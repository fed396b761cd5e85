#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``csrc/`` with nvcc (one nvcc
per source, all started together), then runs its phases; any failure
exits non-zero.

A. The paged-attention kernels against their plain PyTorch version on
   the card, at the Llama-3 8B attention shapes (32 q heads, 8 KV heads,
   head_dim 128, 32-token pages), by the route ``_route`` picks: decode
   (B=4, one query each, live lengths 100-2000) on the tensor-core decode
   kernel in bf16 and on the three-pass TF32 kernel (``"tf32x3"``,
   ``csrc/paged_attn_f32.cu``) in f32; in bf16 also decode at
   phase B's decode-profile shape (live 512-560 of 64 blocks) and at
   Llama-3 8B's own 8,192-token context (live 7,000-8,000 of 256 blocks);
   query chunks (512 queries at offset 1024, 512 at 0, a 32-query final
   bucket at offset 1480) on the tensor-core prefill kernel in bf16 and
   an 8-query chunk at offset 1480 (32 rows a KV head) on the decode
   kernel, the 512 @ 1024 chunk and a verify window of 8 at phase P's
   table width (65 blocks, live 512-560) on the tf32x3 kernel in f32;
   at head_dim 16 and 32: in f32 the serve CLI's tiny preset's
   shape (4/2 heads, head_dim 16: an 8-slot decode step and a 128-query
   prefill in a 16-block table) on the tf32x3 kernel, in bf16 the micro
   draft's 2/1 heads at head_dim 16 and 4/2 heads at head_dim 32 (an
   8-slot decode, a 512-token chunk at offset 0) on the decode kernel,
   each beside the split kernel forced; stale K/V past each cursor and
   scratch-page garbage changing no bit on every route (head_dim 16 too:
   a decode step and 80-query chunks).
   Reports the error, the kernel's time, the plain version's, the bound
   (the larger of bytes over 3.35 TB/s and FLOPs over the dtype's peak),
   and the time of ``scaled_dot_product_attention`` on the pre-gathered
   K/V with the boolean mask as a yardstick (the port never calls it);
   for a case on the decode route, also the split kernel's error and time
   on the same inputs, two decode launches bitwise equal, and every time
   on the device alone; for a case on the tf32x3 route the same (two
   launches bitwise equal, the split kernel's error and time on the same
   inputs); for a chunk on the prefill route, the split
   kernel's error and time on the same inputs and the prefill kernel's
   time at 64- and 128-row tiles. The same cases again through the int8 branch:
   int8 pools quantized from random ones by the model's quantize-on-write,
   bf16 and f32 q, held to the int8 plain version, stale int8 cells and
   their scales past each cursor and scratch-page garbage changing no
   bit; the yardstick then runs on K/V gathered and dequantized
   beforehand.
B. The port's ``ServeEngine`` at full Llama-3 8B width and
   ``SERVE_LAYERS`` (16) of its 32 layers, as every serving phase (bf16,
   random weights from a seed): 4 slots, 512-token prefill chunks, 8
   requests of 100-1500 prompt tokens and 32 new tokens (6 greedy, 2
   sampled). Every request finishes with in-vocabulary tokens, no pool
   page leaks, and the paged kernels launch exactly n_layers x prefill
   chunks times on the prefill route, n_layers x decode iterations on
   the decode route and never on the split route. Reports prefill and
   decode tokens/s, TTFT p50 and peak device memory; then, with every
   slot busy, a decode iteration's host time and its device time by
   kernel (``torch.profiler``, the decode kernel once a layer); then a
   512-token prefill chunk at offset 1024: host time, device time by
   kernel class and the busy share.
C. The same workload in f32 at 8B width and 4 layers, greedy, through the
   kernel path and through the plain path (``attention_impl="xla"``):
   the first 16 tokens of every request agree, every paged launch on the
   tf32x3 route and none on the split route. Then the serve CLI's tiny
   preset (head_dim 16) served in f32 through both paths: streams equal,
   every paged launch on the tf32x3 route at head_dim 16, none on the
   split route. Then, in bf16 (which the
   prefill route takes), every prompt prefilled in 512-token chunks
   through both paths: the last position's logits agree within
   ``BF16_LOGIT_RTOL`` and the first greedy token is equal wherever the
   plain path's top-2 margin exceeds twice the largest logit difference.
D. The flash-attention kernels against their plain PyTorch versions on
   the card, in bf16 and f32, at B 2, S 2048, 32 q heads, 8 KV heads,
   head_dim 128: causal, non-causal, 512 queries against 2048 keys
   (causal, offset 1536), and three packed documents by segment ids
   (causal); then at phase H's attention (B 8, S 1024, 12/4 heads,
   head_dim 64, causal), at phase Q's (B 8, S 1024, 4/2 heads, head_dim
   16, causal) and at its head_dim-32 twin with three documents, and at
   the zoo's encoders, non-causal at head_dim 64: BERT-base (B 16, S 512,
   12/12 heads) and ViT-L/16 (B 32, S 197, 16/16 heads). In bf16 also the
   backward's delta (``csrc/flash_delta.cu``: the sum of P dP over the
   keys) on each route: the wgmma kernel at head_dim 64/128 beside the
   small one forced on the same inputs, the small one at 16/32; each
   against its plain version at the f32 limit, twice bitwise, and 0 on
   rows that see no key, timed beside rowsum(dO * O), JAX's delta (a
   different function). The
   forward and the backward on every route: in bf16 the tensor-core
   kernels of ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``
   (``"wgmma"``, head_dim 64/128) or of ``csrc/flash_small.cu``
   (``"small"``, head_dim 16/32), in f32 the three-pass TF32 kernels of
   ``csrc/flash_fwd_f32.cu`` and ``csrc/flash_bwd_f32.cu`` (``"tf32x3"``),
   each beside the first kernels of ``flash_attn.cu`` (``"mma"``) forced on
   the same inputs. Each
   output is held element by element to a limit of atol x the RMS of its
   row (never below the output's RMS) + rtol x the element, and the
   log-sum-exp to an absolute limit; rows that see no key match the plain
   version exactly; two launches of each kernel's default route on the
   same inputs give the same bits. Then a case with rows that see no key
   and keys that no row sees, in both dtypes: every backward route's dQ,
   dK and dV there exactly the plain version's, and every default forward
   route's O and lse.
   Reports each kernel's error, time, the plain version's, the bound (the
   larger of the bytes it must move over 3.35 TB/s and its matmul FLOPs on
   the visible pairs over the dtype's peak; for the tf32x3 lines 3 x the
   FLOPs over the TF32 peak, with the CUDA-core f32 bound beside it) and,
   as a yardstick the port never calls, ``scaled_dot_product_attention``
   (forward alone for the forward kernel; for the backward ones forward
   and backward through autograd less the forward), timed on the device
   alone: autograd's host side outlasts the card's work at these sizes;
   with the backend SDPA took (flash, efficient, cudnn or math, read from
   the names of the kernels it launched).
E. Training at Llama-3 8B width, 4 layers (``config_llama3_8b(n_layers=4,
   max_seq_len=2048)``: bf16 compute, f32 params, remat "dots"), chunked
   CE, AdamW with global-norm clip 1.0, 4 x 2048 tokens per step, through
   ``make_train_step`` over NCCL at world size 1 and ``fit`` over a
   ``TokenBatcher`` of ``synthetic_tokens``. Eight steps on one fixed
   batch bring the loss down by the stated margin; then a timed window of
   steps gives tokens/s, step ms, peak memory and the model-FLOPs share,
   the kernel launches per step are checked exactly (forward 2 x layers
   with the remat recompute, dQ, dK/dV and delta once per layer, all on
   the wgmma route), and one profiled step gives device time by class and the
   busy share.
F. Three AdamW steps in f32 (TF32 off: cuBLAS and cuDNN hold f32; the
   flash backward's three-pass TF32 split is f32-accurate and is not the
   TF32 those flags allow) at 8B width, 2 layers, B 2, S 1024
   from the same weights, through the kernels (``attention_impl="auto"``)
   and through the plain einsum path (``"xla"``): the losses agree, and
   for every parameter tensor on its own the first step's gradient and
   the parameters after the 3 steps agree, within the stated tolerances.
   Logs the element whose parameter differs most, with its gradient and
   Adam moments on both paths. The flash forward and backward run on the
   tf32x3 route alone, 2 x steps launches of each backward kernel and at
   least as many forward (checked). Then the same model and
   first batch in bf16 compute:
   one step's gradients on the wgmma route and on the mma route (forced),
   each against the f32 plain path per parameter tensor; the wgmma
   route's relative L2 distance is at most ``BF16_STEP_RATIO`` x the mma
   route's + ``BF16_STEP_FLOOR``.
G. The grouped-matmul kernels (the forward and, reading the weight
   transposed in place, the input gradient; the weight gradient) against
   their plain versions, 8 experts and 16,384 routed rows: the MoE slice's
   shapes (K 768 -> N 2048 and K 2048 -> N 768, group sizes from a seeded
   top-2 router) in bf16 and f32, and Mixtral-8x7B-class expert shapes
   (K 4096 -> N 14336 and K 14336 -> N 4096) in bf16, balanced and skewed
   (one expert 40 %, one empty); then the slice's shapes at phase M's
   prefill (4,096 rows from a seeded top-2 router, block 512) in bf16.
   bf16 runs both routes on the same inputs
   (``gmm_wgmma``/``tgmm_wgmma`` of ``csrc/gmm_wgmma.cu``, and the
   mma.sync ``gmm_kernel``/``tgmm_kernel`` of ``csrc/gmm.cu`` forced), f32
   on both ``gmm_tf32x3``/``tgmm_tf32x3`` of ``csrc/gmm_f32.cu``
   (``"tf32x3"``, the route f32 takes) and gmm.cu's kernels forced; f32
   also at the slice's gate/up shape balanced, skewed and in one expert.
   Every element within atol x the output's RMS + rtol x
   |plain| (the forced ``tgmm_kernel`` at the skewed and one-expert f32
   layouts a reading: it chains every row of an expert into one f32
   accumulator), rows that hold no token exactly 0, an empty expert's
   weight gradient exactly 0; two wgmma or tf32x3 launches give the same
   bits. Reports each
   kernel's time, the plain version's, the bound, and
   ``torch._grouped_mm`` on the same spans
   as a yardstick (the port never calls it; null with the reason where
   this torch refuses the case), the kernels and the yardstick timed on
   the device alone.
H. Dropless MoE training at the slice's configuration: the Llama-small
   backbone (dim 768, 12 layers, 12/4 heads, head_dim 64, MLP 2048, vocab
   32000), 8 experts top-2 ``dispatch="ragged"``, bf16 compute, f32 params,
   remat "dots", AdamW, 8 x 1024 tokens a step, through
   ``make_train_step`` over NCCL at world size 1 and ``fit``: the fixed
   batch's loss falls by phase E's margin in 8 steps; a timed window gives
   tokens/s, step ms, peak memory and the model-FLOPs share
   (``moe.flops_per_token``); the launches a step are checked exactly (gmm
   6 x layers, tgmm 3 x layers, flash forward 2 x layers, dQ, dK/dV and
   delta once a layer, all six on the wgmma route); one profiled step gives
   device time by class.
I. The same model at 2 layers in f32 (TF32 off), B 2, S 1024: 3 AdamW
   steps from the same weights through the kernels (``dispatch="ragged"``,
   flash attention) and through an independent plain path
   (``dispatch="index"`` at a capacity that drops nothing, the einsum
   attention), compared as in phase F. The f32 kernel path runs the
   forward grouped GEMM and dlhs on tf32x3 (exactly 6 x layers x steps),
   the weight gradient on tf32x3 too (3 x layers x steps, mma 0) and the
   flash forward and backward on tf32x3, as in phase F (the wgmma counts
   stay 0, checked).
J. Quantized serving: phase B's engine and workload with
   ``kv_quant="int8"`` and ``weight_quant="int8"`` (Llama-3 8B, full width
   and depth, bf16 random weights from seed 0, quantized in place). The
   same checks, every pool int8 with f32 scale siblings, the int8 branch
   launched exactly as phase B's fp branch by route, and the fp branch
   never. Reports phase B's metrics, the peak memory of construction and
   of serving apart, bytes per page fp and int8, the bytes saved, the
   decode and prefill profiles, and, as a reading only, the share of
   greedy tokens equal to phase B's.
K. Phase C with kv and weight int8: f32 at 8B width and 4 layers, the int8
   kernel path against the plain path; the first 16 greedy tokens of all
   8 requests agree; then the bf16 prefill check of phase C.
L. One-shot ``generate`` on the dense KV cache at Llama-3 8B, full width
   and depth, bf16, random weights from seed 0: 4 left-padded prompts of
   100-1,500 real tokens (1,500 columns, a 1,536-column cache window) and
   32 new tokens, greedy, then sampled (T 0.8, top-k 50, top-p 0.9) twice
   from one seed. Tokens in the vocabulary, the cache at the window's
   width, the two sampled runs equal, and no paged, flash or grouped-
   matmul kernel launched (the dense path's attention is the einsum path,
   as JAX's is XLA attention). Reports prefill ms, decode tokens/s, peak
   memory, one decode step's host ms, device ms by kernel class and busy
   share (``torch.profiler``), and, as a reading, the greedy tokens equal
   to each row generated alone. Then in f32 (TF32 off) at 8B width and 4
   layers, one set of weights: each of phase C's 8 requests generated
   alone equals the ``ServeEngine`` greedy stream (tf32x3 paged kernel)
   for 16 tokens, and each row of a left-padded batch of 4 equals that
   row alone.
M. ``generate`` on the ragged MoE (phase H's backbone, 8 experts top-2,
   block 512, bf16, random weights): 4 left-padded prompts to 512 columns
   (2,048 tokens, so the prefill takes the grouped GEMMs) and 32 new
   tokens, greedy. The wgmma grouped GEMM launches exactly 3 x layers
   times in the prefill and the decode steps (4 tokens, the index path)
   add none; no other kernel runs. Reports prefill ms and its device time
   by class, decode tokens/s, peak memory. The logits of every real
   prefill position, ragged against ``dispatch="index"`` on the same
   weights, within ``MOE_BF16_LOGIT_RTOL`` (one bf16 step, relative L2),
   and a row block planted on the wrong expert above it; the first greedy
   token equal where decided; in f32 at 2 layers the two give the same 16
   greedy tokens and prefill logits within 1e-4 relative, the ragged
   path on the tf32x3 route (3 x layers launches).
N. The reference's own job: ``python -m
   k8s_distributed_deeplearning_torch.train.mnist`` on the card as its
   own process, synthetic MNIST at 60,000 / 10,000, batch 100, Adam 1e-3,
   dropout 0.5, 600 steps (one epoch), a checkpoint every 200. Two
   unkilled runs first, A as a user runs it and A0 with ``--prefetch 0``;
   run B is SIGTERMed after its first log at step 300 or later
   (``preempted``, checkpointed, exit 0), then run again (``restore`` at
   that step, to 600). The step-600 checkpoints hold bitwise equal params
   and Adam moments (cuDNN and cuBLAS held to deterministic algorithms;
   were A and A0 to differ, B would be held to ``REPEAT_FACTOR`` x their
   distance), every manifest verifies, one
   flipped byte in B's newest step is quarantined and the restore falls
   back to the step before it, and A's eval on the 10,000 held-out
   examples reaches ``MNIST_MIN_ACCURACY``. Reports step ms (A's and
   A0's), examples/s, the MFU against the f32 peak, the save and restore
   ms and bytes, and the busy share of a profiled window of the same step
   in this process.
O. Checkpoint and resume on the kernels: phase H's model and batches at
   2 of its 12 layers (params and AdamW moments, ~1.5 GB). 2k unkilled steps
   (k = ``RESUME_K``); then k steps with a save at k, a fresh model from
   another seed restored from disk by ``fit``'s restore-on-start, and k
   more: losses, params and moments bitwise equal (or the repeat rule),
   and in each half exactly H's launches a step on the wgmma routes.
   Then from the step-2k checkpoint two steps with fused gradient buckets
   (``bucket_bytes`` 64 MiB) against two without, params bitwise equal
   (NCCL at world 1 on flat f32 buffers). Reports the save and restore
   ms, GB/s and bytes, and the bucket count.

P. The serving engine's host surface at Llama-3 8B (bf16, 16 layers,
   random weights from seed 0, B's engine: 4 slots, 512-token chunks,
   32-token pages). P1: one warm request, then 8 requests of one
   1,024-token prefix plus 100-500-token tails (32 new), with the prefix
   cache off and at 256 MiB: hit and computed prompt tokens, prefill
   tokens/s, TTFT, launches by route exact, no page held after shutdown,
   first tokens equal where phase C's margin rule decides them. P2: B's
   requests (greedy) plain and with a self-draft at spec_k 3 and 7
   (verify windows of 4 and 8, 16 and 32 rows a KV head: both on the
   decode route, none on the split route) and a 2-layer draft at 8B
   width (rejections, rollback): decode tokens/s, acceptance, launches by
   route exact, a verify pass's host and device ms (the decode kernel
   once a layer); then the verify windows alone (W 4, 5, 8, 15, and 8
   with int8 pools; W 16, 64 rows, on both tensor-core routes) against
   the plain version with their times, the split kernel's, SDPA's and
   the bound, and two launches bitwise equal. P3: two tenants from a
   config string; a queued, a pending-prefill and an in-flight request
   cancelled, the pending one requeued, a drain to the end: finish
   reasons, on_finish once a submission, no page held. Then the serve
   CLI's ``--preset small`` (12 layers, bf16, head_dim 64) plain and with
   ``--draft-model micro`` (head_dim 16) at spec_k 3 on 16 of its default
   requests: launches by route exact, every draft launch on the decode
   route at head_dim 16, none on the split route, the greedy tokens equal
   to plain as a reading; the same in f32, streams equal token for token.
   Then at 4 layers in f32: streams with the cache on equal off, greedy
   and sampled speculative streams (self-draft, 2-layer draft) equal
   plain decode, the self-draft accepts every greedy proposal, and a
   request with prompt + new tokens == max_seq_len runs at spec_k 4.

Q. The train CLI's tiny preset at 1,024 tokens (dim 64, 4/2 heads,
   head_dim 16: ``--preset tiny --seq-len 1024``, where the auto attention
   takes the flash kernels) in bf16 and in f32 (the CLI's default), 8
   AdamW steps on one fixed batch through ``make_train_step``: the loss
   falls by phase E's margin, each flash backward kernel launches once a
   layer a step, and the forward at least as often, on its dtype's route
   (bf16 at head_dim 16: small; f32: tf32x3) and on no other, and bf16's
   delta kernel once a layer a step on the small route; at the
   path's attention shape that route's backward is within phase D's limit
   of the plain version.

R. The serving engine's in-process scale-out surface (run after P). R1:
   phase B's workload at Llama-3 8B, 16 layers (bf16, random weights from seed
   0) disaggregated: one ``prefill_only`` engine and two decode engines
   with B's settings on one shared model, through the
   ``DisaggCoordinator``. Every request finishes with "length"; the
   prefill engine's paged launches are all on the prefill route (layers x
   chunks) and the decode engines' all on the decode route (layers x
   their decode iterations), split 0, counted engine by engine; the pages
   shipped equal the sum of ceil(kv_len / 32); no fallback; no engine
   holds a page after shutdown; the first token equals B's wherever
   phase C's margin rule decides it. Reports the streams and tokens equal
   to B's (a reading), export and import ms a request, bytes and GB/s,
   decode tokens/s and peak memory. R2: f32 at 8B width and 4 layers (C's
   kernel path): the disaggregated streams equal a unified engine's,
   greedy and sampled; a greedy and a sampled request exported at decode
   cursor 8 and imported into another engine equal the uninterrupted
   run; a ``ServeGateway`` over two replicas with r0 killed mid-decode
   through ``gateway_dispatch``: every greedy stream equals the unified
   engine's, at least one migration; ``drain_replica`` mid-decode moves
   the decoding requests by shipped pages; every paged launch on tf32x3,
   none on split. R3: ``run_storm`` over the serve CLI's tiny preset
   (f32, head_dim 16) at seed 1, 48 steps, as a gateway of two replicas
   and as one prefill and two decode engines: zero violations, greedy
   streams checked against the unfaulted oracle, faults fired at
   ``serve_decode`` and ``gateway_dispatch``, every paged launch on
   tf32x3 at head_dim 16. R4: the train CLI's tiny preset takes 2 steps
   on the card as its own process and writes a checkpoint;
   ``examples/generate_llama_torch.py`` generates 32 greedy tokens from
   it, equal to ``generate`` on the restored params. Each sub-run logs
   ``since_start_s``.
S. The wire half of the serving fleet (``serve/transport.py``): replica
   servers as processes of their own on the one card (this script started
   with ``--s-server CONF``, a fresh interpreter each; the parent builds
   every kernel first), driven over localhost HTTP. S1: B's workload at
   Llama-3 8B (16 layers) in bf16 through a prefill-role and a decode-role
   server, this process the coordinator (``RemotePrefillWorker`` and a
   ``ReplicaClient``): every request finishes, first tokens equal B's
   where the margin decides, each server's paged launches exact by route
   (prefill server: n_layers x prefill chunks on the prefill route;
   decode server: n_layers x decode iterations on the decode route; split
   0), pages picked up over ``/exports`` and shipped over ``/pages`` =
   the sum of ceil(kv_len / 32), no fallback, no page held; reports the
   wire's GB/s each way, decode tokens/s and each process's peak memory.
   S2: R2's f32 configuration (8B width, 4 layers) against a unified
   in-process engine's streams: a hop (pages exported here at decode
   cursor 8, greedy and sampled, shipped over ``/pages``), a decode
   server SIGKILLed mid-decode (held there by a step budget) with the
   gateway migrating its streams, and a drain over the wire; every stream
   equal, every paged launch in every process on tf32x3. S3: the serve
   CLI itself, two ``--replica-server --preset small`` processes found by
   a ``--replica-discovery-dir`` gateway; SIGTERM to the gateway, then to
   each replica: every process exits 0, each replica prints
   ``replica_drained``.
T. The training loop's hooks and graftscope's readers (run after O).
   T1: E's configuration (8B width, 4 layers, bf16, remat, 4 x 2048,
   AdamW, chunked CE) fed by a ``TokenShardBatcher`` over token shards of
   the byte-level corpus (``write_token_shards``), 12 steps through
   ``fit`` with every hook on: a ``Tracer`` into a JSONL file, a
   ``HeartbeatWriter``, a ``TrainTelemetry``, a ``StepProfiler`` over
   steps 4-6 and the ``quant_calib`` dump. Flash launches exactly E's a
   step by route; the profiler's trace holds the four wgmma flash
   kernels; ``train_steps_total`` renders 12; the heartbeat reads step
   12; graftscope's readers find 12 steps, each with ``data_wait`` and
   ``step``. Reports the losses, the step ms against E's, the critical
   path, the profiled steps and the profiler's start and stop cost. T3
   (on T1's model, its optimizer state freed): the dump has one entry a
   quantizable weight under JAX's names; the model quantized with it and
   without it (a copy) serves 4 requests of 16 new tokens with int8
   weights and int8 KV pages: paged launches exact by route on the int8
   branch (split 0), no page held after shutdown; the share of clipped
   channels and the tokens against the uncalibrated engine's are
   readings. T2: the train CLI's small preset at 2 of its 12 layers, at
   1,024 tokens in bf16 (flash), run as rank 0 and then rank 1 on the one card, each with its
   own tracer, JSONL and checkpoint directory (a save every 4 of 12
   steps), one heartbeat directory, the same shards and seed, and a fault
   plan: rank 1's ``data_wait`` stalls 2 s at steps 3 and 4, rank 0's
   first ``shard_read`` fails once, rank 1's heartbeat stops from step
   10. The readers attribute steps 3 and 4 to ``rank1:data_wait`` (a lag
   above 50 ms) and the worst straggler is rank 1's data_wait; the losses are equal bitwise;
   ``checkpoint_saved`` fires at 4, 8, 12 on each rank; the heartbeat
   files read 12 and 9; graftscope's ``export-perfetto`` aligns both ranks
   on step. T4: the train CLI as its own process, ``--preset tiny
   --attention flash --dtype bfloat16 --data-path SHARDS --profile-dir
   DIR``, 16 steps with adafactor and with lion (bf16 moment), the two
   processes at once: exit 0,
   ``start`` says ``sharded-streaming``, each trace holds the small flash
   kernels (head_dim 16). T5 (inside R2's gateway kill): the replicas
   sample every request's trace; graftscope's ``requests --json``
   stitches each migrated request into one chain, the migrations summing
   to the gateway's count, and ``postmortem`` renders the replicas'
   flight dumps.
U. The fleet controller (``serve/autoscale.py``) and the launch layer
   (``launch/``), run after T. U1: phase B's workload at Llama-3 8B (16 layers)
   (bf16, seed 0), two arrivals a gateway iteration, through a
   ``ServeGateway`` and a ``FleetController`` over an
   ``EngineFactoryBackend`` whose engines (B's settings) share one model,
   on a clock the phase steps (1 to 3 replicas): the queue scales the
   fleet up and the idle tail drains it back to one; every request
   finishes, launches exact by engine and route (decode and prefill only,
   split 0), first tokens equal B's where the margin decides, no page
   held, and the peak memory grows by no more than the added engines'
   KV pools + 2 GiB (the weights are not copied). Reports the decisions,
   each actuation's ms, migrations and decode tokens/s. U2: R2's f32
   model (8B width, 4 layers) on 2-slot engines with a chat (interactive)
   and a bulk (batch) tenant: a scale-up mid-stream, the brownout ladder
   walked up at the ceiling (``shed_batch`` refuses the bulk tenant and
   nothing else) and unwound to ``autoscale_restored``, r0 killed through
   ``gateway_dispatch`` and replaced, drains on the way down (the Job
   controller's victim, the newest replica, one request moved by its
   pages): all 13 streams equal a unified engine's, every paged launch on
   tf32x3. U3: ``LocalProcessBackend`` spawns the port's replica servers
   (``launch serve --replica-server``, the serve CLI's small preset) on
   the card; the fleet goes 1 -> 2 -> 1, ``heartbeat_discoverer`` finds
   each new server once, each child exits 0 and prints
   ``replica_drained``, ``autoscale_summary`` is emitted. U4: ``launch
   render`` and ``validate`` of the GPU manifests (``nvidia.com/gpu``, no
   ``google.com/tpu``); then ``examples/train_mnist_torch.py`` through the
   rendered job, one worker on phase N's synthetic set, a checkpoint
   every 10 of 60 steps: ``launch run-local`` whole, and a run whose rank
   0 an ``executor`` fault SIGKILLs while it stalls past its step-20
   checkpoint, restarted by ``run_elastic`` from the newest step on disk;
   the final params and moments held to phase N's rule. One card: the
   multi-worker gang runs on the CPU only (NCCL refuses two ranks on one
   device). U5: ``launch storm --autoscale`` at the tiny preset, 48
   steps, seed 6 (at seed 1 the plan's ``autoscale_actuate`` fault never
   fires): zero violations, ``autoscale_actuate`` fired.
V. The rest of the model zoo (``models/resnet.py``, ``bert.py``,
   ``vit.py``) at the published widths and depths, bf16 compute and f32
   params, AdamW (lr 1e-3, clip 1.0), synthetic data from seeds, run after
   T. V1: ResNet-50 at 224², batch 64, 1000 classes, BatchNorm, conv7
   stem, through ``make_stats_train_step``: eight steps on one batch end
   below 0.9 x the first loss, the running statistics finite and moved;
   a timed window (images/s, step ms, model-FLOPs share, peak memory, a
   profiled step's busy share); one step each with ghost statistics (32 of
   64), GroupNorm and the s2d stem, finite. Then ResNet-50 in f32 (TF32
   off), a training forward at batch 8 with bn3 scales from the seed: the
   card's logits and new running statistics within 1e-4 relative L2 of
   the port's CPU forward of the same weights. V2: BERT-base MLM (12
   layers, seq 512, batch 16, ``mask_tokens``) and V3: ViT-L/16 (24
   layers, 224², 197 tokens, batch 32), each through
   ``attention_impl="auto"`` (the einsum path at these lengths, as JAX's
   rule picks) and ``"flash"``: the fixed-batch loss falls, tokens/s or
   images/s, step ms, the model-FLOPs share, peak memory, launches exact
   (auto: none; flash: a forward, a dQ, a dK/dV and a delta a layer, all
   on wgmma, none on mma or small); then phase F_bf16's rule on one step's gradients from the
   same weights (ViT's head drawn from the seed): each tensor's relative
   L2 distance from the f32 einsum path, the bf16 flash path's at most
   1.25 x the bf16 einsum path's + 2^-10. V4: BERT-base and ViT-L widths
   at 2 layers in f32 (TF32 off), three AdamW steps through ``"flash"``
   (every launch on tf32x3) and through the einsum path, held by phase
   F's rule. V5: ``examples/train_zoo_torch.py`` through ``main(argv)``
   for resnet18, vit, bert and moe at their small presets, 4 steps each;
   then ``--model resnet18`` as its own process, SIGKILLed past step 20 of
   40, run again: it restores the newest good step on disk and its final
   params and BatchNorm statistics equal an unkilled run's by phase N's
   rule.
W. Tensor-parallel serving (``serve/tp.py``) on the one card, after U:
   tp=2 is two processes on ``cuda:0`` over gloo (NCCL refuses two ranks
   on one device), this one rank 0 and a follower it spawns; every W
   line names the backend, and its speeds are gloo through the host on
   one card, not a TP speed. W1: B's workload at 8B width and
   ``W_LAYERS`` layers in bf16 through a tp=0 and a tp=2 engine: each
   rank's paged launches equal the tp=0 engine's route by route (decode
   layers x iterations, prefill layers x chunks, split 0); each rank's
   decode and prefill kernels held once to their plain versions on its
   own pool shard under phase A's limits; first-token logits by phase C's
   rule against tp=0; the ranks' last logits bit-equal (an all-reduced
   hash); decode tokens/s, a decode iteration's host and device ms (a
   profile), each process's peak memory and the greedy streams are
   readings. W2: 8B width, ``W_LAYERS`` layers, f32, tp=2 against tp=0:
   JAX's ``_mixed_reqs`` at page scale (greedy and sampled, prefix hits,
   chunked prefill), spec_k 4 with a 2-layer draft, a gateway drain that
   migrates mid-decode between two engines, and int8 KV with int8
   weights; every launch of every rank on tf32x3 (QUANT-tf32x3 under
   int8), split 0; streams equal, or, where a greedy token differs, equal
   before it and tp=0's top-2 margin there under twice the largest logit
   difference (the positions the rule decided are reported). W3: tp=1, a
   world of one: first-token logits and streams bitwise W1's tp=0 run's,
   decode iteration ms beside it. W4: ``python -m
   k8s_distributed_deeplearning_torch.serve --preset small --tp 2``
   serves a few requests, the follower joins, both processes exit 0,
   both ranks launch the same kernels, and rank 0's peak device memory
   is within ``W4_PEAK_RATIO`` of rank 1's (the CLI keeps the whole
   model on the host). W2's drain migration runs twice, fp and under
   int8 KV, whose import header needs two broadcasts.

The build also compiles ``csrc/fusion.cc`` (the fusion planner) and logs
whether it loads. Prints the card's name and power limit, the build time,
one JSON line per phase, a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
# The serving and generation phases (A-C's model, B, J, L, P, R1, S1, U1)
# run Llama-3 8B at its full width and 16 of its 32 layers: at 32 they
# took 420-590 s of the run (PR 23's, PR 24's first), host-bound.
SERVE_LAYERS = 16
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12,         # dense tensor-core bf16
              torch.float32: 67e12}           # f32 outside tensor cores
# Phase A tolerances, max |kernel - plain|. f32: online vs plain softmax
# over up to 2000 keys. bf16: the kernel rounds unnormalized p to bf16 for
# P.V (as the Pallas kernel does), the plain version the normalized
# probabilities, and both round the output to bf16.
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# Phase A's decode cases beside the one drawn from its seed, bf16 only
# (live lengths, n_blocks, pages): phase B's decode-profile shape (4 slots
# at 512-560 live tokens of a 2,048-token table) and Llama-3 8B's own
# 8,192-token context (7,000-8,000 live of 256 blocks).
DECODE_CASES = {"decode_b_profile": ([512, 528, 544, 560], 64, 4 * 18 + 1),
                "decode_long": ([7000, 7333, 7667, 8000], 256, 4 * 250 + 1)}
# The query chunks phase A added with the prefill route (512 queries at
# offset 0, 32 at offset 1480), bf16: every element within TOL + 2^-7 x
# |plain|. Rows near position 0 average a few rows of V, so outputs reach
# |x| ~ 4, where the one bf16 step by which two roundings of the output can
# differ is 2^-6 > TOL. The decode and 512 @ 1024 cases keep TOL alone.
CHUNK_RTOL_BF16 = 2 ** -7
# The int8 branch in bf16, per element: |kernel - plain| <= 2^-10 x the
# output's RMS + 2^-7 x |plain|. Both dequantize to the same f32 values and
# keep p in f32, so only the order of the f32 sums and the final bf16
# rounding differ: one bf16 step (at most 2^-7 of the value), plus a
# little near 0. f32 is held to TOL.
INT8_TOL_BF16 = (2 ** -10, 2 ** -7)
# Phases C and K, bf16 prefill: the last position's logits of each request,
# kernel path against plain path, relative L2. The two attentions differ
# in where bf16 rounds (fp: p at the running max or normalized; int8: f32
# K, V and p against K, V and p rounded to bf16), up to one bf16 step
# (2^-8) of an attention output. Each of the 4 layers adds such a
# difference to the residual stream, and the layers after it, with random
# weights, can grow what they are given (attention and MLP gains above 1):
# 4 steps x a growth of 4 = 2^-4. A wrong mask or a lost key tile moves an
# attention output by a large share of its size, far above that.
BF16_LOGIT_RTOL = 2 ** -4
H, KV, HD, PAGE = 32, 8, 128, 32
PAGED_REPLACES = ("k8s_distributed_deeplearning_tpu/ops/"
                  "pallas_paged_attn.py:66")
# Phase D tolerances (atol, rtol), held per element and per output (o, dq,
# dk, dv): |kernel - plain| <= atol x scale + rtol x |plain|. rtol covers
# the output rounding: bf16 keeps 8 significant bits, so two results that
# differ in their last f32 bits can round one bf16 ulp (<= 2^-7 of the
# value) apart. atol covers the rest: in bf16 the rounding of p (forward,
# at the running max in the kernel and at the final max in the plain
# version) or of dS (backward) at different points, in f32 the order of
# the sums. Their effect grows with the size of each row (the head_dim
# vector of one position and head: a row over 2 keys is a mean of 2 values
# of V, one over 2000 keys a far smaller one), so the scale is the row's
# RMS, but never below the whole output's RMS: a dQ row that cancels to
# about 0 (a query that sees one key) still carries its dS rounding. The
# log-sum-exp is f32 in both dtypes and is held to LSE_ATOL absolute.
FLASH_TOL = {torch.float32: (1e-4, 1e-4),
             torch.bfloat16: (2 ** -5, 2 ** -6)}
LSE_ATOL = 1e-3
# Phase E: the loss after 8 steps on one fixed batch is below this share
# of the first step's loss.
FIXED_BATCH_MARGIN = 0.9
# Phase F: relative loss agreement; then, for every parameter tensor on its
# own, the L2 norm of the kernel path's first-step gradient minus the plain
# path's over the plain one's, and the L2 norm of the difference of the
# parameters after the 3 steps over the change the 3 steps made.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-4
TRAIN_PARAM_TOL = 1e-3
# Phase F in bf16: per parameter tensor, the relative L2 distance of one
# step's gradient from the f32 plain path's, on the wgmma route, must be at
# most BF16_STEP_RATIO x the mma route's + BF16_STEP_FLOOR. Both routes
# round P and dS to bf16 at the same points, so their distances from f32
# are set by the bf16 model around them and should agree to a few per
# cent; the ratio leaves room for the two kernels' other sum orders. The
# floor covers a tensor whose distance is near 0 on both routes, where a
# ratio says nothing: 2^-10 is a quarter of one bf16 step (2^-8) of
# relative error, far below what a wrong mask or a lost tile does to the
# attention weights' gradients (a large share of their norm).
BF16_STEP_RATIO = 1.25
BF16_STEP_FLOOR = 2 ** -10
# Phase G tolerances (atol, rtol), held per element: |kernel - plain| <=
# atol x RMS of the plain output + rtol x |plain|. Both versions sum exact
# products in f32, in different orders. f32: the order's effect, about
# 1e-6 of the RMS at these depths. bf16: both round their f32 sums to bf16
# once, and sums on either side of a rounding boundary land one bf16 step
# (at most 2^-7 of the value) apart.
GMM_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -10, 2 ** -7)}
GMM_E, GMM_ROWS = 8, 16384
GMM_REPLACES = {
    "gmm": "k8s_distributed_deeplearning_tpu/ops/pallas_gmm.py:159",
    "tgmm": "k8s_distributed_deeplearning_tpu/ops/pallas_gmm.py:209",
}
# Kernel-line name -> (source, wrapper): each wrapper launches the kernel
# of its route, the wgmma lines its "wgmma" route (bf16), the tf32x3 lines
# its "tf32x3" route (f32), the others the kernels of gmm.cu ("mma",
# forced in both dtypes here: no path runs them).
GMM_KERNELS = {
    "gmm": ("gmm.cu", "gmm"), "tgmm": ("gmm.cu", "tgmm"),
    "gmm_wgmma": ("gmm_wgmma.cu", "gmm"),
    "tgmm_wgmma": ("gmm_wgmma.cu", "tgmm"),
    "gmm_tf32x3": ("gmm_f32.cu", "gmm"),
    "tgmm_tf32x3": ("gmm_f32.cu", "tgmm"),
}
# The MoE slice's model: the JAX package's ragged MoE benchmark row
# (Llama-small backbone, 8 experts, top-2, dispatch="ragged").
MOE_BACKBONE = dict(vocab_size=32000, dim=768, n_layers=12, n_heads=12,
                    n_kv_heads=4, mlp_dim=2048)


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# Cycles of the sleep kernel that ``time_ms(..., host_ahead=True)`` runs
# first: ~0.1 s at the H100's clock, time for the host to enqueue every
# timed launch of a call that issues a few dozen kernels.
HOST_AHEAD_CYCLES = 200_000_000


def time_ms(fn, flush: torch.Tensor, iters: int = 20,
            host_ahead: bool = False) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each with a
    cold L2 (a 256 MB buffer is rewritten before every launch). With
    ``host_ahead`` the card first runs a sleep kernel while the host
    enqueues every timed launch, so that a call whose host side outlasts
    its device side (autograd's backward) is timed on the device alone."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    if host_ahead:
        torch.cuda._sleep(HOST_AHEAD_CYCLES)
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


# ------------------------------------------------------------- phase A


def _attn_case(rng, dev, dtype, lengths, sq, n_blocks, pages,
               heads=(H, KV, HD)):
    """Pools of ``pages`` random pages; row b maps its live blocks onto
    distinct real pages (the rest stay on scratch page 0) and queries the
    last ``sq`` positions of its ``lengths[b]`` tokens. ``heads``: (q
    heads, KV heads, head_dim)."""
    b = len(lengths)
    h, kv, hd = heads
    q = torch.randn(b, sq, h, hd, device=dev).to(dtype)
    pk = torch.randn(pages, PAGE, kv * hd, device=dev).to(dtype)
    pv = torch.randn(pages, PAGE, kv * hd, device=dev).to(dtype)
    tables = np.zeros((b, n_blocks), np.int32)
    free = rng.permutation(np.arange(1, pages))
    used = 0
    for i, n in enumerate(lengths):
        nb = -(-int(n) // PAGE)
        tables[i, :nb] = free[used:used + nb]
        used += nb
    pos = (np.asarray(lengths)[:, None] - sq
           + np.arange(sq)[None, :]).astype(np.int32)
    return (q, pk, pv, torch.from_numpy(tables).to(dev),
            torch.from_numpy(pos).to(dev))


def _bound(args, dtype, route=None):
    """Bytes: K and V of the live tokens once (int8 pools, ``args`` with
    their scales: one byte an element plus an f32 scale a token and head),
    q in, out, tables and positions; operations: 4 x H x hd per visible
    (query, key) pair over the dtype's peak, or on the tf32x3 route the
    TF32 products it issues for them (three a product, two with int8 K/V,
    exact in TF32) over the TF32 peak. The larger time over the card's
    rates."""
    q, pk, _, tables, pos = args[:5]
    item = q.element_size()
    h, hd = q.shape[2:]
    kv = pk.shape[2] // hd
    live = (pos.max(dim=1).values.long() + 1).clamp_max(
        tables.shape[1] * PAGE)
    per_token = kv * (hd * pk.element_size() + (4 if len(args) > 5 else 0))
    nbytes = (2 * int(live.sum()) * per_token         # K and V, once
              + 2 * q.numel() * item                   # q in, out
              + 4 * (tables.numel() + pos.numel()))
    flops = 4 * h * hd * int((pos.long() + 1).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if route == "tf32x3":
        t_flops = (2 if len(args) > 5 else 3) * flops / PEAK_TF32 * 1e3
    else:
        t_flops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else \
        "operations"


def _sdpa_fn(args):
    """scaled_dot_product_attention on K/V gathered beforehand."""
    q, pk, pv, tables, pos = args
    b, sq, _, hd = q.shape
    kv = pk.shape[2] // hd
    s_virt = tables.shape[1] * PAGE
    k = pk[tables.long()].reshape(b, s_virt, kv, hd).transpose(1, 2)
    v = pv[tables.long()].reshape(b, s_virt, kv, hd).transpose(1, 2)
    qt = q.transpose(1, 2)
    mask = (torch.arange(s_virt, device=q.device)[None, None, :]
            <= pos[:, :, None])[:, None]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, k, v, attn_mask=mask, enable_gqa=True)


# Phase A's query chunks (live lengths, sq, n_blocks, pages): 512 queries
# at offset 1024, the first 512-token chunk, and final 32- and 8-query
# buckets at offset 1480. bf16 chunks of 64 rows a KV head and more take
# the prefill route, the 8-query one (32 rows) the decode route; f32 the
# split one.
PREFILL_CASES = {"prefill512": ([1024 + 512], 512, 64, 64),
                 "prefill512_at0": ([512], 512, 64, 64),
                 "prefill32_at1480": ([1480 + 32], 32, 64, 64),
                 "chunk8_at1480": ([1480 + 8], 8, 64, 64)}
# The bitwise stale-cell check through the prefill route: two rows of 64
# queries at live lengths 700 and 1000.
STALE_PREFILL = ([700, 1000], 64, 64, 2 * 64 + 1)


# f32's verify window: spec_k 7 (8 positions, 32 rows a KV head) at phase
# B's decode-profile lengths in a table as wide as phase P's engine gives
# it (ceil((2048 + 7) / 32) = 65 blocks), where a split of the table's
# width leaves most splits empty.
F32_VERIFY_CASE = ([512, 528, 544, 560], 8, 65, 4 * 18 + 1)

# The serve CLI's tiny preset in f32 (phases C and K, :func:`_tiny_run`),
# 4/2 heads at head_dim 16 in 32-token pages of a 16-block table
# (max_seq_len 512), on the tf32x3 route. Its 8 prompts are drawn from
# TINY_SEED; a decode step of all 8 slots halfway through their 16 new
# tokens, and the prefill of one prompt padded to its 128-token bucket. In
# bf16 the same at the micro draft's 2/1 heads (head_dim 16: decode, and a
# 512-token chunk at offset 0, 1,024 rows a KV head) and at 4/2 heads and
# head_dim 32, on the decode route.
TINY_HEADS = (4, 2, 16)
MICRO_HEADS = (2, 1, 16)
HD32_HEADS = (4, 2, 32)
TINY_SEED = 2
TINY_BLOCKS = 512 // PAGE
SMALL_ROUTES = {torch.float32: "tf32x3", torch.bfloat16: "decode"}


def _tiny_prompt_lengths() -> np.ndarray:
    """The tiny-preset run's 8 prompt lengths (32-128 tokens)."""
    return np.random.default_rng(TINY_SEED).integers(32, 129, 8)


def _tiny_cases(dtype) -> dict:
    """Phase A's cases at head_dim 16 and 32: name -> (live lengths, sq,
    n_blocks, pages, heads). f32: the tiny preset's decode step and
    prefill; bf16: decode and a 512-token chunk at the micro draft's heads
    and at head_dim 32."""
    lens = [int(n) + 8 for n in _tiny_prompt_lengths()]
    decode = (lens, 1, TINY_BLOCKS, 8 * 5 + 1)
    chunk = ([512], 512, TINY_BLOCKS, 16 + 1)
    if dtype == torch.float32:
        return {"tiny_decode": (*decode, TINY_HEADS),
                "tiny_prefill128": ([128], 128, TINY_BLOCKS, 2 * 4 + 1,
                                    TINY_HEADS)}
    return {"micro_decode": (*decode, MICRO_HEADS),
            "micro_chunk512": (*chunk, MICRO_HEADS),
            "hd32_decode": (*decode, HD32_HEADS),
            "hd32_chunk512": (*chunk, HD32_HEADS)}


def _shapes(dtype, decode_lens):
    """Phase A's cases for ``dtype``: name -> (live lengths, sq, n_blocks,
    pages, heads). Decode, the prefill chunks (f32: the 512 @ 1024 chunk
    alone), then bf16's other decode cases (f32: a verify window of 8),
    then :func:`_tiny_cases`."""
    bf16 = dtype == torch.bfloat16
    chunks = (PREFILL_CASES if bf16 else
              {"prefill512": PREFILL_CASES["prefill512"]})
    more = ({name: (lens, 1, nb, pages)
             for name, (lens, nb, pages) in DECODE_CASES.items()}
            if bf16 else {"verify8_p_table": F32_VERIFY_CASE})
    cases = {name: (*case, (H, KV, HD)) for name, case in
             {"decode": (decode_lens, 1, 64, 4 * 64 + 1), **chunks,
              **more}.items()}
    cases.update(_tiny_cases(dtype))
    return cases


def _route_timings(args, kw, ref, err_of, flush) -> dict:
    """For a case on the prefill route: the split kernel on the same inputs
    (its error and time) and the prefill kernel at each row tile."""
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    def launch(route, rows=0):
        return lambda: paged_attn._launch(*args, **kw, route=route,
                                          tile_rows=rows)

    split = launch("split")()
    torch.cuda.synchronize()
    return {"split_max_abs_err": err_of(split, ref),
            "split_ms": time_ms(launch("split"), flush),
            "ms_tile64": time_ms(launch("prefill", 64), flush),
            "ms_tile128": time_ms(launch("prefill", 128), flush)}


def _decode_timings(args, kw, out, ref, err_of, flush,
                    route="decode") -> dict:
    """For a case on the decode or the tf32x3 route: a second launch
    bitwise equal to the first, and the split kernel on the same inputs
    (its error, and its time on the device alone)."""
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    def launch(route):
        return lambda: paged_attn._launch(*args, **kw, route=route)

    again = launch(route)()
    split = launch("split")()
    torch.cuda.synchronize()
    return {"repeat_bitwise": torch.equal(again, out),
            "split_max_abs_err": err_of(split, ref), "split": split,
            "split_ms": time_ms(launch("split"), flush, host_ahead=True)}


def _stale(args, lens, quant):
    """The case's pools with every cell past each row's live length, and
    the scratch page, overwritten (fp: +-1e4; int8: 127 with scales 1e4).
    The blocks past each live length already map to the scratch page."""
    q, pk, pv, tables = args[:4]
    out = [t.clone() for t in (pk, pv) + tuple(args[5:])]
    for i, n in enumerate(lens):
        last = int(tables[i, (int(n) - 1) // PAGE])
        tail = slice((int(n) - 1) % PAGE + 1, None)
        for j, t in enumerate(out):
            t[last, tail] = (1e4 if j > 1 else 127) if quant else (
                1e4 if j == 0 else -1e4)
    for j, t in enumerate(out):
        t[0] = (1e4 if j > 1 else 127) if quant else (1e4 if j == 0
                                                      else -1e4)
    return (q, out[0], out[1], tables, args[4], *out[2:])


def phase_a(dev, flush):
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    kern = paged_attn.paged_decode_attention
    plain = paged_attn.paged_decode_attention_reference
    decode_lens = rng.integers(100, 2001, 4)
    cases = []

    def err_of(out, ref):
        return float((out.float() - ref.float()).abs().max())

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for name, (lens, sq, nb, pages, heads) in _shapes(
                dtype, decode_lens).items():
            h, kv, hd = heads
            args = _attn_case(rng, dev, dtype, lens, sq, nb, pages, heads)
            route = paged_attn._route(sq, h // kv, hd, dtype, False)
            small = heads != (H, KV, HD)
            check(not small or route == SMALL_ROUTES[dtype],
                  f"{name}: head_dim {hd} is not on the "
                  f"{SMALL_ROUTES[dtype]} route ({route})")
            before = (kern.launches_prefill, kern.launches_decode,
                      kern.launches_tf32x3, kern.launches_small)
            out = kern(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            check((kern.launches_prefill - before[0],
                   kern.launches_decode - before[1],
                   kern.launches_tf32x3 - before[2],
                   kern.launches_small - before[3])
                  == (route == "prefill", route == "decode",
                      route == "tf32x3", small),
                  f"{name}/{dname}: the {route} route did not launch")
            err = err_of(out, ref)
            rtol = (CHUNK_RTOL_BF16 if dtype == torch.bfloat16
                    and name not in ("decode", "prefill512") else 0.0)

            def share_of(x, ref=ref, rtol=rtol, dtype=dtype):
                return float(((x.float() - ref.float()).abs()
                              / (TOL[dtype] + rtol * ref.float().abs()))
                             .max())

            share = share_of(out)
            check(bool(torch.isfinite(out).all()), f"{name}/{dname}: nan")
            check(share <= 1.0, f"{name}/{dname}: max err {err} uses "
                  f"{share} of its limit (atol {TOL[dtype]}, rtol {rtol})")
            bound, by = _bound(args, dtype, route)
            alone = route != "prefill"   # on the device alone
            cases.append({
                "case": name, "dtype": dname, "route": route, "shape": {
                    "B": len(lens), "sq": sq, "H": h, "kv": kv, "hd": hd,
                    "page_tokens": PAGE, "n_blocks": nb,
                    "live": [int(n) for n in lens]},
                "max_abs_err": err, "tol_share": share,
                "tol": {"atol": TOL[dtype], "rtol": rtol},
                "ms": time_ms(lambda: kern(*args), flush, host_ahead=alone),
                "plain_ms": time_ms(lambda: plain(*args), flush,
                                    host_ahead=alone),
                "library_ms": time_ms(_sdpa_fn(args), flush,
                                      host_ahead=alone),
                "bound_ms": bound, "bound_by": by})
            if route == "tf32x3":      # the split kernel's f32-core bound
                (cases[-1]["bound_ms_f32_cores"],
                 cases[-1]["bound_by_f32_cores"]) = _bound(args, dtype)
            if route == "prefill":
                cases[-1].update(_route_timings(args, {}, ref, err_of, flush))
                cases[-1]["split_tol_share"] = share_of(
                    paged_attn._launch(*args, route="split"))
            if route in ("decode", "tf32x3"):
                timed = _decode_timings(args, {}, out, ref, err_of, flush,
                                        route)
                cases[-1]["split_tol_share"] = share_of(timed.pop("split"))
                cases[-1].update(timed)
                check(timed["repeat_bitwise"],
                      f"{name}/{dname}: two {route} launches differ")
            log({"phase": "A", **cases[-1]})
        # Stale K/V past each cursor and garbage in the scratch page (the
        # blocks past the live length map to it) change no output bit, on
        # the route decode takes (bf16: the decode route; f32: the tf32x3
        # route) and on the route of STALE_PREFILL's chunks (bf16: the
        # prefill route; f32: tf32x3 in 64-row tiles); also at the tiny
        # preset's shape, head_dim 16 (its decode, and two rows of 80
        # queries: bf16 tiles that each read their own key range).
        stale = [("decode" if dtype == torch.bfloat16 else "tf32x3",
                  decode_lens, 1, 64, 4 * 64 + 1, (H, KV, HD)),
                 ("prefill" if dtype == torch.bfloat16 else "tf32x3",
                  *STALE_PREFILL, (H, KV, HD))] + _tiny_stale(dtype)
        for route, lens, sq, nb, pages, heads in stale:
            args = _attn_case(rng, dev, dtype, lens, sq, nb, pages, heads)
            check(paged_attn._route(sq, heads[0] // heads[1], heads[2],
                                    dtype, False) == route,
                  f"stale case is not on the {route} route")
            base = kern(*args)
            args2 = _stale(args, lens, quant=False)
            same = torch.equal(kern(*args2), base)
            check(same, f"stale/scratch K/V changed the output ({dname}, "
                  f"{route})")
            err = err_of(base, plain(*args2))
            check(err <= TOL[dtype], f"stale/scratch vs plain: {err}")
            log({"phase": "A", "case": "stale_kv+scratch_page",
                 "dtype": dname, "route": route, "hd": heads[2],
                 "bitwise_unchanged": same, "max_abs_err": err})
    return cases


def _tiny_stale(dtype) -> list:
    """Phase A's stale-cell cases at head_dim 16: (route, live lengths,
    sq, n_blocks, pages, heads) at the tiny preset's shape, its decode step
    and the last 80 queries (160 rows a KV head) of its two longest
    prompts, on the route ``dtype`` takes there."""
    lens = [int(n) + 8 for n in _tiny_prompt_lengths()]
    longest = sorted(int(n) for n in _tiny_prompt_lengths())[-2:]
    route = SMALL_ROUTES[dtype]
    return [(route, lens, 1, TINY_BLOCKS, 8 * 5 + 1, TINY_HEADS),
            (route, longest, min(80, longest[0]), TINY_BLOCKS, 2 * 4 + 1,
             TINY_HEADS)]


def _quantized(args):
    """The case's pools quantized per token and KV head by the model's
    quantize-on-write: (q, int8 K, int8 V, tables, positions, K scales,
    V scales)."""
    from k8s_distributed_deeplearning_torch.models.transformer import (
        quantize_kv)

    q, pk, pv, tables, pos = args
    hd = q.shape[3]
    (kq, ks), (vq, vs) = (quantize_kv(
        p.view(p.shape[0], PAGE, p.shape[2] // hd, hd)) for p in (pk, pv))
    return (q, kq.view(pk.shape), vq.view(pv.shape), tables, pos, ks, vs)


def _int8_err(out, ref, dtype):
    """max |kernel - plain| and the largest share of the limit any element
    uses (f32: TOL; bf16: INT8_TOL_BF16)."""
    d = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        limit = torch.full_like(d, TOL[dtype])
    else:
        r = ref.float()
        limit = (INT8_TOL_BF16[0] * float(r.square().mean().sqrt())
                 + INT8_TOL_BF16[1] * r.abs())
    return float(d.max()), float((d / limit).max())


def phase_a_int8(dev, flush):
    """Phase A's cases through the kernels' int8 branch."""
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    rng = np.random.default_rng(10)
    torch.manual_seed(10)
    attn = paged_attn.paged_decode_attention
    plain = paged_attn.paged_decode_attention_reference
    decode_lens = rng.integers(100, 2001, 4)
    cases = []

    def scales(args):
        return dict(k_scale=args[5], v_scale=args[6])

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]

        def err_of(out, ref):
            return _int8_err(out, ref, dtype)[0]

        for name, (lens, sq, nb, pages, heads) in _shapes(
                dtype, decode_lens).items():
            h, kv, hd = heads
            args = _quantized(_attn_case(rng, dev, torch.float32, lens, sq,
                                         nb, pages, heads))
            args = (args[0].to(dtype),) + args[1:]
            base5, kw = args[:5], scales(args)
            route = paged_attn._route(sq, h // kv, hd, dtype, True)
            small = heads != (H, KV, HD)
            check(not small or route == SMALL_ROUTES[dtype],
                  f"int8 {name}: head_dim {hd} is not on the "
                  f"{SMALL_ROUTES[dtype]} route ({route})")
            before = (attn.launches_int8, attn.launches_prefill_int8,
                      attn.launches_decode_int8, attn.launches_tf32x3_int8,
                      attn.launches_small_int8)
            out = attn(*base5, **kw)
            want = plain(*base5, **kw)
            torch.cuda.synchronize()
            check((attn.launches_int8 - before[0],
                   attn.launches_prefill_int8 - before[1],
                   attn.launches_decode_int8 - before[2],
                   attn.launches_tf32x3_int8 - before[3],
                   attn.launches_small_int8 - before[4])
                  == (1, int(route == "prefill"), int(route == "decode"),
                      int(route == "tf32x3"), int(small)),
                  f"int8 {name}/{dname}: the {route} route did not launch")
            check(out.dtype == dtype and bool(torch.isfinite(out).all()),
                  f"int8 {name}/{dname}: {out.dtype} or non-finite")
            err, share = _int8_err(out, want, dtype)
            check(share <= 1.0, f"int8 {name}/{dname}: max err {err} uses "
                  f"{share} of its limit")
            q, kq, vq, tables, pos, ks, vs = args

            def deq(x, s, kv=kv, hd=hd):
                return (x.view(-1, PAGE, kv, hd).float() * s[..., None]).to(
                    dtype).view(x.shape)

            bound, by = _bound(args, dtype, route)
            alone = route != "prefill"   # on the device alone
            cases.append({
                "case": name, "dtype": dname, "branch": "int8",
                "route": route, "shape": {
                    "B": len(lens), "sq": sq, "H": h, "kv": kv, "hd": hd,
                    "page_tokens": PAGE, "n_blocks": nb,
                    "live": [int(n) for n in lens]},
                "max_abs_err": err, "tol_share": share,
                "tol": (TOL[dtype] if dtype == torch.float32 else
                        {"atol_rms": INT8_TOL_BF16[0],
                         "rtol": INT8_TOL_BF16[1]}),
                "ms": time_ms(lambda: attn(*base5, **kw), flush,
                              host_ahead=alone),
                "plain_ms": time_ms(lambda: plain(*base5, **kw), flush,
                                    host_ahead=alone),
                "library_ms": time_ms(_sdpa_fn(
                    (q, deq(kq, ks), deq(vq, vs), tables, pos)), flush,
                    host_ahead=alone),
                "bound_ms": bound, "bound_by": by})
            if route == "tf32x3":      # the split kernel's f32-core bound
                (cases[-1]["bound_ms_f32_cores"],
                 cases[-1]["bound_by_f32_cores"]) = _bound(args, dtype)
            if route == "prefill":
                cases[-1].update(_route_timings(base5, kw, want, err_of,
                                                flush))
                cases[-1]["split_tol_share"] = _int8_err(
                    paged_attn._launch(*base5, **kw, route="split"), want,
                    dtype)[1]
            if route in ("decode", "tf32x3"):
                timed = _decode_timings(base5, kw, out, want, err_of, flush,
                                        route)
                cases[-1]["split_tol_share"] = _int8_err(
                    timed.pop("split"), want, dtype)[1]
                cases[-1].update(timed)
                check(timed["repeat_bitwise"],
                      f"int8 {name}/{dname}: two {route} launches differ")
            log({"phase": "A", **cases[-1]})
        # Stale int8 cells past each cursor (127, scale 1e4) and garbage in
        # the scratch page and its scale page change no output bit, on the
        # route decode takes and on STALE_PREFILL's; also at the tiny
        # preset's shape, head_dim 16.
        stale = [("decode" if dtype == torch.bfloat16 else "tf32x3",
                  decode_lens, 1, 64, 4 * 64 + 1, (H, KV, HD)),
                 ("prefill" if dtype == torch.bfloat16 else "tf32x3",
                  *STALE_PREFILL, (H, KV, HD))] + _tiny_stale(dtype)
        for route, lens, sq, nb, pages, heads in stale:
            args = _quantized(_attn_case(rng, dev, torch.float32, lens, sq,
                                         nb, pages, heads))
            args = (args[0].to(dtype),) + args[1:]
            check(paged_attn._route(sq, heads[0] // heads[1], heads[2],
                                    dtype, True) == route,
                  f"int8 stale case is not on the {route} route")
            base = attn(*args[:5], **scales(args))
            args2 = _stale(args, lens, quant=True)
            same = torch.equal(attn(*args2[:5], **scales(args2)), base)
            check(same, f"int8 stale/scratch cells changed the output "
                  f"({dname}, {route})")
            err, share = _int8_err(base, plain(*args2[:5], **scales(args2)),
                                   dtype)
            check(share <= 1.0, f"int8 stale/scratch vs plain: {err}")
            log({"phase": "A", "case": "stale_kv+scratch_page",
                 "dtype": dname, "branch": "int8", "route": route,
                 "hd": heads[2], "bitwise_unchanged": same,
                 "max_abs_err": err, "tol_share": share})
    return cases


# ------------------------------------------------------------- phase B/C


def _requests(vocab, n_new, sampled):
    from k8s_distributed_deeplearning_torch.serve import (Request,
                                                          SamplingParams)

    rng = np.random.default_rng(1)
    lens = rng.integers(100, 1501, 8)
    reqs = []
    for i, n in enumerate(lens):
        sp = SamplingParams()
        if sampled and i == 2:
            sp = SamplingParams(temperature=0.8, top_k=50)
        elif sampled and i == 5:
            sp = SamplingParams(temperature=1.0, top_p=0.9)
        reqs.append(Request(prompt=rng.integers(0, vocab, int(n)).astype(
            np.int32), max_new_tokens=n_new, sampling=sp,
            request_id=f"r{i}", seed=100 + i))
    return reqs


def _timed(engine, name, acc):
    """Wrap ``engine.<name>`` so its device time (synchronized on both
    sides) accumulates in ``acc[name]``; final-chunk logits are checked
    finite on the way."""
    fn = getattr(engine, name)

    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        acc[name] += time.perf_counter() - t0
        if isinstance(out, torch.Tensor) and out.is_floating_point():
            check(bool(torch.isfinite(out).all()), f"{name}: non-finite")
        return out

    setattr(engine, name, wrapper)


def _serve_phase(phase, dev, quant: bool, first_logits=None):
    """Phases B and J: ``ServeEngine`` at full Llama-3 8B width and
    ``SERVE_LAYERS`` layers,
    bf16 random weights from seed 0, serving ``_requests``; J with int8 KV
    pages and int8 weights. Checks the outputs, the pool, and the paged
    kernel's launches by branch; returns the result and the streams.
    ``first_logits`` (a dict) keeps each request's first-token logits."""
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.ops import paged_attn
    from k8s_distributed_deeplearning_torch.serve import ServeEngine
    from k8s_distributed_deeplearning_torch.serve import quant as quant_lib

    cfg = llama.config_llama3_8b(max_seq_len=2048, n_layers=SERVE_LAYERS)
    kw = dict(kv_quant="int8", weight_quant="int8") if quant else {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = llama.LlamaLM(cfg, device=dev, seed=0)
    eng = ServeEngine(model, num_slots=4, prefill_chunk_tokens=512,
                      device=dev, **kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    resident = torch.cuda.memory_allocated() / 2 ** 30
    per_layer = ((torch.int8, torch.int8, torch.float32, torch.float32)
                 if quant else (cfg.dtype, cfg.dtype))
    check(all(tuple(t.dtype for t in layer) == per_layer
              for layer in eng._cache), f"pool dtypes are not {per_layer}")
    check(quant_lib.is_quantized(model) == quant,
          f"weights quantized: {quant_lib.is_quantized(model)}")
    torch.cuda.reset_peak_memory_stats()
    if first_logits is not None:
        _first_logits(eng, first_logits)
    acc = {"_prefill": 0.0, "_decode_step": 0.0}
    for name in acc:
        _timed(eng, name, acc)
    reqs = _requests(cfg.vocab_size, 32, sampled=True)
    free0 = eng.pool.available()
    attn = paged_attn.paged_decode_attention
    _zero_counts(attn)
    t0 = time.perf_counter()
    outs = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fp": attn.launches, "int8": attn.launches_int8}
    prefill_route = {"fp": attn.launches_prefill,
                     "int8": attn.launches_prefill_int8}
    decode_route = {"fp": attn.launches_decode,
                    "int8": attn.launches_decode_int8}
    check(len(outs) == 8, f"{len(outs)} of 8 requests finished")
    for o in outs:
        check(o.finish_reason == "length" and len(o.tokens) == 32,
              f"{o.request_id}: {o.finish_reason}, {len(o.tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in o.tokens),
              f"{o.request_id}: token outside the vocabulary")
    check(eng.pool.available() == free0 and eng.pool.reserved == 0,
          "KV pool pages leaked")
    summ = eng.stats.summary()
    chunks = sum(o.prefill_chunks for o in outs)
    want = cfg.n_layers * (summ["decode_steps"] + chunks)
    branch = "int8" if quant else "fp"
    check(launches == {"fp": 0, "int8": 0, branch: want},
          f"kernel launches {launches}: want {want} = n_layers x (decode "
          f"iterations {summ['decode_steps']} + prefill chunks {chunks}) "
          f"of the {branch} branch and none of the other")
    routes = {"decode": decode_route[branch],
              "prefill": prefill_route[branch],
              "split": (launches[branch] - prefill_route[branch]
                        - decode_route[branch])}
    check(routes == {"decode": cfg.n_layers * summ["decode_steps"],
                     "prefill": cfg.n_layers * chunks, "split": 0}
          and sum(prefill_route.values()) == routes["prefill"]
          and sum(decode_route.values()) == routes["decode"],
          f"launches by route {routes}: want n_layers x decode iterations "
          f"{summ['decode_steps']} on the decode route, n_layers x prefill "
          f"chunks {chunks} on the prefill route and none on the split "
          f"route")
    result = {
        "phase": phase, "model": "llama3-8b", "layers": cfg.n_layers,
        "dtype": "bfloat16", **kw, "slots": 4, "prefill_chunk_tokens": 512,
        "requests": 8, "prompt_tokens": summ["prompt_tokens"],
        "new_tokens": sum(len(o.tokens) for o in outs),
        "decode_iterations": summ["decode_steps"], "prefill_chunks": chunks,
        "kernel_launches": launches[branch], "route_launches": routes,
        "prefill_tokens_per_s": summ["prompt_tokens"] / acc["_prefill"],
        "decode_tokens_per_s": eng.stats.decode_tokens / acc["_decode_step"],
        "prefill_s": acc["_prefill"], "decode_s": acc["_decode_step"],
        "decode_iteration_ms": acc["_decode_step"] / summ["decode_steps"] * 1e3,
        "prefill_chunk_ms": acc["_prefill"] / chunks * 1e3,
        "wall_s": wall, "setup_s": setup_s,
        "ttft_p50_ms": summ["ttft_p50_ms"],
        "latency_p50_ms": summ["latency_p50_ms"],
        "mean_slot_occupancy": summ["mean_slot_occupancy"],
        "setup_peak_memory_gb": setup_peak,
        "resident_after_setup_gb": resident,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "bytes_per_page": {m or "fp": eng._block_nbytes(PAGE, kv_quant=m)
                           for m in (None, "int8")},
        **{k: summ[k] for k in ("kv_quant_bytes_saved",
                                "weight_quant_bytes_saved")}}
    streams = {o.request_id: o.tokens for o in outs}
    return result, streams, eng


def _zero_counts(attn) -> None:
    attn.launches = attn.launches_int8 = 0
    attn.launches_prefill = attn.launches_prefill_int8 = 0
    attn.launches_decode = attn.launches_decode_int8 = 0
    attn.launches_tf32x3 = attn.launches_tf32x3_int8 = 0
    attn.launches_small = attn.launches_small_int8 = 0


def phase_b(dev):
    store = {}
    result, streams, eng = _serve_phase("B", dev, quant=False,
                                        first_logits=store)
    # Phase R1 holds its first tokens to these (the profiles below admit
    # requests of their own).
    first_logits = {k: v.cpu() for k, v in store.items()}
    log(result)
    decode_profile("B", eng, result["layers"])
    result["prefill_profile"] = prefill_profile("B", eng, result["layers"])
    return result, streams, first_logits


def phase_j(dev, b_streams):
    result, streams, eng = _serve_phase("J", dev, quant=True)
    # A reading, not a gate: with random weights, near-ties of the greedy
    # argmax flip under int8 noise, and a flip changes the rest of that
    # stream.
    greedy = [rid for rid in sorted(streams) if rid not in ("r2", "r5")]
    same = sum(a == b for rid in greedy
               for a, b in zip(streams[rid], b_streams[rid]))
    total = sum(len(b_streams[rid]) for rid in greedy)
    first_diff = {rid: next((i for i, (a, b) in enumerate(
        zip(streams[rid], b_streams[rid])) if a != b), None)
        for rid in greedy}
    result.update({"greedy_tokens_equal_to_phase_b": same,
                   "greedy_tokens_compared": total,
                   "greedy_agreement_share": same / total,
                   "first_differing_token": first_diff})
    log(result)
    decode_profile("J", eng, result["layers"])
    result["prefill_profile"] = prefill_profile("J", eng, result["layers"])
    return result


def _kernel_class(name: str) -> str:
    for key, cls in (("paged_prefill", "paged_prefill"),
                     ("paged_decode", "paged_decode"),
                     ("paged_attn_tf32x3", "paged_attn_tf32x3"),
                     ("paged_attn_combine", "paged_attn_combine"),
                     ("paged_attn", "paged_attn"),
                     ("flash_fwd_kernel", "flash_fwd"),
                     ("flash_fwd_wgmma", "flash_fwd_wgmma"),
                     ("flash_fwd_tf32x3", "flash_fwd_tf32x3"),
                     ("flash_fwd_small", "flash_fwd_small"),
                     ("flash_dq_small", "flash_dq_small"),
                     ("flash_dkv_small", "flash_dkv_small"),
                     ("flash_dq_kernel", "flash_dq"),
                     ("flash_dkv_kernel", "flash_dkv"),
                     ("flash_dq_wgmma", "flash_dq_wgmma"),
                     ("flash_dkv_wgmma", "flash_dkv_wgmma"),
                     ("flash_dq_tf32x3", "flash_dq_tf32x3"),
                     ("flash_dkv_tf32x3", "flash_dkv_tf32x3"),
                     ("flash_delta_wgmma", "flash_delta_wgmma"),
                     ("flash_delta", "flash_delta"),
                     ("gmm_kernel", "gmm"),         # gmm_ and tgmm_kernel
                     ("gmm_wgmma", "gmm_wgmma"),    # gmm_ and tgmm_wgmma
                     ("gmm_tf32x3", "gmm_tf32x3")):
        if key in name:
            return cls
    if any(s in name for s in ("gemm", "gemv", "cutlass", "nvjet", "sm90")):
        return "matmul"
    return "other"


def _device_ms_by_kernel(prof, steps: int):
    """(name, launches, device ms per step) for every CUDA kernel in a
    ``torch.profiler`` run of ``steps`` steps, longest first. The
    ``ProfilerStep#n`` ranges that a schedule marks on the device span a
    step's kernels and are not counted."""
    from torch.autograd import DeviceType

    kernels = []
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CUDA
                and not e.key.startswith("ProfilerStep")):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            kernels.append((e.key, e.count, us / 1e3 / steps))
    kernels.sort(key=lambda k: -k[2])
    return kernels


def _by_class(kernels) -> dict:
    out: dict[str, float] = {}
    for name, _, ms in kernels:
        out[_kernel_class(name)] = out.get(_kernel_class(name), 0.0) + ms
    return out


def _profile_reps(fn, reps: int):
    """``torch.profiler`` over ``reps`` calls of ``fn``, after one warm-up
    call with the profiler already tracing and the device idle when the
    recorded window opens: kernels launched as tracing starts can be
    missing from its record, and the launch counts read from it are
    checked exactly."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=reps,
                                   repeat=1)) as prof:
        for i in range(reps + 1):
            fn()
            if i in (0, reps):
                torch.cuda.synchronize()
            prof.step()
    return prof


# Profiled windows to try before taking one whose kernel counts are not
# whole multiples of its calls.
PROFILE_TRIES = 3


def _profile(fn, reps: int) -> dict:
    """Where one call of ``fn`` goes, per call: the host clock over
    ``reps`` calls, then device time by kernel over ``reps`` more under
    ``torch.profiler``; the busy share divides the profiled device time by
    the unprofiled host time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    # Every call of ``fn`` launches the same kernels, so a kernel counted
    # other than a whole multiple of the calls lost records in the
    # profiler (a run read 125 of 128 prefill kernels): profile again.
    # The launch counts read from the profile stay checked exactly.
    for tries in range(1, PROFILE_TRIES + 1):
        kernels = _device_ms_by_kernel(_profile_reps(fn, reps), reps)
        if all(count % reps == 0 for _, count, _ in kernels):
            break
    device_ms = sum(k[2] for k in kernels)
    launches: dict[str, float] = {}
    for name, count, _ in kernels:
        cls = _kernel_class(name)
        launches[cls] = launches.get(cls, 0) + count / reps
    return {"reps": reps, "profile_tries": tries, "host_ms": host_ms,
            "device_ms": device_ms,
            "device_busy_share": device_ms / host_ms,
            "device_ms_by_class": _by_class(kernels),
            "launches": sum(launches.values()),
            "launches_by_class": launches,
            "top_kernels": [{"name": n[:90], "launches": c / reps,
                             "ms": ms} for n, c, ms in kernels[:10]]}


def decode_profile(phase, eng, n_layers, steps: int = 16):
    """Where a decode iteration's time goes, with every slot busy
    (:func:`_profile` over ``steps`` iterations)."""
    from k8s_distributed_deeplearning_torch.serve import Request

    vocab = eng.cfg.vocab_size
    rng = np.random.default_rng(2)
    for i in range(eng.num_slots):
        # Enough tokens for the host window and every profiled window
        # :func:`_profile` may take (``steps`` + 1 iterations each), with
        # room to fill the slots first.
        eng.submit(Request(prompt=rng.integers(0, vocab, 512).astype(np.int32),
                           max_new_tokens=(PROFILE_TRIES + 2) * (steps + 1),
                           request_id=f"p{i}"))
    while eng.occupied_slots() < eng.num_slots:
        eng.step()
    prof = _profile(eng.step, steps)
    check(eng.occupied_slots() == eng.num_slots,
          "a slot emptied inside the profiled decode window")
    eng.run()
    paged = {cls: prof["launches_by_class"].get(cls, 0)
             for cls in ("paged_decode", "paged_attn")}
    check(paged == {"paged_decode": n_layers, "paged_attn": 0},
          f"decode profile launches a step by class {paged}: want "
          f"{n_layers} of the decode kernel and none of the split kernel")
    log({"phase": phase, "case": "decode_profile", "slots": eng.num_slots,
         **prof, "launches_per_layer": prof["launches"] / n_layers})
    return prof


def _table(eng, n_tokens: int):
    """Fresh pool pages for ``n_tokens`` and a one-row block table over
    them (the rest on the scratch page)."""
    pages = eng.pool.alloc(-(-n_tokens // eng.page_tokens))
    table = np.zeros((1, eng.max_blocks), np.int32)
    table[0, :len(pages)] = pages
    return pages, table


def prefill_profile(phase, eng, n_layers, offset: int = 1024,
                    chunk: int = 512, reps: int = 4):
    """Where a prefill chunk's time goes (:func:`_profile`): a 512-token
    chunk at offset 1024 of a random prompt (the chunks before it written
    first). Then the same again with the split kernel forced in place of
    the prefill route, on the same card in the same run: the before and
    after of the route."""
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    vocab = eng.cfg.vocab_size
    prompt = np.random.default_rng(3).integers(
        0, vocab, offset + chunk).astype(np.int32)
    pages, table = _table(eng, offset + chunk)

    def run(start):
        eng._prefill(prompt[None, start:start + chunk], table, start, None)

    for start in range(0, offset + 1, chunk):
        run(start)
    result = {"phase": phase, "case": "prefill_profile", "offset": offset,
              "chunk_tokens": chunk, "reps": reps}
    routed = paged_attn._route
    try:
        for route in ("prefill", "split"):
            paged_attn._route = lambda *a, route=route: route
            run(offset)
            result[route] = _profile(lambda: run(offset), reps)
    finally:
        paged_attn._route = routed
        for page in pages:
            eng.pool.deref(page)
    got = {route: result[route]["launches_by_class"]
           for route in ("prefill", "split")}
    check(got["prefill"].get("paged_prefill") == n_layers
          and "paged_attn" not in got["prefill"]
          and got["split"].get("paged_attn", 0) >= n_layers
          and "paged_prefill" not in got["split"],
          f"prefill chunk launches by class {got}: want {n_layers} of the "
          "prefill kernel on its route and none of the split kernel, and "
          "the reverse with the split kernel forced")
    result["device_ms_saved_per_chunk"] = (
        result["split"]["device_ms"]
        - result["prefill"]["device_ms"])
    log(result)
    return result


def _split_launches(attn, branch: str) -> int:
    """The paged wrapper's launches of ``branch`` ("fp" or "int8") on the
    split route since the last ``_zero_counts``: the branch's total less
    its other routes'."""
    if branch == "fp":
        return (attn.launches - attn.launches_decode - attn.launches_prefill
                - attn.launches_tf32x3)
    return (attn.launches_int8 - attn.launches_decode_int8
            - attn.launches_prefill_int8 - attn.launches_tf32x3_int8)


def _paths_phase(phase, dev, quant: bool):
    """Phases C and K: f32 at 8B width and 4 layers, greedy, the kernel
    path (``attention_impl="auto"``) against the plain path (``"xla"``); K
    with int8 KV pages and int8 weights. The first 16 tokens of every
    request agree, and only the kernel path launches the kernel, every
    launch on the tf32x3 route. Then the serve CLI's default preset
    (:func:`_tiny_run`)."""
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.ops import paged_attn
    from k8s_distributed_deeplearning_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(kv_quant="int8", weight_quant="int8") if quant else {}
    attn = paged_attn.paged_decode_attention
    streams, launches = {}, {}
    for impl in ("auto", "xla"):
        cfg = llama.config_llama3_8b(max_seq_len=2048, n_layers=4,
                                     dtype=torch.float32,
                                     attention_impl=impl)
        model = llama.LlamaLM(cfg, device=dev, seed=0)
        eng = ServeEngine(model, num_slots=4, prefill_chunk_tokens=512,
                          device=dev, **kw)
        _zero_counts(attn)
        outs = eng.run(_requests(cfg.vocab_size, 16, sampled=False))
        launches[impl] = {"fp": attn.launches, "int8": attn.launches_int8,
                          "tf32x3": attn.launches_tf32x3,
                          "tf32x3_int8": attn.launches_tf32x3_int8,
                          "split": _split_launches(
                              attn, "int8" if quant else "fp")}
        streams[impl] = {o.request_id: o.tokens for o in outs}
        del model, eng
        gc.collect()
        torch.cuda.empty_cache()
    agree = {rid: streams["auto"][rid] == streams["xla"][rid]
             for rid in sorted(streams["auto"])}
    result = {"phase": phase, "model": "llama3-8b width, 4 layers",
              "dtype": "float32", **kw, "requests": len(agree),
              "tokens_compared": 16, "launches": launches,
              "streams_agree": agree}
    log(result)
    check(len(agree) == 8 and all(agree.values()),
          "kernel-path and plain-path greedy streams differ")
    branch = "int8" if quant else "fp"
    tf32x3 = "tf32x3_int8" if quant else "tf32x3"
    check(launches["auto"][branch] > 0 and not any(
        launches["xla"].values()) and not launches["auto"][
            "fp" if quant else "int8"],
          f"launches by path {launches}: the {branch} branch on the kernel "
          "path only")
    check(launches["auto"][tf32x3] == launches["auto"][branch]
          and launches["auto"]["split"] == 0,
          f"launches by path {launches}: every f32 {branch} launch on the "
          "tf32x3 route, none on the split route")
    result["tiny_preset"] = _tiny_run(phase, dev, quant)
    return result


def _tiny_run(phase, dev, quant: bool):
    """The serve CLI's default preset (``--preset tiny``: the test
    topology in f32, 4/2 heads at head_dim 16, on the tf32x3 kernel;
    with ``quant`` its int8 KV pages and weights) through the
    kernel path and the plain path: 8 greedy requests of 32-128 prompt
    tokens and 16 new on 8 slots, as the CLI's defaults draw them. The
    streams agree and every paged launch of the kernel path is on the
    tf32x3 route at head_dim 16 (``launches_small``), none on the split
    route."""
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.ops import paged_attn
    from k8s_distributed_deeplearning_torch.serve import (Request,
                                                          ServeEngine)

    kw = dict(kv_quant="int8", weight_quant="int8") if quant else {}
    branch = "int8" if quant else "fp"
    attn = paged_attn.paged_decode_attention
    rng = np.random.default_rng(TINY_SEED)
    prompts = [rng.integers(0, 256, int(n)).astype(np.int32)
               for n in rng.integers(32, 129, 8)]
    streams, launches = {}, {}
    for impl in ("auto", "xla"):
        cfg = llama.config_tiny(max_seq_len=512, dtype=torch.float32,
                                attention_impl=impl)
        model = llama.LlamaLM(cfg, device=dev, seed=0)
        eng = ServeEngine(model, num_slots=8, device=dev, **kw)
        _zero_counts(attn)
        outs = eng.run([Request(prompt=p, max_new_tokens=16,
                                request_id=f"t{i}")
                        for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        sfx = "_int8" if quant else ""
        launches[impl] = {
            "fp": attn.launches, "int8": attn.launches_int8,
            "tf32x3": getattr(attn, "launches_tf32x3" + sfx),
            "small": getattr(attn, "launches_small" + sfx),
            "split": _split_launches(attn, branch)}
        streams[impl] = {o.request_id: o.tokens for o in outs}
        del model, eng
    agree = {r: streams["auto"][r] == streams["xla"][r]
             for r in sorted(streams["auto"])}
    result = {"phase": phase, "case": "tiny_preset",
              "model": "config_tiny (dim 64, 4/2 heads, head_dim 16)",
              "dtype": "float32", **kw, "requests": len(agree),
              "tokens_compared": 16, "launches": launches,
              "streams_agree": agree}
    log(result)
    check(len(agree) == 8 and all(agree.values()),
          "tiny preset: kernel-path and plain-path greedy streams differ")
    auto = launches["auto"]
    check(auto["tf32x3"] == auto["small"] == auto[branch] > 0
          and auto["split"] == 0 and not any(launches["xla"].values()),
          f"tiny preset launches by path {launches}: every {branch} launch "
          "of the kernel path on the tf32x3 route at head_dim 16, none on "
          "the split route")
    return result


def _bf16_prefill_logits(phase, dev, quant: bool):
    """The prefill route on the model path, in bf16 (phases C and K run in
    f32, which never reaches it): at 8B width and 4 layers, every
    request's prompt prefilled in 512-token chunks (the final one bucketed
    as the engine does) through the kernel path and the plain path
    (``"xla"``), with the same weights. The last position's logits agree
    within BF16_LOGIT_RTOL (relative L2 per request), and the first greedy
    token is equal wherever the plain path's top-2 margin exceeds twice
    that request's largest logit difference."""
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.ops import paged_attn
    from k8s_distributed_deeplearning_torch.serve import ServeEngine

    kw = dict(kv_quant="int8", weight_quant="int8") if quant else {}
    attn = paged_attn.paged_decode_attention
    logits, launches, chunks = {}, {}, 0
    for impl in ("auto", "xla"):
        cfg = llama.config_llama3_8b(max_seq_len=2048, n_layers=4,
                                     dtype=torch.bfloat16,
                                     attention_impl=impl)
        model = llama.LlamaLM(cfg, device=dev, seed=0)
        eng = ServeEngine(model, num_slots=2, prefill_chunk_tokens=512,
                          device=dev, **kw)
        _zero_counts(attn)
        rows, chunks = [], 0
        for req in _requests(cfg.vocab_size, 16, sampled=False):
            n = len(req.prompt)
            pages, table = _table(eng, n)
            start = 0
            while n - start > 512:
                eng._prefill(req.prompt[None, start:start + 512], table,
                             start, None)
                start += 512
                chunks += 1
            rem = n - start
            last = np.full((1, eng._bucket(rem)), eng.pad_id, np.int32)
            last[0, :rem] = req.prompt[start:]
            rows.append(eng._prefill(last, table, start, rem - 1).float())
            chunks += 1
            for page in pages:
                eng.pool.deref(page)
        logits[impl] = torch.cat(rows)
        launches[impl] = {"fp": attn.launches, "int8": attn.launches_int8,
                          "prefill_fp": attn.launches_prefill,
                          "prefill_int8": attn.launches_prefill_int8}
        del model, eng
        gc.collect()
        torch.cuda.empty_cache()
    branch = "int8" if quant else "fp"
    want = {k: 0 for k in launches["auto"]}
    want.update({branch: cfg.n_layers * chunks,
                 f"prefill_{branch}": cfg.n_layers * chunks})
    check(launches["auto"] == want and not any(launches["xla"].values()),
          f"bf16 prefill launches by path {launches}: want {want} on the "
          "kernel path, none on the plain path")
    kern, ref = logits["auto"], logits["xla"]
    diff = (kern - ref).abs()
    rel = ((kern - ref).norm(dim=-1) / ref.norm(dim=-1)).tolist()
    largest = diff.max(dim=-1).values
    top2 = ref.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    decided = margin > 2 * largest
    same = kern.argmax(-1) == ref.argmax(-1)
    result = {"phase": phase, "case": "bf16_prefill_logits",
              "model": "llama3-8b width, 4 layers", "dtype": "bfloat16",
              **kw, "requests": len(rel), "prefill_chunks": chunks,
              "launches": launches, "logit_rel_l2": rel,
              "rtol": BF16_LOGIT_RTOL,
              "max_abs_diff_over_rms": float(diff.max()
                                             / ref.square().mean().sqrt()),
              "first_token_decided": decided.tolist(),
              "first_token_equal": same.tolist()}
    log(result)
    check(all(np.isfinite(rel)) and max(rel) <= BF16_LOGIT_RTOL,
          f"bf16 prefill logits: relative L2 {max(rel)} > {BF16_LOGIT_RTOL}")
    check(bool(same[decided].all()),
          "bf16 prefill: a first greedy token differs where the plain "
          "path's top-2 margin exceeds twice the largest logit difference")
    return result


def phase_c(dev):
    result = _paths_phase("C", dev, quant=False)
    result["bf16_prefill"] = _bf16_prefill_logits("C", dev, quant=False)
    return result


def phase_k(dev):
    result = _paths_phase("K", dev, quant=True)
    result["bf16_prefill"] = _bf16_prefill_logits("K", dev, quant=True)
    return result


# ------------------------------------------------------------- phase P

# Phase P's traffic: a shared prefix of 1,024 tokens (32 pages) before
# 100-500-token tails, 32 new tokens; one warm request first, since a
# prefix enters the trie only when its prefill finishes.
P_PREFIX, P_TAILS, P_NEW = 1024, (100, 501), 32
# 256 MiB of trie: one 32-token page over 16 layers is 2 MiB, so the
# prefix's 32 pages take 64 MiB.
P_CACHE_MB = 256
# The two tenants of P3, as a user's config file would give them.
P_TENANTS = json.dumps({"tenants": [
    {"id": "interactive", "priority": "interactive", "weight": 2},
    {"id": "batch", "priority": "batch", "max_slots": 2}]})
# Phase P's verify windows at 8B heads, B's decode-profile lengths (live
# 512-560 of 64 blocks), name -> (window, int8 pools): W 4 is 16 rows a KV
# head, W 5-15 20-60 rows, all on the decode route; W 16 is 64 rows, the
# boundary between the decode and prefill routes, timed on both.
VERIFY_CASES = {"verify_w4": (4, False), "verify_w5": (5, False),
                "verify_w8": (8, False), "verify_w15": (15, False),
                "verify_w16": (16, False), "verify_w8_int8": (8, True)}


def _prefix_requests(vocab, n_new, seed=4):
    """The warm request and the 8 requests of P1, sharing one prefix."""
    from k8s_distributed_deeplearning_torch.serve import Request

    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, P_PREFIX)
    reqs = [Request(prompt=np.concatenate([shared, rng.integers(
        0, vocab, int(rng.integers(*P_TAILS)))]).astype(np.int32),
        max_new_tokens=n_new, request_id=f"p{i}") for i in range(9)]
    return reqs[0], reqs[1:]


def _route_counts(attn) -> dict:
    """The paged kernels' fp launches since the last ``_zero_counts``, by
    route, and the int8 branch's in all."""
    return {"decode": attn.launches_decode,
            "prefill": attn.launches_prefill,
            "tf32x3": attn.launches_tf32x3,
            "split": _split_launches(attn, "fp"),
            "int8": attn.launches_int8}


def _f32_want(want: dict) -> dict:
    """A bf16 run's launches by route (``want``) as the same run in f32
    makes them: every launch on the tf32x3 route."""
    return {**{k: 0 for k in want}, "tf32x3": sum(want.values())}


def _first_logits(engine, store, keep_first=False):
    """Keep, by request id, the logits the final prefill chunk samples
    each request's first token from (with ``keep_first``, the first such
    prefill's: a request resubmitted by a migration prefills again)."""
    prefill, finish = engine._prefill, engine._finish_admission
    current = {}

    def finish_admission(slot, pend):
        current["rid"] = pend.req.request_id
        return finish(slot, pend)

    def wrapper(chunk, table, start, logits_index, **kw):
        out = prefill(chunk, table, start, logits_index, **kw)
        if logits_index is not None and not kw.get("draft") and not (
                keep_first and current["rid"] in store):
            store[current["rid"]] = out.float()
        return out

    engine._finish_admission = finish_admission
    engine._prefill = wrapper


def _clean_after(eng, what):
    """Shut ``eng`` down and check that no page is held or reserved."""
    eng.shutdown()
    leak = eng._check_page_leaks(what)
    c = eng.pool.counters()
    check(leak is None and c["pages_used"] == 0 and eng.pool.reserved == 0,
          f"{what}: pages held after shutdown: {leak}")
    return {"pages_used_after": c["pages_used"],
            "pages_reserved_after": eng.pool.reserved}


def _first_token_rule(kern, ref):
    """Phase C's rule on first-token logits [N, V]: equal first tokens
    where the reference's top-2 margin exceeds twice the largest logit
    difference."""
    diff = (kern - ref).abs().max(dim=-1).values
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * diff
    same = kern.argmax(-1) == ref.argmax(-1)
    return decided, same


def _p1_run(model, dev, cache_mb, n_new):
    """P1's traffic through a 4-slot engine (512-token chunks), the cache
    off (None) or on: the warm request, then the 8, whose launches are
    counted by route. Returns (result, streams, first-token logits)."""
    from k8s_distributed_deeplearning_torch.ops import paged_attn
    from k8s_distributed_deeplearning_torch.serve import ServeEngine

    attn = paged_attn.paged_decode_attention
    eng = ServeEngine(model, num_slots=4, prefill_chunk_tokens=512,
                      prefix_cache_mb=cache_mb, device=dev)
    logits = {}
    _first_logits(eng, logits)
    acc = {"_prefill": 0.0, "_decode_step": 0.0}
    for name in acc:
        _timed(eng, name, acc)
    warm, reqs = _prefix_requests(model.cfg.vocab_size, n_new)
    eng.run([warm])
    for name in acc:
        acc[name] = 0.0
    steps0 = eng.stats.steps
    _zero_counts(attn)
    t0 = time.perf_counter()
    outs = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    routes = _route_counts(attn)
    check(len(outs) == 8 and all(o.finish_reason == "length"
                                 and len(o.tokens) == n_new for o in outs),
          f"P1: {[(o.finish_reason, len(o.tokens)) for o in outs]}")
    layers = model.cfg.n_layers
    chunks = sum(o.prefill_chunks for o in outs)
    steps = eng.stats.steps - steps0
    want = {"decode": layers * steps, "prefill": layers * chunks,
            "tf32x3": 0, "split": 0, "int8": 0}
    if model.cfg.dtype == torch.float32:
        want = _f32_want(want)
    check(routes == want, f"P1 launches by route {routes}: want {want} "
          f"(layers x decode iterations {steps}, layers x prefill "
          f"chunks {chunks})")
    hit = sum(o.cached_prompt_tokens for o in outs)
    prompt = sum(o.prompt_len for o in outs)
    ttft = sorted(o.ttft_s * 1e3 for o in outs)
    summ = eng.stats.summary()
    result = {
        "prefix_cache_mb": cache_mb, "requests": 8, "prompt_tokens": prompt,
        "hit_tokens": hit, "prefill_tokens_computed": prompt - hit,
        "hits": [o.cached_prompt_tokens for o in outs],
        "prefill_chunks": chunks, "decode_iterations": steps,
        "prefill_s": acc["_prefill"],
        "prefill_tokens_per_s": (prompt - hit) / acc["_prefill"],
        "decode_tokens_per_s": sum(len(o.tokens) - 1 for o in outs)
        / acc["_decode_step"],
        "ttft_p50_ms": float(np.median(ttft)), "ttft_ms": ttft,
        "wall_s": wall, "route_launches": routes,
        "kv_pages_shared_max": summ["kv_pages_shared"],
        "prefix_cache_hits": summ["prefix_cache_hits"],
        "prefix_hit_rate": summ["prefix_hit_rate"]}
    result.update(_clean_after(eng, f"P1 cache {cache_mb}"))
    streams = {o.request_id: o.tokens for o in outs}
    return result, streams, {k: v for k, v in logits.items()
                             if k != warm.request_id}


def _spec_run(model, dev, reqs, draft, spec_k, profile=False):
    """B's engine settings with ``draft``/``spec_k`` (None/0: plain
    decode) over ``reqs``. Checks the launches by route exactly; returns
    (result, outputs by request id)."""
    from k8s_distributed_deeplearning_torch.ops import paged_attn
    from k8s_distributed_deeplearning_torch.serve import ServeEngine

    attn = paged_attn.paged_decode_attention
    eng = ServeEngine(model, num_slots=4, prefill_chunk_tokens=512,
                      draft_model=draft, spec_k=spec_k, device=dev)
    name = "_spec_decode" if spec_k else "_decode_step"
    acc = {"_prefill": 0.0, name: 0.0}
    if model.cfg.dtype == torch.bfloat16:
        for n in acc:
            _timed(eng, n, acc)
    _zero_counts(attn)
    t0 = time.perf_counter()
    outs = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    routes = _route_counts(attn)
    summ = eng.stats.summary()
    check(len(outs) == len(reqs), f"{len(outs)} of {len(reqs)} finished")
    lt = model.cfg.n_layers
    ld = draft.cfg.n_layers if draft is not None else 0
    chunks = sum(o.prefill_chunks for o in outs)
    steps = summ["decode_steps"]
    if spec_k:
        w_route = paged_attn._route(spec_k + 1, H // KV, HD, model.cfg.dtype,
                                    False)
        want = {"decode": steps * (spec_k + 1) * ld,
                "prefill": chunks * (lt + ld), "tf32x3": 0, "split": 0,
                "int8": 0}
        want[w_route] += steps * lt
    else:
        w_route = None
        want = {"decode": steps * lt, "prefill": chunks * lt, "tf32x3": 0,
                "split": 0, "int8": 0}
    if model.cfg.dtype == torch.float32:
        want = _f32_want(want)
    check(routes == want,
          f"spec_k {spec_k}: launches by route {routes}, want {want} "
          f"({steps} iterations, {chunks} prefill chunks)")
    result = {"spec_k": spec_k, "draft_layers": ld,
              "verify_route": w_route, "requests": len(outs),
              "decode_iterations": steps, "prefill_chunks": chunks,
              "route_launches": routes, "wall_s": wall,
              "decode_tokens": eng.stats.decode_tokens,
              "spec_acceptance_rate": summ["spec_acceptance_rate"],
              "spec_accept_hist": summ["spec_accept_hist"]}
    if model.cfg.dtype == torch.bfloat16:
        result.update({
            "decode_s": acc[name],
            "decode_tokens_per_s": eng.stats.decode_tokens / acc[name],
            "decode_iteration_ms": acc[name] / steps * 1e3,
            "prefill_s": acc["_prefill"]})
    if profile:
        result["verify_profile"] = _verify_profile(eng, spec_k)
    result.update(_clean_after(eng, f"spec_k {spec_k}"))
    return result, {o.request_id: o for o in outs}


def _verify_profile(eng, spec_k, reps: int = 8):
    """A verify pass's host and device ms with every slot busy, by
    :func:`_profile`."""
    from k8s_distributed_deeplearning_torch.ops import paged_attn
    from k8s_distributed_deeplearning_torch.serve import Request

    vocab = eng.cfg.vocab_size
    rng = np.random.default_rng(2)
    for i in range(eng.num_slots):
        eng.submit(Request(prompt=rng.integers(0, vocab, 512).astype(
            np.int32), max_new_tokens=(spec_k + 1) * 4 * reps,
            request_id=f"v{i}"))
    while eng.occupied_slots() < eng.num_slots:
        eng.step()
    window = eng._spec_draft_step()
    prof = _profile(lambda: eng._spec_verify_step(window), reps)
    check(eng.occupied_slots() == eng.num_slots,
          "a slot emptied inside the profiled window")
    check(paged_attn._route(spec_k + 1, H // KV, HD, torch.bfloat16,
                            False) == "decode",
          f"a verify window of {spec_k + 1} is not on the decode route")
    layers = eng.cfg.n_layers
    want = {"paged_decode": layers, "paged_attn": 0, "paged_attn_combine": 0}
    got = {cls: prof["launches_by_class"].get(cls, 0) for cls in want}
    check(got == want,
          f"verify profile: launches by class {got}, want {want} "
          f"({layers} layers: the decode kernel once a layer, no split "
          f"kernel)")
    return {f: prof[f] for f in ("host_ms", "device_ms",
                                 "device_busy_share", "device_ms_by_class",
                                 "launches_by_class")}


def _verify_cases(dev, flush):
    """The verify windows alone at 8B heads (bf16 q, B's decode-profile
    lengths, fp or int8 pools): the kernel of their route against the
    plain version (phase A's decode limits), with its time, the plain
    version's, SDPA's and the bound; on the decode route also the split
    kernel's error and time on the same inputs and a second launch
    bitwise equal; at 64 rows the decode and prefill kernels' times."""
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    rng = np.random.default_rng(6)
    kern = paged_attn.paged_decode_attention
    plain = paged_attn.paged_decode_attention_reference
    lens, nb, pages = DECODE_CASES["decode_b_profile"]
    bf16 = torch.bfloat16
    cases = []
    for name, (w, quant) in VERIFY_CASES.items():
        if quant:
            args = _quantized(_attn_case(rng, dev, torch.float32, lens, w,
                                         nb, pages))
            args = (args[0].to(bf16),) + args[1:]
            q, kq, vq, tables, pos, ks, vs = args
            base, kw = args[:5], dict(k_scale=ks, v_scale=vs)
            sdpa_args = tuple(
                (x.view(-1, PAGE, KV, HD).float() * s[..., None]).to(
                    bf16).view(x.shape) for x, s in ((kq, ks), (vq, vs)))
            sdpa_args = (q, *sdpa_args, tables, pos)
        else:
            args = base = sdpa_args = _attn_case(rng, dev, bf16, lens, w, nb,
                                                 pages)
            kw = {}

        def err_of(x, ref, quant=quant):
            if quant:
                return _int8_err(x, ref, bf16)
            e = float((x.float() - ref.float()).abs().max())
            return e, e / TOL[bf16]

        route = paged_attn._route(w, H // KV, HD, bf16, quant)
        out, ref = kern(*base, **kw), plain(*base, **kw)
        torch.cuda.synchronize()
        err, share = err_of(out, ref)
        check(bool(torch.isfinite(out).all()) and share <= 1.0,
              f"{name}: max err {err} uses {share} of its limit")
        bound, by = _bound(args, bf16)
        case = {"case": name, "dtype": "bfloat16",
                "branch": "int8" if quant else "fp", "route": route,
                "shape": {"B": len(lens), "sq": w, "H": H, "kv": KV,
                          "hd": HD, "page_tokens": PAGE, "n_blocks": nb,
                          "live": list(lens)},
                "max_abs_err": err, "tol_share": share,
                "ms": time_ms(lambda: kern(*base, **kw), flush,
                              host_ahead=True),
                "plain_ms": time_ms(lambda: plain(*base, **kw), flush,
                                    host_ahead=True),
                "library_ms": time_ms(_sdpa_fn(sdpa_args), flush,
                                      host_ahead=True),
                "bound_ms": bound, "bound_by": by}
        if route == "decode":
            timed = _decode_timings(base, kw, out, ref,
                                    lambda x, r: err_of(x, r)[0], flush)
            case["split_tol_share"] = err_of(timed.pop("split"), ref)[1]
            check(timed["repeat_bitwise"], f"{name}: two launches differ")
            case.update(timed)
        if w * (H // KV) == paged_attn._DECODE_MAX_ROWS:
            # The boundary: both tensor-core kernels on the same inputs.
            for other in ("decode", "prefill"):
                x = paged_attn._launch(*base, **kw, route=other)
                torch.cuda.synchronize()
                e, sh = err_of(x, ref)
                check(sh <= 1.0, f"{name} on the {other} route: max err "
                      f"{e} uses {sh} of its limit")
                case[f"{other}_ms"] = time_ms(
                    lambda other=other: paged_attn._launch(
                        *base, **kw, route=other), flush, host_ahead=True)
        log({"phase": "P", **case})
        cases.append(case)
    return cases


def phase_p(dev, flush):
    """The engine's host surface at Llama-3 8B: P1 the prefix cache, P2
    speculative decoding, P3 request control under two tenants (bf16,
    16 layers, random weights from seed 0, B's engine settings), with
    the exact gates at 4 layers in f32. Returns the results and the
    verify-window kernel cases."""
    from k8s_distributed_deeplearning_torch.models import llama

    result = {"phase": "P", "model": "llama3-8b", "layers": SERVE_LAYERS}
    cfg = llama.config_llama3_8b(max_seq_len=2048, n_layers=SERVE_LAYERS)
    t0 = time.perf_counter()
    model = llama.LlamaLM(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    result["setup_s"] = time.perf_counter() - t0

    # ---- P1: the prefix cache, off and on.
    p1, streams, logits = {}, {}, {}
    for mb in (None, P_CACHE_MB):
        key = "cache_on" if mb else "cache_off"
        p1[key], streams[key], logits[key] = _p1_run(model, dev, mb, P_NEW)
        log({"phase": "P1", "case": key, **p1[key]})
    on, off = p1["cache_on"], p1["cache_off"]
    check(on["hits"] == [P_PREFIX] * 8 and off["hit_tokens"] == 0,
          f"P1 hits {on['hits']} / {off['hits']}: want {P_PREFIX} each "
          "with the cache on, none off")
    check(on["prefill_chunks"] < off["prefill_chunks"],
          "P1: the cache ran no fewer prefill chunks")
    rids = sorted(logits["cache_off"])
    decided, same = _first_token_rule(
        torch.cat([logits["cache_on"][r] for r in rids]),
        torch.cat([logits["cache_off"][r] for r in rids]))
    check(bool(same[decided].all()),
          "P1 bf16: a first token differs with the cache on where the "
          "margin decides it")
    agree = sum(a == b for r in rids for a, b in zip(
        streams["cache_on"][r], streams["cache_off"][r]))
    p1["bf16_agreement"] = {
        "first_token_decided": decided.tolist(),
        "first_token_equal": same.tolist(),
        "tokens_equal": agree, "tokens": 8 * P_NEW,
        "share": agree / (8 * P_NEW)}

    log({"phase": "P1", "case": "bf16_agreement", **p1["bf16_agreement"],
         "setup_s": result["setup_s"], "since_p_s": time.perf_counter()
         - t0})

    # ---- P2: speculative decoding against plain decode, on B's requests
    # all greedy (the sampled streams are held exactly in f32 below).
    reqs = _requests(cfg.vocab_size, P_NEW, sampled=False)
    draft2 = llama.LlamaLM(llama.config_llama3_8b(max_seq_len=2048,
                                                  n_layers=2),
                           device=dev, seed=1)
    p2 = {}
    base, base_outs = _spec_run(model, dev, _copy(reqs), None, 0)
    p2["plain"] = base
    log({"phase": "P2", "case": "plain", **base})
    for key, draft, k in (("self_k3", model, 3), ("self_k7", model, 7),
                          ("draft2_k3", draft2, 3)):
        p2[key], outs = _spec_run(model, dev, _copy(reqs), draft, k,
                                  profile=key.startswith("self"))
        p2[key]["tokens_equal_plain"] = sum(
            a == b for r in outs for a, b in zip(outs[r].tokens,
                                                 base_outs[r].tokens))
        p2[key]["tokens"] = sum(len(o.tokens) for o in base_outs.values())
        log({"phase": "P2", "case": key, **p2[key],
             "since_p_s": time.perf_counter() - t0})
    check(all(r["route_launches"]["split"] == 0 for r in p2.values())
          and p2["self_k7"]["verify_route"] == "decode"
          and p2["self_k3"]["verify_route"] == "decode",
          "P2: a bf16 run launched the split kernel, or a verify window "
          "left the decode route")
    del draft2

    # ---- P3: control and tenants.
    p3 = _control_run(model, dev)
    log({"phase": "P3", **p3, "since_p_s": time.perf_counter() - t0})
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # ---- The serve CLI's small preset with the micro draft (head_dim 16).
    result["small_micro"] = _small_micro_run(dev)

    # ---- The exact gates, at 4 layers in f32.
    exact = _exact_gates(dev)
    log({"phase": "P", "case": "f32_exact", **exact,
         "since_p_s": time.perf_counter() - t0})
    result.update({"p1": p1, "p2": p2, "p3": p3, "f32_exact": exact})
    return result, _verify_cases(dev, flush)


SMALL_MICRO_SPEC_K = 3
SMALL_MICRO_REQUESTS = 16        # of the CLI's 32 defaults


def _small_micro_engine(dev, dtype, draft: bool):
    """The serve CLI's ``--preset small [--draft-model micro --spec-k
    3]`` engine (its defaults: 8 slots, max_seq_len 512, no chunking),
    random weights from seeds 0 and 1, in ``dtype``."""
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.serve import ServeEngine

    cfg = llama.config_tiny(vocab_size=32000, dim=768, n_layers=12,
                            n_heads=12, n_kv_heads=4, mlp_dim=2048,
                            max_seq_len=512, dtype=dtype)
    model = llama.LlamaLM(cfg, device=dev, seed=0)
    micro = None
    if draft:
        micro = llama.LlamaLM(llama.config_tiny(
            vocab_size=32000, dim=32, n_layers=1, n_heads=2, n_kv_heads=1,
            mlp_dim=64, max_seq_len=512, dtype=dtype), device=dev, seed=1)
    return ServeEngine(model, num_slots=8, device=dev, draft_model=micro,
                       spec_k=SMALL_MICRO_SPEC_K if draft else 0)


def _cli_requests(n: int):
    """The first ``n`` of the serve CLI's default requests (seed 0:
    prompts of 32-128 tokens, 16-64 new, greedy), as it draws them."""
    from k8s_distributed_deeplearning_torch.serve import Request

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(n):
        prompt = rng.integers(0, 32000, size=int(rng.integers(32, 129)))
        reqs.append(Request(prompt=prompt.astype(np.int32),
                            max_new_tokens=int(rng.integers(16, 65)),
                            seed=i, request_id=f"c{i}"))
    return reqs


def _small_micro_run(dev):
    """The serve CLI's small preset (12 layers, 12/4 heads at head_dim
    64) plain and with the micro draft (1 layer, 2/1 heads at head_dim
    16) at spec_k 3, the first 16 of the CLI's default requests, greedy
    (8 slots, two waves). In bf16, the
    CLI's dtype for the preset: every paged launch by route exact (the
    target's decode steps and verify windows on the decode route, its
    prompts on the prefill route, every draft launch, prefill chunks
    included, on the decode route at head_dim 16; split 0), the greedy
    tokens equal to the plain run's as a reading (bf16 rounds the
    verify pass and single-token decode differently: phase P2's 8B runs
    read 198-230 of 256, this case 1,326 of 1,327 on an H100).
    Then the same in f32 (TF32 off), where the two agree far inside the
    logits' margins: the streams equal token for token, every draft launch
    on the tf32x3 route at head_dim 16."""
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    attn = paged_attn.paged_decode_attention
    n_req = SMALL_MICRO_REQUESTS
    out = {"model": "serve --preset small --draft-model micro --spec-k 3",
           "requests": n_req}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        runs, streams = {}, {}
        for key, draft in (("plain", False), ("micro_k3", True)):
            eng = _small_micro_engine(dev, dtype, draft)
            _zero_counts(attn)
            t0 = time.perf_counter()
            outs = eng.run(_cli_requests(n_req))
            torch.cuda.synchronize()
            summ = eng.stats.summary()
            steps = summ["decode_steps"]
            chunks = sum(o.prefill_chunks for o in outs)
            routes = {**_route_counts(attn), "small": attn.launches_small}
            lt, ld = 12, int(draft)
            k1 = SMALL_MICRO_SPEC_K + 1 if draft else 1
            small = (steps * k1 + chunks) * ld
            want = {"decode": steps * lt + small, "prefill": chunks * lt,
                    "tf32x3": 0, "split": 0, "int8": 0, "small": small}
            if dtype == torch.float32:
                want = {**_f32_want({k: v for k, v in want.items()
                                     if k != "small"}), "small": small}
            check(len(outs) == n_req and routes == want,
                  f"small preset {dname} {key}: launches by route {routes}, "
                  f"want {want} ({steps} iterations, {chunks} chunks)")
            streams[key] = {o.request_id: o.tokens for o in outs}
            runs[key] = {"route_launches": routes, "decode_iterations": steps,
                         "prefill_chunks": chunks,
                         "wall_s": time.perf_counter() - t0,
                         "decode_tokens": eng.stats.decode_tokens,
                         "spec_acceptance_rate": summ.get(
                             "spec_acceptance_rate")}
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        equal = sum(a == b for r in streams["plain"] for a, b in zip(
            streams["plain"][r], streams["micro_k3"][r]))
        total = sum(len(t) for t in streams["plain"].values())
        same = {r: streams["plain"][r] == streams["micro_k3"][r]
                for r in streams["plain"]}
        runs["tokens_equal_plain"], runs["tokens"] = equal, total
        runs["streams_equal"] = sum(same.values())
        out[dname] = runs
        log({"phase": "P", "case": f"small_micro_{dname}", **runs})
        if dtype == torch.float32:
            check(all(same.values()),
                  f"small preset f32: the micro draft changed a stream "
                  f"({runs['streams_equal']} of {n_req} equal)")
    return out


def _copy(reqs):
    """Fresh Request objects with the same fields (an engine stamps the
    ones it serves)."""
    import dataclasses as dc

    return [dc.replace(r, _t_submit=None, _finished=False) for r in reqs]


def _control_run(model, dev):
    """P3: two tenants from a config string; one queued, one pending and
    one in-flight request cancelled; the pending one requeued (as a
    migration would); then a drain to the end and a shutdown."""
    from k8s_distributed_deeplearning_torch.serve import (
        EngineDraining, Request, ServeEngine, parse_tenants)

    eng = ServeEngine(model, num_slots=4, prefill_chunk_tokens=512,
                      tenants=parse_tenants(P_TENANTS), device=dev)
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(5)
    calls: dict[str, list] = {}

    def req(rid, n, tenant):
        return Request(prompt=rng.integers(0, vocab, n).astype(np.int32),
                       max_new_tokens=16, tenant=tenant, request_id=rid,
                       on_finish=calls.setdefault(rid, []).append)

    reqs = {r.request_id: r for r in (
        req("b0", 1500, "batch"), req("b1", 1400, "batch"),
        req("b2", 600, "batch"), req("i0", 150, "interactive"),
        req("i1", 150, "interactive"), req("i2", 150, "interactive"))}
    for r in reqs.values():
        eng.submit(r)
    outs = {}
    for o in eng.step():
        outs[o.request_id] = o
    states = {"in_flight": sorted(fl.req.request_id for fl in eng._slots
                                  if fl is not None),
              "pending": sorted(p.req.request_id
                                for p in eng._pending.values()),
              "queued": len(eng.queue)}
    check(states == {"in_flight": ["i0", "i1", "i2"], "pending": ["b0"],
                     "queued": 2},
          f"P3: after one step {states}")
    cancelled = {"b1": eng.cancel("b1"),                  # queued
                 "b0": eng.cancel("b0", "migrated"),      # pending prefill
                 "i1": eng.cancel("i1")}                  # in flight
    eng.submit(reqs["b0"], requeue=True)
    eng.drain()
    try:
        eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=2,
                           tenant="interactive", request_id="late"))
        refused = False
    except EngineDraining:
        refused = True
    while eng.busy():
        for o in eng.step():
            outs[o.request_id] = o
    reasons = {k: (o.finish_reason, len(o.tokens))
               for k, o in cancelled.items()}
    finished = {k: (o.finish_reason, len(o.tokens)) for k, o in outs.items()}
    snap = eng.queue.snapshot()["tenants"]
    check(refused and eng.drained, "P3: the drain admitted a request")
    check(reasons["b1"] == ("aborted", 0) and reasons["b0"] == ("migrated", 0)
          and reasons["i1"][0] == "aborted" and 1 <= reasons["i1"][1] < 16,
          f"P3: cancelled {reasons}")
    check(finished == {k: ("length", 16) for k in ("i0", "i2", "b0", "b2")},
          f"P3: finished {finished}")
    check(calls == {"b0": ["migrated", "length"], "b1": ["aborted"],
                    "b2": ["length"], "i0": ["length"], "i1": ["aborted"],
                    "i2": ["length"]},
          f"P3: on_finish calls {calls}")
    check(all(t["in_flight"] == 0 for t in snap.values()),
          f"P3: slots still held by a tenant {snap}")
    return {"after_first_step": states, "cancelled": reasons,
            "finished": finished, "drain_refused_submit": refused,
            "tenants": {k: {f: v[f] for f in ("priority", "popped_total",
                                              "in_flight",
                                              "queue_wait_p95_ms")}
                        for k, v in snap.items()},
            **_clean_after(eng, "P3")}


def _exact_gates(dev):
    """At 8B width, 4 layers, f32: the prefix cache on equals off, greedy
    and sampled speculative streams (a self-draft, a 2-layer draft) equal
    plain decode, the self-draft accepts every greedy proposal, and a
    request with n + max_new == max_seq_len runs at spec_k 4; every paged
    launch on the tf32x3 route (checked in each run)."""
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.serve import Request

    cfg = llama.config_llama3_8b(max_seq_len=2048, n_layers=4,
                                 dtype=torch.float32)
    model = llama.LlamaLM(cfg, device=dev, seed=0)
    out = {"route_launches": {}}
    streams = {}
    for mb in (None, P_CACHE_MB):
        res, streams[mb], _ = _p1_run(model, dev, mb, 16)
        out["route_launches"]["cache_on" if mb else "cache_off"] = res[
            "route_launches"]
    out["prefix_cache_on_equals_off"] = streams[None] == streams[
        P_CACHE_MB]
    check(out["prefix_cache_on_equals_off"],
          "P f32: streams differ with the prefix cache on")
    # 17 new tokens: the first, then four whole windows of spec_k 3.
    reqs = _requests(cfg.vocab_size, 17, sampled=True)
    draft2 = llama.LlamaLM(llama.config_llama3_8b(
        max_seq_len=2048, n_layers=2, dtype=torch.float32), device=dev,
        seed=1)
    res, base = _spec_run(model, dev, _copy(reqs), None, 0)
    out["route_launches"]["plain"] = res["route_launches"]
    for key, draft in (("self_k3", model), ("draft2_k3", draft2)):
        res, outs = _spec_run(model, dev, _copy(reqs), draft, 3)
        out["route_launches"][key] = res["route_launches"]
        same = {r: outs[r].tokens == base[r].tokens for r in base}
        out[key] = {"streams_equal": same,
                    "acceptance_rate": res["spec_acceptance_rate"]}
        check(all(same.values()), f"P f32 {key}: streams differ {same}")
        if draft is model:
            greedy = [r for r in outs if r not in ("r2", "r5")]
            full = all(outs[r].spec_accepted == outs[r].spec_proposed > 0
                       for r in greedy)
            out[key]["greedy_all_accepted"] = full
            check(full, "P f32: the self-draft rejected a greedy proposal")
    rng = np.random.default_rng(8)
    edge = Request(prompt=rng.integers(0, cfg.vocab_size, 2048 - 32).astype(
        np.int32), max_new_tokens=32, request_id="edge")
    _, plain_edge = _spec_run(model, dev, _copy([edge]), None, 0)
    res, spec_edge = _spec_run(model, dev, _copy([edge]), model, 4)
    out["max_seq_len_edge"] = {
        "prompt": 2048 - 32, "max_new_tokens": 32, "spec_k": 4,
        "finish_reason": spec_edge["edge"].finish_reason,
        "equal_plain": spec_edge["edge"].tokens == plain_edge[
            "edge"].tokens}
    check(out["max_seq_len_edge"]["equal_plain"]
          and spec_edge["edge"].finish_reason == "length",
          f"P f32: the max_seq_len edge case {out['max_seq_len_edge']}")
    del model, draft2
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- phase R

R_STORM = dict(seed=1, steps=48, failures_to_trip=2, fault_rate=(0.1, 0.4))
R_HOP_AT = 8          # decode iterations before R2's export
R_GEN_NEW = 32


def _count_step_routes(eng, counts):
    """Accumulate in ``counts`` the paged launches by route of each of
    ``eng``'s steps (the fleet steps its engines one after another, so the
    global counters' change across a step is that engine's)."""
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    attn = paged_attn.paged_decode_attention
    step = eng.step

    def wrapper():
        before = _route_counts(attn)
        out = step()
        for k, v in _route_counts(attn).items():
            counts[k] = counts.get(k, 0) + v - before[k]
        return out

    eng.step = wrapper


def _timed_ship(eng, name, rows):
    """Wrap ``eng.export_request_kv`` or ``import_request_kv`` to append
    (request id, ms, bytes, pages) to ``rows``, synchronized both sides."""
    fn = getattr(eng, name)

    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        blob = out if name == "export_request_kv" else a[0]
        rows.append({"request_id": blob["request_id"], "ms": ms,
                     "bytes": sum(p.nbytes for p in blob["pages"]),
                     "pages": blob["n_pages"],
                     "prefill_chunks": blob["prefill_chunks"],
                     "kv_len": blob["kv_len"]})
        return out

    setattr(eng, name, wrapper)


def _ship_summary(rows) -> dict:
    ms = [r["ms"] for r in rows]
    nbytes = sum(r["bytes"] for r in rows)
    return {"count": len(rows), "ms_per_request": ms,
            "ms_mean": float(np.mean(ms)) if ms else None,
            "bytes": nbytes, "pages": sum(r["pages"] for r in rows),
            "gb_per_s": nbytes / (sum(ms) * 1e-3) / 1e9 if ms else None}


def _r1(dev, b_streams, b_logits, started):
    """R1: B's workload disaggregated at Llama-3 8B, 16 layers (bf16, seed 0):
    one prefill-only engine and two decode engines on one shared model,
    B's settings, through the ``DisaggCoordinator``."""
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.serve import ServeEngine
    from k8s_distributed_deeplearning_torch.serve.disagg import (
        DisaggCoordinator, PrefillWorker)

    cfg = llama.config_llama3_8b(max_seq_len=2048, n_layers=SERVE_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = llama.LlamaLM(cfg, device=dev, seed=0)
    engines = {rid: ServeEngine(model, num_slots=4, prefill_chunk_tokens=512,
                                device=dev, replica_id=rid,
                                prefill_only=rid == "p0")
               for rid in ("p0", "d0", "d1")}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    logits = {}
    _first_logits(engines["p0"], logits)
    counts = {rid: {} for rid in engines}
    acc = {"_decode_step": 0.0}
    exports, imports = [], []
    for rid, eng in engines.items():
        _count_step_routes(eng, counts[rid])
        if rid == "p0":
            _timed_ship(eng, "export_request_kv", exports)
        else:
            _timed(eng, "_decode_step", acc)
            _timed_ship(eng, "import_request_kv", imports)
    coord = DisaggCoordinator([engines["d0"], engines["d1"]],
                              [PrefillWorker(engines["p0"])])
    reqs = _requests(cfg.vocab_size, 32, sampled=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = coord.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(len(outs) == 8 and all(o.finish_reason == "length"
                                 and len(o.tokens) == 32 for o in outs),
          f"R1: {[(o.finish_reason, len(o.tokens)) for o in outs]}")
    layers = cfg.n_layers
    chunks = sum(r["prefill_chunks"] for r in exports)
    steps = {rid: engines[rid].stats.steps for rid in ("d0", "d1")}
    want = {"p0": {"decode": 0, "prefill": layers * chunks, "tf32x3": 0,
                   "split": 0, "int8": 0}}
    for rid, n in steps.items():
        want[rid] = {"decode": layers * n, "prefill": 0, "tf32x3": 0,
                     "split": 0, "int8": 0}
    check(counts == want and chunks > 0 and all(steps.values()),
          f"R1 launches by engine and route {counts}: want {want} "
          f"(layers x prefill chunks {chunks} on p0, layers x decode "
          f"iterations {steps} on each decode engine)")
    prompt_pages = sum(-(-len(r.prompt) // PAGE) for r in reqs)
    shipped = sum(r["pages"] for r in exports)
    check(shipped == prompt_pages == sum(r["pages"] for r in imports)
          and coord.stats.disagg_fallbacks == 0,
          f"R1: {shipped} pages exported, {prompt_pages} = sum of "
          f"ceil(kv_len / {PAGE}) wanted, fallbacks "
          f"{coord.stats.disagg_fallbacks}")
    rids = sorted(b_logits)
    decided, same = _first_token_rule(
        torch.cat([logits[r] for r in rids]),
        torch.cat([b_logits[r].to(dev) for r in rids]))
    check(bool(same[decided].all()),
          "R1: a first token differs from B's where the margin decides it")
    streams = {o.request_id: o.tokens for o in outs}
    decode_tokens = sum(engines[r].stats.decode_tokens for r in ("d0", "d1"))
    result = {
        "phase": "R1", "model": "llama3-8b", "layers": layers,
        "dtype": "bfloat16", "engines": "p0 prefill-only, d0 + d1 decode",
        "slots": 4, "prefill_chunk_tokens": 512, "requests": 8,
        "setup_s": setup_s, "wall_s": wall, "route_launches": counts,
        "prefill_chunks": chunks, "decode_iterations": steps,
        "pages_shipped": shipped, "export": _ship_summary(exports),
        "import": _ship_summary(imports),
        "decode_tokens_per_s": decode_tokens / acc["_decode_step"],
        "decode_s": acc["_decode_step"],
        "decode_iteration_ms": acc["_decode_step"] / sum(steps.values())
        * 1e3,
        "first_token_decided": decided.tolist(),
        "first_token_equal": same.tolist(),
        "streams_equal_b": sum(streams[r] == b_streams[r] for r in streams),
        "tokens_equal_b": sum(a == b for r in streams
                              for a, b in zip(streams[r], b_streams[r])),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "since_start_s": time.perf_counter() - started}
    for rid, eng in engines.items():
        result[f"{rid}_pages_after"] = _clean_after(eng, f"R1 {rid}")
    log(result)
    del model, engines, coord
    gc.collect()
    torch.cuda.empty_cache()
    return result


def _f32_fleet(model, dev, n, **kw):
    from k8s_distributed_deeplearning_torch.serve import ServeEngine

    return [ServeEngine(model, num_slots=4, prefill_chunk_tokens=512,
                        device=dev, replica_id=f"r{i}", **kw)
            for i in range(n)]


def _r2(dev, started, tmp: Path):
    """R2: f32 at 8B width and 4 layers (C's kernel path): disaggregated
    streams, a hop at decode cursor 8, a gateway with a replica killed
    mid-decode and a drain, each against a unified engine's streams."""
    from k8s_distributed_deeplearning_torch import faults
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.ops import paged_attn
    from k8s_distributed_deeplearning_torch.serve import ServeEngine
    from k8s_distributed_deeplearning_torch.serve.disagg import (
        DisaggCoordinator, PrefillWorker)
    from k8s_distributed_deeplearning_torch.serve.gateway import (
        ServeGateway)
    from k8s_distributed_deeplearning_torch.telemetry.flight import (
        FlightRecorder)
    from k8s_distributed_deeplearning_torch.utils.metrics import (
        MetricsLogger)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    attn = paged_attn.paged_decode_attention
    cfg = llama.config_llama3_8b(max_seq_len=2048, n_layers=4,
                                 dtype=torch.float32)
    model = llama.LlamaLM(cfg, device=dev, seed=0)
    reqs = _requests(cfg.vocab_size, 16, sampled=True)
    greedy = [r for r in reqs if r.sampling.temperature <= 0.0]
    result = {"phase": "R2", "model": "llama3-8b width, 4 layers",
              "dtype": "float32", "route_launches": {}}
    _zero_counts(attn)
    (ref_eng,) = _f32_fleet(model, dev, 1)
    oracle = {o.request_id: o.tokens for o in ref_eng.run(_copy(reqs))}
    result["route_launches"]["unified"] = _route_counts(attn)
    _clean_after(ref_eng, "R2 unified")

    # Disaggregated: one prefill-only and two decode engines.
    _zero_counts(attn)
    pre = _f32_fleet(model, dev, 1, prefill_only=True)[0]
    dec = _f32_fleet(model, dev, 2)
    coord = DisaggCoordinator(dec, [PrefillWorker(pre)])
    got = {o.request_id: o.tokens for o in coord.run(_copy(reqs))}
    result["route_launches"]["disagg"] = _route_counts(attn)
    result["disagg_streams_equal"] = {r: got[r] == oracle[r] for r in oracle}
    result["disagg_fallbacks"] = coord.stats.disagg_fallbacks
    check(all(result["disagg_streams_equal"].values())
          and coord.stats.disagg_fallbacks == 0,
          f"R2 disagg streams differ from the unified engine's "
          f"{result['disagg_streams_equal']}")
    for e in [pre] + dec:
        _clean_after(e, "R2 disagg")

    # One request exported at decode cursor 8 and imported elsewhere,
    # greedy (r0) and sampled (r2).
    _zero_counts(attn)
    hop = {}
    for rid in ("r0", "r2"):
        a, b = _f32_fleet(model, dev, 2)
        (req,) = _copy([r for r in reqs if r.request_id == rid])
        a.submit(req)
        while not a.occupied_slots() or a.stats.steps < R_HOP_AT:
            a.step()
        blob = a.export_request_kv(rid)
        check(b.can_import(blob), f"R2 hop {rid}: import refused")
        b.import_request_kv(blob, request=req)
        (out,) = b.run()
        hop[rid] = {"cursor": len(blob["emitted"]) - 1,
                    "pages": blob["n_pages"],
                    "equal": out.tokens == oracle[rid]}
        for e in (a, b):
            _clean_after(e, f"R2 hop {rid}")
    result["route_launches"]["hop"] = _route_counts(attn)
    result["hop"] = hop
    check(all(h["equal"] and h["cursor"] == R_HOP_AT for h in hop.values()),
          f"R2 hop at decode cursor {R_HOP_AT}: {hop}")

    # A gateway over two replicas, r0 killed mid-decode at
    # gateway_dispatch: its live requests migrate by resubmission. Every
    # request's trace is sampled into its replica's JSONL, and each
    # replica keeps a flight recorder (phase T5 reads both).
    _zero_counts(attn)
    trace_logs = [tmp / f"r2_r{i}.jsonl" for i in range(2)]
    trace_files = [open(p, "w") for p in trace_logs]
    flight_dir = tmp / "r2_flight"
    fleet = [ServeEngine(model, num_slots=4, prefill_chunk_tokens=512,
                         device=dev, replica_id=f"r{i}",
                         request_trace_sample=1.0,
                         request_log=MetricsLogger(stream=f, job=f"r{i}"),
                         flight=FlightRecorder(64, dump_dir=str(flight_dir),
                                               job=f"r{i}"))
             for i, f in enumerate(trace_files)]
    gw = ServeGateway(fleet, failures_to_trip=1)
    for r in _copy(greedy):
        gw.submit(r)
    outs = []
    while not fleet[0].stats.steps >= 4:
        outs.extend(gw.step())
    faults.activate(faults.FaultPlan((faults.Fault(
        site="gateway_dispatch", action="ioerror", step=0,
        attempt=None),)))
    try:
        outs.extend(gw.step())
    finally:
        fired = list(faults.active().fired)
        faults.deactivate()
    outs.extend(gw.run())
    kill = {"fired": fired, "breaker": gw.breaker_state("r0"),
            "gateway_migrations": gw.stats.gateway_migrations,
            "streams_equal": {o.request_id: o.tokens == oracle[o.request_id]
                              for o in outs},
            "finish_reasons": sorted({o.finish_reason for o in outs})}
    result["route_launches"]["gateway_kill"] = _route_counts(attn)
    result["gateway_kill"] = kill
    check(len(outs) == len(greedy) and all(kill["streams_equal"].values())
          and kill["gateway_migrations"] >= 1
          and kill["finish_reasons"] == ["length"],
          f"R2 gateway kill: {kill}")
    for e in fleet:
        _clean_after(e, "R2 gateway kill")
    for f in trace_files:
        f.close()
    result["t5"] = _t5(trace_logs, flight_dir, kill)

    # drain_replica mid-decode: decoding requests move by shipped pages.
    _zero_counts(attn)
    fleet = _f32_fleet(model, dev, 2)
    gw = ServeGateway(fleet)
    for r in _copy(greedy[:4]):
        gw.submit(r)
    outs = []
    while fleet[0].stats.steps < 2:      # r0 decoding: pages to ship
        outs.extend(gw.step())
    gw.drain_replica("r0")
    outs.extend(gw.run())
    s = gw.stats
    drain = {"exports": sum(e.stats.disagg_exports for e in fleet),
             "imports": sum(e.stats.disagg_imports for e in fleet),
             "gateway_migrations": s.gateway_migrations,
             "streams_equal": {o.request_id: o.tokens == oracle[o.request_id]
                               for o in outs}}
    result["route_launches"]["gateway_drain"] = _route_counts(attn)
    result["gateway_drain"] = drain
    check(drain["exports"] == drain["imports"] >= 1
          and len(outs) == 4 and all(drain["streams_equal"].values()),
          f"R2 drain: {drain}")
    for e in fleet:
        _clean_after(e, "R2 gateway drain")
    routes = result["route_launches"]
    check(all(v["tf32x3"] > 0 and v["decode"] == v["prefill"] == v["split"]
              == v["int8"] == 0 for v in routes.values()),
          f"R2 launches by run {routes}: every paged launch on tf32x3")
    result["since_start_s"] = time.perf_counter() - started
    log(result)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return result


def _r3(dev, started):
    """R3: the chaos soak over the serve CLI's tiny preset (f32, head_dim
    16) on the card, as a gateway of two replicas and as one prefill and
    two decode engines, at ``R_STORM``'s seed."""
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.ops import paged_attn
    from k8s_distributed_deeplearning_torch.serve import ServeEngine
    from k8s_distributed_deeplearning_torch.serve import storm

    attn = paged_attn.paged_decode_attention
    cfg = llama.config_tiny(max_seq_len=512, dtype=torch.float32)
    model = llama.LlamaLM(cfg, device=dev, seed=0)
    out = {"phase": "R3", "model": "config_tiny (the serve CLI's tiny "
           "preset, head_dim 16)", "dtype": "float32"}
    fired = set()
    for topo, prefill in (("gateway", 0), ("disagg", 1)):
        scfg = storm.StormConfig(prefill=prefill, vocab=cfg.vocab_size,
                                 **R_STORM)

        def make(i, **kw):
            return ServeEngine(model, num_slots=4, max_queue=scfg.max_queue,
                               tenants=scfg.tenant_configs(), device=dev,
                               replica_id=f"s{i}" if i >= 0 else "oracle",
                               **kw)

        _zero_counts(attn)
        t0 = time.perf_counter()
        rep = storm.run_storm(scfg, make_engine=make,
                              make_prefill_engine=lambda i: make(
                                  i, prefill_only=True))
        torch.cuda.synchronize()
        doc = rep.to_dict()
        doc.pop("plan_json")
        doc["fired"] = {f"{s}:{a}": sum(1 for x in rep.fired
                                        if x == (s, a))
                        for s, a in sorted(set(rep.fired))}
        routes = _route_counts(attn)
        routes["small"] = attn.launches_small
        out[topo] = {**doc, "wall_s": time.perf_counter() - t0,
                     "route_launches": routes}
        fired |= set(rep.distinct_sites)
        check(rep.violations == [] and rep.parity_checked > 0
              and rep.submitted == rep.finished > 0,
              f"R3 {topo}: {rep.violations[:3]}, parity checked "
              f"{rep.parity_checked}")
        check(routes["tf32x3"] == routes["small"] > 0
              and routes["split"] == 0,
              f"R3 {topo} launches by route {routes}: every one on tf32x3 "
              "at head_dim 16")
    check({"serve_decode", "gateway_dispatch"} <= fired,
          f"R3: faults fired at {sorted(fired)}")
    out["since_start_s"] = time.perf_counter() - started
    log(out)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _r4(dev, started, tmp: Path):
    """R4: the train CLI's tiny preset takes 2 steps on the card (its own
    process, as a user runs it) and writes a checkpoint;
    ``examples/generate_llama_torch.py`` generates from it; its tokens
    equal ``generate`` on the restored params."""
    import argparse
    import importlib.util
    import io
    from contextlib import redirect_stdout

    from k8s_distributed_deeplearning_torch.models import generate, llama
    from k8s_distributed_deeplearning_torch.train import cli as train_cli
    from k8s_distributed_deeplearning_torch.train.checkpoint import (
        Checkpointer)

    ck = str(tmp / "r4_checkpoints")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_distributed_deeplearning_torch.train",
         "--preset", "tiny", "--num-steps", "2", "--batch-size", "4",
         "--seq-len", "64", "--checkpoint-dir", ck, "--no-eval"],
        cwd=str(REPO), capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    check(proc.returncode == 0, f"R4 train CLI exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    train_s = time.perf_counter() - t0
    spec = importlib.util.spec_from_file_location(
        "generate_llama_torch", REPO / "examples" / "generate_llama_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with redirect_stdout(io.StringIO()):
        got = example.main(["--checkpoint-dir", ck, "--max-new-tokens",
                            str(R_GEN_NEW)])
    params, step = Checkpointer(ck).restore_params(device=dev)
    cfg = train_cli.build_config(argparse.Namespace(
        preset="tiny", seq_len=None, dtype="float32", remat=False,
        attention="xla"))
    model = llama.LlamaLM(cfg, device=dev)
    model.load_state_dict(params, strict=False)
    want = generate.generate(model, torch.zeros((1, 1), dtype=torch.int32),
                             max_new_tokens=R_GEN_NEW)[0].tolist()
    out = {"phase": "R4", "checkpoint_step": step,
           "example_step": got["step"], "train_s": train_s,
           "tokens": got["tokens"], "tokens_equal": got["tokens"] == want,
           "since_start_s": time.perf_counter() - started}
    log(out)
    check(step == got["step"] == 2 and len(got["tokens"]) == R_GEN_NEW
          and got["tokens"] == want,
          f"R4: the example's tokens differ from generate: {out}")
    return out


def phase_r(dev, b_streams, b_logits, started, tmp: Path):
    """The serving engine's in-process scale-out surface on the card: R1
    disaggregated serving at full 8B, R2 the f32 exact gates of shipping,
    hop and failover, R3 the chaos soak, R4 the generate example."""
    return {"r1": _r1(dev, b_streams, b_logits, started),
            "r2": _r2(dev, started, tmp), "r3": _r3(dev, started),
            "r4": _r4(dev, started, tmp)}


# ------------------------------------------------------------- phase S

S_KILL_BUDGET = 10     # engine steps K0 takes before S2's kill (< 16 new)
S_DRAIN_BUDGET = 6     # engine steps D0 takes before S2's drain


class _StepBudget:
    """A replica server's engine, seen through a step budget: once the
    engine has stepped ``budget`` times, ``busy()`` is False and the
    server's step loop idles, so the replica still holds its requests when
    S2 kills or drains it (16 new tokens need more than ``S_KILL_BUDGET``
    steps), however long the test takes to look."""

    def __init__(self, engine, budget):
        self._engine = engine
        self.budget = budget
        self.steps = 0

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def busy(self):
        return self._engine.busy() and (self.budget is None
                                        or self.steps < self.budget)

    def step(self):
        self.steps += 1
        return self._engine.step()


def s_server(conf_json: str) -> int:
    """Phase S's replica-server process: ``python3 chip_smoke.py
    --s-server CONF`` (CONF a JSON object). Builds Llama-3 8B (bf16, or f32
    at ``layers`` layers) from seed 0 on the card, one 4-slot engine of
    ``role`` (512-token chunks) behind a ``ReplicaServer`` on an ephemeral
    port written to ``port_file``; on SIGTERM drains, then prints one JSON
    line: paged launches by route, decode iterations, tokens and seconds,
    memory, and what the engine shipped. ``logits`` names a file for the
    first-token logits; ``step_budget`` caps the engine's steps."""
    conf = json.loads(conf_json)
    sys.path.insert(0, str(REPO))
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.ops import paged_attn
    from k8s_distributed_deeplearning_torch.serve import ServeEngine
    from k8s_distributed_deeplearning_torch.serve.transport import (
        ReplicaServer)

    term = []
    signal.signal(signal.SIGTERM, lambda signum, frame: term.append(1))
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    if conf["dtype"] == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = llama.config_llama3_8b(max_seq_len=2048,
                                     n_layers=conf["layers"],
                                     dtype=torch.float32)
    else:
        cfg = llama.config_llama3_8b(max_seq_len=2048,
                                     n_layers=SERVE_LAYERS)
    model = llama.LlamaLM(cfg, device=dev, seed=0)
    eng = ServeEngine(model, num_slots=4, prefill_chunk_tokens=512,
                      device=dev, replica_id=conf["rid"],
                      prefill_only=conf["role"] == "prefill")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated() / 2 ** 30
    logits = {}
    if conf.get("logits"):
        _first_logits(eng, logits)
    # Each decode iteration (start, seconds, tokens: one a slot), both
    # sides synchronized, and each adoption's end: the decode rate with
    # and without page imports running beside it in this process.
    iters, adopted = [], []
    decode_step, import_kv = eng._decode_step, eng.import_request_kv

    def timed_decode_step():
        tokens = eng.occupied_slots()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = decode_step()
        torch.cuda.synchronize()
        iters.append((t, time.perf_counter() - t, tokens))
        return out

    def timed_import(*a, **kw):
        out = import_kv(*a, **kw)
        adopted.append(time.perf_counter())
        return out

    eng._decode_step = timed_decode_step
    eng.import_request_kv = timed_import
    attn = paged_attn.paged_decode_attention
    _zero_counts(attn)
    srv = ReplicaServer(_StepBudget(eng, conf.get("step_budget")),
                        handler_timeout=600.0, role=conf["role"]).start()
    port_file = Path(conf["port_file"])
    tmp = port_file.with_suffix(".tmp")
    tmp.write_text(f"{srv.port}\n")
    os.replace(tmp, port_file)
    draining = False
    while not srv.shutting_down:
        if term and not draining:
            srv.begin_drain()
            draining = True
        if draining and srv.drained:
            break
        time.sleep(0.01)
    srv.close()
    torch.cuda.synchronize()
    st = eng.stats
    last = max(adopted, default=0.0)
    quiet = [(dt, n) for t, dt, n in iters if t > last]
    if conf.get("logits"):
        torch.save({k: v.cpu() for k, v in logits.items()}, conf["logits"])
    print(json.dumps({
        "s_server": conf["rid"], "role": conf["role"],
        "dtype": conf["dtype"], "layers": cfg.n_layers,
        "setup_s": setup_s, "resident_gb": resident,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "route_launches": _route_counts(attn),
        "launches_small": attn.launches_small,
        "decode_iterations": st.steps, "decode_tokens": st.decode_tokens,
        "decode_s": sum(dt for _, dt, _ in iters),
        "decode_after_last_import": {
            "iterations": len(quiet), "tokens": sum(n for _, n in quiet),
            "s": sum(dt for dt, _ in quiet)},
        "exports": st.disagg_exports,
        "imports": st.disagg_imports,
        "transport_dedup_hits": st.transport_dedup_hits,
        "pages_used_after": eng.pool.counters()["pages_used"],
        "pages_reserved_after": eng.pool.reserved}), flush=True)
    return 0


def _s_spawn(tmp: Path, **conf):
    """Start one replica-server process of phase S (a fresh interpreter:
    no fork after CUDA is up); its output goes to files in ``tmp``."""
    conf["port_file"] = str(tmp / f"{conf['rid']}.port")
    out = open(tmp / f"{conf['rid']}.out", "w")
    err = open(tmp / f"{conf['rid']}.err", "w")
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--s-server",
         json.dumps(conf)], cwd=str(REPO), stdout=out, stderr=err,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    out.close()
    err.close()
    return {"proc": proc, "port_file": Path(conf["port_file"]),
            "out": tmp / f"{conf['rid']}.out",
            "err": tmp / f"{conf['rid']}.err"}


def _s_tail(child) -> str:
    return child["err"].read_text()[-2000:]


def _s_ports(children: dict, timeout_s: float = 600.0) -> dict:
    """Wait for every child's port file: rid -> port."""
    deadline = time.perf_counter() + timeout_s
    ports = {}
    while len(ports) < len(children):
        for rid, ch in children.items():
            if rid in ports:
                continue
            if ch["port_file"].exists():
                ports[rid] = int(ch["port_file"].read_text())
            elif ch["proc"].poll() is not None:
                check(False, f"S: replica server {rid} exited "
                      f"{ch['proc'].returncode}: {_s_tail(ch)}")
        check(time.perf_counter() < deadline,
              f"S: replica servers not up in {timeout_s} s")
        time.sleep(0.05)
    return ports


def _s_stop(children: dict, timeout_s: float = 300.0) -> dict:
    """SIGTERM every live child, wait, and return rid -> (exit code, its
    summary line or None). A child that does not exit in time is
    killed."""
    for ch in children.values():
        if ch["proc"].poll() is None:
            ch["proc"].send_signal(signal.SIGTERM)
    out = {}
    for rid, ch in children.items():
        try:
            rc = ch["proc"].wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            ch["proc"].kill()
            rc = ch["proc"].wait()
        summary = None
        for line in ch["out"].read_text().splitlines():
            if line.startswith('{"s_server"'):
                summary = json.loads(line)
        out[rid] = (rc, summary)
    return out


def _s_healthz(port: int) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=60) as resp:
        return json.loads(resp.read().decode())


def _s_time_wire(client, name, rows):
    """Wrap ``client.take_remote_exports`` or ``ship_pages`` to append a
    row (ms, page bytes, pages, blobs, prefill chunks) for each call that
    moved a blob; the time is the whole call: encoding, the HTTP
    round trips, the far side's decoding and adoption."""
    from k8s_distributed_deeplearning_torch.serve.disagg import blob_nbytes

    fn = getattr(client, name)

    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        ms = (time.perf_counter() - t0) * 1e3
        blobs = out if name == "take_remote_exports" else [a[0]]
        if blobs:
            rows.append({"ms": ms,
                         "bytes": sum(blob_nbytes(b) for b in blobs),
                         "pages": sum(int(b["n_pages"]) for b in blobs),
                         "blobs": len(blobs),
                         "prefill_chunks": sum(int(b["prefill_chunks"])
                                               for b in blobs)})
        return out

    setattr(client, name, wrapper)


def _wire_summary(rows) -> dict:
    ms = [r["ms"] for r in rows]
    nbytes = sum(r["bytes"] for r in rows)
    return {"calls": len(rows), "blobs": sum(r["blobs"] for r in rows),
            "ms_per_call": ms, "bytes": nbytes,
            "pages": sum(r["pages"] for r in rows),
            "gb_per_s": nbytes / (sum(ms) * 1e-3) / 1e9 if ms else None}


def _client(port, rid):
    from k8s_distributed_deeplearning_torch.serve.transport import (
        ReplicaClient)

    return ReplicaClient(f"127.0.0.1:{port}", replica_id=rid,
                         timeout_s=600.0, backoff_s=0.05)


def _s_drive(front, deadline_s: float, what: str) -> list:
    outs = []
    t0 = time.perf_counter()
    while front.busy():
        outs.extend(front.step())
        check(time.perf_counter() - t0 < deadline_s,
              f"{what}: did not finish in {deadline_s} s")
        time.sleep(0.001)
    return outs


def _s1(b_streams, b_logits, started, tmp: Path):
    """S1: B's workload disaggregated over the wire at Llama-3 8B, 16 layers
    (bf16, seed 0): a prefill-role and a decode-role replica-server
    process on the one card; this process holds the coordinator with a
    ``RemotePrefillWorker`` and a ``ReplicaClient``."""
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.serve import transport
    from k8s_distributed_deeplearning_torch.serve.disagg import (
        DisaggCoordinator, RemotePrefillWorker)

    cfg = llama.config_llama3_8b(max_seq_len=2048,      # no model built here
                                 n_layers=SERVE_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    logits_path = tmp / "s1_logits.pt"
    t0 = time.perf_counter()
    children = {"sp": _s_spawn(tmp, rid="sp", role="prefill",
                               dtype="bfloat16", logits=str(logits_path)),
                "sd": _s_spawn(tmp, rid="sd", role="decode",
                               dtype="bfloat16")}
    try:
        ports = _s_ports(children)
        setup_s = time.perf_counter() - t0
        pre, dec = _client(ports["sp"], "sp"), _client(ports["sd"], "sd")
        exports, ships = [], []
        _s_time_wire(pre, "take_remote_exports", exports)
        _s_time_wire(dec, "ship_pages", ships)
        coord = DisaggCoordinator([dec], [RemotePrefillWorker(pre)])
        reqs = _requests(cfg.vocab_size, 32, sampled=True)
        t1 = time.perf_counter()
        for r in reqs:
            coord.submit(r)
        outs = _s_drive(coord, 600.0, "S1")
        wall = time.perf_counter() - t1
    finally:
        summaries = _s_stop(children)
    check(all(rc == 0 and summ is not None
              for rc, summ in summaries.values()),
          f"S1 replica servers: {summaries}")
    sp, sd = summaries["sp"][1], summaries["sd"][1]
    check(len(outs) == 8 and all(o.finish_reason == "length"
                                 and len(o.tokens) == 32
                                 and all(0 <= t < cfg.vocab_size
                                         for t in o.tokens) for o in outs),
          f"S1: {[(o.finish_reason, len(o.tokens)) for o in outs]}")
    layers = cfg.n_layers
    chunks = sum(r["prefill_chunks"] for r in exports)
    want = {"sp": {"decode": 0, "prefill": layers * chunks, "tf32x3": 0,
                   "split": 0, "int8": 0},
            "sd": {"decode": layers * sd["decode_iterations"], "prefill": 0,
                   "tf32x3": 0, "split": 0, "int8": 0}}
    got = {"sp": sp["route_launches"], "sd": sd["route_launches"]}
    check(got == want and chunks > 0 and sd["decode_iterations"] > 0,
          f"S1 launches by process and route {got}: want {want} (layers x "
          f"prefill chunks {chunks} in the prefill server, layers x decode "
          f"iterations {sd['decode_iterations']} in the decode server)")
    prompt_pages = sum(-(-len(r.prompt) // PAGE) for r in reqs)
    wire_out, wire_in = _wire_summary(exports), _wire_summary(ships)
    check(wire_out["pages"] == wire_in["pages"] == prompt_pages
          and sp["exports"] == sd["imports"] == 8
          and coord.stats.disagg_fallbacks == 0
          and sp["pages_used_after"] == sd["pages_used_after"] == 0,
          f"S1: pages {wire_out['pages']} picked up, {wire_in['pages']} "
          f"shipped, {prompt_pages} = sum of ceil(kv_len / {PAGE}) wanted; "
          f"exports {sp['exports']}, imports {sd['imports']}, fallbacks "
          f"{coord.stats.disagg_fallbacks}, pages held after "
          f"{sp['pages_used_after']} / {sd['pages_used_after']}")
    logits = torch.load(logits_path)
    rids = sorted(b_logits)
    decided, same = _first_token_rule(
        torch.cat([logits[r] for r in rids]),
        torch.cat([b_logits[r] for r in rids]))
    check(bool(same[decided].all()),
          "S1: a first token differs from B's where the margin decides it")
    streams = {o.request_id: o.tokens for o in outs}
    result = {
        "phase": "S1", "model": "llama3-8b", "layers": layers,
        "dtype": "bfloat16",
        "processes": "sp prefill-role server, sd decode-role server, this "
                     "process the coordinator",
        "slots": 4, "prefill_chunk_tokens": 512, "requests": 8,
        "setup_s": setup_s, "wall_s": wall,
        "route_launches": got, "prefill_chunks": chunks,
        "decode_iterations": sd["decode_iterations"],
        "pages_shipped": wire_in["pages"],
        "exports_wire": wire_out, "pages_wire": wire_in,
        "pages_chunk_chars": transport.PAGES_CHUNK_CHARS,
        "decode_tokens_per_s": sd["decode_tokens"] / sd["decode_s"],
        "decode_iteration_ms": sd["decode_s"] / sd["decode_iterations"]
        * 1e3,
        "decode_after_last_import": {
            **sd["decode_after_last_import"],
            "tokens_per_s": (sd["decode_after_last_import"]["tokens"]
                             / sd["decode_after_last_import"]["s"]
                             if sd["decode_after_last_import"]["s"]
                             else None)},
        "first_token_decided": decided.tolist(),
        "first_token_equal": same.tolist(),
        "streams_equal_b": sum(streams[r] == b_streams[r] for r in streams),
        "tokens_equal_b": sum(a == b for r in streams
                              for a, b in zip(streams[r], b_streams[r])),
        "peak_memory_gb": {"sp": sp["peak_memory_gb"],
                           "sd": sd["peak_memory_gb"],
                           "coordinator":
                           torch.cuda.max_memory_allocated() / 2 ** 30},
        "resident_gb": {"sp": sp["resident_gb"], "sd": sd["resident_gb"]},
        "server_setup_s": {"sp": sp["setup_s"], "sd": sd["setup_s"]},
        "since_start_s": time.perf_counter() - started}
    log(result)
    return result


def _s2(dev, started, tmp: Path):
    """S2: f32 at 8B width and 4 layers (R2's configuration) over the
    wire, against a unified in-process engine's streams: a hop (pages
    shipped over ``/pages`` at decode cursor 8), a decode replica-server
    process killed mid-decode with the gateway migrating its streams, and
    a drain over the wire. Four decode-role servers: H (the hop's
    target), K0 and D0 (the kill's and the drain's victims, each held
    mid-flight by a step budget) and K1 (the survivor of both)."""
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.ops import paged_attn
    from k8s_distributed_deeplearning_torch.serve.disagg import (
        request_from_blob)
    from k8s_distributed_deeplearning_torch.serve.gateway import (
        ServeGateway)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    attn = paged_attn.paged_decode_attention
    conf = dict(role="decode", dtype="float32", layers=4)
    t0 = time.perf_counter()
    # Started first: they build their models while this process runs the
    # oracle.
    children = {"H": _s_spawn(tmp, rid="H", **conf),
                "K0": _s_spawn(tmp, rid="K0", step_budget=S_KILL_BUDGET,
                               **conf),
                "K1": _s_spawn(tmp, rid="K1", **conf),
                "D0": _s_spawn(tmp, rid="D0", step_budget=S_DRAIN_BUDGET,
                               **conf)}
    result = {"phase": "S2", "model": "llama3-8b width, 4 layers",
              "dtype": "float32", "route_launches": {}}
    try:
        cfg = llama.config_llama3_8b(max_seq_len=2048, n_layers=4,
                                     dtype=torch.float32)
        model = llama.LlamaLM(cfg, device=dev, seed=0)
        reqs = _requests(cfg.vocab_size, 16, sampled=True)
        greedy = [r for r in reqs if r.sampling.temperature <= 0.0]
        _zero_counts(attn)
        (ref_eng,) = _f32_fleet(model, dev, 1)
        oracle = {o.request_id: o.tokens
                  for o in ref_eng.run(_copy(reqs))}
        _clean_after(ref_eng, "S2 unified")
        ports = _s_ports(children)
        result["setup_s"] = time.perf_counter() - t0
        cl = {rid: _client(port, rid) for rid, port in ports.items()}

        # The hop: exported here at decode cursor 8, shipped over /pages
        # into H, streamed back over /poll; greedy r0 and sampled r2.
        hop = {}
        for rid in ("r0", "r2"):
            (a,) = _f32_fleet(model, dev, 1)
            (req,) = _copy([r for r in reqs if r.request_id == rid])
            a.submit(req)
            while not a.occupied_slots() or a.stats.steps < R_HOP_AT:
                a.step()
            blob = a.export_request_kv(rid)
            got, fin = [], []
            r = request_from_blob(blob)
            r.on_token, r.on_finish = got.append, fin.append
            t1 = time.perf_counter()
            body = cl["H"].ship_pages(blob, req=r)
            ship_ms = (time.perf_counter() - t1) * 1e3
            t1 = time.perf_counter()
            while not fin:
                cl["H"].step()
                check(time.perf_counter() - t1 < 300, f"S2 hop {rid}")
                time.sleep(0.001)
            hop[rid] = {"cursor": len(blob["emitted"]) - 1,
                        "pages": blob["n_pages"], "ship_ms": ship_ms,
                        "adopted": body["adopted"], "finish": fin,
                        "equal": list(blob["emitted"]) + got
                        == oracle[rid]}
            _clean_after(a, f"S2 hop {rid}")
        result["hop"] = hop
        result["route_launches"]["this_process"] = _route_counts(attn)
        check(all(h["equal"] and h["cursor"] == R_HOP_AT
                  and h["finish"] == ["length"] for h in hop.values()),
              f"S2 hop at decode cursor {R_HOP_AT}: {hop}")

        # The kill: K0 stops stepping after S_KILL_BUDGET steps (every
        # request on it is mid-decode), then its process is SIGKILLed.
        for c in cl.values():
            c.retries = 1
        gw = ServeGateway([cl["K0"], cl["K1"]], failures_to_trip=1)
        for r in _copy(greedy):
            gw.submit(r)
        outs = []
        t1 = time.perf_counter()
        while _s_healthz(ports["K0"])["steps"] < S_KILL_BUDGET:
            outs.extend(gw.step())
            check(time.perf_counter() - t1 < 300,
                  "S2 kill: K0 did not reach its step budget")
            time.sleep(0.005)
        on_k0 = sorted({st.req.request_id
                        for st in cl["K0"]._streams.values()})
        check(bool(on_k0), "S2 kill: no request on K0")
        children["K0"]["proc"].kill()
        children["K0"]["proc"].wait()
        outs.extend(_s_drive(gw, 600.0, "S2 kill"))
        kill = {"on_k0": on_k0, "breaker": gw.breaker_state("K0"),
                "breaker_trips": gw.stats.gateway_breaker_trips,
                "gateway_migrations": gw.stats.gateway_migrations,
                "streams_equal": {o.request_id: o.tokens
                                  == oracle[o.request_id] for o in outs},
                "finish_reasons": sorted({o.finish_reason for o in outs})}
        result["kill"] = kill
        check(len(outs) == len(greedy)
              and all(kill["streams_equal"].values())
              and kill["gateway_migrations"] >= len(on_k0)
              and kill["finish_reasons"] == ["length"],
              f"S2 kill: {kill}")

        # The drain: D0 stops stepping after S_DRAIN_BUDGET steps, then
        # drains over the wire; its streams move to K1 by resubmission.
        gw = ServeGateway([cl["D0"], cl["K1"]])
        for r in _copy(greedy[:4]):
            gw.submit(r)
        on_d0 = sorted({st.req.request_id
                        for st in cl["D0"]._streams.values()})
        check(bool(on_d0), "S2 drain: no request on D0")
        outs = []
        t1 = time.perf_counter()
        while _s_healthz(ports["D0"])["steps"] < S_DRAIN_BUDGET:
            outs.extend(gw.step())
            check(time.perf_counter() - t1 < 300,
                  "S2 drain: D0 did not reach its step budget")
            time.sleep(0.005)
        gw.drain_replica("D0")
        outs.extend(_s_drive(gw, 600.0, "S2 drain"))
        drain = {"on_d0": on_d0, "draining": cl["D0"].draining,
                 "gateway_migrations": gw.stats.gateway_migrations,
                 "streams_equal": {o.request_id: o.tokens
                                   == oracle[o.request_id] for o in outs}}
        result["drain"] = drain
        check(len(outs) == 4 and drain["draining"]
              and drain["gateway_migrations"] >= len(on_d0)
              and all(drain["streams_equal"].values()),
              f"S2 drain: {drain}")
        del model
    finally:
        summaries = _s_stop(children)
    pages_after = {}
    for rid in ("H", "K1", "D0"):
        rc, summ = summaries[rid]
        check(rc == 0 and summ is not None, f"S2 {rid}: exit {rc}")
        result["route_launches"][rid] = summ["route_launches"]
        pages_after[rid] = summ["pages_used_after"]
    result["pages_used_after"] = pages_after
    result["K0_exit"] = summaries["K0"][0]        # SIGKILLed: no summary
    routes = result["route_launches"]
    check(all(v["tf32x3"] > 0 and v["decode"] == v["prefill"] == v["split"]
              == v["int8"] == 0 for v in routes.values())
          and not any(pages_after.values()),
          f"S2 launches by process {routes}: every paged launch on "
          f"tf32x3; pages held after {pages_after}")
    result["since_start_s"] = time.perf_counter() - started
    log(result)
    gc.collect()
    torch.cuda.empty_cache()
    return result


S3_CLI = [sys.executable, "-u", "-m",
          "k8s_distributed_deeplearning_torch.serve", "--preset", "small"]


def _s3_replicas(tmp: Path) -> list:
    """S3's two replica-server processes, started early (during S2):
    ``--replica-server --preset small`` on ephemeral ports, with heartbeat
    beacons in ``tmp/s3_hb``."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return [subprocess.Popen(
        S3_CLI + ["--replica-server", "--metrics-port", "0",
                  "--port-file", str(tmp / f"s3-{i}.port"),
                  "--heartbeat-dir", str(tmp / "s3_hb"),
                  "--replica-rank", str(i), "--max-queue", "1"],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(2)]


def _s3(started, tmp: Path, procs: list):
    """S3: the serve CLI itself, as a user runs it: the two replica-server
    processes of :func:`_s3_replicas` and a gateway process that finds
    them by their beacons; SIGTERM to the gateway, then to each replica:
    every process exits 0, and each replica prints ``replica_drained``."""
    hb = tmp / "s3_hb"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    t0 = time.perf_counter()
    try:
        deadline = time.perf_counter() + 300
        for i, p in enumerate(procs):
            pf = tmp / f"s3-{i}.port"
            while not (pf.exists() and pf.read_text().strip()):
                check(p.poll() is None and time.perf_counter() < deadline,
                      f"S3 replica {i} not up: {p.poll()}")
                time.sleep(0.05)
        up_s = time.perf_counter() - t0
        gw = subprocess.Popen(
            S3_CLI + ["--replica-discovery-dir", str(hb), "--requests", "64"],
            cwd=str(REPO), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        procs.append(gw)
        lines = []
        while time.perf_counter() < deadline:
            line = gw.stdout.readline()
            if not line:
                break
            lines.append(line)
            if '"serve_request"' in line:
                break
        check(bool(lines) and '"serve_request"' in lines[-1],
              f"S3 gateway: {''.join(lines)[-2000:]}")
        gw.send_signal(signal.SIGTERM)
        rest, gerr = gw.communicate(timeout=300)
        gout = "".join(lines) + rest
        outs = []
        for p in procs[:2]:
            p.send_signal(signal.SIGTERM)
        for p in procs[:2]:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reasons: dict = {}
    for line in gout.splitlines():
        if '"serve_request"' in line:
            why = json.loads(line)["finish_reason"]
            reasons[why] = reasons.get(why, 0) + 1
    result = {"phase": "S3", "preset": "small",
              "exit_codes": [p.returncode for p in procs],
              "gateway_finish_reasons": reasons,
              "replica_drained": [o.count('"replica_drained"')
                                  for o, _ in outs],
              "replica_summaries": [o.count('"serve_summary"')
                                    for o, _ in outs],
              "replicas_wait_s": up_s, "wall_s": time.perf_counter() - t0,
              "since_start_s": time.perf_counter() - started}
    log(result)
    check(result["exit_codes"] == [0, 0, 0],
          f"S3 exit codes {result['exit_codes']}: gateway {gerr[-1500:]}; "
          f"replicas {[e[-800:] for _, e in outs]}")
    check(result["replica_drained"] == [1, 1]
          and result["replica_summaries"] == [1, 1]
          and '"serve_summary"' in gout, f"S3: {result}")
    return result


def phase_s(dev, b_streams, b_logits, started, tmp: Path):
    """The wire half of the serving fleet on the card, over localhost
    HTTP between processes: S1 disaggregated serving at full 8B, S2 the
    f32 exact gates of a hop, a kill and a drain, S3 the serve CLI."""
    s1 = _s1(b_streams, b_logits, started, tmp)
    s3_procs = _s3_replicas(tmp)
    try:
        s2 = _s2(dev, started, tmp)
    except BaseException:
        for p in s3_procs:
            p.kill()
            p.wait()
        raise
    return {"s1": s1, "s2": s2, "s3": _s3(started, tmp, s3_procs)}


# ------------------------------------------------------------- phase L/M

GEN_NEW = 32


def _all_launches() -> dict:
    """Every wrapper's launches by kernel-line name (:func:`_launch_counts`)
    and the paged wrapper's by branch and route."""
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    attn = paged_attn.paged_decode_attention
    out = _launch_counts()
    out.update({f"paged_{k}": getattr(attn, k) for k in (
        "launches_int8", "launches_prefill", "launches_prefill_int8",
        "launches_decode", "launches_decode_int8", "launches_tf32x3",
        "launches_tf32x3_int8")})
    return out


def _zero_all() -> None:
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    _zero_launches()
    _zero_counts(paged_attn.paged_decode_attention)


def _pad_left(rows) -> tuple[np.ndarray, np.ndarray]:
    """Token rows left-padded (with 0) to the longest, and their mask."""
    s = max(len(r) for r in rows)
    prompt = np.zeros((len(rows), s), np.int32)
    mask = np.zeros((len(rows), s), np.int32)
    for i, r in enumerate(rows):
        prompt[i, s - len(r):] = r
        mask[i, s - len(r):] = 1
    return prompt, mask


def _left_padded(vocab, lens, seed):
    """Random prompts of ``lens`` real tokens each, left-padded."""
    rng = np.random.default_rng(seed)
    return _pad_left([rng.integers(0, vocab, n) for n in lens])


class _PrefillSpy:
    """While in use, ``models.generate.prefill`` is wrapped: synchronized
    on both sides, each call records its seconds, the cache it made and
    every wrapper's launches just after it."""

    def __enter__(self):
        from k8s_distributed_deeplearning_torch.models import generate

        self.lib, self.orig = generate, generate.prefill

        def spied(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = self.orig(*a, **kw)
            torch.cuda.synchronize()
            self.seconds = time.perf_counter() - t0
            self.cache = cache
            self.launches = _all_launches()
            return logits, cache

        generate.prefill = spied
        return self

    def __exit__(self, *exc):
        self.lib.prefill = self.orig


def _generate(model, prompt, **kw):
    """One ``generate`` call on a host prompt, synchronized: tokens on the
    host and its wall seconds. The tokens come back on the model's
    device."""
    from k8s_distributed_deeplearning_torch.models import generate

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate.generate(model, prompt, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    where = next(model.parameters()).device
    check(out.device == where, f"generate ran on {out.device}, the model "
          f"lives on {where}")
    return out.cpu().numpy(), wall


def _in_vocab(tokens, vocab, what):
    check(bool(((tokens >= 0) & (tokens < vocab)).all()),
          f"{what}: token outside the vocabulary")


def phase_l(dev):
    """Phase L: one-shot ``generate`` at Llama-3 8B, full width, 16 layers,
    bf16, random weights from seed 0, on the dense cache; then the f32
    cross-checks at 4 layers."""
    from k8s_distributed_deeplearning_torch.models import generate, llama

    cfg = llama.config_llama3_8b(n_layers=SERVE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    model = llama.LlamaLM(cfg, device=dev, seed=0)
    lens = [1500] + np.random.default_rng(6).integers(100, 1500, 3).tolist()
    prompt, mask = _left_padded(cfg.vocab_size, lens, seed=7)
    window = generate.cache_window(cfg.max_seq_len, prompt.shape[1],
                                   GEN_NEW)
    sampling = dict(temperature=0.8, top_k=50, top_p=0.9)
    runs = {}
    with _PrefillSpy() as spy:
        _zero_all()
        # The first call pays the allocator's growth and cuBLAS's first
        # plans; the rates come from the second greedy run.
        for name in ("greedy_first", "greedy", "sampled", "sampled_again"):
            kw = {}
            if name.startswith("sampled"):
                gen = torch.Generator(device=dev)
                gen.manual_seed(11)
                kw = dict(sampling, generator=gen)
            out, wall = _generate(model, prompt, max_new_tokens=GEN_NEW,
                                  prompt_mask=mask, **kw)
            check(out.shape == (4, GEN_NEW), f"{name}: shape {out.shape}")
            _in_vocab(out, cfg.vocab_size, name)
            check(spy.cache.length == window,
                  f"{name}: cache of {spy.cache.length} columns, want the "
                  f"window {window}")
            runs[name] = {"tokens": out, "prefill_s": spy.seconds,
                          "wall_s": wall}
        launches = _all_launches()
        cache = spy.cache
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    check(not any(launches.values()),
          f"launches during generate {launches}: the dense path runs no "
          "paged, flash or grouped-matmul kernel")
    check(np.array_equal(runs["sampled"]["tokens"],
                         runs["sampled_again"]["tokens"]),
          "two sampled runs from one seed differ")
    greedy = runs["greedy"]["tokens"]
    check(np.array_equal(greedy, runs["greedy_first"]["tokens"]),
          "two greedy runs differ")
    # A reading, not a gate: a row alone multiplies [1, S] matrices, the
    # batch [4, S], and cuBLAS may sum those in another order in bf16.
    alone = []
    for i, n in enumerate(lens):
        row, _ = _generate(model, prompt[i:i + 1, -n:],
                           max_new_tokens=GEN_NEW)
        same = row[0] == greedy[i]
        alone.append({"len": n, "equal": int(same.sum()),
                      "first_diff": (None if same.all()
                                     else int(np.argmin(same)))})
    pm = torch.from_numpy(mask).to(dev)
    step_kw = dict(positions=pm.sum(-1, dtype=torch.int32)[:, None],
                   segment_ids=torch.ones(4, 1, dtype=torch.int32,
                                          device=dev))
    token = torch.from_numpy(greedy[:, 0]).to(dev)

    def step():
        cache.index = prompt.shape[1]
        generate.decode_step(model, cache, token, **step_kw).argmax(-1)

    step()
    profile = _profile(step, 16)
    del cache
    p_t, p_kw = torch.from_numpy(prompt).to(dev), \
        generate.left_padded_inputs(pm)
    prefill_prof = _profile(
        lambda: generate.prefill(model, p_t, cache_len=window,
                                 logits_index=-1, **p_kw), 2)
    g = runs["greedy"]
    result = {
        "phase": "L", "model": "llama3-8b", "layers": cfg.n_layers,
        "dtype": "bfloat16", "batch": 4, "prompt_lens": lens,
        "prompt_columns": prompt.shape[1], "cache_window": window,
        "new_tokens": GEN_NEW, "sampling": sampling,
        "prefill_ms": g["prefill_s"] * 1e3,
        "prefill_tokens_per_s": int(mask.sum()) / g["prefill_s"],
        "decode_tokens_per_s": 4 * (GEN_NEW - 1)
        / (g["wall_s"] - g["prefill_s"]),
        "generate_s": {k: v["wall_s"] for k, v in runs.items()},
        "prefill_s": {k: v["prefill_s"] for k, v in runs.items()},
        "peak_memory_gb": peak_gb,
        "launches": launches, "sampled_runs_equal": True,
        "greedy_alone_tokens_equal": sum(a["equal"] for a in alone),
        "greedy_alone_tokens_compared": 4 * GEN_NEW,
        "greedy_alone_rows": alone, "decode_step": profile,
        "prefill_profile": prefill_prof}
    log(result)
    del model, spy, step
    gc.collect()
    torch.cuda.empty_cache()
    result["f32"] = _generate_f32(dev)
    return result


def _generate_f32(dev):
    """Phase L in f32 (TF32 off) at 8B width and 4 layers, one set of
    weights: each of phase C's 8 requests generated alone equals the
    port's ``ServeEngine`` greedy stream (the tf32x3 paged kernel) for 16
    tokens, and each row of a left-padded batch of the first 4 equals that
    row alone. ``generate`` launches no kernel."""
    from k8s_distributed_deeplearning_torch.models import generate, llama
    from k8s_distributed_deeplearning_torch.ops import paged_attn
    from k8s_distributed_deeplearning_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama.config_llama3_8b(max_seq_len=2048, n_layers=4,
                                 dtype=torch.float32)
    model = llama.LlamaLM(cfg, device=dev, seed=0)
    reqs = _requests(cfg.vocab_size, 16, sampled=False)
    eng = ServeEngine(model, num_slots=4, prefill_chunk_tokens=512,
                      device=dev)
    attn = paged_attn.paged_decode_attention
    _zero_all()
    engine = {o.request_id: o.tokens for o in eng.run(reqs)}
    routes = {"tf32x3": attn.launches_tf32x3,
              "split": _split_launches(attn, "fp"),
              "prefill": attn.launches_prefill,
              "decode": attn.launches_decode}
    check(routes["tf32x3"] > 0 and not routes["split"]
          and not routes["prefill"] and not routes["decode"],
          f"f32 engine launches by route {routes}: want the tf32x3 route")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    _zero_all()
    alone = {r.request_id: _generate(model, r.prompt[None],
                                     max_new_tokens=16)[0][0].tolist()
             for r in reqs}
    lens = [len(r.prompt) for r in reqs[:4]]
    prompt, mask = _pad_left([r.prompt for r in reqs[:4]])
    padded, _ = _generate(model, prompt, max_new_tokens=16, prompt_mask=mask)
    launches = _all_launches()
    engine_equal = {rid: alone[rid] == engine[rid] for rid in sorted(alone)}
    padded_equal = {r.request_id: padded[i].tolist() == alone[r.request_id]
                    for i, r in enumerate(reqs[:4])}
    result = {"phase": "L", "case": "f32_cross_checks",
              "model": "llama3-8b width, 4 layers", "dtype": "float32",
              "requests": len(reqs), "tokens_compared": 16,
              "engine_launches_by_route": routes,
              "generate_launches": {k: v for k, v in launches.items() if v},
              "generate_equals_engine": engine_equal,
              "padded_prompt_lens": lens,
              "padded_row_equals_alone": padded_equal}
    log(result)
    check(not any(launches.values()),
          f"f32 generate launches {launches}: want none")
    check(all(engine_equal.values()),
          "f32 generate and ServeEngine greedy streams differ")
    check(all(padded_equal.values()),
          "f32 left-padded rows differ from the rows generated alone")
    del model
    return result


# Phase M, bf16: the logits of every real prefill position, ragged against
# index dispatch on the same weights, relative L2 per row. The wgmma
# grouped GEMM and cuBLAS's batched matmul sum each product in the same
# order on the H100, and the two paths read bitwise-equal logits there
# (relative L2 0.0, PERF.md section 6). The limit is one bf16 step: a
# change of either summation order reads near it or above it, and a row
# block sent to the wrong expert, which the phase plants in the first
# layer to show that the check sees it, reads far above it.
MOE_BF16_LOGIT_RTOL = 2 ** -8


def _real_rel_l2(got, want, mask) -> list:
    """Relative L2 of ``got`` against ``want`` [B, S, V] per row, over the
    row's real positions (``mask`` [B, S], numpy, nonzero where real)."""
    real = torch.from_numpy(mask).to(got.device).bool()
    return [float((got[b, m] - want[b, m]).norm() / want[b, m].norm())
            for b, m in enumerate(real)]


class _MisroutedBlock:
    """Within the ``with`` block, the first grouped layout that the MoE
    layer builds sends its first live row block to the next expert (a
    routing fault planted to show that phase M's comparison sees one)."""

    def __enter__(self):
        from k8s_distributed_deeplearning_torch.models import moe

        self.gmm_ops = moe.gmm_ops
        self.build = build = self.gmm_ops.grouped_layout
        self.planted = 0

        def faulty(group_sizes, total_rows, block_m):
            lay = build(group_sizes, total_rows, block_m=block_m)
            if self.planted:
                return lay
            self.planted += 1
            experts = lay.block_expert.clone()
            blk = int(lay.block_live.argmax())
            experts[blk] = (experts[blk] + 1) % group_sizes.shape[0]
            return lay._replace(block_expert=experts)

        self.gmm_ops.grouped_layout = faulty
        return self

    def __exit__(self, *exc):
        self.gmm_ops.grouped_layout = self.build


def _rel_l2(got, want, dims) -> list:
    return ((got - want).norm(dim=dims) / want.norm(dim=dims)).tolist()


def phase_m(dev):
    """Phase M: ``generate`` on the ragged MoE (phase H's backbone, 8
    experts top-2, block 512), bf16; launches exact; ragged against index
    dispatch in bf16 and, at 2 layers, in f32."""
    import dataclasses

    from k8s_distributed_deeplearning_torch.models import generate, llama, moe

    cfg = llama.config_tiny(**MOE_BACKBONE, max_seq_len=1024,
                            dtype=torch.bfloat16)
    mcfg = moe.MoEConfig(num_experts=8, top_k=2, dispatch="ragged",
                         ragged_block_m=512)
    n = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    model = moe.MoELM(cfg, mcfg, device=dev, seed=0)
    lens = [512] + np.random.default_rng(8).integers(100, 512, 3).tolist()
    prompt, mask = _left_padded(cfg.vocab_size, lens, seed=9)
    # A first call pays the allocator's growth and cuBLAS's first plans.
    first, _ = _generate(model, prompt, max_new_tokens=GEN_NEW,
                         prompt_mask=mask)
    with _PrefillSpy() as spy:
        _zero_all()
        out, wall = _generate(model, prompt, max_new_tokens=GEN_NEW,
                              prompt_mask=mask)
        at_prefill, prefill_s = spy.launches, spy.seconds
        window = spy.cache.length
        launches = _all_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    _in_vocab(out, cfg.vocab_size, "MoE generate")
    check(np.array_equal(out, first), "two MoE greedy runs differ")
    want = {k: 0 for k in launches}
    want.update(gmm=3 * n, gmm_wgmma=3 * n)
    check(at_prefill == want,
          f"MoE prefill launches {at_prefill}: want {want} (3 grouped "
          "GEMMs a layer on the wgmma route)")
    check(launches == want,
          f"MoE generate launches {launches}: the decode steps (t = 4, the "
          f"index path) must add none to the prefill's {want}")
    p_t = torch.from_numpy(prompt).to(dev)
    kw = generate.left_padded_inputs(torch.from_numpy(mask).to(dev))

    def prefill(m, **extra):
        return generate.prefill(m, p_t, cache_len=window, **kw, **extra)[0]

    profile = _profile(lambda: prefill(model, logits_index=-1), 4)
    index = moe.MoELM(cfg, dataclasses.replace(mcfg, dispatch="index"),
                      device=dev, seed=0)
    index.load_state_dict(model.state_dict())
    logits, compare_launches = {}, {}
    for name, m in (("ragged", model), ("index", index)):
        _zero_all()
        logits[name] = prefill(m)
        compare_launches[name] = {k: v for k, v in _all_launches().items()
                                  if v}
    check(compare_launches == {"ragged": {"gmm": 3 * n,
                                          "gmm_wgmma": 3 * n},
                               "index": {}},
          f"bf16 comparison prefills launched {compare_launches}: want the "
          "grouped GEMMs on the ragged path only")
    ragged_all, index_all = logits["ragged"].float(), logits["index"].float()
    rel = _real_rel_l2(ragged_all, index_all, mask)
    with _MisroutedBlock() as fault:
        faulty = prefill(model).float()
    check(fault.planted == 1, "the misrouted block was not planted")
    fault_rel = _real_rel_l2(faulty, index_all, mask)
    ragged_last, index_last = ragged_all[:, -1], index_all[:, -1]
    largest = (ragged_last - index_last).abs().max(-1).values
    top2 = index_last.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * largest
    same = ragged_last.argmax(-1) == index_last.argmax(-1)
    bitwise = torch.equal(logits["ragged"], logits["index"])
    del logits, ragged_all, index_all, faulty
    del model, index, spy
    gc.collect()
    torch.cuda.empty_cache()
    result = {
        "phase": "M", "model": "llama-small MoE 8e top-2 ragged",
        "layers": n, "dtype": "bfloat16", "experts": mcfg.num_experts,
        "top_k": mcfg.top_k, "ragged_block_m": mcfg.ragged_block_m,
        "batch": 4, "prompt_lens": lens, "cache_window": window,
        "new_tokens": GEN_NEW, "prefill_ms": prefill_s * 1e3,
        "decode_tokens_per_s": 4 * (GEN_NEW - 1) / (wall - prefill_s),
        "generate_s": wall, "peak_memory_gb": peak_gb,
        "prefill_launches": {k: v for k, v in at_prefill.items() if v},
        "generate_launches": {k: v for k, v in launches.items() if v},
        "prefill_profile": profile,
        "bf16_ragged_vs_index": {
            "launches": compare_launches,
            "logit_rel_l2": rel, "rtol": MOE_BF16_LOGIT_RTOL,
            "bitwise_equal": bitwise,
            "misrouted_block_rel_l2": fault_rel,
            "first_token_decided": decided.tolist(),
            "first_token_equal": same.tolist()}}
    log(result)
    check(all(np.isfinite(rel)) and max(rel) <= MOE_BF16_LOGIT_RTOL,
          f"bf16 MoE prefill logits, ragged vs index: relative L2 "
          f"{max(rel)} > {MOE_BF16_LOGIT_RTOL}")
    check(max(fault_rel) > MOE_BF16_LOGIT_RTOL,
          f"a row block sent to the wrong expert reads relative L2 "
          f"{max(fault_rel)}, within the limit {MOE_BF16_LOGIT_RTOL}")
    check(bool(same[decided].all()),
          "bf16 MoE prefill: a first greedy token differs where the index "
          "path's top-2 margin exceeds twice the largest logit difference")
    result["f32"] = _moe_f32(dev, mcfg, prompt, mask)
    return result


def _moe_f32(dev, mcfg, prompt, mask):
    """Phase M in f32 (TF32 off) at 2 layers, one set of weights: the
    ragged path (the grouped GEMM on the tf32x3 route, 3 a layer in the
    prefill) and ``dispatch="index"`` give the same first 16 greedy tokens,
    and their prefill logits agree within 1e-4 relative L2 per row."""
    import dataclasses

    from k8s_distributed_deeplearning_torch.models import generate, llama, moe

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = llama.config_tiny(**dict(MOE_BACKBONE, n_layers=2),
                            max_seq_len=1024, dtype=torch.float32)
    ragged = moe.MoELM(cfg, mcfg, device=dev, seed=0)
    index = moe.MoELM(cfg, dataclasses.replace(mcfg, dispatch="index"),
                      device=dev, seed=0)
    index.load_state_dict(ragged.state_dict())
    streams, launches = {}, {}
    for name, m in (("ragged", ragged), ("index", index)):
        _zero_all()
        streams[name], _ = _generate(m, prompt, max_new_tokens=16,
                                     prompt_mask=mask)
        launches[name] = {k: v for k, v in _all_launches().items() if v}
    p_t = torch.from_numpy(prompt).to(dev)
    kw = generate.left_padded_inputs(torch.from_numpy(mask).to(dev))
    window = generate.cache_window(cfg.max_seq_len, prompt.shape[1], 16)
    logits = {name: generate.prefill(m, p_t, cache_len=window, **kw)[0]
              for name, m in (("ragged", ragged), ("index", index))}
    rel = _rel_l2(logits["ragged"], logits["index"], (-2, -1))
    equal = np.array_equal(streams["ragged"], streams["index"])
    result = {"phase": "M", "case": "f32_ragged_vs_index", "layers": 2,
              "dtype": "float32", "tokens_compared": 16,
              "launches": launches, "streams_equal": equal,
              "prefill_logit_rel_l2": rel}
    log(result)
    n = cfg.n_layers
    check(launches == {"ragged": {"gmm": 3 * n, "gmm_tf32x3": 3 * n},
                       "index": {}},
          f"f32 MoE generate launches {launches}: want {3 * n} gmm on the "
          "tf32x3 route for ragged, none for index")
    check(equal, "f32 MoE greedy streams differ, ragged vs index")
    check(max(rel) <= 1e-4,
          f"f32 MoE prefill logits, ragged vs index: relative L2 "
          f"{max(rel)} > 1e-4")
    del ragged, index, logits
    return result


# ------------------------------------------------------------- phase D

# name: (B, sq, sk, H, KV, head_dim, causal, segment lengths). Llama-3
# 8B's attention at training length, then MoE H's (the Llama-small
# backbone's 12/4 heads at head_dim 64, 8 x 1024 tokens), then phase Q's
# (the train CLI's tiny preset, 4/2 heads at head_dim 16, 8 x 1024
# tokens), then the same heads at head_dim 32 with packed documents of
# 300/400/324 tokens (the small kernels' other head dim, with segment ids),
# then the zoo's encoders, bidirectional at head_dim 64: BERT-base (B 16,
# S 512, 12 heads) and ViT-L/16 at 224² (B 32, S 197, which no tile
# divides, 16 heads).
FLASH_CASES = {
    "causal": (2, 2048, 2048, H, KV, HD, True, None),
    "noncausal": (2, 2048, 2048, H, KV, HD, False, None),
    "sq512_sk2048_causal": (2, 512, 2048, H, KV, HD, True, None),
    "three_docs_causal": (2, 2048, 2048, H, KV, HD, True, (700, 800, 548)),
    "moe_h_causal": (8, 1024, 1024, 12, 4, 64, True, None),
    "q_tiny_causal": (8, 1024, 1024, 4, 2, 16, True, None),
    "q_hd32_docs": (8, 1024, 1024, 4, 2, 32, True, (300, 400, 324)),
    "bert_base": (16, 512, 512, 12, 12, 64, False, None),
    "vit_l16": (32, 197, 197, 16, 16, 64, False, None),
}
FLASH_REPLACES = {
    "flash_fwd": "k8s_distributed_deeplearning_tpu/ops/pallas_flash.py:148",
    "flash_bwd_dq": "k8s_distributed_deeplearning_tpu/ops/pallas_flash.py:396",
    "flash_bwd_dkv":
        "k8s_distributed_deeplearning_tpu/ops/pallas_flash.py:520",
    # Not a Pallas kernel: the wrapper's jnp reduction delta = rowsum(dO *
    # O), which the bf16 backward computes as the sum of P dP instead.
    "flash_bwd_delta":
        "k8s_distributed_deeplearning_tpu/ops/pallas_flash.py:669",
}
# Kernel-line name -> (source, wrapper); FLASH_REPLACES names the TPU
# kernel by wrapper. Each wrapper launches the kernel of its route: the
# wgmma lines are the "wgmma" route (bf16, head_dim 64/128), the tf32x3
# lines the "tf32x3" route (f32, every head dim), the small lines the
# "small" route (bf16 at head_dim 16/32), the others the first kernels
# of flash_attn.cu ("mma"), which no training path takes: forced here on
# the same inputs.
FLASH_KERNELS = {
    "flash_fwd": ("flash_attn.cu", "flash_fwd"),
    "flash_fwd_wgmma": ("flash_fwd.cu", "flash_fwd"),
    "flash_fwd_tf32x3": ("flash_fwd_f32.cu", "flash_fwd"),
    "flash_bwd_dq": ("flash_attn.cu", "flash_bwd_dq"),
    "flash_bwd_dkv": ("flash_attn.cu", "flash_bwd_dkv"),
    "flash_bwd_dq_wgmma": ("flash_bwd.cu", "flash_bwd_dq"),
    "flash_bwd_dkv_wgmma": ("flash_bwd.cu", "flash_bwd_dkv"),
    "flash_bwd_dq_tf32x3": ("flash_bwd_f32.cu", "flash_bwd_dq"),
    "flash_bwd_dkv_tf32x3": ("flash_bwd_f32.cu", "flash_bwd_dkv"),
    "flash_fwd_small": ("flash_small.cu", "flash_fwd"),
    "flash_bwd_dq_small": ("flash_small.cu", "flash_bwd_dq"),
    "flash_bwd_dkv_small": ("flash_small.cu", "flash_bwd_dkv"),
    "flash_bwd_delta_wgmma": ("flash_delta.cu", "flash_bwd_delta"),
    "flash_bwd_delta_small": ("flash_delta.cu", "flash_bwd_delta"),
}
# Routes other than "mma", whose launches a wrapper counts apart
# (``launches_<route>``) and whose kernel lines carry ``_<route>``.
ROUTE_COUNTS = ("wgmma", "tf32x3", "small")
# TF32 dense on an H100 SXM: the tf32x3 kernels issue three TF32 products
# for each f32 product, so their least time is 3 x FLOPs over this.
PEAK_TF32 = 495e12
# The H100 SXM's exponentials: 16 ex2 an SM a clock (the multi-function
# units), 132 SMs at the 1.98 GHz boost clock. Every flash kernel takes
# one exponential per visible (query, key) pair and query head.
PEAK_EX2 = 16 * 132 * 1.98e9


def _flash_case(dev, dtype, shape, seed):
    b, sq, sk, h, kv, hd, _, seg_lens = shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rnd(*dims):
        return torch.randn(*dims, generator=gen, device=dev).to(dtype)

    q = rnd(b, sq, h, hd)
    k, v = rnd(b, sk, kv, hd), rnd(b, sk, kv, hd)
    do = rnd(b, sq, h, hd)
    segq = segk = None
    if seg_lens is not None:
        ids = torch.repeat_interleave(
            torch.arange(1, len(seg_lens) + 1, device=dev),
            torch.tensor(seg_lens, device=dev)).to(torch.int32)
        segk = ids[None].expand(b, sk).contiguous()
        segq = segk[:, sk - sq:].contiguous()
    return q, k, v, do, segq, segk


def _visible_pairs(dev, shape, segq, segk):
    """(query, key) pairs the mask lets through, summed over the batch."""
    b, sq, sk, _, _, _, causal, _ = shape
    row = torch.arange(sq, device=dev)[:, None]
    col = torch.arange(sk, device=dev)[None, :]
    allow = torch.ones(1, sq, sk, dtype=torch.bool, device=dev)
    if causal:
        allow = allow & (row + (sk - sq) >= col)[None]
    if segq is not None:
        allow = allow & (segq[:, :, None] == segk[:, None, :])
    return int(allow.sum()) * (b if allow.shape[0] == 1 else 1)


def _flash_bound(kind, dtype, shape, pairs):
    """Least time on an H100 SXM: the largest of each input read once and
    each output written once over 3.35 TB/s, the kernel's matmul FLOPs on
    the visible pairs (forward 2 products, dQ 3, dK/dV 4, each 2 *
    head_dim FLOPs per pair and query head) over the dtype's peak (for
    the tf32x3 lines, 3 x those FLOPs over the TF32 peak; the f32
    CUDA-core bound, 67 TF/s, which a three-pass kernel may beat, is the
    mma line's bound for the same work), and one exponential per visible
    pair and query head over ``PEAK_EX2``. Returns (ms, "bytes" or
    "operations", {"bytes_ms", "mma_ms", "exp_ms"})."""
    b, sq, sk, h, kv, hd, _, _ = shape
    item = torch.finfo(dtype).bits // 8
    qo = b * sq * h * hd * item                    # q, o, do or dq
    kvb = b * sk * kv * hd * item                  # k or v (dk or dv)
    stat = b * h * sq * 4                          # lse or delta, f32
    base = kind
    for route in ROUTE_COUNTS:
        base = base.removesuffix(f"_{route}")
    nbytes, mm = {"flash_fwd": (2 * qo + 2 * kvb + stat, 2),
                  "flash_bwd_dq": (3 * qo + 2 * kvb + 2 * stat, 3),
                  "flash_bwd_dkv": (2 * qo + 4 * kvb + 2 * stat, 4),
                  "flash_bwd_delta": (2 * qo + 2 * kvb + 2 * stat, 2)}[base]
    flops = mm * 2 * hd * h * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = (3 * flops / PEAK_TF32 if kind.endswith("_tf32x3")
               else flops / PEAK_FLOPS[dtype]) * 1e3
    t_exp = h * pairs / PEAK_EX2 * 1e3
    t_ops = max(t_flops, t_exp)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), {
        "bytes_ms": t_bytes, "mma_ms": t_flops, "exp_ms": t_exp}


def _flash_err(outputs: dict, tol) -> dict:
    """Kernel outputs against the plain ones, ``{name: (got, ref)}``. Each
    element's scale is the larger of its row's RMS (the head_dim vector of
    one position and head) and the whole output's RMS. Returns the largest
    |got - ref|, the largest |got - ref| over its scale, and the largest
    share of the limit atol x scale + rtol x |ref| used (the check: <= 1),
    each the worst over the outputs."""
    atol, rtol = tol
    worst = {"max_abs_err": 0.0, "err_over_scale": 0.0, "tol_share": 0.0}
    for got, ref in outputs.values():
        r = ref.float()
        d = (got.float() - r).abs()
        scale = r.square().mean(-1, keepdim=True).sqrt().clamp_min(
            float(r.square().mean().sqrt()))
        reading = {
            "max_abs_err": float(d.max()),
            "err_over_scale": float((d / scale).max()),
            "tol_share": float((d / (atol * scale + rtol * r.abs())).max())}
        worst = {k: max(worst[k], reading[k]) for k in worst}
    return worst


def _sdpa_fns(q, k, v, do, causal, segq, segk):
    """scaled_dot_product_attention on the same inputs (heads-first views,
    GQA), forward alone and forward + backward: a yardstick only."""
    import torch.nn.functional as F

    sq, sk = q.shape[1], k.shape[1]
    mask, is_causal = None, causal and sq == sk and segq is None
    if (causal and not is_causal) or segq is not None:
        row = torch.arange(sq, device=q.device)[:, None]
        col = torch.arange(sk, device=q.device)[None, :]
        mask = torch.ones(1, 1, sq, sk, dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (row + (sk - sq) >= col)
        if segq is not None:
            mask = mask & (segq[:, None, :, None] == segk[:, None, None, :])
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=is_causal, enable_gqa=True)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qt, kt, vt), dot)

    return fwd, fwd_bwd


def _sdpa_backend(fn, reps: int = 3) -> str:
    """Which fused kernel ``scaled_dot_product_attention`` took in ``fn``,
    read from the names of the CUDA kernels that ``reps`` profiled calls
    launch (one call alone was seen to miss kernels in a trace started
    cold, as in ``_profile_reps``): "cudnn", "flash", "efficient" (the
    memory-efficient CUTLASS fmha), else "math (<the longest kernel's
    name>)"; "not traced" if the profiler saw no CUDA kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = sorted(((getattr(e, "self_device_time_total", 0), e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
    if not kernels:
        return "not traced"
    names = " ".join(name.lower() for _, name in kernels)
    for key, backend in (("cudnn", "cudnn"), ("flash", "flash"),
                         ("fmha", "efficient"), ("efficient", "efficient")):
        if key in names:
            return backend
    return f"math ({kernels[0][1][:60]})"


def _blind_rows(dev):
    """Rows that see no key (causal with sq > sk; a query segment id no
    key carries) and keys no row sees (a key segment id no query carries),
    in bf16 and f32 at 8B's head_dim and in bf16 at head_dim 16 (the small
    kernels): every backward route gives exactly the plain version's dQ, dK
    and dV there (0), every forward route but mma (wgmma, tf32x3, small)
    O = 0 and the plain lse, and the bf16 delta on each of its routes 0.
    Returns the routes checked."""
    from k8s_distributed_deeplearning_torch.ops import flash_attn as fa

    checked = []
    for dtype, hd in ((torch.bfloat16, HD), (torch.float32, HD),
                      (torch.bfloat16, 16)):
        q, k, v, do, _, _ = _flash_case(
            dev, dtype, (2, 96, 64, 8, 2, hd, True, None), 99)
        segq = torch.ones(2, 96, dtype=torch.int32, device=dev)
        segk = torch.ones(2, 64, dtype=torch.int32, device=dev)
        segq[0, 40:45] = 7
        segk[1, 10:20] = 8
        o, lse = fa.flash_attention_reference(
            q, k, v, causal=True, q_segment_ids=segq, kv_segment_ids=segk)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta, segq, segk, True, hd ** -0.5)
        want = fa.flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal=True, q_segment_ids=segq,
            kv_segment_ids=segk, delta=delta)
        blind = (lse <= -1e29).transpose(1, 2)       # [B, sq, H]
        unseen = torch.zeros(k.shape[:3], dtype=torch.bool, device=dev)
        unseen[1, 10:20] = True
        check(int(blind.sum()) > 0, "the blind-row case has no blind row")
        dname = f"{str(dtype).split('.')[-1]}/hd{hd}"
        for which in ("dq", "dkv"):
            for route in sorted({"mma", fa._bwd_route(dtype, hd, which)}):
                if which == "dq":
                    dq = fa.flash_bwd_dq(*args, route=route)
                    torch.cuda.synchronize()
                    same = torch.equal(dq[blind], want[0][blind])
                else:
                    dk, dv = fa.flash_bwd_dkv(*args, route=route)
                    torch.cuda.synchronize()
                    same = (torch.equal(dk[unseen], want[1][unseen])
                            and torch.equal(dv[unseen], want[2][unseen]))
                check(same, f"{route} {which}, {dname}: rows that see no "
                      f"key or keys no row sees differ from the plain "
                      f"version")
                checked.append(f"{which}:{route}/{dname}")
        if dtype == torch.bfloat16:
            for route in sorted({"small", fa._delta_route(hd)}):
                got_delta = fa.flash_bwd_delta(q, k, v, do, lse, segq, segk,
                                               True, hd ** -0.5, route=route)
                torch.cuda.synchronize()
                check(bool((got_delta[lse <= -1e29] == 0).all()),
                      f"{route} delta, {dname}: rows that see no key are "
                      f"not 0")
                checked.append(f"delta:{route}/{dname}")
        route = fa._fwd_route(dtype, hd)
        if route != "mma":
            o2, lse2 = fa.flash_fwd(q, k, v, segq, segk, True, hd ** -0.5)
            torch.cuda.synchronize()
            check(torch.equal(lse2[lse <= -1e29], lse[lse <= -1e29])
                  and bool((o2[blind] == 0).all()),
                  f"{route} forward, {dname}: rows that see no key differ "
                  f"from the plain version")
            checked.append(f"fwd:{route}/{dname}")
    return checked


def phase_d(dev, flush):
    """The flash kernels against their plain versions, case by case; the
    forward and each backward kernel on every route its dtype and head dim
    have (bf16 at head_dim 64/128: the wgmma kernels; bf16 at 16/32: the
    small kernels; f32: the tf32x3 kernels; each beside flash_attn.cu's
    mma kernels forced) on the same inputs, and each default route launched
    twice for bitwise equality; in bf16 also the backward's delta
    (``csrc/flash_delta.cu``) on each route its head dim has (64/128: the
    wgmma kernel, and the small one forced on the same inputs; 16/32: the
    small one) against its plain version at the f32 limit, each twice
    bitwise and 0 on rows that see no key, timed beside rowsum(dO * O)
    (JAX's delta, a different function); then rows that see no key on
    every backward route, on every forward route but mma and on both delta
    routes."""
    from k8s_distributed_deeplearning_torch.ops import flash_attn as fa

    rows = {name: [] for name in FLASH_KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        tol = FLASH_TOL[dtype]
        for ci, (case, shape) in enumerate(FLASH_CASES.items()):
            causal, hd = shape[6], shape[5]
            q, k, v, do, segq, segk = _flash_case(dev, dtype, shape, ci)
            scale = hd ** -0.5
            # kernel -> {route: kernel-line name}, the default route last.
            lines = {}
            for kernel, wrapper, default in (
                    ("fwd", "flash_fwd", fa._fwd_route(dtype, hd)),
                    ("dq", "flash_bwd_dq", fa._bwd_route(dtype, hd, "dq")),
                    ("dkv", "flash_bwd_dkv",
                     fa._bwd_route(dtype, hd, "dkv"))):
                lines[kernel] = {"mma": wrapper}
                if default != "mma":
                    lines[kernel][default] = f"{wrapper}_{default}"
            fwd = {route: fa.flash_fwd(q, k, v, segq, segk, causal, scale,
                                       route=route) for route in lines["fwd"]}
            ref_o, ref_lse = fa.flash_attention_reference(
                q, k, v, causal=causal, q_segment_ids=segq,
                kv_segment_ids=segk)
            delta = (do.float() * ref_o.float()).sum(-1).transpose(
                1, 2).contiguous()
            bwd_args = (q, k, v, do, ref_lse, delta, segq, segk, causal,
                        scale)
            want = fa.flash_attention_bwd_reference(
                q, k, v, ref_o, ref_lse, do, causal=causal,
                q_segment_ids=segq, kv_segment_ids=segk, delta=delta)
            got_dq = {route: fa.flash_bwd_dq(*bwd_args, route=route)
                      for route in lines["dq"]}
            got_dkv = {route: fa.flash_bwd_dkv(*bwd_args, route=route)
                       for route in lines["dkv"]}
            torch.cuda.synchronize()
            for out in [x for o_lse in fwd.values() for x in o_lse] + list(
                    got_dq.values()) + [x for dk_dv in got_dkv.values()
                                        for x in dk_dv]:
                check(bool(torch.isfinite(out).all()),
                      f"{case}/{dname}: non-finite kernel output")
            seen = ref_lse > -1e29
            blind = ~seen.transpose(1, 2)            # [B, sq, H]
            errs = {}
            for route, name in lines["fwd"].items():
                o, lse = fwd[route]
                check(torch.equal(lse <= -1e29, ~seen)
                      and torch.equal(lse[~seen], ref_lse[~seen])
                      and torch.equal(o[blind], ref_o[blind]),
                      f"{name} {case}/{dname}: rows that see no key differ")
                lse_err = float((lse[seen] - ref_lse[seen]).abs().max())
                check(lse_err <= LSE_ATOL,
                      f"{name} {case}/{dname}: lse error {lse_err} > "
                      f"{LSE_ATOL}")
                errs[name] = _flash_err({"o": (o, ref_o)}, tol)
                errs[name]["lse_max_abs_err"] = lse_err
            for route, name in lines["dq"].items():
                errs[name] = _flash_err({"dq": (got_dq[route], want[0])},
                                        tol)
            for route, name in lines["dkv"].items():
                dk, dv = got_dkv[route]
                errs[name] = _flash_err({"dk": (dk, want[1]),
                                         "dv": (dv, want[2])}, tol)
            if dtype == torch.bfloat16:
                # The bf16 backward's delta (the sum of P dP) on each route
                # its head dim has against its plain version, held to the
                # f32 limit: both sum f32 products, in different orders.
                want_delta = fa.flash_delta_reference(
                    q, k, v, ref_lse, do, causal=causal,
                    q_segment_ids=segq, kv_segment_ids=segk)
                for route in sorted({"small", fa._delta_route(hd)}):
                    name = f"flash_bwd_delta_{route}"
                    got_delta, again = (fa.flash_bwd_delta(
                        q, k, v, do, ref_lse, segq, segk, causal, scale,
                        route=route) for _ in range(2))
                    torch.cuda.synchronize()
                    errs[name] = _flash_err(
                        {"delta": (got_delta[..., None],
                                   want_delta[..., None])},
                        FLASH_TOL[torch.float32])
                    check(torch.equal(got_delta, again),
                          f"{case}/{dname}: two {route} delta launches "
                          f"differ")
                    check(bool((got_delta[~seen] == 0).all()),
                          f"{name} {case}/{dname}: rows that see no key "
                          f"are not 0")
                    del got_delta, again
            for name, e in errs.items():
                lim = FLASH_TOL[torch.float32
                                if name.startswith("flash_bwd_delta")
                                else dtype]
                check(e["tol_share"] <= 1.0,
                      f"{name} {case}/{dname}: {e} exceeds |kernel - plain| "
                      f"<= {lim[0]} x rms + {lim[1]} x |plain|")
            # Two launches of each default route other than mma, the same
            # bits.
            repeated = []
            fwd_default = list(lines["fwd"])[-1]
            if fwd_default != "mma":
                o2, lse2 = fa.flash_fwd(q, k, v, segq, segk, causal, scale)
                check(torch.equal(fwd[fwd_default][0], o2)
                      and torch.equal(fwd[fwd_default][1], lse2),
                      f"{case}/{dname}: two {fwd_default} forward launches "
                      f"differ")
                repeated.append(f"fwd:{fwd_default}")
                del o2, lse2
            dq_default = list(lines["dq"])[-1]
            if dq_default != "mma":
                check(torch.equal(got_dq[dq_default],
                                  fa.flash_bwd_dq(*bwd_args)),
                      f"{case}/{dname}: two {dq_default} dQ launches differ")
                repeated.append(f"dq:{dq_default}")
            dkv_default = list(lines["dkv"])[-1]
            if dkv_default != "mma":
                dk2, dv2 = fa.flash_bwd_dkv(*bwd_args)
                check(torch.equal(got_dkv[dkv_default][0], dk2)
                      and torch.equal(got_dkv[dkv_default][1], dv2),
                      f"{case}/{dname}: two {dkv_default} dK/dV launches "
                      f"differ")
                repeated.append(f"dkv:{dkv_default}")
                del dk2, dv2
            log({"phase": "D", "case": case, "dtype": dname,
                 "bitwise_repeat": repeated})
            del got_dq, got_dkv, fwd, o, lse
            pairs = _visible_pairs(dev, shape, segq, segk)
            sdpa_fwd, sdpa_fwd_bwd = _sdpa_fns(q, k, v, do, causal, segq,
                                               segk)
            plain_bwd_ms = time_ms(lambda: fa.flash_attention_bwd_reference(
                q, k, v, ref_o, ref_lse, do, causal=causal,
                q_segment_ids=segq, kv_segment_ids=segk), flush, 10)
            lib_fwd = time_ms(sdpa_fwd, flush, 10, host_ahead=True)
            lib_fwd_bwd = time_ms(sdpa_fwd_bwd, flush, 10, host_ahead=True)
            lib_backend = _sdpa_backend(sdpa_fwd_bwd)
            plain_fwd_ms = time_ms(lambda: fa.flash_attention_reference(
                q, k, v, causal=causal, q_segment_ids=segq,
                kv_segment_ids=segk), flush, 10)
            # Each kernel on the device alone: a wrapper's host side can
            # outlast the L2 flush before it, and the gap would count.
            times = {name: (time_ms(lambda: fa.flash_fwd(
                q, k, v, segq, segk, causal, scale, route=route), flush, 10,
                host_ahead=True), plain_fwd_ms, lib_fwd)
                for route, name in lines["fwd"].items()}
            for route, name in lines["dq"].items():
                times[name] = (time_ms(lambda: fa.flash_bwd_dq(
                    *bwd_args, route=route), flush, 10, host_ahead=True),
                    plain_bwd_ms, lib_fwd_bwd - lib_fwd)
            for route, name in lines["dkv"].items():
                times[name] = (time_ms(lambda: fa.flash_bwd_dkv(
                    *bwd_args, route=route), flush, 10, host_ahead=True),
                    plain_bwd_ms, lib_fwd_bwd - lib_fwd)
            if dtype == torch.bfloat16:
                # No single PyTorch call computes the sum of P dP. Beside
                # each route, rowsum(dO * O) over the same dO and the
                # forward's O, as the JAX wrapper computes delta: a
                # different function, the one the sum of P dP replaced.
                plain_delta_ms = time_ms(
                    lambda: fa.flash_delta_reference(
                        q, k, v, ref_lse, do, causal=causal,
                        q_segment_ids=segq, kv_segment_ids=segk),
                    flush, 10)
                rowsum_ms = time_ms(
                    lambda: (do.float() * ref_o.float()).sum(-1).transpose(
                        1, 2).contiguous(), flush, 10, host_ahead=True)
                for route in sorted({"small", fa._delta_route(hd)}):
                    name = f"flash_bwd_delta_{route}"
                    times[name] = (time_ms(
                        lambda: fa.flash_bwd_delta(
                            q, k, v, do, ref_lse, segq, segk, causal, scale,
                            route=route),
                        flush, 10, host_ahead=True), plain_delta_ms, None)
                    errs[name]["rowsum_do_o_ms"] = rowsum_ms
            b, sq, sk, h, kv, _, _, seg_lens = shape
            for name, (ms, plain_ms, lib_ms) in times.items():
                bound, by, parts = _flash_bound(name, dtype, shape, pairs)
                if name.endswith("_tf32x3"):       # the mma line's bound
                    errs[name]["bound_ms_f32_cores"] = _flash_bound(
                        name.removesuffix("_tf32x3"), dtype, shape, pairs)[0]
                lim = FLASH_TOL[torch.float32
                                if name.startswith("flash_bwd_delta")
                                else dtype]
                rows[name].append({
                    "case": case, "dtype": dname, "shape": {
                        "B": b, "sq": sq, "sk": sk, "H": h, "kv": kv,
                        "hd": hd, "causal": causal, "segments": seg_lens},
                    "visible_pairs": pairs, **errs[name],
                    "tol": {"atol_rms": lim[0], "rtol": lim[1]},
                    "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "library_fwd_bwd_ms": (None if lib_ms is None
                                           else lib_fwd_bwd),
                    "library_backend": (None if lib_ms is None
                                        else lib_backend),
                    "bound_ms": bound, "bound_by": by,
                    "bound_parts_ms": parts})
                log({"phase": "D", "kernel": name, **rows[name][-1]})
            del q, k, v, do, ref_o, ref_lse, want, delta, bwd_args
            torch.cuda.empty_cache()
    log({"phase": "D", "case": "blind_rows_exact",
         "routes": _blind_rows(dev)})
    return rows


# ------------------------------------------------------------- phase G

# (case, group sizes, routed rows, row block, K, N, dtypes), 8 experts: the
# MoE slice's expert products (gate and up: d 768 -> mlp 2048; down: 2048
# -> 768) at training's 16,384 rows and block 128; Mixtral-8x7B-class ones
# (4096 -> 14336, 14336 -> 4096) at 16,384 rows; the slice's products at
# phase M's prefill (B 4 x S 512 tokens at top-2: 4,096 rows, the layer's
# block 512). The case's index seeds its inputs.
GMM_CASES = [
    ("slice_gate_up", "router", GMM_ROWS, 128, 768, 2048,
     (torch.bfloat16, torch.float32)),
    ("slice_down", "router", GMM_ROWS, 128, 2048, 768,
     (torch.bfloat16, torch.float32)),
    ("mixtral_gate_up_balanced", "balanced", GMM_ROWS, 128, 4096, 14336,
     (torch.bfloat16,)),
    ("mixtral_down_balanced", "balanced", GMM_ROWS, 128, 14336, 4096,
     (torch.bfloat16,)),
    ("mixtral_gate_up_skewed", "skewed", GMM_ROWS, 128, 4096, 14336,
     (torch.bfloat16,)),
    ("mixtral_down_skewed", "skewed", GMM_ROWS, 128, 14336, 4096,
     (torch.bfloat16,)),
    ("prefill_gate_up", "router", 4096, 512, 768, 2048, (torch.bfloat16,)),
    ("prefill_down", "router", 4096, 512, 2048, 768, (torch.bfloat16,)),
    ("slice_gate_up_balanced", "balanced", GMM_ROWS, 128, 768, 2048,
     (torch.float32,)),
    ("slice_gate_up_skewed", "skewed", GMM_ROWS, 128, 768, 2048,
     (torch.float32,)),
    ("slice_gate_up_one_expert", "one_expert", GMM_ROWS, 128, 768, 2048,
     (torch.float32,)),
]


def _gmm_sizes(kind: str, rows: int) -> list[int]:
    """Rows of each expert, ``rows`` in all: from a seeded top-2 router
    over rows / 2 tokens, even, skewed (one expert 40 %, one empty), or
    all in one expert."""
    if kind == "router":
        logits = np.random.default_rng(5).standard_normal((rows // 2, GMM_E))
        top2 = np.argsort(-logits, axis=1)[:, :2]
        return np.bincount(top2.ravel(), minlength=GMM_E).tolist()
    if kind == "balanced":
        return [rows // GMM_E] * GMM_E
    if kind == "one_expert":
        return [rows] + [0] * (GMM_E - 1)
    big = int(0.4 * rows)
    rest = rows - big
    sizes = [big, 0] + [rest // 6] * 6
    sizes[2] += rest - sum(sizes[2:])
    return sizes


def _gmm_inputs(dev, dtype, sizes, block_m, k, n, seed):
    """The layout, lhs [M_pad, K], rhs [E, K, N] and an output gradient
    [M_pad, N]; rows that hold no token are 0 in lhs and in the gradient,
    as in the MoE layer."""
    from k8s_distributed_deeplearning_torch.ops import gmm as gmm_ops

    lay = gmm_ops.grouped_layout(
        torch.tensor(sizes, dtype=torch.int32, device=dev), sum(sizes),
        block_m=block_m)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    live = gmm_ops.live_rows(lay)[:, None]
    lhs = (torch.randn(lay.m_pad, k, generator=gen, device=dev)
           * live).to(dtype)
    rhs = (torch.randn(GMM_E, k, n, generator=gen, device=dev)
           * k ** -0.5).to(dtype)
    dout = (torch.randn(lay.m_pad, n, generator=gen, device=dev)
            * live).to(dtype)
    return lay, lhs, rhs, dout


def _grouped_mm_fns(lay, lhs, rhs, dout) -> dict:
    """``torch._grouped_mm`` over the layout's spans for each function, a
    yardstick the port never calls: name -> (fn, None), or (None, reason)
    where this torch refuses every operand layout tried."""
    gm = getattr(torch, "_grouped_mm", None)
    names = ("gmm", "gmm_dlhs", "tgmm")
    if gm is None:
        return {k: (None, "this torch has no torch._grouped_mm")
                for k in names}
    spans = ((lay.group_sizes + lay.block_m - 1) // lay.block_m).clamp_min(
        1) * lay.block_m
    offs = (lay.row_offset + spans).to(torch.int32)
    col = rhs.transpose(1, 2)                  # [E, N, K] view of rhs
    options = {
        "gmm": [(lhs, rhs), (lhs, col.contiguous().transpose(1, 2))],
        "gmm_dlhs": [(dout, col), (dout, col.contiguous())],
        "tgmm": [(lhs.t(), dout), (lhs.t().contiguous(), dout),
                 (lhs.t().contiguous(), dout.t().contiguous().t())]}
    out = {}
    for name in names:
        reasons = []
        for a, b in options[name]:
            try:
                gm(a, b, offs=offs)
                torch.cuda.synchronize()
            except (RuntimeError, TypeError, ValueError) as exc:
                reasons.append(f"{type(exc).__name__}: {str(exc)[:200]}")
                continue
            out[name] = ((lambda a=a, b=b: gm(a, b, offs=offs)), None)
            break
        else:
            out[name] = (None, " | ".join(reasons))
    return out


def _gmm_bound(flops, nbytes, dtype, route=None):
    """Least time on an H100 SXM: the larger of the FLOPs over the dtype's
    peak (on the tf32x3 route: the three TF32 products it issues for each
    over the TF32 peak) and the bytes (each input read once, each output
    written once) over 3.35 TB/s."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = (3 * flops / PEAK_TF32 if route == "tf32x3"
               else flops / PEAK_FLOPS[dtype]) * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations")


def phase_g(dev, flush):
    """The grouped-matmul kernels against their plain versions, case by
    case; every function on the mma route and on its dtype's own (bf16:
    wgmma; f32: tf32x3) on the same inputs, the latter launched twice for
    bitwise equality; every kernel and the yardstick timed on the device
    alone."""
    from k8s_distributed_deeplearning_torch.ops import gmm as gmm_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = {name: [] for name in GMM_KERNELS}
    for ci, (case, kind, n_rows, block_m, k, n, dtypes) in enumerate(
            GMM_CASES):
        sizes = _gmm_sizes(kind, n_rows)
        for dtype in dtypes:
            dname = str(dtype).split(".")[-1]
            tol = GMM_TOL[dtype]
            lay, lhs, rhs, dout = _gmm_inputs(dev, dtype, sizes, block_m, k,
                                              n, ci)
            # Elements each function must read: the rows that hold a token
            # (not the padding of their blocks, nor the dead blocks that
            # m_pad reserves) and the weights of the experts that have one.
            weights = sum(s > 0 for s in sizes) * k * n
            fns = {
                "gmm": (lambda route: gmm_ops.gmm_forward(
                            lhs, rhs, lay, route=route),
                        lambda: gmm_ops.gmm_reference(lhs, rhs, lay),
                        n_rows * k + weights, (lay.m_pad, n)),
                "gmm_dlhs": (
                    lambda route: gmm_ops.gmm_forward(
                        dout, rhs, lay, transpose_rhs=True, route=route),
                    lambda: gmm_ops.gmm_reference(dout, rhs, lay,
                                                  transpose_rhs=True),
                    n_rows * n + weights, (lay.m_pad, k)),
                "tgmm": (lambda route: gmm_ops.tgmm(lhs, dout, GMM_E, lay,
                                                    route=route),
                         lambda: gmm_ops.tgmm_reference(lhs, dout, GMM_E,
                                                        lay),
                         n_rows * (k + n), (GMM_E, k, n))}
            extra = gmm_ops._gmm_route(dtype)      # bf16 wgmma, f32 tf32x3
            library = _grouped_mm_fns(lay, lhs, rhs, dout)
            dead = ~gmm_ops.live_rows(lay)
            for fn_name, (kern, plain, reads, out_shape) in fns.items():
                routes = ["mma"] + (
                    [extra] if gmm_ops._gmm_route(
                        dtype, "tgmm" if fn_name == "tgmm" else "gmm")
                    == extra else [])
                want = plain()
                ref = want.float()
                rms = float(ref.square().mean().sqrt())
                lib_fn, lib_reason = library[fn_name]
                lib_err = None
                if lib_fn is not None:
                    lib_out = lib_fn().float()
                    lib_err = float(((lib_out - ref).abs() if fn_name == "tgmm"
                                     else (lib_out - ref)[~dead].abs()).max())
                    del lib_out
                nbytes = (reads + math.prod(out_shape)) * lhs.element_size()
                bound = _gmm_bound(2 * n_rows * k * n, nbytes, dtype)[0]
                plain_ms = time_ms(plain, flush, 5)
                library_ms = (time_ms(lib_fn, flush, host_ahead=True)
                              if lib_fn is not None else None)
                for route in routes:
                    what = f"{fn_name} {case}/{dname} ({route} route)"
                    got = kern(route)
                    torch.cuda.synchronize()
                    check(tuple(got.shape) == out_shape
                          and got.dtype == dtype,
                          f"{what}: {got.dtype} {tuple(got.shape)}")
                    check(bool(torch.isfinite(got).all()),
                          f"{what}: non-finite output")
                    err = (got.float() - ref).abs()
                    share = float((err / (tol[0] * rms + tol[1]
                                          * ref.abs())).max())
                    # tgmm_kernel, forced, chains all of an expert's rows
                    # into one f32 accumulator on the CUDA cores: at the
                    # f32 layouts of 6,553 and 16,384 rows an expert that
                    # drifts past the limit (2.85x at 16,384 on an
                    # H100), so its error there is a reading; every
                    # other route and case is gated.
                    reading = (route == "mma" and fn_name == "tgmm"
                               and dtype == torch.float32
                               and kind in ("skewed", "one_expert"))
                    check(share <= 1.0 or reading,
                          f"{what}: |kernel - plain| uses {share} of the "
                          f"limit {tol[0]} x rms + {tol[1]} x |plain|")
                    if fn_name == "tgmm":
                        empty = [e for e, s in enumerate(sizes) if s == 0]
                        zeros = all(bool((got[e] == 0).all())
                                    for e in empty)
                        check(zeros, f"{what}: an empty expert's gradient "
                              "is not 0")
                    else:
                        zeros = bool((got[dead] == 0).all())
                        check(zeros, f"{what}: rows that hold no token are "
                              "not 0")
                    same = None
                    if route != "mma":       # two launches, the same bits
                        same = torch.equal(got, kern(route))
                        check(same, f"{what}: two launches differ")
                    route_bound = _gmm_bound(2 * n_rows * k * n, nbytes,
                                             dtype, route)
                    row = {"fn": fn_name, "case": case, "dtype": dname,
                           "route": route,
                           "shape": {"E": GMM_E, "rows": n_rows,
                                     "m_pad": lay.m_pad, "K": k, "N": n,
                                     "block_m": lay.block_m,
                                     "sizes": sizes},
                           "max_abs_err": float(err.max()),
                           "err_over_rms": float(err.max()) / rms,
                           "tol_share": share, "gated": not reading,
                           "tol": {"atol_rms": tol[0], "rtol": tol[1]},
                           "zeros_exact": zeros, "bitwise_repeat": same,
                           "ms": time_ms(lambda: kern(route), flush,
                                         host_ahead=True),
                           "plain_ms": plain_ms, "library_ms": library_ms,
                           "library_max_abs_err": lib_err,
                           "bound_ms": route_bound[0],
                           "bound_by": route_bound[1]}
                    if route == "tf32x3":    # gmm_kernel's f32-core bound
                        row["bound_ms_f32_cores"] = bound
                    if lib_reason is not None:
                        row["library_null_reason"] = lib_reason
                    del got, err
                    kernel = ("tgmm" if fn_name == "tgmm" else "gmm") + (
                        "" if route == "mma" else f"_{route}")
                    rows[kernel].append(row)
                    log({"phase": "G", "kernel": kernel, **row})
                del want, ref
            del lay, lhs, rhs, dout, fns, library, dead
            gc.collect()
            torch.cuda.empty_cache()
    return rows


def _gmm_entries(rows, h_result, i_result, m_result):
    """Kernel-line entries of the grouped-matmul kernels: the
    representative case is the MoE slice's gate/up product, in bf16 (in
    f32 for the tf32x3 lines, which take f32 alone). The launches are
    phase H's (the bf16 step: the wgmma kernels) and phase M's bf16
    generate (its prefill); for the tf32x3 kernels and those of gmm.cu,
    phase I's kernel path and phase M's ragged generate, both f32, by
    route: gmm.cu's kernels run on no path since f32 gmm and tgmm took
    the tf32x3 route (0, the forced comparison of phase G alone)."""
    out = []
    for name, cases in rows.items():
        rep_dtype = "float32" if name.endswith("_tf32x3") else "bfloat16"
        rep = next(c for c in cases if c["case"] == "slice_gate_up"
                   and c["dtype"] == rep_dtype
                   and c["fn"] in ("gmm", "tgmm"))
        source, wrapper = GMM_KERNELS[name]
        if name.endswith("_wgmma"):
            by_phase = {"H": h_result["launches"].get(name, 0),
                        "M": m_result["generate_launches"].get(name, 0)}
        else:
            f32_paths = {"I (f32)": i_result["kernel_path_launches"],
                         "M (f32)": m_result["f32"]["launches"]["ragged"]}
            by_phase = {where: (counts.get(name, 0)
                                if name.endswith("_tf32x3") else
                                _mma_launches(counts, name)
                                if name in counts else 0)
                        for where, counts in f32_paths.items()}
        out.append({
            "name": name, "route": "cuda",
            "source": "k8s_distributed_deeplearning_torch/csrc/" + source,
            "replaces": GMM_REPLACES[wrapper],
            "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            **{k: rep[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
            **({"bound_ms_f32_cores": rep["bound_ms_f32_cores"]}
               if "bound_ms_f32_cores" in rep else {}),
            "cases": [{k: c.get(k) for k in (
                "case", "fn", "dtype", "max_abs_err", "tol_share", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")}
                for c in cases]})
    return out


# ------------------------------------------------------------- phase E/F


def _train_loss(model, chunked, moe_cfg):
    """The loss of ``model`` (an ``MoELM`` with ``moe_cfg``) for the
    data-parallel step."""
    from k8s_distributed_deeplearning_torch.models import llama, moe

    if moe_cfg is None:
        return lambda batch, gen: llama.loss_fn(model, batch, gen,
                                                chunked=chunked)
    return lambda batch, gen: moe.loss_fn(model, moe_cfg, batch, gen,
                                          chunked=chunked)


def _train_setup(cfg, dev, lr, chunked=True, moe_cfg=None, seed=0):
    """A ``LlamaLM`` (or ``MoELM`` with ``moe_cfg``) from ``seed``, AdamW
    with global-norm clip 1.0, its state and the data-parallel train
    step."""
    from k8s_distributed_deeplearning_torch.models import llama, moe
    from k8s_distributed_deeplearning_torch.parallel import (
        data_parallel as dp)
    from k8s_distributed_deeplearning_torch.train import optim

    if moe_cfg is None:
        model = llama.LlamaLM(cfg, device=dev, seed=seed)
    else:
        model = moe.MoELM(cfg, moe_cfg, device=dev, seed=seed)
    params = dict(model.named_parameters())
    optimizer = optim.make_optimizer("adamw", lr, grad_clip=1.0)
    return model, optimizer, dp.init_state(params, optimizer), \
        dp.make_train_step(_train_loss(model, chunked, moe_cfg), optimizer)


def _kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by its kernel-line name."""
    from k8s_distributed_deeplearning_torch.ops import flash_attn as fa
    from k8s_distributed_deeplearning_torch.ops import gmm as gmm_ops
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    return {"paged_decode_attention": paged_attn.paged_decode_attention,
            "flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
            "flash_bwd_dkv": fa.flash_bwd_dkv,
            "flash_bwd_delta": fa.flash_bwd_delta,
            "gmm": gmm_ops.gmm_forward, "tgmm": gmm_ops.tgmm}


def _zero_launches() -> None:
    for w in _kernel_wrappers().values():
        w.launches = 0
        for route in ROUTE_COUNTS:
            if hasattr(w, f"launches_{route}"):
                setattr(w, f"launches_{route}", 0)


def _launch_counts() -> dict:
    """Every wrapper's launches by its kernel-line name (all routes); the
    flash and grouped-matmul wrappers' wgmma-route launches, and the flash
    backward wrappers' tf32x3-route launches, under their own lines."""
    wrappers = _kernel_wrappers()
    out = {n: w.launches for n, w in wrappers.items()}
    for n, w in wrappers.items():
        for route in ROUTE_COUNTS:
            if hasattr(w, f"launches_{route}"):
                out[f"{n}_{route}"] = getattr(w, f"launches_{route}")
    return out


def _mma_launches(launches: dict, name: str) -> int:
    """Launches of a wrapper's mma route: its total less its other
    routes'."""
    return launches[name] - sum(launches.get(f"{name}_{r}", 0)
                                for r in ROUTE_COUNTS)


def _train_phase(phase, dev, info, cfg, *, batch_size, seq, lr, chunked,
                 flops_tok, per_step, moe_cfg=None):
    """Phases E and H: train ``cfg`` (an ``MoELM`` with ``moe_cfg``) through
    ``make_train_step`` and ``fit``. Eight steps on one fixed batch must
    bring the loss below the margin; then a timed window of steps, with
    every kernel's launch count set to 0 before it and held exactly to
    ``per_step`` (launches a step by kernel-line name, the flash
    wrappers' wgmma-route launches under their own) after it; then one
    profiled step."""
    from torch.profiler import ProfilerActivity, profile

    from k8s_distributed_deeplearning_torch.train import data as data_lib
    from k8s_distributed_deeplearning_torch.train import loop

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, optimizer, state, step_fn = _train_setup(
        cfg, dev, lr=lr, chunked=chunked, moe_cfg=moe_cfg)
    tokens = data_lib.synthetic_tokens(1 << 17, vocab_size=cfg.vocab_size,
                                       seed=0)
    batcher = data_lib.TokenBatcher(tokens, batch_size, seq, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state.params.values())

    fixed = batcher.batch_at(0)
    losses = []
    for i in range(8):
        state, loss, _ = step_fn(state, fixed, i)
        losses.append(float(loss))
    check(all(np.isfinite(losses)), f"non-finite loss on the fixed batch: "
          f"{losses}")
    check(losses[-1] < FIXED_BATCH_MARGIN * losses[0],
          f"8 steps on one fixed batch: loss {losses[0]} -> {losses[-1]}, "
          f"not below {FIXED_BATCH_MARGIN} x the first")
    log({"phase": phase, "case": "fixed_batch", "steps": 8, "lr": lr,
         "losses": losses, "margin": FIXED_BATCH_MARGIN})

    warm, timed = 2, 6
    state = loop.fit(step_fn, state, batcher.iter_from, state.step + warm,
                     rng=1, log_every=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    state = loop.fit(step_fn, state, batcher.iter_from, state.step + timed,
                     rng=1, log_every=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    want = {n: per_step.get(n, 0) * timed for n in launches}
    check(launches == want, f"kernel launches {launches} != {want} over "
          f"{timed} steps")
    step_ms = wall / timed * 1e3
    tok_s = timed * batch_size * seq / wall
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    # One more step: the host's time to enqueue it against its time to
    # finish; near equal means the host, not the card, sets the pace.
    t0 = time.perf_counter()
    state, loss, _ = step_fn(state, batcher.batch_at(state.step), state.step)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    host_step_ms = (time.perf_counter() - t0) * 1e3
    # The optimizer's share of the profiled step, between CUDA events.
    opt_events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    apply = optimizer.apply

    def timed_apply(*args):
        opt_events[0].record()
        out = apply(*args)
        opt_events[1].record()
        return out

    optimizer.apply = timed_apply
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, loss, _ = step_fn(state, batcher.batch_at(state.step),
                                 state.step)
        torch.cuda.synchronize()
    optimizer.apply = apply
    check(bool(torch.isfinite(loss)), "non-finite loss in the profiled step")
    kernels = _device_ms_by_kernel(prof, 1)
    device_ms = sum(k[2] for k in kernels)
    result = {
        "phase": phase, **info, "layers": cfg.n_layers,
        "params": n_params, "dtype": str(cfg.dtype).split(".")[-1],
        "param_dtype": "float32", "remat_policy": cfg.remat_policy,
        "chunked_ce": chunked, "batch": batch_size, "seq_len": seq,
        "world_size": 1, "backend": "nccl", "lr": lr, "setup_s": setup_s,
        "timed_steps": timed, "step_ms": step_ms, "tokens_per_s": tok_s,
        "flops_per_token": flops_tok,
        "model_flops_share": flops_tok * tok_s / PEAK_FLOPS[torch.bfloat16],
        "peak_memory_gb": peak_gb,
        "host_enqueue_ms": enqueue_ms, "host_step_ms": host_step_ms,
        "launches": {n: v for n, v in launches.items() if v},
        "launches_per_step": {n: v / timed for n, v in launches.items()
                              if v},
        "profiled_step": {
            "device_ms": device_ms,
            "device_busy_share": device_ms / step_ms,
            "kernel_launches": sum(k[1] for k in kernels),
            "device_ms_by_class": _by_class(kernels),
            "optimizer_ms": opt_events[0].elapsed_time(opt_events[1]),
            "top_kernels": [{"name": n[:90], "launches": c, "ms": ms}
                            for n, c, ms in kernels[:10]]}}
    log(result)
    del model, optimizer, state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return result


def phase_e(dev):
    from k8s_distributed_deeplearning_torch.models import llama

    cfg = llama.config_llama3_8b(n_layers=4, max_seq_len=2048,
                                 param_dtype=torch.float32)
    n = cfg.n_layers
    return _train_phase(
        "E", dev, {"model": "llama3-8b width"}, cfg, batch_size=4, seq=2048,
        lr=3e-4, chunked=True,
        flops_tok=llama.flops_per_token(cfg, seq_len=2048),
        per_step=_e_per_step(n))


def _e_per_step(n: int) -> dict:
    """Phase E's flash launches a step at ``n`` layers. Forward 2 x
    layers: remat "dots" recomputes the flash forward. bf16 at head_dim
    128 takes the wgmma route throughout, the bf16 backward's delta kernel
    included, once a layer."""
    return {"flash_fwd": 2 * n, "flash_fwd_wgmma": 2 * n,
            "flash_bwd_dq": n, "flash_bwd_dkv": n,
            "flash_bwd_dq_wgmma": n, "flash_bwd_dkv_wgmma": n,
            "flash_bwd_delta": n, "flash_bwd_delta_wgmma": n}


def _moe_slice(n_layers: int | None = None):
    """Phase H's model (the JAX package's ``moe_8e_top2_ragged`` row: the
    Llama-small backbone, 8 experts top-2 ragged, remat "dots", bf16
    compute, f32 params) at 1024 tokens a row, at ``n_layers`` (default:
    the backbone's 12), and its kernel launches a step by kernel-line
    name. Under remat "dots" the gmm outputs are saved, not recomputed: 3
    forward products and 3 input gradients a layer, 3 weight gradients,
    all bf16 on the wgmma route; the flash forward runs again in the
    recompute."""
    from k8s_distributed_deeplearning_torch.models import llama, moe

    seq = 1024
    depth = {} if n_layers is None else {"n_layers": n_layers}
    cfg = llama.config_tiny(**{**MOE_BACKBONE, **depth}, max_seq_len=seq,
                            dtype=torch.bfloat16, param_dtype=torch.float32,
                            remat=True, remat_policy="dots")
    mcfg = moe.MoEConfig(num_experts=8, top_k=2, dispatch="ragged")
    n = cfg.n_layers
    per_step = {"gmm": 6 * n, "tgmm": 3 * n, "gmm_wgmma": 6 * n,
                "tgmm_wgmma": 3 * n, "flash_fwd": 2 * n,
                "flash_fwd_wgmma": 2 * n,
                "flash_bwd_dq": n, "flash_bwd_dkv": n,
                "flash_bwd_dq_wgmma": n, "flash_bwd_dkv_wgmma": n,
                "flash_bwd_delta": n, "flash_bwd_delta_wgmma": n}
    return cfg, mcfg, seq, per_step


def phase_h(dev):
    from k8s_distributed_deeplearning_torch.models import moe

    cfg, mcfg, seq, per_step = _moe_slice()
    return _train_phase(
        "H", dev, {"model": "llama-small MoE 8e top-2 ragged",
                   "experts": mcfg.num_experts, "top_k": mcfg.top_k,
                   "dispatch": mcfg.dispatch,
                   "ragged_block_m": mcfg.ragged_block_m},
        cfg, batch_size=8, seq=seq, lr=1e-3, chunked=False,
        flops_tok=moe.flops_per_token(cfg, mcfg, seq_len=seq),
        per_step=per_step, moe_cfg=mcfg)


def _recorded_steps(optimizer, state, step_fn, batch_at, steps, keep_on):
    """``steps`` AdamW steps on ``batch_at(i)``. Returns the losses, and on
    ``keep_on`` the initial weights, the first step's gradients, and the
    parameters and Adam moments after the steps (phases F, I and V4)."""
    init = {n: p.detach().to(keep_on, copy=True)
            for n, p in state.params.items()}
    first_grads, apply = {}, optimizer.apply

    def keep_first(params, grads, opt_state):
        if not first_grads:
            first_grads.update({n: g.to(keep_on, copy=True)
                                for n, g in grads.items()})
        return apply(params, grads, opt_state)

    optimizer.apply = keep_first
    losses = []
    for i in range(steps):
        state, loss, _ = step_fn(state, batch_at(i), i)
        losses.append(float(loss))
    return {"losses": losses, "init": init, "grads": first_grads,
            "params": {n: p.detach().to(keep_on)
                       for n, p in state.params.items()},
            **{k: {n: t.to(keep_on) for n, t in state.opt_state[k].items()}
               for k in ("mu", "nu")}}


def _agreement_run(cfg, dev, lr, batcher, steps, keep_on, moe_cfg=None):
    """One path of phases F and I: ``steps`` AdamW steps in f32 from the
    seeded weights (:func:`_recorded_steps`)."""
    _, optimizer, state, step_fn = _train_setup(cfg, dev, lr=lr,
                                                moe_cfg=moe_cfg)
    return _recorded_steps(optimizer, state, step_fn, batcher.batch_at,
                           steps, keep_on)


def _check_f32_flash(phase, launches, backward) -> None:
    """An f32 training path's flash launches: the forward on the tf32x3
    route alone (at least once a backward), the backward ``backward``
    times on the tf32x3 route alone; none on the mma, wgmma or small
    routes."""
    check(launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == backward
          and launches["flash_bwd_dq_tf32x3"] == backward
          and launches["flash_bwd_dkv_tf32x3"] == backward
          and launches["flash_fwd"] == launches["flash_fwd_tf32x3"]
          >= backward,
          f"phase {phase} (f32) flash launches {launches}: want {backward} "
          f"of each backward and at least as many forward, all on the "
          f"tf32x3 route and none on the others")


def phase_f(dev):
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.train import data as data_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lr, steps, batch_size, seq = 1e-4, 3, 2, 1024
    tokens = data_lib.synthetic_tokens(1 << 15, vocab_size=128256, seed=3)
    batcher = data_lib.TokenBatcher(tokens, batch_size, seq, seed=3)

    def run(impl, keep_on):
        cfg = llama.config_llama3_8b(n_layers=2, max_seq_len=seq,
                                     dtype=torch.float32,
                                     param_dtype=torch.float32,
                                     attention_impl=impl)
        return _agreement_run(cfg, dev, lr, batcher, steps, keep_on)

    # The kernel path's record waits in host memory while the plain path
    # runs: two runs' weights, gradients and moments do not fit the card.
    _zero_launches()
    ka = run("auto", torch.device("cpu"))
    launches = _launch_counts()
    _check_f32_flash("F", launches, 2 * steps)
    gc.collect()
    torch.cuda.empty_cache()
    kx = run("xla", dev)
    return _agreement("F", {"model": "llama3-8b width, 2 layers",
                            "batch": batch_size, "seq_len": seq,
                            "steps": steps, "lr": lr,
                            "kernel_path_launches": {
                                n: c for n, c in launches.items() if c}},
                      ka, kx, dev)


def phase_f_bf16(dev):
    """Phase F's model and first batch in bf16 compute (f32 params): one
    step's gradients through the flash kernels on the wgmma route and on
    the mma route (forced for dQ and dK/dV; delta on its wgmma kernel in
    both), each held per parameter tensor to the f32 plain path's
    (``attention_impl="xla"``), from the same weights."""
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.ops import flash_attn as fa
    from k8s_distributed_deeplearning_torch.parallel import (
        data_parallel as dp)
    from k8s_distributed_deeplearning_torch.train import data as data_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch_size, seq = 2, 1024
    tokens = data_lib.synthetic_tokens(1 << 15, vocab_size=128256, seed=3)
    batch = data_lib.TokenBatcher(tokens, batch_size, seq, seed=3).batch_at(0)

    def model_of(dtype, impl):
        cfg = llama.config_llama3_8b(n_layers=2, max_seq_len=seq,
                                     dtype=dtype, param_dtype=torch.float32,
                                     attention_impl=impl)
        return llama.LlamaLM(cfg, device=dev, seed=0)

    def grads(model):
        params = dict(model.named_parameters())
        loss, _ = llama.loss_fn(model, dp.to_device(batch, dev), chunked=True)
        return float(loss.detach()), dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))

    plain = model_of(torch.float32, "xla")
    loss_ref, ref = grads(plain)
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    model = model_of(torch.bfloat16, "auto")
    errs, losses, launches = {}, {}, {}
    route_of = fa._bwd_route
    try:
        for route in ("wgmma", "mma"):
            fa._bwd_route = lambda dtype, head_dim, which, r=route: r
            _zero_launches()
            losses[route], g = grads(model)
            launches[route] = {n: c for n, c in _launch_counts().items() if c}
            errs[route] = {n: float((g[n] - ref[n]).double().norm()
                                    / ref[n].double().norm()) for n in ref}
            del g
    finally:
        fa._bwd_route = route_of
    worst = {n: errs["wgmma"][n] / (BF16_STEP_RATIO * errs["mma"][n]
                                    + BF16_STEP_FLOOR) for n in ref}
    result = {"phase": "F", "case": "bf16_step_routes",
              "model": "llama3-8b width, 2 layers", "batch": batch_size,
              "seq_len": seq, "loss_f32_plain": loss_ref,
              "loss_bf16": losses, "launches": launches,
              "grad_rel_l2_vs_f32_plain": errs,
              "ratio": BF16_STEP_RATIO, "floor": BF16_STEP_FLOOR,
              "worst_share": max(worst.values()),
              "worst_param": max(worst, key=worst.get)}
    log(result)
    del model, ref
    gc.collect()
    torch.cuda.empty_cache()
    check(launches["wgmma"].get("flash_bwd_dq_wgmma") == 2
          and launches["wgmma"].get("flash_bwd_dkv_wgmma") == 2
          and "flash_bwd_dq_wgmma" not in launches["mma"]
          and launches["mma"].get("flash_bwd_dq") == 2
          and all(launches[r].get("flash_bwd_delta_wgmma") == 2
                  for r in launches),
          f"bf16 step launches by route: {launches}")
    name = result["worst_param"]
    check(max(worst.values()) <= 1.0,
          f"bf16 step: {name}'s gradient on the wgmma route is further from "
          f"the f32 plain path than {BF16_STEP_RATIO} x the mma route's + "
          f"{BF16_STEP_FLOOR}: {errs['wgmma'][name]} against "
          f"{errs['mma'][name]}")
    return result


def phase_i(dev):
    from k8s_distributed_deeplearning_torch.models import llama, moe
    from k8s_distributed_deeplearning_torch.train import data as data_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lr, steps, batch_size, seq = 1e-4, 3, 2, 1024
    tokens = data_lib.synthetic_tokens(
        1 << 15, vocab_size=MOE_BACKBONE["vocab_size"], seed=4)
    batcher = data_lib.TokenBatcher(tokens, batch_size, seq, seed=4)
    ragged = moe.MoEConfig(num_experts=8, top_k=2, dispatch="ragged")
    # capacity_factor E / k makes the capacity every token (clamped to T):
    # the index path then drops nothing and routes as the ragged one.
    index = moe.MoEConfig(num_experts=8, top_k=2, dispatch="index",
                          capacity_factor=8 / 2)

    def run(impl, mcfg, keep_on):
        cfg = llama.config_tiny(**{**MOE_BACKBONE, "n_layers": 2},
                                max_seq_len=seq, dtype=torch.float32,
                                param_dtype=torch.float32, remat=True,
                                attention_impl=impl)
        _zero_launches()
        out = _agreement_run(cfg, dev, lr, batcher, steps, keep_on,
                             moe_cfg=mcfg)
        return out, _launch_counts()

    ka, kernel_launches = run("auto", ragged, torch.device("cpu"))
    gc.collect()
    torch.cuda.empty_cache()
    kx, plain_launches = run("xla", index, dev)
    # A layer's three expert products, forward and dlhs, each step; their
    # weight gradients on tgmm_tf32x3; gmm.cu's kernels never.
    want = 2 * 3 * 2 * steps
    check(kernel_launches["gmm"] == kernel_launches["gmm_tf32x3"] == want
          and kernel_launches["tgmm"] == kernel_launches["tgmm_tf32x3"]
          == want // 2
          and _mma_launches(kernel_launches, "tgmm") == 0
          and kernel_launches["gmm_wgmma"] == 0
          and kernel_launches["tgmm_wgmma"] == 0,
          f"phase I kernel path (f32: gmm on tf32x3, {want}; tgmm on "
          f"tf32x3, {want // 2}; mma 0) launched {kernel_launches}")
    _check_f32_flash("I", kernel_launches, 2 * steps)
    check(not any(plain_launches.values()),
          f"phase I plain path launched kernels: {plain_launches}")
    return _agreement("I", {"model": "llama-small MoE width, 2 layers",
                            "kernel_path": "ragged + flash",
                            "plain_path": "index at capacity T + einsum",
                            "kernel_path_launches": kernel_launches,
                            "batch": batch_size, "seq_len": seq,
                            "steps": steps, "lr": lr}, ka, kx, dev)


# ------------------------------------------------------------- phase Q

Q_STEPS = 8


def phase_q(dev):
    """The train CLI's tiny preset at 1,024 tokens (``--preset tiny
    --seq-len 1024``: dim 64, 4/2 heads, head_dim 16; the length at which
    ``attention_impl="auto"`` takes the flash kernels) in bf16 and in f32
    (the CLI's default dtype) through
    ``make_train_step``: 8 AdamW steps on one fixed batch bring the loss
    below phase E's margin; each flash backward kernel launches once a
    layer a step on its route (bf16 at head_dim 16: small; f32: tf32x3) and
    on no other, the forward at least as often on the same route and on no
    other, bf16's delta kernel once a layer a step on the small route;
    then, at the path's attention shape, the backward kernels of
    those routes against the plain version within phase D's limit."""
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.ops import flash_attn as fa
    from k8s_distributed_deeplearning_torch.train import cli
    from k8s_distributed_deeplearning_torch.train import data as data_lib

    batch_size, seq = 8, 1024
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        cfg = llama.config_tiny(**{**cli.PRESETS["tiny"], "dtype": dtype,
                                   "param_dtype": torch.float32,
                                   "max_seq_len": seq})
        hd = cfg.resolved_head_dim
        _, _, state, step_fn = _train_setup(cfg, dev, lr=1e-3)
        tokens = data_lib.synthetic_tokens(1 << 16,
                                           vocab_size=cfg.vocab_size, seed=5)
        fixed = data_lib.TokenBatcher(tokens, batch_size, seq,
                                      seed=5).batch_at(0)
        _zero_launches()
        losses = []
        for i in range(Q_STEPS):
            state, loss, _ = step_fn(state, fixed, i)
            losses.append(float(loss))
        torch.cuda.synchronize()
        launches = _launch_counts()
        del state, step_fn
        route = {"flash_fwd": fa._fwd_route(dtype, hd),
                 "flash_bwd_dq": fa._bwd_route(dtype, hd, "dq"),
                 "flash_bwd_dkv": fa._bwd_route(dtype, hd, "dkv")}
        n = cfg.n_layers * Q_STEPS
        on_route = {w: (_mma_launches(launches, w) if r == "mma"
                        else launches[f"{w}_{r}"]) for w, r in route.items()}
        check(all(np.isfinite(losses))
              and losses[-1] < FIXED_BATCH_MARGIN * losses[0],
              f"tiny preset, {dname}: 8 steps on one fixed batch, loss "
              f"{losses[0]} -> {losses[-1]}")
        check(on_route["flash_bwd_dq"] == on_route["flash_bwd_dkv"] == n
              and launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == n
              and on_route["flash_fwd"] == launches["flash_fwd"] >= n,
              f"tiny preset, {dname}: flash launches {launches}, want {n} "
              f"of each backward and at least {n} forward, each on its "
              f"route {route} alone")
        # bf16's delta kernel once a layer a step, on the small route (head
        # dim 16); f32 computes rowsum(dO * O) in PyTorch.
        want_delta = n if dtype == torch.bfloat16 else 0
        delta_route = fa._delta_route(hd)
        check(launches["flash_bwd_delta"] == want_delta
              and launches[f"flash_bwd_delta_{delta_route}"] == want_delta,
              f"tiny preset, {dname}: delta launches {launches}, want "
              f"{want_delta} on the {delta_route} route alone")
        if dtype == torch.bfloat16:
            route["flash_bwd_delta"] = delta_route
        shape = (batch_size, seq, seq, cfg.n_heads, cfg.n_kv_heads, hd, True,
                 None)
        q, k, v, do, segq, segk = _flash_case(dev, dtype, shape, 7)
        o, lse = fa.flash_attention_reference(q, k, v, causal=True)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta, segq, segk, True, hd ** -0.5)
        want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                causal=True, delta=delta)
        dq = fa.flash_bwd_dq(*args)
        dk, dv = fa.flash_bwd_dkv(*args)
        torch.cuda.synchronize()
        err = _flash_err({"dq": (dq, want[0]), "dk": (dk, want[1]),
                          "dv": (dv, want[2])}, FLASH_TOL[dtype])
        check(err["tol_share"] <= 1.0,
              f"tiny preset's attention, {dname}, backward on {route}: "
              f"{err}")
        out[dname] = {"route": route, "losses": losses,
                      "launches": {k_: c for k_, c in launches.items() if c},
                      "backward_vs_plain": err}
        del q, k, v, do, o, lse, delta, args, want, dq, dk, dv
        gc.collect()
        torch.cuda.empty_cache()
    result = {"phase": "Q", "model": "train --preset tiny --seq-len 1024",
              "batch": batch_size, "seq_len": seq, "steps": Q_STEPS,
              "layers": cfg.n_layers, "head_dim": hd, **out}
    log(result)
    return result


# ------------------------------------------------------------- phase T

T_STEPS = 12               # T1 and T2: steps through fit
T_LOG_EVERY = 4
T_PROFILE = (4, 3)         # T1's StepProfiler: start step, steps traced
# T2: rank 1's data_wait stall at steps 3 and 4. Step 4 also holds a save
# of the small preset's state (1.5 GB at 12 layers, 0.75 GB at T2's 2:
# snapshot, write, MD5), whose time differed between the two ranks' runs
# by up to 0.92 s at 12 layers (80-922 ms in three runs on the card): a
# stall must exceed that to be the step's culprit.
T_STALL_S = 2.0
T_STRAGGLER_MS = 50.0      # T2: a straggler lags the median by more
T_CKPT_EVERY = 4           # T2: saves at 4, 8 and 12
T_HB_STOP = 10             # T2: rank 1's heartbeat silent from step 10
T_CLI_STEPS = 16           # T4: the CLI's profile window is steps 10-14
T2_LAYERS = 2              # T2: the small preset at 2 of its 12 layers
T_SERVE_NEW = 16           # T3: new tokens a request


def _graftscope(*argv) -> tuple[int, str, str]:
    """The port's graftscope CLI in a fresh interpreter, as it runs over
    copied logs (it imports no torch)."""
    proc = subprocess.run(
        [sys.executable, "-m",
         "k8s_distributed_deeplearning_torch.telemetry.graftscope",
         *map(str, argv)], capture_output=True, text=True, timeout=300,
        cwd=REPO)
    return proc.returncode, proc.stdout, proc.stderr


def _trace_kernels(path: Path) -> dict:
    """Kernel launches by class (``_kernel_class``) in a Chrome trace
    written by ``utils/profiling.py``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out: dict[str, int] = {}
    for e in events:
        if e.get("cat") == "kernel":
            cls = _kernel_class(e.get("name", ""))
            out[cls] = out.get(cls, 0) + 1
    return out


def _t_shards(tmp: Path) -> Path:
    """The byte-level corpus of the repo as uint16 token shards."""
    from k8s_distributed_deeplearning_torch.train import data as data_lib

    tokens = data_lib.load_tokens(str(REPO / "data" / "corpus"
                                      / "pydocs.txt.gz"))
    out = tmp / "shards"
    data_lib.write_token_shards(tokens, str(out), shard_tokens=1 << 18,
                                dtype="uint16")
    return out


def _events(path: Path, event: str) -> list[dict]:
    with open(path) as f:
        return [r for r in map(json.loads, f) if r.get("event") == event]


def _record_fires(inj, calls: list) -> None:
    """Record every ``fire(site, step=)`` call of the injector ``inj``."""
    fire = inj.fire

    def recorded(site, *, step=None, path=None):
        calls.append((site, step))
        return fire(site, step=step, path=path)

    inj.fire = recorded


def _t1(dev, tmp: Path, shards: Path, e_result: dict):
    """T1: E's configuration through ``fit`` with every hook on. Returns
    the log line, the trained model and the calibration dump's path."""
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.telemetry import bridge
    from k8s_distributed_deeplearning_torch.telemetry import timeline
    from k8s_distributed_deeplearning_torch.telemetry.heartbeat import (
        HeartbeatWriter, read_heartbeats)
    from k8s_distributed_deeplearning_torch.telemetry.registry import (
        MetricsRegistry)
    from k8s_distributed_deeplearning_torch.telemetry.trace import Tracer
    from k8s_distributed_deeplearning_torch.train import data as data_lib
    from k8s_distributed_deeplearning_torch.train import loop
    from k8s_distributed_deeplearning_torch.utils.metrics import (
        MetricsLogger)
    from k8s_distributed_deeplearning_torch.utils.profiling import (
        StepProfiler)

    cfg = llama.config_llama3_8b(n_layers=4, max_seq_len=2048,
                                 param_dtype=torch.float32)
    n = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, optimizer, state, step_fn = _train_setup(cfg, dev, lr=3e-4)
    batcher = data_lib.TokenShardBatcher(str(shards), 4, 2048, seed=0,
                                         vocab_size=cfg.vocab_size)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log_path, hb_dir = tmp / "t1.jsonl", tmp / "t1_hb"
    prof_dir, calib = tmp / "t1_prof", tmp / "t1_calib.json"
    registry = MetricsRegistry()
    profiler = StepProfiler(str(prof_dir), start_step=T_PROFILE[0],
                            num_steps=T_PROFILE[1])
    hook_ms = {}
    hook = profiler.step_hook

    def timed_hook(step):
        t = time.perf_counter()
        hook(step)
        hook_ms[step] = (time.perf_counter() - t) * 1e3

    profiler.step_hook = timed_hook
    losses = []

    def recording(state, batch, seed):
        state, loss, aux = step_fn(state, batch, seed)
        losses.append(loss.detach())
        return state, loss, aux

    _zero_launches()
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        metrics = MetricsLogger(stream=f, job="train")
        state = loop.fit(
            recording, state, batcher.iter_from, T_STEPS, rng=1,
            metrics=metrics, log_every=T_LOG_EVERY, global_batch_size=4,
            tracer=Tracer(metrics, rank=0),
            heartbeat=HeartbeatWriter(str(hb_dir), 0),
            telemetry=bridge.TrainTelemetry(registry), profiler=profiler,
            quant_calib=str(calib), model=model)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    want = {k: v * T_STEPS for k, v in _e_per_step(n).items()}
    want = {k: want.get(k, 0) for k in launches}
    check(launches == want, f"T1 launches {launches} != {want} over "
          f"{T_STEPS} steps (E's a step)")
    loss_f = [float(x) for x in losses]
    check(len(loss_f) == T_STEPS and all(np.isfinite(loss_f)),
          f"T1 losses {loss_f}")
    traced = _trace_kernels(prof_dir / "trace.json")
    check(all(traced.get(k, 0) > 0 for k in
              ("flash_fwd_wgmma", "flash_dq_wgmma", "flash_dkv_wgmma",
               "flash_delta_wgmma")),
          f"T1 profiler trace kernels {traced}: want the four wgmma "
          "flash kernels")
    found = re.search(r"^train_steps_total (\S+)$", registry.render(), re.M)
    check(found is not None and float(found.group(1)) == T_STEPS,
          f"T1 train_steps_total renders {found and found.group(1)}")
    beats = read_heartbeats(str(hb_dir))
    check([(b["rank"], b["step"]) for b in beats] == [(0, T_STEPS)],
          f"T1 heartbeat files {beats}")
    parsed = timeline.parse_files([str(log_path)])
    tl = timeline.build_step_timelines(parsed)
    check(sorted(tl) == list(range(T_STEPS))
          and all({"data_wait", "step"} <= set(tl[s][0].components)
                  for s in tl), f"T1 step records {sorted(tl)}")
    rc, out, err = _graftscope("steps", log_path, "--json")
    check(rc == 0, f"T1 graftscope steps: rc {rc} {err[-2000:]}")
    steps_json = json.loads(out)
    check(steps_json["steps"] == T_STEPS and steps_json["ranks"] == [0],
          f"T1 graftscope steps --json: {steps_json}")
    path = steps_json["critical_path_ms"]
    total = sum(path.values()) or 1.0
    train_steps = _events(log_path, "train_step")
    result = {
        "phase": "T1", "model": "llama3-8b width", "layers": n,
        "batch": 4, "seq_len": 2048, "steps": T_STEPS, "setup_s": setup_s,
        "data": "sharded-streaming", "num_windows": batcher.num_windows,
        "wall_s": wall, "launches": {k: v for k, v in launches.items() if v},
        "losses_at_log_steps": {e["step"]: e["loss"] for e in train_steps},
        "step_ms_by_log_window": {e["step"]: e["step_time_ms"]
                                  for e in train_steps},
        "step_ms_after_profiler": train_steps[-1]["step_time_ms"],
        "e_step_ms": e_result["step_ms"],
        "hooks_cost_share": (train_steps[-1]["step_time_ms"]
                             / e_result["step_ms"] - 1.0),
        "critical_path_ms": path,
        "critical_path_share": {k: v / total for k, v in path.items()},
        "step_wall_ms": {s: tl[s][0].wall_ms for s in sorted(tl)},
        "data_wait_ms": {s: tl[s][0].components["data_wait"]
                         for s in sorted(tl)},
        "profiled_steps_wall_ms": {s: tl[s][0].wall_ms for s in range(
            T_PROFILE[0], T_PROFILE[0] + T_PROFILE[1])},
        "profiler_start_ms": hook_ms.get(T_PROFILE[0]),
        "profiler_stop_ms": hook_ms.get(sum(T_PROFILE)),
        "profiler_trace_kernels": {k: v for k, v in traced.items()
                                   if k.startswith("flash")},
        "profiler_trace_mb": (prof_dir / "trace.json").stat().st_size / 2**20,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(result)
    del optimizer, state, step_fn, losses
    gc.collect()
    torch.cuda.empty_cache()
    return result, model, calib


def _t3(dev, model, calib_path: Path) -> dict:
    """T3: T1's model quantized with its own calibration dump (and a copy
    without it) serving with int8 weights and int8 KV pages."""
    import copy

    from k8s_distributed_deeplearning_torch.ops import paged_attn
    from k8s_distributed_deeplearning_torch.serve import (Request,
                                                          ServeEngine)
    from k8s_distributed_deeplearning_torch.serve import quant

    cfg = model.cfg
    calib = quant.load_calibration(str(calib_path))
    names = {quant.jax_path_name(name) for name, _ in
             quant._quantizable(model)}
    check(set(calib["weights"]) == names and len(names) == 7,
          f"T3 dump keys {sorted(calib['weights'])} != {sorted(names)}")
    raw = quant.calibration_absmax(model)
    channels = sum(len(v) for v in raw.values())
    clipped = sum(int(c < r) for k in raw
                  for c, r in zip(calib["weights"][k], raw[k]))
    plain = copy.deepcopy(model)
    with torch.no_grad():
        quant.quantize_model(model, calibration=calib)
        quant.quantize_model(plain)
    scales_equal = all(
        torch.equal(a.weight_scale, b.weight_scale)
        for (_, a), (_, b) in zip(quant._quantizable(model),
                                  quant._quantizable(plain)))
    rng = np.random.default_rng(11)
    reqs = [(f"q{i}", rng.integers(0, cfg.vocab_size, int(n)).astype(
        np.int32)) for i, n in enumerate((200, 600, 1100, 1500))]
    attn = paged_attn.paged_decode_attention
    streams, result = {}, {"phase": "T3", "model": "T1's, int8"}
    for label, m in (("calibrated", model), ("uncalibrated", plain)):
        eng = ServeEngine(m, num_slots=4, prefill_chunk_tokens=512,
                          device=dev, kv_quant="int8", weight_quant="int8")
        _zero_counts(attn)
        t0 = time.perf_counter()
        outs = eng.run([Request(prompt=p, max_new_tokens=T_SERVE_NEW,
                                request_id=rid) for rid, p in reqs])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        summ = eng.stats.summary()
        chunks = sum(o.prefill_chunks for o in outs)
        routes = {"decode": attn.launches_decode_int8,
                  "prefill": attn.launches_prefill_int8,
                  "split": (attn.launches_int8 - attn.launches_prefill_int8
                            - attn.launches_decode_int8),
                  "fp": attn.launches}
        want = {"decode": cfg.n_layers * summ["decode_steps"],
                "prefill": cfg.n_layers * chunks, "split": 0, "fp": 0}
        check(len(outs) == 4 and all(
            o.finish_reason == "length" and len(o.tokens) == T_SERVE_NEW
            and all(0 <= t < cfg.vocab_size for t in o.tokens)
            for o in outs), f"T3 {label}: outputs")
        check(routes == want, f"T3 {label}: paged launches {routes} != "
              f"{want}")
        streams[label] = {o.request_id: o.tokens for o in outs}
        result[label] = {"route_launches": routes, "wall_s": wall,
                         "decode_iterations": summ["decode_steps"],
                         "prefill_chunks": chunks,
                         **_clean_after(eng, f"T3 {label}")}
    same = sum(a == b for rid in streams["calibrated"] for a, b in zip(
        streams["calibrated"][rid], streams["uncalibrated"][rid]))
    result.update({
        "dump_entries": len(calib["weights"]), "channels": channels,
        "clipped_channels": clipped, "clipped_share": clipped / channels,
        "scales_equal_uncalibrated": scales_equal,
        "tokens_equal_uncalibrated": same,
        "tokens_compared": 4 * T_SERVE_NEW})
    log(result)
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    return result


def _t2(dev, tmp: Path, shards: Path) -> dict:
    """T2: the small preset's training run as rank 0 then rank 1, with
    faults, read back by graftscope."""
    from k8s_distributed_deeplearning_torch import faults
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.telemetry import timeline
    from k8s_distributed_deeplearning_torch.telemetry.heartbeat import (
        HeartbeatWriter, read_heartbeats)
    from k8s_distributed_deeplearning_torch.telemetry.trace import Tracer
    from k8s_distributed_deeplearning_torch.train import cli
    from k8s_distributed_deeplearning_torch.train import data as data_lib
    from k8s_distributed_deeplearning_torch.train import loop
    from k8s_distributed_deeplearning_torch.train.checkpoint import (
        Checkpointer)
    from k8s_distributed_deeplearning_torch.utils.metrics import (
        MetricsLogger)

    small = {k: v for k, v in cli.PRESETS["small"].items()
             if k != "scan_layers"}          # a layout, not an architecture
    cfg = llama.config_tiny(**{**small,
                               "n_layers": T2_LAYERS,
                               "dtype": torch.bfloat16,
                               "param_dtype": torch.float32,
                               "max_seq_len": 1024})
    batch, seq = 4, 1024
    plan = faults.FaultPlan((
        faults.Fault(site="data_wait", action="stall", rank=1, after=3,
                     count=2, seconds=T_STALL_S),
        faults.Fault(site="shard_read", action="ioerror", rank=0, count=1),
        faults.Fault(site="heartbeat", action="stop", rank=1,
                     step=T_HB_STOP)))
    hb_dir = tmp / "t2_hb"

    def batcher():
        return data_lib.TokenShardBatcher(str(shards), batch, seq, seed=0,
                                          vocab_size=cfg.vocab_size)

    # A throwaway run first: the first steps of a shape in this process
    # pay one-time costs that rank 0 alone would carry.
    _, _, state, step_fn = _train_setup(cfg, dev, lr=3e-4)
    loop.fit(step_fn, state, batcher().iter_from, 2, rng=1, log_every=0)
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    ranks, logs = {}, []
    for rank in (0, 1):
        _, _, state, step_fn = _train_setup(cfg, dev, lr=3e-4)
        losses, fires = [], []

        def recording(state, b, seed, step_fn=step_fn, losses=losses):
            state, loss, aux = step_fn(state, b, seed)
            losses.append(loss.detach())
            return state, loss, aux

        log_path = tmp / f"t2_rank{rank}.jsonl"
        logs.append(log_path)
        ck = Checkpointer(str(tmp / f"t2_ck{rank}"), max_to_keep=1)
        _record_fires(faults.activate(plan, rank=rank), fires)
        t0 = time.perf_counter()
        try:
            with open(log_path, "w") as f:
                metrics = MetricsLogger(stream=f, job="train")
                loop.fit(recording, state, batcher().iter_from, T_STEPS,
                         rng=1, metrics=metrics, checkpointer=ck,
                         checkpoint_every=T_CKPT_EVERY,
                         log_every=T_LOG_EVERY,
                         tracer=Tracer(metrics, rank=rank),
                         heartbeat=HeartbeatWriter(str(hb_dir), rank))
                torch.cuda.synchronize()
        finally:
            fired = [site for site, _ in faults.active().fired]
            faults.deactivate()
            ck.close()
        ranks[rank] = {
            "wall_s": time.perf_counter() - t0,
            "losses": [float(x) for x in losses],
            "checkpoint_saved_at": [s for site, s in fires
                                    if site == "checkpoint_saved"],
            "faults_fired": fired}
        del state, step_fn
        gc.collect()
        torch.cuda.empty_cache()
    for rank, path in enumerate(logs):
        ranks[rank]["saves"] = [
            {k: e.get(k) for k in ("step", "snapshot_ms", "write_ms",
                                   "manifest_ms", "save_ms")}
            for e in _events(path, "checkpoint")]
    losses_equal = ranks[0]["losses"] == ranks[1]["losses"]
    beats = {b["rank"]: b["step"] for b in read_heartbeats(str(hb_dir))}
    parsed = timeline.parse_files([str(p) for p in logs])
    tl = timeline.build_step_timelines(parsed)
    attrs = timeline.attribute_stragglers(tl)
    by_step = {a.step: a for a in attrs}
    summary = timeline.straggler_summary(attrs, T_STRAGGLER_MS, 1.2)
    trace_path = tmp / "t2_trace.json"
    rc, out, err = _graftscope("export-perfetto", *logs, "-o", trace_path)
    events = []
    if rc == 0:
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
    ends = {e["pid"]: e["ts"] + e["dur"] for e in events
            if e["ph"] == "X" and e["name"] == "step"
            and e["args"].get("step") == 0}
    result = {
        "phase": "T2",
        "model": f"train --preset small --seq-len 1024, {T2_LAYERS} layers",
        "dtype": "bfloat16", "batch": batch, "seq_len": seq,
        "steps": T_STEPS, "stall_s": T_STALL_S, "ranks": ranks,
        "losses_bitwise_equal": losses_equal, "heartbeats": beats,
        "stragglers": summary,
        "attributions": {a.step: {
            "rank": a.slowest_rank, "span": a.span, "lag_ms": a.lag_ms,
            "wall_ms": a.wall_ms, "span_excess_ms": a.span_excess_ms,
            "straggler": a.is_straggler(T_STRAGGLER_MS, 1.2)}
            for a in attrs},
        "components_ms": {s: {r: rec.breakdown() for r, rec in tl[s].items()}
                          for s in (3, 4)},
        "critical_path_ms": timeline.critical_path(tl),
        "perfetto_events": len(events), "perfetto_step0_end_us": ends}
    log(result)
    for rank, r in ranks.items():
        check(r["checkpoint_saved_at"] == [4, 8, 12],
              f"T2 rank {rank}: checkpoint_saved fired at "
              f"{r['checkpoint_saved_at']}")
    check(ranks[0]["faults_fired"] == ["shard_read"]
          and ranks[1]["faults_fired"] == ["data_wait", "data_wait"],
          f"T2 faults fired {[r['faults_fired'] for r in ranks.values()]}")
    check(all(np.isfinite(ranks[0]["losses"])), "T2 losses not finite")
    check(losses_equal, "T2 losses differ between the ranks")
    check(beats == {0: T_STEPS, 1: T_HB_STOP - 1},
          f"T2 heartbeat files {beats}")
    for step in (3, 4):
        a = by_step[step]
        check(a.slowest_rank == 1 and a.span == "data_wait"
              and a.lag_ms > T_STRAGGLER_MS,
              f"T2 step {step} attributed to {vars(a)}")
    check(summary["worst"] is not None
          and (summary["worst"]["rank"], summary["worst"]["span"])
          == (1, "data_wait"), f"T2 straggler summary {summary}")
    check(rc == 0, f"T2 export-perfetto: rc {rc} {err[-2000:]}")
    check(set(ends) == {0, 1} and abs(ends[0] - ends[1]) <= 1.0,
          f"T2 perfetto: step 0 ends at {ends} (us)")
    return result


def _t4(tmp: Path, shards: Path) -> dict:
    """T4: the train CLI on the card as its own process, streaming the
    shards and tracing steps 10-14, with adafactor and with lion (the two
    processes at once: the tiny preset leaves the card nearly idle)."""
    runs = {}
    t0 = time.perf_counter()
    for opt, extra in (("adafactor", []),
                       ("lion", ["--moment-dtype", "bfloat16"])):
        cmd = [sys.executable, "-m", "k8s_distributed_deeplearning_torch.train",
               "--preset", "tiny", "--attention", "flash", "--dtype",
               "bfloat16", "--data-path", str(shards), "--profile-dir",
               str(tmp / f"t4_prof_{opt}"), "--num-steps", str(T_CLI_STEPS),
               "--log-every", "4", "--checkpoint-dir",
               str(tmp / f"t4_ck_{opt}"), "--optimizer", opt, *extra]
        runs[opt] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True,
                                     cwd=REPO)
    outs = {}
    try:
        for opt, proc in runs.items():
            outs[opt] = proc.communicate(timeout=600)
    finally:
        for proc in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    out = {}
    for opt, (stdout, stderr) in outs.items():
        rc = runs[opt].returncode
        check(rc == 0, f"T4 {opt}: rc {rc}\n{stderr[-3000:]}")
        events = [json.loads(x) for x in stdout.splitlines()
                  if x.startswith("{")]
        start = next(e for e in events if e["event"] == "start")
        check(start.get("data") == "sharded-streaming",
              f"T4 {opt}: start event {start}")
        traced = _trace_kernels(tmp / f"t4_prof_{opt}" / "trace.json")
        check(all(traced.get(k, 0) > 0 for k in
                  ("flash_fwd_small", "flash_dq_small", "flash_dkv_small")),
              f"T4 {opt}: trace kernels {traced}")
        out[opt] = {
            "num_windows": start["num_windows"],
            "losses": {e["step"]: e["loss"] for e in events
                       if e["event"] == "train_step"},
            "step_ms": {e["step"]: e["step_time_ms"] for e in events
                        if e["event"] == "train_step"},
            "trace_kernels": {k: v for k, v in traced.items()
                              if k.startswith("flash")}}
    result = {"phase": "T4", "cli": "train --preset tiny --attention flash "
              "--dtype bfloat16", "steps": T_CLI_STEPS, "wall_s": wall,
              **out}
    log(result)
    return result


def phase_t(dev, tmp: Path, e_result: dict) -> dict:
    """The training loop's hooks and graftscope's readers: T1 (and T3 on
    its model), T2, T4."""
    t0 = time.perf_counter()
    shards = _t_shards(tmp)
    t1, model, calib = _t1(dev, tmp, shards, e_result)
    t3 = _t3(dev, model, calib)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t2 = _t2(dev, tmp, shards)
    t4 = _t4(tmp, shards)
    return {"t1": t1, "t2": t2, "t3": t3, "t4": t4,
            "seconds": time.perf_counter() - t0}


def _t5(logs: list, flight_dir: Path, kill: dict) -> dict:
    """T5: graftscope over R2's gateway kill: every sampled request trace
    of both replicas stitched on its trace id, and the flight dumps."""
    rc, out, err = _graftscope("requests", *logs, "--json")
    check(rc == 0, f"T5 graftscope requests: rc {rc} {err[-2000:]}")
    doc = json.loads(out)
    migrated = doc["migrated"]
    migrations = sum(j["migrations"] for j in migrated)
    check(migrations == kill["gateway_migrations"] >= 1
          and all(j["finish_reason"] == "length"
                  and j["replicas"][0] == "r0" for j in migrated),
          f"T5 stitched journeys {[(j['trace_id'], j['replicas']) for j in migrated]}"
          f": {migrations} migrations, the gateway counted "
          f"{kill['gateway_migrations']}")
    dumps = sorted(flight_dir.glob("flight-*.jsonl"))
    check(len(dumps) >= 1, f"T5 no flight dump in {flight_dir}")
    rc, text, err = _graftscope("postmortem", *dumps)
    check(rc == 0 and text.count("flight dump ") == len(dumps),
          f"T5 postmortem: rc {rc} {err[-2000:]}")
    result = {"phase": "T5", "request_traces": doc["requests"],
              "journeys": doc["journeys"], "migrated": len(migrated),
              "migrations": migrations,
              "gateway_migrations": kill["gateway_migrations"],
              "flight_dumps": [p.name for p in dumps],
              "postmortem_lines": len(text.splitlines())}
    log(result)
    return result


# ------------------------------------------------------------- phase N/O

MNIST_STEPS = 600            # one epoch of 60,000 at batch 100
MNIST_KILL_AFTER = 300       # SIGTERM after the first log at or past it
MNIST_MIN_ACCURACY = 0.95
# The repeat rule: when two unkilled runs already differ, a resumed run
# is held to that distance, per tensor (max |a - b|), times this factor.
REPEAT_FACTOR = 4.0
# Phase O: k steps, save, restore into a fresh model, k more; phase H's
# model at 2 of its 12 layers (1.5 GB a save against 6.25 GB: O took
# 96-126 s at 12 layers, 84 s of 107 in saves and restores).
RESUME_K = 3
O_LAYERS = 2
BUCKET_BYTES = 64 << 20      # Horovod's fusion-buffer default


def _mnist_job(ckdir, log_path, kill_after=None, extra=()):
    """Run the MNIST CLI on the card as its own process (cuDNN and cuBLAS
    held to deterministic algorithms; the repeat rule covers what is left)
    with the flags ``extra`` added, and return its events; with
    ``kill_after``, SIGTERM it after the first ``train_step`` event at
    that step or later."""
    code = ("import runpy, torch; "
            "torch.backends.cudnn.deterministic = True; "
            "torch.backends.cudnn.benchmark = False; "
            "runpy.run_module('k8s_distributed_deeplearning_torch.train."
            "mnist', run_name='__main__')")
    cmd = [sys.executable, "-c", code, "--num-steps", str(MNIST_STEPS),
           "--batch-size", "100", "--lr", "0.001", "--checkpoint-dir",
           str(ckdir), "--checkpoint-every", "200", "--log-every", "50",
           *extra]
    env = {**os.environ, "PYTHONPATH": str(REPO),
           "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    with open(log_path, "a") as err:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=err,
                                text=True, cwd=REPO, env=env)
        events = []
        try:
            for line in proc.stdout:
                if not line.startswith("{"):
                    continue
                events.append(json.loads(line))
                ev = events[-1]
                if kill_after is not None and ev["event"] == "train_step" \
                        and ev["step"] >= kill_after:
                    proc.send_signal(signal.SIGTERM)
                    kill_after = None
            proc.wait(timeout=600)
        finally:
            if proc.poll() is None:        # a failure above: stop the job
                proc.kill()
                proc.wait()
    check(proc.returncode == 0, f"MNIST job exited {proc.returncode}; its "
          f"stderr ends:\n{Path(log_path).read_text()[-3000:]}")
    return events


def _tensor_leaves(state: dict) -> dict:
    """Params and optimizer moments of a loaded checkpoint, by name."""
    out = {f"params/{n}": t for n, t in state["params"].items()}
    for key in ("mu", "nu"):
        out.update({f"{key}/{n}": t
                    for n, t in state["opt_state"][key].items()})
    return out


def _max_diffs(a: dict, b: dict) -> dict:
    return {n: float((a[n].float() - b[n].float()).abs().max())
            for n in a}


def _repeat_rule(name, a, b, again) -> dict:
    """``b`` (resumed) against ``a`` (unkilled): bitwise equal, or, when
    an unkilled repeat (``again()``) already differs from ``a``, within
    ``REPEAT_FACTOR`` x that distance on every tensor."""
    got = _max_diffs(a, b)
    if not any(got.values()):
        return {"bitwise_equal": True}
    rep = _max_diffs(a, again())
    bad = {n: (got[n], rep[n]) for n in got
           if got[n] > REPEAT_FACTOR * rep[n]}
    check(not bad, f"{name}: the resumed run differs beyond "
          f"{REPEAT_FACTOR} x the unkilled runs' distance: {bad}")
    return {"bitwise_equal": False,
            "tensors_differing": sum(v > 0 for v in got.values()),
            "max_abs_diff": max(got.values()),
            "unkilled_repeat_max_abs_diff": max(rep.values()),
            "repeat_differs": {n: v for n, v in rep.items() if v}}


def _median_step(events, key="step_time_ms"):
    """The median of a run's ``train_step`` windows but the first (which
    holds the start-up)."""
    return float(np.median([e[key] for e in events
                            if e["event"] == "train_step"][1:]))


def phase_n(dev, tmp: Path):
    """The reference's own job: the MNIST CLI at 60,000 / 10,000 synthetic
    examples, batch 100, Adam 1e-3, dropout 0.5, 600 steps. Two unkilled
    runs first: A as a user runs it, A0 with ``--prefetch 0`` (the same
    arithmetic; their step times say what the prefetch thread costs).
    Run B is SIGTERMed past step 300 and run again. Then the checks, the
    corrupted-step fallback, and a profiled window of the same step in
    this process."""
    from torch.profiler import ProfilerActivity, profile

    from k8s_distributed_deeplearning_torch import config as cfg_lib
    from k8s_distributed_deeplearning_torch.train import data as data_lib
    from k8s_distributed_deeplearning_torch.train import mnist as job
    from k8s_distributed_deeplearning_torch.train.checkpoint import (
        Checkpointer)
    from k8s_distributed_deeplearning_torch.utils import ckpt as ckpt_paths

    log_path = tmp / "mnist_stderr.log"
    dirs = {r: tmp / f"mnist_{r}" for r in ("a", "a0", "b")}
    t0 = time.perf_counter()
    run_a = _mnist_job(dirs["a"], log_path)
    wall_a = time.perf_counter() - t0
    run_a0 = _mnist_job(dirs["a0"], log_path, extra=("--prefetch", "0"))
    run_b1 = _mnist_job(dirs["b"], log_path, kill_after=MNIST_KILL_AFTER)
    pre = [e for e in run_b1 if e["event"] == "preempted"]
    check(len(pre) == 1 and pre[0]["checkpointed"] is True
          and MNIST_KILL_AFTER <= pre[0]["step"] < MNIST_STEPS,
          f"run B: no checkpointed preemption past step {MNIST_KILL_AFTER}:"
          f" {pre}")
    check(not any(e["event"] == "eval" for e in run_b1),
          "a preempted run evaluated")
    run_b2 = _mnist_job(dirs["b"], log_path)
    restores = [e for e in run_b2 if e["event"] == "restore"]
    check([e["step"] for e in restores] == [pre[0]["step"]],
          f"run B again restored {restores}, not step {pre[0]['step']}")
    for d in (dirs["a"], dirs["b"]):
        for step in ckpt_paths.steps_on_disk(str(d)):
            problem = ckpt_paths.verify_manifest(str(d), step)
            check(problem is None, f"{d}/{step}: {problem}")

    def final(d):
        return torch.load(d / str(MNIST_STEPS) / "state.pt",
                          weights_only=True)

    fa, fa0, fb = (final(dirs[r]) for r in ("a", "a0", "b"))
    check(fa["step"] == fb["step"] == fa0["step"] == MNIST_STEPS
          and fa["opt_state"]["count"] == fb["opt_state"]["count"],
          "the step-600 checkpoints disagree on the step or Adam's count")
    repeat = _max_diffs(_tensor_leaves(fa), _tensor_leaves(fa0))
    resume = _repeat_rule("phase N", _tensor_leaves(fa), _tensor_leaves(fb),
                          lambda: _tensor_leaves(fa0))
    resume["unkilled_runs_bitwise_equal"] = not any(repeat.values())
    evals = [e for e in run_a if e["event"] == "eval"]
    check(len(evals) == 1 and evals[0]["eval_examples"] == 10_000
          and evals[0]["accuracy"] >= MNIST_MIN_ACCURACY,
          f"run A's eval: {evals}, want accuracy >= {MNIST_MIN_ACCURACY}")

    # One corrupted byte in B's newest step: quarantined, and the next
    # restore falls back to the step before it.
    steps_b = ckpt_paths.steps_on_disk(str(dirs["b"]))
    victim = dirs["b"] / str(steps_b[-1]) / "state.pt"
    with open(victim, "r+b") as f:
        f.seek(victim.stat().st_size // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    conf = cfg_lib.TrainConfig()
    _, _, template, _ = job.build(conf, dev, 1)
    ck = Checkpointer(str(dirs["b"]))
    restored, step = ck.restore_latest(template)
    check(step == steps_b[-2] and [s for s, _ in ck.quarantined]
          == [steps_b[-1]] and "checksum" in ck.quarantined[0][1],
          f"corrupt step {steps_b[-1]}: restored {step}, quarantined "
          f"{ck.quarantined}")
    want = torch.load(dirs["b"] / str(step) / "state.pt", weights_only=True)
    check(all(torch.equal(restored.params[n].cpu(), t)
              for n, t in want["params"].items()),
          "the fallback restore does not hold the older step's params")

    # The job's step in this process, under the job's cuDNN settings: a
    # timed window, then a profiled one.
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32)
    cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = True, False, True
    _, _, state, step_fn = job.build(conf, dev, 1)
    x, y = data_lib.synthetic_mnist(10_000, seed=0)
    batcher = data_lib.ShardedBatcher(x, y, conf.batch_size, seed=0)
    for i in range(20):
        state, loss, _ = step_fn(state, batcher.batch_at(i), i)
    torch.cuda.synchronize()
    steps = 50
    t1 = time.perf_counter()
    for i in range(steps):
        state, loss, _ = step_fn(state, batcher.batch_at(i), i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            state, loss, _ = step_fn(state, batcher.batch_at(i), i)
        torch.cuda.synchronize()
    cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = flags
    kernels = _device_ms_by_kernel(prof, steps)
    device_ms = sum(k[2] for k in kernels)
    logs = [e for e in run_a if e["event"] == "train_step"]
    saves = [e for e in run_a if e["event"] == "checkpoint"]
    result = {
        "phase": "N", "model": "MNIST ConvNet (the reference's conv_model)",
        "train_examples": 60_000, "test_examples": 10_000, "batch": 100,
        "steps": MNIST_STEPS, "dropout": 0.5, "lr": 0.001,
        "run_a_wall_s": wall_a,
        "step_ms": _median_step(run_a),
        "examples_per_s": _median_step(run_a, "examples_per_sec"),
        "mfu_f32_peak": _median_step(run_a, "mfu"),
        "step_ms_prefetch_0": _median_step(run_a0),
        "final_loss": logs[-1]["loss"], "eval": evals[0],
        "preempted_at": pre[0]["step"],
        "preempt_save": {k: pre[0][k] for k in pre[0]
                         if k.endswith("_ms") or k == "bytes"},
        "restore": {k: restores[0][k] for k in restores[0]
                    if k.endswith("_ms") or k == "bytes"},
        "saves": [{k: e[k] for k in e if k.endswith("_ms") or k in
                   ("step", "bytes")} for e in saves],
        "resume": resume, "corrupt_fallback": {
            "quarantined": steps_b[-1], "restored": step},
        "profiled_window": {
            "steps": steps, "step_ms": step_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / step_ms,
            "device_ms_by_class": _by_class(kernels),
            "top_kernels": [{"name": n[:90], "launches": c / steps,
                             "ms": ms} for n, c, ms in kernels[:8]]}}
    log(result)
    return result


def phase_o(dev, tmp: Path):
    """Checkpoint and resume on the kernels: phase H's model at
    ``O_LAYERS`` layers, unkilled for 2k steps, then k steps, a save, a
    fresh model from another seed restored from disk and k more; then two
    steps with fused gradient buckets against two without."""
    from k8s_distributed_deeplearning_torch.parallel import (
        data_parallel as dp)
    from k8s_distributed_deeplearning_torch.train import data as data_lib
    from k8s_distributed_deeplearning_torch.train import loop
    from k8s_distributed_deeplearning_torch.train.checkpoint import (
        Checkpointer)

    cfg, mcfg, seq, per_step = _moe_slice(O_LAYERS)
    k = RESUME_K
    tokens = data_lib.synthetic_tokens(1 << 17, vocab_size=cfg.vocab_size,
                                       seed=0)
    batcher = data_lib.TokenBatcher(tokens, 8, seq, seed=0)

    def setup(seed):
        gc.collect()
        torch.cuda.empty_cache()
        model, optimizer, state, step_fn = _train_setup(
            cfg, dev, lr=1e-3, chunked=False, moe_cfg=mcfg, seed=seed)
        losses = []

        def logged(state, batch, s):
            state, loss, aux = step_fn(state, batch, s)
            losses.append(float(loss))
            return state, loss, aux
        return model, optimizer, state, logged, losses

    def host(state) -> dict:
        return {f"params/{n}": t.detach().cpu() for n, t in
                state.params.items()} | {
            f"{m}/{n}": t.cpu() for m in ("mu", "nu")
            for n, t in state.opt_state[m].items()}

    def unkilled():
        _, _, state, step_fn, losses = setup(0)
        state = loop.fit(step_fn, state, batcher.iter_from, 2 * k, rng=1)
        return host(state), losses

    want, want_losses = unkilled()
    ckdir = tmp / "moe"
    ck = Checkpointer(str(ckdir), max_to_keep=2)
    _, _, state, step_fn, losses = setup(0)
    _zero_launches()
    state = loop.fit(step_fn, state, batcher.iter_from, k, rng=1,
                     checkpointer=ck, checkpoint_every=k)
    first = _launch_counts()
    save = dict(ck.last_save)
    del state, step_fn
    model, optimizer, state, step_fn, losses2 = setup(1)
    _zero_launches()
    state = loop.fit(step_fn, state, batcher.iter_from, 2 * k, rng=1,
                     checkpointer=ck, checkpoint_every=k)
    second = _launch_counts()
    restore = dict(ck.last_restore)
    want_counts = {n: per_step.get(n, 0) * k for n in first}
    check(first == want_counts and second == want_counts,
          f"phase O launches {first} / {second} != {want_counts} a half")
    check(restore["step"] == k and state.step == 2 * k,
          f"restored {restore}, ended at {state.step}")
    resume = _repeat_rule("phase O", want, host(state),
                          lambda: unkilled()[0])
    resume["losses_equal"] = losses + losses2 == want_losses
    check(resume["losses_equal"] or not resume["bitwise_equal"],
          f"losses {losses + losses2} != {want_losses} with equal state")
    del want

    # Fused buckets: two steps from the step-2k checkpoint with and
    # without them.
    loss_fn = _train_loss(model, False, mcfg)
    plain = dp.make_train_step(loss_fn, optimizer)
    fused = dp.make_train_step(loss_fn, optimizer, bucket_bytes=BUCKET_BYTES)
    out = {}
    for name, fn in (("plain", plain), ("fused", fused)):
        state, _ = ck.restore_latest(state)
        state = loop.fit(fn, state, batcher.iter_from, 2 * k + 2, rng=1)
        out[name] = {n: t.detach().cpu() for n, t in state.params.items()}
    restore2 = dict(ck.last_restore)
    check(all(torch.equal(out["plain"][n], out["fused"][n])
              for n in out["plain"]),
          "two steps with fused buckets differ from two without")
    n_buckets = max(dp.plan_buckets(dict(state.params), None,
                                    BUCKET_BYTES)) + 1
    disk = sum(f.stat().st_size for f in ckdir.rglob("*") if f.is_file())
    gb = save["bytes"] / 1e9
    result = {
        "phase": "O", "model": "llama-small MoE 8e top-2 ragged",
        "layers": cfg.n_layers, "k": k,
        "params": sum(t.numel() for t in state.params.values()),
        "state_bytes": save["bytes"], "disk_bytes": disk,
        "save": save, "save_gb_per_s": gb / (save["save_ms"] / 1e3),
        "write_gb_per_s": gb / (save["write_ms"] / 1e3),
        "restore": restore,
        "restore_gb_per_s": restore["bytes"] / 1e9
        / (restore["restore_ms"] / 1e3),
        "restore_again": restore2, "resume": resume,
        "losses": want_losses, "launches_a_half": first,
        "buckets": {"bucket_bytes": BUCKET_BYTES, "count": n_buckets,
                    "params_bitwise_equal": True}}
    log(result)
    del model, optimizer, state, step_fn, out
    return result


def _agreement(phase, info, ka, kx, dev):
    """Phases F and I: the kernel path's run ``ka`` (held on the host)
    against the plain path's ``kx``: losses, then per parameter tensor the
    first step's gradient and the parameters after the steps."""
    steps = info["steps"]
    la, lx = ka["losses"], kx["losses"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(la, lx))

    def l2(x):
        return float(x.double().square().sum().sqrt())

    # Per parameter tensor, so that a fault confined to the attention
    # projections cannot hide behind the 1.05 B embedding and head values.
    grad_rel, param_rel, name, idx, worst_diff = {}, {}, None, 0, -1.0
    for n, px in kx["params"].items():
        gx = kx["grads"][n]
        grad_rel[n] = l2(ka["grads"][n].to(dev) - gx) / l2(gx)
        diff = ka["params"][n].to(dev) - px
        param_rel[n] = l2(diff) / l2(px - kx["init"][n])
        if float(diff.abs().max()) > worst_diff:
            worst_diff = float(diff.abs().max())
            name, idx = n, int(diff.abs().argmax())
        del diff

    # The element whose parameter differs most, with what Adam saw there.
    def at(t):
        return float(t.reshape(-1)[idx])

    fields = ("params", "grads", "mu", "nu")
    worst = {"param": name, "index": idx, "abs_diff": worst_diff,
             "init": at(kx["init"][name]),
             "kernel": {k: at(ka[k][name]) for k in fields},
             "plain": {k: at(kx[k][name]) for k in fields},
             "leaf_grad_rms": l2(kx["grads"][name])
             / math.sqrt(kx["grads"][name].numel()), "adam_eps": 1e-8}
    result = {"phase": phase, **info, "dtype": "float32", "tf32": False,
              "losses_kernel": la, "losses_plain": lx,
              "loss_max_rel_diff": loss_rel, "loss_rtol": TRAIN_LOSS_RTOL,
              "grad_rel_diff_worst": max(grad_rel.values()),
              "grad_rel_diff_worst_param": max(grad_rel, key=grad_rel.get),
              "grad_rtol": TRAIN_GRAD_TOL,
              "param_rel_diff_worst": max(param_rel.values()),
              "param_rel_diff_worst_param": max(param_rel,
                                                key=param_rel.get),
              "param_rtol": TRAIN_PARAM_TOL,
              "grad_rel_diff": grad_rel, "param_rel_diff": param_rel,
              "max_abs_diff_element": worst}
    log(result)
    del ka, kx
    gc.collect()
    torch.cuda.empty_cache()
    check(all(np.isfinite(la + lx)), f"non-finite loss in phase {phase}")
    check(loss_rel <= TRAIN_LOSS_RTOL,
          f"kernel-path and plain-path losses differ by {loss_rel}")
    check(max(grad_rel.values()) <= TRAIN_GRAD_TOL,
          f"first-step gradients: worst parameter "
          f"{result['grad_rel_diff_worst_param']} differs by "
          f"{max(grad_rel.values())} > {TRAIN_GRAD_TOL} of its L2 norm")
    check(max(param_rel.values()) <= TRAIN_PARAM_TOL,
          f"params after {steps} steps: worst parameter "
          f"{result['param_rel_diff_worst_param']} differs by "
          f"{max(param_rel.values())} > {TRAIN_PARAM_TOL} x its change")
    return result


def _p_launches(p_result, route) -> dict:
    """Phase P's launches of one route, by path (each path's counts were
    set to 0 just before it and read just after); the f32 exact gates'
    paths under "f32"."""
    paths = {f"P1 {k}": v["route_launches"]
             for k, v in p_result["p1"].items() if k.startswith("cache")}
    paths.update({f"P2 {k}": v["route_launches"]
                  for k, v in p_result["p2"].items()})
    paths.update({f"f32 {k}": v for k, v in
                  p_result["f32_exact"]["route_launches"].items()})
    return {k: v[route] for k, v in paths.items()}


def _r_launches(r_result, route, small) -> dict:
    """Phase R's launches of one route, by sub-run (each counted from 0):
    R1 by engine, R2 by run, R3 by topology. Only R3 runs at head_dim 16
    (the tiny preset in f32, its launches counted in ``small``), so the
    head_dim-16/32 entries take those and the others the rest."""
    runs = {f"R1 {rid}": v for rid, v in
            r_result["r1"]["route_launches"].items()}
    runs.update({f"R2 {k}": v for k, v in
                 r_result["r2"]["route_launches"].items()})
    runs.update({f"R3 {topo}": r_result["r3"][topo]["route_launches"]
                 for topo in ("gateway", "disagg")})
    out = {}
    for name, v in runs.items():
        part = v.get("small", 0) if route == "tf32x3" else 0
        out[name] = part if small else v[route] - part
    return out


def _paged_entries(fp_cases, b_result, c_result, int8_cases, j_result,
                   k_result, p_result, verify_cases, r_result):
    """Kernel-line entries of the paged kernels, by kernel, head dims and
    branch. The decode kernel's representative case at head_dim 64/128 is
    decode in bf16, the prefill kernel's 512 queries at offset 1024 in
    bf16, with the launches of phases B (fp) and J (int8) on each route;
    the tf32x3 kernel's is decode in f32, with the launches of the f32
    kernel paths of phases C (fp) and K (int8). At head_dim 16/32 the
    decode kernel's is the micro draft's decode in bf16, with the
    draft's launches in phase P's small-preset run; the tf32x3 kernel's
    the tiny preset's f32 decode step, with the launches of C's and K's
    tiny-preset runs. The split kernel's cases are the other routes'
    cases with it forced on their inputs (the tiny preset's decode its
    representative), with its launches in those runs: 0. Each fp entry of
    a head_dim 64/128 kernel also carries phase P's launches by path (the
    prefix cache, the speculative runs; for tf32x3 its f32 exact gates);
    P's verify windows join the entry of their route and branch. Each fp
    entry carries phase R's launches by sub-run (``launches_r``): the
    disaggregated engines (R1), the f32 fleet runs (R2), the soak (R3);
    the int8 entries none (R serves fp pools)."""
    out = []
    keys = ("case", "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    extra = ("split_ms", "split_max_abs_err", "split_tol_share",
             "repeat_bitwise", "ms_tile64", "ms_tile128")
    small_hd = (16, 32)
    for name, route, source, rep_case, rep_dtype, small in (
            ("paged_decode", "decode", "paged_decode.cu", "decode",
             "bfloat16", False),
            ("paged_prefill_attention", "prefill", "paged_prefill.cu",
             "prefill512", "bfloat16", False),
            ("paged_attn_tf32x3", "tf32x3", "paged_attn_f32.cu", "decode",
             "float32", False),
            ("paged_decode_small", "decode", "paged_decode.cu",
             "micro_decode", "bfloat16", True),
            ("paged_attn_tf32x3_small", "tf32x3", "paged_attn_f32.cu",
             "tiny_decode", "float32", True),
            ("paged_attn_split", "split", "paged_attn.cu", "tiny_decode",
             "float32", False)):
        for branch, cases, served, f32_path in (
                ("fp", fp_cases, b_result, c_result),
                ("quant=True", int8_cases, j_result, k_result)):
            int8 = branch != "fp"
            tiny = f32_path["tiny_preset"]["launches"]["auto"]
            if route == "split":
                # The other routes' cases with the split kernel forced on
                # their inputs: their split_* numbers, and the f32 CUDA
                # cores' bound where the case's own route has the TF32 one.
                mine = [
                    {**{k: c[k] for k in keys
                        if k not in ("max_abs_err", "ms")},
                     "route_of_case": c["route"], "ms": c["split_ms"],
                     "max_abs_err": c["split_max_abs_err"],
                     "tol_share": c["split_tol_share"],
                     "bound_ms": c.get("bound_ms_f32_cores", c["bound_ms"]),
                     "bound_by": c.get("bound_by_f32_cores", c["bound_by"])}
                    for c in cases if "split_ms" in c]
                launched = tiny["split"]
                where = (f"{f32_path['phase']} (f32 tiny preset, head_dim "
                         "16)")
            else:
                mine = [c for c in cases if c["route"] == route
                        and (c["shape"]["hd"] in small_hd) == small]
                if small and route == "tf32x3":
                    launched = tiny["small"]
                    where = (f"{f32_path['phase']} (f32 tiny preset, "
                             "head_dim 16)")
                elif small:
                    launched = (0 if int8 else p_result["small_micro"][
                        "bfloat16"]["micro_k3"]["route_launches"]["small"])
                    where = ("P (bf16 small preset, the micro draft's "
                             "head_dim 16)")
                elif route == "tf32x3":
                    launched = f32_path["launches"]["auto"][
                        "tf32x3_int8" if int8 else "tf32x3"]
                    where = f"{f32_path['phase']} (f32 kernel path)"
                else:
                    launched = served["route_launches"][route]
                    where = served["phase"]
            rep = next(c for c in mine
                       if c["case"] == rep_case and c["dtype"] == rep_dtype)
            out.append({
                "name": name + ("_int8" if int8 else ""),
                "route": "cuda",
                "source": "k8s_distributed_deeplearning_torch/csrc/" + source,
                "replaces": PAGED_REPLACES, "branch": branch,
                "launches": launched, "launches_in": where,
                **{k: rep[k] for k in keys[2:]},
                **({"bound_ms_f32_cores": rep["bound_ms_f32_cores"]}
                   if "bound_ms_f32_cores" in rep else {}),
                "cases": [{k: c[k] for k in keys + extra + (
                    "tol_share", "route_of_case", "bound_ms_f32_cores")
                    if k in c} for c in mine]})
            if not int8 and not small:
                out[-1]["launches_p"] = _p_launches(p_result, route)
            out[-1]["launches_r"] = (
                {} if int8 else _r_launches(r_result, route, small))
            out[-1]["launches_in"] += "; R by sub-run in launches_r"
            if not small:
                out[-1]["cases"] += [
                    {k: c[k] for k in keys + extra + (
                        "tol_share", "decode_ms", "prefill_ms") if k in c}
                    for c in verify_cases if c["route"] == route
                    and c["branch"] == ("int8" if int8 else "fp")]
    return out


def _flash_entries(rows, e_result, f_result, q_result, v_result):
    """Kernel-line entries of the flash kernels: the representative case
    is the training path's causal one, in bf16 (f32 for the tf32x3 lines;
    phase Q's shape for the small lines). The launches are those of the
    path that runs each kernel: phase E's bf16 step for the wgmma kernels,
    phase F's f32 kernel path for the tf32x3 kernels and the mma forward,
    phase Q's bf16 tiny preset (head dim 16) for the small kernels and the
    mma backward; each by route (the mma kernels: 0, forced only). The
    zoo's paths under ``"flash"`` add ``launches_zoo``: V2's and V3's timed
    windows on the wgmma lines, V4's f32 kernel paths on the tf32x3
    lines."""
    out = []
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    for name, cases in rows.items():
        source, wrapper = FLASH_KERNELS[name]
        route = next((r for r in ROUTE_COUNTS if name.endswith(f"_{r}")),
                     "mma")
        rep = next(c for c in cases if c["case"] == (
            "q_tiny_causal" if route == "small" else "causal")
            and c["dtype"] == ("float32" if route == "tf32x3"
                               else "bfloat16"))
        if route == "wgmma":
            where, counts = "E", e_result["launches"]
        elif route == "tf32x3" or (wrapper == "flash_fwd"
                                   and route == "mma"):
            where, counts = "F (f32)", f_result["kernel_path_launches"]
        else:
            where = "Q (bf16, head_dim 16)"
            counts = q_result["bfloat16"]["launches"]
        if route != "mma":
            launched = counts.get(name, 0)
        else:       # the counts hold nonzero entries alone
            launched = _mma_launches(counts, name) if name in counts else 0
        zoo = {}
        if route == "wgmma":
            zoo = {p: round(v_result[p]["runs"]["flash"][
                "launches_per_step"].get(name, 0) * V_TIMED)
                for p in ("V2", "V3")}
        elif route == "tf32x3":
            zoo = {f"V4 {case}": r["kernel_path_launches"].get(name, 0)
                   for case, r in v_result["V4"].items()}
        out.append({
            "name": name, "route": "cuda",
            "source": "k8s_distributed_deeplearning_torch/csrc/" + source,
            "replaces": FLASH_REPLACES[wrapper],
            "launches": launched, "launches_in": where,
            **({"launches_zoo": zoo} if zoo else {}),
            **{k: rep[k] for k in keys},
            **{k: rep[k] for k in ("bound_ms_f32_cores", "rowsum_do_o_ms")
               if k in rep},
            "bound_parts_ms": rep["bound_parts_ms"],
            "cases": [{k: c[k] for k in ("case", "dtype", "max_abs_err",
                                          "tol_share", *keys[1:],
                                          "library_backend",
                                          "rowsum_do_o_ms") if k in c}
                      for c in cases]})
    return out


def _entry_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled symbol: the
    length-prefixed name ending in ``kernel``, ``wgmma``, ``tf32x3`` or
    ``small`` (a
    length may follow hex digits of the namespace's hash, so every suffix
    of a digit run is tried)."""
    for run in re.finditer(r"\d+", mangled):
        for i in range(run.start(), run.end()):
            end = run.end() + int(mangled[i:run.end()])
            name = mangled[run.end():end]
            if re.fullmatch(r"[a-z_]+(?:kernel|wgmma|tf32x3|small)",
                            name) and \
                    mangled[end:end + 1] in ("I", "E"):
                args = re.match(r"(I\w*?)EvP", mangled[end:])
                return name + (args.group(1) if args else "")
    return mangled


# ------------------------------------------------------------- phase V

V_FIXED_STEPS = 8          # steps on one fixed batch, as E's
V_WARM, V_TIMED = 2, 6     # steps before the timed window, and in it
V_LR = 1e-3                # AdamW, global-norm clip 1.0
V_F32_TOL = 1e-4           # V1: f32 card against CPU, relative L2
V_IMAGES = 256             # V1's synthetic images (V3 takes 128)
V_F32_STEPS = 3            # V4's AdamW steps, as F's
V_EXAMPLE_STEPS = 4        # V5: each small preset through main(argv)
V_RESUME_STEPS = 40        # V5: the subprocess run, killed and re-run
V_KILL_AFTER = 20          # V5: SIGKILL after the first log at or past it
EXAMPLE_ZOO = REPO / "examples" / "train_zoo_torch.py"


def _v_free() -> None:
    """Return the card's cached blocks after the caller dropped a model."""
    gc.collect()
    torch.cuda.empty_cache()


def _v_fixed(phase, step_fn, state, batch):
    """Eight steps on one batch must bring the loss below the margin."""
    losses = []
    for i in range(V_FIXED_STEPS):
        state, loss, _ = step_fn(state, batch, i)
        losses.append(float(loss))
    check(all(np.isfinite(losses)), f"{phase}: non-finite loss on the fixed "
          f"batch: {losses}")
    check(losses[-1] < FIXED_BATCH_MARGIN * losses[0],
          f"{phase}: {V_FIXED_STEPS} steps on one fixed batch: loss "
          f"{losses[0]} -> {losses[-1]}, not below {FIXED_BATCH_MARGIN} x "
          f"the first")
    return state, losses


def _v_window(phase, step_fn, state, batches, *, examples, flops_example,
              per_step):
    """A timed window through ``fit`` after a warm-up, every kernel's
    launches set to 0 before it and held to ``per_step`` x steps after it
    (by kernel-line name), then one profiled step. ``batches`` is
    ``start_step -> iterator``; ``examples`` a step's images or tokens."""
    from torch.profiler import ProfilerActivity, profile

    from k8s_distributed_deeplearning_torch.train import loop

    state = loop.fit(step_fn, state, batches, state.step + V_WARM, rng=1,
                     log_every=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    state = loop.fit(step_fn, state, batches, state.step + V_TIMED, rng=1,
                     log_every=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    want = {n: per_step.get(n, 0) * V_TIMED for n in launches}
    check(launches == want, f"{phase}: kernel launches {launches} != {want} "
          f"over {V_TIMED} steps")
    rate = V_TIMED * examples / wall
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    batch = next(batches(state.step))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, loss, _ = step_fn(state, batch, state.step)
        torch.cuda.synchronize()
    check(bool(torch.isfinite(loss)), f"{phase}: non-finite loss in the "
          f"profiled step")
    kernels = _device_ms_by_kernel(prof, 1)
    device_ms = sum(k[2] for k in kernels)
    step_ms = wall / V_TIMED * 1e3
    return state, {
        "timed_steps": V_TIMED, "step_ms": step_ms, "per_s": rate,
        "model_flops_share": flops_example * rate
        / PEAK_FLOPS[torch.bfloat16],
        "peak_memory_gb": peak_gb,
        "launches_per_step": {n: v / V_TIMED for n, v in launches.items()
                              if v},
        "profiled_step": {
            "device_ms": device_ms, "device_busy_share": device_ms / step_ms,
            "device_ms_by_class": _by_class(kernels),
            "top_kernels": [{"name": n[:90], "launches": c, "ms": ms}
                            for n, c, ms in kernels[:8]]}}


def _v_stats_step(model):
    """AdamW over a ResNet's parameters and the stats-carrying step."""
    from k8s_distributed_deeplearning_torch.models import resnet
    from k8s_distributed_deeplearning_torch.parallel import (
        data_parallel as dp)
    from k8s_distributed_deeplearning_torch.train import optim

    optimizer = optim.make_optimizer("adamw", V_LR, grad_clip=1.0)
    state = dp.init_stats_state(dict(model.named_parameters()),
                                dict(model.named_buffers()), optimizer)
    return state, dp.make_stats_train_step(
        lambda b, g: resnet.loss_fn(model, b, g), optimizer)


def _rel_l2_of(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-30))


def _v1(dev) -> dict:
    """ResNet-50 at 224², batch 64, 1000 classes, bf16 compute and f32
    params, BatchNorm and the conv7 stem; one step each with ghost
    statistics (32 of 64), GroupNorm and the s2d stem; then f32 on the card
    (TF32 off) against the port's CPU forward of the same weights."""
    from k8s_distributed_deeplearning_torch.models import resnet
    from k8s_distributed_deeplearning_torch.train import data as data_lib

    batch, size = 64, 224
    x, y = data_lib.synthetic_images(V_IMAGES, size=size, num_classes=1000,
                                     seed=0)
    batcher = data_lib.ShardedBatcher(x, y, batch, seed=0)
    torch.cuda.reset_peak_memory_stats()
    model = resnet.resnet50(device=dev, seed=0)
    stats0 = {k: v.clone() for k, v in model.named_buffers()}
    state, step_fn = _v_stats_step(model)
    state, losses = _v_fixed("V1", step_fn, state, batcher.batch_at(0))
    moved = [float((v - stats0[k]).abs().max())
             for k, v in state.batch_stats.items()]
    check(all(bool(torch.isfinite(v).all())
              for v in state.batch_stats.values()) and min(moved) > 0,
          f"V1: running statistics not finite or not moved ({min(moved)})")
    state, window = _v_window(
        "V1", step_fn, state, batcher.iter_from, examples=batch,
        flops_example=resnet.flops_per_example(size), per_step={})
    result = {"phase": "V1", "model": "resnet50", "image_size": size,
              "batch": batch, "dtype": "bfloat16", "norm": "batch",
              "stem": "conv7", "lr": V_LR, "fixed_batch_losses": losses,
              "stats_min_moved": min(moved), "images_per_s": window["per_s"],
              **window}
    del model, state, step_fn
    _v_free()
    variants = {}
    for name, kw in (("ghost_32_of_64", dict(norm="ghost",
                                              stats_examples=32)),
                     ("group", dict(norm="group")), ("s2d", dict(stem="s2d"))):
        model = resnet.resnet50(device=dev, seed=0, **kw)
        state, step_fn = _v_stats_step(model)
        state, loss, _ = step_fn(state, batcher.batch_at(0), 0)
        variants[name] = float(loss)
        check(np.isfinite(variants[name]), f"V1 {name}: loss {loss}")
        del model, state, step_fn
        _v_free()
    result["variant_losses"] = variants

    # f32 on the card against the CPU: logits and the new running
    # statistics of a training forward, batch 8, bn3 scales from the seed.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = resnet.resnet50(dtype=torch.float32, device=dev, seed=1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    with torch.no_grad():
        for block in card.blocks.values():
            block.bn3.scale.normal_(0.0, 0.2, generator=gen)
    cpu = resnet.resnet50(dtype=torch.float32, device="cpu", seed=1)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    images = torch.from_numpy(x[:8])
    outs = {}
    for where, m, xs in (("card", card, images.to(dev)),
                         ("cpu", cpu, images)):
        stats: dict = {}
        with torch.no_grad():
            logits = m(xs, train=True, batch_stats=stats)
        outs[where] = (logits.cpu(), {k: v.cpu() for k, v in stats.items()})
    logit_rel = _rel_l2_of(outs["card"][0], outs["cpu"][0])
    stat_rel = {k: _rel_l2_of(v, outs["cpu"][1][k])
                for k, v in outs["card"][1].items()}
    worst = max(stat_rel, key=stat_rel.get)
    result["f32_card_vs_cpu"] = {
        "batch": 8, "logits_rel_l2": logit_rel,
        "stats_rel_l2_worst": stat_rel[worst], "stats_worst": worst,
        "stats_count": len(stat_rel), "tol": V_F32_TOL}
    log(result)
    n_bn = sum(isinstance(m, resnet.BatchNorm) for m in card.modules())
    check(len(stat_rel) == 2 * n_bn and logit_rel <= V_F32_TOL
          and stat_rel[worst] <= V_F32_TOL,
          f"V1 f32: card against CPU, {len(stat_rel)} statistics, logits "
          f"{logit_rel}, worst statistic {worst} {stat_rel[worst]} > "
          f"{V_F32_TOL}")
    del card, cpu
    _v_free()
    return result


def _v_masked(tokens, vocab, seed):
    """BERT's masked batch from a host token-window batch ([B, S + 1]):
    the first S tokens masked by ``mask_tokens`` from a seeded CPU
    generator, ``mask_id`` the last id (the JAX script's choice)."""
    from k8s_distributed_deeplearning_torch.models import bert

    gen = torch.Generator()
    gen.manual_seed(seed)
    inputs, targets, weights = bert.mask_tokens(
        torch.from_numpy(tokens[:, :-1]).long(), gen, vocab_size=vocab,
        mask_id=vocab - 1)
    return {"inputs": inputs, "targets": targets, "weights": weights}


def _v_flash_per_step(layers: int, route: str) -> dict:
    """Flash launches a step of an encoder without remat: one forward, one
    dQ, one dK/dV and the bf16 backward's delta a layer, all on
    ``route``."""
    out = {}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "flash_bwd_delta"):
        out[name] = out[f"{name}_{route}"] = layers
    return out


def _v_grads(build, loss_of, batch, dev, dtype, impl):
    """One batch's loss and every parameter's gradient, from the seeded
    weights ``build(dtype, impl)`` gives."""
    from k8s_distributed_deeplearning_torch.parallel import (
        data_parallel as dp)

    model = build(dtype, impl)
    params = dict(model.named_parameters())
    loss, _ = loss_of(model)(dp.to_device(batch, dev), None)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    return float(loss.detach()), grads


def _v_encoder(phase, dev, build, loss_of, fixed, batches, *, examples,
               flops_example, layers, grad_build):
    """V2 and V3: the encoder through ``attention_impl="auto"`` (the einsum
    path at these lengths, as JAX picks) and ``"flash"``: the fixed-batch
    loss falls, a timed window with the launches exact by route (auto:
    none; flash: a forward, dQ and dK/dV a layer, all wgmma), then phase
    F_bf16's rule on one step's gradients (``grad_build``: the same
    weights with a random head where the model's is zero)."""
    from k8s_distributed_deeplearning_torch.parallel import (
        data_parallel as dp)
    from k8s_distributed_deeplearning_torch.train import optim

    runs = {}
    for impl in ("auto", "flash"):
        torch.cuda.reset_peak_memory_stats()
        model = build(torch.bfloat16, impl)
        optimizer = optim.make_optimizer("adamw", V_LR, grad_clip=1.0)
        state = dp.init_state(dict(model.named_parameters()), optimizer)
        step_fn = dp.make_train_step(loss_of(model), optimizer)
        state, losses = _v_fixed(f"{phase} {impl}", step_fn, state, fixed)
        per_step = ({} if impl == "auto"
                    else _v_flash_per_step(layers, "wgmma"))
        state, window = _v_window(f"{phase} {impl}", step_fn, state, batches,
                                  examples=examples,
                                  flops_example=flops_example,
                                  per_step=per_step)
        runs[impl] = {"fixed_batch_losses": losses, **window}
        del model, state, step_fn, optimizer
        _v_free()

    # F_bf16's rule: each tensor's relative L2 distance from the f32 einsum
    # path, the flash path's at most 1.25 x the bf16 einsum path's + 2^-10.
    loss_ref, ref = _v_grads(grad_build, loss_of, fixed, dev,
                             torch.float32, "xla")
    errs, grad_losses, launches = {}, {"f32_xla": loss_ref}, {}
    for impl in ("xla", "flash"):
        _zero_launches()
        grad_losses[impl], g = _v_grads(grad_build, loss_of, fixed, dev,
                                        torch.bfloat16, impl)
        launches[impl] = {n: c for n, c in _launch_counts().items() if c}
        errs[impl] = {n: _rel_l2_of(g[n], ref[n]) for n in ref}
        del g
    share = {n: errs["flash"][n] / (BF16_STEP_RATIO * errs["xla"][n]
                                    + BF16_STEP_FLOOR) for n in ref}
    name = max(share, key=share.get)
    rule = {"losses": grad_losses, "launches": launches,
            "worst_share": share[name], "worst_param": name,
            "flash_rel_l2": errs["flash"][name],
            "xla_rel_l2": errs["xla"][name], "ratio": BF16_STEP_RATIO,
            "floor": BF16_STEP_FLOOR}
    del ref
    _v_free()
    check(launches["flash"] == _v_flash_per_step(layers, "wgmma")
          and not launches["xla"],
          f"{phase} gradient step launches by route: {launches}")
    check(share[name] <= 1.0,
          f"{phase}: {name}'s bf16 flash gradient is further from the f32 "
          f"einsum path than {BF16_STEP_RATIO} x the bf16 einsum path's + "
          f"{BF16_STEP_FLOOR}: {errs['flash'][name]} against "
          f"{errs['xla'][name]}")
    return runs, rule


def _v2(dev) -> dict:
    """BERT-base MLM at its published width and depth, seq 512, batch 16
    (8,192 tokens a step), masked by ``mask_tokens``."""
    from k8s_distributed_deeplearning_torch.models import bert, transformer
    from k8s_distributed_deeplearning_torch.train import data as data_lib

    batch, seq = 16, 512
    cfg = bert.config_bert_base()
    tokens = data_lib.synthetic_tokens(1 << 17, vocab_size=cfg.vocab_size,
                                       seed=0)
    batcher = data_lib.TokenBatcher(tokens, batch, seq, seed=0)
    masked = [_v_masked(batcher.batch_at(i)["tokens"], cfg.vocab_size, i)
              for i in range(V_WARM + V_TIMED + 2)]

    def batches(start):
        return (masked[(start + i) % len(masked)] for i in range(1 << 30))

    def build(dtype, impl):
        return bert.BertMLM(bert.config_bert_base(
            dtype=dtype, param_dtype=torch.float32, attention_impl=impl),
            device=dev, seed=0)

    def loss_of(model):
        return lambda b, g: bert.loss_fn(model, b, g)

    runs, rule = _v_encoder(
        "V2", dev, build, loss_of, masked[0], batches,
        examples=batch * seq,
        flops_example=transformer.flops_per_token(cfg, seq_len=seq),
        layers=cfg.n_layers, grad_build=build)
    result = {"phase": "V2", "model": "bert-base", "layers": cfg.n_layers,
              "batch": batch, "seq_len": seq, "dtype": "bfloat16",
              "lr": V_LR, "tokens_per_step": batch * seq,
              "masked_per_step": float(masked[0]["weights"].sum()),
              "runs": {k: {**v, "tokens_per_s": v["per_s"]}
                       for k, v in runs.items()},
              "bf16_grad_rule": rule}
    log(result)
    return result


def _v_vit(dev, dtype, impl, layers=None, random_head=False):
    """ViT-L/16 at 224² (1000 classes) from seed 0; ``random_head`` draws
    the head from the seed (its zero init leaves every encoder gradient
    exactly 0 at the first step)."""
    from k8s_distributed_deeplearning_torch.models import vit

    over = {} if layers is None else {"n_layers": layers}
    model = vit.ViT(vit.config_vit_l16(dtype=dtype,
                                       param_dtype=torch.float32,
                                       attention_impl=impl, **over),
                    patch_size=16, num_classes=1000, image_size=224,
                    device=dev, seed=0)
    if random_head:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        with torch.no_grad():
            model.head.weight.normal_(0.0, 0.02, generator=gen)
    return model


def _v3(dev) -> dict:
    """ViT-L/16 at its published width and depth, 224² (197 tokens:
    no flash tile divides it), batch 32."""
    from k8s_distributed_deeplearning_torch.models import vit
    from k8s_distributed_deeplearning_torch.train import data as data_lib

    batch = 32
    x, y = data_lib.synthetic_images(128, size=224, num_classes=1000, seed=1)
    batcher = data_lib.ShardedBatcher(x, y, batch, seed=0)

    def loss_of(model):
        return lambda b, g: vit.loss_fn(model, b, g)

    cfg = vit.config_vit_l16()
    shape = types.SimpleNamespace(cfg=cfg, patch_size=16, num_classes=1000)
    runs, rule = _v_encoder(
        "V3", dev, lambda dt, impl: _v_vit(dev, dt, impl), loss_of,
        batcher.batch_at(0), batcher.iter_from, examples=batch,
        flops_example=vit.flops_per_image(shape, image_size=224),
        layers=cfg.n_layers,
        grad_build=lambda dt, impl: _v_vit(dev, dt, impl, random_head=True))
    result = {"phase": "V3", "model": "vit-l16", "layers": cfg.n_layers,
              "image_size": 224, "tokens": 197, "batch": batch,
              "dtype": "bfloat16", "lr": V_LR,
              "runs": {k: {**v, "images_per_s": v["per_s"]}
                       for k, v in runs.items()},
              "bf16_grad_rule": rule}
    log(result)
    return result


def _v4_run(build, loss_of, batches, keep_on) -> dict:
    """One path of V4: phase F's record (:func:`_recorded_steps`) of
    ``V_F32_STEPS`` AdamW steps in f32 from the seeded weights."""
    from k8s_distributed_deeplearning_torch.parallel import (
        data_parallel as dp)
    from k8s_distributed_deeplearning_torch.train import optim

    model = build()
    optimizer = optim.make_optimizer("adamw", 1e-4, grad_clip=1.0)
    state = dp.init_state(dict(model.named_parameters()), optimizer)
    out = _recorded_steps(optimizer, state,
                          dp.make_train_step(loss_of(model), optimizer),
                          batches.__getitem__, V_F32_STEPS, keep_on)
    del model, state, optimizer
    _v_free()
    return out


def _v4(dev) -> dict:
    """f32 on the card (TF32 off): BERT-base and ViT-L widths at 2 layers,
    three AdamW steps through ``"flash"`` (the tf32x3 kernels) and through
    the einsum path from the same weights, held by phase F's rule."""
    from k8s_distributed_deeplearning_torch.models import bert, vit
    from k8s_distributed_deeplearning_torch.train import data as data_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layers = 2
    bcfg = bert.config_bert_base()
    tokens = data_lib.synthetic_tokens(1 << 15, vocab_size=bcfg.vocab_size,
                                       seed=3)
    tb = data_lib.TokenBatcher(tokens, 4, 512, seed=3)
    x, y = data_lib.synthetic_images(24, size=224, num_classes=1000, seed=3)
    cases = {
        "bert_base_2_layers": (
            lambda impl: bert.BertMLM(bert.config_bert_base(
                n_layers=layers, dtype=torch.float32,
                param_dtype=torch.float32, attention_impl=impl),
                device=dev, seed=0),
            lambda m: (lambda b, g: bert.loss_fn(m, b, g)),
            [_v_masked(tb.batch_at(i)["tokens"], bcfg.vocab_size, i)
             for i in range(V_F32_STEPS)], "B 4 x S 512"),
        "vit_l16_2_layers": (
            lambda impl: _v_vit(dev, torch.float32, impl, layers=layers,
                                random_head=True),
            lambda m: (lambda b, g: vit.loss_fn(m, b, g)),
            [{"image": x[8 * i:8 * i + 8], "label": y[8 * i:8 * i + 8]}
             for i in range(V_F32_STEPS)], "B 8 at 224², S 197")}
    out = {}
    for name, (build, loss_of, batches, shape) in cases.items():
        _zero_launches()
        ka = _v4_run(lambda: build("flash"), loss_of, batches,
                     torch.device("cpu"))
        launches = _launch_counts()
        _check_f32_flash(f"V4 {name}", launches, layers * V_F32_STEPS)
        kx = _v4_run(lambda: build("xla"), loss_of, batches, dev)
        res = _agreement(f"V4 {name}", {
            "model": name, "shape": shape, "steps": V_F32_STEPS, "lr": 1e-4,
            "kernel_path_launches": {n: c for n, c in launches.items()
                                     if c}}, ka, kx, dev)
        out[name] = {k: res[k] for k in (
            "loss_max_rel_diff", "grad_rel_diff_worst",
            "grad_rel_diff_worst_param", "param_rel_diff_worst",
            "param_rel_diff_worst_param", "kernel_path_launches")}
    log({"phase": "V4", **out})
    return out


def _v5_state(ckdir, step) -> dict:
    """Params and running statistics of the example's checkpoint."""
    state = torch.load(Path(ckdir) / str(step) / "state.pt",
                       weights_only=True)
    return ({f"params/{n}": t for n, t in state["params"].items()}
            | {f"stats/{n}": t for n, t in state["batch_stats"].items()})


def _v5(dev, tmp: Path) -> dict:
    """The example: each small preset through ``main(argv)`` on the card;
    then ``--model resnet18`` as its own process, SIGKILLed past step 20
    and run again (restore at the newest step on disk), against an
    unkilled process by phase N's rule (cuDNN held to deterministic
    algorithms in each)."""
    import contextlib
    import importlib.util
    import io

    from k8s_distributed_deeplearning_torch.utils import ckpt as ckpt_paths

    spec = importlib.util.spec_from_file_location("train_zoo_torch",
                                                  EXAMPLE_ZOO)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    presets = {}
    for model in ("resnet18", "vit", "bert", "moe"):
        buf = io.StringIO()
        _zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            final = example.main([
                "--model", model, "--num-steps", str(V_EXAMPLE_STEPS),
                "--batch-size", "32", "--log-every", "1",
                "--checkpoint-dir", str(tmp / f"v5_{model}")])
        events = [json.loads(line) for line in buf.getvalue().splitlines()
                  if line.startswith("{")]
        steps = [e for e in events if e["event"] == "train_step"]
        start = next(e for e in events if e["event"] == "start")
        presets[model] = {
            "s": time.perf_counter() - t0, "final": final,
            "device": start["device"], "losses": [e["loss"] for e in steps],
            "launches": {n: c for n, c in _launch_counts().items() if c}}
        check(final["num_steps"] == V_EXAMPLE_STEPS
              and len(steps) == V_EXAMPLE_STEPS
              and start["device"].startswith("cuda")
              and all(np.isfinite(e["loss"]) for e in steps),
              f"V5 {model}: {presets[model]}")

    args = ["--model", "resnet18", "--num-steps", str(V_RESUME_STEPS),
            "--batch-size", "32", "--checkpoint-every", "10",
            "--log-every", "5", "--prefetch", "0"]
    code = ("import runpy, sys, torch; "
            "torch.backends.cudnn.deterministic = True; "
            "torch.backends.cudnn.benchmark = False; "
            f"runpy.run_path({str(EXAMPLE_ZOO)!r}, run_name='__main__')")
    env = {**os.environ, "PYTHONPATH": str(REPO),
           "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}

    def proc_run(ckdir, kill_after=None):
        cmd = [sys.executable, "-c", code, *args, "--checkpoint-dir",
               str(ckdir)]
        events = []
        with open(tmp / "v5_stderr.log", "a") as err:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=err,
                                    text=True, cwd=REPO, env=env)
            try:
                for line in proc.stdout:
                    if not line.startswith("{"):
                        continue
                    events.append(json.loads(line))
                    ev = events[-1]
                    if kill_after is not None \
                            and ev["event"] == "train_step" \
                            and ev["step"] >= kill_after:
                        proc.kill()
                        kill_after = None
                proc.wait(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return proc.returncode, events

    def unkilled(ckdir):
        # A process of its own, as the killed run: this one's TF32 and
        # cuDNN settings are not the example's defaults.
        rc, _ = proc_run(ckdir)
        check(rc == 0, f"V5: an unkilled run exited {rc}")
        return _v5_state(ckdir, V_RESUME_STEPS)

    t0 = time.perf_counter()
    rc1, first = proc_run(tmp / "v5_killed", kill_after=V_KILL_AFTER)
    killed_s = time.perf_counter() - t0
    on_disk = [s for s in ckpt_paths.steps_on_disk(str(tmp / "v5_killed"))
               if ckpt_paths.verify_manifest(str(tmp / "v5_killed"), s)
               is None]
    check(rc1 != 0 and on_disk and max(on_disk) < V_RESUME_STEPS,
          f"V5: the killed run exited {rc1} with steps {on_disk} on disk")
    rc2, second = proc_run(tmp / "v5_killed")
    restores = [e["step"] for e in second if e["event"] == "restore"]
    check(rc2 == 0 and restores == [max(on_disk)],
          f"V5: the re-run exited {rc2}, restored {restores}, newest good "
          f"step {max(on_disk)}")
    want = unkilled(tmp / "v5_whole")
    resume = _repeat_rule("V5", want, _v5_state(tmp / "v5_killed",
                                                V_RESUME_STEPS),
                          lambda: unkilled(tmp / "v5_again"))
    result = {"phase": "V5", "presets": presets, "resume": {
        "steps": V_RESUME_STEPS, "killed_after_step": max(
            e["step"] for e in first if e["event"] == "train_step"),
        "killed_run_s": killed_s, "steps_on_disk": on_disk,
        "restored_at": restores[0], **resume}}
    log(result)
    return result


def phase_v(dev, tmp: Path) -> dict:
    """The model zoo at its published widths (V1 ResNet-50, V2 BERT-base,
    V3 ViT-L/16; V4 f32 at 2 layers; V5 the example)."""
    out = {}
    for name, fn in (("V1", _v1), ("V2", _v2), ("V3", _v3), ("V4", _v4)):
        t0 = time.perf_counter()
        out[name] = fn(dev)
        log({"phase_part_done": name, "s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    out["V5"] = _v5(dev, tmp)
    log({"phase_part_done": "V5", "s": time.perf_counter() - t0})
    return out


# ------------------------------------------------------------- phase U

# U1's and U2's controller policy, on a clock the phase steps: one
# second a control round.
U_POLICY = dict(min_replicas=1, max_replicas=3, interval_s=0.0,
                up_cooldown_s=2.0, down_cooldown_s=4.0, sustain_rounds=1)
U_ARRIVALS = 2         # U1: B's requests arrive two a gateway iteration
U_MEM_SLACK_GB = 2.0   # U1: peak growth allowed beyond the added KV pools
U2_NEW = 16
U2_TENANTS = json.dumps({"tenants": [{"id": "chat",
                                      "priority": "interactive"},
                                     {"id": "bulk", "priority": "batch"}]})
U3_REQUESTS = 16       # 12 before the scale-up, 4 after
U4_STEPS = 60          # MNIST steps a run (batch 100, phase N's set)
U4_CKPT_EVERY = 10
U4_STALL_STEP = 25     # rank 0 stalls here (600 s) ...
U4_KILL_S = 30.0       # ... and the executor SIGKILLs it this long after
#                        spawn: past its step-20 checkpoint
U5_STORM = ["--seed", "6", "--steps", "48", "--preset", "tiny",
            "--autoscale"]


class _UEvents:
    """A ``MetricsLogger``-shaped event sink: (event, fields) in order."""

    def __init__(self):
        self.events = []

    def emit(self, event, **fields):
        self.events.append((event, fields))

    def names(self):
        return [e for e, _ in self.events]


def _count_calls(eng, calls):
    """Count ``eng``'s target prefill chunks and decode iterations in
    ``calls`` (a draft's prefill is not the target's)."""
    prefill, decode = eng._prefill, eng._decode_step

    def prefill_wrapper(*a, **kw):
        if not kw.get("draft"):
            calls["_prefill"] += 1
        return prefill(*a, **kw)

    def decode_wrapper(*a, **kw):
        calls["_decode_step"] += 1
        return decode(*a, **kw)

    eng._prefill, eng._decode_step = prefill_wrapper, decode_wrapper


def _pool_bytes(eng) -> int:
    return sum(t.numel() * t.element_size()
               for layer in eng._cache for t in layer)


def _u_round(ctl, clk, decisions, ms):
    """One control round at the next second of the phase's clock, timed
    (synchronized both sides); a non-hold decision is kept, and a round
    that retires a drained replica (remove and stop) is timed as
    ``finalize``."""
    clk[0] += 1.0
    pending = ctl.snapshot()["pending_removals"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = ctl.control_round(clk[0])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) * 1e3
    if d["decision"] != "hold":
        decisions.append(d)
        ms.setdefault(d["decision"], []).append(dt)
    elif ctl.snapshot()["pending_removals"] < pending:
        ms.setdefault("finalize", []).append(dt)
    return d


def _u1(dev, b_logits, started):
    """U1: phase B's workload through a ``ServeGateway`` and a
    ``FleetController`` over an ``EngineFactoryBackend`` at full Llama-3
    8B (bf16, seed 0): every replica an engine with B's settings on one
    shared model."""
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.serve import ServeEngine
    from k8s_distributed_deeplearning_torch.serve.autoscale import (
        EngineFactoryBackend, FleetController)
    from k8s_distributed_deeplearning_torch.serve.gateway import (
        ServeGateway)
    from k8s_distributed_deeplearning_torch.utils.metrics import (
        ServingStats)

    cfg = llama.config_llama3_8b(max_seq_len=2048, n_layers=SERVE_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    model = llama.LlamaLM(cfg, device=dev, seed=0)
    engines, counts, calls, logits = {}, {}, {}, {}
    acc = {"_decode_step": 0.0}

    def make():
        rid = f"r{len(engines)}"
        eng = ServeEngine(model, num_slots=4, prefill_chunk_tokens=512,
                          device=dev, replica_id=rid)
        counts[rid] = {}
        calls[rid] = {"_prefill": 0, "_decode_step": 0}
        _first_logits(eng, logits, keep_first=True)
        _count_step_routes(eng, counts[rid])
        _timed(eng, "_decode_step", acc)
        _count_calls(eng, calls[rid])
        engines[rid] = eng
        return eng

    stats, events = ServingStats(), _UEvents()
    gw = ServeGateway([make()], stats=stats, logger=events)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    clk = [0.0]
    ctl = FleetController(gw, EngineFactoryBackend(make), logger=events,
                          clock=lambda: clk[0], **U_POLICY)
    reqs = _requests(cfg.vocab_size, 32, sampled=True)
    feed = list(_copy(reqs))
    outs, decisions, ms = [], [], {}
    most = 1
    t0 = time.perf_counter()
    for _ in range(4000):
        for _ in range(U_ARRIVALS):
            if feed:
                gw.submit(feed.pop(0))
        outs.extend(gw.step())
        _u_round(ctl, clk, decisions, ms)
        most = max(most, len(gw.replica_ids()))
        snap = ctl.snapshot()
        if (not feed and not gw.busy() and snap["actual_replicas"] == 1
                and snap["pending_removals"] == 0
                and len(gw.replica_ids()) == 1):
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    kinds = [d["decision"] for d in decisions]
    check(len(outs) == 8 and all(o.finish_reason == "length"
                                 and len(o.tokens) == 32 for o in outs),
          f"U1: {[(o.request_id, o.finish_reason, len(o.tokens)) for o in outs]}")
    check(most <= 3 and "up" in kinds and "down" in kinds
          and len(gw.replica_ids()) == 1,
          f"U1 decisions {kinds}, at most {most} replicas, ends with "
          f"{gw.replica_ids()}")
    layers = cfg.n_layers
    want = {rid: {"decode": layers * c["_decode_step"],
                  "prefill": layers * c["_prefill"], "tf32x3": 0,
                  "split": 0, "int8": 0} for rid, c in calls.items()}
    check(all(counts[rid].get(k, 0) == v for rid in want
              for k, v in want[rid].items())
          and sum(c["_prefill"] for c in calls.values()) > 0,
          f"U1 launches by engine and route {counts}: want {want}")
    rids = sorted(b_logits)
    decided, same = _first_token_rule(
        torch.cat([logits[r] for r in rids]),
        torch.cat([b_logits[r].to(dev) for r in rids]))
    check(bool(same[decided].all()),
          "U1: a first token differs from B's where the margin decides it")
    added = sum(_pool_bytes(e) for rid, e in engines.items() if rid != "r0")
    growth = peak - base
    check(growth <= added + U_MEM_SLACK_GB * 2 ** 30,
          f"U1: peak memory grew {growth / 2 ** 30:.2f} GiB, more than the "
          f"added engines' KV pools ({added / 2 ** 30:.2f} GiB) + "
          f"{U_MEM_SLACK_GB} GiB: are the weights copied?")
    decode_tokens = sum(e.stats.decode_tokens for e in engines.values())
    result = {
        "phase": "U1", "model": "llama3-8b", "layers": layers,
        "dtype": "bfloat16", "slots": 4, "prefill_chunk_tokens": 512,
        "requests": 8, "policy": U_POLICY, "arrivals_per_iteration":
        U_ARRIVALS, "decisions": decisions, "engines_built": len(engines),
        "most_replicas": most, "actuation_ms": ms,
        "migrations": stats.gateway_migrations, "wall_s": wall,
        "decode_tokens_per_s": decode_tokens / acc["_decode_step"],
        "route_launches": counts, "calls": calls,
        "first_token_decided": decided.tolist(),
        "first_token_equal": same.tolist(),
        "kv_pool_gb_per_engine": _pool_bytes(engines["r0"]) / 2 ** 30,
        "peak_growth_gb": growth / 2 ** 30,
        "added_pools_gb": added / 2 ** 30,
        "events": [e for e in events.names() if e.startswith(
            ("autoscale_", "gateway_replica_"))]}
    for rid, eng in engines.items():
        result[f"{rid}_pages_after"] = _clean_after(eng, f"U1 {rid}")
    result["since_start_s"] = time.perf_counter() - started
    log(result)
    del model, engines, gw, ctl
    gc.collect()
    torch.cuda.empty_cache()
    return result


def _u2_requests(vocab):
    from k8s_distributed_deeplearning_torch.serve import Request

    rng = np.random.default_rng(2)
    return [Request(prompt=rng.integers(0, vocab, int(n)).astype(np.int32),
                    max_new_tokens=U2_NEW, request_id=f"u{i}",
                    tenant="chat")
            for i, n in enumerate(rng.integers(100, 1501, 13))]


def _u2(dev, started):
    """U2: R2's f32 model (8B width, 4 layers) behind the controller: a
    scale-up mid-stream, the brownout ladder walked up at max and unwound,
    a replica killed through ``gateway_dispatch`` and replaced, drains on
    the way down; every stream against a unified engine's."""
    from k8s_distributed_deeplearning_torch import faults
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.ops import paged_attn
    from k8s_distributed_deeplearning_torch.serve import (
        QueueFull, Request, ServeEngine, parse_tenants)
    from k8s_distributed_deeplearning_torch.serve.autoscale import (
        EngineFactoryBackend, FleetController, K8sParallelismBackend)
    from k8s_distributed_deeplearning_torch.serve.gateway import (
        ServeGateway)
    from k8s_distributed_deeplearning_torch.utils.metrics import (
        ServingStats)

    class NewestFirst(EngineFactoryBackend):
        # A Job controller's victim: the highest replica index (the
        # newest engine, which is still decoding when the fleet shrinks).
        victim_rid = K8sParallelismBackend.victim_rid

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    attn = paged_attn.paged_decode_attention
    cfg = llama.config_llama3_8b(max_seq_len=2048, n_layers=4,
                                 dtype=torch.float32)
    model = llama.LlamaLM(cfg, device=dev, seed=0)
    tenants = parse_tenants(U2_TENANTS)
    reqs = _u2_requests(cfg.vocab_size)
    _zero_counts(attn)
    ref = ServeEngine(model, num_slots=4, prefill_chunk_tokens=512,
                      device=dev, tenants=tenants)
    oracle = {o.request_id: o.tokens for o in ref.run(_copy(reqs))}
    ref_routes = _route_counts(attn)
    _clean_after(ref, "U2 unified")
    # The fleet's launches from here on, counted apart from the reference's.
    _zero_counts(attn)
    engines, counts, calls = {}, {}, {}

    def make():
        rid = f"r{len(engines)}"
        eng = ServeEngine(model, num_slots=2, prefill_chunk_tokens=512,
                          device=dev, tenants=tenants, replica_id=rid)
        counts[rid] = {}
        calls[rid] = {"_prefill": 0, "_decode_step": 0}
        _count_step_routes(eng, counts[rid])
        _count_calls(eng, calls[rid])
        engines[rid] = eng
        return eng

    stats, events = ServingStats(), _UEvents()
    gw = ServeGateway([make(), make()], stats=stats, logger=events,
                      failures_to_trip=1, hedge_after_s=600.0)
    clk = [0.0]
    ctl = FleetController(
        gw, NewestFirst(make), logger=events, clock=lambda: clk[0],
        **{**U_POLICY, "up_cooldown_s": 1.0, "down_cooldown_s": 1.0,
           "unhealthy_rounds": 1})
    decisions, ms, outs = [], {}, []
    refused = {}
    feed = _copy(reqs)
    for r in feed[:8]:                 # 8 on 4 slots: load 2.0 a slot
        gw.submit(r)
    for _ in range(2):
        outs.extend(gw.step())
    up = _u_round(ctl, clk, decisions, ms)
    for r in feed[8:12]:               # 12 on 6 slots: over at the ceiling
        gw.submit(r)
    outs.extend(gw.step())
    ladder = []
    for _ in range(3):
        d = _u_round(ctl, clk, decisions, ms)
        ladder.append((d["decision"], d.get("stage")))
        if d.get("stage") == "shed_batch":
            try:
                gw.submit(Request(prompt=[1, 2, 3], max_new_tokens=2,
                                  tenant="bulk", request_id="bulk0"))
                refused["bulk"] = None
            except QueueFull as e:
                refused["bulk"] = str(e)
            gw.submit(feed[12])        # chat still admitted under shed
            refused["chat"] = None
        levers = (gw.shed_classes, gw.hedge_after_s, gw.max_live_requests)
        ladder.append(repr(levers))
    # r0 dies mid-decode: its requests migrate, the controller replaces it.
    faults.activate(faults.FaultPlan((faults.Fault(
        site="gateway_dispatch", action="ioerror", step=0,
        attempt=None),)))
    try:
        outs.extend(gw.step())
    finally:
        fired = list(faults.active().fired)
        faults.deactivate()
    most = len(gw.replica_ids())
    for _ in range(4000):
        outs.extend(gw.step())
        _u_round(ctl, clk, decisions, ms)
        most = max(most, len(gw.replica_ids()))
        snap = ctl.snapshot()
        if (not gw.busy() and snap["brownout_level"] == 0
                and snap["actual_replicas"] == 1
                and snap["pending_removals"] == 0
                and len(gw.replica_ids()) == 1):
            break
    kinds = [d["decision"] for d in decisions]
    names = events.names()
    routes = _route_counts(attn)
    streams = {o.request_id: o.tokens for o in outs}
    result = {
        "phase": "U2", "model": "llama3-8b width, 4 layers",
        "dtype": "float32", "slots": 2, "requests": len(reqs),
        "first_round": up["decision"], "ladder": ladder,
        "refused_under_shed": refused, "kill_fired": fired,
        "decisions": kinds, "most_replicas": most,
        "engines_built": len(engines),
        "migrations": stats.gateway_migrations,
        "page_exports": sum(e.stats.disagg_exports
                            for e in engines.values()),
        "streams_equal": {r: streams.get(r) == oracle[r] for r in oracle},
        "route_launches": routes, "route_launches_by_engine": counts,
        "calls": calls, "unified_route_launches": ref_routes,
        "actuation_ms": ms,
        "events": [e for e in names if e.startswith("autoscale_")]}
    log(result)
    check(up["decision"] == "up" and [x for x in ladder
                                      if isinstance(x, tuple)] == [
        ("brownout", "shed_batch"), ("brownout", "no_hedge"),
        ("brownout", "tight_admission")],
          f"U2: first round {up['decision']}, ladder {ladder}")
    check(refused.get("bulk") is not None
          and "is shed (brownout)" in refused["bulk"]
          and "chat" in refused, f"U2 shed_batch refusals: {refused}")
    check(len(streams) == len(reqs)
          and all(result["streams_equal"].values()),
          f"U2 streams against the unified engine: "
          f"{result['streams_equal']}")
    check("replace" in kinds and "restore" in kinds and "down" in kinds
          and most <= 3 and stats.gateway_migrations >= 1
          and result["page_exports"] >= 1,
          f"U2 decisions {kinds}, at most {most} replicas, migrations "
          f"{stats.gateway_migrations}, requests drained by their pages "
          f"{result['page_exports']}")
    check(names.count("autoscale_brownout") == 3
          and names.count("autoscale_restored") == 1
          and names.index("autoscale_restored") > max(
              i for i, n in enumerate(names) if n == "autoscale_brownout"),
          f"U2 events {result['events']}")
    check((gw.shed_classes, gw.hedge_after_s, gw.max_live_requests)
          == (frozenset(), 600.0, None), "U2: the levers are not restored")
    layers = cfg.n_layers
    want = {rid: {"tf32x3": layers * (c["_prefill"] + c["_decode_step"]),
                  "decode": 0, "prefill": 0, "split": 0, "int8": 0}
            for rid, c in calls.items()}
    check(all(counts[rid].get(k, 0) == v for rid in want
              for k, v in want[rid].items())
          and routes == {k: sum(w[k] for w in want.values())
                         for k in routes}
          and sum(c["_prefill"] for c in calls.values()) > 0,
          f"U2 launches by engine and route {counts} (in all {routes}): "
          f"want {want}, every paged launch on tf32x3")
    for rid, eng in engines.items():
        _clean_after(eng, f"U2 {rid}")
    result["since_start_s"] = time.perf_counter() - started
    del model, engines, gw, ctl
    gc.collect()
    torch.cuda.empty_cache()
    return result


def _logged_process_backend(log_dir: Path, **kw):
    """A ``LocalProcessBackend`` that keeps each child's output in
    ``log_dir/replica-<rank>.log`` and each child's exit code, by replica
    id, in ``returncodes`` (the backend itself discards both)."""
    from unittest import mock

    from k8s_distributed_deeplearning_torch.serve.autoscale import (
        LocalProcessBackend)

    class Logged(LocalProcessBackend):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.returncodes = {}
            self._all = {}

        def start_replica(self):
            log_dir.mkdir(parents=True, exist_ok=True)
            popen = subprocess.Popen
            with open(log_dir / f"replica-{self._next_rank}.log", "w") as f:
                def logged(cmd, **_):
                    return popen(cmd, stdout=f, stderr=subprocess.STDOUT)

                with mock.patch.object(subprocess, "Popen", logged):
                    client = super().start_replica()
            self._all[client.replica_id] = self._procs[client.replica_id]
            return client

        def _record(self):
            self.returncodes = {rid: p.returncode
                                for rid, p in sorted(self._all.items())}

        def stop_replica(self, rid, engine):
            super().stop_replica(rid, engine)
            self._record()

        def reap_all(self):
            super().reap_all()
            self._record()

    return Logged(**kw)


def _u3(started, tmp: Path):
    """U3: ``LocalProcessBackend`` spawns the port's replica servers on the
    card (``launch serve --replica-server``, the serve CLI's small preset)
    and the controller takes the fleet from 1 to 2 and back to 1;
    ``heartbeat_discoverer`` finds each new server once."""
    from k8s_distributed_deeplearning_torch.serve import Request
    from k8s_distributed_deeplearning_torch.serve.autoscale import (
        FleetController, heartbeat_discoverer)
    from k8s_distributed_deeplearning_torch.serve.gateway import (
        ServeGateway)
    from k8s_distributed_deeplearning_torch.utils.metrics import (
        MetricsLogger, ServingStats)

    hb, logs = tmp / "u3_hb", tmp / "u3_logs"
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = str(REPO)
    # Each load read scrapes the server's /metrics afresh: the controller
    # must see the queue the submissions built, not a cached snapshot.
    backend = _logged_process_backend(
        logs, heartbeat_dir=str(hb), preset="small", slots=4,
        client_kwargs={"health_refresh_s": 0.0})
    discover = heartbeat_discoverer(str(hb), stale_after_s=None)
    summary_path = tmp / "u3_events.jsonl"
    t0 = time.perf_counter()
    found, decisions, ms, outs = [], [], {}, []
    try:
        first = backend.start_replica()
        spawn_s = [time.perf_counter() - t0]
        found.append([c.endpoint for c in discover([])])
        stats = ServingStats()
        with open(summary_path, "w") as f:
            logger = MetricsLogger(stream=f, job="u3")
            gw = ServeGateway([first], stats=stats, logger=logger)
            clk = [0.0]
            ctl = FleetController(gw, backend, logger=logger,
                                  clock=lambda: clk[0],
                                  **{**U_POLICY, "max_replicas": 2})
            rng = np.random.default_rng(3)
            reqs = [Request(prompt=rng.integers(0, 32000, 64).astype(
                np.int32), max_new_tokens=16, request_id=f"w{i}")
                for i in range(U3_REQUESTS)]
            for r in reqs[:12]:        # 12 on 4 slots: load 3.0 a slot
                gw.submit(r)
            t1 = time.perf_counter()
            _u_round(ctl, clk, decisions, ms)
            spawn_s.append(time.perf_counter() - t1)
            found.append([c.endpoint for c in discover([])])
            found.append([c.endpoint for c in discover([])])
            for r in reqs[12:]:        # the newcomer can take these
                gw.submit(r)
            routed = {rid: gw.replica_engine(rid).load()
                      for rid in gw.replica_ids()}
            deadline = time.perf_counter() + 300
            while time.perf_counter() < deadline:
                outs.extend(gw.step())
                if not gw.busy():
                    # Idle: the control rounds drain one server out.
                    _u_round(ctl, clk, decisions, ms)
                    snap = ctl.snapshot()
                    if (snap["actual_replicas"] == 1
                            and snap["pending_removals"] == 0
                            and len(gw.replica_ids()) == 1):
                        break
                time.sleep(0.005)
            logger.emit("autoscale_summary", **ctl.snapshot())
            last = gw.replica_ids()[0]
            backend.stop_replica(last, gw.replica_engine(last))
            logger.close()
    finally:
        backend.reap_all()
        if old is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = old
    drained = {p.name: p.read_text().count('"event": "replica_drained"')
               for p in sorted(logs.glob("replica-*.log"))}
    events = [json.loads(line) for line in summary_path.read_text()
              .splitlines()]
    summ = [e for e in events if e["event"] == "autoscale_summary"]
    result = {"phase": "U3", "preset": "small", "decisions":
              [d["decision"] for d in decisions],
              "discovered": found, "spawn_s": spawn_s,
              "requests_finished": len(outs),
              "finish_reasons": sorted({o.finish_reason for o in outs}),
              "routed_after_up": routed,
              "returncodes": backend.returncodes,
              "replica_drained": drained, "actuation_ms": ms,
              "autoscale_summary": summ[-1] if summ else None,
              "wall_s": time.perf_counter() - t0,
              "since_start_s": time.perf_counter() - started}
    log(result)
    check(found[0] == [first.endpoint] and len(found[1]) == 1
          and found[1] != found[0] and found[2] == [],
          f"U3 discovery: {found}")
    check(result["decisions"][:1] == ["up"] and "down" in result["decisions"]
          and len(outs) == U3_REQUESTS
          and result["finish_reasons"] == ["length"], f"U3: {result}")
    check(backend.returncodes == {"r0": 0, "r1": 0}
          and list(drained.values()) == [1, 1] and summ,
          f"U3 children: exit codes {backend.returncodes}, "
          f"replica_drained {drained}, autoscale_summary {bool(summ)}")
    return result


def _u4(started, tmp: Path):
    """U4: ``launch render``/``validate`` of the GPU manifests; then the
    MNIST worker script through the rendered job on the card, one
    worker: a run whole, and a run whose rank 0 the ``executor`` fault
    SIGKILLs after its first checkpoint, restarted by ``run_elastic``."""
    import io
    import threading
    from contextlib import redirect_stdout

    from k8s_distributed_deeplearning_torch.config import JobConfig
    from k8s_distributed_deeplearning_torch.launch import __main__ as launch
    from k8s_distributed_deeplearning_torch.launch import elastic
    from k8s_distributed_deeplearning_torch.utils import ckpt as ckpt_paths

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc_render = launch.main(["render", "--workers", "2",
                                 "--serve-replicas", "2", "--storm-steps",
                                 "10", "--", "--num-steps", "600"])
        rc_validate = launch.main(["validate", "--workers", "2",
                                   "--serve-replicas", "2"])
    text = buf.getvalue()
    check(rc_render == rc_validate == 0 and "nvidia.com/gpu" in text
          and "google.com/tpu" not in text
          and "offline validation: OK" in text,
          f"U4 render {rc_render}, validate {rc_validate}: {text[-500:]}")

    def args(ck):
        return ["--num-steps", str(U4_STEPS), "--batch-size", "100",
                "--checkpoint-dir", str(ck), "--checkpoint-every",
                str(U4_CKPT_EVERY), "--log-every", "10", "--no-eval"]

    env = {"PYTHONPATH": str(REPO)}
    whole, killed = tmp / "u4_whole", tmp / "u4_killed"
    unkilled = {}

    def run_whole():
        t = time.perf_counter()
        unkilled["proc"] = subprocess.run(
            [sys.executable, "-m", "k8s_distributed_deeplearning_torch.launch",
             "run-local", "--workers", "1", "--max-restarts", "1",
             "--timeout", "300", "--"] + args(whole),
            cwd=str(REPO), capture_output=True, text=True, timeout=400,
            env=dict(os.environ, **env))
        unkilled["s"] = time.perf_counter() - t

    th = threading.Thread(target=run_whole)
    th.start()
    plan = json.dumps({"faults": [
        {"site": "step", "action": "stall", "rank": 0,
         "step": U4_STALL_STEP, "seconds": 600},
        {"site": "executor", "action": "exit", "rank": 0,
         "seconds": U4_KILL_S}]})
    on_disk = []
    t0 = time.perf_counter()
    try:
        res, restarts = elastic.run_elastic(
            JobConfig(num_workers=1, fault_plan=plan,
                      script_args=args(killed)),
            max_restarts=1, timeout=300, cwd=str(REPO), extra_env=env,
            checkpoint_dir=str(killed),
            on_restart=lambda n, c: on_disk.append(
                ckpt_paths.latest_step_on_disk(str(killed))))
    finally:
        th.join()
    elastic_s = time.perf_counter() - t0
    proc = unkilled["proc"]
    check(proc.returncode == 0, f"U4 unkilled run-local exit "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    ev = [json.loads(line) for line in res[0].stdout.splitlines()
          if line.startswith("{")]
    restore = [e["step"] for e in ev if e["event"] == "restore"]
    check(restarts == 1 and res[0].returncode == 0 and on_disk
          and on_disk[0] is not None and on_disk[0] >= U4_CKPT_EVERY
          and restore == on_disk,
          f"U4: restarts {restarts}, exit {res[0].returncode}, newest step "
          f"on disk at the restart {on_disk}, restored at {restore}")

    def state(d):
        return _tensor_leaves(torch.load(Path(d) / str(U4_STEPS) /
                                         "state.pt", weights_only=True))

    def again():
        ck = tmp / "u4_again"
        (r,) = elastic.run_elastic(JobConfig(num_workers=1,
                                             script_args=args(ck)),
                                   timeout=300, cwd=str(REPO),
                                   extra_env=env)[0]
        check(r.returncode == 0, f"U4 repeat exit {r.returncode}")
        return state(ck)

    rule = _repeat_rule("U4", state(whole), state(killed), again)
    result = {"phase": "U4", "workers": 1, "steps": U4_STEPS,
              "checkpoint_every": U4_CKPT_EVERY,
              "stall_step": U4_STALL_STEP, "kill_after_s": U4_KILL_S,
              "restarts": restarts, "step_on_disk_at_restart": on_disk,
              "restored_at": restore, "elastic_s": elastic_s,
              "unkilled_s": unkilled["s"], "final_params": rule,
              "since_start_s": time.perf_counter() - started}
    log(result)
    return result


def _u5(started, tmp: Path):
    """U5: ``launch storm --autoscale`` at the tiny preset on the card."""
    import io
    from contextlib import redirect_stdout

    from k8s_distributed_deeplearning_torch.launch import __main__ as launch
    from k8s_distributed_deeplearning_torch.ops import paged_attn

    attn = paged_attn.paged_decode_attention
    report = tmp / "u5_report.json"
    _zero_counts(attn)
    t0 = time.perf_counter()
    with redirect_stdout(io.StringIO()):
        rc = launch.main(["storm", *U5_STORM, "--report-json", str(report)])
    doc = json.loads(report.read_text())
    fired = {f"{s}:{a}": sum(1 for x in doc["fired"] if x == [s, a])
             for s, a in sorted({tuple(x) for x in doc["fired"]})}
    routes = _route_counts(attn)
    result = {"phase": "U5", "argv": U5_STORM, "rc": rc,
              "violations": doc["violations"], "fired": fired,
              "submitted": doc["submitted"], "finished": doc["finished"],
              "migrations": doc["migrations"], "route_launches": routes,
              "wall_s": time.perf_counter() - t0,
              "since_start_s": time.perf_counter() - started}
    log(result)
    check(rc == 0 and doc["violations"] == []
          and doc["submitted"] == doc["finished"] > 0
          and any(k.startswith("autoscale_actuate:") for k in fired),
          f"U5: {result}")
    check(routes["tf32x3"] > 0 and routes["split"] == 0,
          f"U5 launches by route {routes}")
    return result


def phase_u(dev, b_logits, started, tmp: Path):
    """The fleet controller and the launch layer on the card: U1 the
    autoscaled gateway at full 8B, U2 its f32 exact gates, U3 replica
    servers spawned and reaped, U4 the launch layer's render, validate
    and elastic restart, U5 the autoscaled soak."""
    return {"u1": _u1(dev, b_logits, started), "u2": _u2(dev, started),
            "u3": _u3(started, tmp), "u4": _u4(started, tmp),
            "u5": _u5(started, tmp)}


# ---------------------------------------------------------------- phase W
# Tensor-parallel serving (serve/tp.py) on the one card: tp=2 is two
# processes on cuda:0 over gloo, this one rank 0 and a follower it
# spawns. Every number of W is gloo through the host on one card, a
# reading of the seam, not a TP speed.

W_LAYERS = 4
W_TIMEOUT_S = 300.0          # every collective of the tp world
W2_CHUNK = 64                # W2's prefill chunk (pages of 32 tokens)
W2_SPEC_K = 4
W2_DRAFT_LAYERS = 2
W4_REQUESTS = 4
# Rank 0 of the CLI holds its shard, its pool and the sampling state;
# the whole model beside them (the small preset's is about 1.4x a
# shard's bytes at tp=2) would put it past this share of rank 1's peak.
W4_PEAK_RATIO = 1.25
# Phase W1's kernel checks on each rank's own pool shard (phase A's
# decode and prefill512 limits: atol, no rtol).
W_CHECK_CASES = {"decode": ([1000, 1200, 1400, 1500], 1),
                 "prefill512": ([1024 + 512], 512)}


def _w_routes(stats: dict, rank: int) -> dict:
    """One rank's paged launches by branch and route, from
    ``TpWorld.stats()`` (split: the launches no other route took)."""
    out = {}
    for branch, sfx in (("fp", ""), ("int8", "_int8")):
        routes = {r: int(stats[f"launches_{r}{sfx}"][rank])
                  for r in ("decode", "prefill", "tf32x3")}
        routes["split"] = int(stats[f"launches{sfx}"][rank]) - sum(
            routes.values())
        out[branch] = routes
    return out


def _w_rank_routes(world, stats, tp: int) -> list:
    return [_w_routes(stats, r) for r in range(world.size if tp else 1)]


def _w_check_shards(eng) -> dict:
    """Every rank's paged kernels held once to their plain versions on
    that rank's own pool shard (its layer 0, after the run: pages that
    hold the run's K/V), at W_CHECK_CASES, under phase A's limits."""
    out = {}
    for name, (lens, sq) in W_CHECK_CASES.items():
        nb = -(-max(lens) // PAGE)
        tables = np.zeros((len(lens), eng.max_blocks), np.int32)
        for i in range(len(lens)):
            tables[i, :nb] = 1 + (np.arange(nb) + i * nb) % (
                eng.pool.num_pages - 1)
        positions = np.stack([np.arange(n - sq, n) for n in lens])
        rows = eng.tp_kernel_check(tables, positions,
                                   atol=TOL[torch.bfloat16], seed=7)
        for rank, (err, share) in enumerate(rows):
            check(np.isfinite(err) and share <= 1.0,
                  f"W1 {name}: rank {rank}'s kernel error {err} uses "
                  f"{share} of phase A's limit on its own pool shard")
        out[name] = {"max_abs_err": [r[0] for r in rows],
                     "tol_share": [r[1] for r in rows]}
    return out


def _w_serve(model, dev, world, tp: int) -> dict:
    """B's workload through a ``tp`` engine on ``model``: the streams,
    the first-token logits, each rank's launches by route (counted from
    0), the timed programs and each rank's peak memory."""
    from k8s_distributed_deeplearning_torch.serve import ServeEngine

    cfg = model.cfg
    world.stats(reset=True)
    t0 = time.perf_counter()
    eng = ServeEngine(model, num_slots=4, prefill_chunk_tokens=512,
                      device=dev, tp=tp)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    store = {}
    _first_logits(eng, store)
    acc = {"_prefill": 0.0, "_decode_step": 0.0}
    for name in acc:
        _timed(eng, name, acc)
    outs = eng.run(_requests(cfg.vocab_size, 32, sampled=True))
    stats = world.stats()
    check(len(outs) == 8 and all(
        o.finish_reason == "length" and len(o.tokens) == 32
        and all(0 <= t < cfg.vocab_size for t in o.tokens)
        for o in outs), f"W tp={tp}: a request did not finish")
    summ = eng.stats.summary()
    chunks = sum(o.prefill_chunks for o in outs)
    want = {"fp": {"decode": cfg.n_layers * summ["decode_steps"],
                   "prefill": cfg.n_layers * chunks, "tf32x3": 0,
                   "split": 0},
            "int8": {"decode": 0, "prefill": 0, "tf32x3": 0, "split": 0}}
    ranks = _w_rank_routes(world, stats, tp)
    check(all(r == want for r in ranks),
          f"W tp={tp}: launches by rank {ranks}, want each {want}")
    return {"engine": eng, "logits": store,
            "streams": {o.request_id: list(o.tokens) for o in outs},
            "reading": {
                "tp": tp, "setup_s": setup_s, "route_launches": ranks,
                "decode_iterations": summ["decode_steps"],
                "prefill_chunks": chunks,
                "decode_tokens_per_s": (eng.stats.decode_tokens
                                        / acc["_decode_step"]),
                "decode_iteration_ms": (acc["_decode_step"]
                                        / summ["decode_steps"] * 1e3),
                "prefill_chunk_ms": acc["_prefill"] / chunks * 1e3,
                "peak_memory_gb_by_rank": [
                    b / 2 ** 30 for b in stats["peak_bytes"][:max(tp, 1)]]}}


def _w1(model, dev, world) -> tuple[dict, dict]:
    """B's workload at 8B width and W_LAYERS layers in bf16, tp=0 and
    tp=2: each rank's launches equal the tp=0 engine's route by route,
    first-token logits by phase C's rule, kernels held on each rank's
    shard; streams, tokens/s, decode ms and peak memory are readings.
    Returns the result and the tp=0 run (phase W3's reference)."""
    runs = {tp: _w_serve(model, dev, world, tp) for tp in (0, 2)}
    eng = runs[2]["engine"]
    check(eng.tp_consistency_check(),
          "W1: the ranks' last logits are not bit-equal")
    runs[2]["reading"]["kernel_checks"] = _w_check_shards(eng)
    world.stats(reset=True)
    runs[2]["reading"]["decode_profile"] = decode_profile("W1 tp=2", eng,
                                                          W_LAYERS)
    eng.close()
    for run in runs.values():
        del run["engine"]
    gc.collect()
    # B's requests only: the decode profile's own admissions were kept too.
    logits = {tp: torch.stack([runs[tp]["logits"][k][0]
                               for k in sorted(runs[tp]["streams"])])
              for tp in runs}
    streams = {tp: runs[tp]["streams"] for tp in runs}
    kern, ref = logits[2], logits[0]
    rel = ((kern - ref).norm(dim=-1) / ref.norm(dim=-1)).tolist()
    decided, same = _first_token_rule(kern, ref)
    check(all(np.isfinite(rel)) and max(rel) <= BF16_LOGIT_RTOL,
          f"W1: first-token logits relative L2 {max(rel)} > "
          f"{BF16_LOGIT_RTOL}")
    check(bool(same[decided].all()),
          "W1: a first greedy token differs where tp=0's top-2 margin "
          "exceeds twice the largest logit difference")
    result = {"phase": "W1", "model": "llama3-8b width", "layers": W_LAYERS,
              "dtype": "bfloat16", "backend": world.backend,
              "note": "tp=2 is two processes on one card, gloo through "
                      "the host: a reading of the seam, not a TP speed; "
                      "rank 0's peak memory includes this script's whole "
                      "model, which the tp=0 reference runs",
              "runs": {tp: runs[tp]["reading"] for tp in runs},
              "first_token_logit_rel_l2": rel,
              "first_token_decided": decided.tolist(),
              "first_token_equal": same.tolist(),
              "streams_equal": sum(streams[0][k] == streams[2][k]
                                   for k in streams[0]),
              "streams": len(streams[0])}
    log(result)
    return result, runs[0]


def _w_mixed_reqs(vocab, tag="r", greedy=False):
    """JAX's ``_mixed_reqs`` at page scale: greedy and sampled
    alternating, two sharing a 64-token prefix (two whole pages for the
    trie), tails that cross W2_CHUNK."""
    from k8s_distributed_deeplearning_torch.serve import (Request,
                                                          SamplingParams)

    rng = np.random.default_rng(5)
    shared = rng.integers(1, vocab, size=64).astype(np.int32)
    reqs = []
    for i, n in enumerate((7, 90, 134, 40)):
        tail = rng.integers(1, vocab, size=n).astype(np.int32)
        prompt = np.concatenate([shared, tail]) if i >= 2 else tail
        sp = (SamplingParams() if i % 2 == 0 or greedy else
              SamplingParams(temperature=0.8, top_k=20, top_p=0.9))
        reqs.append(Request(prompt=prompt, max_new_tokens=12, sampling=sp,
                            seed=i + 1, request_id=f"{tag}{i}"))
    return reqs


def _w_logits_at(eng, prompt) -> torch.Tensor:
    """The logits ``eng`` samples the token after ``prompt`` from."""
    from k8s_distributed_deeplearning_torch.serve import Request

    store = {}
    _first_logits(eng, store)
    try:
        eng.run([Request(prompt=np.asarray(prompt, np.int32),
                         max_new_tokens=1, request_id="w_rule")])
    finally:
        eng.__dict__.pop("_prefill", None)
        eng.__dict__.pop("_finish_admission", None)
    return store["w_rule"][0]


def _w_rule(what, ref_eng, tp_eng, reqs, ref, got) -> int:
    """Streams equal; where a greedy token differs, the streams agree
    before it and tp=0's top-2 margin there is under twice the largest
    logit difference (phase C's rule). Returns the positions it
    decided."""
    decided = 0
    prompts = {r.request_id: (r.prompt, r.sampling.temperature)
               for r in reqs}
    check(set(ref) == set(got), f"{what}: requests {set(ref) ^ set(got)}")
    for rid in sorted(ref):
        a, b = ref[rid], got[rid]
        if a == b:
            continue
        p = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        prompt, temp = prompts[rid]
        check(temp <= 0.0 and p < min(len(a), len(b)),
              f"{what}: stream {rid} differs at {p} (sampled or cut)")
        ctx = np.concatenate([prompt, np.asarray(a[:p], np.int32)])
        lr, lt = _w_logits_at(ref_eng, ctx), _w_logits_at(tp_eng, ctx)
        top2 = lr.topk(2).values
        margin = float(top2[0] - top2[1])
        diff = float((lt - lr).abs().max())
        check(margin < 2 * diff, f"{what}: {rid} differs at {p} where "
              f"tp=0's margin {margin} >= 2 x the logit difference {diff}")
        decided += 1
    return decided


def _w2_routes_ok(what, world, stats, tp, quant) -> list:
    ranks = _w_rank_routes(world, stats, tp)
    on, off = ("int8", "fp") if quant else ("fp", "int8")
    for r, got in enumerate(ranks):
        check(got[on]["tf32x3"] > 0 and got[on]["decode"] == 0
              and got[on]["prefill"] == 0 and got[on]["split"] == 0
              and not any(got[off].values()),
              f"{what}: rank {r}'s launches {got}: want every one on the "
              f"{'QUANT-' if quant else ''}tf32x3 route, split 0")
    return ranks


def _w2(dev, world) -> dict:
    """8B width, W_LAYERS layers, f32, tp=2 against tp=0: the mixed
    workload (greedy and sampled, prefix hits, chunked prefill), spec_k
    4 with a W2_DRAFT_LAYERS-layer draft, a gateway drain that migrates
    mid-decode between two engines (fp, then under int8 KV), and int8 KV
    with int8 weights."""
    from k8s_distributed_deeplearning_torch.models import llama
    from k8s_distributed_deeplearning_torch.serve import Request, ServeEngine
    from k8s_distributed_deeplearning_torch.serve.gateway import ServeGateway
    from k8s_distributed_deeplearning_torch.utils.metrics import ServingStats

    cfg = llama.config_llama3_8b(max_seq_len=2048, n_layers=W_LAYERS,
                                 dtype=torch.float32)
    model = llama.LlamaLM(cfg, device=dev, seed=0)
    dcfg = llama.config_llama3_8b(max_seq_len=2048,
                                  n_layers=W2_DRAFT_LAYERS,
                                  dtype=torch.float32)
    draft = llama.LlamaLM(dcfg, device=dev, seed=1)
    vocab = cfg.vocab_size
    result = {"phase": "W2", "model": "llama3-8b width", "layers": W_LAYERS,
              "dtype": "float32", "backend": world.backend,
              "route_launches": {}, "decided": {}}

    def serve(what, tp, make, reqs_of, passes=1):
        world.stats(reset=True)
        eng = make(tp)
        toks = {}
        for i in range(passes):
            toks.update({o.request_id: list(o.tokens) for o in eng.run(
                reqs_of("rs"[i]))})
        return eng, toks, world.stats()

    def both(name, make, reqs_of, passes, quant):
        # tp=2 first: the tp=0 int8 engine quantizes the model in place.
        engs, toks = {}, {}
        for tp in (2, 0):
            engs[tp], toks[tp], stats = serve(name, tp, make, reqs_of,
                                              passes)
            result["route_launches"][f"{name} tp={tp}"] = _w2_routes_ok(
                f"W2 {name} tp={tp}", world, stats, tp, quant)
        check(engs[2].tp_consistency_check(),
              f"W2 {name}: the ranks' last logits are not bit-equal")
        if name == "mixed":
            check(engs[2].stats.summary()["prefix_cache_hits"] >= 1,
                  "W2 mixed: no prefix hit")
        if name == "spec":
            check(engs[2].stats.spec_steps > 0, "W2 spec: no spec step")
        reqs = reqs_of("r") + (reqs_of("s") if passes == 2 else [])
        result["decided"][name] = _w_rule(f"W2 {name}", engs[0], engs[2],
                                          reqs, toks[0], toks[2])
        engs[2].close()

    cases = {
        "mixed": (lambda tp: ServeEngine(
            model, num_slots=4, min_bucket=32, prefill_chunk_tokens=W2_CHUNK,
            prefix_cache_mb=256, device=dev, tp=tp),
                  lambda tag: _w_mixed_reqs(vocab, tag), 2, False),
        "spec": (lambda tp: ServeEngine(
            model, num_slots=4, min_bucket=32, draft_model=draft,
            spec_k=W2_SPEC_K, device=dev, tp=tp),
                 lambda tag: _w_mixed_reqs(vocab, tag), 1, False),
        "int8": (lambda tp: ServeEngine(
            model, num_slots=4, min_bucket=32, prefill_chunk_tokens=W2_CHUNK,
            kv_quant="int8", weight_quant="int8", device=dev, tp=tp),
                 lambda tag: _w_mixed_reqs(vocab, tag), 1, True)}
    for name in ("mixed", "spec"):
        both(name, *cases[name])
        gc.collect()
    # The drain migration between two engines of each mode, fp and then
    # under int8 KV (4 pool tensors a layer: an import whose header
    # needs a second broadcast at W_LAYERS).
    rng = np.random.default_rng(3)
    mreqs = [Request(prompt=rng.integers(1, vocab, size=40 + 30 * i).astype(
                 np.int32), max_new_tokens=10 + i, request_id=f"m{i}")
             for i in range(4)]
    for name, kv_quant in (("migration", None), ("migration_int8", "int8")):
        mig, fleets = {}, {}
        for tp in (2, 0):
            world.stats(reset=True)
            stats = ServingStats()
            engines = [ServeEngine(model, num_slots=2, eos_id=None,
                                   min_bucket=32, stats=stats,
                                   replica_id=f"r{i}", kv_quant=kv_quant,
                                   device=dev, tp=tp)
                       for i in range(2)]
            gw = ServeGateway(engines, stats=stats)
            for r in mreqs:
                gw.submit(Request(prompt=r.prompt,
                                  max_new_tokens=r.max_new_tokens,
                                  request_id=r.request_id))
            outs = []
            for _ in range(3):
                outs.extend(gw.step())
            gw.drain_replica("r0")
            for _ in range(600):
                if not gw.busy():
                    break
                outs.extend(gw.step())
            check(not gw.busy() and stats.gateway_migrations >= 1,
                  f"W2 {name} tp={tp}: busy {gw.busy()}, migrations "
                  f"{stats.gateway_migrations}")
            result["route_launches"][f"{name} tp={tp}"] = _w2_routes_ok(
                f"W2 {name} tp={tp}", world, world.stats(), tp,
                kv_quant is not None)
            mig[tp] = {o.request_id: list(o.tokens) for o in outs}
            fleets[tp] = engines
        result["decided"][name] = _w_rule(
            f"W2 {name}", fleets[0][1], fleets[2][1], mreqs, mig[0], mig[2])
        for e in fleets[2]:
            e.close()
        del fleets
        gc.collect()
    # Last: the tp=0 int8 engine quantizes the model in place (and every
    # engine on it from the int8 migration on takes int8 KV).
    both("int8", *cases["int8"])
    result["positions_decided_by_rule"] = sum(result["decided"].values())
    log(result)
    return result


def _w3(model, dev, world, ref) -> dict:
    """A world of one through the seam on W1's model: first-token logits
    and streams bitwise equal to W1's tp=0 run (``ref``); decode
    iteration ms of both, a reading."""
    run = _w_serve(model, dev, world, 1)
    run["engine"].close()
    del run["engine"]
    check(run["streams"] == ref["streams"],
          "W3: tp=1 streams differ from tp=0's")
    check(sorted(run["logits"]) == sorted(ref["logits"])
          and all(torch.equal(run["logits"][k], ref["logits"][k])
                  for k in ref["logits"]),
          "W3: tp=1 first-token logits are not bitwise tp=0's")
    check(run["reading"]["route_launches"]
          == ref["reading"]["route_launches"],
          f"W3: launches {run['reading']['route_launches']} != tp=0's")
    result = {"phase": "W3", "model": "llama3-8b width", "layers": W_LAYERS,
              "dtype": "bfloat16", "backend": world.backend,
              "logits_bitwise": True, "streams_equal": True,
              "route_launches": {
                  f"tp={r['reading']['tp']}": r["reading"]["route_launches"]
                  for r in (ref, run)},
              "decode_iteration_ms": {
                  f"tp={r['reading']['tp']}": r["reading"][
                      "decode_iteration_ms"] for r in (ref, run)}}
    log(result)
    return result


def _w4_start():
    """The serve CLI at ``--preset small --tp 2`` as a process of its own
    (rank 0 spawns its follower): :func:`_w4` reads it."""
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "k8s_distributed_deeplearning_torch.serve",
         "--preset", "small", "--tp", "2", "--requests", str(W4_REQUESTS),
         "--slots", "4", "--out-len", "8", "16"], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _w4(started) -> dict:
    """W4: the CLI served W4_REQUESTS requests, the follower joined, both
    processes exited 0, both ranks launched the same kernels, and rank
    0's peak device memory is within W4_PEAK_RATIO of rank 1's."""
    t0, proc = started
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0,
          f"W4: the CLI exited {proc.returncode}: {err[-3000:]}")
    events = [json.loads(line) for line in out.splitlines()
              if line.startswith("{")]
    summ = events[-1]
    check(summ["event"] == "serve_summary"
          and summ["requests_completed"] == W4_REQUESTS
          and summ["tp"] == 2, f"W4: summary {summ}")
    check("tp world: rank 1 of 2" in err, "W4: no follower joined the world")
    ranks = summ["tp_ranks"]        # the readings that are not all 0
    stats = {k: ranks.get(k, [0, 0]) for k in
             ("launches", "launches_int8", *(
                 f"launches_{r}{m}" for r in ("decode", "prefill", "tf32x3")
                 for m in ("", "_int8")))}
    routes = [_w_routes(stats, r) for r in range(2)]
    check(routes[0] == routes[1] and routes[0]["fp"]["split"] == 0
          and routes[0]["fp"]["decode"] > 0,
          f"W4: launches by rank {routes}")
    # The CLI keeps the whole model on the host: rank 0's card holds its
    # shard as rank 1's does, not the whole model beside it.
    peaks = ranks.get("peak_bytes", [0, 0])
    check(0 < peaks[0] <= W4_PEAK_RATIO * peaks[1],
          f"W4: peak device bytes by rank {peaks}: rank 0's over "
          f"{W4_PEAK_RATIO} x rank 1's")
    result = {"phase": "W4", "preset": "small", "tp": 2,
              "backend": summ["tp_backend"], "wall_s":
              time.perf_counter() - t0, "route_launches": routes,
              "peak_memory_gb_by_rank": [b / 2 ** 30 for b in
                                         ranks.get("peak_bytes", [0, 0])],
              "tokens_per_sec": summ["tokens_per_sec"],
              "note": "ran beside W2 on the same card"}
    log(result)
    return result


def phase_w(dev) -> dict:
    """W1-W3 in the tp worlds this process leads; W4 in a CLI process
    beside W2."""
    from k8s_distributed_deeplearning_torch.serve import tp as tp_lib

    from k8s_distributed_deeplearning_torch.models import llama

    out = {}
    model = llama.LlamaLM(llama.config_llama3_8b(
        max_seq_len=2048, n_layers=W_LAYERS), device=dev, seed=0)
    world = tp_lib.launch(2, "cuda", timeout_s=W_TIMEOUT_S)
    log({"phase": "W", "world": 2, "backend": world.backend})
    w4 = None
    try:
        out["w1"], tp0 = _w1(model, dev, world)
        # W2 takes no speed reading: the CLI of W4 runs beside it.
        w4 = _w4_start()
        out["w2"] = _w2(dev, world)
        out["w4"] = _w4(w4)
    finally:
        if w4 is not None and w4[1].poll() is None:
            w4[1].kill()
            w4[1].wait()
        tp_lib.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    world = tp_lib.launch(1, "cuda", timeout_s=W_TIMEOUT_S)
    log({"phase": "W", "world": 1, "backend": world.backend})
    try:
        out["w3"] = _w3(model, dev, world, tp0)
    finally:
        tp_lib.shutdown()
    del model
    return out


PAGED_ROUTES = {"paged_decode": "decode", "paged_prefill_attention": "prefill",
                "paged_attn_tf32x3": "tf32x3", "paged_attn_split": "split"}


def _w_launches(w_result, route: str, int8: bool) -> dict:
    """Phase W's launches of one route and branch, by sub-run and rank
    (each sub-run's counts set to 0 just before it and read just
    after)."""
    branch = "int8" if int8 else "fp"
    runs = {f"W1 tp={tp}": v["route_launches"]
            for tp, v in w_result["w1"]["runs"].items()}
    runs.update({f"W2 {k}": v for k, v in
                 w_result["w2"]["route_launches"].items()})
    runs.update({f"W3 {k}": v for k, v in
                 w_result["w3"]["route_launches"].items()})
    runs["W4 cli"] = w_result["w4"]["route_launches"]
    return {k: [rank[branch][route] for rank in v] for k, v in runs.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from k8s_distributed_deeplearning_torch.ops import _build
    from k8s_distributed_deeplearning_torch.parallel import distributed

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    libs = _build.build_all()
    from k8s_distributed_deeplearning_torch.runtime import fusion
    log({"build_s": time.perf_counter() - t0,
         "kernels": sorted(libs),
         "fusion_native_available": fusion.native_available()})
    for lib in libs.values():
        entry = ""
        for line in lib.with_suffix(".log").read_text().splitlines():
            found = re.search(r"Compiling entry function '(\w+)'", line)
            if found:
                entry = _entry_name(found.group(1))
            if "registers" in line or "spill" in line:
                log(f"ptxas {lib.stem} {entry}: {line.strip()}")
    started = time.perf_counter()

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        gc.collect()
        torch.cuda.empty_cache()
        log({"phase_done": name, "s": time.perf_counter() - t,
             "since_start_s": time.perf_counter() - started})
        return out

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    cases = timed("A", phase_a, dev, flush)
    int8_cases = timed("A_int8", phase_a_int8, dev, flush)
    b, b_streams, b_logits = timed("B", phase_b, dev)
    j = timed("J", phase_j, dev, b_streams)
    c = timed("C", phase_c, dev)
    k = timed("K", phase_k, dev)
    p, verify = timed("P", phase_p, dev, flush)
    with tempfile.TemporaryDirectory() as tmp:
        r = timed("R", phase_r, dev, b_streams, b_logits, started,
                  Path(tmp))
        timed("S", phase_s, dev, b_streams, b_logits, started, Path(tmp))
    timed("L", phase_l, dev)
    flash_rows = timed("D", phase_d, dev, flush)
    gmm_rows = timed("G", phase_g, dev, flush)
    m = timed("M", phase_m, dev)
    del flush
    distributed.initialize_single("cuda")
    try:
        e = timed("E", phase_e, dev)
        f = timed("F", phase_f, dev)
        timed("F_bf16", phase_f_bf16, dev)
        h = timed("H", phase_h, dev)
        i = timed("I", phase_i, dev)
        q = timed("Q", phase_q, dev)
        with tempfile.TemporaryDirectory() as tmp:
            timed("N", phase_n, dev, Path(tmp))
            timed("O", phase_o, dev, Path(tmp))
        with tempfile.TemporaryDirectory() as tmp:
            timed("T", phase_t, dev, Path(tmp), e)
        with tempfile.TemporaryDirectory() as tmp:
            v = timed("V", phase_v, dev, Path(tmp))
    finally:
        distributed.shutdown()
    with tempfile.TemporaryDirectory() as tmp:
        timed("U", phase_u, dev, b_logits, started, Path(tmp))
    w = timed("W", phase_w, dev)
    paged = _paged_entries(cases, b, c, int8_cases, j, k, p, verify, r)
    for entry in paged:
        if not entry["name"].startswith(("paged_decode_small",
                                         "paged_attn_tf32x3_small")):
            route = PAGED_ROUTES[entry["name"].removesuffix("_int8")]
            entry["launches_w"] = _w_launches(
                w, route, entry["name"].endswith("_int8"))
            entry["launches_in"] += "; W by sub-run and rank in launches_w"
    log({"kernels": paged + _flash_entries(flash_rows, e, f, q, v)
         + _gmm_entries(gmm_rows, h, i, m)})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--s-server":
        sys.exit(s_server(sys.argv[2]))
    sys.exit(main())
