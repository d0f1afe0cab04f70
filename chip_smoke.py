#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored; each
prints its wall time):

1. Print the card (``nvidia-smi`` name and power limit) and the torch and
   CUDA versions; build the CUDA kernels from ``src/repro_torch/kernels/
   csrc`` with nvcc for sm_90a (one nvcc a source, all at once) and print
   the build seconds; check in the library's SASS (``cuobjdump``) that
   the kernels of the fused matmul, the fused MLP and the codes matmul
   multiply on the int8 tensor cores (IMMA from mma.sync; IGMMA from the
   codes matmul's 128-row wgmma instance), and print where any POPC sits.
2. Hold every kernel against its plain PyTorch version on the card, at the
   shapes h2o-danube-1.8b's decode step and prefill chunks give it
   (absmax, matmul, codes matmul and BP quantise bitwise, popcount exact,
   the quantise also on bf16 inputs, every finite bf16 pattern included,
   MLP within 1e-5 relative and relu bitwise, decode attention within
   1e-5), and time kernel, plain version and, where one exists, the
   PyTorch library call computing the same function (CUDA events, L2
   flushed before every call).  Weights are bf16, as the model holds them
   and the served path passes them; absmax, the matmul and the MLP are
   also timed on the f32 cast and checked bitwise against it.  absmax is
   checked with and without its floor, on ragged sizes and an unaligned
   view, and for one kernel a call; the fused matmul bitwise at M 1-256,
   with coded y, on its encode's plane boundaries, and for at most two
   kernels a call (profiler); the MLP at M 1-256 and ragged shapes with
   bf16, f32 and coded weights, and for at most two kernels a call;
   decode attention at S 1-4096, dead rows and qwen2-72b's heads (D 128,
   G 8); the codes matmul at M 1-256, ragged shapes and K 0, and for at
   most two kernels a call; the quantise timed on f32 and on bf16 weights,
   also by the profiler's kernel time; popcount on 8 MB tiles of 16, 64,
   256 and 2048 columns (event time, profiler kernel time with the L2
   flushed dirty and clean, bound, ``bits.sum``), exact there and on
   ragged rows starting at every misalignment, one kernel a call.  NaN
   and Inf: absmax, the fused matmul and MLP (a NaN or an Inf in x or a
   weight; relu with a NaN in w_gate) and decode attention (a NaN in q)
   give NaN where the plain version does and its values elsewhere.  The
   redesigned kernels' times print beside the earlier designs'
   (EARLIER_MS), and the build's ptxas registers and spills beside their
   dynamic shared memory.
3. Card vs CPU: h2o-danube at full width, 1 layer, the same seeded
   weights on both devices, 2 prompts (37 and 101 tokens; a third of 64
   dropped for time), 8 greedy tokens each through the
   paged engine, in ``bp8_fused`` and in ``bp8`` (both over a ``bp8``
   cache); the card's path captured (the engine's default), the card's
   path eager (``capture=False``) and the CPU's plain path must emit the
   same tokens.
4. The served path: the full h2o-danube-1.8b (24 layers, full width,
   seeded random weights) in ``bp8_fused`` + ``bp8`` serves 8 requests
   (prompts of 32-256 tokens, 16 new tokens each) through
   ``PagedServeEngine`` (4 slots, block 16, prefill chunk 64), twice on
   one capturing engine (the first run captures each shape's CUDA graph;
   the second, timed, replays them) and once, after a short warm-up, on
   an eager engine: tokens/s of both, the capture seconds, peak device
   memory, and graphs per entry point, which must stay within
   ``compile_shape_bounds()``.  All three runs must emit the same tokens.
   Launch counts (a replay adds its graph's kernels) are zeroed just
   before the timed run and read just after; every kernel of the path
   must have launched, and must show by name in the profile of a captured
   run.  A prefill chunk and a decode step replayed from graphs must give
   the eager calls' caches and logits bitwise.  Short runs under
   ``torch.profiler``, captured and eager, give device time by kernel
   (the copy kernels of dtype casts apart), the idle share and the host
   time of the engine's ``paged.*`` ranges; decode steps of 2 and of 3
   layers the device launches and device time a decode layer adds, by
   kernel.
5. The unfused path: ``oisma_matmul(impl="unfused")`` at every projection
   shape of one h2o-danube-1.8b layer (4 and 256 rows) and at
   qwen2-72b's 256x8192x29568, with its accumulation periphery (the
   signed AND bits of every output as a row, summed by the popcount
   kernel, equal the codes matmul), each matmul also with its weight held
   as bf16 and read as stored.  Launch counts are zeroed just before and
   read just after; each result must equal ``impl="fused"`` bitwise.
6. Full depth in ``bp8``: the 24-layer h2o-danube-1.8b with
   ``matmul_mode="bp8"`` serves 2 requests x 8 new tokens twice on one
   capturing engine; tokens/s of the second run, peak device memory, and
   a profile of one short request.  ``bp8``'s bitplane encode as a
   comparison with the plane thresholds is timed beside the earlier
   gather from the dataset's table (the same planes, checked bitwise).
7. Sampling, the lock-step engine, obs and traffic, on phase 4's model:
   threefry keys, random bits (both layouts) and uniforms on the card
   bitwise the CPU's, the tokens of (4, 32000) logits equal at T 0.5, 0.8
   and 1.0, the gumbel noise's largest difference in ulps, and the host
   time of ``sample_tokens`` at T 0.8 against T 0; 6 requests (prompts
   of 32-200 tokens, 16 new tokens, seed 7, T 0.8) through the capturing
   paged engine and through the lock-step engine serving each alone
   (max_len 512, one decode graph, its launches counted): tokens/s of
   both, the lock-step decode replayed bitwise equal to eager, and at 1
   layer the card's tokens equal to the CPU's on both engines; a
   captured profile at T 0.8 (``paged.sample``'s share); ``run_traffic``
   (32 requests, offered load 0.2) on a capturing paged engine with a
   registry, a tracer and a watchdog: the record, tokens/s, the watchdog
   within ``compile_shape_bounds()``, the ``serve.*`` totals, the Chrome
   trace written to ``chiprun_out/serve_trace.json``, and the
   ``kernels.*`` counters (none on the capturing engine; an eager
   engine's).

8. Training in ``bp8_fused``: absmax, the fused matmul and the fused MLP
   at the training path's rows (M 1024 = 8 x 128 tokens, and a ragged
   1000) and every projection shape of the full model against their
   plain versions (bitwise; the MLP within 1e-5), one layer's forward
   timed beside its bound; one train step at full width and 1 layer on
   the card against the CPU from the same seeded state (2 x 32 tokens:
   the loss within 1e-3, the grad norm within 1e-2 relative, each leaf's
   gradient through AdamW's first moment within 5e-2 of its max with a
   cosine of at least 0.999, the new params' step of the same sign as
   the CPU's on 90% of the elements the CPU's step moved in each leaf
   and 99% of each bf16 leaf's elements equal), its CPU step replayed op
   by op on the card on the CPU's own inputs (``replay_ops``: the fused
   matmul and MLP bitwise, their straight-through gradients within 1e-5,
   a bf16 weight's within a bf16 ulp; attention, the norms and the loss
   head forward and backward within 1e-5), a
   checkpoint written on the
   card (raw, into ``build/``, removed after) restored bitwise and
   ``train()`` resuming from it (losses within 2e-2 of an uninterrupted
   run: the embedding's backward adds with atomics); then the full
   24-layer h2o-danube-1.8b trained through ``trainer.train`` for 5 steps
   of 8 x 128 tokens (lr 3e-5, warmup 5): per-step wall time, training
   tokens/s past the first step, peak device memory, the losses (finite,
   none above step 1's by more than 0.25), that it trained (every step's
   gradient norm finite and above 0; every leaf moved from its seeded
   value, each f32 leaf by 1/4 to 2 times the steps' learning rates
   summed), launch counts zeroed just before and read just after (13
   absmax, 5 matmuls and 1 MLP a layer, twice: forward and recompute),
   and a profile of one more step (device time by kind of kernel, the
   idle share, and the device time of the step's own ``train.*`` ranges:
   forward, backward with the recompute, gradient sum, AdamW, with the
   BP kernels of the forward and of the recompute apart).

9. The Gemma family in ``bp8_fused`` + ``bp8``.  (a) The served path's
   four kernels against their plain versions at gemma3-12b's and
   paligemma-3b's shapes (phase 2's timer, bounds and checks): decode
   attention at head_dim 256 with G 2 (8 KV heads) and G 8 (MQA), S
   1-4096, windows 1024 and full with positions past 1024, within 1e-5,
   with the split and dynamic shared memory it launched with; the fused
   matmul bitwise at every projection (K up to 16384, N down to 256) at M
   4 and 64; the gelu MLP within 1e-5; absmax bitwise on the largest
   weights; the ptxas registers and shared memory of the four.  (b) Card
   vs CPU: gemma3 at full width and 1 layer (``reduced``; its window
   does not cut at these prompts) on the
   paged engine (prompts of 64 and 128 tokens, 4 greedy tokens), and
   paligemma at full width and 1 layer on the lock-step engine (256 zero
   patch tokens, prompts of 20 and 48, 6 tokens): card captured, card
   eager and CPU tokens equal.  (c) gemma3-12b at full width and 12 of
   its 48 layers (two groups of 5 local and 1 global; ``reduced``), seeded
   on the card (init time and peak printed), on ``PagedServeEngine`` (4
   slots, block 16, 160 blocks, chunk 64): 8 requests, one of 1200
   prompt tokens (the local window cuts) and 7 of 32-256, 16 new tokens,
   twice on a capturing engine (the second timed, launches counted) and
   once eager, all tokens equal; graphs within the bounds; the logits'
   share of a captured decode step; a short profile.  (d) The full
   18-layer paligemma-3b on the lock-step engine (256 zero patch tokens,
   4 prompts of 16-64, 16 new tokens): twice captured (the second timed,
   launches counted) and once eager, tokens equal, its decode graph
   replayed bitwise equal to eager.

10. Mixture-of-experts and latent attention in ``bp8_fused`` (granite-moe
   over a ``bp8`` cache; MLA's latent cache is bf16).  (a) The served
   path's kernels at the new shapes (phase 2's timer, bounds and checks):
   the fused matmul bitwise at every projection of a granite-moe-1b,
   deepseek-v2 and minicpm3 layer (K 1024 / N 512; N 576, K 1536, N
   24576, K 16384; the shared experts' N 3072; the dense layers' down
   projections) at M 4 and 64; absmax bitwise on their weights; the silu
   MLP at 5120 -> 12288 and 2560 -> 6400 within 1e-5; decode attention
   at D 64, KH 8, G 2 within 1e-5 (S 1-4096, full and a 1024 window).
   (b) Card vs CPU: the three archs at full width, granite-moe and
   minicpm3 at 1 layer, deepseek at 2 (its dense first layer and one MoE
   layer) on the paged
   engine, prompts of 32 and 64 tokens (one chunk), 4 greedy tokens (3
   for deepseek): card captured, card eager and CPU tokens equal; where
   they part, the step, the CPU's top-2 logit margin and the largest
   logit difference are printed.  (c) The full 24-layer granite-moe-1b
   on ``PagedServeEngine`` (4 slots, block 16, chunk 64): 8 requests of
   32-256 prompt tokens, 16 new each, twice captured (the second timed,
   launches counted) and once eager, tokens equal; graphs within the
   bounds; a prefill chunk and a decode step replayed bitwise equal to
   eager; the capacity and dropped slots of each MoE layer in a 64-token
   chunk and a 4-row step; a short captured profile by kind of kernel
   (the BP kernels, the expert bmm, routing sorts, dispatch and combine).
   (d) deepseek-v2 at its published width and 4 layers (the dense first
   layer and 3 MoE layers; ``reduced`` in the report): seeded on the card
   (init time and peak), 4 requests, 16 new each, captured twice and
   eager, tokens equal; a captured decode step's time against the bytes
   of the routed experts it reads.  (e) The full granite-moe-1b trained 3
   steps (8 x 128 tokens, lr 3e-5): gradient norms above 0, every leaf
   (routers and experts included) moved from its seed, launches (8
   absmax and 4 matmuls a layer, forward and recompute), step times and
   peak memory.

11. The encoder-decoder and the hybrid in ``bp8_fused`` over a ``bp8``
   cache, whose cross K/V (whisper) and conv and SSM states (zamba2) the
   paged cache keeps dense per slot.  (a) The served path's kernels at
   the new shapes (phase 2's timer, bounds and checks): the fused matmul
   bitwise at every projection of whisper-base (K 512 -> N 512 / 2048, K
   2048 -> 512) at M 4, 64 and 1500 (the encoder's rows and the cross
   K/V) and of zamba2-2.7b (``in_proj`` 2560 -> 10448, ``out_proj`` 5120
   -> 2560, attention 2560 -> 2560, down 10240 -> 2560) at M 4 and 64;
   absmax bitwise on their inputs and weights; zamba2's silu MLP 2560 ->
   10240 within 1e-5; decode attention at G 1 (whisper D 64, KH 8;
   zamba2 D 80, KH 32; S 1-4096, full and a 1024 window) within 1e-5.
   Rows time one decode layer (whisper) or group (zamba2) of a 4-row
   step; whisper's encoder layer at M 1500 is timed beside its bound.
   (b) Card vs CPU on the paged engine, prompts of 32 and 64 tokens, 4
   greedy tokens, weights seeded on the card: the whole whisper-base
   over non-zero seeded frames, and zamba2 at full width and 6 layers
   (one group; ``reduced``); where they part, the margin report.  (c)
   The full whisper-base and (d) the full zamba2-2.7b (54 Mamba2 layers
   in 9 groups, 2.7 B parameters) on ``PagedServeEngine`` (4 slots,
   block 16, chunk 64; whisper over seeded frames): 8 requests of 32-256
   prompt tokens, 16 new each, twice captured (the second timed,
   launches counted) and once eager, tokens equal; graphs within the
   bounds (whisper's with-frames prefill graphs included); the first
   chunk (with the frames), a later chunk and a decode step replayed
   bitwise equal to eager; the same requests once on the lock-step
   engine (each alone); peak memory, a slot's dense cache bytes, and a
   short captured profile by kind of kernel with the idle share.

12. xlstm-1.3b (48 layers: 6 groups of 7 mLSTM blocks and 1 sLSTM block;
   a cache of recurrent states only, dense per slot) in ``bp8_fused``,
   and ring-buffer KV caches (``ring_cache=True``) on h2o-danube-1.8b.
   (a) absmax and the fused matmul at a group of an xlstm 4-row decode
   step (7 x ``up`` 2048 -> 5504 and ``down`` 2752 -> 2048, ``wx`` 2048
   -> 8192, ``wo_proj`` 2048 -> 2048), bitwise at M 4, 64 and 256 and
   timed beside their bounds; decode attention over a wrapped ring (S
   4096, window 4096, positions 4600-8695 at slots pos % 4096, so slot
   order is not position order) within 1e-5 of its plain version and of
   the ordered cells, timed; rows 1-3 of the ring path are phase 2's (the
   same h2o-danube shapes).  (b) Card vs CPU: xlstm at full width and 8
   layers (one group; ``reduced``) on both engines, prompts of 32 and 64,
   4 greedy tokens; h2o-danube at full width, 1 layer and a ring of 64
   on the lock-step engine, prompts of 100 and 150, 12 tokens, max_len
   256: card captured, card eager and CPU tokens equal.  (c) The full
   xlstm-1.3b on ``PagedServeEngine`` as phase 4 serves h2o-danube:
   captured twice and eager, tokens equal; a first chunk (from the zero
   state), a later chunk and a decode step replayed bitwise equal to
   eager; a slot's state bytes, peak memory, a captured 4-row decode
   step against its bytes, a short captured profile; the same requests
   on the lock-step engine, each alone, its decode replayed bitwise
   equal to eager.  (d) The full h2o-danube-1.8b on the lock-step engine
   with a ring of 4096: one prompt of 4600 tokens, 16 new, max_len 8192,
   captured twice and eager, tokens equal, the decode graph replayed
   bitwise equal to eager, the prefill logits bitwise those of the same
   engine without the ring, the decode tokens and largest logit
   difference against it (reported), a slot's cache bytes ring against
   full, captured decode steps of both against the bound, peak memory
   and a profile of the request.
13. Training the encoder-decoder, hybrid and xlstm families in
   ``bp8_fused``.  (a) absmax and the fused matmul bitwise at one forward
   layer of each at the training shape (8 x 128 tokens, M 1024):
   whisper-base's decoder layer (its cross K/V at M 8 x 1500) and encoder
   layer (M 8 x 1500, timed into the detail), zamba2-2.7b's ``in_proj``
   2560 -> 10448, ``out_proj`` 5120 -> 2560, shared attention and MLP
   down, and its silu MLP 2560 -> 10240 within 1e-5, xlstm-1.3b's ``up``
   2048 -> 5504, ``down`` 2752 -> 2048, ``wx`` 2048 -> 8192 and
   ``wo_proj``; each layer's kernels timed beside their bound.  (b) A
   train step on the card and on the CPU from one seeded state over
   ``demo_batch`` (2 x 32 tokens; whisper's 2 x 1500 frames): whisper
   whole and at 1 + 1 layers, zamba2 at 6 layers (one group) and xlstm
   at 8 (one group) (``reduced``).  The CPU's step is replayed op by op
   on the card on the CPU's own inputs (``replay_ops``: the fused matmul
   and MLP and their straight-through gradients; attention, the SSD,
   the mLSTM's chunked scan, the sLSTM's recurrence, the norms and the
   loss head forward and backward, the backward for the CPU's own
   output gradient), failing if an op the step must reach was never
   replayed; phase 8's whole-step rules (``compare_train_step``, the
   loss within 1e-5 of it) gate every step.  whisper at 1 + 1 layers
   and zamba2's group meet them against the plain CPU; whisper at 3 + 3
   and xlstm's group against the CPU following the card's forward layer
   by layer (``card_layers``: each layer's output swapped for the
   card's on the same inputs, which must agree within ``FOLLOW_TOL``),
   since the layers' forward rounding (a bf16 flip before a BP quantise
   moves a whole level) compounds past the rules at that depth.  (c)
   Each at
   full width trained 3 steps of 8 x 128 tokens at lr 3e-5: whisper-base
   whole through ``make_train_step`` over ``demo_batch`` (the data
   pipeline makes no frames), xlstm-1.3b and zamba2-2.7b whole through
   ``trainer.train`` (zamba2's 2.35 B parameters fit with AdamW updating
   a leaf a slice at a time); launch counts
   zeroed just before and read just after, against a step's (each dense
   2 absmax and a matmul, the MLP 3 absmax, the recomputed layers twice);
   losses finite, gradient norms above 0, every leaf moved from its
   seed; step seconds, training tokens/s, peak memory, and a profile of
   one more step by the step's ``train.*`` ranges.

14. The distributed layer (``dist/``, ``launch/mesh.py``): (a) absmax and
   the fused matmul bitwise, the fused MLP within 1e-5, of their plain
   versions at a TP-2 rank's shard shapes of h2o-danube-1.8b (wq 2560 ->
   1280, wk/wv 2560 -> 320, wo 1280 -> 2560 and down 3456 -> 2560
   row-parallel, up/gate 2560 -> 3456) at 256 rows (8 x 128 tokens in
   ``TrainPlan.for_shape``'s 4 microbatches), timed beside their bound;
   (b) 8 ranks started here (``launch_ranks``, gloo): 4 processes on
   cuda:0 and their 4 twins on the CPU.  At full width and 2 layers (2 x
   32 tokens), the pipelined step (stage 2, GPipe and 1F1B, bf16), the
   data-parallel one (data 2) and the stage-free TP one (model 2; both
   bp8_fused) and TP inside 2 stages (bf16, 4 layers) against the
   single-process card step, with f32 weights gated (the loss within
   1e-5 relative, every leaf's gradient within 1e-4 of its largest: for
   the stage-free steps, the reduced scales) and with bf16 weights
   reported (the loss, every leaf's cosine); and one ``bp8_fused`` train
   step of h2o-danube, granite-moe-1b (experts over 2) and minicpm3-4b
   (MLA heads over 2) at 2 layers on (stage 2, model 2) against the same
   mesh on the CPU twins (each card rank's pieces sent to its twin, phase
   13(b)'s whole-step rules on their sums); which transport each op
   used, and the world's timeline; (c)
   h2o-danube-1.8b at full width and 12 of its 24 layers (``reduced``)
   on (stage 2, data 1, model 2)
   through ``trainer.train(mesh=)``, 3 steps of 8 x 128 tokens, lr 3e-5:
   step times, tokens/s, each rank's peak and their sum, each rank's
   share of the steps spent waiting in sends, receives and all-reduces,
   each stage's idle share against the plan's bubble, each rank's
   launches of rows 1-3 (counted from just before to just after), every
   piece moved, finite grad norms above 0; its checkpoint (whole leaves,
   bf16 moments, written by rank 0) restored in this process without a
   mesh, every rank's pieces bitwise, and ``train()`` continuing from it;
   and sequence parallelism (``dist/seq.py``), the world's first work:
   the 4 card ranks as one (seq 4, data 1, model 1) ring under the
   "sequence" rules, the twins waiting at a barrier, ``bp8_fused``
   throughout: (d) the ring core on
   seeded inputs, each case bitwise the port's oracle run in the rank's
   one process and within 1e-5 of dense attention: GQA at qwen2-72b's
   heads (64 q, 8 kv, D 128) over 8192 slots under the kv schedule (8192
   queries, a block a rank) and the stats schedule (one query), 8191
   slots through ``pad_kv``, and the absorbed-MLA ring at minicpm3-4b's
   latent (R 256, rope 32, 40 heads); (e) qwen2-72b at full width and 2
   of its 80 layers over a ``bp8`` cache (a 32768-token prompt, 8192 a
   rank, 16 greedy decode steps) and minicpm3-4b at full width and 16 of
   its 62 layers (an 8192-token prompt, 16 steps) under the ring,
   launches of rows 1-3 counted from
   just before the prefill to just after the last step; ranks 1-3 then
   free their weights while rank 0 runs the same calls in one process
   without the ring, the steps fed the ring's tokens: the prefill's
   last-position logits' cosine above 0.9999, each greedy choice equal
   but where the single process's top-2 gap is under 1% of the row's
   largest |logit| (the gaps printed either way); prefill and step
   seconds of both, each rank's cache bytes and peak against the single
   process's, a decode step's share in sends and receives (``Mesh.stats``)
   and the launches; (f) long_500k: 4 decode steps of qwen2-72b (2
   layers) over a seeded cache of 524288 slots (BP8 codes and scales,
   positions 0..524283; a block a rank) on the ring against the single
   process's steps over the whole cache through the fused decode
   attention: logits' cosine above 0.9999, top-1 equal but at a near
   tie, step ms and cache bytes; then rows 1-3 timed at a ring rank's
   qwen2-72b prefill shapes (M 8192) beside their bound; after (f),
   tensor-parallel serving (``dist/serving.py``) on the same 4 card ranks
   under the "prefill" and "decode" rules, the twins at a barrier: (g)
   qwen2-72b at full width and 4 of its 80 layers on (data 1, model 4)
   (2 x 1024 tokens, 16 greedy steps, a ``bp8`` cache) and (h)
   paligemma-3b whole on (data 2, model 2) (2 rows of 256 zero patches
   and 64 tokens, 8 steps), each rank's pieces drawn block by block from
   seeds; ranks 1-3 then free theirs while rank 0 runs the same calls
   whole: layer 0's K/V pieces bitwise its cut, every call's cosine above
   0.9999, greedy tokens equal but at a near tie, each leaf's bytes a
   rank its share; prefill and step seconds, peaks, a decode step's
   share in collectives, launches of rows 1-4; then rows 1-4 timed at a
   TP rank's decode shapes.

15. The OISMA reference and the engine model (``core/bp.py``, ``sim/``,
   ``roofline/``), one process, seconds: (a) levels 0..9 from a numpy
   seed as int8 codes at h2o-danube-1.8b's q projection (M 4 and 64, K =
   N = 2560): ``sc_multiply`` (the paper's AND and popcount, bits 10 and
   8) summed over K equal to the codes matmul (row 5); the AND
   bitstreams of an M 4 x N 256 tile (rows of K * 8 bytes) reduced by
   the popcount kernel (row 6) to the same sums; ``bp_matmul_reference``
   and ``bp_matmul_bitplane`` bitwise equal in float64 at M 64 on seeded
   inputs in [0, 1], and times 10 equal to the codes matmul on
   ``quantize_to_levels``' codes; rows 5 and 6 against their plain
   versions, the torch forms and the kernels timed, launches counted
   over (a); (b) the paper's Fig. 7 on the card: the relative Frobenius
   error at 4, 64 and 512 (the paper's 9.42% and 1.81% beside them),
   failing unless it falls; (c) ``sim.validate()`` under 0.5% on every
   row, and for h2o-danube-1.8b's decode_32k and prefill_32k the OISMA
   engine's projection (22 nm, double-buffered; 1 and 4 engines) beside
   one H100's analytic roofline terms (the data sheet's peaks), printed
   as analytic, not measured.

The last lines are the kernels JSON (each kernel with the path its
launches come from; rows 1-3 also on the training path, timed at M
1024; rows 1-4 also on the Gemma paths, timed at their decode shapes;
absmax, the matmul and attention on granite-moe's path and absmax, the
matmul and the MLP on deepseek-v2's, timed at their decode shapes; rows
1, 2 and 4 on whisper-base's path and rows 1-4 on zamba2-2.7b's, timed
at their decode shapes; rows 1-2 on xlstm-1.3b's path, timed at its
decode shapes, and rows 1-4 on the ring path, row 4 timed over the
wrapped ring; rows 1-2 on whisper-base's and xlstm-1.3b's training paths
and rows 1-3 on zamba2-2.7b's, timed at one forward layer at M 1024;
rows 1-3 on the mesh's training path, timed at a TP-2 rank's layer at M
256, their launches summed over the 4 ranks; rows 1-3 on the ring's
serving path, timed at a ring rank's qwen2-72b prefill layer at M 8192,
their launches summed over the 4 ranks and the two models; rows 1-4 on
the TP serving path, timed at a qwen2-72b TP-4 rank's decode layer,
their launches summed over the 4 ranks and (g)-(h); rows 5 and 6
on the in-array reference's path of phase 15(a), timed at its shapes),
the card line, and ``{"ok": true, "device": {...}}``.  A detail report goes to ``chip_smoke_report.json`` in the
output directory beside this script.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent


def h100_peaks():
    """The H100's data-sheet peaks (HBM3 bytes/s, dense int8 OP/s, f32
    FLOP/s outside the tensor cores) from ``repro_torch.roofline.hw``, the
    port's one home for them; None where the package is not beside this
    script, which ``main`` then refuses."""
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        return None, None, None
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    from repro_torch.roofline import hw
    return hw.HBM_BW, hw.PEAK_OPS_INT8, hw.PEAK_FLOPS_F32


H100_BYTES_PER_S, H100_INT8_OPS_PER_S, H100_F32_FLOPS_PER_S = h100_peaks()
REPLACES = {
    "absmax": "src/repro/kernels/fused.py:74",
    "fused_matmul": "src/repro/kernels/fused.py:140",
    "fused_mlp": "src/repro/kernels/fused.py:228",
    "decode_attention": "src/repro/kernels/attention.py:121",
    "bp_matmul": "src/repro/kernels/bp_matmul.py:95",
    "bp_quantize": "src/repro/kernels/bp_matmul.py:179",
    "popcount": "src/repro/kernels/bp_matmul.py:147",
}
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name}.cu"
           for name in REPLACES}
#: the path whose launch counts each kernel reports
PATHS = {"absmax": "serve_bp8_fused", "fused_matmul": "serve_bp8_fused",
         "fused_mlp": "serve_bp8_fused", "decode_attention": "serve_bp8_fused",
         "bp_matmul": "unfused", "bp_quantize": "unfused",
         "popcount": "unfused"}
#: the earlier designs' times (NVIDIA H100 80GB HBM3, 700 W; the
#: "Earlier ms" of PERF.md §6: f32 weights, absmax on f32 only, the MLP
#: on the popcount core; the codes matmul on the popcount core, the
#: quantise with a division per element, popcount one warp a row)
EARLIER_MS = {"absmax": 0.2246, "fused_matmul": 0.1959, "fused_mlp": 0.1695,
              "decode_attention": 0.0320, "bp_matmul": 4.2553,
              "bp_quantize": 0.2353, "popcount": 0.0098,
              "fused_matmul_prefill_64x2560x2560_ms": 0.0641,
              "fused_layer_256_rows_ms": 1.6818, "qwen2_72b_fused_ms": 4.0602}
EARLIER = "earlier design"
#: kernels whose registers and shared memory the build report prints
PTXAS_SHOWN = ("bp_mma_kernel", "absmax_kernel", "decode_partial_kernel",
               "decode_combine_kernel", "bp_quantize_kernel")
TINY = 1.1754943508222875e-38     # f32 tiny: the scales' floor
#: the depth of the h2o-danube card-vs-CPU checks of phases 3, 7, 8 and
#: 12(b) (the ring): one layer, so that the CPU's plain path leaves the
#: script's time to phase 14
CPU_CHECK_LAYERS = 1
#: phase 3's prompts of the 37, 64 and 101 tokens drawn: 37 and 101 (the
#: 64 dropped to keep the script's time; ``reduced`` in PERF.md §4)
PHASE3_PROMPTS = (0, 2)
# h2o-danube-1.8b: d_model, q/o width, k/v width, d_ff
D, HD, KVD, FF = 2560, 2560, 640, 6912
#: (K, N) of one layer's projections: wq, wk, wv, wo, up, gate, down
LAYER = [(D, HD), (D, KVD), (D, KVD), (HD, D), (D, FF), (D, FF), (FF, D)]
QWEN_UP = (256, 8192, 29568)     # qwen2-72b's up projection at 256 tokens
#: 8 MB 0/1 tiles at the periphery's widths (16, 64, 256 columns) and 2048
POPCOUNT_WIDTHS = [(524288, 16), (131072, 64), (32768, 256), (4096, 2048)]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Mean ms per iteration of a list of calls (the sum over the list),
    the L2 cache flushed before each call.  A device-side sleep ahead of
    each timed call lets the host enqueue the call before the card reaches
    it, so host-side launch overhead is not counted.

    The flush writes 64 MB, which leaves up to the L2's 50 MB dirty: a
    call that reads tens of MB then also pays for writing those lines
    back.  ``clean=True`` flushes by reading the 64 MB instead, so the
    call finds the L2 clean, as a served step finds it."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, calls, iters: int = 10, clean: bool = False,
                 warm: bool = True) -> float:
        """``warm=False``: the calls have just run (their check), so the
        warm-up call is skipped."""
        torch = self.torch
        if warm:
            for f in calls:
                f()
        torch.cuda.synchronize()
        events = []
        for _ in range(iters):
            for f in calls:
                if clean:
                    self.flush.max()
                else:
                    self.flush.zero_()
                torch.cuda._sleep(2_000_000)
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                f()
                e.record()
                events.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events) / iters


#: CUDA API calls that enqueue device work (a kernel, a memset, a copy)
ENQUEUE_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaMemsetAsync", "cudaMemcpyAsync")


def kernels_enqueued(torch, fn) -> dict:
    """Device work (kernels and memsets) one call of ``fn`` enqueues, by
    the CUDA API call that enqueued it, from the profiler; each count is
    the larger of two profiled calls.  The launches are counted where the
    host makes them: the profiler's record of the kernel itself is lost
    now and then (a session in which CUPTI requests a new activity buffer
    keeps the launch and drops the kernel), the record of the launch
    never."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = {}
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.key in ENQUEUE_CALLS:
                seen[e.key] = max(seen.get(e.key, 0), e.count)
    return seen


def ptxas_report(log: str) -> list:
    """``-Xptxas -v`` lines (registers, shared memory, spills) of the
    kernels named in PTXAS_SHOWN, one line per kernel instance."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in PTXAS_SHOWN if k in line), None)
            if name:
                out.append(line.split("'")[1] if "'" in line else line)
        elif name and ("Used" in line or "spill" in line):
            out[-1] += " |" + line.split(":", 1)[-1].rstrip()
    return out


def sass_counts(build, lib_path) -> dict:
    """Per kernel of the integer core (``bp_mma_kernel``: the fused matmul,
    the MLP and the codes matmul), the IMMA and IGMMA (int8 tensor-core:
    mma.sync and wgmma) and POPC instructions in the built library's SASS
    (``cuobjdump -sass``), and each POPC with the two instructions either
    side of it."""
    tool = pathlib.Path(build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump failed: {out.stderr.strip()[-500:]}")
    counts, name, body = {}, None, []

    def close():
        if name:
            ops = [ln.split(";")[0].split("*/")[-1].strip() for ln in body
                   if "*/" in ln]
            popc = [i for i, op in enumerate(ops) if "POPC" in op]
            counts[name] = {
                "IMMA": sum("IMMA" in op for op in ops),
                "IGMMA": sum("IGMMA" in op for op in ops), "POPC": len(popc),
                "POPC_context": [ops[max(0, i - 2):i + 3] for i in popc]}

    for line in out.stdout.splitlines():
        if "Function :" in line:
            close()
            fn = line.split("Function :", 1)[1].strip()
            name, body = (fn if "bp_mma_kernel" in fn else None), []
        elif name:
            body.append(line)
    close()
    return counts


def bound(byte_count: float, ops: float, peak_ops: float):
    tb, to = byte_count / H100_BYTES_PER_S, ops / peak_ops
    return max(tb, to) * 1e3, tb, to


def phase_kernels(torch, timer, dev="cuda"):
    """Kernel vs plain at the main path's shapes; returns per-kernel rows."""
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import fused as kf
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    def weight(k, n):   # bf16, as the model holds its weights
        return (randn(k, n, std=k ** -0.5)).to(torch.bfloat16)

    def nbytes(t):
        return t.numel() * t.element_size()

    d, hd, kvd, ff = 2560, 2560, 640, 6912
    rows = {}
    detail = {}

    # ---- shapes of one layer of the decode step (M = 4 slots) ----
    M = 4
    mm_shapes = [(M, d, hd), (M, d, kvd), (M, d, kvd), (M, hd, d), (M, ff, d)]
    xs = {k: randn(M, k) for k in (d, ff)}
    ws = [weight(k, n) for (_, k, n) in mm_shapes]
    up, gate = weight(d, ff), weight(d, ff)

    # absmax: 13 per layer (x and w of 5 dense calls, x/up/gate of the
    # MLP), floored at f32 tiny in the same launch; x f32, weights bf16
    am_in = ([xs[k] for (_, k, _) in mm_shapes] + ws + [xs[d], up, gate])
    am_f32 = [t.float() for t in am_in]
    ragged = randn(4103)
    am_checked = am_in + [randn(1), randn(7), randn(4097), ragged[1:4100],
                          ragged.to(torch.bfloat16)[1:4100]]
    for t in am_checked:
        for lo in (0.0, TINY):
            a = kf.absmax(t, lo)
            if not torch.equal(a, ref.absmax_ref(t, lo)):
                fail(f"absmax differs at {tuple(t.shape)} {t.dtype} floor "
                     f"{lo}: {a.item()} vs {ref.absmax_ref(t, lo).item()}")
            if not torch.equal(kf.absmax(t, lo), a):
                fail(f"absmax differs between two calls at {tuple(t.shape)}")
            if t.dtype == torch.bfloat16 and not torch.equal(
                    a, kf.absmax(t.float(), lo)):
                fail(f"absmax of bf16 differs from its f32 cast at "
                     f"{tuple(t.shape)}")
    if not torch.equal(kf.absmax(torch.zeros_like(up), TINY),
                       torch.full((1, 1), TINY, device=dev)):
        fail("absmax of zeros is not the floor")
    seen = {f"{tuple(t.shape)} {t.dtype}": kernels_enqueued(
        torch, lambda t=t: kf.absmax(t, TINY)) for t in (xs[d], up)}
    if any(sum(n.values()) != 1 for n in seen.values()):
        fail(f"absmax enqueued {seen} (one kernel a call)")
    detail["absmax_kernels_per_call"] = {k: sum(n.values())
                                         for k, n in seen.items()}
    rows["absmax"] = dict(
        max_abs_err=0.0,
        ms=timer([lambda t=t: kf.absmax(t, TINY) for t in am_in]),
        plain_ms=timer([lambda t=t: ref.absmax_ref(t, TINY) for t in am_in]),
        library_ms=timer([lambda t=t: torch.amax(t.abs()) for t in am_in]),
        b=[bound(nbytes(t) + 4, t.numel(), H100_F32_FLOPS_PER_S)
           for t in am_in])
    detail["absmax_f32_weights_ms"] = timer(
        [lambda t=t: kf.absmax(t, TINY) for t in am_f32])
    detail["absmax_f32_weights_bound_ms"] = sum(
        bound(nbytes(t) + 4, t.numel(), H100_F32_FLOPS_PER_S)[0]
        for t in am_f32)
    # what the timer costs a call by itself (one one-element kernel), and
    # the 13 scans with the L2 left clean, as a served step leaves it
    one = torch.empty(1, device=dev)
    detail["timer_one_element_kernel_ms"] = timer([lambda: one.zero_()])
    detail["absmax_clean_l2_ms"] = timer(
        [lambda t=t: kf.absmax(t, TINY) for t in am_in], clean=True)

    # fused matmul: 5 per layer; bitwise, plus prefill rows, coded y, and
    # a ragged shape; a bf16 weight equals its f32 cast bitwise
    def scales(x, y):
        return kf.absmax(x, TINY), kf.absmax(y, TINY)

    mm_calls, mm_f32, mm_plain, mm_bounds = [], [], [], []
    for (m, k, n), w in zip(mm_shapes, ws):
        x = xs[k]
        sx, sy = scales(x, w)
        a = kf.fused_bp_matmul(x, w, sx, sy)
        b = ref.fused_matmul_ref(x, w, sx, sy)
        if not torch.equal(a, b):
            fail(f"fused matmul differs at {(m, k, n)}: max "
                 f"{(a - b).abs().max().item()}")
        wf = w.float()
        if not torch.equal(a, kf.fused_bp_matmul(x, wf, sx, sy)):
            fail(f"fused matmul: bf16 y differs from its f32 cast at "
                 f"{(m, k, n)}")
        mm_calls.append(lambda x=x, w=w, sx=sx, sy=sy:
                        kf.fused_bp_matmul(x, w, sx, sy))
        mm_f32.append(lambda x=x, w=wf, sx=sx, sy=sy:
                      kf.fused_bp_matmul(x, w, sx, sy))
        mm_plain.append(lambda x=x, w=w, sx=sx, sy=sy:
                        ref.fused_matmul_ref(x, w, sx, sy))
        mm_bounds.append(bound(4 * m * k + nbytes(w) + 8 + 4 * m * n,
                               2 * m * n * 8 * k, H100_INT8_OPS_PER_S))
    extra = []
    for (m, k, n) in ([(m, d, hd) for m in (1, 4, 8, 16, 64, 65, 256)]
                      + [(64, ff, d), (130, 100, 96), (1, 7, 5), (3, 33, 50)]):
        x, w = randn(m, k), weight(k, n)
        sx, sy = scales(x, w)
        a = kf.fused_bp_matmul(x, w, sx, sy)
        if not torch.equal(a, ref.fused_matmul_ref(x, w, sx, sy)):
            fail(f"fused matmul differs at {(m, k, n)}")
        if not torch.equal(a, kf.fused_bp_matmul(x, w.float(), sx, sy)):
            fail(f"fused matmul: bf16 y differs from f32 at {(m, k, n)}")
        codes, cs = ops.prepare_bp_weight(w)
        if not torch.equal(kf.fused_bp_matmul(x, codes, sx, cs),
                           ref.fused_matmul_ref(x, codes, sx, cs)):
            fail(f"fused matmul with int8-coded y differs at {(m, k, n)}")
        extra.append((m, k, n))
    codes, cs = ops.prepare_bp_weight(ws[1])
    a = ops.oisma_matmul(xs[d], codes, y_scale=cs)
    if not torch.equal(a, ref.fused_matmul_ref(xs[d], codes, None, cs)):
        fail("fused matmul with int8-coded y differs")
    # operands exactly on the encode's plane boundaries and one ulp off:
    # x at several scales, y at scale 1 (so that sx * sy stays finite)
    def on_edges(sc, *shape):
        s_ = torch.full((1, 1), sc, device=dev)
        b = ref.level_boundaries(s_)
        inf = torch.full_like(b, math.inf)
        vals = torch.cat([b, torch.nextafter(b, inf), torch.nextafter(b, -inf),
                          torch.zeros(1, device=dev), s_.reshape(1)])
        i = torch.randint(0, len(vals), shape, generator=gen, device=dev)
        sign = torch.randint(0, 2, shape, generator=gen, device=dev) * 2 - 1
        return vals[i] * sign, s_

    wb, sw = on_edges(1.0, d, kvd)
    for sc in (0.37, 5.128217, TINY, 3e38):
        for m in (8, 72):
            xb, s_ = on_edges(sc, m, d)
            if not torch.equal(kf.fused_bp_matmul(xb, wb, s_, sw),
                               ref.fused_matmul_ref(xb, wb, s_, sw)):
                fail(f"fused matmul differs on the plane boundaries of "
                     f"scale {sc} at M {m}")
    launches = {}
    for (m, k, n) in sorted(set(mm_shapes) | {(64, d, hd), (256, d, ff),
                                              (1, 7, 5)}):
        x, w = randn(m, k), weight(k, n)
        sx, sy = scales(x, w)
        seen = kernels_enqueued(torch, lambda: kf.fused_bp_matmul(
            x, w, sx, sy))
        if not 1 <= sum(seen.values()) <= 2:
            fail(f"fused matmul at {(m, k, n)}: {seen} enqueued (at most "
                 f"2 kernels)")
        launches["x".join(map(str, (m, k, n)))] = sum(seen.values())
    detail["fused_matmul_kernels_per_call"] = launches
    x64 = randn(64, d)
    p64 = (x64, ws[0], *scales(x64, ws[0]))
    detail["fused_matmul_prefill_64x2560x2560_ms"] = timer(
        [lambda: kf.fused_bp_matmul(*p64)])
    rows["fused_matmul"] = dict(max_abs_err=0.0, ms=timer(mm_calls),
                                plain_ms=timer(mm_plain, iters=3),
                                library_ms=None, b=mm_bounds)
    detail["fused_matmul_f32_weights_ms"] = timer(mm_f32)
    detail["fused_matmul_f32_weights_bound_ms"] = sum(
        bound(4 * m * k + 4 * k * n + 8 + 4 * m * n, 2 * m * n * 8 * k,
              H100_INT8_OPS_PER_S)[0] for (m, k, n) in mm_shapes)
    detail["fused_matmul_checked_extra_shapes"] = extra

    # fused MLP: 1 per layer; 1e-5 relative to the output's magnitude for
    # silu and gelu, bitwise for relu; bf16, f32 and coded weights
    def mlp_err(a, b, act, what):
        e = ((a - b).abs().max() / b.abs().max().clamp_min(1.0)).item()
        if act == "relu" and not torch.equal(a, b):
            fail(f"fused MLP (relu, {what}) not bitwise: {e:.3g}")
        if not math.isfinite(e) or e > 1e-5:
            fail(f"fused MLP ({act}, {what}) off by {e:.3g}")
        return (a - b).abs().max().item()

    def mlp_weights(k, f, kind):
        u, g = weight(k, f), weight(k, f)
        if kind == "coded":
            (u, su_), (g, sg_) = ops.prepare_bp_weight(u), \
                ops.prepare_bp_weight(g)
            return u, g, su_, sg_
        if kind == "f32":
            u, g = u.float(), g.float()
        return u, g, kf.absmax(u, TINY), kf.absmax(g, TINY)

    err = 0.0
    x = xs[d]
    sx, su, sg = (kf.absmax(t, TINY) for t in (x, up, gate))
    mlp_checked = []
    for (m, k, f) in ([(m, d, ff) for m in (1, 4, 8, 16, 64, 65, 256)]
                      + [(130, 100, 96), (1, 7, 5)]):
        xx = randn(m, k)
        s0 = kf.absmax(xx, TINY)
        for kind in ("bf16", "f32", "coded"):
            if k == d and kind != "bf16" and m not in (4, 64):
                continue          # the wide f32 and coded cases: 4, 64 rows
            u, g, su_, sg_ = mlp_weights(k, f, kind)
            for act in ("silu", "gelu", "relu"):
                a = kf.fused_mlp(xx, u, g, s0, su_, sg_, act)
                b = ref.fused_mlp_ref(xx, u, g, act, s0, su_, sg_)
                err = max(err, mlp_err(a, b, act, f"{kind}, {(m, k, f)}"))
                if kind == "bf16" and not torch.equal(a, kf.fused_mlp(
                        xx, u.float(), g.float(), s0, su_, sg_, act)):
                    fail(f"fused MLP: bf16 weights differ from their f32 "
                         f"cast at {(m, k, f)} ({act})")
            mlp_checked.append((m, k, f, kind))
    detail["fused_mlp_checked"] = mlp_checked
    mlp_launches = {}
    for m in (4, 64):
        xx = randn(m, d)
        args = (xx, up, gate, kf.absmax(xx, TINY), su, sg, "silu")
        seen = kernels_enqueued(torch, lambda: kf.fused_mlp(*args))
        if not 1 <= sum(seen.values()) <= 2:
            fail(f"fused MLP at M {m}: {seen} enqueued (at most 2 kernels)")
        mlp_launches[f"{m}x{d}x{ff}"] = sum(seen.values())
    detail["fused_mlp_kernels_per_call"] = mlp_launches
    upf, gatef = up.float(), gate.float()
    rows["fused_mlp"] = dict(
        max_abs_err=err,
        ms=timer([lambda: kf.fused_mlp(x, up, gate, sx, su, sg, "silu")]),
        plain_ms=timer([lambda: ref.fused_mlp_ref(x, up, gate, "silu", sx,
                                                  su, sg)], iters=3),
        library_ms=None,
        b=[bound(4 * M * d + nbytes(up) + nbytes(gate) + 12 + 4 * M * ff,
                 2 * 2 * M * ff * 8 * d, H100_INT8_OPS_PER_S)])
    detail["fused_mlp_f32_weights_ms"] = timer(
        [lambda: kf.fused_mlp(x, upf, gatef, sx, su, sg, "silu")])
    detail["fused_mlp_f32_weights_bound_ms"] = bound(
        4 * M * d + 8 * d * ff + 12 + 4 * M * ff, 2 * 2 * M * ff * 8 * d,
        H100_INT8_OPS_PER_S)[0]
    x64 = randn(64, d)
    p64 = (x64, up, gate, kf.absmax(x64, TINY), su, sg, "silu")
    detail["fused_mlp_clean_l2_ms"] = timer(
        [lambda: kf.fused_mlp(x, up, gate, sx, su, sg, "silu")], clean=True)
    detail["fused_mlp_prefill_64x2560x6912_ms"] = timer(
        [lambda: kf.fused_mlp(*p64)])
    detail["fused_mlp_prefill_64x2560x6912_bound_ms"] = bound(
        4 * 64 * d + nbytes(up) + nbytes(gate) + 12 + 4 * 64 * ff,
        2 * 2 * 64 * ff * 8 * d, H100_INT8_OPS_PER_S)[0]

    # decode attention: B=4 rows, 8 kv heads x 4 queries, D=80, S=1024
    def cache(b, s, kh, dd, empty_tail=0, dead_row=False):
        kc, ks = ka.quantize_kv(randn(b, s, kh, dd))
        vc, vs = ka.quantize_kv(randn(b, s, kh, dd))
        pos = torch.arange(s, device=dev, dtype=torch.int32)[None].repeat(b, 1)
        if empty_tail:
            pos[0, s - empty_tail:] = -1
        if dead_row:
            pos[-1] = -1
        qp = (pos.max(dim=1).values.clamp_min(0)).to(torch.int32)
        return kc, ks, vc, vs, pos, qp

    B, KH, G, D, S = 4, 8, 4, 80, 1024
    q = randn(B, KH, G, D) / math.sqrt(D)
    main = cache(B, S, KH, D)
    err = 0.0
    cases = [(q, main, 4096, None),
             (q, cache(B, S, KH, D, empty_tail=100, dead_row=True), 100, 30.0),
             (randn(2, 2, 4, 80), cache(2, 48, 2, 80, empty_tail=5), 17, None),
             (q, cache(B, 1, KH, D), 4096, None),
             (q, cache(B, 33, KH, D, dead_row=True), 4096, None),
             (q, cache(B, 4096, KH, D, empty_tail=1000, dead_row=True), 1500,
              30.0),
             # qwen2-72b's heads: D 128, G 8
             (randn(B, KH, 8, 128) / math.sqrt(128),
              cache(B, 1024, KH, 128, dead_row=True), 4096, None)]
    for qq, cc, win, cap in cases:
        a = ka.bp8_decode_attention(qq, *cc, win, softcap=cap)
        b = ka.bp8_decode_attention_ref(qq, *cc, win, softcap=cap)
        e = (a - b).abs().max().item()
        if not math.isfinite(e) or e > 1e-5:
            fail(f"decode attention (S={cc[0].shape[1]}, window {win}, "
                 f"softcap {cap}) off by {e:.3g}")
        err = max(err, e)
    kc, ks, vc, vs, pos, qp = main
    kd, vd = ka.dequantize_kv(kc, ks), ka.dequantize_kv(vc, vs)
    qs = q.reshape(B, KH * G, 1, D)
    kt = kd.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vt = vd.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    mask = ((pos >= 0) & (pos <= qp[:, None])
            & (qp[:, None] - pos < 4096))[:, None, None, :]
    F = torch.nn.functional
    rows["decode_attention"] = dict(
        max_abs_err=err,
        ms=timer([lambda: ka.bp8_decode_attention(q, *main, 4096)]),
        plain_ms=timer([lambda: ka.bp8_decode_attention_ref(q, *main, 4096)]),
        library_ms=timer([lambda: F.scaled_dot_product_attention(
            qs, kt, vt, attn_mask=mask, scale=1.0)]),
        b=[bound(4 * B * KH * G * D * 2 + 2 * B * S * KH * D
                 + 2 * 4 * B * S * KH + 4 * B * S + 4 * B,
                 4 * B * KH * G * S * D, H100_F32_FLOPS_PER_S)])
    detail["nan_and_inf_checked"] = nan_and_inf_checks(torch, randn, dev)
    unfused_kernel_rows(torch, timer, randn,
                        lambda k, n: weight(k, n).float(), rows, detail, dev)
    return rows, detail


def nan_and_inf_checks(torch, randn, dev):
    """NaN where the plain version has NaN, its bits everywhere else: absmax
    (f32 and bf16, aligned and not, the special value first, in the middle
    and last), the fused matmul and MLP with a NaN or an Inf in x (and in
    the weight), the relu MLP with a NaN in w_gate, decode attention with
    a NaN in q (within 1e-5 elsewhere).  The reference propagates NaN
    through every max and the relu, and so do the plain versions."""
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import fused as kf
    from repro_torch.kernels import ops, ref

    def put(x, vals, at):
        x = x.clone()
        for j, v in enumerate(vals):
            x.view(-1)[(at + 3 * j) % x.numel()] = v
        return x

    def same(a, b, what, atol=0.0):
        nan_a, nan_b = torch.isnan(a), torch.isnan(b)
        if not torch.equal(nan_a, nan_b):
            fail(f"{what}: NaN at {int(nan_a.sum())} places, plain "
                 f"{int(nan_b.sum())}")
        ok = ~nan_b
        if atol == 0.0 and not torch.equal(a[ok], b[ok]):
            fail(f"{what}: differs from the plain version off the NaNs")
        if atol and not bool(((a[ok] - b[ok]).abs() <= atol).all()):
            fail(f"{what}: off by more than {atol} off the NaNs")
        return int(nan_b.sum())

    nan, inf = float("nan"), float("inf")
    specials = {"nan": (nan,), "inf": (inf,), "-inf": (-inf,),
                "nan+inf": (nan, inf)}
    checked = []
    base = randn(4097)
    for dtype in (torch.float32, torch.bfloat16):
        for x in (base[:4096].to(dtype), base[1:].to(dtype)):
            for name, vals in specials.items():
                for at in (0, 2048, x.numel() - 1):
                    t = put(x, vals, at)
                    for lo in (0.0, TINY):
                        n = same(kf.absmax(t, lo), ref.absmax_ref(t, lo),
                                 f"absmax {dtype} {name} at {at}")
                        if n != (name.startswith("nan")):
                            fail(f"absmax {dtype} {name}: NaN {n}")
    checked.append("absmax: f32/bf16 x aligned/unaligned x 4 x 3 places")
    x = randn(4, D)
    wq = (randn(D, KVD) * D ** -0.5).to(torch.bfloat16)
    for name, vals in specials.items():
        for xs, ws in ((put(x, vals, 5), wq),
                       (x, put(wq.float(), vals, 5).to(torch.bfloat16))):
            n = same(ops.oisma_matmul(xs, ws), ref.fused_matmul_ref(xs, ws),
                     f"fused matmul, {name}")
            if n != 4 * KVD:
                fail(f"fused matmul, {name}: NaN at {n} of {4 * KVD}")
    checked.append("fused matmul 4x2560x640: 4 specials in x and in w")
    up, gate = ((randn(D, FF) * D ** -0.5).to(torch.bfloat16)
                for _ in range(2))
    for act in ("silu", "gelu", "relu"):
        for name, vals in specials.items():
            xs = put(x, vals, 11)
            same(ops.oisma_mlp(xs, up, gate, act=act),
                 ref.fused_mlp_ref(xs, up, gate, act), f"MLP {act}, {name}",
                 atol=1e-5)
    g_nan = put(gate.float(), (nan,), 17).to(torch.bfloat16)
    n = same(ops.oisma_mlp(x, up, g_nan, act="relu"),
             ref.fused_mlp_ref(x, up, g_nan, "relu"), "MLP relu, NaN gate")
    if n != 4 * FF:
        fail(f"MLP relu, NaN in w_gate: NaN at {n} of {4 * FF}")
    checked.append("fused MLP 4x2560x6912: 3 acts x 4 specials in x; relu "
                   "with a NaN in w_gate")
    b, kh, g, d, s_ = 4, 8, 4, 80, 1024
    q = randn(b, kh, g, d) / math.sqrt(d)
    q[1, 2, 3, 7] = nan
    kc, ks = ka.quantize_kv(randn(b, s_, kh, d))
    vc, vs = ka.quantize_kv(randn(b, s_, kh, d))
    pos = torch.arange(s_, device=dev, dtype=torch.int32)[None].repeat(b, 1)
    qp = torch.full((b,), s_ - 1, dtype=torch.int32, device=dev)
    args = (q, kc, ks, vc, vs, pos, qp, None)
    n = same(ka.bp8_decode_attention(*args), ka.bp8_decode_attention_ref(
        *args), "decode attention, NaN in q", atol=1e-5)
    if n != d:
        fail(f"decode attention, NaN in q: NaN at {n}, want {d}")
    checked.append("decode attention B4 KH8 G4 D80 S1024, a NaN in q")
    print("NaN and Inf: " + "; ".join(checked) + ": as the plain versions")
    return checked


def kernel_device_ms(torch, timer, calls, part: str,
                     clean: bool = False) -> float:
    """Device time per run of ``calls`` of the kernels whose name holds
    ``part``, from the profiler (each call after the timer's L2 flush, as
    the event times are taken, or with ``clean`` its flush by reading; the
    flush's own kernel is not counted).  A session that recorded none of
    those kernels is taken again, up to 4 times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    runs = 5
    for f in calls:
        f()
    torch.cuda.synchronize()
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                for f in calls:
                    if clean:
                        timer.flush.max()
                    else:
                        timer.flush.zero_()
                    f()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and part in e.key)
        if us > 0:
            break
    return us / 1e3 / runs


def unfused_kernel_rows(torch, timer, randn, weight, rows, detail, dev):
    """The unfused pipeline's kernels against their plain versions: the
    codes matmul and the BP quantise bitwise (the quantise on f32 and bf16
    inputs), popcount exact; timed over one layer at 256 rows (the unfused
    path's prefill half)."""
    from repro_torch.kernels import bp_matmul as kb
    from repro_torch.kernels import ref
    from repro_torch.core.quantize import quantize_bp

    def codes_of(t):
        return ref.bp_quantize_ref(t, ref.tensor_scale(t))

    def ints(*shape, lo, hi):     # seeded integers in [lo, hi] as int8
        return (randn(*shape) * (hi - lo) / 4).round().clamp(lo, hi).to(
            torch.int8)

    # codes matmul: codes of real data at the layer's shapes and at every
    # row-block instance (M 1-256), plus ragged shapes and K 0
    checked = []
    for (m, k, n) in ([(4, D, HD), (4, D, KVD), (4, FF, D), (256, D, HD),
                       (256, D, FF), (256, FF, D)]
                      + [(m, D, KVD) for m in (1, 16, 64, 65, 128)]):
        xc, yc = codes_of(randn(m, k)), codes_of(weight(k, n))
        if not torch.equal(kb.bp_matmul(xc, yc), ref.bp_matmul_ref(xc, yc)):
            fail(f"codes matmul differs at {(m, k, n)}")
        checked.append((m, k, n))
    for (m, k, n) in [(130, 100, 96), (1, 7, 5), (100, 300, 130),
                      (129, 257, 130), (256, 6912, 40), (3, 0, 4),
                      (200, 0, 130)]:
        xc, yc = ints(m, k, lo=-9, hi=9), ints(k, n, lo=-9, hi=9)
        if not torch.equal(kb.bp_matmul(xc, yc), ref.bp_matmul_ref(xc, yc)):
            fail(f"codes matmul differs at {(m, k, n)}")
        checked.append((m, k, n))
    detail["bp_matmul_checked_shapes"] = checked
    launches = {}
    for (m, k, n) in [(4, D, HD), (64, D, KVD), (256, D, FF), (1, 7, 5),
                      (3, 0, 4)]:
        xc, yc = ints(m, k, lo=-9, hi=9), ints(k, n, lo=-9, hi=9)
        seen = kernels_enqueued(torch, lambda: kb.bp_matmul(xc, yc))
        if not 1 <= sum(seen.values()) <= 2:
            fail(f"codes matmul at {(m, k, n)}: {seen} enqueued (at most 2 "
                 f"kernels)")
        launches["x".join(map(str, (m, k, n)))] = sum(seen.values())
    detail["bp_matmul_kernels_per_call"] = launches
    M = 256
    xcs = {k: codes_of(randn(M, k)) for k in (D, FF)}
    ycs = [codes_of(weight(k, n)) for (k, n) in LAYER]
    pairs = [(xcs[k], yc) for (k, _), yc in zip(LAYER, ycs)]
    rows["bp_matmul"] = dict(
        max_abs_err=0.0,
        ms=timer([lambda a=a, b=b: kb.bp_matmul(a, b) for a, b in pairs]),
        plain_ms=timer([lambda a=a, b=b: ref.bp_matmul_ref(a, b)
                        for a, b in pairs], iters=3),
        library_ms=None,
        b=[bound(M * k + k * n + 4 * M * n, 2 * M * n * 8 * k,
                 H100_INT8_OPS_PER_S) for (k, n) in LAYER])
    detail["bp_matmul_256x2560x6912_ms"] = timer(
        [lambda: kb.bp_matmul(xcs[D], ycs[4])])
    x4 = xcs[D][:4].contiguous()
    detail["bp_matmul_4x2560x2560_ms"] = timer(
        [lambda: kb.bp_matmul(x4, ycs[0])])
    detail["bp_matmul_4x2560x2560_bound_ms"] = bound(
        4 * D + D * HD + 4 * 4 * HD, 2 * 4 * HD * 8 * D,
        H100_INT8_OPS_PER_S)[0]

    # BP quantise: the 14 operands of one layer at 256 rows (7 x, 7 w),
    # bitwise on f32 and on the weights held as bf16, plus half-level
    # boundaries, quantize_bp's codes and every finite bf16 pattern
    ins = [randn(M, k) for (k, _) in LAYER] + [weight(k, n)
                                                for (k, n) in LAYER]
    scales = [ref.tensor_scale(t) for t in ins]
    ins16 = ins[:7] + [t.to(torch.bfloat16) for t in ins[7:]]
    for t, sc in zip(ins + ins16[7:], scales + scales[7:]):
        if not torch.equal(kb.bp_quantize(t, sc),
                           ref.bp_quantize_ref(t.float(), sc)):
            fail(f"BP quantise differs at {tuple(t.shape)} {t.dtype}")
    v = torch.arange(-32768, 32768, dtype=torch.int32, device=dev)
    v = v.to(torch.int16).view(torch.bfloat16)
    every = v[torch.isfinite(v)]
    for sc in (5.128217, 0.37, TINY, 3e38, None):
        s_ = (ref.tensor_scale(every.float()) if sc is None
              else torch.full((1, 1), sc, device=dev))
        for t in (every, every[1:]):
            if not torch.equal(kb.bp_quantize(t, s_),
                               ref.bp_quantize_ref(t.float(), s_)):
                fail(f"BP quantise differs on the finite bf16 patterns "
                     f"(scale {s_.item()}, {t.numel()} values)")
    q = quantize_bp(ins[-1])
    if not torch.equal(kb.bp_quantize(ins[-1], scales[-1]), ref.to_codes(q)):
        fail("BP quantise differs from quantize_bp's codes")
    sc = scales[7]
    mid = (torch.arange(9, device=dev) + 0.5) * sc[0, 0] / 10
    edge = torch.cat([mid, torch.nextafter(mid, mid + 1),
                      torch.nextafter(mid, mid - 1)])
    edge = torch.cat([edge, -edge])
    if not torch.equal(kb.bp_quantize(edge, sc), ref.bp_quantize_ref(edge, sc)):
        fail("BP quantise differs at half-level boundaries")
    q32 = [lambda t=t, c=c: kb.bp_quantize(t, c) for t, c in zip(ins, scales)]
    q16 = [lambda t=t, c=c: kb.bp_quantize(t, c)
           for t, c in zip(ins16, scales)]
    rows["bp_quantize"] = dict(
        max_abs_err=0.0, ms=timer(q32),
        plain_ms=timer([lambda t=t, c=c: ref.bp_quantize_ref(t, c)
                        for t, c in zip(ins, scales)]),
        library_ms=None,
        b=[bound(5 * t.numel() + 4, 3 * t.numel(), H100_F32_FLOPS_PER_S)
           for t in ins])
    detail["bp_quantize_kernel_time_ms"] = kernel_device_ms(
        torch, timer, q32, "bp_quantize")
    detail["bp_quantize_bf16_weights_ms"] = timer(q16)
    detail["bp_quantize_bf16_weights_kernel_time_ms"] = kernel_device_ms(
        torch, timer, q16, "bp_quantize")
    detail["bp_quantize_bf16_weights_bound_ms"] = sum(
        bound((t.element_size() + 1) * t.numel() + 4, 3 * t.numel(),
              H100_F32_FLOPS_PER_S)[0] for t in ins16)

    # popcount: 0/1 tiles at the periphery's widths, then int8, uint8 and
    # bool tiles of any value, ragged and starting at every misalignment
    tiles = [ints(*shape, lo=0, hi=1)
             for shape in POPCOUNT_WIDTHS + [(300, 100)]]
    wide = ints(513, 1000, lo=-128, hi=127)
    tiles += [wide, wide.to(torch.uint8), wide > 0]
    flat = ints(77 * 257 + 16, lo=-128, hi=127)
    for buf in (flat, flat.view(torch.uint8), flat > 0):
        for c in (1, 15, 16, 33, 100, 257):
            tiles += [buf[o:o + 77 * c].view(77, c) for o in range(16)]
    for t in tiles:
        if not torch.equal(kb.popcount_accumulate(t),
                           ref.popcount_accumulate_ref(t)):
            fail(f"popcount differs at {tuple(t.shape)} {t.dtype}")
    for t in tiles[:len(POPCOUNT_WIDTHS)]:
        seen = kernels_enqueued(torch, lambda t=t: kb.popcount_accumulate(t))
        if sum(seen.values()) != 1:
            fail(f"popcount at {tuple(t.shape)}: {seen} enqueued (one "
                 f"kernel a call)")
    big = tiles[len(POPCOUNT_WIDTHS) - 1]          # (4096, 2048)
    r, c = big.shape
    rows["popcount"] = dict(
        max_abs_err=0.0,
        ms=timer([lambda: kb.popcount_accumulate(big)]),
        plain_ms=timer([lambda: ref.popcount_accumulate_ref(big)]),
        library_ms=timer([lambda: big.sum(-1, dtype=torch.int32)]),
        b=[bound(r * c + 4 * r, r * c, H100_F32_FLOPS_PER_S)])
    widths = {}
    for t in tiles[:len(POPCOUNT_WIDTHS)]:
        r, c = t.shape
        widths[f"{r}x{c}"] = {
            "ms": timer([lambda t=t: kb.popcount_accumulate(t)]),
            "kernel_ms": kernel_device_ms(
                torch, timer, [lambda t=t: kb.popcount_accumulate(t)],
                "popcount_kernel"),
            # the L2 flushed by reading: no dirty lines to write back
            "kernel_clean_l2_ms": kernel_device_ms(
                torch, timer, [lambda t=t: kb.popcount_accumulate(t)],
                "popcount_kernel", clean=True),
            "bound_ms": bound(r * c + 4 * r, r * c, H100_F32_FLOPS_PER_S)[0],
            "bits_sum_ms": timer([lambda t=t: t.sum(-1, dtype=torch.int32)]),
            "bits_sum_kernel_ms": kernel_device_ms(
                torch, timer, [lambda t=t: t.sum(-1, dtype=torch.int32)],
                "reduce_kernel")}
    detail["popcount_widths"] = widths
    print("popcount by width (event ms, profiler kernel ms, the same with "
          "the L2 clean, bound ms; bits.sum event and kernel ms): "
          + "; ".join(
              f"{k}: {v['ms']:.4f}, {v['kernel_ms']:.4f}, "
              f"{v['kernel_clean_l2_ms']:.4f}, "
              f"{v['bound_ms']:.5f}; {v['bits_sum_ms']:.4f}, "
              f"{v['bits_sum_kernel_ms']:.4f}" for k, v in widths.items()))


def seeded_pair(cfg):
    """The config's seeded weights on the card and a copy on the CPU:
    (cpu params, card params).  Seeded on the card, where the draw takes
    a fraction of a second (the CPU's draw of a full-width model takes
    tens of seconds)."""
    from repro_torch.models import build as build_model
    from repro_torch.models.params import init_params, tree_map
    p_gpu = init_params(build_model(cfg).schema(), seed=0, device="cuda")
    return tree_map(lambda t: t.to("cpu"), p_gpu), p_gpu


def make_engine(cfg, params, device, capture=None, temperature=0.0,
                seed=0, num_blocks=96, frames=None):
    """A paged engine (4 slots, block 16, chunk 64); ``frames`` (an
    encoder-decoder's (1, F, d_model) frame embeddings) are written into
    its frames buffer."""
    from repro_torch.models import build
    from repro_torch.serve.paged_engine import (PagedEngineConfig,
                                                PagedServeEngine)
    ecfg = PagedEngineConfig(slots=4, block_size=16, num_blocks=num_blocks,
                             max_prefill_tokens=64, eos_id=-1,
                             temperature=temperature, seed=seed)
    engine = PagedServeEngine(build(cfg), params, cfg, ecfg, device=device,
                              capture=capture)
    if frames is not None:
        engine.frames.copy_(frames)
    return engine


def serve(torch, cfg, params, prompts, max_new, device, engine=None,
          capture=None, frames=None):
    """Serve ``prompts`` on ``engine`` (a new one if None, with
    ``frames``); returns (tokens by request, seconds, engine)."""
    from repro_torch.serve.paged_engine import PagedRequest
    if engine is None:
        engine = make_engine(cfg, params, device, capture, frames=frames)
    reqs = [PagedRequest(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.run(reqs)
    if device == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, engine


#: the kernels of the served path (``bp8_fused`` over a ``bp8`` cache)
SERVED = tuple(n for n, path in PATHS.items() if path == "serve_bp8_fused")


def serve_captured_and_eager(torch, build, cfg, params, prompts,
                             num_blocks=96, kernels=None, frames=None):
    """Serve ``prompts`` (16 new tokens each) twice on one capturing paged
    engine (the first run captures each shape's graph; the second, timed,
    replays them, its launches zeroed just before and read just after)
    and once, after a short warm-up, on an eager engine of its own.  Fails
    unless the graphs stay within ``compile_shape_bounds()``, the three
    runs emit the same tokens, every kernel of the path (``kernels``,
    default ``SERVED``) launched, and every request has 16 tokens of the
    vocabulary.  Returns (the record, the capturing engine, the eager
    engine)."""
    torch.cuda.reset_peak_memory_stats()
    engine = make_engine(cfg, params, "cuda", num_blocks=num_blocks,
                         frames=frames)
    cold, cold_s, _ = serve(torch, cfg, params, prompts, 16, "cuda", engine)
    capture_s = engine.stats.snapshot()["capture_s"]
    before = engine.stats.snapshot()
    build.reset_launches()
    out, dt, _ = serve(torch, cfg, params, prompts, 16, "cuda", engine)
    launches = dict(build.LAUNCHES)
    run = {k: engine.stats.snapshot()[k] - before[k]
           for k in ("steps", "prefill_chunks", "decode_ticks")}
    peak = torch.cuda.max_memory_allocated() / 1e9
    counts, bounds = engine.compile_counts(), engine.compile_shape_bounds()
    torch.cuda.reset_peak_memory_stats()
    eager_engine = make_engine(cfg, params, "cuda", capture=False,
                               num_blocks=num_blocks, frames=frames)
    serve(torch, cfg, params, prompts[:1], 2, "cuda", eager_engine)
    eager, eager_s, _ = serve(torch, cfg, params, prompts, 16, "cuda",
                              eager_engine)
    eager_peak = torch.cuda.max_memory_allocated() / 1e9
    lens = [len(p) for p in prompts]
    n_tok = sum(len(v) for v in out.values())
    print(f"served {cfg.name}: {cfg.num_layers} layers, {len(out)} requests "
          f"(prompts {lens}), {n_tok} tokens; captured, warm: {dt:.3f}s = "
          f"{n_tok / dt:.2f} tok/s; eager: {eager_s:.3f}s = "
          f"{n_tok / eager_s:.2f} tok/s; captured, first run {cold_s:.3f}s "
          f"of which warm-ups and captures {capture_s:.3f}s; engine steps a "
          f"run {run['steps']}, prefill chunks {run['prefill_chunks']}, "
          f"decode ticks {run['decode_ticks']}")
    print(f"graphs per entry point {counts}, bound {bounds}; peak device "
          f"memory captured {peak:.2f} GB, eager {eager_peak:.2f} GB")
    print(f"served {cfg.name} launches (warm captured run, replays "
          f"counted): {launches}")
    if any(counts[k] > bounds[k] for k in bounds):
        fail(f"{cfg.name}: graphs {counts} exceed the bound {bounds}")
    if not out == cold == eager:
        fail(f"{cfg.name}: captured (first and second run) and eager tokens "
             f"differ")
    for name in kernels or SERVED:
        if launches.get(name, 0) <= 0:
            fail(f"{cfg.name}: kernel {name} was not launched")
    for rid, toks in out.items():
        if len(toks) != 16 or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"{cfg.name} request {rid}: bad output {toks}")
    return {"model": cfg.name, "layers": cfg.num_layers,
            "requests": len(out), "prompt_lens": lens, "new_tokens": n_tok,
            "seconds": dt, "tokens_per_s": n_tok / dt,
            "eager_seconds": eager_s, "eager_tokens_per_s": n_tok / eager_s,
            "first_run_seconds": cold_s, "capture_s": capture_s,
            "graphs": counts, "graph_bounds": bounds,
            "engine_steps": run["steps"],
            "prefill_chunks": run["prefill_chunks"],
            "decode_ticks": run["decode_ticks"], "launches": launches,
            "peak_mem_gb": peak, "eager_peak_mem_gb": eager_peak}, \
        engine, eager_engine


#: served-path kernels by the device names they run under
SERVED_KERNEL_NAMES = (("absmax", "absmax_kernel"),
                       ("decode_attention", "decode_partial_kernel"))


def served_kernel(name: str):
    """Which served-path kernel a device activity is, by its name: the
    integer core's instances by their template's NW (1: the fused matmul,
    2: the MLP), with f32 x (the codes matmul's x is int8)."""
    import re
    for kernel, part in SERVED_KERNEL_NAMES:
        if part in name:
            return kernel
    m = re.search(r"bp_mma_kernel<\s*\d+\s*,\s*[^,]+,\s*(\d+)\s*,"
                  r"\s*float", name)
    return None if m is None else {"1": "fused_matmul",
                                   "2": "fused_mlp"}.get(m.group(1))


#: device kernels by kind, first match wins: (kind, name parts)
DEVICE_KINDS = (
    ("gemm (cuBLAS/CUTLASS: expert bmm, logits, f32 einsums)",
     ("gemm", "cutlass", "xmma", "cublas", "splitk", "nvjet", "gemv")),
    ("sort (routing)", ("sort", "radix")),
    ("scatter/gather/index (dispatch, combine, cache)",
     ("scatter", "gather", "index", "cumsum", "scan")),
    ("softmax and reductions", ("softmax", "reduce")),
    ("copies and casts", ("copy",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")))


def device_kind(name: str) -> str:
    """A device kernel's kind for a profile's breakdown: the BP kernels by
    name (``served_kernel``), the rest by ``DEVICE_KINDS``."""
    bp = served_kernel(name)
    if bp is not None:
        return bp
    low = name.lower()
    for kind, parts in DEVICE_KINDS:
        if any(p in low for p in parts):
            return kind
    return "other"


def profile_serving(torch, engine, cfg, params, prompts, prompt_len=64,
                    new=8):
    """Device time by kernel, the card's idle share, and the host's
    ``paged.*`` ranges over a short serving run on ``engine`` (the prompts
    cut to ``prompt_len`` tokens, ``new`` new tokens each).  The run is
    served once unprofiled first, so that a capturing engine holds every
    graph it needs before the profiled run."""
    cut = [p[:prompt_len] for p in prompts]
    serve(torch, cfg, params, cut, new, "cuda", engine)
    return profile_run(torch, lambda: serve(torch, cfg, params, cut, new,
                                            "cuda", engine)[1],
                       engine.capture)


def profile_run(torch, run, capture: bool):
    """``profile_serving``'s report of one call of ``run`` (which serves
    and returns its wall seconds) under ``torch.profiler``: device time
    by kernel and kind, the idle share, and the host's ``paged.*``
    ranges."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_s = run()
    rows, host = [], {}
    for ev in prof.key_averages():
        if ev.key.startswith("paged."):
            if ev.device_type != DeviceType.CUDA:   # (and its annotation
                host[ev.key] = {"ms": ev.cpu_time_total / 1e3,  # on the
                                "calls": ev.count}  # device: not a kernel)
            continue
        if ev.device_type != DeviceType.CUDA:
            continue        # host ops: their kernels are counted below
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            rows.append((us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    kinds = {}
    for us, k, n in rows:
        kind = device_kind(k)
        c, t = kinds.get(kind, (0, 0.0))
        kinds[kind] = (c + n, t + us / 1e3)
    out = {"capture": capture, "wall_s": wall_s,
           "device_busy_s": busy_s, "idle_share": 1.0 - busy_s / wall_s,
           "by_kind": {k: {"launches": c, "ms": t} for k, (c, t) in
                       sorted(kinds.items(), key=lambda kv: -kv[1][1])},
           "host_ranges": {k: dict(v, share_of_wall=v["ms"] / 1e3 / wall_s)
                           for k, v in sorted(host.items())},
           "served_kernels": sorted({served_kernel(k) for _, k, _ in rows}
                                    - {None}),
           "top": [{"name": k[:120], "ms": us / 1e3, "calls": n,
                    "share_of_busy": us / 1e6 / busy_s}
                   for us, k, n in rows[:15]],
           # dtype casts and other copies (direct_copy_kernel)
           "copies": [{"name": k[:120], "ms": us / 1e3, "calls": n}
                      for us, k, n in rows if "copy" in k.lower()]}
    mode = "captured" if capture else "eager"
    print(f"profile ({mode}): wall {wall_s:.3f}s, device busy "
          f"{busy_s:.3f}s, idle share {out['idle_share']:.3f}")
    for r in out["top"][:8]:
        print(f"  {r['share_of_busy']:.3f} {r['ms']:.1f} ms x{r['calls']} "
              f"{r['name']}")
    print("  device time by kind (ms, launches): " + ", ".join(
        f"{k} {v['ms']:.1f} x{v['launches']}"
        for k, v in out["by_kind"].items()))
    for r in out["copies"]:
        print(f"  copies: {r['ms']:.2f} ms x{r['calls']} {r['name'][:80]}")
    print("  host ranges (ms, share of wall): " + ", ".join(
        f"{k} {v['ms']:.1f} {v['share_of_wall']:.3f}"
        for k, v in out["host_ranges"].items()))
    return out


def decode_layer_launches(torch, cfg, params):
    """Device work (kernels, memsets, copies) that one decode layer adds to
    a decode step of 4 rows, and its device time: the profile of a
    3-layer step less that of a 2-layer step (same weights; ``params``
    must hold 3 layers or more).  The total counts the host's records of
    the launches (``ENQUEUE_CALLS``), which the profiler never drops; the
    split by kernel name comes from the device's records, which a session
    now and then loses (so it may sum to less).  Each step is profiled
    twice and the second kept, so that the profiler's start-up loses
    nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import build as build_model
    steps = []
    for layers in (2, 3):
        c = dataclasses.replace(cfg, num_layers=layers)
        model = build_model(c)
        cache = model.init_cache(4, 256, "cuda")
        tokens = torch.ones((4, 1), dtype=torch.long, device="cuda")
        pos = torch.full((4,), 100, dtype=torch.int32, device="cuda")
        for _ in range(2):
            model.decode_step(params, tokens, cache, pos)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                model.decode_step(params, tokens, cache, pos)
                torch.cuda.synchronize()
        avgs = prof.key_averages()
        evs = [e for e in avgs if e.device_type == DeviceType.CUDA]
        steps.append(({e.key: e.count for e in evs},
                      sum(getattr(e, "self_device_time_total", 0)
                          for e in evs),
                      sum(e.count for e in avgs if e.key in ENQUEUE_CALLS)))
    (two, us2, host2), (three, us3, host3) = steps
    per = {k: three.get(k, 0) - two.get(k, 0) for k in set(two) | set(three)}
    per = {k: v for k, v in sorted(per.items(), key=lambda kv: -kv[1]) if v}
    total = host3 - host2
    copies = sum(v for k, v in per.items() if "copy" in k.lower())
    print(f"decode layer launches: {total} enqueued a layer (host records; "
          f"device records {sum(per.values())}, {copies} copy kernels), "
          f"{(us3 - us2) / 1e3:.4f} ms of device time; by kernel: "
          + ", ".join(f"{v} {k[:60]}" for k, v in per.items()))
    return {"total": total, "device_records": sum(per.values()),
            "copies": copies, "by_kernel": per,
            "device_ms": (us3 - us2) / 1e3,
            "step_2_layers": host2, "step_3_layers": host3}


def phase_unfused(torch, timer, build, dev="cuda"):
    """The unfused pipeline at full width, with its periphery; returns the
    path's launch counts and a detail record."""
    from repro_torch.core.bp import bitstreams_bp8
    from repro_torch.kernels import bp_matmul as kb
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    def weight(k, n):
        return randn(k, n, std=k ** -0.5).to(torch.bfloat16).float()

    ws = {kn: weight(*kn) for kn in dict.fromkeys(LAYER)}
    cases = [(randn(m, k), ws[(k, n)]) for m in (4, 256) for (k, n) in LAYER]
    m, k, n = QWEN_UP
    cases.append((randn(m, k), weight(k, n)))
    # periphery: 32 x 64 outputs over K = 256 (rows of 2048 signed bits)
    px, pw = randn(32, 256), weight(256, 64)
    tab_r, tab_l = (torch.as_tensor(bitstreams_bp8(w), dtype=torch.int8,
                                    device=dev) for w in ("right", "left"))
    # the same weights held as bf16, as the model holds them (exact: they
    # were rounded to bf16), read as stored by the unfused path too
    w16 = {id(w): w.to(torch.bfloat16) for _, w in cases}
    torch.cuda.synchronize()

    build.reset_launches()
    t0 = time.perf_counter()
    outs = [ops.oisma_matmul(x, w, impl="unfused") for x, w in cases]
    outs16 = [ops.oisma_matmul(x, w16[id(w)], impl="unfused")
              for x, w in cases]
    xc = kb.bp_quantize(px, ref.tensor_scale(px))
    wc = kb.bp_quantize(pw, ref.tensor_scale(pw))
    bits = (tab_r[xc.abs().long()][:, :, None, :]
            * tab_l[wc.abs().long()][None]
            * (torch.sign(xc)[:, :, None] * torch.sign(wc)[None])[..., None])
    rows = bits.permute(0, 2, 1, 3).reshape(32 * 64, 256 * 8).contiguous()
    periphery = ops.popcount_accumulate(rows).reshape(32, 64)
    product = ops.bp_matmul_codes(xc, wc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)

    for (x, w), a, a16 in zip(cases, outs, outs16):
        b = ops.oisma_matmul(x, w)
        if not torch.equal(a, b):
            fail(f"unfused != fused at {tuple(x.shape)} @ {tuple(w.shape)}: "
                 f"max {(a - b).abs().max().item()}")
        # the served form: the same weight held as bf16 (it is exact there)
        if not torch.equal(a, ops.oisma_matmul(x, w16[id(w)])):
            fail(f"unfused != fused with a bf16 weight at {tuple(x.shape)} "
                 f"@ {tuple(w.shape)}")
        if not torch.equal(a16, b):
            fail(f"unfused with a bf16 weight != fused at {tuple(x.shape)} "
                 f"@ {tuple(w.shape)}: max {(a16 - b).abs().max().item()}")
    if not torch.equal(periphery.to(torch.float32), product):
        fail("periphery popcounts differ from the codes matmul")
    layer = {}
    for m in (4, 256):
        pairs = [(x, w) for x, w in cases[:-1] if x.shape[0] == m]
        layer[m] = dict(
            unfused_ms=timer([lambda x=x, w=w: ops.oisma_matmul(
                x, w, impl="unfused") for x, w in pairs]),
            unfused_bf16_weights_ms=timer([lambda x=x, w=w16[id(w)]:
                                           ops.oisma_matmul(
                                               x, w, impl="unfused")
                                           for x, w in pairs]),
            fused_ms=timer([lambda x=x, w=w: ops.oisma_matmul(x, w)
                            for x, w in pairs]))
    x, w = cases[-1]
    qwen = dict(unfused_ms=timer([lambda: ops.oisma_matmul(
        x, w, impl="unfused")], iters=3),
        fused_ms=timer([lambda: ops.oisma_matmul(x, w)], iters=3))
    qs = "x".join(map(str, QWEN_UP))
    print(f"unfused path: {len(cases)} matmuls (7 per layer at M 4 and 256, "
          f"qwen2-72b {qs}), each with an f32 and a bf16 weight, + "
          f"periphery in {wall:.3f}s, all equal to the fused path bitwise; "
          f"launches {launches}")
    for m, r in layer.items():
        was = (f" ({EARLIER}: {EARLIER_MS['fused_layer_256_rows_ms']})"
               if m == 256 else "")
        print(f"  one layer, M {m}: unfused {r['unfused_ms']:.4f} ms (bf16 "
              f"weights {r['unfused_bf16_weights_ms']:.4f}), fused "
              f"{r['fused_ms']:.4f} ms{was}")
    print(f"  qwen2-72b {qs}: unfused {qwen['unfused_ms']:.4f} ms, fused "
          f"{qwen['fused_ms']:.4f} ms ({EARLIER}: "
          f"{EARLIER_MS['qwen2_72b_fused_ms']})")
    return launches, {"wall_s": wall, "launches": launches,
                      "layer_ms": layer, f"qwen2_72b_{qs}_ms": qwen}


def f32_ulps(torch, got, want) -> float:
    """Largest |got - want| in ulps of max(|want|, 1), in f32."""
    scale = torch.clamp(want.abs(), min=1.0)
    ulp = torch.nextafter(scale, torch.full_like(scale, math.inf)) - scale
    return float(((got.double() - want.double()).abs() / ulp.double()).max())


def sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def sampling_on_card(torch, dev="cuda"):
    """Threefry keys, random bits (both layouts) and uniforms on the card
    bitwise the CPU's, for 4 seeds x rids 0-5 x steps 0-7 at V 32000; the
    gumbel noise's largest difference in ulps (of max(|g|, 1)); tokens of
    (4, 32000) logits equal at T 0.5, 0.8 and 1.0, a dead row among them;
    and the host time of one ``sample_tokens`` call of 4 live rows (the
    work of ``paged.sample`` in a decode tick) at T 0.8 and at T 0."""
    import numpy as np
    from repro_torch.serve import sampling as S
    vocab = 32000
    rows = [(rid, step) for rid in range(6) for step in range(8)]
    ulps = 0.0
    for seed in range(4):
        keys = S.row_keys(seed, rows, "cpu")
        if not torch.equal(S.row_keys(seed, rows, dev).cpu(), keys):
            fail(f"seed {seed}: the card's threefry keys differ")
        for part in (True, False):
            bits = S.random_bits(keys, vocab, part)
            cbits = S.random_bits(keys.to(dev), vocab, part)
            if not torch.equal(cbits.cpu(), bits):
                fail(f"seed {seed}, partitionable={part}: random bits differ")
            u, cu = S.uniform(bits), S.uniform(cbits).cpu()
            if not torch.equal(cu.view(torch.int32), u.view(torch.int32)):
                fail(f"seed {seed}, partitionable={part}: uniforms differ")
            ulps = max(ulps, f32_ulps(torch, S.gumbel(cu.to(dev)).cpu(),
                                      S.gumbel(u)))
    rng = np.random.default_rng(17)
    logits = torch.from_numpy((rng.normal(size=(4, vocab)) * 3)
                              .astype(np.float32))
    clogits = logits.to(dev)
    draws = 0
    for seed in range(4):
        for step in range(4):
            for batch in ([(0, step), (1, step), (2, step), (3, step)],
                          [(4, step), None, (5, step), (0, step + 4)]):
                for t in (0.5, 0.8, 1.0):
                    kw = dict(seed=seed, temperature=t)
                    got = S.sample_tokens(clogits, batch, **kw)
                    want = S.sample_tokens(logits, batch, **kw)
                    if not np.array_equal(got, want):
                        fail(f"sampled tokens differ, seed {seed}, rows "
                             f"{batch}, T {t}: card {got}, cpu {want}")
                    draws += 1
    live = [(r, 3) for r in range(4)]
    host_ms = {}
    for t in (0.8, 0.0):
        S.sample_tokens(clogits, live, seed=0, temperature=t)
        sync(torch, dev)
        t0 = time.perf_counter()
        for _ in range(50):
            S.sample_tokens(clogits, live, seed=0, temperature=t)
        host_ms[t] = (time.perf_counter() - t0) / 50 * 1e3
    print(f"sampling on the card: keys, bits (both layouts) and uniforms "
          f"bitwise the CPU's (4 seeds x 48 (rid, step) x 32000); gumbel "
          f"noise within {ulps:.3f} ulp of max(|g|, 1); {draws} batches of "
          f"(4, 32000) sampled as on the CPU; sample_tokens of 4 live rows "
          f"(paged.sample's work a decode tick): T 0.8 {host_ms[0.8]:.3f} ms,"
          f" T 0 {host_ms[0.0]:.3f} ms (host clock, the tokens copied out)")
    return {"gumbel_max_ulps": ulps, "token_batches": draws,
            "sample_ms_t08": host_ms[0.8], "sample_ms_t0": host_ms[0.0]}


def lockstep_engine(cfg, params, device, slots=1, temperature=0.8,
                    capture=None):
    from repro_torch.models import build as build_model
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    return ServeEngine(build_model(cfg), params, cfg, EngineConfig(
        slots=slots, max_len=512, eos_id=-1, temperature=temperature),
        device=device, capture=capture)


def serve_lockstep(torch, engine, prompts, max_new, seed, alone):
    """Serve ``prompts`` on the lock-step ``engine`` (each alone, or all in
    one call); returns (tokens by request, seconds)."""
    from repro_torch.serve.engine import Request
    reqs = [Request(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    sync(torch, engine.device)
    t0 = time.perf_counter()
    out = {}
    for batch in ([[r] for r in reqs] if alone else [reqs]):
        out.update(engine.run(batch, seed=seed))
    sync(torch, engine.device)
    return out, time.perf_counter() - t0


def lockstep_replay_vs_eager(torch, engine, params, prompt, rng):
    """Two decode steps of the lock-step engine's captured graph (one row,
    the contiguous ``max_len`` cache plus any prefix, one scalar position)
    against eager ``decode_step`` calls on the same inputs: logits and
    caches bitwise."""
    from repro_torch.models.params import tree_leaves
    with torch.inference_mode():        # the engine's buffers are made so
        _replay_vs_eager(torch, engine, params, prompt, rng)
    _, cache, _ = engine._decode_inputs(1)
    slots = [t.shape[-1] for path, t in tree_leaves(cache)
             if path[-1] == "pos"]
    what = (f"{slots[0]}-slot contiguous cache" if slots
            else "recurrent state only")
    print(f"lock-step decode ({engine.cfg.name}, 1 row, {what}, scalar "
          f"position): 2 replayed steps bitwise equal to eager (logits and "
          f"cache)")


def _replay_vs_eager(torch, engine, params, prompt, rng):
    from repro_torch.models.params import tree_leaves
    model = engine.model
    tok, cache, pos = engine._decode_inputs(1)
    max_len = engine.ecfg.max_len
    _, fresh = model.prefill(params, engine._make_batch([prompt],
                                                        len(prompt)), max_len)
    dev, p0 = engine.device, len(prompt) + engine.cfg.num_prefix_tokens

    def clone(tree):
        return {k: clone(v) if isinstance(v, dict) else v.clone()
                for k, v in tree.items()}

    for step in range(2):
        t = torch.as_tensor(rng.integers(3, model.cfg.vocab_size, (1, 1)),
                            device=dev)
        p = torch.tensor(p0 + step, dtype=torch.int32, device=dev)
        want, want_cache = model.decode_step(params, t, clone(fresh), p)
        tok.copy_(t)
        pos.copy_(p)
        for (_, leaf), (_, src) in zip(tree_leaves(cache),
                                       tree_leaves(fresh)):
            leaf.copy_(src)
        got, got_cache = engine._decode((1, max_len))
        if not torch.equal(got, want):
            fail(f"lock-step decode replayed: logits differ from eager by "
                 f"{(got - want).abs().max().item()}")
        if not all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(tree_leaves(got_cache), tree_leaves(want_cache))):
            fail("lock-step decode replayed: the cache differs from eager")
        fresh = want_cache


def engines_at_temperature(torch, build, full, params, rng, dev="cuda"):
    """6 requests (prompts of 32-200 tokens, 16 new tokens, seed 7, T 0.8)
    on the capturing paged engine (slots 4) and on the lock-step engine,
    each request served alone (slots 1, max_len 512): tokens/s of both
    (second runs), the lock-step engine's graph count and launches; the
    lock-step replay bitwise equal to eager; and at one layer, the card's
    tokens equal the CPU's for requests 0 and 2 (32 and 40 tokens) on the
    paged engine and for request 0 served alone on the lock-step engine,
    4 new tokens each (the CPU's plain path costs seconds a call)."""
    lens = [32, 200, 40] + [int(n) for n in rng.integers(32, 201, 3)]
    prompts = [rng.integers(3, full.vocab_size, n).astype("int32")
               for n in lens]
    paged = make_engine(full, params, dev, temperature=0.8, seed=7)
    serve(torch, full, params, prompts, 16, dev, paged)
    paged_out, paged_s, _ = serve(torch, full, params, prompts, 16, dev,
                                  paged)
    paged.ecfg.temperature = 0.0        # the same graphs and requests, greedy
    _, greedy_s, _ = serve(torch, full, params, prompts, 16, dev, paged)
    lock = lockstep_engine(full, params, dev)
    serve_lockstep(torch, lock, prompts, 16, 7, alone=True)
    build.reset_launches()
    lock_out, lock_s = serve_lockstep(torch, lock, prompts, 16, 7,
                                      alone=True)
    lock_launches = dict(build.LAUNCHES)
    counts = lock.compile_counts()
    n_tok = sum(len(v) for v in lock_out.values())
    same = sum(paged_out[i] == lock_out[i] for i in lock_out)
    for out in (paged_out, lock_out):
        for rid, toks in out.items():
            if len(toks) != 16 or not all(0 <= t < full.vocab_size
                                          for t in toks):
                fail(f"T 0.8 request {rid}: bad output {toks}")
    if counts != {"decode_step": 1}:
        fail(f"lock-step engine served alone: {counts} decode graphs, not 1")
    for name in ("absmax", "fused_matmul", "fused_mlp", "decode_attention"):
        if dev == "cuda" and lock_launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the lock-step path")
    print(f"T 0.8, seed 7, {len(prompts)} requests (prompts {lens}), "
          f"{n_tok} tokens: paged (captured, slots 4) {paged_s:.3f}s = "
          f"{n_tok / paged_s:.2f} tok/s (the same at T 0: {greedy_s:.3f}s = "
          f"{n_tok / greedy_s:.2f} tok/s); lock-step served alone (captured, "
          f"slots 1, max_len 512) {lock_s:.3f}s = {n_tok / lock_s:.2f} "
          f"tok/s, decode graphs {counts}, launches {lock_launches}")
    print(f"  paged and lock-step streams equal for {same} of "
          f"{len(prompts)} requests (not required in bp8_fused: a matmul "
          f"call scales its activation by one absmax, so a stream depends "
          f"on its batch and prefill chunks, in the reference too)")
    lockstep_replay_vs_eager(torch, lock, params, prompts[1], rng)
    del paged, lock
    # the card against the CPU at CPU_CHECK_LAYERS, both engines
    cfg2 = dataclasses.replace(full, num_layers=CPU_CHECK_LAYERS)
    p_cpu, p_gpu = seeded_pair(cfg2)
    two = [prompts[0], prompts[2]]
    t0 = time.perf_counter()
    outs = {}
    for side, d, p in (("card", dev, p_gpu), ("cpu", "cpu", p_cpu)):
        eng = make_engine(cfg2, p, d, temperature=0.8, seed=7)
        outs[side, "paged"] = serve(torch, cfg2, p, two, 4, d, eng)[0]
        outs[side, "lock"] = serve_lockstep(
            torch, lockstep_engine(cfg2, p, d), two[:1], 4, 7,
            alone=True)[0]
    cpu_s = time.perf_counter() - t0
    print(f"  card vs cpu at T 0.8 ({CPU_CHECK_LAYERS} layer, full width, "
          f"prompts "
          f"{[len(p) for p in two]}, 4 tokens): paged card "
          f"{outs['card', 'paged']}, cpu {outs['cpu', 'paged']}; lock-step "
          f"card {outs['card', 'lock']}, cpu {outs['cpu', 'lock']} "
          f"({cpu_s:.1f}s)")
    for kind in ("paged", "lock"):
        if outs["card", kind] != outs["cpu", kind]:
            fail(f"T 0.8: the {kind} engine's card and CPU tokens differ")
    return {"prompt_lens": lens, "new_tokens": n_tok,
            "paged_seconds": paged_s, "paged_tokens_per_s": n_tok / paged_s,
            "paged_t0_seconds": greedy_s,
            "paged_t0_tokens_per_s": n_tok / greedy_s,
            "lockstep_seconds": lock_s,
            "lockstep_tokens_per_s": n_tok / lock_s,
            "lockstep_graphs": counts, "lockstep_launches": lock_launches,
            "streams_equal_across_engines": same, "card_vs_cpu_s": cpu_s}


def obs_and_traffic(torch, full, params, out_dir, dev="cuda"):
    """``run_traffic`` (32 requests, offered load 0.2) on a capturing paged
    engine at full width with a registry, a tracer and a watchdog: the
    step-based record, wall seconds and tokens/s, the watchdog's report
    (within ``compile_shape_bounds()``), the ``serve.*`` totals, the
    Chrome trace (``chiprun_out/serve_trace.json``) and its spans; the
    ``kernels.*`` counters of that run (0: warm-ups, captures and replays
    record nothing) and of 2 requests on an eager engine."""
    import numpy as np
    from repro_torch.kernels import metrics as kmetrics
    from repro_torch.models import build as build_model
    from repro_torch.obs import (MetricsRegistry, Observability,
                                 RetraceWatchdog, Tracer)
    from repro_torch.serve.paged_engine import (PagedEngineConfig,
                                                PagedServeEngine)
    from repro_torch.serve.traffic import TrafficConfig, run_traffic
    reg = MetricsRegistry()
    obs = Observability(reg, Tracer(), RetraceWatchdog(reg))
    ecfg = PagedEngineConfig(slots=4, block_size=8, num_blocks=64,
                             max_prefill_tokens=16)
    engine = PagedServeEngine(build_model(full), params, full, ecfg,
                              device=dev, obs=obs)
    tcfg = TrafficConfig(num_requests=32, offered_load=0.2,
                         vocab=full.vocab_size)
    kreg = MetricsRegistry()
    prev = kmetrics.set_registry(kreg)
    try:
        sync(torch, dev)
        t0 = time.perf_counter()
        record = run_traffic(engine, tcfg)
        sync(torch, dev)
        wall = time.perf_counter() - t0
        captured_kernels = kreg.snapshot()
        kmetrics.set_registry(MetricsRegistry())
        serve(torch, full, params, [p.astype("int32") for p in
              (np.arange(3, 40), np.arange(5, 21))], 4, dev,
              make_engine(full, params, dev, capture=False))
        eager_kernels = kmetrics.get_registry().snapshot()
    finally:
        kmetrics.set_registry(prev)
    report = obs.watchdog.report()
    bounds = engine.compile_shape_bounds()
    obs.watchdog.assert_ok()
    if any(r["compiled"] > bounds[k] for k, r in report.items()):
        fail(f"watchdog {report} over the bounds {bounds}")
    serve_totals = {r["name"]: r.get("value", r.get("count"))
                    for r in reg.snapshot() if r["name"].startswith("serve.")}
    trace_path = out_dir / "serve_trace.json"
    obs.tracer.export(str(trace_path))
    spans = sum(e.ph == "X" for e in obs.tracer.events)
    if record["completed"] != tcfg.num_requests or obs.tracer.open_spans():
        fail(f"traffic run: {record['completed']} of {tcfg.num_requests} "
             f"completed, {obs.tracer.open_spans()} spans open")
    if engine.capture and any(r["name"] == "kernels.calls"
                              for r in captured_kernels):
        fail(f"kernels.* recorded on the capturing engine: "
             f"{captured_kernels}")
    eager_calls = {r["labels"]["kernel"]: r["value"] for r in eager_kernels
                   if r["name"] == "kernels.calls"}
    if not eager_calls.get("fused_matmul") or not eager_calls.get(
            "fused_mlp"):
        fail(f"kernels.calls on the eager engine: {eager_kernels}")
    capture_s = engine.stats.snapshot()["capture_s"]
    print(f"traffic (32 requests, offered load 0.2, capturing paged "
          f"engine, slots 4, block 8, chunk 16): {record}; wall "
          f"{wall:.3f}s = {record['output_tokens'] / wall:.2f} tok/s, of "
          f"which warm-ups and captures {capture_s:.3f}s")
    print(f"  watchdog {report} (bounds {bounds}); serve.* {serve_totals}")
    print(f"  trace: {len(obs.tracer.events)} events, {spans} spans -> "
          f"{out_dir.name}/{trace_path.name}; kernels.* on the capturing "
          f"engine {captured_kernels}; kernels.calls on an eager engine "
          f"(2 requests x 4 tokens) {eager_calls}")
    return {"record": record, "wall_s": wall, "capture_s": capture_s,
            "tokens_per_s": record["output_tokens"] / wall,
            "watchdog": report, "bounds": bounds, "serve": serve_totals,
            "trace_events": len(obs.tracer.events), "spans": spans,
            "kernels_captured": captured_kernels,
            "kernels_eager_calls": eager_calls}


#: the training path's rows: 8 x 128 tokens (the launcher's defaults),
#: and a ragged count that is no multiple of the kernels' row tiles
TRAIN_ROWS = (1024, 1000)


def encode_forms_ms(torch, timer, dev="cuda"):
    """``bp8``'s bitplane encode as one comparison with the plane thresholds
    (the port's form) against the earlier gather from the dataset's
    (10, 8) table, on the levels of one decode step's x (4 x 2560) and of
    the wq weight (2560 x 2560) and the up weight (2560 x 6912); both give
    the same planes bitwise."""
    from repro_torch.core import bp_matmul as bpm
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    levels = [torch.randint(0, 10, s, generator=gen, device=dev,
                            dtype=torch.int8)
              for s in ((4, D), (D, HD), (D, FF))]

    def gather(lv, which):
        return bpm._table(which, torch.float32, lv.device)[lv.long()]

    for lv in levels:
        for which in ("right", "left"):
            if not torch.equal(bpm.encode_bitplanes(lv, which, torch.float32),
                               gather(lv, which)):
                fail(f"comparison encode differs from the table at "
                     f"{tuple(lv.shape)} ({which})")
    new = timer([lambda lv=lv: bpm.encode_bitplanes(lv, "left",
                                                    torch.float32)
                 for lv in levels])
    old = timer([lambda lv=lv: gather(lv, "left") for lv in levels])
    print(f"bp8 bitplane encode (x 4x{D}, w {D}x{HD} and {D}x{FF}, f32 "
          f"planes): comparison {new:.4f} ms, table gather {old:.4f} ms")
    return {"comparison_ms": new, "gather_ms": old}


def phase_train_kernels(torch, timer, dev="cuda"):
    """absmax, the fused matmul and the fused MLP at the training path's
    rows (TRAIN_ROWS) and every h2o-danube-1.8b projection shape, against
    their plain versions: absmax and the matmul bitwise, the MLP within
    1e-5 relative for silu and gelu and bitwise for relu; at 1024 rows the
    kernels of one layer's forward are timed (phase 2's timer) beside
    their bound.  Returns rows for the kernels line."""
    from repro_torch.kernels import fused as kf
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(8)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    def nbytes(t):
        return t.numel() * t.element_size()

    mm = [(D, HD), (D, KVD), (D, KVD), (HD, D), (FF, D)]
    ws = [randn(k, n, std=k ** -0.5).to(torch.bfloat16) for k, n in mm]
    up, gate = (randn(D, FF, std=D ** -0.5).to(torch.bfloat16)
                for _ in range(2))
    rows, err = {}, 0.0
    for m in TRAIN_ROWS:
        xs = {k: randn(m, k) for k in (D, FF)}
        am_in = [xs[k] for k, _ in mm] + ws + [xs[D], up, gate]
        for t in am_in:
            if not torch.equal(kf.absmax(t, TINY), ref.absmax_ref(t, TINY)):
                fail(f"absmax differs at {tuple(t.shape)} {t.dtype}")
        sc = {id(t): kf.absmax(t, TINY) for t in am_in}
        mm_args = [(xs[k], w, sc[id(xs[k])], sc[id(w)])
                   for (k, _), w in zip(mm, ws)]
        for a in mm_args:
            got, want = kf.fused_bp_matmul(*a), ref.fused_matmul_ref(*a)
            if not torch.equal(got, want):
                fail(f"fused matmul differs at M {m}, {tuple(a[1].shape)}: "
                     f"max {(got - want).abs().max().item()}")
        x = xs[D]
        mlp_args = (x, up, gate, sc[id(x)], sc[id(up)], sc[id(gate)])
        for act in ("silu", "gelu", "relu"):
            got = kf.fused_mlp(*mlp_args, act)
            want = ref.fused_mlp_ref(x, up, gate, act, *mlp_args[3:])
            e = ((got - want).abs().max()
                 / want.abs().max().clamp_min(1.0)).item()
            if act == "relu" and not torch.equal(got, want):
                fail(f"fused MLP (relu) not bitwise at M {m}: {e:.3g}")
            if not math.isfinite(e) or e > 1e-5:
                fail(f"fused MLP ({act}) off by {e:.3g} at M {m}")
            err = max(err, (got - want).abs().max().item())
        if m != TRAIN_ROWS[0]:
            continue
        rows["absmax"] = dict(
            max_abs_err=0.0,
            ms=timer([lambda t=t: kf.absmax(t, TINY) for t in am_in]),
            plain_ms=timer([lambda t=t: ref.absmax_ref(t, TINY)
                            for t in am_in]),
            library_ms=timer([lambda t=t: torch.amax(t.abs())
                              for t in am_in]),
            b=[bound(nbytes(t) + 4, t.numel(), H100_F32_FLOPS_PER_S)
               for t in am_in])
        rows["fused_matmul"] = dict(
            max_abs_err=0.0,
            ms=timer([lambda a=a: kf.fused_bp_matmul(*a) for a in mm_args]),
            plain_ms=timer([lambda a=a: ref.fused_matmul_ref(*a)
                            for a in mm_args], iters=3),
            library_ms=None,
            b=[bound(4 * m * a[0].shape[1] + nbytes(a[1]) + 8
                     + 4 * m * a[1].shape[1],
                     2 * m * a[1].shape[1] * 8 * a[0].shape[1],
                     H100_INT8_OPS_PER_S) for a in mm_args])
        rows["fused_mlp"] = dict(
            max_abs_err=0.0,
            ms=timer([lambda: kf.fused_mlp(*mlp_args, "silu")]),
            plain_ms=timer([lambda: ref.fused_mlp_ref(
                x, up, gate, "silu", *mlp_args[3:])], iters=3),
            library_ms=None,
            b=[bound(4 * m * D + nbytes(up) + nbytes(gate) + 12 + 4 * m * FF,
                     2 * 2 * m * FF * 8 * D, H100_INT8_OPS_PER_S)])
    rows["fused_mlp"]["max_abs_err"] = err
    for name, r in rows.items():
        print(f"train kernel {name} (one layer's forward, M "
              f"{TRAIN_ROWS[0]}): ms "
              f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
              f"{sum(x[0] for x in r['b']):.4f} library_ms {r['library_ms']}")
    print(f"train kernels checked at M {TRAIN_ROWS}: 13 absmax, 5 matmuls "
          f"and the MLP (3 activations) of a layer, equal to plain")
    return rows


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _leaves(torch, tree):
    from repro_torch.models.params import tree_leaves
    return [(path, t.detach().cpu()) for path, t in tree_leaves(tree)]


#: a train step's replay (``replay_ops``): the plain-torch blocks held on
#: the card to the CPU on the CPU's own inputs, forward and backward (the
#: gradient of each input that needs one, for the CPU's gradient of the
#: block's output), within this share of the CPU's largest magnitude (f32
#: sums in another order); a bf16 output also within one bf16 ulp an element
REPLAY_TOL = {"sdpa": 1e-5, "_ssd_chunked": 1e-4, "_mlstm_chunked": 1e-4,
              "_slstm_scan": 1e-4, "rms_norm": 1e-5, "layer_norm": 1e-5,
              "chunked_softmax_xent": 1e-5}


def replay_blocks():
    """(module, name) of every plain-torch block ``REPLAY_TOL`` names, in
    each module of the port that calls it by that name."""
    from repro_torch.models import attention, model, ssm
    return [(attention, "sdpa"), (ssm, "_ssd_chunked"),
            (ssm, "_mlstm_chunked"), (ssm, "_slstm_scan"),
            (model, "rms_norm"), (ssm, "rms_norm"), (attention, "rms_norm"),
            (model, "layer_norm"), (model, "chunked_softmax_xent")]


def replay_reach(cfg) -> set:
    """The ``replay_ops`` entries a train step of ``cfg`` must fill: each
    block of its family forward and backward (``<name>_grad0``), and in
    ``bp8_fused`` the kernels forward and their straight-through
    gradients.  An entry left empty means the replay patched a name the
    step no longer calls, and checked nothing there."""
    blocks = {"chunked_softmax_xent",
              "layer_norm" if cfg.family == "encdec" else "rms_norm"}
    if cfg.family == "xlstm":
        blocks |= {"_mlstm_chunked", "_slstm_scan"}
    else:
        blocks.add("sdpa")
    if cfg.family == "hybrid":
        blocks.add("_ssd_chunked")
    need = blocks | {f"{b}_grad0" for b in blocks}
    if cfg.matmul_mode == "bp8_fused":
        need |= {"oisma_matmul", "_MatmulSTE_grad0"}
        if cfg.mlp_gated and cfg.family in ("decoder", "hybrid"):
            need |= {"oisma_mlp", "_MlpSTE_grad0"}
    return need


def _to(torch, x, dev, leaves=None):
    """``x`` (a tensor, or a dict, list or tuple of them) detached onto
    ``dev``; with ``leaves``, each tensor that required grad becomes a new
    leaf that requires it, appended there."""
    if isinstance(x, torch.Tensor):
        y = x.detach().to(dev)
        if leaves is not None and x.requires_grad:
            leaves.append(y.requires_grad_())
        return y
    if isinstance(x, dict):
        return {k: _to(torch, v, dev, leaves) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to(torch, v, dev, leaves) for v in x)
    return x


class replay_ops:
    """While active, every call the CPU makes of a BP kernel's op (the
    fused matmul and MLP, forward and straight-through backward) and of
    the plain-torch blocks (``REPLAY_TOL``: attention, the SSD, the
    mLSTM, the sLSTM, the norms and the loss head) runs again on the card
    on the very same inputs, and the two outputs are compared: the
    kernels bitwise (the MLP within 1e-5 of the largest magnitude, at
    least 1), their STE gradients within 1e-5 (the MLP's 1e-4) and a
    bf16 weight's within one bf16 ulp an element, the blocks within
    ``REPLAY_TOL``.  A block's backward is replayed when the CPU's
    backward reaches its output: its inputs' gradients for that output
    gradient, taken by autograd on the card and on the CPU from the
    CPU's inputs.  A mismatch fails.  ``stats`` holds {op: [calls,
    worst share]}.  What the replay does not cover (the embedding and
    its backward, the residual adds, RoPE, the gates' elementwise ops)
    is held only by the whole step's rules (``compare_train_step``)."""

    def __init__(self, torch, dev="cuda"):
        from repro_torch.kernels import ops
        self.torch, self.dev, self.stats, self.saved = torch, dev, {}, []
        self.ops = ops
        self.targets = [(ops, "oisma_matmul", 0.0), (ops, "oisma_mlp", 1e-5)
                        ] + [(mod, n, REPLAY_TOL[n])
                             for mod, n in replay_blocks()]

    def card(self, x):
        return _to(self.torch, x, self.dev)

    def check(self, name, got, want, tol, floor=0.0):
        """``got`` within ``tol`` of ``want``'s largest magnitude (at least
        ``floor``); a bf16 output (a weight's gradient) also within one
        bf16 ulp an element, as it rounds an f32 sum."""
        torch = self.torch
        bf16 = want.dtype == torch.bfloat16
        got, want = got.detach().float().cpu(), want.detach().float()
        big = max(float(want.abs().max()), floor)
        err = (got - want).abs()
        share = float(err.max()) / big if big else float(err.max())
        n, worst = self.stats.get(name, (0, 0.0))
        self.stats[name] = (n + 1, max(worst, share))
        allow = torch.full_like(want, tol * big)
        if bf16:
            allow = torch.maximum(allow, torch.exp2(torch.floor(torch.log2(
                want.abs().clamp_min(1e-30))) - 7))
        if not bool((err <= allow).all()):          # NaN fails too
            fail(f"replay: {name} on the card vs the CPU on the same "
                 f"inputs {tuple(want.shape)}: {share:.3g} of the largest "
                 f"magnitude ({tol}{', one bf16 ulp' if bf16 else ''})")

    def _vjp(self, name, fn, tol, a, kw, g):
        """The CPU's gradient ``g`` of ``fn(*a, **kw)``'s first output
        taken back through ``fn`` on the card and on the CPU, from the
        CPU's inputs; each input's gradient compared."""
        torch = self.torch

        def grads(dev):
            leaves = []
            args, kwargs = _to(torch, (a, kw), dev, leaves)
            with torch.enable_grad():
                out = fn(*args, **kwargs)
                first = out[0] if isinstance(out, tuple) else out
                return torch.autograd.grad(first, leaves, g.to(dev),
                                           allow_unused=True)

        for i, (got, want) in enumerate(zip(grads(self.dev), grads("cpu"))):
            if (got is None) != (want is None):
                fail(f"replay: {name}'s gradient {i} is None on "
                     f"{'the card' if got is None else 'the CPU'} only")
            if want is not None:
                self.check(f"{name}_grad{i}", got, want, tol)

    def _forward(self, name, fn, tol):
        torch = self.torch

        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            first = out[0] if isinstance(out, tuple) else out
            if first.device.type == "cpu":
                with torch.no_grad():
                    got = fn(*self.card(a), **self.card(kw))
                pairs = ([(got, out)] if not isinstance(out, tuple) else
                         list(zip(got, out)))
                for i, (g, w) in enumerate(pairs):
                    for k in (sorted(w) if isinstance(w, dict) else [None]):
                        self.check(name if not i and k is None else
                                   f"{name}[{i}]{k or ''}",
                                   g if k is None else g[k],
                                   w if k is None else w[k], tol,
                                   1.0 if name == "oisma_mlp" else 0.0)
                # a block under autograd: its backward when the CPU's
                # reaches it (under remat, the forward's output; the
                # recomputed one's hook never fires)
                if first.requires_grad and name in REPLAY_TOL:
                    first.register_hook(
                        lambda g: self._vjp(name, fn, tol, a, kw, g))
            return out
        return wrapped

    def _backward(self, name, bwd, tol):
        torch = self.torch

        def twin(ctx, saved):
            """A stand-in for ``ctx`` (whose saved tensors unpack once)."""
            t = type("Ctx", (), {})()
            t.saved_tensors = saved
            t.needs_input_grad = ctx.needs_input_grad
            t.act = getattr(ctx, "act", None)
            return t

        def wrapped(ctx, g):
            saved = ctx.saved_tensors
            grads = bwd(twin(ctx, saved), g)
            if g.device.type == "cpu":
                with torch.no_grad():
                    got = bwd(twin(ctx, self.card(saved)), self.card(g))
                for i, (a, b) in enumerate(zip(got, grads)):
                    if b is not None:
                        self.check(f"{name}_grad{i}", a, b, tol)
            return grads
        return wrapped

    def missed(self, cfg) -> list:
        """``replay_reach(cfg)``'s entries this replay saw no call of."""
        return sorted(n for n in replay_reach(cfg)
                      if not self.stats.get(n, (0,))[0])

    def __enter__(self):
        for mod, name, tol in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))
            setattr(mod, name, self._forward(name, fn, tol))
        for cls, tol in ((self.ops._MatmulSTE, 1e-5),
                         (self.ops._MlpSTE, 1e-4)):
            bwd = cls.backward
            self.saved.append((cls, "backward", staticmethod(bwd)))
            cls.backward = staticmethod(self._backward(cls.__name__, bwd,
                                                       tol))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)
        self.saved.clear()


class jitter_ops:
    """A control for ``compare_train_step``: while active, every f32 first
    output of the plain-torch blocks (``replay_blocks``) is multiplied by
    1 +- 2^-20 an element (a seeded sign), in the forward and, through
    autograd, the backward: noise no larger than the card's per-block
    differences that ``replay_ops`` measures."""
    side = "the jittered CPU"

    def __init__(self, torch, seed=0):
        self.torch, self.saved = torch, []
        self.gen = torch.Generator().manual_seed(seed)

    def _jittered(self, fn):
        torch = self.torch

        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            first = out[0] if isinstance(out, tuple) else out
            if first.dtype != torch.float32:
                return out
            sign = torch.randint(0, 2, first.shape, generator=self.gen,
                                 device=first.device) * 2 - 1
            first = first * (1 + sign.float() * 2.0 ** -20)
            return (first,) + tuple(out[1:]) if isinstance(out, tuple) \
                else first
        return wrapped

    def __enter__(self):
        for mod, name in replay_blocks():
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))
            setattr(mod, name, self._jittered(fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)
        self.saved.clear()


def card_layer_fns():
    """(module, name) of each layer-level function a train step calls:
    the recurrent blocks, attention and the MLP, with their projections
    and the glue around the replayed blocks."""
    from repro_torch.models import attention, model, ssm
    return [(ssm, "mlstm_apply"), (ssm, "slstm_apply"),
            (ssm, "mamba2_apply"), (attention, "gqa_apply"),
            (model, "mlp_apply")]


#: ``compare_train_step(follow_card=True)``: each layer's output on the
#: card against the CPU's on the same inputs, in ``bp8_fused``: at most
#: this share of the elements more than one bf16 ulp off, and the largest
#: difference at most this share of the largest magnitude (a bf16 flip
#: before a BP quantise moves an element a whole level; measured at full
#: width by ``scripts/torch_train_card_vs_cpu.py``: xlstm's mLSTM 0.00812
#: and 0.0834, whisper's attention 0.000224 and 0.0369, zamba2's Mamba2
#: 1.83e-05 and 0.0668)
FOLLOW_TOL = (0.02, 0.25)


def layer_reach(cfg) -> set:
    """The ``card_layer_fns`` a train step of ``cfg`` calls."""
    if cfg.family == "xlstm":
        return {"mlstm_apply", "slstm_apply"}
    return {"gqa_apply", "mlp_apply"} | (
        {"mamba2_apply"} if cfg.family == "hybrid" else set())


class card_layers(jitter_ops):
    """A control for ``compare_train_step``: while active, each layer
    function's (``card_layer_fns``) first output on the CPU is replaced by
    the card's on the same inputs (the gradient still the CPU's), and
    ``stats`` holds {layer: (calls, share of elements differing, share
    more than one bf16 ulp off, largest difference over the largest
    magnitude)}, the worst of each.  A CPU step run so follows the card's
    forward layer by layer under the CPU's backward."""
    side = "the CPU with the card's layer outputs"

    def __init__(self, torch, dev="cuda"):
        self.torch, self.dev, self.saved, self.stats = torch, dev, [], {}

    def _carded(self, name, fn):
        torch = self.torch

        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            first = out[0] if isinstance(out, tuple) else out
            with torch.no_grad():
                got = fn(*_to(torch, a, self.dev), **_to(torch, kw, self.dev))
            got = (got[0] if isinstance(got, tuple) else got).to(first.dtype
                                                                  ).cpu()
            want = first.detach()
            d = (got.float() - want.float()).abs()
            ulp = torch.exp2(torch.floor(torch.log2(
                want.float().abs().clamp_min(1e-30))) - 7)
            big = float(want.float().abs().max())
            n, *w = self.stats.get(name, (0, 0.0, 0.0, 0.0))
            self.stats[name] = (n + 1, *map(max, w, (
                float((d > 0).float().mean()), float((d > ulp).float().mean()),
                float(d.max()) / big if big else float(d.max()))))
            first = first + (got - want)
            return (first,) + tuple(out[1:]) if isinstance(out, tuple) \
                else first
        return wrapped

    def __enter__(self):
        self.torch.zeros(1, device=self.dev)  # not first inside a remat
        for mod, name in card_layer_fns():
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))
            setattr(mod, name, self._carded(name, fn))
        return self


def leaf_stats(torch, which: str, g, c, old=None) -> dict:
    """What the whole-step rules read of one piece of a leaf (the whole
    leaf, or a rank's piece: ``merge_stats`` adds pieces up): for a first
    moment ("m") the largest |c|, the largest |g - c| and the f64 sums
    g.c, g.g, c.c; for a new param the counts of its elements, of those
    the CPU's step moved from ``old``, of those whose step agrees in sign,
    of equal ones, and whether every step on the card and every old
    value is 0."""
    bf16 = c.dtype == torch.bfloat16
    g, c = g.float(), c.float()
    n = c.numel()
    st = {"bf16": bf16, "diff": float((g - c).abs().max()) if n else 0.0}
    if which == "m":
        g64, c64 = g.double(), c.double()   # f32 products of small moments
        st.update(big=float(c.abs().max()) if n else 0.0,  # underflow
                  dot=float((g64 * c64).sum()), gg=float((g64 * g64).sum()),
                  cc=float((c64 * c64).sum()))
        return st
    old = old.detach().float()
    dg, dc = g - old, c - old
    on = dc != 0
    st.update(n=n, on=int(on.sum()),
              agree=int((torch.sign(dg[on]) == torch.sign(dc[on])).sum()),
              equal=int((g == c).sum()), dg_zero=bool((dg == 0).all()),
              old_zero=bool((old == 0).all()))
    return st


def merge_stats(a: dict, b: dict) -> dict:
    """Two pieces' ``leaf_stats`` as one."""
    out = dict(a)
    for k in ("dot", "gg", "cc", "n", "on", "agree", "equal"):
        if k in a:
            out[k] = a[k] + b[k]
    for k in ("diff", "big"):
        if k in a:
            out[k] = max(a[k], b[k])
    for k in ("dg_zero", "old_zero"):
        if k in a:
            out[k] = a[k] and b[k]
    return out


def whole_step_stats(torch, new_gpu, new_cpu, old_params) -> dict:
    """``leaf_stats`` of every whole leaf of two new states (``{"params",
    "opt": {"m"}}``) from ``old_params``, keyed "m/..." and "params/..."."""
    stats = {}
    for which in ("m", "params"):
        src_g = new_gpu["opt"]["m"] if which == "m" else new_gpu["params"]
        src_c = new_cpu["opt"]["m"] if which == "m" else new_cpu["params"]
        for (path, g), (_, c) in zip(_leaves(torch, src_g),
                                     _leaves(torch, src_c)):
            stats[f"{which}/{'/'.join(path)}"] = leaf_stats(
                torch, which, g, c, None if which == "m"
                else _leaf(old_params, path))
    return stats


def step_faults(torch, out, stats: dict, side: str, ref: str, what: str,
                loss_tol: float) -> list:
    """The whole-step rules of ``compare_train_step`` on ``stats`` (each
    leaf's ``leaf_stats``, merged over its pieces): the loss within
    ``loss_tol`` and the grad norm within 1e-2 relative (``out``'s
    ``loss_card``/``loss_cpu``, ``grad_norm_card``/``grad_norm_cpu``),
    each leaf's first moment within 5e-2 of its largest with a cosine of
    0.999, each new leaf's step of the CPU's sign on 90% of the elements
    the CPU's moved, a bf16 leaf 99% equal.  Fills ``out["leaves"]``,
    prints a line, returns the faults."""
    faults = []
    if abs(out["loss_card"] - out["loss_cpu"]) > loss_tol:
        faults.append(f"train step: loss on {side} {out['loss_card']} vs "
                      f"the CPU {out['loss_cpu']} ({loss_tol:.3g})")
    if abs(out["grad_norm_card"] / out["grad_norm_cpu"] - 1) > 1e-2:
        faults.append(f"train step: grad norm {out['grad_norm_card']} vs "
                      f"{out['grad_norm_cpu']} (1e-2 relative)")
    for key, st in stats.items():
        diff = st["diff"]
        if key.startswith("m/"):
            big = st["big"]
            if big == 0.0:    # no gradient (zamba2's LoRA a_q, b_q 0)
                out["leaves"][key] = {"max_diff_of_max": diff,
                                      "cosine": None}
                if diff:
                    faults.append(f"train step: gradient of {key} is "
                                  f"0 on the CPU, not on {side}")
                continue
            cos = st["dot"] / (math.sqrt(st["gg"]) * math.sqrt(st["cc"]))
            out["leaves"][key] = {"max_diff_of_max": diff / big,
                                  "cosine": cos}
            if diff > 5e-2 * big or cos < 0.999:
                faults.append(f"train step: gradient of {key} on "
                              f"{side} vs the "
                              f"CPU: max diff {diff / big:.3g} of its "
                              f"max, cosine {cos:.6f} (5e-2, 0.999)")
            continue
        # the step each side took: a wrong or dropped update moves a
        # weight the other way, or not at all, where the CPU's moved it
        # (Adam's first step is about lr either way, so a bound on the
        # difference could not tell); a leaf the CPU left as it was
        # stays so
        agree = st["agree"] / st["on"] if st["on"] else float(st["dg_zero"])
        same = st["equal"] / st["n"]
        bf16 = st["bf16"]
        out["leaves"][key] = {"max_diff": diff, "equal_share": same,
                              "moved_share": st["on"] / st["n"],
                              "sign_agreement": agree, "bf16": bf16}
        # a bf16 leaf rounds the small differences away; an f32 leaf (the
        # norms' gains) keeps them in its last bits.  A bf16 leaf that
        # starts at 0 (zamba2's conv_b and LoRA b_q) steps to -lr * (+-1
        # in its last f32 bits) everywhere: one value, so a bf16 rounding
        # boundary next to lr flips a share of it at once, and only the
        # sign rule holds it
        zero = st["old_zero"]
        out["leaves"][key]["from_zero"] = zero
        if agree < 0.9 or (bf16 and not zero and same < 0.99):
            faults.append(f"train step: new {key} on {side} vs "
                          f"the CPU: the step's sign agrees on "
                          f"{agree:.5f} of the elements the CPU "
                          f"moved (0.9), {same:.5f} of elements "
                          f"equal (0.99 of a bf16 leaf)")
    worst = max(v.get("max_diff_of_max", 0) for v in out["leaves"].values())
    least = min(v["equal_share"] for v in out["leaves"].values()
                if v.get("bf16") and not v["from_zero"])
    signs = min(v["sign_agreement"] for v in out["leaves"].values()
                if "sign_agreement" in v)
    cosine = min(v["cosine"] for v in out["leaves"].values()
                 if v.get("cosine") is not None)
    if not any(v.get("moved_share") for v in out["leaves"].values()):
        faults.append("train step: the CPU's step moved no weight")
    print(f"train step on {side} vs {ref} ({what}): loss "
          f"{out['loss_card']:.6f} vs "
          f"{out['loss_cpu']:.6f}, grad norm {out['grad_norm_card']:.6f} "
          f"vs {out['grad_norm_cpu']:.6f}; gradients' largest difference "
          f"{worst:.3g} of a leaf's max, least cosine {cosine:.6f}; new "
          f"bf16 params' least equal share "
          f"{least:.5f}; the step's sign agrees on at least {signs:.5f} of a "
          f"leaf's moved elements; the CPU step {out['cpu_step_s']:.1f}s")
    return faults


def compare_train_step(torch, model, opt, host_batch, label: str,
                       dev="cuda", loss_tol=1e-3, loss_rtol=0.0, gate=True,
                       control=None, follow_card=False):
    """One train step of ``model`` on the card and on the CPU from the same
    seeded state over ``host_batch``: the loss within ``loss_tol`` or
    ``loss_rtol`` of the CPU's, the larger (the trained families' tied
    std-1 embeddings give losses of hundreds at full width), the
    gradient norm within 1e-2 relative, the gradients (through AdamW's
    first moment, ``m = (1 - b1) g s``, ``s`` the clip scale) within 5e-2
    of a leaf's largest and a cosine of 0.999, and the new params: the
    step's sign agrees where the CPU's moved a weight, and a bf16 leaf is
    mostly equal (one that starts at 0 excepted).  The CPU's step runs
    under ``replay_ops``, each op held to the card on the CPU's inputs.
    The replay fails if it checked nothing of an op the step must reach
    (``replay_reach``).  ``gate=False`` reports the whole step's
    differences without failing on them (a depth where they compound
    past the rules; the replay holds).  ``follow_card=True`` holds the
    card's step instead to the CPU's following the card's forward layer
    by layer (``card_layers``: each layer's output replaced by the card's
    on the same inputs, within ``FOLLOW_TOL`` of the CPU's): a depth where
    the layers' rounding compounds, the rest of the step (the backward,
    the loss, AdamW) still held to the CPU.  ``control`` (``jitter_ops`` or
    ``card_layers``) makes the other step the CPU's under it, with no
    replay: how far the CPU parts from itself under that change alone.
    Returns the report."""
    from repro_torch.models.params import tree_map
    from repro_torch.optim.optimizer import lr_at
    from repro_torch.train.train_step import (TrainPlan, init_state,
                                              make_train_step)
    cfg = model.cfg
    step = make_train_step(model, opt, TrainPlan(
        1, host_batch["tokens"].shape[0]))
    side = control.side if control else "the card"
    cpu_state = init_state(model, 0, opt, "cpu")
    gpu_state = tree_map(lambda t: t.to("cpu" if control else dev,
                                        copy=True), cpu_state)
    t0 = time.perf_counter()
    rp = replay_ops(torch, dev)
    follow = card_layers(torch, dev) if follow_card else None
    with contextlib.nullcontext() if control else rp, \
            follow or contextlib.nullcontext():
        new_cpu, m_cpu = step(cpu_state, host_batch)
    cpu_s = time.perf_counter() - t0
    if follow and set(follow.stats) != layer_reach(cfg):
        fail(f"{cfg.name}'s step called the layer functions "
             f"{sorted(follow.stats)}, not {sorted(layer_reach(cfg))}")
    for k, (n, _, past, big) in (follow.stats if follow else {}).items():
        if not past <= FOLLOW_TOL[0] or not big <= FOLLOW_TOL[1]:
            fail(f"{cfg.name}'s {k} on the card vs the CPU on the same "
                 f"inputs: {past:.3g} of the elements past one bf16 ulp, "
                 f"the largest difference {big:.3g} of the largest "
                 f"({FOLLOW_TOL})")
    if not control and rp.missed(cfg):
        fail(f"replay: {cfg.name}'s step reached no call of "
             f"{rp.missed(cfg)}: the replay checked nothing there")
    with control or contextlib.nullcontext():
        new_gpu, m_gpu = step(gpu_state, {
            k: v.to("cpu" if control else dev)
            for k, v in host_batch.items()})
    lr = float(lr_at(opt, torch.tensor(1)))
    out = {"cpu_step_s": cpu_s, "loss_card": float(m_gpu["loss"]),
           "loss_cpu": float(m_cpu["loss"]),
           "grad_norm_card": float(m_gpu["grad_norm"]),
           "grad_norm_cpu": float(m_cpu["grad_norm"]), "lr": lr,
           "leaves": {}}
    out["replay"] = {k: {"calls": n, "worst_share": w}
                     for k, (n, w) in sorted(rp.stats.items())}
    layers = follow or control
    if getattr(layers, "stats", None):
        out["layers"] = layers.stats
        print(f"{cfg.name}'s layers on the card vs the CPU on the same "
              f"inputs (calls, share differing, share past one bf16 ulp, "
              f"largest difference of the largest): " + ", ".join(
                  f"{k} {n} {a:.3g} {b:.3g} {c:.3g}"
                  for k, (n, a, b, c) in sorted(layers.stats.items())))
    if not control:
        print(f"replay of {cfg.name}'s CPU step on the card, op by op on "
              f"the same inputs (calls, worst share of the largest): "
              + ", ".join(f"{k} {n} {w:.3g}"
                          for k, (n, w) in sorted(rp.stats.items())))
    loss_tol = max(loss_tol, loss_rtol * abs(out["loss_cpu"]))
    faults = step_faults(
        torch, out, whole_step_stats(torch, new_gpu, new_cpu,
                                     cpu_state["params"]), side,
        "the CPU on the card's layer outputs" if follow else "the CPU",
        f"{cfg.name}, {label}, {cfg.matmul_mode}", loss_tol)
    out["faults"] = faults
    if faults and gate:
        fail("; ".join(faults))
    if faults:
        print(f"  not gated ({len(faults)} rules past): "
              + "; ".join(faults)[:600])
    return out


def train_card_vs_cpu(torch, full, dev="cuda"):
    """One ``bp8_fused`` train step at full width and one layer on the card
    and on the CPU from the same seeded state (2 x 32 tokens,
    ``compare_train_step``); then a checkpoint written on the card that
    restores bitwise, and ``train()`` resuming from it."""
    import shutil
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import build as build_model
    from repro_torch.optim.optimizer import OptimizerConfig
    from repro_torch.train import trainer as tr
    cfg = dataclasses.replace(full, num_layers=CPU_CHECK_LAYERS)
    model = build_model(cfg)
    opt = OptimizerConfig(warmup_steps=5, total_steps=8)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2)
    host_batch = {k: torch.from_numpy(v)
                  for k, v in batch_at(dcfg, 0).items()}
    out = compare_train_step(torch, model, opt, host_batch,
                             f"full width, {CPU_CHECK_LAYERS} layer, 2 x 32 "
                             "tokens", dev)

    # a checkpoint written on the card, restored bitwise, and resumed
    shape = ShapeConfig("t", "train", 32, 2)
    d = ROOT / "build" / "smoke_train_ckpt"
    shutil.rmtree(d, ignore_errors=True)

    def tcfg(steps, ckpt):
        return tr.TrainerConfig(total_steps=steps, ckpt_every=100, keep=1,
                                ckpt_dir=str(d) if ckpt else None,
                                ckpt_compress_opt=False)

    try:
        t0 = time.perf_counter()
        state, hist = tr.train(model, cfg, shape, tcfg(2, True),
                               opt_cfg=opt, device=dev)
        save_s = time.perf_counter() - t0
        like = tr._payload(state, dcfg, 2, 0)
        back, ckpt_step = CheckpointManager(str(d)).restore(like)
        if ckpt_step != 2:
            fail(f"checkpoint restored at step {ckpt_step}, not 2")
        for (path, a), (_, b) in zip(_leaves(torch, state),
                                     _leaves(torch, back["state"])):
            if a.dtype != b.dtype or not torch.equal(a, b):
                fail(f"checkpoint leaf {'/'.join(path)} not restored "
                     f"bitwise")
        _, resumed = tr.train(model, cfg, shape, tcfg(3, True), opt_cfg=opt,
                              device=dev)
        _, straight = tr.train(model, cfg, shape, tcfg(3, False),
                               opt_cfg=opt, device=dev)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if [h["step"] for h in resumed] != [3]:
        fail(f"train() did not resume at step 3: {resumed}")
    gaps = [abs(a["loss"] - b["loss"])
            for a, b in zip(hist + resumed, straight)]
    print(f"checkpoint at full width ({CPU_CHECK_LAYERS} layer) written on "
          f"the card and "
          f"restored bitwise; resumed losses {[h['loss'] for h in hist]} + "
          f"{resumed[0]['loss']} vs uninterrupted "
          f"{[h['loss'] for h in straight]} (largest gap {max(gaps):.3g}); "
          f"2 steps + save {save_s:.1f}s")
    if max(gaps) > 2e-2:
        fail(f"resumed losses differ from an uninterrupted run by "
             f"{max(gaps)} (2e-2)")
    out.update(resume_gaps=gaps, save_s=save_s)
    return out


def _train_kernel_kind(name: str) -> str:
    """A device activity of a train step by its name: the BP kernels, the
    f32 matrix products (cuBLAS), or the rest (elementwise, reductions,
    copies, the embedding's index ops)."""
    low = name.lower()
    if "absmax_kernel" in name or "bp_mma_kernel" in name:
        return "bp_kernels"
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "f32_matmuls"
    return "other"


#: the ``record_function`` ranges of ``make_train_step``, in step order
TRAIN_PARTS = ("train.forward", "train.backward", "train.grad_sum",
               "train.adamw")


def profile_train_step(torch, model, opt, state, batch,
                       label="full depth, 8 x 128 tokens"):
    """Where one full-depth train step's time goes, from the Chrome trace of
    a ``torch.profiler`` session over one step of ``make_train_step``:
    device time by kind of kernel, the idle share (1 - device busy / wall)
    and the device time of each part of the step.  A kernel belongs to the
    part (the step's own ``train.*`` ranges) whose host range holds its
    launch, matched through the trace's correlation ids, so the BP kernels
    of the forward and of its recompute inside the backward are timed
    apart.  Launches whose device record the session dropped are counted."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train.train_step import TrainPlan, make_train_step
    step = make_train_step(model, opt, TrainPlan(1, batch["tokens"].shape[0]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, m = step(state, batch)
        float(m["loss"])
        wall = time.perf_counter() - t0
    path = ROOT / "build" / "train_step_trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        events = [e for e in json.loads(path.read_text())["traceEvents"]
                  if e.get("ph") == "X"]
    finally:
        path.unlink(missing_ok=True)

    def cat(e):
        return str(e.get("cat", "")).lower()

    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if cat(e) == "user_annotation" and e["name"] in TRAIN_PARTS]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if cat(e) in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})
                and ("Launch" in e["name"] or "Memset" in e["name"]
                     or "Memcpy" in e["name"])}
    device = [e for e in events
              if cat(e) in ("kernel", "gpu_memset", "gpu_memcpy")]

    def part_of(e):
        ts = launched.get(e.get("args", {}).get("correlation"))
        for lo, hi, name in ranges:
            if ts is not None and lo <= ts <= hi:
                return name
        return "other"

    kinds, parts, names = {}, {}, {}
    for e in device:
        ms = e["dur"] / 1e3
        k = _train_kernel_kind(e["name"])
        n, t = kinds.get(k, (0, 0.0))
        kinds[k] = (n + 1, t + ms)
        p = parts.setdefault(part_of(e), {"launches": 0, "device_ms": 0.0,
                                          "bp_ms": 0.0})
        p["launches"] += 1
        p["device_ms"] += ms
        if k == "bp_kernels":
            p["bp_ms"] += ms
        n, t = names.get(e["name"], (0, 0.0))
        names[e["name"]] = (n + 1, t + ms)
    for lo, hi, name in ranges:
        p = parts.setdefault(name, {"launches": 0, "device_ms": 0.0,
                                    "bp_ms": 0.0})
        p["host_ms"] = p.get("host_ms", 0.0) + (hi - lo) / 1e3
    missing = [n for n in TRAIN_PARTS if not any(r[2] == n for r in ranges)]
    if missing:
        fail(f"train step profile: no {missing} range in the trace")
    if not device:
        fail("train step profile: no device activity in the trace")
    top = sorted(((t, k, n) for k, (n, t) in names.items()), reverse=True)
    busy_ms = sum(t for _, t in kinds.values())
    fwd, bwd = parts["train.forward"], parts["train.backward"]
    out = {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / (wall * 1e3),
           "by_kind": {k: {"launches": n, "ms": t}
                       for k, (n, t) in sorted(kinds.items())},
           "bp_forward_ms": fwd["bp_ms"], "bp_recompute_ms": bwd["bp_ms"],
           "parts": {k: parts[k] for k in TRAIN_PARTS + ("other",)
                     if k in parts},
           "launches_without_device_record": len(
               set(launched) - {e.get("args", {}).get("correlation")
                                for e in device}),
           "top": [{"ms": t, "name": k[:100], "calls": n}
                   for t, k, n in top[:12]]}
    print(f"train step profile ({model.cfg.name}, {label}): wall "
          f"{out['wall_ms']:.1f} ms, device busy {busy_ms:.1f} ms, idle "
          f"share {out['idle_share']:.3f}; by kind "
          + ", ".join(f"{k} {v['ms']:.1f} ms x{v['launches']}"
                      for k, v in out["by_kind"].items())
          + f"; BP kernels in the forward {fwd['bp_ms']:.1f} ms, in the "
          f"backward's recompute {bwd['bp_ms']:.1f} ms; by part (device ms, "
          f"launches, host ms) "
          + ", ".join(f"{k} {v['device_ms']:.1f} x{v['launches']} "
                      f"{v.get('host_ms', 0.0):.1f}"
                      for k, v in out["parts"].items())
          + f"; {out['launches_without_device_record']} launches without a "
          f"device record")
    for t, k, n in top[:8]:
        print(f"  {t:.2f} ms x{n} {k[:100]}")
    return out


def update_from_init(torch, init, params, lr_sum):
    """How far training moved each leaf from its initial value: the share
    of elements that changed, and for each f32 leaf its largest change over
    ``lr_sum``.  Fails unless every leaf moved and each f32 leaf's largest
    change lies in [lr_sum / 4, 2 lr_sum + 4 ulps]: AdamW moves a weight by
    about its step's lr, and a bf16 weight only where that exceeds half
    its ulp."""
    from repro_torch.models.params import tree_leaves
    moved, gains, faults = {}, {}, []
    for (path, a), (_, b) in zip(tree_leaves(init), tree_leaves(params)):
        key = "/".join(path)
        moved[key] = float((a != b).float().mean())
        if moved[key] == 0:
            faults.append(f"{key} did not move")
        if a.dtype == torch.float32:
            top = float((b - a).abs().max())
            gains[key] = top / lr_sum
            ulp = float(torch.finfo(torch.float32).eps * a.abs().max())
            if not lr_sum / 4 <= top <= 2 * lr_sum + 4 * ulp:
                faults.append(f"{key} moved at most {top:.3g}, not within "
                              f"[{lr_sum / 4:.3g}, {2 * lr_sum:.3g}]")
    if not gains:
        faults.append("no f32 leaf")
    if faults:
        fail("full-depth training: against the initial weights, "
             + "; ".join(faults))
    return moved, gains


def train_full_depth(torch, build, full, steps=5, dev="cuda"):
    """The full h2o-danube-1.8b in ``bp8_fused`` trained through
    ``trainer.train`` at the launcher's seq 128 and global batch 8, lr
    3e-5 with warmup 5 (at lr 3e-4 the loss jumps from the third step at
    this width, in bf16 as in bp8_fused, for a cause not yet found:
    ``scripts/torch_train_lr.py``, ROADMAP Queue 3), launch counts zeroed
    just before and read just after; per-step wall time, training tokens/s
    past the first step, peak device memory and each step's loss (finite,
    none above step 1's by more than 0.25, the spread of the first losses
    over batches).  That the run trained: every step's gradient norm is
    finite and above 0, and against the seeded initial weights every leaf
    moved, each f32 leaf (the norms' gains) by at least a quarter and at
    most twice the sum of the steps' learning rates (Adam moves a weight
    by about lr a step).  Then a profile of one more step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import build as build_model
    from repro_torch.models.params import init_params
    from repro_torch.optim.optimizer import OptimizerConfig, lr_at
    from repro_torch.train.trainer import TrainerConfig, train
    cfg = dataclasses.replace(full, kv_quant="none")
    model = build_model(cfg)
    shape = ShapeConfig("train", "train", 128, 8)
    opt = OptimizerConfig(learning_rate=3e-5, warmup_steps=5,
                          total_steps=steps)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    norms = []
    tcfg = TrainerConfig(total_steps=steps, ckpt_dir=None)
    build.reset_launches()
    state, hist = train(model, cfg, shape, tcfg, opt_cfg=opt, device=dev,
                        on_metrics=lambda i, m: norms.append(
                            float(m["grad_norm"])))
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if len(norms) != steps or not all(math.isfinite(g) and g > 0
                                      for g in norms):
        fail(f"full-depth training: gradient norms {norms}, not finite and "
             f"above 0 at each of {steps} steps")
    lr_sum = sum(float(lr_at(opt, torch.tensor(i)))
                 for i in range(1, steps + 1))
    moved, gains = update_from_init(
        torch, init_params(model.schema(), seed=tcfg.seed, device=dev),
        state["params"], lr_sum)
    losses = [h["loss"] for h in hist]
    dts = [h["dt"] for h in hist]
    tokens = shape.seq_len * shape.global_batch
    warm = sorted(dts[1:])
    med = warm[len(warm) // 2]
    if not all(math.isfinite(x) for x in losses):
        fail(f"full-depth training: non-finite losses {losses}")
    if max(losses[1:]) > losses[0] + 0.25:
        fail(f"full-depth training: the loss rose above step 1's "
             f"{losses[0]}: {losses}")
    per_step = cfg.num_layers * 2     # each layer's forward, and its recompute
    want = {"absmax": 13 * per_step * steps,
            "fused_matmul": 5 * per_step * steps,
            "fused_mlp": per_step * steps}
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        fail(f"training launches {got}, expected {want} (13 absmax, 5 "
             f"matmuls and 1 MLP a layer, forward and recompute)")
    print(f"full-depth training: {cfg.name}, {cfg.num_layers} layers, "
          f"bp8_fused, {steps} steps of {shape.global_batch} x "
          f"{shape.seq_len} tokens; step 1 {dts[0]:.3f}s, steps 2-{steps} "
          + ", ".join(f"{x:.3f}" for x in dts[1:])
          + f"s (median {med:.3f}s = {tokens / med:.1f} training tokens/s); "
          f"peak device memory {peak:.2f} GB; losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; launches {launches}; gradient norms "
          + ", ".join(f"{g:.4f}" for g in norms)
          + f"; moved from the initial weights: least share of a leaf "
          f"{min(moved.values()):.5f}, f32 leaves' largest step "
          f"{min(gains.values()):.3f}-{max(gains.values()):.3f} of the "
          f"learning rates' sum {lr_sum:.3g}")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                      global_batch=shape.global_batch)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in batch_at(dcfg, steps).items()}
    prof = profile_train_step(torch, model, opt, state, batch)
    return launches, {"model": cfg.name, "layers": cfg.num_layers,
                      "steps": steps, "tokens_per_step": tokens,
                      "step_s": dts, "median_step_s": med,
                      "tokens_per_s": tokens / med, "losses": losses,
                      "grad_norms": norms, "moved_share": moved,
                      "f32_step_of_lr_sum": gains,
                      "peak_mem_gb": peak, "launches": launches,
                      "profile": prof}


# ---------------------------------------------------------------------------
# phase 9: the Gemma family
# ---------------------------------------------------------------------------

#: the Gemma family's archs, their served paths in the kernels line
GEMMA_PATHS = {"gemma3_12b": "serve_gemma3", "paligemma_3b": "serve_paligemma"}


def gemma_config(arch: str, **kw):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), matmul_mode="bp8_fused",
                               kv_quant="bp8", **kw)


def gemma_kernel_rows(torch, timer, cfg, log: str, dev="cuda"):
    """Phase 9(a) for one arch: the served path's four kernels against
    their plain versions at its shapes: the fused matmul bitwise at every
    projection (M 4 and 64), the gelu MLP within 1e-5 (M 4 and 64), absmax
    bitwise on the largest weights, decode attention at D 256 within 1e-5
    (S 1-4096, windows 1024 and full, positions past 1024).  Rows time one
    layer of a 4-row decode step beside its bound; the attention row at
    S 2048 (the served view of a 1300-token request) with gemma3's local
    window, counting in its bound only the keys the masks let through."""
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import fused as kf
    from repro_torch.kernels import ref
    from repro_torch.kernels.build import KINDS, library

    gen = torch.Generator(device=dev)
    gen.manual_seed(9)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    def weight(k, n):
        return randn(k, n, std=k ** -0.5).to(torch.bfloat16)

    def nbytes(t):
        return t.numel() * t.element_size()

    d, ff = cfg.d_model, cfg.d_ff
    kh, g, hd = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
        cfg.head_dim
    mm = [(d, cfg.num_heads * hd), (d, kh * hd), (d, kh * hd),
          (cfg.num_heads * hd, d), (ff, d)]
    ws = [weight(k, n) for k, n in mm]
    up, gate = weight(d, ff), weight(d, ff)
    rows, detail = {}, {}

    # the fused matmul, bitwise at every projection, 4 and 64 rows
    for m in (4, 64):
        for (k, n), w in zip(mm, ws):
            x = randn(m, k)
            sx, sy = kf.absmax(x, TINY), kf.absmax(w, TINY)
            if not torch.equal(kf.fused_bp_matmul(x, w, sx, sy),
                               ref.fused_matmul_ref(x, w, sx, sy)):
                fail(f"{cfg.name}: fused matmul differs at {(m, k, n)}")
    xs = {k: randn(4, k) for k in {k for k, _ in mm}}
    calls, plain, bounds = [], [], []
    for (k, n), w in zip(mm, ws):
        args = (xs[k], w, kf.absmax(xs[k], TINY), kf.absmax(w, TINY))
        calls.append(lambda a=args: kf.fused_bp_matmul(*a))
        plain.append(lambda a=args: ref.fused_matmul_ref(*a))
        bounds.append(bound(4 * 4 * k + nbytes(w) + 8 + 4 * 4 * n,
                            2 * 4 * n * 8 * k, H100_INT8_OPS_PER_S))
    rows["fused_matmul"] = dict(max_abs_err=0.0, ms=timer(calls),
                                plain_ms=timer(plain, iters=3),
                                library_ms=None, b=bounds)

    # absmax: a decode layer's 13 scans, and bitwise on the largest weights
    am_in = [xs[k] for k, _ in mm] + ws + [xs[d], up, gate]
    for t in am_in + [torch.cat([up, gate], 1)]:
        if not torch.equal(kf.absmax(t, TINY), ref.absmax_ref(t, TINY)):
            fail(f"{cfg.name}: absmax differs at {tuple(t.shape)}")
    rows["absmax"] = dict(
        max_abs_err=0.0,
        ms=timer([lambda t=t: kf.absmax(t, TINY) for t in am_in]),
        plain_ms=timer([lambda t=t: ref.absmax_ref(t, TINY) for t in am_in]),
        library_ms=timer([lambda t=t: torch.amax(t.abs()) for t in am_in]),
        b=[bound(nbytes(t) + 4, t.numel(), H100_F32_FLOPS_PER_S)
           for t in am_in])

    # the gelu MLP, within 1e-5 of the output's magnitude
    err = 0.0
    su, sg = kf.absmax(up, TINY), kf.absmax(gate, TINY)
    for m in (4, 64):
        x = randn(m, d)
        sx = kf.absmax(x, TINY)
        a = kf.fused_mlp(x, up, gate, sx, su, sg, "gelu")
        b = ref.fused_mlp_ref(x, up, gate, "gelu", sx, su, sg)
        e = ((a - b).abs().max() / b.abs().max().clamp_min(1.0)).item()
        if not math.isfinite(e) or e > 1e-5:
            fail(f"{cfg.name}: gelu MLP off by {e:.3g} at M {m}")
        err = max(err, (a - b).abs().max().item())
    x = xs[d]
    sx = kf.absmax(x, TINY)
    rows["fused_mlp"] = dict(
        max_abs_err=err,
        ms=timer([lambda: kf.fused_mlp(x, up, gate, sx, su, sg, "gelu")]),
        plain_ms=timer([lambda: ref.fused_mlp_ref(x, up, gate, "gelu", sx,
                                                  su, sg)], iters=3),
        library_ms=None,
        b=[bound(4 * 4 * d + nbytes(up) + nbytes(gate) + 12 + 4 * 4 * ff,
                 2 * 2 * 4 * ff * 8 * d, H100_INT8_OPS_PER_S)])

    # decode attention at D 256: 4 rows, positions past 1024
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def cache(s):
        kc, ks = ka.quantize_kv(randn(4, s, kh, hd))
        vc, vs = ka.quantize_kv(randn(4, s, kh, hd))
        pos = torch.arange(s, device=dev, dtype=torch.int32)[None].repeat(4, 1)
        qp = torch.tensor([s - 1, max(s - 300, 0), max(s // 2 - 1, 0),
                           max(s - 1100, 0)], dtype=torch.int32, device=dev)
        pos[2, s // 2:] = -1                      # a row's empty tail
        return kc, ks, vc, vs, pos, qp

    q = randn(4, kh, g, hd) / math.sqrt(hd)
    err, launched = 0.0, {}
    for s in (1, 33, 1024, 1300, 2048, 4096):
        cc = cache(s)
        for win in (1024, None):
            a = ka.bp8_decode_attention(q, *cc, win)
            e = (a - ka.bp8_decode_attention_ref(q, *cc, win)).abs().max()
            e = e.item()
            if not math.isfinite(e) or e > 1e-5:
                fail(f"{cfg.name}: decode attention (S {s}, window {win}) "
                     f"off by {e:.3g}")
            err = max(err, e)
        split = ka.split_tokens(s, 4 * kh, g, hd, sms)
        launched[s] = {"split_tokens": split,
                       "dynamic_smem_bytes": ka._split_smem(g, hd, split)}
    detail["decode_attention_launch"] = launched
    S = 2048
    kc, ks, vc, vs, pos, qp = cache(S)
    main = (kc, ks, vc, vs, pos, qp)
    win = cfg.window_size or ka.BIG_WINDOW
    seen = ((pos >= 0) & (pos <= qp[:, None])
            & (qp[:, None] - pos < win)).sum().item()   # keys let through
    kd, vd = ka.dequantize_kv(kc, ks), ka.dequantize_kv(vc, vs)
    qs = q.reshape(4, kh * g, 1, hd)
    kt = kd.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vt = vd.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    mask = ((pos >= 0) & (pos <= qp[:, None])
            & (qp[:, None] - pos < win))[:, None, None, :]
    F = torch.nn.functional
    rows["decode_attention"] = dict(
        max_abs_err=err,
        ms=timer([lambda: ka.bp8_decode_attention(q, *main, win)]),
        plain_ms=timer([lambda: ka.bp8_decode_attention_ref(q, *main, win)]),
        library_ms=timer([lambda: F.scaled_dot_product_attention(
            qs, kt, vt, attn_mask=mask, scale=1.0)]),
        b=[bound(2 * 4 * 4 * kh * g * hd + seen * kh * (2 * hd + 8)
                 + 4 * seen + 4 * 4, 4 * seen * kh * g * hd,
                 H100_F32_FLOPS_PER_S)])
    lib = library()
    detail["fused_matmul_dynamic_smem_bytes"] = {
        m: lib.oisma_fused_matmul_smem(m, KINDS[torch.bfloat16])
        for m in (4, 64)}
    shown = [ln for ln in ptxas_report(log) if any(
        k in ln for k in ("bp_mma_kernel", "absmax_kernel",
                          "decode_partial_kernel", "decode_combine_kernel"))]
    print(f"{cfg.name} kernels (registers, static shared memory, spills; "
          f"ptxas): " + "; ".join(shown))
    print(f"{cfg.name}: decode attention at D {hd}, KH {kh}, G {g}: "
          + ", ".join(f"S {s}: split {v['split_tokens']} tokens, "
                      f"{v['dynamic_smem_bytes']} B dynamic shared memory"
                      for s, v in launched.items())
          + f"; fused matmul tiles (bf16 weight) "
          + ", ".join(f"M {m}: {v} B" for m, v in
                      detail["fused_matmul_dynamic_smem_bytes"].items()))
    for name, r in rows.items():
        print(f"{cfg.name} kernel {name}: ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} library_ms {r['library_ms']} bound_ms "
              f"{sum(x[0] for x in r['b']):.5f} max_abs_err "
              f"{r['max_abs_err']}")
    return rows, detail


def lockstep_card_vs_cpu(torch, cfg, prompts, max_new, max_len=128):
    """The same seeded weights on the card, captured and eager, and on the
    CPU emit the same greedy tokens through the lock-step engine (all
    prompts in one generation)."""
    from repro_torch.models import build as build_model
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    p_cpu, p_gpu = seeded_pair(cfg)
    out = {}
    for what, params, dev, capture in (("captured", p_gpu, "cuda", None),
                                       ("eager", p_gpu, "cuda", False),
                                       ("cpu", p_cpu, "cpu", None)):
        eng = ServeEngine(build_model(cfg), params, cfg, EngineConfig(
            slots=len(prompts), max_len=max_len, eos_id=-1), device=dev,
            capture=capture)
        out[what], secs = serve_lockstep(torch, eng, prompts, max_new, 0,
                                         alone=False)
    print(f"card vs cpu ({cfg.name}, lock-step, {cfg.num_layers} layers, "
          f"full width, {cfg.num_prefix_tokens} zero patch tokens, ring "
          f"{cfg.ring_cache}, prompts {[len(p) for p in prompts]}): card, "
          f"captured {out['captured']}; eager {out['eager']}; cpu "
          f"{out['cpu']} ({secs:.1f}s on the CPU)")
    if not out["captured"] == out["eager"] == out["cpu"]:
        fail(f"{cfg.name}: card (captured, eager) and CPU tokens differ")
    return secs


def serve_gemma3(torch, build, timer, rng):
    """Phase 9(c): gemma3-12b at full width and GEMMA3_SERVE_LAYERS of its
    48 layers on ``PagedServeEngine``
    (4 slots, block 16, 160 blocks, prefill chunk 64): 8 requests, one
    prompt of 1200 tokens (past the local window of 1024) and 7 of
    32-256, 16 new tokens each; twice on one capturing engine (the second
    timed, launches zeroed just before and read just after) and once on an
    eager engine, all three tokens equal; graphs within the bounds; a
    short profile; the logits' share of a captured decode step."""
    import numpy as np
    from repro_torch.models import build as build_model
    from repro_torch.models.params import init_params, tree_leaves
    cfg = gemma_config("gemma3_12b", num_layers=GEMMA3_SERVE_LAYERS)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(model.schema(), seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s, init_peak = (time.perf_counter() - t0,
                         torch.cuda.max_memory_allocated() / 1e9)
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    print(f"{cfg.name}: {n_params / 1e9:.3f} B params seeded on the card in "
          f"{init_s:.1f}s, init peak {init_peak:.2f} GB")
    lens = [32, 1200, 256] + [int(n) for n in rng.integers(32, 257, 5)]
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    rec, engine, eager_engine = serve_captured_and_eager(
        torch, build, cfg, params, prompts, num_blocks=160)
    del eager_engine
    # the logits (the tied (262144, 3840) embedding cast to f32 and a
    # matmul) against a captured 4-row decode step over a 2048-token view
    key = max(k for k in engine._decode._shapes)
    h = torch.randn((4, 1, cfg.d_model), device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        logits_ms = timer([lambda: model._logits(params, h)], iters=5)
        step_ms = timer([lambda: engine._decode(key)], iters=5)
    print(f"{cfg.name}: logits of 4 rows {logits_ms:.4f} ms, a captured "
          f"decode step (view {key}) {step_ms:.4f} ms: the logits' share "
          f"{logits_ms / step_ms:.3f}")
    prof = profile_serving(torch, engine, cfg, params, prompts[:4])
    ran = set(prof["served_kernels"])
    if not set(SERVED) <= ran:
        fail(f"{cfg.name}: kernels missing from the captured profile "
             f"(ran: {sorted(ran)})")
    del engine
    return rec["launches"], dict(
        rec, params=n_params, init_s=init_s, init_peak_mem_gb=init_peak,
        logits_ms=logits_ms, decode_step_ms=step_ms, decode_view=key,
        logits_share_of_decode_step=logits_ms / step_ms, profile=prof)


def serve_paligemma(torch, build, rng):
    """Phase 9(d): the full paligemma-3b (18 layers) on the lock-step
    engine (4 slots, max_len 128, 256 zero patch tokens a request): 4
    requests of 16-64 prompt tokens, 16 new tokens each, twice on one
    capturing engine (the second timed, launches zeroed just before and
    read just after) and once eager, tokens equal; the decode graph
    replayed bitwise equal to eager, logits and cache."""
    import numpy as np
    from repro_torch.models.params import init_params
    from repro_torch.models import build as build_model
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    cfg = gemma_config("paligemma_3b")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(model.schema(), seed=0, device="cuda")
    lens = [16, 64] + [int(n) for n in rng.integers(16, 65, 2)]
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    ecfg = EngineConfig(slots=4, max_len=128, eos_id=-1)
    engine = ServeEngine(model, params, cfg, ecfg, device="cuda")
    cold, cold_s = serve_lockstep(torch, engine, prompts, 16, 0, False)
    build.reset_launches()
    out, dt = serve_lockstep(torch, engine, prompts, 16, 0, False)
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    eager_engine = ServeEngine(model, params, cfg, ecfg, device="cuda",
                               capture=False)
    eager, eager_s = serve_lockstep(torch, eager_engine, prompts, 16, 0,
                                    False)
    del eager_engine
    n_tok = sum(len(v) for v in out.values())
    print(f"served {cfg.name}: {cfg.num_layers} layers, lock-step, "
          f"{len(out)} requests (prompts {lens} after "
          f"{cfg.num_prefix_tokens} patch tokens), {n_tok} tokens; captured, "
          f"warm: {dt:.3f}s = {n_tok / dt:.2f} tok/s (first run "
          f"{cold_s:.3f}s); eager {eager_s:.3f}s = {n_tok / eager_s:.2f} "
          f"tok/s; graphs {engine.compile_counts()}; peak device memory "
          f"{peak:.2f} GB; launches (warm captured run) {launches}")
    if not out == cold == eager:
        fail(f"{cfg.name}: captured (first and second run) and eager tokens "
             f"differ")
    for name in SERVED:
        if launches.get(name, 0) <= 0:
            fail(f"{cfg.name}: kernel {name} was not launched")
    for rid, toks in out.items():
        if len(toks) != 16 or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"{cfg.name} request {rid}: bad output {toks}")
    lockstep_replay_vs_eager(torch, engine, params, prompts[1], rng)
    del engine
    return launches, {
        "model": cfg.name, "layers": cfg.num_layers, "requests": len(out),
        "prompt_lens": lens, "prefix_tokens": cfg.num_prefix_tokens,
        "new_tokens": n_tok, "seconds": dt, "tokens_per_s": n_tok / dt,
        "eager_seconds": eager_s, "eager_tokens_per_s": n_tok / eager_s,
        "first_run_seconds": cold_s, "launches": launches,
        "peak_mem_gb": peak}


#: 9(b)'s cut of gemma3: 2 of its 48 layers (3 until phase 13 came: the
#: whole script then took ~1035 s of its 1200 on an NVIDIA H100 80GB HBM3
#: at 700 W).  At prompts of at most
#: 128 tokens its 1024-token window does not cut, so a global layer, or a
#: third local one, would show nothing that the two local ones do not
GEMMA_CHECK_LAYERS = 1
GEMMA_REDUCED = {"num_layers": "48 -> 1 (a local layer; paligemma 18 -> 1) "
                 "in 9(b), the "
                 "card-vs-CPU check only: the CPU's plain path costs tens "
                 "of seconds a call at full width"}
#: 9(c)'s depth: two of gemma3-12b's 8 groups (5 local layers and a global
#: one each), to keep the script's time (48 until phase 15 came)
GEMMA3_SERVE_LAYERS = 12


def phase_gemma(torch, timer, build, log: str, rng):
    """Phase 9: the Gemma family on the card.  Returns the kernel rows and
    the launches of each arch's served path, and a report."""
    import numpy as np
    report, rows, launches = {}, {}, {}
    gc.collect()               # what the earlier phases left in cycles
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for arch in GEMMA_PATHS:
        rows[arch], report[f"kernels_{arch}"] = gemma_kernel_rows(
            torch, timer, gemma_config(arch), log)
    report["a_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    # prompts of one and two whole chunks: the CPU's plain path costs
    # tens of seconds a call at this width, so (b) makes six calls
    g3 = gemma_config("gemma3_12b", num_layers=GEMMA_CHECK_LAYERS)
    prompts = [rng.integers(3, g3.vocab_size, n).astype(np.int32)
               for n in (64, 128)]
    report["cpu_s"] = {"gemma3_12b": card_vs_cpu(torch, g3, prompts, 4)}
    report["b_reduced"] = GEMMA_REDUCED
    pali = gemma_config("paligemma_3b", num_layers=GEMMA_CHECK_LAYERS)
    prompts = [rng.integers(3, pali.vocab_size, n).astype(np.int32)
               for n in (20, 48)]
    report["cpu_s"]["paligemma_3b"] = lockstep_card_vs_cpu(torch, pali,
                                                           prompts, 6)
    report["b_s"] = time.perf_counter() - t1
    print(f"phase 9(b) card vs cpu: {report['b_s']:.1f}s (reduced "
          f"{GEMMA_REDUCED})")
    gc.collect()
    torch.cuda.empty_cache()
    launches["gemma3_12b"], report["gemma3"] = serve_gemma3(
        torch, build, timer, rng)
    gc.collect()               # the engines' graphs sit in reference cycles
    torch.cuda.empty_cache()
    launches["paligemma_3b"], report["paligemma"] = serve_paligemma(
        torch, build, rng)
    gc.collect()
    torch.cuda.empty_cache()
    report["launches"] = launches
    return rows, launches, report


# ---------------------------------------------------------------------------
# phase 10: mixture-of-experts and latent attention
# ---------------------------------------------------------------------------

#: the MoE archs' served paths in the kernels line, and their kernels
MOE_PATHS = {"granite_moe_1b": "serve_granite_moe",
             "deepseek_v2_236b": "serve_deepseek_v2"}
MOE_KERNELS = {"granite_moe_1b": ("absmax", "fused_matmul",
                                  "decode_attention"),
               "deepseek_v2_236b": ("absmax", "fused_matmul", "fused_mlp")}
#: deepseek-v2's cut: its published width, 4 of its 60 layers
DEEPSEEK_LAYERS = 4
DEEPSEEK_REDUCED = {"num_layers": "60 -> 4 (the dense first layer and 3 MoE "
                    "layers): 472 GB of bf16 weights do not fit one 80 GB "
                    "card; one MoE layer's 160 routed experts alone are "
                    "7.55 GB"}


def moe_config(arch: str, **kw):
    """The arch in ``bp8_fused``, over a ``bp8`` cache where it has one
    (the MLA archs keep their bf16 latent cache: bp8 is GQA-only)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    kw = {"matmul_mode": "bp8_fused",
          "kv_quant": "none" if cfg.attention_type == "mla" else "bp8", **kw}
    return dataclasses.replace(cfg, **kw)


def moe_kernel_rows(torch, timer, cfg, log: str, dev="cuda"):
    """Phase 10(a) for one arch: ``served_kernel_rows`` over one layer of a
    4-row decode step: granite's 4 projections; deepseek's and minicpm3's
    MLA projections, shared experts and the dense layers' down
    projection, with the silu MLP where the arch has a dense one."""
    d, h = cfg.d_model, cfg.num_heads
    if cfg.attention_type == "mla":
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        mm = [(d, cfg.q_lora_rank), (cfg.q_lora_rank, h * qk),
              (d, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
              (h * cfg.v_head_dim, d)]
    else:
        kh, hd = cfg.num_kv_heads, cfg.head_dim
        mm = [(d, h * hd), (d, kh * hd), (d, kh * hd), (h * hd, d)]
    if cfg.num_shared_experts:
        sd = cfg.moe_d_ff * cfg.num_shared_experts
        mm += [(d, sd), (d, sd), (sd, d)]
    dense_mlp = cfg.first_dense_layers > 0 or not cfg.num_experts
    if dense_mlp:
        mm += [(cfg.d_ff, d)]
    return served_kernel_rows(torch, timer, cfg, mm, mlp=dense_mlp, dev=dev)


def served_kernel_rows(torch, timer, cfg, step, mlp: bool, big_m=(),
                       dev="cuda"):
    """The kernels an arch's served path runs, against their plain
    versions at its shapes (phase 2's timer, bounds and checks): the fused
    matmul bitwise at every projection in ``step`` (the (K, N) of one
    layer of a decode step, with repeats) at M 4 and 64 and ``big_m``,
    absmax bitwise on the layer's inputs and weights, the MLP (``mlp``,
    the arch's activation) within 1e-5 at M 4 and 64, and decode
    attention within 1e-5 at the arch's D, KH and G (S 1-4096, full and
    a 1024 window) where its cache is ``bp8``.  Rows time the layer of a
    4-row decode step beside its bound, decode attention over a 512-token
    view.  Returns (rows, detail)."""
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import fused as kf
    from repro_torch.kernels import ref
    from repro_torch.kernels.build import KINDS, library

    gen = torch.Generator(device=dev)
    gen.manual_seed(10)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    def weight(k, n):
        return randn(k, n, std=k ** -0.5).to(torch.bfloat16)

    def nbytes(t):
        return t.numel() * t.element_size()

    d, h = cfg.d_model, cfg.num_heads
    distinct = sorted(set(step))
    ws = {kn: weight(*kn) for kn in distinct}
    rows, detail = {}, {"matmul_shapes": step}

    for m in (4, 64) + tuple(big_m):
        for (k, n), w in ws.items():
            x = randn(m, k)
            sx, sy = kf.absmax(x, TINY), kf.absmax(w, TINY)
            if not torch.equal(kf.fused_bp_matmul(x, w, sx, sy),
                               ref.fused_matmul_ref(x, w, sx, sy)):
                fail(f"{cfg.name}: fused matmul differs at {(m, k, n)}")
    xs = {k: randn(4, k) for k in {k for k, _ in distinct}}
    calls, plain, bounds = [], [], []
    for k, n in step:
        w = ws[(k, n)]
        args = (xs[k], w, kf.absmax(xs[k], TINY), kf.absmax(w, TINY))
        calls.append(lambda a=args: kf.fused_bp_matmul(*a))
        plain.append(lambda a=args: ref.fused_matmul_ref(*a))
        bounds.append(bound(4 * 4 * k + nbytes(w) + 8 + 4 * 4 * n,
                            2 * 4 * n * 8 * k, H100_INT8_OPS_PER_S))
    rows["fused_matmul"] = dict(max_abs_err=0.0, ms=timer(calls),
                                plain_ms=timer(plain, iters=3),
                                library_ms=None, b=bounds)

    am_in = [xs[k] for k, _ in step] + [ws[kn] for kn in step]
    if mlp:
        up, gate = weight(d, cfg.d_ff), weight(d, cfg.d_ff)
        am_in += [xs[d], up, gate]
    for t in am_in:
        if not torch.equal(kf.absmax(t, TINY), ref.absmax_ref(t, TINY)):
            fail(f"{cfg.name}: absmax differs at {tuple(t.shape)}")
    rows["absmax"] = dict(
        max_abs_err=0.0,
        ms=timer([lambda t=t: kf.absmax(t, TINY) for t in am_in]),
        plain_ms=timer([lambda t=t: ref.absmax_ref(t, TINY) for t in am_in]),
        library_ms=timer([lambda t=t: torch.amax(t.abs()) for t in am_in]),
        b=[bound(nbytes(t) + 4, t.numel(), H100_F32_FLOPS_PER_S)
           for t in am_in])

    if mlp:
        err, ff = 0.0, cfg.d_ff
        su, sg = kf.absmax(up, TINY), kf.absmax(gate, TINY)
        for m in (4, 64):
            x = randn(m, d)
            sx = kf.absmax(x, TINY)
            a = kf.fused_mlp(x, up, gate, sx, su, sg, cfg.act)
            b = ref.fused_mlp_ref(x, up, gate, cfg.act, sx, su, sg)
            e = ((a - b).abs().max() / b.abs().max().clamp_min(1.0)).item()
            if not math.isfinite(e) or e > 1e-5:
                fail(f"{cfg.name}: MLP off by {e:.3g} at M {m}")
            err = max(err, (a - b).abs().max().item())
        x = xs[d]
        sx = kf.absmax(x, TINY)
        rows["fused_mlp"] = dict(
            max_abs_err=err,
            ms=timer([lambda: kf.fused_mlp(x, up, gate, sx, su, sg,
                                           cfg.act)]),
            plain_ms=timer([lambda: ref.fused_mlp_ref(
                x, up, gate, cfg.act, sx, su, sg)], iters=3),
            library_ms=None,
            b=[bound(4 * 4 * d + nbytes(up) + nbytes(gate) + 12
                     + 4 * 4 * ff, 2 * 2 * 4 * ff * 8 * d,
                     H100_INT8_OPS_PER_S)])

    if cfg.kv_quant == "bp8":
        kh, g, hd = cfg.num_kv_heads, h // cfg.num_kv_heads, cfg.head_dim
        sms = torch.cuda.get_device_properties(0).multi_processor_count

        def cache(s):
            kc, ks = ka.quantize_kv(randn(4, s, kh, hd))
            vc, vs = ka.quantize_kv(randn(4, s, kh, hd))
            pos = torch.arange(s, device=dev, dtype=torch.int32)[None].repeat(
                4, 1)
            qp = torch.tensor([s - 1, max(s - 300, 0), max(s // 2 - 1, 0),
                               max(s - 1100, 0)], dtype=torch.int32,
                              device=dev)
            pos[2, s // 2:] = -1                  # a row's empty tail
            return kc, ks, vc, vs, pos, qp

        q = randn(4, kh, g, hd) / math.sqrt(hd)
        err, launched = 0.0, {}
        for s in (1, 33, 512, 1024, 1300, 4096):
            cc = cache(s)
            for win in (1024, None):
                a = ka.bp8_decode_attention(q, *cc, win)
                e = (a - ka.bp8_decode_attention_ref(q, *cc, win)).abs().max()
                e = e.item()
                if not math.isfinite(e) or e > 1e-5:
                    fail(f"{cfg.name}: decode attention (S {s}, window "
                         f"{win}) off by {e:.3g}")
                err = max(err, e)
            split = ka.split_tokens(s, 4 * kh, g, hd, sms)
            launched[s] = {"split_tokens": split,
                           "dynamic_smem_bytes": ka._split_smem(g, hd, split)}
        detail["decode_attention_launch"] = launched
        S = 512
        kc, ks, vc, vs, pos, qp = main = cache(S)
        win = ka.BIG_WINDOW
        allowed = (pos >= 0) & (pos <= qp[:, None])
        seen = allowed.sum().item()                 # keys let through
        kd, vd = ka.dequantize_kv(kc, ks), ka.dequantize_kv(vc, vs)
        qs = q.reshape(4, kh * g, 1, hd)
        kt = kd.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
        vt = vd.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
        F = torch.nn.functional
        rows["decode_attention"] = dict(
            max_abs_err=err,
            ms=timer([lambda: ka.bp8_decode_attention(q, *main, win)]),
            plain_ms=timer([lambda: ka.bp8_decode_attention_ref(
                q, *main, win)]),
            library_ms=timer([lambda: F.scaled_dot_product_attention(
                qs, kt, vt, attn_mask=allowed[:, None, None, :],
                scale=1.0)]),
            b=[bound(2 * 4 * 4 * kh * g * hd + seen * kh * (2 * hd + 8)
                     + 4 * seen + 4 * 4, 4 * seen * kh * g * hd,
                     H100_F32_FLOPS_PER_S)])
        print(f"{cfg.name}: decode attention at D {hd}, KH {kh}, G {g}: "
              + ", ".join(f"S {s}: split {v['split_tokens']} tokens, "
                          f"{v['dynamic_smem_bytes']} B dynamic shared "
                          f"memory" for s, v in launched.items()))
    lib = library()
    detail["fused_matmul_dynamic_smem_bytes"] = {
        m: lib.oisma_fused_matmul_smem(m, KINDS[torch.bfloat16])
        for m in (4, 64)}
    print(f"{cfg.name}: fused matmul bitwise at (K, N) {distinct}, M "
          + ", ".join(str(m) for m in (4, 64) + tuple(big_m))
          + (f"; {cfg.act} MLP {d} -> {cfg.d_ff}" if mlp else ""))
    for name, r in rows.items():
        print(f"{cfg.name} kernel {name}: ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} library_ms {r['library_ms']} bound_ms "
              f"{sum(x[0] for x in r['b']):.5f} max_abs_err "
              f"{r['max_abs_err']}")
    return rows, detail


def moe_drops(torch, model, params, rng):
    """Capacity and dropped (token, slot)s of each MoE layer in one eager
    64-token prefill chunk and one 4-row decode step (the engine's
    shapes), read from the router (``moe.route``)."""
    from repro_torch.models import moe as moe_mod
    cfg = model.cfg
    seen = []
    route = moe_mod.route

    def record(router, c, xt, capacity):
        r = route(router, c, xt, capacity)
        seen.append((xt.shape[0], capacity, r["keep"]))
        return r

    moe_mod.route = record
    try:
        cache = model.init_cache(4, 128, "cuda")
        toks = torch.as_tensor(rng.integers(3, cfg.vocab_size, (1, 64)),
                               device="cuda")
        one = {k: {n: v[:, :1] for n, v in stack.items()}
               for k, stack in cache.items()}
        model.prefill_chunk(params, {"tokens": toks}, one, 0)
        prefill = [(t, c, int((~keep).sum())) for t, c, keep in seen]
        seen.clear()
        full = {k: {n: v.expand(-1, 4, *v.shape[2:]).contiguous()
                    for n, v in stack.items()} for k, stack in one.items()}
        model.decode_step(params, torch.as_tensor(
            rng.integers(3, cfg.vocab_size, (4, 1)), device="cuda"), full,
            torch.tensor([64, 64, 64, 64], dtype=torch.int32,
                         device="cuda"))
        decode = [(t, c, int((~keep).sum())) for t, c, keep in seen]
    finally:
        moe_mod.route = route
    k = cfg.num_experts_per_tok
    out = {}
    for what, recs in (("prefill_chunk_64", prefill),
                       ("decode_step_4_rows", decode)):
        t, c = recs[0][:2]
        dropped = [d for _, _, d in recs]
        out[what] = {"tokens": t, "slots": t * k, "capacity": c,
                     "dropped_by_layer": dropped,
                     "dropped_share": sum(dropped) / (t * k * len(recs))}
        print(f"{cfg.name} {what}: {t} tokens x {k} slots over "
              f"{cfg.num_experts} experts, capacity {c} per expert; dropped "
              f"slots by layer {dropped} (share "
              f"{out[what]['dropped_share']:.4f})")
    return out


def seeded_on_card(torch, cfg):
    """The arch's seeded weights on the card: (params, init seconds, init
    peak GB, parameter count)."""
    from repro_torch.models import build as build_model
    from repro_torch.models.params import init_params, tree_leaves
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(build_model(cfg).schema(), seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    n = sum(t.numel() for _, t in tree_leaves(params))
    print(f"{cfg.name}: {cfg.num_layers} layers, {n / 1e9:.3f} B params "
          f"seeded on the card in {init_s:.1f}s, init peak {peak:.2f} GB")
    return params, init_s, peak, n


def serve_granite(torch, build, rng):
    """Phase 10(c): the full granite-moe-1b (24 layers) on the paged
    engine, 8 requests of 32-256 prompt tokens, 16 new each, twice
    captured and once eager (tokens equal, launches of the second run),
    a prefill chunk and a decode step replayed bitwise equal to eager,
    the capacity and dropped slots of a chunk and a step, and a short
    captured profile by kind of kernel."""
    from repro_torch.models import build as build_model
    cfg = moe_config("granite_moe_1b")
    model = build_model(cfg)
    params, init_s, init_peak, n = seeded_on_card(torch, cfg)
    lens = [32, 256] + [int(x) for x in rng.integers(32, 257, 6)]
    prompts = [rng.integers(3, cfg.vocab_size, x).astype("int32")
               for x in lens]
    rec, engine, eager_engine = serve_captured_and_eager(
        torch, build, cfg, params, prompts,
        kernels=MOE_KERNELS["granite_moe_1b"])
    del eager_engine
    rec["graphed_vs_eager"] = graphed_vs_eager(torch, model, params, rng)
    rec["drops"] = moe_drops(torch, model, params, rng)
    # short: a MoE step launches ~4x the kernels of a dense one
    prof = profile_serving(torch, engine, cfg, params, prompts[:2], 32, 4)
    ran = set(prof["served_kernels"])
    if not set(MOE_KERNELS["granite_moe_1b"]) <= ran:
        fail(f"{cfg.name}: kernels missing from the captured profile (ran: "
             f"{sorted(ran)})")
    del engine
    return rec["launches"], dict(rec, params=n, init_s=init_s,
                                 init_peak_mem_gb=init_peak, profile=prof)


def serve_deepseek(torch, build, timer, rng):
    """Phase 10(d): deepseek-v2 at its published width, 4 layers (the dense
    first layer and 3 MoE layers), on the paged engine: 4 requests of
    32-200 prompt tokens, 16 new each, twice captured and once eager
    (tokens equal); a captured 4-row decode step's time against the bytes
    of the routed experts it reads (every expert runs its batched matmul,
    as the reference's)."""
    from repro_torch.models import build as build_model
    from repro_torch.models.params import tree_leaves
    cfg = moe_config("deepseek_v2_236b", num_layers=DEEPSEEK_LAYERS)
    model = build_model(cfg)
    params, init_s, init_peak, n = seeded_on_card(torch, cfg)
    lens = [32, 200] + [int(x) for x in rng.integers(32, 201, 2)]
    prompts = [rng.integers(3, cfg.vocab_size, x).astype("int32")
               for x in lens]
    rec, engine, eager_engine = serve_captured_and_eager(
        torch, build, cfg, params, prompts,
        kernels=MOE_KERNELS["deepseek_v2_236b"])
    del eager_engine
    expert_bytes = sum(t.numel() * t.element_size() for path, t in
                       tree_leaves(params["layers"]["moe"])
                       if path[0] in ("up", "gate", "down"))
    key = max(engine._decode._shapes)
    with torch.inference_mode():
        step_ms = timer([lambda: engine._decode(key)], iters=5, clean=True)
    bound_ms = expert_bytes / H100_BYTES_PER_S * 1e3
    print(f"{cfg.name}: a captured 4-row decode step (view {key}) "
          f"{step_ms:.3f} ms; the routed experts' weights it reads "
          f"{expert_bytes / 1e9:.2f} GB, {bound_ms:.3f} ms at 3.35 TB/s "
          f"(share of the step {bound_ms / step_ms:.3f}); reduced "
          f"{DEEPSEEK_REDUCED}")
    prof = profile_serving(torch, engine, cfg, params, prompts[:2], new=4)
    del engine
    return rec["launches"], dict(
        rec, params=n, init_s=init_s, init_peak_mem_gb=init_peak,
        reduced=DEEPSEEK_REDUCED, decode_step_ms=step_ms, decode_view=key,
        expert_bytes=expert_bytes, expert_bytes_bound_ms=bound_ms,
        profile=prof)


def train_granite(torch, build, steps=3, dev="cuda"):
    """Phase 10(e): the full granite-moe-1b in ``bp8_fused`` trained 3 steps
    through ``trainer.train`` (8 x 128 tokens, lr 3e-5, warmup 3): every
    gradient norm finite and above 0, every leaf moved from its seed (the
    routers, f32, by a quarter to twice the learning rates' sum), launches
    (8 absmax and 4 matmuls a layer, forward and recompute; the routed
    experts are plain matmuls), step times and peak memory."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build as build_model
    from repro_torch.models.params import init_params
    from repro_torch.optim.optimizer import OptimizerConfig, lr_at
    from repro_torch.train.trainer import TrainerConfig, train
    cfg = moe_config("granite_moe_1b", kv_quant="none")
    model = build_model(cfg)
    shape = ShapeConfig("train", "train", 128, 8)
    opt = OptimizerConfig(learning_rate=3e-5, warmup_steps=steps,
                          total_steps=steps)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    norms = []
    tcfg = TrainerConfig(total_steps=steps, ckpt_dir=None)
    build.reset_launches()
    state, hist = train(model, cfg, shape, tcfg, opt_cfg=opt, device=dev,
                        on_metrics=lambda i, m: norms.append(
                            float(m["grad_norm"])))
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if len(norms) != steps or not all(math.isfinite(g) and g > 0
                                      for g in norms):
        fail(f"granite training: gradient norms {norms}")
    lr_sum = sum(float(lr_at(opt, torch.tensor(i)))
                 for i in range(1, steps + 1))
    moved, gains = update_from_init(
        torch, init_params(model.schema(), seed=tcfg.seed, device=dev),
        state["params"], lr_sum)
    per = cfg.num_layers * 2 * steps
    want = {"absmax": 8 * per, "fused_matmul": 4 * per}
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        fail(f"granite training launches {got}, expected {want}")
    losses = [h["loss"] for h in hist]
    dts = [h["dt"] for h in hist]
    if not all(math.isfinite(x) for x in losses):
        fail(f"granite training: non-finite losses {losses}")
    moe_moved = {k: v for k, v in moved.items() if "/moe/" in k}
    print(f"granite training: {cfg.num_layers} layers, bp8_fused, {steps} "
          f"steps of {shape.global_batch} x {shape.seq_len} tokens; step "
          f"times " + ", ".join(f"{x:.3f}" for x in dts) + f" s; peak "
          f"device memory {peak:.2f} GB; losses (with the aux loss) "
          + ", ".join(f"{x:.4f}" for x in losses) + "; gradient norms "
          + ", ".join(f"{g:.4f}" for g in norms) + f"; launches {launches}; "
          f"router and experts moved from the seed (least share of a "
          f"leaf): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                  sorted(moe_moved.items())))
    return {"model": cfg.name, "layers": cfg.num_layers, "steps": steps,
            "step_s": dts, "losses": losses, "grad_norms": norms,
            "peak_mem_gb": peak, "launches": launches,
            "moved_share": moved, "f32_step_of_lr_sum": gains}


def phase_moe(torch, timer, build, log: str, rng):
    """Phase 10: mixture-of-experts and latent attention on the card.
    Returns the kernel rows and the launches of each MoE arch's served
    path, and a report."""
    import numpy as np
    report, rows, launches = {}, {}, {}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for arch in MOE_PATHS:
        rows[arch], report[f"kernels_{arch}"] = moe_kernel_rows(
            torch, timer, moe_config(arch), log)
    _, report["kernels_minicpm3_4b"] = moe_kernel_rows(
        torch, timer, moe_config("minicpm3_4b"), log)
    shown = [ln for ln in ptxas_report(log) if any(
        k in ln for k in ("bp_mma_kernel", "absmax_kernel",
                          "decode_partial_kernel", "decode_combine_kernel"))]
    print("kernels (registers, static shared memory, spills; ptxas): "
          + "; ".join(shown))
    report["a_s"] = time.perf_counter() - t0
    print(f"phase 10(a) kernels at the new shapes: {report['a_s']:.1f}s")

    t1 = time.perf_counter()
    report["cpu_s"] = {}
    for arch, lens, new in (("granite_moe_1b", (32, 64), 4),
                            ("minicpm3_4b", (32, 64), 4),
                            ("deepseek_v2_236b", (32, 64), 3)):
        # deepseek's dense first layer and one MoE layer; one layer else
        cfg = moe_config(arch, num_layers=2 if arch == "deepseek_v2_236b"
                         else 1)
        prompts = [rng.integers(3, cfg.vocab_size, x).astype(np.int32)
                   for x in lens]
        report["cpu_s"][arch] = card_vs_cpu(torch, cfg, prompts, new)
        gc.collect()
    report["b_s"] = time.perf_counter() - t1
    print(f"phase 10(b) card vs cpu: {report['b_s']:.1f}s")

    gc.collect()
    torch.cuda.empty_cache()
    launches["granite_moe_1b"], report["granite"] = serve_granite(
        torch, build, rng)
    gc.collect()
    torch.cuda.empty_cache()
    launches["deepseek_v2_236b"], report["deepseek"] = serve_deepseek(
        torch, build, timer, rng)
    gc.collect()
    torch.cuda.empty_cache()
    report["train_granite"] = train_granite(torch, build)
    gc.collect()
    torch.cuda.empty_cache()
    report["launches"] = launches
    return rows, launches, report


# ---------------------------------------------------------------------------
# phase 11: the encoder-decoder (whisper-base) and the hybrid (zamba2-2.7b)
# ---------------------------------------------------------------------------

#: the two archs' served paths in the kernels line, and their kernels
#: (whisper's MLP is un-gated: it runs through ``dense``)
EH_PATHS = {"whisper_base": "serve_whisper_base",
            "zamba2_2p7b": "serve_zamba2_2p7b"}
EH_KERNELS = {"whisper_base": ("absmax", "fused_matmul", "decode_attention"),
              "zamba2_2p7b": ("absmax", "fused_matmul", "fused_mlp",
                              "decode_attention")}
#: 11(b)'s cut of zamba2: one group of its 9 (the CPU's plain path costs
#: seconds a call at full width); whisper-base runs whole
ZAMBA_CHECK_LAYERS = 6
ZAMBA_REDUCED = {"num_layers": "54 -> 6 (one group: 6 Mamba2 blocks and "
                 "the shared attention block) in 11(b), the card-vs-CPU "
                 "check only: the CPU's plain path costs seconds a call "
                 "at full width"}


def eh_shapes(cfg):
    """(the (K, N) of the projections one layer (whisper: a decoder layer;
    zamba2: a group of ``attn_every`` Mamba2 blocks and the shared block)
    runs in a decode step, with repeats; the distinct (K, N) every
    projection of the arch has)."""
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = [(d, h * hd), (d, kh * hd), (d, kh * hd), (h * hd, d)]
    if cfg.family == "encdec":
        # self attention, cross attention's wq and wo (its wk/wv run once
        # a request, at M = frames), the un-gated MLP
        step = attn + [(d, h * hd), (h * hd, d), (d, cfg.d_ff),
                       (cfg.d_ff, d)]
    else:
        d_inner = cfg.ssm_expand * d
        n_in = 2 * d_inner + 2 * cfg.ssm_state + d_inner // cfg.ssm_headdim
        step = ([(d, n_in), (d_inner, d)] * cfg.attn_every + attn
                + [(cfg.d_ff, d)])
    return step, sorted(set(step))


def eh_kernel_rows(torch, timer, cfg, dev="cuda"):
    """Phase 11(a) for one arch: ``served_kernel_rows`` over one decode
    layer (whisper) or group (zamba2) of a 4-row step (``eh_shapes``):
    the matmul also at M 1500 for whisper (the encoder's rows and the
    cross K/V), zamba2's silu MLP, decode attention at G 1.  whisper's
    encoder layer at M 1500 is timed beside its bound into the detail."""
    from repro_torch.kernels import fused as kf
    step, _ = eh_shapes(cfg)
    encdec = cfg.family == "encdec"
    rows, detail = served_kernel_rows(torch, timer, cfg, step,
                                      mlp=cfg.mlp_gated,
                                      big_m=(1500,) if encdec else (),
                                      dev=dev)
    if encdec:          # the encoder layer's projections at 1500 rows
        gen = torch.Generator(device=dev)
        gen.manual_seed(11)
        d, ff = cfg.d_model, cfg.d_ff
        enc = [(d, d)] * 4 + [(d, ff), (ff, d)]
        args = []
        for k, n in enc:
            x = torch.randn((1500, k), generator=gen, device=dev)
            w = (torch.randn((k, n), generator=gen, device=dev)
                 * k ** -0.5).to(torch.bfloat16)
            args.append((x, w, kf.absmax(x, TINY), kf.absmax(w, TINY)))
        ms = timer([lambda a=a: kf.fused_bp_matmul(*a) for a in args])
        b = [bound(4 * 1500 * k + 2 * k * n + 8 + 4 * 1500 * n,
                   2 * 1500 * n * 8 * k, H100_INT8_OPS_PER_S)
             for k, n in enc]
        detail["encoder_layer_1500_rows"] = {
            "ms": ms, "bound_ms": sum(x[0] for x in b),
            "bound_by": "bytes" if sum(x[1] for x in b) >= sum(
                x[2] for x in b) else "operations"}
        print(f"{cfg.name}: an encoder layer's 6 projections at M 1500: "
              f"{ms:.4f} ms, bound {detail['encoder_layer_1500_rows']}")
    return rows, detail


def seeded_frames(torch, cfg, rng):
    """(1, F, d_model) bf16 frame embeddings on the card from ``rng``."""
    import numpy as np
    fr = rng.normal(size=(1, cfg.encoder_frames, cfg.d_model))
    return torch.as_tensor(fr.astype(np.float32), device="cuda").to(
        torch.bfloat16)


def dense_slot_bytes(engine) -> int:
    """Bytes one slot's dense (per-slot) cache leaves hold in the pool."""
    pc = engine.cache
    return sum(leaf.numel() * leaf.element_size() // leaf.shape[bi]
               for _, leaf, bi, is_kv in pc.leaves() if not is_kv)


def serve_encdec_hybrid(torch, build, arch, rng):
    """Phase 11(c)/(d): the full arch on the paged engine (4 slots, block
    16, chunk 64): 8 requests of 32-256 prompt tokens, 16 new each, twice
    captured (the second timed, launches counted) and once eager, tokens
    equal, graphs within the bounds (whisper's with-frames prefill graphs
    included); the first chunk (whisper: with its frames), a later chunk
    and a decode step replayed bitwise equal to eager; the same requests
    once on the lock-step engine (each alone: a refill's prefill of more
    than 256 tokens is refused by the SSD's chunking, in the reference
    too); peak memory, a slot's dense state bytes, and a short captured
    profile by kind of kernel with the idle share."""
    import numpy as np
    from repro_torch.models import build as build_model
    cfg = moe_config(arch)
    model = build_model(cfg)
    params, init_s, init_peak, n = seeded_on_card(torch, cfg)
    frames = (seeded_frames(torch, cfg, rng) if cfg.family == "encdec"
              else None)
    lens = [32, 256] + [int(x) for x in rng.integers(32, 257, 6)]
    prompts = [rng.integers(3, cfg.vocab_size, x).astype(np.int32)
               for x in lens]
    rec, engine, eager_engine = serve_captured_and_eager(
        torch, build, cfg, params, prompts, kernels=EH_KERNELS[arch],
        frames=frames)
    del eager_engine
    shapes = sorted(engine.stats.prefill_shapes)
    if cfg.family == "encdec" and not any(k[2] for k in shapes):
        fail(f"{cfg.name}: no prefill graph with frames ({shapes})")
    rec["prefill_shapes"] = [list(k) for k in shapes]
    rec["dense_slot_bytes"] = dense_slot_bytes(engine)
    print(f"{cfg.name}: prefill shapes (chunk, view, frames) {shapes}; "
          f"a slot's dense cache leaves {rec['dense_slot_bytes'] / 1e6:.2f} "
          f"MB; peak device memory {rec['peak_mem_gb']:.2f} GB")
    rec["graphed_vs_eager"] = graphed_vs_eager(torch, model, params, rng,
                                               frames=frames)
    lock = lockstep_engine(cfg, params, "cuda", temperature=0.0)
    if frames is not None:
        lock.frames.copy_(frames)
    serve_lockstep(torch, lock, prompts[:1], 2, 0, alone=True)   # warm
    out, secs = serve_lockstep(torch, lock, prompts, 16, 0, alone=True)
    n_tok = sum(len(v) for v in out.values())
    for rid, toks in out.items():
        if len(toks) != 16 or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"{cfg.name} lock-step request {rid}: bad output {toks}")
    rec["lockstep"] = {"seconds": secs, "tokens_per_s": n_tok / secs,
                       "graphs": lock.compile_counts()}
    print(f"{cfg.name} on the lock-step engine (each request alone, "
          f"captured decode): {n_tok} tokens in {secs:.3f}s = "
          f"{n_tok / secs:.2f} tok/s, graphs {lock.compile_counts()}")
    del lock
    prof = profile_serving(torch, engine, cfg, params, prompts[:2], 32, 4)
    ran = set(prof["served_kernels"])
    if not set(EH_KERNELS[arch]) <= ran:
        fail(f"{cfg.name}: kernels missing from the captured profile (ran: "
             f"{sorted(ran)})")
    del engine
    return rec["launches"], dict(rec, params=n, init_s=init_s,
                                 init_peak_mem_gb=init_peak, profile=prof)


def phase_encdec_hybrid(torch, timer, build, rng):
    """Phase 11: whisper-base and zamba2-2.7b on the card.  Returns the
    kernel rows and the launches of each arch's served path, and a
    report."""
    import numpy as np
    report, rows, launches = {}, {}, {}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for arch in EH_PATHS:
        rows[arch], report[f"kernels_{arch}"] = eh_kernel_rows(
            torch, timer, moe_config(arch))
    report["a_s"] = time.perf_counter() - t0
    print(f"phase 11(a) kernels at the new shapes: {report['a_s']:.1f}s")

    t1 = time.perf_counter()
    report["cpu_s"] = {}
    for arch, layers in (("whisper_base", None),
                         ("zamba2_2p7b", ZAMBA_CHECK_LAYERS)):
        cfg = moe_config(arch, **({} if layers is None else
                                  {"num_layers": layers}))
        prompts = [rng.integers(3, cfg.vocab_size, x).astype(np.int32)
                   for x in (32, 64)]
        frames = (seeded_frames(torch, cfg, rng)
                  if cfg.family == "encdec" else None)
        report["cpu_s"][arch] = card_vs_cpu(torch, cfg, prompts, 4,
                                            frames=frames)
        gc.collect()
    report["b_reduced"] = ZAMBA_REDUCED
    report["b_s"] = time.perf_counter() - t1
    print(f"phase 11(b) card vs cpu: {report['b_s']:.1f}s (reduced "
          f"{ZAMBA_REDUCED})")

    for arch, part in (("whisper_base", "c"), ("zamba2_2p7b", "d")):
        gc.collect()
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        launches[arch], report[arch] = serve_encdec_hybrid(torch, build,
                                                           arch, rng)
        report[f"{part}_s"] = time.perf_counter() - t2
        print(f"phase 11({part}) {arch}: {report[f'{part}_s']:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    report["launches"] = launches
    return rows, launches, report


# ---------------------------------------------------------------------------
# phase 12: xlstm-1.3b (mLSTM and sLSTM), and ring-buffer KV caches
# ---------------------------------------------------------------------------

#: the two served paths in the kernels line, and their kernels (xlstm has
#: no attention and no MLP: its projections run through ``dense``)
XLSTM_PATH, RING_PATH = "serve_xlstm_1p3b", "serve_ring_h2o_danube"
XLSTM_KERNELS = ("absmax", "fused_matmul")
RING_KERNELS = ("absmax", "fused_matmul", "fused_mlp", "decode_attention")
#: 12(b)'s cuts, the card-vs-CPU checks only (the CPU's plain path costs
#: seconds a call at full width)
XLSTM_CHECK_LAYERS = 8
XLSTM_REDUCED = {"num_layers": "48 -> 8 (one group: 7 mLSTM blocks and the "
                 "sLSTM block) in 12(b), the card-vs-CPU check only"}
RING_REDUCED = {"num_layers": "24 -> 1 and window_size 4096 -> 64 in 12(b), "
                "the card-vs-CPU ring check only, so that a 150-token "
                "prompt wraps the ring"}
#: 12(b)'s new tokens on the ring: each decode step of the CPU's plain
#: path quantises every full-width weight again, so the CPU half grows
#: with the steps
RING_CHECK_NEW = 12
#: 12(d): the ring's prompt, new tokens and cache length
RING_PROMPT, RING_NEW, RING_MAX_LEN = 4600, 16, 8192


def xlstm_config(**kw):
    """xlstm-1.3b in ``bp8_fused`` (no KV cache: its states are f32)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("xlstm_1p3b"),
                               matmul_mode="bp8_fused", **kw)


def ring_config(**kw):
    """h2o-danube-1.8b in ``bp8_fused`` over a ``bp8`` ring cache."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("h2o_danube_1p8b"),
                               matmul_mode="bp8_fused", kv_quant="bp8",
                               ring_cache=True, **kw)


def xlstm_step_shapes(cfg):
    """The (K, N) of the projections one group of xlstm runs in a decode
    step: 7 x (``up`` d -> 2 x inner, ``down`` inner -> d), then the
    sLSTM's ``wx`` d -> 4d and ``wo_proj`` d -> d."""
    from repro_torch.models.ssm import mlstm_inner
    d, di = cfg.d_model, mlstm_inner(cfg)
    return ([(d, 2 * di), (di, d)] * (cfg.slstm_every - 1)
            + [(d, 4 * d), (d, d)])


def wrapped_ring_attention(torch, timer, cfg, dev="cuda"):
    """Row 4 over a wrapped ring: 4 rows, ``window`` slots (h2o-danube's D,
    KH and G) holding positions 4600 .. 4600 + window - 1 at slots
    pos % window, so slot order is not position order; queries at the
    newest position and at three earlier ones (causal masks cut the
    newer cells).  Within 1e-5 of its plain version, and of itself over
    the same cells in position order; timed beside its plain version,
    SDPA on the dequantised ring and its bound.  Returns (row,
    detail)."""
    from repro_torch.kernels import attention as ka
    n, kh = cfg.window_size, cfg.num_kv_heads
    g, hd = cfg.num_heads // kh, cfg.head_dim
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    start, b = 4600, 4
    k, v = (torch.randn((b, n, kh, hd), generator=gen, device=dev)
            for _ in range(2))
    q = torch.randn((b, kh, g, hd), generator=gen, device=dev) / math.sqrt(hd)
    ordered = torch.arange(start, start + n, dtype=torch.int32,
                           device=dev).repeat(b, 1)
    slots = ordered[0].long() % n
    ring = {}
    for name, t in (("k", k), ("v", v), ("pos", ordered)):
        ring[name] = torch.empty_like(t)
        ring[name][:, slots] = t
    if torch.equal(ring["pos"], ordered):
        fail("the ring's slot order equals its position order")
    top = start + n - 1
    qp = torch.tensor([top, top - 300, top - n // 2, top - 1100],
                      dtype=torch.int32, device=dev)
    out, err = {}, 0.0
    for what, kk, vv, pp in (("ring", ring["k"], ring["v"], ring["pos"]),
                             ("ordered", k, v, ordered)):
        kc, ks = ka.quantize_kv(kk)
        vc, vs = ka.quantize_kv(vv)
        args = (q, kc, ks, vc, vs, pp, qp, n)
        out[what] = ka.bp8_decode_attention(*args)
        e = (out[what] - ka.bp8_decode_attention_ref(*args)).abs().max()
        if not math.isfinite(e.item()) or e.item() > 1e-5:
            fail(f"decode attention over a {what} ring of {n} off by "
                 f"{e.item():.3g}")
        err = max(err, e.item())
        if what == "ring":
            main = args
    vs_ordered = (out["ring"] - out["ordered"]).abs().max().item()
    if vs_ordered > 1e-5:
        fail(f"decode attention over the wrapped ring differs from the "
             f"ordered cells by {vs_ordered:.3g}")
    kc, ks, vc, vs, pos = main[1:6]
    allowed = (pos >= 0) & (pos <= qp[:, None]) & (qp[:, None] - pos < n)
    seen = allowed.sum().item()
    kd, vd = ka.dequantize_kv(kc, ks), ka.dequantize_kv(vc, vs)
    qs = q.reshape(b, kh * g, 1, hd)
    kt = kd.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vt = vd.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    F = torch.nn.functional
    row = dict(
        max_abs_err=err,
        ms=timer([lambda: ka.bp8_decode_attention(*main)]),
        plain_ms=timer([lambda: ka.bp8_decode_attention_ref(*main)]),
        library_ms=timer([lambda: F.scaled_dot_product_attention(
            qs, kt, vt, attn_mask=allowed[:, None, None, :], scale=1.0)]),
        b=[bound(2 * 4 * b * kh * g * hd + seen * kh * (2 * hd + 8)
                 + 4 * seen + 4 * b, 4 * seen * kh * g * hd,
                 H100_F32_FLOPS_PER_S)])
    detail = {"slots": n, "positions": [start, start + n - 1],
              "q_pos": qp.tolist(), "keys_seen": seen,
              "max_abs_err": err, "ring_vs_ordered": vs_ordered}
    print(f"decode attention over a wrapped ring (S {n}, window {n}, "
          f"positions {start}..{start + n - 1} at slots pos % {n}): within "
          f"{err:.3g} of its plain version, {vs_ordered:.3g} of the ordered "
          f"cells; ms {row['ms']:.4f} plain {row['plain_ms']:.4f} SDPA "
          f"{row['library_ms']:.4f} bound {row['b'][0][0]:.5f}")
    return row, detail


def param_bytes(params) -> int:
    from repro_torch.models.params import tree_leaves
    return sum(t.numel() * t.element_size() for _, t in tree_leaves(params))


def spec_bytes(spec) -> int:
    """Bytes of a cache spec ({leaf: (shape, dtype)})."""
    from repro_torch.models.params import tree_leaves
    return sum(math.prod(shape) * dtype.itemsize
               for _, (shape, dtype) in tree_leaves(spec))


def serve_xlstm(torch, build, timer, rng):
    """Phase 12(c): the full xlstm-1.3b (48 layers) on the paged engine as
    phase 4 serves h2o-danube (4 slots, block 16, chunk 64, 8 requests of
    32-256 tokens, 16 new each), twice captured and once eager, tokens
    equal; a first chunk (the zero state), a later chunk and a decode step
    replayed bitwise equal to eager; a slot's dense state bytes, peak
    memory, a captured 4-row decode step against its bytes (the weights
    and the states read and written), a short captured profile; then the
    same requests on the lock-step engine, each alone (prompts of at most
    256 tokens: a longer one must be a multiple of the mLSTM's chunk)."""
    import numpy as np
    from repro_torch.models import build as build_model
    cfg = xlstm_config()
    model = build_model(cfg)
    params, init_s, init_peak, n = seeded_on_card(torch, cfg)
    lens = [32, 256] + [int(x) for x in rng.integers(32, 257, 6)]
    prompts = [rng.integers(3, cfg.vocab_size, x).astype(np.int32)
               for x in lens]
    rec, engine, eager_engine = serve_captured_and_eager(
        torch, build, cfg, params, prompts, kernels=XLSTM_KERNELS)
    del eager_engine
    rec["prefill_shapes"] = [list(k) for k in
                             sorted(engine.stats.prefill_shapes)]
    rec["dense_slot_bytes"] = slot = dense_slot_bytes(engine)
    spec = model.cache_spec(1, 1)
    if slot != spec_bytes(spec):
        fail(f"{cfg.name}: a slot holds {slot} B of state, its spec "
             f"{spec_bytes(spec)}")
    rec["graphed_vs_eager"] = graphed_vs_eager(torch, model, params, rng,
                                               fresh=True)
    key = max(engine._decode._shapes)
    with torch.inference_mode():
        step_ms = timer([lambda: engine._decode(key)], iters=5, clean=True)
    wbytes = param_bytes(params)
    step_bytes = wbytes + 2 * engine.ecfg.slots * slot
    bound_ms = step_bytes / H100_BYTES_PER_S * 1e3
    rec["decode_step"] = {"view": key, "ms": step_ms,
                          "weight_bytes": wbytes, "bytes": step_bytes,
                          "bound_ms": bound_ms}
    print(f"{cfg.name}: a slot's state {slot / 1e6:.2f} MB (mLSTM "
          f"{spec_bytes(spec['mlstm']) / 1e6:.2f}, sLSTM "
          f"{spec_bytes(spec['slstm']) / 1e6:.3f}); peak "
          f"device memory {rec['peak_mem_gb']:.2f} GB; a captured 4-row "
          f"decode step (view {key}) {step_ms:.3f} ms against "
          f"{bound_ms:.3f} ms to read {wbytes / 1e9:.2f} GB of weights and "
          f"read and write 4 slots' state (share {bound_ms / step_ms:.3f})")
    prof = profile_serving(torch, engine, cfg, params, prompts[:2], 32, 4)
    ran = set(prof["served_kernels"])
    if not set(XLSTM_KERNELS) <= ran:
        fail(f"{cfg.name}: kernels missing from the captured profile (ran: "
             f"{sorted(ran)})")
    del engine
    lock = lockstep_engine(cfg, params, "cuda", temperature=0.0)
    serve_lockstep(torch, lock, prompts[:1], 2, 0, alone=True)   # warm
    out, secs = serve_lockstep(torch, lock, prompts, 16, 0, alone=True)
    n_tok = sum(len(v) for v in out.values())
    for rid, toks in out.items():
        if len(toks) != 16 or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"{cfg.name} lock-step request {rid}: bad output {toks}")
    lockstep_replay_vs_eager(torch, lock, params, prompts[0], rng)
    rec["lockstep"] = {"seconds": secs, "tokens_per_s": n_tok / secs,
                       "graphs": lock.compile_counts()}
    print(f"{cfg.name} on the lock-step engine (each request alone, "
          f"captured decode): {n_tok} tokens in {secs:.3f}s = "
          f"{n_tok / secs:.2f} tok/s, graphs {lock.compile_counts()}")
    del lock
    return rec["launches"], dict(rec, params=n, init_s=init_s,
                                 init_peak_mem_gb=init_peak, profile=prof)


def serve_ring(torch, build, timer, rng):
    """Phase 12(d): the full h2o-danube-1.8b on the lock-step engine with
    ``ring_cache=True`` (window 4096): one prompt of 4600 tokens, 16 new,
    max_len 8192, twice on a capturing engine (the second timed, its
    launches zeroed just before and read just after) and once eager,
    tokens equal; the decode graph replayed bitwise equal to eager; the
    prefill logits bitwise those of the same engine without the ring
    (prefill attends the whole prompt either way); the decode tokens and
    the largest logit difference against it (reported: the softmax sums
    another number of cells); a slot's cache bytes, ring against full; a
    captured decode step against its bytes; peak memory; a profile of
    the request."""
    import numpy as np
    from repro_torch.models import build as build_model
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    ring = ring_config()
    full = dataclasses.replace(ring, ring_cache=False)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(build_model(full).schema(), seed=0, device="cuda")
    prompt = rng.integers(3, ring.vocab_size, RING_PROMPT).astype(np.int32)
    ecfg = EngineConfig(slots=1, max_len=RING_MAX_LEN, eos_id=-1)
    engines, runs = {}, {}
    for what, cfg, capture in (("ring", ring, None),
                               ("ring_eager", ring, False),
                               ("full", full, None)):
        eng = ServeEngine(build_model(cfg), params, cfg, ecfg,
                          device="cuda", capture=capture)
        logits = []
        sample = eng._sample

        def recording(lg, slots, sample=sample, logits=logits):
            logits.append(lg.float().clone())
            return sample(lg, slots)

        eng._sample = recording
        out, secs = serve_lockstep(torch, eng, [prompt], RING_NEW, 0, True)
        runs[what] = {"tokens": out[0], "first_s": secs,
                      "logits": list(logits)}
        if capture is None:
            logits.clear()
            if what == "ring":
                build.reset_launches()
            again, secs = serve_lockstep(torch, eng, [prompt], RING_NEW, 0,
                                         True)
            if what == "ring":
                runs[what]["launches"] = dict(build.LAUNCHES)
            if again != out:
                fail(f"{cfg.name} ({what}): a second captured run's tokens "
                     f"differ from the first's")
        runs[what]["seconds"] = secs
        engines[what] = eng
        if len(out[0]) != RING_NEW or not all(
                0 <= t < ring.vocab_size for t in out[0]):
            fail(f"{cfg.name} ({what}): bad output {out[0]}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    r, e, f = runs["ring"], runs["ring_eager"], runs["full"]
    if r["tokens"] != e["tokens"]:
        fail(f"ring: captured tokens {r['tokens']} differ from eager "
             f"{e['tokens']}")
    if not torch.equal(r["logits"][0], f["logits"][0]):
        fail(f"ring: prefill logits differ from the full cache's by "
             f"{(r['logits'][0] - f['logits'][0]).abs().max().item()}")
    diffs = [(a - b).abs().max().item()
             for a, b in zip(r["logits"][1:], f["logits"][1:])]
    launches = r["launches"]
    for name in RING_KERNELS:
        if launches.get(name, 0) <= 0:
            fail(f"ring: kernel {name} was not launched")
    lockstep_replay_vs_eager(torch, engines["ring"], params, prompt, rng)
    step = {}
    for what in ("ring", "full"):
        eng = engines[what]
        with torch.inference_mode():
            step[what] = timer([lambda eng=eng: eng._decode(
                (1, RING_MAX_LEN))], iters=5, clean=True)
    ring_b = spec_bytes(build_model(ring).cache_spec(1, RING_MAX_LEN))
    full_b = spec_bytes(build_model(full).cache_spec(1, RING_MAX_LEN))
    wbytes = param_bytes(params)
    bound_ms = (wbytes + ring_b) / H100_BYTES_PER_S * 1e3
    eng = engines["ring"]
    prof = profile_run(torch, lambda: serve_lockstep(
        torch, eng, [prompt], RING_NEW, 0, True)[1], True)
    for k in list(engines):
        del engines[k]
    del eng
    rec = {"model": ring.name, "layers": ring.num_layers,
           "window": ring.window_size, "prompt_tokens": RING_PROMPT,
           "new_tokens": RING_NEW, "max_len": RING_MAX_LEN,
           "tokens": r["tokens"], "full_tokens": f["tokens"],
           "tokens_equal_full": r["tokens"] == f["tokens"],
           "decode_logit_max_abs_diff_vs_full": diffs,
           "seconds": r["seconds"], "tokens_per_s": RING_NEW / r["seconds"],
           "eager_seconds": e["seconds"],
           "eager_tokens_per_s": RING_NEW / e["seconds"],
           "full_seconds": f["seconds"],
           "full_tokens_per_s": RING_NEW / f["seconds"],
           "first_run_seconds": r["first_s"], "launches": launches,
           "cache_bytes_per_slot": {"ring": ring_b, "full": full_b},
           "decode_step_ms": step, "weight_bytes": wbytes,
           "decode_step_bound_ms": bound_ms, "peak_mem_gb": peak,
           "profile": prof}
    print(f"ring ({ring.name}, window {ring.window_size}, lock-step, one "
          f"prompt of {RING_PROMPT}, {RING_NEW} new, max_len "
          f"{RING_MAX_LEN}): captured {r['seconds']:.3f}s = "
          f"{RING_NEW / r['seconds']:.2f} tok/s (first run "
          f"{r['first_s']:.3f}s), eager {e['seconds']:.3f}s, full cache "
          f"captured {f['seconds']:.3f}s; tokens {r['tokens']}, full cache "
          f"{f['tokens']} (equal {r['tokens'] == f['tokens']}); decode "
          f"logits against the full cache differ by at most "
          f"{max(diffs):.3g}; prefill logits bitwise equal")
    print(f"ring: a slot's cache {ring_b / 1e6:.2f} MB, full "
          f"{full_b / 1e6:.2f} MB; a captured decode step ring "
          f"{step['ring']:.3f} ms, full {step['full']:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({wbytes / 1e9:.2f} GB of weights and the "
          f"ring); peak device memory {peak:.2f} GB; launches {launches}")
    return launches, rec


def phase_xlstm_ring(torch, timer, build, rows2, rng):
    """Phase 12: xlstm-1.3b and the ring cache on the card.  ``rows2``:
    phase 2's rows, which hold rows 1-3 at h2o-danube's shapes, the ring
    path's.  Returns the kernel rows and the launches of each path, and
    a report."""
    import numpy as np
    report, rows, launches = {}, {}, {}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    xcfg = xlstm_config()
    rows[XLSTM_PATH], report["kernels_xlstm"] = served_kernel_rows(
        torch, timer, xcfg, xlstm_step_shapes(xcfg), mlp=False,
        big_m=(256,))
    ring_row, report["ring_attention"] = wrapped_ring_attention(
        torch, timer, ring_config())
    rows[RING_PATH] = {n: rows2[n] for n in RING_KERNELS[:3]}
    rows[RING_PATH]["decode_attention"] = ring_row
    report["a_s"] = time.perf_counter() - t0
    print(f"phase 12(a) kernels at the new shapes: {report['a_s']:.1f}s")

    t1 = time.perf_counter()
    x8 = xlstm_config(num_layers=XLSTM_CHECK_LAYERS)
    prompts = [rng.integers(3, x8.vocab_size, n).astype(np.int32)
               for n in (32, 64)]
    report["cpu_s"] = {"xlstm_paged": card_vs_cpu(torch, x8, prompts, 4),
                       "xlstm_lockstep": lockstep_card_vs_cpu(
                           torch, x8, prompts, 4)}
    gc.collect()
    r2 = ring_config(num_layers=CPU_CHECK_LAYERS, window_size=64)
    prompts = [rng.integers(3, r2.vocab_size, n).astype(np.int32)
               for n in (100, 150)]
    report["cpu_s"]["ring_lockstep"] = lockstep_card_vs_cpu(
        torch, r2, prompts, RING_CHECK_NEW, max_len=256)
    report["b_reduced"] = {"xlstm": XLSTM_REDUCED, "ring": RING_REDUCED}
    report["b_s"] = time.perf_counter() - t1
    print(f"phase 12(b) card vs cpu: {report['b_s']:.1f}s (reduced "
          f"{report['b_reduced']})")

    for what, part, fn in (("xlstm_1p3b", "c", serve_xlstm),
                           ("ring", "d", serve_ring)):
        gc.collect()
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        path = XLSTM_PATH if part == "c" else RING_PATH
        launches[path], report[what] = fn(torch, build, timer, rng)
        report[f"{part}_s"] = time.perf_counter() - t2
        print(f"phase 12({part}) {what}: {report[f'{part}_s']:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    report["launches"] = launches
    return rows, launches, report


# ---------------------------------------------------------------------------
# phase 13: training whisper-base, zamba2-2.7b and xlstm-1.3b
# ---------------------------------------------------------------------------

#: the three families' training paths in the kernels line
FT_PATHS = {"whisper_base": "train_whisper_base",
            "zamba2_2p7b": "train_zamba2_2p7b",
            "xlstm_1p3b": "train_xlstm_1p3b"}
#: the training shape of 13(a) and 13(c), the launcher's: seq 128 and
#: global batch 8, so M = 1024 rows a projection (whisper's encoder and
#: cross K/V: 8 x 1500 frames)
FT_SEQ, FT_BATCH, FT_STEPS = 128, 8, 3
#: 13(b)'s steps: (depth overrides, the CPU following the card's layer
#: outputs), each gated by ``compare_train_step``'s whole-step rules.  Each
#: CPU step also runs under ``replay_ops`` (each block and kernel held to
#: the card on the CPU's inputs, forward and backward).  whisper at depth
#: (3 + 3 layers) and xlstm's one group (8 layers) compound the layers'
#: forward rounding (a bf16 flip before a BP quantise moves a whole
#: level) past those rules in
#: ``bf16`` as in ``bp8_fused``: the CPU following the card's layer
#: outputs parts from the CPU as far as the card does (PERF.md,
#: Findings).  So there the CPU follows the card's layers (held to the
#: CPU's within ``FOLLOW_TOL``) and the rules hold the rest of the step;
#: whisper at 1 + 1 layers and zamba2's group hold them plain
FT_CHECKS = {"whisper_base": (({"encoder_layers": 3, "num_layers": 3}, True),
                              ({"encoder_layers": 1, "num_layers": 1},
                               False)),
             "zamba2_2p7b": (({"num_layers": 6}, False),),
             "xlstm_1p3b": (({"num_layers": 8}, True),)}
FT_REDUCED = {
    "whisper_base": "encoder_layers 6 -> 1 and num_layers 6 -> 1 for the "
                    "plain whole-step comparison of 13(b); 6 -> 3 and 6 -> 3 "
                    "against the CPU following its layer outputs",
    "zamba2_2p7b": "num_layers 54 -> 6 (one group: 6 Mamba2 layers and the "
                   "shared block) in 13(b), the card-vs-CPU step only",
    "xlstm_1p3b": "num_layers 48 -> 8 (one group: 7 mLSTM blocks and 1 "
                  "sLSTM block) in 13(b), the card-vs-CPU step only"}


def ft_config(arch, **kw):
    """The arch in ``bp8_fused``, no KV cache (training keeps none)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), matmul_mode="bp8_fused",
                               kv_quant="none", **kw)


def ft_layer_shapes(cfg):
    """The (M, K, N) of the projections one forward layer of the arch runs
    at the training shape, and for whisper its encoder layer's (None
    else): whisper a decoder layer (self attention, cross attention with
    its K/V at M = batch x frames, the un-gated MLP); zamba2 a Mamba2
    layer and the shared block's attention and MLP down projection (its
    up and gate are the fused MLP); xlstm an mLSTM block (``up``,
    ``down``) and the sLSTM block (``wx``, ``wo_proj``)."""
    from repro_torch.models.ssm import mlstm_inner
    m, d = FT_SEQ * FT_BATCH, cfg.d_model
    hd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    attn = [(m, d, hd), (m, d, kvd), (m, d, kvd), (m, hd, d)]
    if cfg.family == "encdec":
        mf = FT_BATCH * cfg.encoder_frames
        mlp = [(d, cfg.d_ff), (cfg.d_ff, d)]
        dec = attn + [(m, d, hd), (mf, d, kvd), (mf, d, kvd), (m, hd, d)] + [
            (m, k, n) for k, n in mlp]
        enc = [(mf, k, n) for _, k, n in attn] + [(mf, k, n) for k, n in mlp]
        return dec, enc
    if cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * d
        n_in = 2 * d_inner + 2 * cfg.ssm_state + d_inner // cfg.ssm_headdim
        return [(m, d, n_in), (m, d_inner, d)] + attn + [
            (m, cfg.d_ff, d)], None
    di = mlstm_inner(cfg)
    return [(m, d, 2 * di), (m, di, d), (m, d, 4 * d), (m, d, d)], None


def ft_kernel_rows(torch, timer, cfg, dev="cuda"):
    """Phase 13(a) for one arch: absmax and the fused matmul bitwise at
    every projection of ``ft_layer_shapes`` (whisper's encoder layer too)
    and zamba2's silu MLP 2560 -> 10240 at M 1024 within 1e-5 of their
    plain versions, and one forward layer's kernels timed (phase 2's
    timer) beside their bound; whisper's encoder layer at M 8 x 1500
    into the detail.  Returns (rows, detail)."""
    from repro_torch.kernels import fused as kf
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    def nbytes(t):
        return t.numel() * t.element_size()

    layer, enc = ft_layer_shapes(cfg)
    every = layer + (enc or [])
    ws = {(k, n): randn(k, n, std=k ** -0.5).to(torch.bfloat16)
          for _, k, n in every}
    xs = {(m, k): randn(m, k) for m, k, _ in every}
    for t in list(xs.values()) + list(ws.values()):
        if not torch.equal(kf.absmax(t, TINY), ref.absmax_ref(t, TINY)):
            fail(f"{cfg.name}: absmax differs at {tuple(t.shape)} {t.dtype}")
    sc = {id(t): kf.absmax(t, TINY)
          for t in list(xs.values()) + list(ws.values())}

    def args(shapes):
        return [(xs[(m, k)], ws[(k, n)], sc[id(xs[(m, k)])],
                 sc[id(ws[(k, n)])]) for m, k, n in shapes]

    for (m, k, n), a in zip(every, args(every)):
        got, want = kf.fused_bp_matmul(*a), ref.fused_matmul_ref(*a)
        if not torch.equal(got, want):
            fail(f"{cfg.name}: fused matmul differs at {(m, k, n)}: max "
                 f"{(got - want).abs().max().item()}")

    def mm_bounds(shapes):
        return [bound(4 * m * k + 2 * k * n + 8 + 4 * m * n,
                      2 * m * n * 8 * k, H100_INT8_OPS_PER_S)
                for m, k, n in shapes]

    lay = args(layer)
    rows = {"fused_matmul": dict(
        max_abs_err=0.0,
        ms=timer([lambda a=a: kf.fused_bp_matmul(*a) for a in lay]),
        plain_ms=timer([lambda a=a: ref.fused_matmul_ref(*a) for a in lay],
                       iters=3),
        library_ms=None, b=mm_bounds(layer))}
    am_in = [a[0] for a in lay] + [a[1] for a in lay]
    detail = {"layer_shapes": layer}
    if cfg.mlp_gated and cfg.family == "hybrid":
        d, ff = cfg.d_model, cfg.d_ff
        x = randn(FT_SEQ * FT_BATCH, d)
        up, gate = (randn(d, ff, std=d ** -0.5).to(torch.bfloat16)
                    for _ in range(2))
        margs = (x, up, gate) + tuple(kf.absmax(t, TINY)
                                      for t in (x, up, gate))
        got = kf.fused_mlp(*margs, cfg.act)
        want = ref.fused_mlp_ref(x, up, gate, cfg.act, *margs[3:])
        e = ((got - want).abs().max() / want.abs().max().clamp_min(1.0)
             ).item()
        if not math.isfinite(e) or e > 1e-5:
            fail(f"{cfg.name}: fused MLP ({cfg.act}) off by {e:.3g} at M "
                 f"{x.shape[0]}")
        m = x.shape[0]
        rows["fused_mlp"] = dict(
            max_abs_err=(got - want).abs().max().item(),
            ms=timer([lambda: kf.fused_mlp(*margs, cfg.act)]),
            plain_ms=timer([lambda: ref.fused_mlp_ref(
                x, up, gate, cfg.act, *margs[3:])], iters=3),
            library_ms=None,
            b=[bound(4 * m * d + nbytes(up) + nbytes(gate) + 12 + 4 * m * ff,
                     2 * 2 * m * ff * 8 * d, H100_INT8_OPS_PER_S)])
        am_in += [x, up, gate]
    rows["absmax"] = dict(
        max_abs_err=0.0,
        ms=timer([lambda t=t: kf.absmax(t, TINY) for t in am_in]),
        plain_ms=timer([lambda t=t: ref.absmax_ref(t, TINY) for t in am_in]),
        library_ms=timer([lambda t=t: torch.amax(t.abs()) for t in am_in]),
        b=[bound(nbytes(t) + 4, t.numel(), H100_F32_FLOPS_PER_S)
           for t in am_in])
    if enc:
        b = mm_bounds(enc)
        ea = args(enc)
        detail["encoder_layer"] = {
            "rows": enc[0][0],
            "ms": timer([lambda a=a: kf.fused_bp_matmul(*a) for a in ea]),
            "bound_ms": sum(x[0] for x in b),
            "bound_by": "bytes" if sum(x[1] for x in b) >= sum(
                x[2] for x in b) else "operations"}
        print(f"{cfg.name}: the encoder layer's 6 projections at M "
              f"{enc[0][0]}: {detail['encoder_layer']}")
    print(f"{cfg.name}: absmax and the fused matmul bitwise at (M, K, N) "
          f"{sorted(set(every))}"
          + (f"; the {cfg.act} MLP {cfg.d_model} -> {cfg.d_ff} at M "
             f"{FT_SEQ * FT_BATCH} within 1e-5" if "fused_mlp" in rows
             else ""))
    for name, r in rows.items():
        print(f"{cfg.name} train kernel {name} (one forward layer): ms "
              f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
              f"{r['library_ms']} bound_ms {sum(x[0] for x in r['b']):.4f} "
              f"max_abs_err {r['max_abs_err']}")
    return rows, detail


def ft_card_vs_cpu(torch, arch, dev="cuda"):
    """Phase 13(b) for one arch: ``bp8_fused`` train steps at full width
    (``FT_CHECKS``' depths) on the card and on the CPU from one seeded
    state over ``demo_batch`` (2 x 32 tokens; whisper's 2 x 1500 frames):
    the CPU's step replayed op by op on the card (``replay_ops``), and
    ``compare_train_step``'s rules on the whole step (the loss within
    1e-5 of it), against the CPU following the card's layer outputs
    where ``FT_CHECKS`` says."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.inputs import demo_batch
    from repro_torch.models import build as build_model
    from repro_torch.optim.optimizer import OptimizerConfig
    out = []
    for kw, follow in FT_CHECKS[arch]:
        cfg = ft_config(arch, **kw)
        host = demo_batch(cfg, ShapeConfig("t", "train", 32, 2),
                          device="cpu")
        depth = (f"{cfg.encoder_layers} + {cfg.num_layers}"
                 if cfg.family == "encdec" else str(cfg.num_layers))
        rep = compare_train_step(
            torch, build_model(cfg), OptimizerConfig(warmup_steps=5,
                                                     total_steps=8),
            host, f"full width, {depth} layers, 2 x 32 tokens", dev,
            loss_rtol=1e-5, follow_card=follow)
        out.append(dict(rep, overrides=kw, follow_card=follow))
        gc.collect()
    return out


def ft_launches_per_step(cfg) -> dict:
    """The launches of one train step: each ``dense`` 2 absmax and 1 fused
    matmul, the fused MLP 3 absmax; a layer the backward recomputes
    (whisper's decoder layers, zamba2's Mamba2 layers, xlstm's mLSTM
    blocks) twice."""
    if cfg.family == "encdec":
        mm, mlp = cfg.encoder_layers * 6 + cfg.num_layers * 10 * 2, 0
    elif cfg.family == "hybrid":
        groups = cfg.num_layers // cfg.attn_every
        mm, mlp = cfg.num_layers * 2 * 2 + groups * 5, groups
    else:
        groups = cfg.num_layers // cfg.slstm_every
        mm, mlp = groups * ((cfg.slstm_every - 1) * 2 * 2 + 2), 0
    return {"absmax": 2 * mm + 3 * mlp, "fused_matmul": mm,
            "fused_mlp": mlp}


def ft_train_full(torch, build, arch, dev="cuda"):
    """Phase 13(c) for one arch: the model at full width in ``bp8_fused``
    trained ``FT_STEPS`` steps of 8 x 128 tokens at lr 3e-5 (warmup
    ``FT_STEPS``): whisper-base whole through ``make_train_step`` over
    ``demo_batch`` (seeds 0, 1, 2: the data pipeline makes no frames);
    xlstm-1.3b and zamba2-2.7b whole through ``trainer.train``.  Launch
    counts zeroed just before and read just after
    (``ft_launches_per_step``); each loss finite, each gradient norm
    finite and above 0, every leaf moved from its seed
    (``update_from_init``); step seconds, tokens/s past the first step,
    peak device memory; a profile of one more step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch.inputs import demo_batch
    from repro_torch.models import build as build_model
    from repro_torch.models.params import init_params, tree_leaves
    from repro_torch.optim.optimizer import OptimizerConfig, lr_at
    from repro_torch.train.train_step import (TrainPlan, init_state,
                                              make_train_step)
    from repro_torch.train.trainer import TrainerConfig, train
    cfg = ft_config(arch)
    model = build_model(cfg)
    shape = ShapeConfig("train", "train", FT_SEQ, FT_BATCH)
    opt = OptimizerConfig(learning_rate=3e-5, warmup_steps=FT_STEPS,
                          total_steps=FT_STEPS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    norms = []
    build.reset_launches()
    if cfg.family == "encdec":
        state = init_state(model, 0, opt, dev)
        step = make_train_step(model, opt, TrainPlan(1, FT_BATCH))
        hist = []
        for i in range(FT_STEPS):
            batch = demo_batch(cfg, shape, seed=i, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss = float(m["loss"])
            hist.append({"step": i + 1, "loss": loss,
                         "dt": time.perf_counter() - t0})
            norms.append(float(m["grad_norm"]))
        prof_batch = demo_batch(cfg, shape, seed=FT_STEPS, device=dev)
    else:
        state, hist = train(model, cfg, shape,
                            TrainerConfig(total_steps=FT_STEPS,
                                          ckpt_dir=None),
                            opt_cfg=opt, device=dev,
                            on_metrics=lambda i, m: norms.append(
                                float(m["grad_norm"])))
        prof_batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_at(
            DataConfig(vocab_size=cfg.vocab_size, seq_len=FT_SEQ,
                       global_batch=FT_BATCH), FT_STEPS).items()}
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(t.numel() for _, t in tree_leaves(state["params"]))
    losses = [h["loss"] for h in hist]
    dts = [h["dt"] for h in hist]
    if len(norms) != FT_STEPS or not all(math.isfinite(g) and g > 0
                                         for g in norms):
        fail(f"{cfg.name} training: gradient norms {norms}, not finite and "
             f"above 0 at each of {FT_STEPS} steps")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{cfg.name} training: non-finite losses {losses}")
    want = {k: v * FT_STEPS for k, v in ft_launches_per_step(cfg).items()}
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        fail(f"{cfg.name} training launches {got}, expected {want}")
    lr_sum = sum(float(lr_at(opt, torch.tensor(i)))
                 for i in range(1, FT_STEPS + 1))
    moved, gains = update_from_init(
        torch, init_params(model.schema(), seed=0, device=dev),
        state["params"], lr_sum)
    tokens = FT_SEQ * FT_BATCH
    med = sorted(dts[1:])[len(dts[1:]) // 2]
    print(f"{cfg.name} training: {cfg.num_layers} layers, "
          f"{n_params / 1e9:.3f} B params, bp8_fused, {FT_STEPS} steps of "
          f"{FT_BATCH} x {FT_SEQ} tokens; step times "
          + ", ".join(f"{x:.3f}" for x in dts)
          + f" s (median past the first {med:.3f} s = {tokens / med:.1f} "
          f"training tokens/s); peak device memory {peak:.2f} GB; losses "
          + ", ".join(f"{x:.4f}" for x in losses) + "; gradient norms "
          + ", ".join(f"{g:.4f}" for g in norms) + f"; launches {launches}; "
          f"moved from the seed: least share of a leaf "
          f"{min(moved.values()):.3g}, f32 leaves' largest step "
          f"{min(gains.values()):.3f}-{max(gains.values()):.3f} of the "
          f"learning rates' sum {lr_sum:.3g}")
    prof = profile_train_step(torch, model, opt, state, prof_batch,
                              label=f"{cfg.num_layers} layers, {FT_BATCH} x "
                                    f"{FT_SEQ} tokens")
    return launches, {"model": cfg.name, "layers": cfg.num_layers,
                      "params": n_params, "steps": FT_STEPS,
                      "tokens_per_step": tokens, "step_s": dts,
                      "median_step_s": med, "tokens_per_s": tokens / med,
                      "losses": losses, "grad_norms": norms,
                      "peak_mem_gb": peak, "launches": launches,
                      "moved_share": moved, "f32_step_of_lr_sum": gains,
                      "profile": prof}


def phase_train_families(torch, timer, build):
    """Phase 13: whisper-base, zamba2-2.7b and xlstm-1.3b trained on the
    card.  Returns the kernel rows and the launches of each arch's
    training path, and a report."""
    report, rows, launches = {}, {}, {}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for arch in FT_PATHS:
        rows[arch], report[f"kernels_{arch}"] = ft_kernel_rows(
            torch, timer, ft_config(arch))
    report["a_s"] = time.perf_counter() - t0
    print(f"phase 13(a) kernels at the training shapes: {report['a_s']:.1f}s")

    t1 = time.perf_counter()
    report["card_vs_cpu"] = {}
    for arch in FT_PATHS:
        report["card_vs_cpu"][arch] = ft_card_vs_cpu(torch, arch)
        gc.collect()
    report["b_reduced"] = FT_REDUCED
    report["b_s"] = time.perf_counter() - t1
    print(f"phase 13(b) card vs cpu: {report['b_s']:.1f}s (reduced "
          f"{FT_REDUCED})")

    for arch in FT_PATHS:
        t2 = time.perf_counter()
        launches[arch], report[arch] = ft_train_full(torch, build, arch)
        report[f"c_s_{arch}"] = time.perf_counter() - t2
        print(f"phase 13(c) {arch}: {report[f'c_s_{arch}']:.1f}s")
        gc.collect()
        torch.cuda.empty_cache()
    report["launches"] = launches
    return rows, launches, report


# ---------------------------------------------------------------------------
# phase 14: the distributed layer (mesh, sharding, TP, GPipe and 1F1B)
# ---------------------------------------------------------------------------

DIST_PATH = "train_mesh_bp8_fused"
#: (c): h2o-danube-1.8b at full width and 12 of its 24 layers (whole
#: until phase 15 came) on (stage 2, data 1, model 2), 3 steps
DIST_SHAPE = {"stage": 2, "data": 1, "model": 2}
DIST_FULL_LAYERS = 12
DIST_STEPS, DIST_SEQ, DIST_BATCH = 3, 128, 8
#: (b)'s depths, and the batch of its steps (2 x 32 tokens, 2 microbatches
#: on 2 stages: ``TrainPlan.for_shape``'s)
DIST_LAYERS, DIST_STAGE_TP_LAYERS = 2, 4
DIST_CHECK_SEQ, DIST_CHECK_BATCH = 32, 2
DIST_REDUCED = {"num_layers": "24 -> 2 in 14(b) (4 for the bf16 stage x "
                "TP case); granite-moe-1b 24 -> 2, minicpm3-4b 62 -> 2; "
                "24 -> 12 in 14(c)"}
#: the whole-step cases held to the same mesh on the CPU (4 gloo ranks)
DIST_CPU_CASES = ("h2o_danube_1p8b", "granite_moe_1b", "minicpm3_4b")
#: the limit on a world of ranks (spawn, the kernels' load, the cases)
DIST_TIMEOUT = 600


def dist_config(arch, mode="bp8_fused", layers=None):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, matmul_mode=mode, kv_quant="none",
                               num_layers=layers or cfg.num_layers)


def dist_kernel_rows(torch, timer, m, dev="cuda"):
    """Phase 14(a): rows 1-3 at a rank's shard shapes of h2o-danube-1.8b
    under TP 2 at ``m`` rows a microbatch (wq 2560 -> 1280, wk/wv 2560 ->
    320, wo 1280 -> 2560 and down 3456 -> 2560 row-parallel, the MLP's
    up/gate 2560 -> 3456)."""
    tp = DIST_SHAPE["model"]
    return layer_kernel_rows(
        torch, timer, [(m, D, HD // tp), (m, D, KVD // tp),
                       (m, D, KVD // tp), (m, HD // tp, D),
                       (m, FF // tp, D)], (m, D, FF // tp),
        "14(a)", f"a TP-{tp} rank's", "mesh train", dev=dev)


def layer_kernel_rows(torch, timer, shapes, mlp, tag, what, label,
                      plain_iters=3, dev="cuda"):
    """absmax and the fused matmul bitwise, and the silu MLP within 1e-5,
    of their plain versions at one layer's (M, K, N) matmul ``shapes`` and
    MLP (M, K, N) ``mlp``, each timed (phase 2's timer) beside its bound
    over the layer's calls (the plain versions ``plain_iters`` times; at
    one, warmed by the check alone)."""
    from repro_torch.kernels import fused as kf
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    def nbytes(t):
        return t.numel() * t.element_size()

    xs = {(mm, k): randn(mm, k) for mm, k, _ in shapes}
    ws = {(k, n): randn(k, n, std=k ** -0.5).to(torch.bfloat16)
          for _, k, n in shapes}
    for t in list(xs.values()) + list(ws.values()):
        if not torch.equal(kf.absmax(t, TINY), ref.absmax_ref(t, TINY)):
            fail(f"phase {tag}: absmax differs at {tuple(t.shape)}")
    sc = {id(t): kf.absmax(t, TINY)
          for t in list(xs.values()) + list(ws.values())}
    args = [(xs[(mm, k)], ws[(k, n)], sc[id(xs[(mm, k)])],
             sc[id(ws[(k, n)])]) for mm, k, n in shapes]
    for shp, a in zip(shapes, args):
        got, want = kf.fused_bp_matmul(*a), ref.fused_matmul_ref(*a)
        if not torch.equal(got, want):
            fail(f"phase {tag}: fused matmul differs at {shp}: max "
                 f"{(got - want).abs().max().item()}")
        del got, want
    m, k, n = mlp
    x = randn(m, k)
    up, gate = (randn(k, n, std=k ** -0.5).to(torch.bfloat16)
                for _ in range(2))
    margs = (x, up, gate) + tuple(kf.absmax(t, TINY) for t in (x, up, gate))
    got = kf.fused_mlp(*margs, "silu")
    want = ref.fused_mlp_ref(x, up, gate, "silu", *margs[3:])
    e = ((got - want).abs().max() / want.abs().max().clamp_min(1.0)).item()
    mlp_err = (got - want).abs().max().item()
    del got, want
    if not math.isfinite(e) or e > 1e-5:
        fail(f"phase {tag}: fused MLP off by {e:.3g} at M {m}")
    am_in = [a[0] for a in args] + [a[1] for a in args] + [x, up, gate]
    rows = {
        "absmax": dict(
            max_abs_err=0.0,
            ms=timer([lambda t=t: kf.absmax(t, TINY) for t in am_in]),
            plain_ms=timer([lambda t=t: ref.absmax_ref(t, TINY)
                            for t in am_in]),
            library_ms=timer([lambda t=t: torch.amax(t.abs())
                              for t in am_in]),
            b=[bound(nbytes(t) + 4, t.numel(), H100_F32_FLOPS_PER_S)
               for t in am_in]),
        "fused_matmul": dict(
            max_abs_err=0.0,
            ms=timer([lambda a=a: kf.fused_bp_matmul(*a) for a in args]),
            plain_ms=timer([lambda a=a: ref.fused_matmul_ref(*a)
                            for a in args], iters=plain_iters,
                           warm=plain_iters > 1),
            library_ms=None,
            b=[bound(4 * mm * kk + 2 * kk * nn + 8 + 4 * mm * nn,
                     2 * mm * nn * 8 * kk, H100_INT8_OPS_PER_S)
               for mm, kk, nn in shapes]),
        "fused_mlp": dict(
            max_abs_err=mlp_err,
            ms=timer([lambda: kf.fused_mlp(*margs, "silu")]),
            plain_ms=timer([lambda: ref.fused_mlp_ref(
                x, up, gate, "silu", *margs[3:])], iters=plain_iters,
                warm=plain_iters > 1),
            library_ms=None,
            b=[bound(4 * m * k + nbytes(up) + nbytes(gate) + 12
                     + 4 * m * n, 2 * 2 * m * n * 8 * k,
                     H100_INT8_OPS_PER_S)])}
    print(f"phase {tag}: absmax and the fused matmul bitwise at {what} "
          f"(M, K, N) {shapes}, the silu MLP {k} -> {n} within 1e-5 "
          f"({e:.3g})")
    for name, r in rows.items():
        print(f"{label} kernel {name} ({what} layer at M {m}): ms "
              f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
              f"{r['library_ms']} bound_ms {sum(x[0] for x in r['b']):.4f} "
              f"max_abs_err {r['max_abs_err']}")
    return rows


# -- the ranks' side (a spawned process each; nothing here runs at import) --

def _bits_digest(torch, t) -> tuple:
    """Two int64 sums over a tensor's bits (as stored): equal digests of
    equal-shaped tensors mean equal bits but for a vanishing chance."""
    width = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    flat = t.detach().contiguous().reshape(-1)
    bits = flat.view(width[flat.element_size()]) if flat.is_floating_point() \
        else flat
    s1 = s2 = 0
    step = 1 << 26
    for lo in range(0, bits.numel(), step):
        v = bits[lo:lo + step].to(torch.int64)
        w = torch.arange(lo, lo + v.numel(), device=v.device) % 65521 + 1
        s1 += int(v.sum())
        s2 += int((v * w).sum())
    return (tuple(t.shape), s1, s2)


def _rank_batch(torch, cfg, seq, batch, step=0, dev="cpu"):
    from repro_torch.data.pipeline import DataConfig, batch_at
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch)
    return {k: torch.from_numpy(v).to(dev)
            for k, v in batch_at(dcfg, step).items()}


def _piece_places(model, mesh_shape, coords):
    """Per leaf of ``model``'s params, the (dim, lo, hi) cuts of the piece
    the rank at ``coords`` holds on a mesh of ``mesh_shape``, the number
    of ranks holding the same piece, and whether this rank is the first
    of them (at index 0 on every axis that does not split the leaf)."""
    from repro_torch.dist.sharding import _cut
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.train_step import param_placements
    sizes = dict(mesh_shape)
    out = {}
    for (path, d), (_, pl) in zip(
            tree_leaves(model.schema()),
            tree_leaves(param_placements(model, _Shape(mesh_shape)))):
        cuts, split, used = [], 1, set()
        for dim, entry in enumerate(pl):
            axes = [a for a in ((entry,) if isinstance(entry, str)
                                else (entry or ())) if sizes.get(a, 1) > 1]
            if axes:
                i = 0
                for a in axes:
                    i = i * sizes[a] + coords[a]
                n = math.prod(sizes[a] for a in axes)
                cuts.append((dim,) + _cut(d.shape[dim], n, i))
                split *= n
                used.update(axes)
        first = all(coords[a] == 0 for a in sizes if a not in used)
        out["/".join(path)] = (cuts, math.prod(sizes.values()) // split,
                               first)
    return out


def _cut_piece(t, cuts):
    for dim, lo, hi in cuts:
        t = t.narrow(dim, lo, hi - lo)
    return t


def _case_vs_single(torch, build, mesh, dev, case):
    """A (b) case against the single-process step: the mesh's step in each
    schedule, with the weights in f32 and as held (bf16), from one seeded
    init.  Every member rank also runs the single-process step (2 layers:
    cheap) and holds its pieces of the mesh's gradients to the same cuts
    of the single-process ones; the per-leaf sums are reduced over the
    mesh (each piece counted once), so nothing whole is gathered."""
    from repro_torch.dist import sharding as shd
    from repro_torch.models import build as build_model
    from repro_torch.models.params import init_params, tree_leaves, tree_map
    from repro_torch.train.train_step import param_placements
    cfg = dist_config("h2o_danube_1p8b", case["mode"], case["layers"])
    model = build_model(cfg)
    batch = _rank_batch(torch, cfg, DIST_CHECK_SEQ, DIST_CHECK_BATCH,
                        dev=dev)
    whole = init_params(model.schema(), seed=0, device=dev)
    places = _piece_places(model, mesh.shape, mesh.coords)
    pls = param_placements(model, mesh)
    out = {}
    for f32 in (True, False):
        src = tree_map(lambda t: t.float() if f32 else t, whole)
        live = tree_map(lambda t: t.clone().requires_grad_(), src)
        flat = tree_leaves(live)
        wl, _ = model.loss(live, batch)
        want = dict(zip(("/".join(p) for p, _ in flat), torch.autograd.grad(
            wl, [t for _, t in flat])))
        del live, flat
        for sched in case.get("schedules", ("1f1b",)):
            mine = tree_map(lambda t, pl: shd.local_shard(t, pl, mesh)
                            .clone().requires_grad_(), src, pls)
            gl, _, grads = model.pipeline_loss(
                mine, batch, mesh=mesh, num_microbatches=case.get("M", 1),
                schedule=sched)
            sums = torch.zeros((len(want), 3), dtype=torch.float64,
                               device=dev)
            diff = torch.zeros((len(want), 2), dtype=torch.float64,
                               device=dev)
            for i, (path, g) in enumerate(tree_leaves(grads)):
                key = "/".join(path)
                cuts, reps, _ = places[key]
                w = _cut_piece(want[key], cuts).double()
                g = g.double()
                sums[i] = torch.stack([(g * w).sum(), (g * g).sum(),
                                       (w * w).sum()]) / reps
                diff[i] = torch.stack([(g - w).abs().max(), w.abs().max()])
            mesh.all_reduce(sums, mesh.axis_names)
            mesh.all_reduce(diff, mesh.axis_names, "max")
            cos = sums[:, 0] / (sums[:, 1].sqrt() * sums[:, 2].sqrt())
            worst = diff[:, 0] / diff[:, 1].clamp_min(1e-300)
            gl, wl_ = float(gl), float(wl.detach())
            rel = abs(gl - wl_) / abs(wl_)
            least, top = float(cos.min()), float(worst.max())
            # bf16 weights: a backward in another order rounds bf16
            # gradients apart (cosines 0.99993-0.99999 on the card)
            ok = (rel <= 1e-5 and top <= 1e-4) if f32 else \
                (rel <= 1e-4 and least > 0.9999)
            out[f"{sched}, {'f32' if f32 else 'bf16'} weights"] = {
                "loss": gl, "loss_single": wl_, "loss_rel": rel,
                "least_cosine": least, "worst_of_max": top, "ok": ok,
                "rule": ("loss 1e-5 relative, every leaf within 1e-4 of "
                         "its largest" if f32 else "loss 1e-4 relative, "
                         "every leaf's cosine > 0.9999")}
            del mine, grads
        del want
        gc.collect()
    return out


def _case_step_pair(torch, mesh, dev, case, twin: bool, pending: list):
    """One ``make_train_step(mesh=)`` step of a (b) whole-step case from
    the CPU's seeded state, on the card's mesh and on its twin on the CPU
    (ranks 0-3 and 4-7: the rank at a position on one holds the same
    pieces as its twin on the other).  A card rank sends each piece it is
    the first holder of (the new params and first moments) to its twin,
    which returns ``leaf_stats`` of them against its own, from the old
    params: no whole leaf leaves a rank.  The twin posts its receives
    before its step, and the card's sends go into ``pending`` (waited at
    the end of the world), so the card goes on while its twin computes."""
    import torch.distributed as tdist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build as build_model
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.optim.optimizer import OptimizerConfig
    from repro_torch.train.train_step import (TrainPlan, init_state,
                                              make_train_step)
    cfg = dist_config(case["arch"], "bp8_fused", DIST_LAYERS)
    model = build_model(cfg)
    opt = OptimizerConfig(learning_rate=3e-4, warmup_steps=1,
                          total_steps=1)
    plan = TrainPlan.for_shape(
        cfg, ShapeConfig("t", "train", DIST_CHECK_SEQ, DIST_CHECK_BATCH),
        data_shards=1, pipeline_stages=mesh.shape["stage"])
    state = init_state(model, 0, opt, "cpu", mesh=mesh)
    places = _piece_places(model, mesh.shape, mesh.coords)
    old = {"/".join(p): t.clone() for p, t in tree_leaves(state["params"])
           if places["/".join(p)][2]}
    n = len(mesh.ranks)
    recvs = []
    if twin:      # the card's pieces: the params' dtypes, f32 moments
        for which in ("params", "m"):
            for key, t in old.items():
                buf = torch.empty(t.shape, dtype=t.dtype if which ==
                                  "params" else opt.moment_dtype)
                recvs.append((which, key, buf,
                              tdist.irecv(buf, mesh.rank - n, tag=7)))
    state = tree_map(lambda t: t.to(dev), state)
    step = make_train_step(model, opt, plan, mesh=mesh)
    t0 = time.perf_counter()
    new, m = step(state, _rank_batch(torch, cfg, DIST_CHECK_SEQ,
                                     DIST_CHECK_BATCH, dev=dev))
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "step_s": time.perf_counter() - t0,
           "plan": dataclasses.asdict(plan)}
    mine = {(which, "/".join(p)): t
            for which, tree in (("params", new["params"]),
                                ("m", new["opt"]["m"]))
            for p, t in tree_leaves(tree) if places["/".join(p)][2]}
    if not twin:                         # to the twin on the CPU
        for which in ("params", "m"):
            for key in old:
                buf = mine[which, key].detach().cpu().contiguous()
                pending.append((buf, tdist.isend(buf, mesh.rank + n, tag=7)))
        return out
    stats = {}
    for which, key, g, work in recvs:
        work.wait()
        stats[f"{which}/{key}"] = leaf_stats(
            torch, which, g, mine[which, key],
            old[key] if which == "params" else None)
    return out | {"stats": stats}


def _case_full(torch, build, mesh, dev, ckpt_dir, quiet):
    """Phase 14(c) on one rank: h2o-danube-1.8b at full width and
    ``DIST_FULL_LAYERS`` layers in ``bp8_fused`` through
    ``trainer.train(mesh=)``, ``DIST_STEPS`` steps of 8 x 128 tokens at
    lr 3e-5 with ``TrainPlan.for_shape``'s microbatches and bf16 moments
    (the checkpoint of the whole 24-layer state was 10.8 GB, not 18),
    a checkpoint at the end; launches counted from just before to just
    after, the peak, the transport and its seconds, the stages' times,
    the pieces' digests (the checkpoint's proof) and whether each of this
    rank's pieces moved.  ``quiet()`` is called after the last step, before
    the checkpoint: the steps run on a quiet host, the twins' CPU steps
    after them."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build as build_model
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.obs import Observability
    from repro_torch.train.train_step import (TrainPlan, init_state,
                                              make_train_step)
    from repro_torch.train.trainer import TrainerConfig, train
    cfg = dist_config("h2o_danube_1p8b", layers=DIST_FULL_LAYERS)
    model = build_model(cfg)
    shape = ShapeConfig("train", "train", DIST_SEQ, DIST_BATCH)
    opt = dist_full_opt()
    plan = TrainPlan.for_shape(cfg, shape, data_shards=1,
                               pipeline_stages=mesh.shape["stage"])
    inner = make_train_step(model, opt, plan, mesh=mesh)
    norms, stage_times = [], []

    def step_fn(state, batch):
        new, m = inner(state, batch)
        norms.append(float(m["grad_norm"]))
        stage_times.extend(dataclasses.asdict(t) for t in m["stage_times"])
        if len(norms) == DIST_STEPS:
            quiet()
        return new, m

    state = init_state(model, 0, opt, dev, mesh=mesh)
    init = tree_map(lambda t: t.cpu(), state["params"])
    gc.collect()
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    mesh.reset_stats()
    build.reset_launches()
    obs = Observability.make()
    t0 = time.perf_counter()
    # one checkpoint, the final one (a save every DIST_STEPS would write
    # the last step twice)
    state, hist = train(model, cfg, shape, TrainerConfig(
        total_steps=DIST_STEPS, ckpt_every=DIST_STEPS + 1,
        ckpt_dir=ckpt_dir, ckpt_async=False, ckpt_compress_opt=False),
        opt_cfg=opt, step_fn=step_fn, state=state, mesh=mesh, obs=obs,
        device=dev)
    wall = time.perf_counter() - t0
    ckpt_s = {r["name"]: r["sum"] for r in obs.registry.snapshot()
              if r["name"] in ("ckpt.snapshot_s", "ckpt.write_s")}
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    moved = {"/".join(p): float((a != b.cpu()).float().mean())
             for (p, a), (_, b) in zip(tree_leaves(init),
                                       tree_leaves(state["params"]))}
    stats = {f"{op} ({tr})": {"calls": s.calls, "s": s.seconds,
                             "bytes": s.bytes}
             for (op, tr), s in mesh.stats.items()}
    digests = {"/".join(p): _bits_digest(torch, t)
               for p, t in tree_leaves(state)}
    return {"losses": [h["loss"] for h in hist],
            "step_s": [h["dt"] for h in hist], "wall_s": wall,
            "grad_norms": norms, "stage_times": stage_times,
            "layers_per_stage": cfg.num_layers // mesh.shape["stage"],
            "launches": launches, "ckpt_s": ckpt_s,
            "peak_gb": peak, "transport": stats, "moved": moved,
            "digests": digests, "coords": mesh.coords}


def dist_full_opt():
    """(c)'s optimizer: lr 3e-5, warmup over its steps, bf16 moments."""
    import torch
    from repro_torch.optim.optimizer import OptimizerConfig
    return OptimizerConfig(learning_rate=3e-5, warmup_steps=DIST_STEPS,
                           total_steps=DIST_STEPS + 1,
                           moment_dtype=torch.bfloat16)


def dist_rank(dev, cases, ckpt_dir):
    """One rank of phase 14's world (ranks 0-3 on the card, 4-7 on the
    CPU): every case in order, each on the meshes over its rank sets
    (built by every rank; the 2-rank cases on {0, 1} and {2, 3} at once,
    a whole-step case on 0-3 and 4-7 at once).  (d)-(f) and then (c) come
    first, and run on a quiet host: the twins wait at a barrier over all
    8 ranks that the card's ranks reach at the end of (d)-(f), and at
    another after (c)'s last step, and through (g)-(h) likewise.  Returns
    this rank's results."""
    import torch
    import torch.distributed as tdist
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import Mesh
    res, pending = {}, []
    # every mesh first: making one is collective, and a card rank must not
    # wait there for a twin still in an earlier case's CPU step
    built = [[Mesh(case["mesh"], device=dev, ranks=r) for r in case["ranks"]]
             for _, case in cases]
    for (name, case), meshes in zip(cases, built):
        t0 = time.perf_counter()
        side = next((i for i, m in enumerate(meshes) if m.member), None)
        if side is None:
            if case["kind"] in ("full", "ring", "serve_tp"):
                # a twin waits them out
                tdist.barrier()
                res[name] = {"result": None, "s": time.perf_counter() - t0,
                             "lead": False, "transport": []}
            continue
        mesh = meshes[side]
        if case["kind"] == "vs_single":
            res[name] = _case_vs_single(torch, build, mesh, dev, case)
        elif case["kind"] == "step_pair":
            res[name] = _case_step_pair(torch, mesh, dev, case, side == 1,
                                        pending)
        elif case["kind"] == "ring":
            res[name] = _case_ring(torch, build, mesh, dev, tdist.barrier)
        elif case["kind"] == "serve_tp":
            res[name] = _case_serve_tp(torch, build, mesh, dev,
                                       tdist.barrier, case["case"])
        else:
            res[name] = _case_full(torch, build, mesh, dev, ckpt_dir,
                                   tdist.barrier)
        res[name] = {"result": res[name], "s": time.perf_counter() - t0,
                     "lead": mesh.position == 0,
                     "transport": sorted({tr for _, tr in mesh.stats})}
        gc.collect()
        if dev != "cpu":
            torch.cuda.empty_cache()
    for _, work in pending:     # the card's pieces, received by the twins
        work.wait()
    return res


# -- the parent's side -------------------------------------------------------

CARD, TWINS = (0, 1, 2, 3), (4, 5, 6, 7)


def _world_cases():
    """(d)-(h), (c), then (b), with the rank sets of their meshes: the
    twins wait at a barrier through (d)-(h) and (c)'s steps, and run
    their CPU steps beside (c)'s checkpoint and the card's (b) cases."""
    pipe = {"kind": "vs_single", "mode": "bf16", "layers": DIST_LAYERS,
            "M": 2, "schedules": ("gpipe", "1f1b")}
    free = {"kind": "vs_single", "mode": "bp8_fused", "layers": DIST_LAYERS}
    return [
        ("ring", {"kind": "ring", "mesh": RING_SHAPE, "ranks": [CARD]}),
    ] + [(f"serve_tp_{k}", {"kind": "serve_tp", "case": k,
                            "mesh": c["mesh"], "ranks": [CARD]})
         for k, c in TP_CASES.items()] + [
        ("full", {"kind": "full", "mesh": DIST_SHAPE, "ranks": [CARD]}),
        ("stage2", {**pipe, "mesh": {"stage": 2}, "ranks": [(0, 1)]}),
        ("data2", {**free, "mesh": {"data": 2}, "ranks": [(2, 3)]}),
        ("model2", {**free, "mesh": {"data": 1, "model": 2},
                    "ranks": [(0, 1)]}),
        ("stage2_model2", {**pipe, "layers": DIST_STAGE_TP_LAYERS,
                           "mesh": DIST_SHAPE, "schedules": ("1f1b",),
                           "ranks": [CARD]}),
    ] + [(f"step_{a}", {"kind": "step_pair", "arch": a, "mesh": DIST_SHAPE,
                        "ranks": [CARD, TWINS]}) for a in DIST_CPU_CASES]


def _step_vs_cpu(torch, arch, card, twins):
    """(b)'s whole-step rules (``step_faults``) on a case's twin ranks'
    ``leaf_stats``, merged over the pieces."""
    cfg = dist_config(arch, "bp8_fused", DIST_LAYERS)
    stats = {}
    for r in twins:
        for key, st in r["stats"].items():
            stats[key] = merge_stats(stats[key], st) if key in stats else st
    lead_card, lead_cpu = card[0], twins[0]
    out = {"loss_card": lead_card["loss"], "loss_cpu": lead_cpu["loss"],
           "grad_norm_card": lead_card["grad_norm"],
           "grad_norm_cpu": lead_cpu["grad_norm"],
           "cpu_step_s": lead_cpu["step_s"],
           "card_step_s": lead_card["step_s"], "plan": lead_card["plan"],
           "leaves": {}}
    # the loss within 1e-3, or 1e-5 of it (the tied std-1 embeddings of
    # granite-moe and minicpm3 give losses of hundreds at full width)
    faults = step_faults(torch, out, dict(sorted(stats.items())),
                         "the card's mesh", "the same mesh on the CPU",
                         f"{cfg.name}, {DIST_LAYERS} layers, (stage 2, "
                         f"model 2)", max(1e-3, 1e-5 * abs(lead_cpu["loss"])))
    if faults:
        fail(f"phase 14(b) {arch}: " + "; ".join(faults))
    return {k: v for k, v in out.items() if k != "leaves"} | {
        "least_cosine": min(v["cosine"] for v in out["leaves"].values()
                            if v.get("cosine") is not None)}


def phase_dist(torch, timer, build):
    """Phase 14: the distributed layer.  (a) the kernels at a rank's shard
    shapes; (b) the mesh steps at full width and 2 layers (4 for the
    stage x TP case) against the single-process card step and, on (stage
    2, model 2) in ``bp8_fused``, against the same mesh on 4 gloo CPU
    ranks; (c) h2o-danube-1.8b (8 layers) on (stage 2, model 2), its
    checkpoint restored bitwise and resumed in this process without a
    mesh; (d)-(f) sequence parallelism on the 4 card ranks as one (seq 4)
    ring: the ring core bitwise its oracles, qwen2-72b (2 layers) and
    minicpm3-4b served under the ring against the same calls in one
    process, and a long_500k decode step, then rows 1-3 timed at a ring
    rank's prefill shapes; (g)-(h) tensor-parallel serving on the same 4
    card ranks: qwen2-72b (4 layers) on (data 1, model 4) and paligemma-3b
    on (data 2, model 2) against the same calls in one process, then rows
    1-4 timed at a TP rank's shapes.  The card's ranks are 4 processes
    on cuda:0 over gloo, started here with their 4 twins on the CPU;
    (d)-(h) and (c)'s steps run first, while the twins wait at barriers,
    so that no
    CPU step of a twin loads the host under them (the ring's first work
    takes the ranks' cold start).  Returns the kernel rows
    and launches of (c), of (e) and of (g)-(h) (summed over the ranks),
    and a report."""
    import shutil
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import launch_ranks
    from repro_torch.train.train_step import TrainPlan
    report = {}
    plan = TrainPlan.for_shape(
        dist_config("h2o_danube_1p8b", layers=DIST_FULL_LAYERS),
        ShapeConfig("t", "train", DIST_SEQ, DIST_BATCH), data_shards=1,
        pipeline_stages=DIST_SHAPE["stage"])
    m = DIST_SEQ * DIST_BATCH // plan.pipeline_microbatches
    t0 = time.perf_counter()
    rows = dist_kernel_rows(torch, timer, m)
    report["a_s"] = time.perf_counter() - t0
    print(f"phase 14(a) kernels at a rank's shard shapes: "
          f"{report['a_s']:.1f}s")

    ckpt_dir = ROOT / "build" / "phase14_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    report["parent_gb"] = {"allocated": torch.cuda.memory_allocated() / 1e9,
                           "reserved": torch.cuda.memory_reserved() / 1e9}
    print(f"phase 14: this process holds {report['parent_gb']['allocated']:.2f}"
          f" GB allocated, {report['parent_gb']['reserved']:.2f} GB reserved "
          "on the card as its ranks start")
    t1 = time.perf_counter()
    tm = {}
    ranks = launch_ranks(dist_rank, len(CARD + TWINS), _world_cases(),
                         str(ckpt_dir), device=["cuda"] * len(CARD)
                         + ["cpu"] * len(TWINS), timeout=DIST_TIMEOUT,
                         threads=[1] * len(CARD) + [2] * len(TWINS),
                         timings=tm)
    card, twins = ranks[:len(CARD)], ranks[len(CARD):]
    report["world_s"] = time.perf_counter() - t1
    report["case_s"] = {"card": {k: v["s"] for k, v in card[0].items()},
                        "twin": {k: v["s"] for k, v in twins[0].items()}}
    print(f"phase 14 world (4 card ranks and their 4 CPU twins): "
          f"{report['world_s']:.1f}s; per case on the card's rank 0: "
          + ", ".join(f"{k} {v['s']:.1f}s" for k, v in card[0].items())
          + "; on its twin: " + ", ".join(
              f"{k} {v['s']:.1f}s" for k, v in twins[0].items()))
    b = tm["began"]
    span = {k: (min(r[k] for r in tm["ranks"]) - b,
                max(r[k] for r in tm["ranks"]) - b)
            for k in ("started", "ready", "done", "arrived")}
    report["world_timeline"] = span | {"joined": tm["joined"] - b}
    print("phase 14 world's timeline (s from the launch, first and last "
          "rank): " + ", ".join(f"{k} {a:.1f}-{z:.1f}"
                                for k, (a, z) in span.items())
          + f", joined {tm['joined'] - b:.1f}")
    transports = sorted({t for r in ranks for v in r.values()
                         for t in v["transport"]})
    print(f"phase 14 transports: {transports} (backend gloo: the 4 card "
          f"ranks share one card; CUDA tensors through pinned host copies)")
    report["transports"] = transports

    # (b) against the single-process card step
    cases = _world_cases()
    held = {name: r[name]["result"] for name, c in cases
            if c["kind"] == "vs_single" for r in card
            if name in r and r[name]["lead"]}
    for name, res in held.items():
        for run, h in res.items():
            print(f"phase 14(b) {name} ({run}) vs the single-process card "
                  f"step: loss {h['loss']:.6f} vs {h['loss_single']:.6f} "
                  f"({h['loss_rel']:.3g} relative), least cosine "
                  f"{h['least_cosine']:.7f}, largest difference "
                  f"{h['worst_of_max']:.3g} of a leaf's largest "
                  f"({h['rule']}): {'held' if h['ok'] else 'PAST'}")
            if not h["ok"]:
                fail(f"phase 14(b) {name} ({run}): {h}")
    if len(held) != 4:
        fail(f"phase 14(b): {sorted(held)} held, not the 4 cases")
    report["vs_single"] = held
    # (b) against the same mesh on the CPU
    report["vs_cpu"] = {
        c["arch"]: _step_vs_cpu(torch, c["arch"],
                                [r[name]["result"] for r in card],
                                [r[name]["result"] for r in twins])
        for name, c in cases if c["kind"] == "step_pair"}
    report["b_reduced"] = DIST_REDUCED

    # (d)-(f)
    ring_launches, report["ring"] = ring_report(
        [r["ring"]["result"] for r in card])
    # (g)-(h)
    tp_launches, report["serve_tp"] = tp_report(torch, [
        {k: v["result"] for k, v in r.items() if k.startswith("serve_tp_")}
        for r in card])
    # (c)
    full = [r["full"]["result"] for r in card]
    del card
    gc.collect()
    launches, report["c"] = dist_full_report(torch, full, plan)
    t2 = time.perf_counter()
    report["c"]["restore"] = dist_restore(torch, full, ckpt_dir)
    report["c_restore_s"] = time.perf_counter() - t2
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    ring_rows = ring_kernel_rows(torch, timer)
    report["ring_rows_s"] = time.perf_counter() - t3
    t4 = time.perf_counter()
    tp_rows = tp_kernel_rows(torch, timer)
    report["tp_rows_s"] = time.perf_counter() - t4
    report["serve_tp"]["rows_h"] = {k: {x: y for x, y in r.items()
                                        if x != "b"}
                                    | {"bound_ms": sum(b[0] for b in r["b"])}
                                    for k, r in tp_rows["h"].items()}
    return (rows, launches, ring_rows, ring_launches, tp_rows["g"],
            tp_launches, report)


def dist_full_report(torch, full, plan):
    """(c)'s checks and numbers over the 4 ranks' results."""
    per_step = (full[0]["layers_per_stage"] * plan.pipeline_microbatches
                * 2 * DIST_STEPS)
    want = {"absmax": 13 * per_step, "fused_matmul": 5 * per_step,
            "fused_mlp": per_step}
    launches = {k: 0 for k in want}
    for r in full:
        got = {k: r["launches"].get(k, 0) for k in want}
        if got != want:
            fail(f"phase 14(c): rank {r['coords']} launched {got}, expected "
                 f"{want} (13 absmax, 5 matmuls, 1 MLP a layer of its "
                 f"{r['layers_per_stage']}, each of "
                 f"{plan.pipeline_microbatches} microbatches forward and "
                 f"recomputed)")
        for k in want:
            launches[k] += got[k]
    lead = full[0]
    norms, losses = lead["grad_norms"], lead["losses"]
    if len(norms) != DIST_STEPS or not all(math.isfinite(g) and g > 0
                                           for g in norms):
        fail(f"phase 14(c): gradient norms {norms}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"phase 14(c): losses {losses}")
    still = [(r["coords"], k) for r in full for k, v in r["moved"].items()
             if v == 0]
    if still:
        fail(f"phase 14(c): pieces that did not move: {still}")
    steps = [max(r["step_s"][i] for r in full) for i in range(DIST_STEPS)]
    med = sorted(steps[1:])[len(steps[1:]) // 2]
    tokens = DIST_SEQ * DIST_BATCH
    peaks = [r["peak_gb"] for r in full]
    waits = []
    for r in full:
        w = sum(v["s"] for k, v in r["transport"].items()
                if k.split(" ")[0] in ("send", "send_wait", "recv",
                                       "all_reduce_sum", "all_reduce_max"))
        waits.append(w / sum(r["step_s"]))
    idle = [sum(t["total_s"] - t["forward_s"] - t["backward_s"]
                for t in r["stage_times"]) / sum(t["total_s"]
                                                 for t in r["stage_times"])
            for r in full]
    print(f"phase 14(c): h2o-danube-1.8b ({DIST_FULL_LAYERS} of its 24 "
          f"layers, d_model 2560), "
          f"bp8_fused, on {DIST_SHAPE} (4 gloo ranks on one card), "
          f"{DIST_STEPS} steps of {DIST_BATCH} x {DIST_SEQ} tokens in "
          f"{plan.pipeline_microbatches} microbatches; step times "
          + ", ".join(f"{x:.3f}" for x in steps)
          + f" s (slowest rank; median past the first {med:.3f} s = "
          f"{tokens / med:.1f} training tokens/s); losses "
          + ", ".join(f"{x:.4f}" for x in losses) + "; gradient norms "
          + ", ".join(f"{g:.4f}" for g in norms) + "; peak device memory "
          "by rank " + ", ".join(f"{p:.2f}" for p in peaks)
          + f" GB, sum {sum(peaks):.2f} GB (one process, phase 8: 51.15 GB, "
          f"f32 moments); share of the steps waiting in sends, receives "
          "and all-reduces by rank " + ", ".join(f"{w:.3f}" for w in waits)
          + "; a stage's idle share of its flushes by rank "
          + ", ".join(f"{x:.3f}" for x in idle)
          + f" (plan's bubble {plan.bubble:.3f}); launches (all ranks) "
          f"{launches}")
    print(f"phase 14(c): each rank's train() {[round(r['wall_s'], 1) for r in full]}"
          f" s, of it the steps {[round(sum(r['step_s']), 1) for r in full]}"
          f" s; the checkpoint's snapshot and write on rank 0 "
          f"{full[0]['ckpt_s']}")
    for r in full:
        print(f"  rank {r['coords']}: transport "
              + ", ".join(f"{k} {v['calls']} calls {v['s']:.3f}s "
                          f"{v['bytes'] / 1e9:.3f} GB"
                          for k, v in sorted(r["transport"].items())))
    return launches, {
        "mesh": DIST_SHAPE, "steps": DIST_STEPS, "step_s": steps,
        "median_step_s": med, "tokens_per_s": tokens / med,
        "losses": losses, "grad_norms": norms, "peak_gb": peaks,
        "peak_sum_gb": sum(peaks), "wait_share": waits,
        "idle_share": idle, "bubble_plan": plan.bubble,
        "microbatches": plan.pipeline_microbatches, "launches": launches,
        "wall_s": [r["wall_s"] for r in full],
        "transport": [r["transport"] for r in full]}


def dist_restore(torch, full, ckpt_dir, dev="cuda"):
    """(c)'s checkpoint in this process without a mesh: restored, each
    rank's pieces cut from it against the digests the ranks took of
    theirs (bitwise), then ``train()`` continuing from the restored state
    for one more step (it writes no second checkpoint)."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build as build_model
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.train.trainer import TrainerConfig, train
    cfg = dist_config("h2o_danube_1p8b", layers=DIST_FULL_LAYERS)
    model = build_model(cfg)
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    step = ckpt.latest_step(str(ckpt_dir))
    if step != DIST_STEPS:
        fail(f"phase 14(c): the mesh's checkpoint is of step {step}")
    # the restore checks the tree's structure only: placeholders will do
    zeros = tree_map(lambda d: 0, model.schema())
    like = {"state": {"params": zeros, "opt": {"m": zeros, "v": zeros,
                                               "step": 0}},
            "extra": {"data": 0, "rng": 0}}
    t0 = time.perf_counter()
    payload = ckpt.restore(str(ckpt_dir), step, like)
    state = payload["state"]
    read_s = time.perf_counter() - t0
    geom = payload["extra"]["data"].tolist()
    if geom != [0, DIST_STEPS, DIST_BATCH, DIST_SEQ]:
        fail(f"phase 14(c): the checkpoint's data geometry {geom}")
    bad, seen = [], {}
    for r in full:
        places = _piece_places(model, DIST_SHAPE, r["coords"])
        for path, t in tree_leaves(state):
            key = "/".join(path)
            leaf = path[1:] if path[0] == "params" else path[2:]
            cuts = places["/".join(leaf)][0] if leaf else []
            if (key, tuple(cuts)) not in seen:
                seen[(key, tuple(cuts))] = _bits_digest(
                    torch, _cut_piece(t, cuts).to(dev))
            if seen[(key, tuple(cuts))] != r["digests"][key]:
                bad.append((r["coords"], key))
    if bad:
        fail(f"phase 14(c): restored pieces differ from the ranks': {bad}")
    state = tree_map(lambda t: t.to(dev), state)
    t1 = time.perf_counter()
    _, hist = train(model, cfg, ShapeConfig("train", "train", DIST_SEQ,
                                            DIST_BATCH),
                    TrainerConfig(total_steps=DIST_STEPS + 1),
                    opt_cfg=dist_full_opt(), state=state,
                    start_step=DIST_STEPS, device=dev)
    resume_s = time.perf_counter() - t1
    if [h["step"] for h in hist] != [DIST_STEPS + 1] or not math.isfinite(
            hist[0]["loss"]):
        fail(f"phase 14(c): resuming without a mesh ran {hist}")
    print(f"phase 14(c): the mesh's checkpoint (step {step}) restored in "
          f"one process without a mesh in {read_s:.1f}s, every rank's pieces "
          f"bitwise; train() continued from it at step {hist[0]['step']}, "
          f"loss {hist[0]['loss']:.4f} ({resume_s:.1f}s)")
    return {"read_s": read_s, "resumed": hist, "resume_s": resume_s}


# ---------------------------------------------------------------------------
# phase 14(d)-(f): sequence parallelism (ring attention over "seq")
# ---------------------------------------------------------------------------

SEQ_PATH = "serve_seq_ring_bp8_fused"
#: the ring's mesh: phase 14's 4 card ranks as one ring
RING_SHAPE = {"seq": 4, "data": 1, "model": 1}
#: (e): qwen2-72b at full width and 2 of its 80 layers under a prompt of
#: decode_32k's length (8192 tokens a rank), minicpm3-4b at full width
#: and 16 of its 62 layers (whole until phase 15 came) under 8192; 16
#: greedy decode steps each
RING_QWEN_LAYERS, RING_QWEN_PROMPT = 2, 32768
RING_MINICPM_LAYERS, RING_MINICPM_PROMPT, RING_STEPS = 16, 8192, 16
#: (f): long_500k's cache, seeded: 524288 slots, positions 0..524283
LONG_SLOTS, LONG_FILLED, LONG_STEPS = 524288, 524284, 4
#: (d): the ring core's KV length at qwen2-72b's heads and minicpm3's
#: latent
RING_CORE_SKV = 8192
RING_SEED = 25
#: a greedy token may part from the single process's only where that
#: run's top-2 logit gap is under this share of the row's largest |logit|
RING_TIE = 0.01
SEQ_REDUCED = {"num_layers": "qwen2-72b 80 -> 2 in 14(e) and (f); "
                "minicpm3-4b 62 -> 16 in 14(e)"}


def seq_config(arch, layers=None, kv_quant="none"):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, matmul_mode="bp8_fused",
                               kv_quant=kv_quant,
                               num_layers=layers or cfg.num_layers)


def _cosine(torch, a, b) -> float:
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float((a @ b) / (a.norm() * b.norm()))


def _rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1.0))


def _ring_core(torch, mesh, dev):
    """14(d) on one rank: the ring core at qwen2-72b's heads (64 q, 8 kv,
    D 128) over 8192 KV slots under both schedules (the kv schedule over
    8192 queries, a block a rank; the stats schedule over one), an odd
    8191 through ``pad_kv``, and the absorbed-MLA ring at minicpm3-4b's
    latent (R 256, rope 32, 40 heads); each held bitwise to the port's
    oracle run in this process and within 1e-5 of dense attention."""
    from repro_torch.dist import seq
    from repro_torch.dist import sharding as shd
    from repro_torch.models import attention as A
    gen = torch.Generator(device=dev)
    gen.manual_seed(RING_SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    n, skv = mesh.size("seq"), RING_CORE_SKV
    q, k, v = randn(1, skv, 64, 128), randn(1, skv, 8, 128), randn(
        1, skv, 8, 128)
    pos = torch.arange(skv, device=dev)[None]
    q1, p1 = q[:, -1:], pos[:, -1:]
    out = {}

    def held(name, got, want, dense):
        mesh.reset_stats()
        out[name] = {"bitwise": bool(torch.equal(got, want)),
                     "dense_err": _rel_err(got, dense)}

    with shd.use_rules(mesh, shd.get_rules("sequence")), seq.use_ring(mesh):
        lay = seq.row_ring(1, skv)
        lo, c = lay.block(skv)
        with seq.shard_rows(skv, lay):
            got = seq.ring_attend(q[:, lo:lo + c], k[:, lo:lo + c],
                                  v[:, lo:lo + c], pos[:, lo:lo + c],
                                  pos[:, lo:lo + c], kv_local=True)
        held(f"gqa, kv schedule, {skv} queries", got,
             A.ring_reference(q, k, v, pos, pos, n_blocks=n,
                              q_blocks=n)[:, lo:lo + c],
             A.sdpa(q, k, v, pos, pos)[:, lo:lo + c])
        held("gqa, stats schedule, 1 query",
             seq.ring_attend(q1, k, v, p1, pos),
             A.ring_reference(q1, k, v, p1, pos, n_blocks=n),
             A.sdpa(q1, k, v, p1, pos))
        odd = (k[:, :skv - 1], v[:, :skv - 1], pos[:, :skv - 1])
        held(f"gqa, stats schedule, {skv - 1} slots through pad_kv",
             seq.ring_attend(q1, *odd[:2], p1, odd[2]),
             A.ring_reference(q1, *seq.pad_kv(*odd, skv)[:2], p1,
                              seq.pad_kv(*odd, skv)[2], n_blocks=n),
             A.sdpa(q1, *odd[:2], p1, odd[2]))
        qa, qr = randn(1, 1, 40, 256), randn(1, 1, 40, 32)
        ckv = randn(1, skv, 256, dtype=torch.bfloat16)
        kr = randn(1, skv, 32, dtype=torch.bfloat16)
        scale = 1.0 / math.sqrt(96.0)
        s = (torch.einsum("bqhr,bsr->bhqs", qa, ckv.float())
             + torch.einsum("bqhp,bsp->bhqs", qr, kr.float())) * scale
        dense = torch.einsum("bhqs,bsr->bqhr", torch.softmax(s, -1),
                             ckv.float())
        held("mla, stats schedule, 1 query",
             seq.ring_attend_mla(qa, qr, ckv[:, lo:lo + c], kr[:, lo:lo + c],
                                 p1, pos[:, lo:lo + c], scale=scale),
             A.ring_mla_reference(qa, qr, ckv, kr, p1, pos, n_blocks=n,
                                  scale=scale), dense)
    return out


def _transport(mesh) -> dict:
    return {f"{op} ({tr})": {"calls": st.calls, "s": st.seconds,
                             "bytes": st.bytes}
            for (op, tr), st in mesh.stats.items()}


def _comm_s(transport) -> float:
    """Seconds in the ring's sends and receives (and the row gathers and
    scale reductions of a sharded prefill)."""
    return sum(v["s"] for k, v in transport.items()
               if k.split(" ")[0] in ("send", "send_wait", "recv",
                                      "all_gather", "all_reduce_max"))


def _sync_s(torch, t0) -> float:
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _ring_serve(torch, build, mesh, dev, model, params, prompt_len):
    """14(e) on one rank: ``model`` under the ring prefills a seeded
    prompt of ``prompt_len`` tokens and takes ``RING_STEPS`` greedy
    decode steps; launches counted from just before to just after."""
    from repro_torch.dist import seq
    from repro_torch.dist import sharding as shd
    cfg = model.cfg
    gen = torch.Generator().manual_seed(RING_SEED + prompt_len)
    prompt = torch.randint(3, cfg.vocab_size, (1, prompt_len),
                           generator=gen).to(dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = {}
    with shd.use_rules(mesh, shd.get_rules("sequence")), seq.use_ring(mesh):
        torch.cuda.synchronize()
        mesh.reset_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": prompt},
                                      prompt_len + RING_STEPS)
        res["prefill_s"] = _sync_s(torch, t0)
        res["prefill_transport"] = _transport(mesh)
        first = logits.float()
        tok = logits.argmax(-1)
        toks, steps = [int(tok)], []
        mesh.reset_stats()
        for i in range(RING_STEPS):
            t1 = time.perf_counter()
            logits, cache = model.decode_step(params, tok[:, None], cache,
                                              prompt_len + i)
            tok = logits.argmax(-1)
            toks.append(int(tok))
            steps.append(_sync_s(torch, t1))
        res["decode_transport"] = _transport(mesh)
        res["launches"] = dict(build.LAUNCHES)
    res.update(step_s=steps, tokens=toks, cache_bytes=param_bytes(cache),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               decode_comm_share=_comm_s(res["decode_transport"])
               / sum(steps))
    return res, prompt, first


def _greedy_vs(torch, logits, token) -> dict:
    """The single process's row against the ring's greedy ``token``: its
    own choice, its top-2 gap and the near-tie threshold."""
    row = logits.float().reshape(-1)
    top = torch.topk(row, 2)
    gap = float(top.values[0] - top.values[1])
    tie = RING_TIE * float(row.abs().max())
    return {"ring": token, "single": int(top.indices[0]), "gap": gap,
            "tie_below": tie, "equal": int(top.indices[0]) == token}


def _single_serve(torch, model, params, prompt, first, ring):
    """14(e)'s single-process run (no ring) of the same calls, the decode
    steps fed the ring's tokens: the prefill logits' cosine, and each
    greedy choice against the ring's."""
    prompt_len = prompt.shape[1]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": prompt},
                                  prompt_len + RING_STEPS)
    prefill_s = _sync_s(torch, t0)
    out = {"prefill_s": prefill_s, "cosine": _cosine(torch, first, logits),
           "choices": [_greedy_vs(torch, logits, ring["tokens"][0])]}
    steps = []
    for i in range(RING_STEPS):
        tok = torch.tensor([[ring["tokens"][i]]], device=prompt.device)
        t1 = time.perf_counter()
        logits, cache = model.decode_step(params, tok, cache, prompt_len + i)
        steps.append(_sync_s(torch, t1))
        out["choices"].append(_greedy_vs(torch, logits,
                                         ring["tokens"][i + 1]))
    out.update(step_s=steps, cache_bytes=param_bytes(cache),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out


def _long_cache(torch, model, dev, blocks, n):
    """(f)'s seeded cache of blocks ``blocks`` of ``n`` (one rank's, or
    all joined for the single process): BP8 codes in [-9, 9], scales in
    [0.25, 2.25), positions 0..LONG_FILLED-1 and -1 after; each block
    drawn from its own seed, so that the ranks' blocks join to the whole."""
    c = LONG_SLOTS // n
    parts = []
    for r in blocks:
        gen = torch.Generator(device=dev)
        gen.manual_seed(RING_SEED + 100 + r)
        leaf = {}
        for key, (shape, dtype) in sorted(
                model.cache_spec(1, c)["layers"].items()):
            if key == "pos":
                p = torch.arange(r * c, (r + 1) * c, device=dev,
                                 dtype=torch.int32)
                p = torch.where(p < LONG_FILLED, p, -1)
                leaf[key] = p.expand(shape).contiguous()
            elif dtype == torch.int8:
                leaf[key] = torch.randint(-9, 10, shape, generator=gen,
                                          device=dev, dtype=torch.int8)
            else:
                leaf[key] = torch.rand(shape, generator=gen,
                                       device=dev) * 2 + 0.25
        parts.append(leaf)
    return {"layers": {k: torch.cat([p[k] for p in parts], 2)
                       for k in parts[0]}}


def _long_tokens(torch, cfg, dev):
    gen = torch.Generator().manual_seed(RING_SEED + 7)
    return torch.randint(3, cfg.vocab_size, (LONG_STEPS, 1, 1),
                         generator=gen).to(dev)


def _long_steps(torch, model, params, cache, toks):
    """(f)'s decode steps over ``cache``: each step's logits and
    seconds."""
    logits, steps = [], []
    for i in range(LONG_STEPS):
        t0 = time.perf_counter()
        lg, cache = model.decode_step(params, toks[i], cache,
                                      LONG_FILLED + i)
        steps.append(_sync_s(torch, t0))
        logits.append(lg.float())
    return logits, steps, cache


def _ring_long(torch, mesh, dev, model, params):
    """14(f) on one rank: ``LONG_STEPS`` decode steps of qwen2-72b over
    its block of long_500k's seeded cache, under the ring."""
    from repro_torch.dist import seq
    from repro_torch.dist import sharding as shd
    n, i = mesh.size("seq"), mesh.index("seq")
    gc.collect()
    torch.cuda.empty_cache()
    cache = _long_cache(torch, model, dev, [i], n)
    with shd.use_rules(mesh, shd.get_rules("sequence")), seq.use_ring(mesh):
        mesh.reset_stats()
        logits, steps, cache = _long_steps(torch, model, params, cache,
                                           _long_tokens(torch, model.cfg,
                                                        dev))
    return {"step_s": steps, "cache_bytes": param_bytes(cache),
            "comm_share": _comm_s(_transport(mesh)) / sum(steps)}, logits


def _single_long(torch, model, params, dev, ring_logits, n):
    """14(f)'s single-process steps over the whole seeded cache (through
    the fused decode attention, row 4), against the ring's logits."""
    gc.collect()
    torch.cuda.empty_cache()
    cache = _long_cache(torch, model, dev, range(n), n)
    logits, steps, cache = _long_steps(torch, model, params, cache,
                                       _long_tokens(torch, model.cfg, dev))
    return {"step_s": steps, "cache_bytes": param_bytes(cache),
            "cosines": [_cosine(torch, a, b)
                        for a, b in zip(ring_logits, logits)],
            "choices": [_greedy_vs(torch, b, int(a.argmax()))
                        for a, b in zip(ring_logits, logits)]}


def _case_ring(torch, build, mesh, dev, quiet):
    """Phase 14(d)-(f) on one card rank of the (seq 4) ring: the core,
    then qwen2-72b (2 layers) served under the ring and its long_500k
    steps, then minicpm3-4b (16 layers).  After each model's ring runs, ranks
    1-3 free their weights and wait while rank 0 runs the same calls in
    this one process without the ring, and compares.  ``quiet()`` (the
    barrier the CPU twins wait at) is called at the end: everything here
    runs on a quiet host."""
    import torch.distributed as tdist
    from repro_torch.models import build as build_model
    from repro_torch.models.params import init_params
    lead = mesh.index("seq") == 0
    group = mesh.group("seq")
    out = {"core": _ring_core(torch, mesh, dev)}
    for arch, layers, prompt_len, kvq in (
            ("qwen2_72b", RING_QWEN_LAYERS, RING_QWEN_PROMPT, "bp8"),
            ("minicpm3_4b", RING_MINICPM_LAYERS, RING_MINICPM_PROMPT,
             "none")):
        cfg = seq_config(arch, layers, kvq)
        model = build_model(cfg)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = init_params(model.schema(), seed=0, device=dev)
        init_s = _sync_s(torch, t0)
        ring, prompt, first = _ring_serve(torch, build, mesh, dev, model,
                                          params, prompt_len)
        ring["init_s"] = init_s
        res = {"ring": ring}
        if arch == "qwen2_72b":
            res["long_ring"], long_logits = _ring_long(torch, mesh, dev,
                                                       model, params)
        if not lead:
            del params
            gc.collect()
            torch.cuda.empty_cache()
        tdist.barrier(group=group)
        if lead:
            res["single"] = _single_serve(torch, model, params, prompt,
                                          first, ring)
            if arch == "qwen2_72b":
                res["long_single"] = _single_long(
                    torch, model, params, dev, long_logits,
                    mesh.size("seq"))
            del params
            gc.collect()
            torch.cuda.empty_cache()
        tdist.barrier(group=group)
        out[arch] = res
    quiet()
    return out


def ring_kernel_rows(torch, timer):
    """14(e)'s rows 1-3 at a ring rank's prefill shapes: qwen2-72b's
    projections (wq, wk, wv, wo, down) and gated MLP at M 8192, a rank's
    block of the 32768-token prompt."""
    m, d, kv, ff = RING_QWEN_PROMPT // RING_SHAPE["seq"], 8192, 1024, 29568
    return layer_kernel_rows(
        torch, timer, [(m, d, d), (m, d, kv), (m, d, kv), (m, d, d),
                       (m, ff, d)], (m, d, ff), "14(e)",
        "a ring rank's qwen2-72b prefill", "ring prefill", plain_iters=1)


def ring_report(ranks):
    """14(d)-(f)'s gates and numbers over the 4 card ranks' results:
    fails the script where a case is not bitwise, a cosine is at or under
    0.9999 or a greedy choice parts outside a near tie."""
    report = {"core": ranks[0]["core"]}
    for r, res in enumerate(ranks):
        for name, c in res["core"].items():
            if not c["bitwise"] or not c["dense_err"] <= 1e-5:
                fail(f"phase 14(d) rank {r} {name}: {c}")
    print("phase 14(d): the ring core bitwise its oracle on every rank, "
          "within 1e-5 of dense attention: " + "; ".join(
              f"{k} {max(r['core'][k]['dense_err'] for r in ranks):.3g}"
              for k in ranks[0]["core"]))
    launches = {}
    for arch in ("qwen2_72b", "minicpm3_4b"):
        ring = [res[arch]["ring"] for res in ranks]
        single = ranks[0][arch]["single"]
        bad = [c for c in single["choices"]
               if not c["equal"] and c["gap"] >= c["tie_below"]]
        if not single["cosine"] > 0.9999 or bad:
            fail(f"phase 14(e) {arch}: prefill cosine {single['cosine']}, "
                 f"greedy choices parting outside a near tie {bad}")
        per_rank = [{k: v for k, v in r["launches"].items()
                     if k in ("absmax", "fused_matmul", "fused_mlp")}
                    for r in ring]
        for k in ("absmax", "fused_matmul", "fused_mlp"):
            launches[k] = launches.get(k, 0) + sum(p.get(k, 0)
                                                   for p in per_rank)
        if any(p.get(k, 0) <= 0 for p in per_rank
               for k in ("absmax", "fused_matmul", "fused_mlp")):
            fail(f"phase 14(e) {arch}: a row of 1-3 never launched on a "
                 f"ring rank: {per_rank}")
        step_ring = [max(r["step_s"][i] for r in ring)
                     for i in range(RING_STEPS)]
        med = lambda xs: sorted(xs[1:])[len(xs[1:]) // 2]
        parted = sum(not c["equal"] for c in single["choices"])
        print(f"phase 14(e) {arch} ({ring[0]['init_s']:.1f}s init a rank): "
              f"prefill {max(r['prefill_s'] for r in ring):.3f}s on the "
              f"ring (slowest rank) vs {single['prefill_s']:.3f}s single; "
              f"decode step median {med(step_ring) * 1e3:.1f} ms ring vs "
              f"{med(single['step_s']) * 1e3:.1f} ms single; prefill "
              f"logits cosine {single['cosine']:.7f}; greedy tokens equal "
              f"at {len(single['choices']) - parted} of "
              f"{len(single['choices'])} (top-2 gaps "
              + ", ".join(f"{c['gap']:.4g}" for c in single["choices"])
              + "); cache bytes a rank "
              + ", ".join(str(r["cache_bytes"]) for r in ring)
              + f" vs {single['cache_bytes']} single; peak GB a rank "
              + ", ".join(f"{r['peak_gb']:.2f}" for r in ring)
              + f" vs {single['peak_gb']:.2f} single; decode share in "
              "sends and receives a rank "
              + ", ".join(f"{r['decode_comm_share']:.3f}" for r in ring)
              + "; launches of rows 1-3 a rank " + ", ".join(
                  str(p) for p in per_rank))
        report[arch] = {"ring": ring, "single": single,
                        "launches": per_rank}
    long_ring = [res["qwen2_72b"]["long_ring"] for res in ranks]
    long_single = ranks[0]["qwen2_72b"]["long_single"]
    bad = [c for c in long_single["choices"]
           if not c["equal"] and c["gap"] >= c["tie_below"]]
    if not min(long_single["cosines"]) > 0.9999 or bad:
        fail(f"phase 14(f): cosines {long_single['cosines']}, top-1 "
             f"parting outside a near tie {bad}")
    step = [max(r["step_s"][i] for r in long_ring)
            for i in range(LONG_STEPS)]
    print(f"phase 14(f) long_500k decode, qwen2-72b 2 layers over "
          f"{LONG_SLOTS} slots: step ms ring (slowest rank) "
          + ", ".join(f"{x * 1e3:.1f}" for x in step) + " vs single "
          + ", ".join(f"{x * 1e3:.1f}" for x in long_single["step_s"])
          + "; logits cosines " + ", ".join(
              f"{x:.7f}" for x in long_single["cosines"])
          + "; top-1 equal " + str([c["equal"] for c in
                                     long_single["choices"]])
          + "; cache bytes a rank " + ", ".join(
              str(r["cache_bytes"]) for r in long_ring)
          + f" vs {long_single['cache_bytes']} single; share in sends and "
          "receives a rank " + ", ".join(f"{r['comm_share']:.3f}"
                                          for r in long_ring))
    report["long_500k"] = {"ring": long_ring, "single": long_single}
    report["reduced"] = SEQ_REDUCED
    return launches, report


# ---------------------------------------------------------------------------
# phase 14(g)-(h): tensor-parallel serving on a ("data", "model") mesh
# ---------------------------------------------------------------------------

TP_PATH = "serve_tp_bp8_fused"
#: (g): qwen2-72b at full width and 4 of its 80 layers on (data 1, model
#: 4), 2 rows of 1024-token prompts, 16 greedy decode steps; (h):
#: paligemma-3b whole on (data 2, model 2), 2 rows (one a data rank) of
#: 256 zero patch tokens and a 64-token prompt, 8 steps
TP_CASES = {
    "g": {"arch": "qwen2_72b", "layers": 4, "mesh": {"data": 1, "model": 4},
          "rows": 2, "prompt": 1024, "steps": 16},
    "h": {"arch": "paligemma_3b", "layers": None,
          "mesh": {"data": 2, "model": 2}, "rows": 2, "prompt": 64,
          "steps": 8},
}
TP_SEED = 28
#: rows of a leaf's block drawn from one seed (the stacked leaves: a
#: layer a block)
TP_BLOCK_ROWS = 2048
TP_REDUCED = {"num_layers": "qwen2-72b 80 -> 4 in 14(g): its whole ~145 GB "
              "of bf16 weights do not fit one card for the one-process "
              "oracle, and the script's time; paligemma-3b whole in 14(h), "
              "8 decode steps"}
#: the collectives a serving call makes (the vocabulary's sum and gather,
#: the row-parallel sums, the scale reductions, the rows' gather)
TP_COLLECTIVES = ("all_reduce_sum", "all_reduce_max", "all_gather")


def tp_config(arch, layers=None):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, matmul_mode="bp8_fused", kv_quant="bp8",
                               num_layers=layers or cfg.num_layers)


def _seeded_leaf(torch, d, i, placement, mesh, dev):
    """Leaf ``i`` of a schema (``ParamDef`` ``d``) drawn block by block
    along its first dim (a layer of a stack, or ``TP_BLOCK_ROWS`` rows),
    each block from a seed of its own, by the init's std rule: with a
    mesh and ``placement``, only this rank's piece (the blocks it
    overlaps, cut), else the whole leaf.  So the ranks' pieces join into
    the one process's leaves, and no rank holds more than its pieces and
    one block."""
    from repro_torch.dist.sharding import _cut, local_shard
    n0 = d.shape[0]
    rows = 1 if d.axes[0] == "stack" else TP_BLOCK_ROWS
    lo, hi = 0, n0
    if mesh is not None and placement[0] is not None:
        lo, hi = _cut(n0, mesh.size(placement[0]), mesh.index(placement[0]))
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    std = 1.0 if d.init == "embed" else d.scale / math.sqrt(max(1, fan_in))
    parts = []
    for b0 in range(lo - lo % rows, hi, rows):
        shape = (min(rows, n0 - b0),) + tuple(d.shape[1:])
        if d.init in ("zeros", "ones"):
            blk = (torch.zeros if d.init == "zeros" else torch.ones)(
                shape, dtype=d.dtype, device=dev)
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(TP_SEED * 1_000_003 + i * 100_003 + b0 // rows)
            blk = torch.randn(shape, generator=gen, device=dev).mul_(std).to(
                d.dtype)
        blk = blk[max(lo, b0) - b0:min(hi, b0 + rows) - b0]
        if mesh is not None:
            blk = local_shard(blk, (None,) + tuple(placement[1:]), mesh)
        parts.append(blk.contiguous())
        del blk
    return torch.cat(parts, 0) if len(parts) > 1 else parts[0]


def seeded_tree(torch, model, dev, placements=None, mesh=None):
    """``model``'s params drawn by ``_seeded_leaf``: this rank's pieces
    of them under ``placements`` on ``mesh``, or the whole tree."""
    from repro_torch.models.params import tree_leaves, tree_unflatten
    schema = model.schema()
    leaves = tree_leaves(schema)
    pls = [p for _, p in tree_leaves(placements)] if placements else \
        [None] * len(leaves)
    return tree_unflatten(schema, [
        _seeded_leaf(torch, d, i, pl, mesh, dev)
        for i, ((_, d), pl) in enumerate(zip(leaves, pls))])


def _tp_batch(torch, cfg, c, dev):
    """A case's whole batch: seeded prompts, and paligemma's zero patch
    embeddings."""
    gen = torch.Generator().manual_seed(TP_SEED + c["prompt"])
    batch = {"tokens": torch.randint(3, cfg.vocab_size,
                                     (c["rows"], c["prompt"]),
                                     generator=gen).to(dev)}
    if cfg.num_prefix_tokens:
        batch["patches"] = torch.zeros(
            (c["rows"], cfg.num_prefix_tokens, cfg.d_model),
            dtype=torch.bfloat16, device=dev)
    return batch


def _leaf_bytes(tree) -> dict:
    from repro_torch.models.params import tree_leaves
    return {"/".join(k): v.numel() * v.element_size()
            for k, v in tree_leaves(tree)}


def _layer0(cache) -> dict:
    """The model's first layer of a cache, cloned."""
    stack = "dense_layers" if "dense_layers" in cache else "layers"
    return {k: v[0].clone() for k, v in cache[stack].items()}


def _tp_serve(torch, build, mesh, dev, key):
    """14(g)/(h) on one card rank: the case's model served on ``mesh``
    through ``dist.serving`` (this rank's seeded pieces, the whole batch
    on every rank): a prefill, then the case's greedy decode steps;
    launches counted from just before to just after.  Returns the rank's
    numbers, and (kept on the rank) every call's logits and the layer-0
    cache after the prefill and at the end."""
    from repro_torch.dist import serving as sv
    from repro_torch.models import build as build_model
    c = TP_CASES[key]
    cfg = tp_config(c["arch"], c["layers"])
    model = build_model(cfg)
    rows = c["rows"]
    rules = sv.serving_rules(mesh, "prefill", rows)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = seeded_tree(torch, model, dev,
                         sv.serve_placements(model, mesh, rules), mesh)
    res = {"init_s": _sync_s(torch, t0)}
    batch = _tp_batch(torch, cfg, c, dev)
    length = c["prompt"] + c["steps"]
    kept = {"logits": []}
    torch.cuda.synchronize()
    build.reset_launches()
    mesh.reset_stats()
    with sv.use_tp_serving(mesh, "prefill", batch=rows) as ctx:
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, length)
        res["prefill_s"] = _sync_s(torch, t0)
        res["rows"], res["kv_heads"] = ctx.rows(rows), ctx.kv_heads(cfg)
        plan = ctx.plan(cfg)
    res["prefill_transport"] = _transport(mesh)
    kept["logits"].append(logits.float())
    kept["l0_prefill"] = _layer0(cache)
    tok = logits.argmax(-1)
    toks, steps = [tok.tolist()], []
    mesh.reset_stats()
    pos0 = c["prompt"] + cfg.num_prefix_tokens
    with sv.use_tp_serving(mesh, "decode", batch=rows):
        for i in range(c["steps"]):
            t1 = time.perf_counter()
            logits, cache = model.decode_step(params, tok[:, None], cache,
                                              pos0 + i)
            tok = logits.argmax(-1)
            steps.append(_sync_s(torch, t1))
            toks.append(tok.tolist())
            kept["logits"].append(logits.float())
    tr = res["decode_transport"] = _transport(mesh)
    res["launches"] = dict(build.LAUNCHES)
    kept["l0_end"] = _layer0(cache)
    coll = {k: v for k, v in tr.items() if k.split(" ")[0] in TP_COLLECTIVES}
    res.update(
        step_s=steps, tokens=toks, plan=dataclasses.asdict(plan),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        param_bytes=_leaf_bytes(params), cache_bytes=_leaf_bytes(cache),
        decode_collectives_per_step=sum(v["calls"] for v in coll.values())
        / c["steps"],
        decode_collective_share=sum(v["s"] for v in coll.values())
        / sum(steps))
    del params, cache
    return res, kept


def _tp_single(torch, model, dev, c, mine, kept, pieces, infos):
    """14(g)/(h)'s one-process run on the card rank 0 (the whole seeded
    params, no mesh) of the same calls, the decode steps fed the mesh's
    tokens: every call's logits cosine and greedy choices, and each
    rank's layer-0 cache pieces (``pieces``: every rank's, gathered here)
    against this run's cut at the rank's rows and kv heads."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = model.cfg
    t0 = time.perf_counter()
    params = seeded_tree(torch, model, dev)
    init_s = _sync_s(torch, t0)
    batch = _tp_batch(torch, cfg, c, dev)
    toks = mine["tokens"]

    def held(l0, when):
        out = []
        for r, info in enumerate(infos):
            (lo, hi), (first, n) = info
            same = True
            for k, v in l0.items():
                cut = v[lo:hi]
                if cut.dim() >= 3:
                    cut = cut[:, :, first:first + n]
                same &= torch.equal(cut.cpu(), pieces[when][k][r].cpu())
            out.append(bool(same))
        return out

    def choices(logits, want):
        return [_greedy_vs(torch, logits[r], want[r])
                for r in range(logits.shape[0])]

    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, c["prompt"] + c["steps"])
    out = {"init_s": init_s, "prefill_s": _sync_s(torch, t0),
           "cosines": [_cosine(torch, kept["logits"][0], logits)],
           "choices": choices(logits, toks[0]),
           "l0_prefill": held(_layer0(cache), "prefill")}
    steps = []
    pos0 = c["prompt"] + cfg.num_prefix_tokens
    for i in range(c["steps"]):
        tok = torch.tensor(toks[i], device=dev)[:, None]
        t1 = time.perf_counter()
        logits, cache = model.decode_step(params, tok, cache, pos0 + i)
        steps.append(_sync_s(torch, t1))
        out["cosines"].append(_cosine(torch, kept["logits"][i + 1], logits))
        out["choices"] += choices(logits, toks[i + 1])
    out.update(step_s=steps, l0_end=held(_layer0(cache), "end"),
               cache_bytes=_leaf_bytes(cache),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del params, cache
    return out


def _case_serve_tp(torch, build, mesh, dev, quiet, key):
    """Phase 14(g) or (h) on one card rank: the case served on the mesh,
    every rank's layer-0 cache pieces gathered to rank 0, then ranks 1-3
    free their weights and wait while rank 0 runs the same calls in this
    one process, and compares.  ``quiet()`` (the barrier the CPU twins
    wait at) is called at the end."""
    import torch.distributed as tdist
    from repro_torch.models import build as build_model
    c = TP_CASES[key]
    lead = mesh.position == 0
    group = mesh.group(mesh.axis_names)
    res, kept = _tp_serve(torch, build, mesh, dev, key)
    pieces = {when: {k: mesh.gather(v.contiguous(), mesh.axis_names)
                     for k, v in kept[f"l0_{when}"].items()}
              for when in ("prefill", "end")}
    infos = [None] * mesh.size(mesh.axis_names)
    tdist.all_gather_object(infos, (res["rows"], res["kv_heads"]),
                            group=group)
    if not lead:
        del kept
    gc.collect()
    torch.cuda.empty_cache()
    tdist.barrier(group=group)
    if lead:
        model = build_model(tp_config(c["arch"], c["layers"]))
        res["single"] = _tp_single(torch, model, dev, c, res, kept, pieces,
                                   infos)
        del kept, pieces
        gc.collect()
        torch.cuda.empty_cache()
    tdist.barrier(group=group)
    quiet()
    return res


def tp_kernel_rows(torch, timer):
    """Rows 1-4 at a TP rank's decode shapes (served_kernel_rows, M 4;
    checked bitwise at M 4, 64 and the prefill's 2048): qwen2-72b on 4
    ranks (wq 8192 -> 2048, wk/wv 8192 -> 256, wo 2048 -> 8192 and down
    7392 -> 8192 row-parallel, the silu MLP 8192 -> 7392, decode
    attention at 2 kv heads, G 8, D 128) for the kernels line, and
    paligemma-3b on 2 (wq 2048 -> 1024, wk/wv 2048 -> 256 whole, wo 1024
    -> 2048, down 8192 -> 2048, the gelu MLP 2048 -> 8192, decode
    attention at 1 kv head, G 4, D 256), printed beside it."""
    out = {}
    for key, (h, kh, ff, tp) in (("g", (16, 2, 7392, 4)),
                                 ("h", (4, 1, 8192, 2))):
        c = TP_CASES[key]
        full = tp_config(c["arch"], 1)
        d, hd = full.d_model, full.head_dim
        rank = dataclasses.replace(full, num_heads=h, num_kv_heads=kh,
                                   d_ff=ff)
        step = [(d, h * hd), (d, kh * hd), (d, kh * hd), (h * hd, d),
                (ff, d)]
        out[key], _ = served_kernel_rows(
            torch, timer, rank, step, mlp=True,
            big_m=(c["rows"] * (c["prompt"] + full.num_prefix_tokens),))
        print(f"phase 14({key}) rows 1-4 above at a TP-{tp} rank's "
              f"{c['arch']} shapes")
    return out


def tp_report(torch, ranks):
    """14(g)-(h)'s gates and numbers over the 4 card ranks' results: fails
    the script where a layer-0 piece is not bitwise the one process's
    cut, a call's logits cosine is at or under 0.9999, a greedy choice
    parts outside a near tie, a leaf's bytes on a rank are not the whole
    leaf's over its pieces, or a row of the path never launched on a
    rank.  Returns the path's launches of rows 1-4 (over both cases and
    every rank) and the report."""
    from repro_torch.dist import serving as sv
    from repro_torch.models import build as build_model
    from repro_torch.models.params import tree_leaves
    launches, report = {}, {"reduced": TP_REDUCED}
    for key, c in TP_CASES.items():
        res = [r[f"serve_tp_{key}"] for r in ranks]
        single = res[0]["single"]
        cfg = tp_config(c["arch"], c["layers"])
        model = build_model(cfg)
        tag = f"phase 14({key}) {c['arch']}"
        if not all(single["l0_prefill"]) or not all(single["l0_end"]):
            fail(f"{tag}: layer-0 K/V pieces not bitwise the one process's "
                 f"cut: prefill {single['l0_prefill']}, end "
                 f"{single['l0_end']}")
        bad = [ch for ch in single["choices"]
               if not ch["equal"] and ch["gap"] >= ch["tie_below"]]
        if not min(single["cosines"]) > 0.9999 or bad:
            fail(f"{tag}: cosines {single['cosines']}, greedy choices "
                 f"parting outside a near tie {bad}")
        # bytes: each split leaf on a rank is the whole leaf's over its
        # pieces (the one process's weights from the schema, its cache
        # from its own run)
        shape = _Shape(c["mesh"])
        pl = dict(("/".join(k), v) for k, v in tree_leaves(
            sv.serve_placements(model, shape, sv.serving_rules(
                shape, "prefill", c["rows"]))))
        whole = {"/".join(k): math.prod(d.shape) * d.dtype.itemsize
                 for k, d in tree_leaves(model.schema())}
        faults = []
        for r in res:
            for k, n in whole.items():
                pieces = math.prod(c["mesh"][a] for e in pl[k]
                                   if e is not None
                                   for a in ((e,) if isinstance(e, str)
                                             else e))
                if r["param_bytes"][k] * pieces != n:
                    faults.append((k, r["param_bytes"][k], n, pieces))
            (lo, hi), (_, kh) = r["rows"], r["kv_heads"]
            for k, n in single["cache_bytes"].items():
                part = n * (hi - lo) // c["rows"]
                if k.split("/")[-1] != "pos":
                    part = part * kh // cfg.num_kv_heads
                if r["cache_bytes"][k] != part:
                    faults.append((k, r["cache_bytes"][k], part))
        if faults:
            fail(f"{tag}: bytes not the whole leaf's over its pieces: "
                 f"{faults[:6]}")
        per_rank = [{k: v for k, v in r["launches"].items() if k in SERVED}
                    for r in res]
        if any(p.get(k, 0) <= 0 for p in per_rank for k in SERVED):
            fail(f"{tag}: a row of {SERVED} never launched on a rank: "
                 f"{per_rank}")
        for p in per_rank:
            for k, v in p.items():
                launches[k] = launches.get(k, 0) + v
        med = lambda xs: sorted(xs[1:])[len(xs[1:]) // 2]
        step = [max(r["step_s"][i] for r in res)
                for i in range(c["steps"])]
        parted = sum(not ch["equal"] for ch in single["choices"])
        print(f"{tag} on {c['mesh']} ({res[0]['init_s']:.1f}s init a rank, "
              f"plan {res[0]['plan']}): prefill "
              f"{max(r['prefill_s'] for r in res):.3f}s on the mesh "
              f"(slowest rank) vs {single['prefill_s']:.3f}s single; decode "
              f"step median {med(step) * 1e3:.1f} ms mesh vs "
              f"{med(single['step_s']) * 1e3:.1f} ms single; layer-0 K/V "
              f"bitwise the one process's cut on every rank; logits "
              f"cosines min {min(single['cosines']):.7f}; greedy tokens "
              f"equal at {len(single['choices']) - parted} of "
              f"{len(single['choices'])} (least top-2 gap "
              f"{min(ch['gap'] for ch in single['choices']):.4g}); weight "
              f"GB a rank " + ", ".join(
                  f"{sum(r['param_bytes'].values()) / 1e9:.2f}" for r in res)
              + f" vs {sum(whole.values()) / 1e9:.2f} whole; cache bytes a "
              f"rank " + ", ".join(str(sum(r["cache_bytes"].values()))
                                   for r in res)
              + f" vs {sum(single['cache_bytes'].values())} single; peak GB "
              f"a rank " + ", ".join(f"{r['peak_gb']:.2f}" for r in res)
              + f" vs {single['peak_gb']:.2f} single; decode share in "
              f"collectives a rank " + ", ".join(
                  f"{r['decode_collective_share']:.3f}" for r in res)
              + ", collectives a step " + ", ".join(
                  f"{r['decode_collectives_per_step']:.0f}" for r in res)
              + "; launches of rows 1-4 a rank " + ", ".join(
                  str(p) for p in per_rank))
        report[key] = {"ranks": [{k: v for k, v in r.items()
                                  if k != "single"} for r in res],
                       "single": single}
    return launches, report


# ---------------------------------------------------------------------------
# phase 15: the OISMA reference and the engine model
# ---------------------------------------------------------------------------

#: the path whose launches rows 5 and 6 report from phase 15(a)
OISMA_REF_PATH = "oisma_in_array_reference"
#: h2o-danube-1.8b's q projection at a decode step and at a prefill chunk
OISMA_SHAPES = ((4, D, HD), (64, D, HD))
#: the AND bitstreams' tile of 15(a): M 4 x the first N 256 outputs
OISMA_TILE_N = 256
#: rows of x in one piece of the in-array multiply's (rows, K, N, bits)
#: AND (1.2 GB at the q projection's K and N)
OISMA_PIECE_ROWS = 8
OISMA_SEED = 27
#: the paper's Fig. 7 relative Frobenius errors of the BP matmul
FIG7_PAPER = {4: 0.0942, 512: 0.0181}
#: trials a size, as the reference's accuracy benchmark takes them
FIG7_TRIALS = {4: 60, 64: 60, 512: 20}
#: h2o-danube-1.8b's cells the engine model and the roofline are printed for
OISMA_CELLS = ("decode_32k", "prefill_32k")


def sc_matmul(torch, bp, xl, yl, bits: int):
    """The paper's in-array multiply summed over K: sum_k of
    ``sc_multiply(x[m, k], y[k, n])`` (AND and popcount of the two
    levels' bitstreams, ``bits`` wide), int64 (M, N), OISMA_PIECE_ROWS
    rows of x at a time."""
    return torch.cat([
        bp.sc_multiply(xl[i:i + OISMA_PIECE_ROWS, :, None], yl[None],
                       bits=bits).sum(1)
        for i in range(0, xl.shape[0], OISMA_PIECE_ROWS)])


def _max_err(torch, got, want) -> float:
    return float((got.double() - want.double()).abs().max())


def phase_oisma(torch, timer, build, dev="cuda"):
    """Phase 15: (a) the paper's AND/popcount reference of the in-array
    multiply against rows 5 and 6, (b) Fig. 7's error curve on the card,
    (c) the engine simulator's validation and the analytic projections.
    Returns rows 5 and 6 on OISMA_REF_PATH, their launches over (a), and
    a report."""
    import numpy as np

    from repro_torch import sim
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.core import bp
    from repro_torch.kernels import bp_matmul as kb
    from repro_torch.kernels import ref
    from repro_torch.roofline import hw
    from repro_torch.roofline.model import (MeshSpec, analytic_cell,
                                            oisma_engine_projection)

    rng = np.random.default_rng(OISMA_SEED)

    def on_card(a):
        return torch.as_tensor(a, device=dev)

    levels = {s: (on_card(rng.integers(0, 10, s[:2], dtype=np.int8)),
                  on_card(rng.integers(0, 10, s[1:], dtype=np.int8)))
              for s in OISMA_SHAPES}
    big = OISMA_SHAPES[-1]
    m, k, n = big
    xf, yf = on_card(rng.random((m, k))), on_card(rng.random((k, n)))
    right, left = bp.bent_pyramid_datasets()
    x4, y4 = levels[OISMA_SHAPES[0]]
    y4 = y4[:, :OISMA_TILE_N]
    report = {}

    # (a) the path: the codes matmul on the levels, and the periphery's
    # popcount on the AND bitstreams of an M 4 x N 256 tile (rows of K * 8
    # bytes); launches zeroed just before and read just after
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    kern = {s: kb.bp_matmul(*levels[s]) for s in OISMA_SHAPES}
    tile = (bp.encode(x4, right, bp.EFFECTIVE_BITS)[:, None]
            & bp.encode(y4, left, bp.EFFECTIVE_BITS).permute(1, 0, 2)[None]
            ).reshape(x4.shape[0] * OISMA_TILE_N, -1)
    pops = kb.popcount_accumulate(tile)
    qx, qy = (bp.quantize_to_levels(t).to(torch.int8) for t in (xf, yf))
    kern_q = kb.bp_matmul(qx, qy)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    if launches.get("bp_matmul", 0) <= 0 or launches.get("popcount", 0) <= 0:
        fail(f"phase 15(a): rows 5 and 6 not both launched ({launches})")

    for s in OISMA_SHAPES:
        for bits in (bp.BITS, bp.EFFECTIVE_BITS):
            want = sc_matmul(torch, bp, *levels[s], bits)
            if not torch.equal(kern[s].to(torch.int64), want):
                fail(f"phase 15(a): sc_multiply (bits {bits}) summed over K "
                     f"differs from the codes matmul at {s}: max "
                     f"{_max_err(torch, kern[s], want)}")
    sums = pops.reshape(x4.shape[0], OISMA_TILE_N)
    if not torch.equal(sums.to(torch.int64), sc_matmul(
            torch, bp, x4, y4, bp.EFFECTIVE_BITS)):
        fail("phase 15(a): the popcount of the AND bitstreams differs from "
             "sc_multiply's sums")
    if not torch.equal(sums.float(), kern[OISMA_SHAPES[0]][:, :OISMA_TILE_N]):
        fail("phase 15(a): the popcount's sums differ from the codes matmul's")
    r_lut = bp.bp_matmul_reference(xf, yf)
    for bits in (bp.BITS, bp.EFFECTIVE_BITS):
        if not torch.equal(r_lut, bp.bp_matmul_bitplane(xf, yf, bits=bits)):
            fail(f"phase 15(a): bp_matmul_reference and bp_matmul_bitplane "
                 f"(bits {bits}) differ in float64 at {big}")
    if r_lut.dtype != torch.float64 or not torch.equal(
            torch.round(r_lut * 10), kern_q.double()):
        fail(f"phase 15(a): the float64 reference times 10 differs from the "
             f"codes matmul on quantize_to_levels' codes at {big}")
    # rows 5 and 6 against their plain versions on the path's inputs
    plain = [(kern[s], ref.bp_matmul_ref(*levels[s])) for s in OISMA_SHAPES]
    plain.append((kern_q, ref.bp_matmul_ref(qx, qy)))
    errs = {"bp_matmul": max(_max_err(torch, a, b) for a, b in plain),
            "popcount": _max_err(torch, pops,
                                 ref.popcount_accumulate_ref(tile))}
    if any(errs.values()):
        fail(f"phase 15(a): a kernel differs from its plain version: {errs}")

    ms = {}
    for s in OISMA_SHAPES:
        tag = "x".join(map(str, s))
        xl, yl = levels[s]
        for bits in (bp.BITS, bp.EFFECTIVE_BITS):
            ms[f"sc_multiply_bits{bits}_{tag}"] = timer(
                [lambda xl=xl, yl=yl, bits=bits: sc_matmul(
                    torch, bp, xl, yl, bits)], iters=3)
        ms[f"bp_matmul_kernel_{tag}"] = timer(
            [lambda xl=xl, yl=yl: kb.bp_matmul(xl, yl)])
    tag = "x".join(map(str, big))
    ms[f"bp_matmul_reference_f64_{tag}"] = timer(
        [lambda: bp.bp_matmul_reference(xf, yf)], iters=3)
    ms[f"bp_matmul_bitplane_f64_{tag}"] = timer(
        [lambda: bp.bp_matmul_bitplane(xf, yf)], iters=3)
    r, c = tile.shape
    ms[f"popcount_kernel_{r}x{c}"] = timer(
        [lambda: kb.popcount_accumulate(tile)])
    rows = {
        "bp_matmul": dict(
            max_abs_err=errs["bp_matmul"],
            ms=timer([lambda p=levels[s]: kb.bp_matmul(*p)
                      for s in OISMA_SHAPES]),
            plain_ms=timer([lambda p=levels[s]: ref.bp_matmul_ref(*p)
                            for s in OISMA_SHAPES], iters=3),
            library_ms=None,
            b=[bound(mm * kk + kk * nn + 4 * mm * nn, 2 * mm * nn * 8 * kk,
                     H100_INT8_OPS_PER_S) for (mm, kk, nn) in OISMA_SHAPES]),
        "popcount": dict(
            max_abs_err=errs["popcount"],
            ms=timer([lambda: kb.popcount_accumulate(tile)]),
            plain_ms=timer([lambda: ref.popcount_accumulate_ref(tile)]),
            library_ms=timer([lambda: tile.sum(-1, dtype=torch.int32)]),
            b=[bound(r * c + 4 * r, r * c, H100_F32_FLOPS_PER_S)])}
    print(f"phase 15(a): sc_multiply (AND and popcount, bits 10 and 8) "
          f"summed over K equal to the codes matmul at "
          f"{', '.join('x'.join(map(str, s)) for s in OISMA_SHAPES)}; the "
          f"popcount kernel's {r} rows of {c} AND bytes equal to their "
          f"sums; bp_matmul_reference == bp_matmul_bitplane bitwise in "
          f"float64 at {tag}, times 10 equal to the kernel on "
          f"quantize_to_levels' codes; launches {launches} in "
          f"{path_s:.3f}s; ms " + ", ".join(f"{k_} {v:.4f}"
                                            for k_, v in ms.items()))
    report["a"] = {"launches": launches, "path_s": path_s, "ms": ms,
                   "tile": [r, c]}

    # (b) the paper's Fig. 7: the BP matmul's relative Frobenius error
    # against the float64 product, falling with the size
    fig7 = {}
    for size, trials in FIG7_TRIALS.items():
        errs7 = []
        for _ in range(trials):
            x, y = on_card(rng.random((size, size))), on_card(
                rng.random((size, size)))
            exact = x @ y
            errs7.append(float(torch.linalg.norm(
                exact - bp.bp_matmul_reference(x, y))
                / torch.linalg.norm(exact)))
        fig7[size] = sum(errs7) / trials
    print("phase 15(b) Fig. 7, relative Frobenius error (mean of "
          + ", ".join(f"{t} at {s}" for s, t in FIG7_TRIALS.items())
          + " seeded uniform trials): " + ", ".join(
              f"{s}x{s} {e * 100:.3f}%" + (
                  f" (paper {FIG7_PAPER[s] * 100:.2f}%)" if s in FIG7_PAPER
                  else "") for s, e in fig7.items()))
    if not fig7[4] > fig7[64] > fig7[512]:
        fail(f"phase 15(b): the errors do not fall 4 > 64 > 512: {fig7}")
    report["b_fig7"] = fig7

    # (c) the engine model: the simulator pinned to the paper's endpoints,
    # and the analytic projections of two cells (nothing here is measured)
    rows_v = sim.validate()
    for metric, got, want, rel in rows_v:
        print(f"phase 15(c) sim.validate {metric}: simulated {got:.6g}, "
              f"paper {want:.6g}, relative error {rel:.3e}")
    if any(rel >= 0.005 for *_, rel in rows_v):
        fail(f"phase 15(c): sim.validate() at or above 0.5%: {rows_v}")
    cfg = get_config("h2o_danube_1p8b")
    cells = {}
    for cell in OISMA_CELLS:
        shape = SHAPES[cell]
        proj = {e: oisma_engine_projection(cfg, shape, engines=e,
                                           technology_nm=22,
                                           double_buffered=True)
                for e in (1, 4)}
        terms = analytic_cell(cfg, shape, MeshSpec())["terms"]
        cells[cell] = {"oisma_engine": proj, "h100_roofline": {
            "t_compute_s": terms.t_compute, "t_memory_s": terms.t_memory,
            "bottleneck": terms.bottleneck, "flops": terms.flops,
            "hbm_bytes": terms.hbm_bytes}}
        one, four = proj[1], proj[4]
        print(f"phase 15(c) h2o-danube-1.8b {cell} (analytic, not "
              f"measured): the OISMA engine at 22 nm, double-buffered, "
              f"weights only: 1 engine {one['latency_s']:.6g} s a step "
              f"(serial reprogramming {one['serial_reprogram_latency_s']:.6g}"
              f" s), utilization {one['utilization']:.4f}, "
              f"{one['achieved_tops_per_watt']:.4f} TOPS/W, "
              f"{one['gops_per_mm2']:.2f} GOPS/mm2; 4 engines "
              f"{four['latency_s']:.6g} s, scaling efficiency "
              f"{four['scaling_efficiency']:.4f}; one H100's roofline: "
              f"t_compute {terms.t_compute:.6g} s ({terms.flops:.4g} FLOPs "
              f"at the data sheet's {hw.PEAK_FLOPS_BF16:.4g} bf16 FLOP/s), "
              f"t_memory {terms.t_memory:.6g} s ({terms.hbm_bytes:.4g} B at "
              f"{hw.HBM_BW:.4g} B/s), bottleneck {terms.bottleneck}")
    report["c"] = {"validate": rows_v, "cells": cells}
    return rows, launches, report


class _Shape:
    """A mesh's shape for ``param_placements`` (which reads its plan from
    the shape alone)."""

    def __init__(self, shape):
        self.shape = dict(shape)


class Phase:
    """Prints a phase's wall time when it ends."""

    def __init__(self, name: str, report: dict):
        self.name, self.report = name, report

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.report.setdefault("phase_s", {})[self.name] = dt
        print(f"phase {self.name}: {dt:.1f}s")


def parting(torch, cfg, p_cpu, p_gpu, prompt, cpu_toks, gpu_toks,
            frames=None):
    """Where a request's card and CPU tokens part: the step, and at that
    step (the prompt and the agreed tokens through a one-shot prefill on
    each device, after ``frames`` for an encoder-decoder) the CPU's top-2
    logit margin and the largest logit difference."""
    import numpy as np
    from repro_torch.models import build as build_model
    j = next(i for i, (a, b) in enumerate(zip(cpu_toks, gpu_toks))
             if a != b)
    seq = np.concatenate([prompt, np.asarray(cpu_toks[:j], np.int32)])
    model = build_model(cfg)
    logits = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        batch = {"tokens": torch.as_tensor(seq[None].astype(np.int64),
                                           device=dev)}
        if frames is not None:
            batch["frames"] = frames.to(dev)
        logits[dev] = model.prefill(params, batch,
                                    len(seq) + 1)[0][0].float().cpu()
    top = torch.topk(logits["cpu"], 2).values
    return {"step": j, "cpu_top2_margin": float(top[0] - top[1]),
            "max_logit_diff": float((logits["cpu"]
                                     - logits["cuda"]).abs().max())}


def card_vs_cpu(torch, cfg, prompts, max_new=8, frames=None):
    """The same seeded weights (``cfg.num_layers`` layers) on the card,
    captured and eager, and on the CPU must emit the same greedy tokens
    through the paged engine (an encoder-decoder over the same
    ``frames``, (1, F, d_model) on the card).  Where a request parts,
    print the step, the CPU's top-2 logit margin and the largest logit
    difference, and fail."""
    p_cpu, p_gpu = seeded_pair(cfg)
    f_cpu = None if frames is None else frames.to("cpu")
    out_gpu, _, eng = serve(torch, cfg, p_gpu, prompts, max_new, "cuda",
                            frames=frames)
    if not eng.capture:
        fail("the engine on CUDA does not capture by default")
    graphs = eng.compile_counts()
    del eng
    out_eager, _, _ = serve(torch, cfg, p_gpu, prompts, max_new, "cuda",
                            capture=False, frames=frames)
    out_cpu, cpu_s, _ = serve(torch, cfg, p_cpu, prompts, max_new, "cpu",
                              frames=f_cpu)
    print(f"card vs cpu ({cfg.name}, {cfg.matmul_mode}, kv {cfg.kv_quant}, "
          f"{cfg.num_layers} layers, full width, prompts "
          f"{[len(p) for p in prompts]}): card, captured ({graphs} graphs) "
          f"{out_gpu}")
    print(f"    card, eager {out_eager}")
    print(f"    cpu {out_cpu} ({cpu_s:.1f}s on the CPU)")
    parts = {}
    for rid, toks in out_cpu.items():
        for what, other in (("captured", out_gpu), ("eager", out_eager)):
            if other[rid] != toks:
                parts[f"{rid} {what}"] = parting(torch, cfg, p_cpu, p_gpu,
                                                 prompts[rid], toks,
                                                 other[rid], frames)
    if parts:
        print(f"{cfg.name}: card and CPU tokens part: {parts}")
        fail(f"{cfg.name} ({cfg.matmul_mode}): card (captured, eager) and "
             f"CPU tokens differ")
    return cpu_s


def expand_rows(model, cache, rows: int):
    """A batch-1 cache repeated to ``rows`` rows along each leaf's batch
    axis (``cache_axes``), contiguous."""
    from repro_torch.models.params import tree_leaves
    axes = dict(tree_leaves(model.cache_axes()))
    out = {}
    for path, leaf in tree_leaves(cache):
        shape = list(leaf.shape)
        shape[axes[path].index("batch")] = rows
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf.expand(*shape).contiguous()
    return out


def graphed_vs_eager(torch, model, params, rng, frames=None, fresh=False):
    """A prefill chunk (64 tokens at position 64) and a decode step (4 rows)
    at full width, replayed from graphs, against the eager calls on the
    same inputs: the caches bitwise equal, and the logits bitwise equal
    (or, if the f32 logits matmul alone differs under capture, that is
    printed with its largest difference).  With ``frames`` (an
    encoder-decoder) the first chunk, which carries them and runs the
    encoder, is replayed from its own graph and checked too; with
    ``fresh`` (a recurrent model) the first chunk, from the zero state,
    is replayed from the later chunk's graph and checked."""
    from repro_torch.models.params import tree_leaves
    from repro_torch.serve.graphs import GraphedEntry
    cfg = model.cfg

    def clone(tree):
        return {k: clone(v) if isinstance(v, dict) else v.clone()
                for k, v in tree.items()}

    def caches_equal(a, b):
        return all(torch.equal(x, y) for (_, x), (_, y)
                   in zip(tree_leaves(a), tree_leaves(b)))

    pool = torch.cuda.graph_pool_handle()
    prefill = GraphedEntry(lambda t, v, p0: model.prefill_chunk(
        params, {"tokens": t}, v, p0), capture=True, pool=pool)
    decode = GraphedEntry(lambda t, v, p: model.decode_step(params, t, v, p),
                          capture=True, pool=pool)
    cache = model.init_cache(1, 256, "cuda")
    t = torch.as_tensor(rng.integers(3, cfg.vocab_size, (1, 64)),
                        device="cuda")
    result = {}
    if fresh:
        prefill.inputs("p", lambda: (t.clone(), clone(cache),
                                     torch.zeros((), dtype=torch.int64,
                                                 device="cuda")))
        want, cache = model.prefill_chunk(params, {"tokens": t},
                                          clone(cache), 0)
        got, got_cache = prefill("p")
        result["prefill chunk 64 from the zero state"] = (
            got.clone(), want, clone(got_cache), cache)
    elif frames is None:
        model.prefill_chunk(params, {"tokens": t}, cache, 0)
    else:
        first = GraphedEntry(lambda t, v, p0, f: model.prefill_chunk(
            params, {"tokens": t, "frames": f}, v, p0), capture=True,
            pool=pool)
        first.inputs("f", lambda: (t.clone(), clone(cache),
                                   torch.zeros((), dtype=torch.int64,
                                               device="cuda"),
                                   frames.clone()))
        want, cache = model.prefill_chunk(
            params, {"tokens": t, "frames": frames}, clone(cache), 0)
        got, got_cache = first("f")
        result["prefill chunk 64 with frames"] = (got.clone(), want,
                                                  got_cache, cache)
    t = torch.as_tensor(rng.integers(3, cfg.vocab_size, (1, 64)),
                        device="cuda")
    tok_s, view_s, p0_s = prefill.inputs("p", lambda: (
        t.clone(), clone(cache), torch.full((), 64, device="cuda")))
    tok_s.copy_(t)
    p0_s.fill_(64)
    for (_, leaf), (_, src) in zip(tree_leaves(view_s), tree_leaves(cache)):
        leaf.copy_(src)
    want, want_cache = model.prefill_chunk(params, {"tokens": t},
                                           clone(cache), 64)
    got, got_cache = prefill("p")
    # a graph's outputs live in the shared pool until another graph runs
    result["prefill chunk 64"] = (got.clone(), want, got_cache, want_cache)
    rows = 4
    full = expand_rows(model, want_cache, rows)
    t = torch.as_tensor(rng.integers(3, cfg.vocab_size, (rows, 1)),
                        device="cuda")
    p = torch.tensor([128, 130, 200, 255], dtype=torch.int32, device="cuda")
    decode.inputs("d", lambda: (t.clone(), clone(full), p.clone()))
    want, want_cache = model.decode_step(params, t, clone(full), p)
    got, got_cache = decode("d")
    result["decode step 4 rows"] = (got.clone(), want, got_cache,
                                    want_cache)
    report = {}
    for what, (g, w, gc, wc) in result.items():
        if not caches_equal(gc, wc):
            fail(f"graphed {what}: the cache differs from the eager call's")
        diff = (g - w).abs().max().item()
        report[what] = {"logits_bitwise": bool(torch.equal(g, w)),
                        "logits_max_abs_diff": diff}
        if not torch.equal(g, w):
            h = torch.randn((g.shape[0], cfg.d_model),
                            device="cuda").to(torch.bfloat16)
            mm = GraphedEntry(lambda h: model._logits(params, h),
                              capture=True, pool=pool)
            mm.inputs("h", lambda: (h.clone(),))
            alone = (mm("h") - model._logits(params, h)).abs().max().item()
            if alone == 0.0:
                fail(f"graphed {what}: logits differ by {diff} with the "
                     f"caches equal and the logits matmul alone equal")
            print(f"graphed {what}: logits differ by at most {diff:.3g}; "
                  f"cause: the f32 logits matmul alone differs under "
                  f"capture by {alone:.3g} (cuBLAS)")
            report[what]["cause"] = "f32 logits matmul under capture"
    print(f"graphed vs eager at full width ({cfg.name}): {report}")
    return report


def main() -> None:
    import faulthandler
    faulthandler.enable()              # a native crash prints its stack
    sys.stdout.reconfigure(line_buffering=True)
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script needs one NVIDIA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.models import build as build_model
    from repro_torch.models.params import init_params

    resolve_device("cuda")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    with Phase("1 build", report):
        lib_path = build.build()
        log = (lib_path.parent / build.LOG_NAME).read_text()
        report["build_log"] = log
        for line in ptxas_report(log):
            print(f"ptxas: {line}")
        sass = sass_counts(build, lib_path)
        report["bp_mma_sass"] = sass
        for fn, c in sass.items():
            print(f"SASS {fn}: {c['IMMA']} IMMA, {c['IGMMA']} IGMMA, "
                  f"{c['POPC']} POPC")
        for ctx in next(iter(sass.values()), {}).get("POPC_context", []):
            print(f"  POPC in context: {' | '.join(ctx)}")
        if not sass or any(c["IMMA"] + c["IGMMA"] == 0 for c in sass.values()):
            fail("the integer core's kernels must multiply on the int8 "
                 "tensor cores (IMMA or IGMMA)")
        # the codes matmul: coded x and one coded weight (x's type last)
        if not any("Li1EaEE" in fn for fn in sass):
            fail("no kernel of the codes matmul in the SASS")
        lib = build.library()
        from repro_torch.kernels.attention import _split_smem
        print("dynamic shared memory: fused matmul tiles (bf16 weight) "
              + ", ".join(f"M {m}: {lib.oisma_fused_matmul_smem(m, 1)} B"
                          for m in (4, 64, 256))
              + f"; decode attention split block (G 4, D 80, 64 tokens) "
              f"{_split_smem(4, 80, 64)} B")
    print(f"kernels built ({build.BUILD_ROOT / build.source_hash()})")

    # ---- phase 2: kernels vs plain ----
    with Phase("2 kernels vs plain", report):
        timer = Timer(torch)
        rows, detail = phase_kernels(torch, timer)
    report["kernel_detail"] = detail
    for name, r in rows.items():
        was = (f" ({EARLIER}: {EARLIER_MS[name]})" if name in EARLIER_MS
               else "")
        print(f"kernel {name}: ms {r['ms']:.4f}{was} plain_ms "
              f"{r['plain_ms']:.4f} library_ms {r['library_ms']} max_abs_err "
              f"{r['max_abs_err']}")
    for k, v in detail.items():
        if k.endswith("_ms"):
            was = (f" ({EARLIER}: {EARLIER_MS[k]})" if k in EARLIER_MS
                   else "")
            print(f"  {k}: {v:.4f}{was}")
        elif k.endswith("_kernels_per_call"):
            print(f"  {k}: {v}")

    # ---- phase 3: card vs CPU at full width, CPU_CHECK_LAYERS ----
    rng = np.random.default_rng(0)
    full = dataclasses.replace(get_config("h2o_danube_1p8b"),
                               matmul_mode="bp8_fused", kv_quant="bp8")
    prompts = [rng.integers(3, full.vocab_size, n).astype(np.int32)
               for n in (37, 64, 101)]
    report["cpu_s"] = {}
    for mode in ("bp8_fused", "bp8"):
        with Phase(f"3 card vs cpu, {mode}", report):
            cfg2 = dataclasses.replace(full, num_layers=CPU_CHECK_LAYERS,
                                       matmul_mode=mode)
            # PHASE3_PROMPTS of the three drawn (the draws keep the later
            # phases' prompts): 37 tokens, a part of a chunk, and 101, a
            # chunk and a part of one
            report["cpu_s"][mode] = card_vs_cpu(
                torch, cfg2, [prompts[i] for i in PHASE3_PROMPTS])

    # ---- phase 4: the served path, full model ----
    with Phase("4 served path (bp8_fused)", report):
        model = build_model(full)
        params = init_params(model.schema(), seed=0, device="cuda")
        lens = [32, 256] + [int(n) for n in rng.integers(32, 257, 6)]
        prompts = [rng.integers(3, full.vocab_size, n).astype(np.int32)
                   for n in lens]
        main_path, engine, eager_engine = serve_captured_and_eager(
            torch, build, full, params, prompts)
        launches = main_path["launches"]
        logits, _ = model.prefill(params, {"tokens": torch.as_tensor(
            prompts[0][None, :16].astype(np.int64), device="cuda")}, 16)
        if logits.shape != (1, full.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            fail(f"prefill logits: shape {tuple(logits.shape)}, finite "
                 f"{bool(torch.isfinite(logits).all())}")
        report["graphed_vs_eager"] = graphed_vs_eager(torch, model, params,
                                                      rng)
        report["profile"] = profile_serving(torch, engine, full, params,
                                            prompts[:4])
        report["profile_eager"] = profile_serving(torch, eager_engine, full,
                                                  params, prompts[:4])
        ran = set(report["profile"]["served_kernels"])
        if not set(SERVED) <= ran:
            fail(f"served kernels missing from the captured profile (ran: "
                 f"{sorted(ran)})")
        del eager_engine
        report["decode_layer_launches"] = decode_layer_launches(
            torch, full, params)
        report["main_path"] = main_path
        del engine

    # ---- phase 5: the unfused pipeline at full width ----
    with Phase("5 unfused path", report):
        unfused_launches, report["unfused_path"] = phase_unfused(
            torch, timer, build)
        for name, path in PATHS.items():
            if path == "unfused" and unfused_launches.get(name, 0) <= 0:
                fail(f"kernel {name} was not launched on the unfused path")

    # ---- phase 6: full depth in bp8 ----
    with Phase("6 full depth, bp8", report):
        full8 = dataclasses.replace(full, matmul_mode="bp8")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, _, engine = serve(torch, full8, params, prompts[:2], 8, "cuda")
        first_s = time.perf_counter() - t0
        capture_s = engine.stats.snapshot()["capture_s"]
        out, dt, _ = serve(torch, full8, params, prompts[:2], 8, "cuda",
                           engine)
        n_tok = sum(len(v) for v in out.values())
        peak = torch.cuda.max_memory_allocated() / 1e9
        for rid, toks in out.items():
            if len(toks) != 8 or not all(0 <= t < full.vocab_size
                                         for t in toks):
                fail(f"bp8 request {rid}: bad output {toks}")
        print(f"bp8 full depth: {full8.num_layers} layers, 2 requests "
              f"(prompts {lens[:2]}), {n_tok} tokens, captured, warm: "
              f"{dt:.3f}s = {n_tok / dt:.2f} tok/s (first run {first_s:.3f}s,"
              f" of which warm-ups and captures {capture_s:.3f}s), engine "
              f"steps {engine.step_count // 2}, graphs "
              f"{engine.compile_counts()}, peak device memory {peak:.2f} GB")
        report["bp8_full_depth"] = {
            "encode": encode_forms_ms(torch, timer),
            "seconds": dt, "first_run_s": first_s, "capture_s": capture_s,
            "new_tokens": n_tok, "tokens_per_s": n_tok / dt,
            "engine_steps": engine.step_count // 2, "peak_mem_gb": peak,
            "profile": profile_serving(torch, engine, full8, params,
                                       prompts[:1], 16, 2)}
        del engine

    # ---- phase 7: sampling, the lock-step engine, obs and traffic ----
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with Phase("7 sampling, lock-step engine, obs, traffic", report):
        p7 = {"sampling": sampling_on_card(torch)}
        p7["engines_t08"] = engines_at_temperature(torch, build, full,
                                                   params, rng)
        engine = make_engine(full, params, "cuda", temperature=0.8, seed=7)
        p7["profile_t08"] = profile_serving(torch, engine, full, params,
                                            prompts[:4])
        del engine
        p7["traffic"] = obs_and_traffic(torch, full, params, out_dir)
        for what, prof in (("T 0", report["profile"]),
                           ("T 0.8", p7["profile_t08"])):
            r = prof["host_ranges"].get("paged.sample")
            if r is None:
                fail(f"no paged.sample range in the captured profile, {what}")
            print(f"paged.sample, captured, {what}: {r['ms'] / r['calls']:.3f}"
                  f" ms a call ({r['calls']} calls), {r['share_of_wall']:.3f} "
                  f"of the run's wall")
        report["phase7"] = p7

    # ---- phase 8: training ----
    with Phase("8 training (bp8_fused)", report):
        train_rows = phase_train_kernels(torch, timer)
        p8 = {"card_vs_cpu": train_card_vs_cpu(torch, full)}
        del params
        train_launches, p8["full_depth"] = train_full_depth(torch, build,
                                                            full)
        report["phase8"] = p8

    # ---- phase 9: the Gemma family ----
    with Phase("9 gemma3-12b and paligemma-3b", report):
        gemma_rows, gemma_launches, report["phase9"] = phase_gemma(
            torch, timer, build, log, rng)

    # ---- phase 10: mixture-of-experts and latent attention ----
    with Phase("10 granite-moe-1b, deepseek-v2 and minicpm3", report):
        moe_rows, moe_launches, report["phase10"] = phase_moe(
            torch, timer, build, log, rng)

    # ---- phase 11: the encoder-decoder and the hybrid ----
    with Phase("11 whisper-base and zamba2-2.7b", report):
        eh_rows, eh_launches, report["phase11"] = phase_encdec_hybrid(
            torch, timer, build, rng)

    # ---- phase 12: xlstm and the ring cache ----
    with Phase("12 xlstm-1.3b and the ring cache", report):
        xr_rows, xr_launches, report["phase12"] = phase_xlstm_ring(
            torch, timer, build, rows, rng)

    # ---- phase 13: training the encoder-decoder, hybrid and xlstm ----
    with Phase("13 training whisper-base, zamba2-2.7b and xlstm-1.3b",
               report):
        ft_rows, ft_launches, report["phase13"] = phase_train_families(
            torch, timer, build)

    # ---- phase 14: the distributed layer ----
    with Phase("14 the distributed layer (mesh, sharding, TP, pipeline)",
               report):
        (dist_rows, dist_launches, ring_rows, ring_launches, tp_rows,
         tp_launches, report["phase14"]) = phase_dist(torch, timer, build)

    # ---- phase 15: the OISMA reference and the engine model ----
    with Phase("15 the OISMA reference and the engine model", report):
        oisma_rows, oisma_launches, report["phase15"] = phase_oisma(
            torch, timer, build)

    path_launches = {"serve_bp8_fused": launches, "unfused": unfused_launches,
                     "train_bp8_fused": train_launches,
                     DIST_PATH: dist_launches, SEQ_PATH: ring_launches,
                     TP_PATH: tp_launches,
                     OISMA_REF_PATH: oisma_launches}
    for arch, path in GEMMA_PATHS.items():
        path_launches[path] = gemma_launches[arch]
    for arch, path in MOE_PATHS.items():
        path_launches[path] = moe_launches[arch]
    for arch, path in EH_PATHS.items():
        path_launches[path] = eh_launches[arch]
    path_launches.update(xr_launches)
    for arch, path in FT_PATHS.items():
        path_launches[path] = ft_launches[arch]
    kernels = []
    for name, path, r in ([(n, PATHS[n], rows[n]) for n in SOURCES]
                          + [(n, "train_bp8_fused", r)
                             for n, r in train_rows.items()]
                          + [(n, GEMMA_PATHS[arch], r)
                             for arch, arch_rows in gemma_rows.items()
                             for n, r in arch_rows.items()]
                          + [(n, MOE_PATHS[arch], r)
                             for arch, arch_rows in moe_rows.items()
                             for n, r in arch_rows.items()]
                          + [(n, EH_PATHS[arch], r)
                             for arch, arch_rows in eh_rows.items()
                             for n, r in arch_rows.items()]
                          + [(n, path, r)
                             for path, path_rows in xr_rows.items()
                             for n, r in path_rows.items()]
                          + [(n, FT_PATHS[arch], r)
                             for arch, arch_rows in ft_rows.items()
                             for n, r in arch_rows.items()]
                          + [(n, DIST_PATH, r) for n, r in dist_rows.items()]
                          + [(n, SEQ_PATH, r) for n, r in ring_rows.items()]
                          + [(n, TP_PATH, r) for n, r in tp_rows.items()]
                          + [(n, OISMA_REF_PATH, r)
                             for n, r in oisma_rows.items()]):
        b = r["b"]
        t_bytes = sum(x[1] for x in b)
        t_ops = sum(x[2] for x in b)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "path": path,
            "launches": path_launches[path][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": sum(x[0] for x in b),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": r["library_ms"]})
    report["kernels"] = kernels
    paths = [(k["name"], k["path"]) for k in kernels]
    if len(set(paths)) != len(paths):
        fail(f"kernels line: a (kernel, path) twice in {paths}")
    print("phase seconds: " + ", ".join(
        f"{k.split(' ')[0]} {v:.1f}" for k, v in report["phase_s"].items())
        + f"; in all {sum(report['phase_s'].values()):.1f}")
    (out_dir / "chip_smoke_report.json").write_text(
        json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
