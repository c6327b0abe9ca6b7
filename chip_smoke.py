#!/usr/bin/env python3
"""On-card proof that the PyTorch/CUDA port serves RWKV-4 (exact and
hardware numerics) and RWKV-6 on every weight form (W8, W4, VQ and mixed
planes, plain bf16), with its prefix cache, self-speculative decode, SLO
layer, crash-safe snapshots and fault drills,
and the dense transformer smollm-135m, runs
the RWKV whole-sequence forward, trains smollm-135m, rwkv4-169m and
rwkv6-7b (4 of its 32 layers at full width), and runs the quantized serve step and the Δ-PoT matmuls of its public kernel
entry point, through its kernels.

    python3 chip_smoke.py            (from the root of a checkout, one GPU)

Phases, each of which raises on failure (the script then exits non-zero);
each prints its seconds and peak device memory (`phase_done` lines):

 1. Build: nvcc compiles every `src/repro_torch/csrc/*.cu` for sm_90a, one
    process per source, all started together, into one shared library.
 2. rwkv4-169m kernels at full width (L12 D768 F3072 V50277), each
    against its plain PyTorch version on the same inputs (TF32 off):
      dpot_w8_matmul (K5)      M in {128, 8} x (K, N) in {(768, 768),
                               (768, 3072), (3072, 768), (768, 50277)}
      dpot_w4_matmul (K5-W4)   M in {128, 8} x (K, N) in {(768, 768),
                               (768, 50277)} (att.wk and the head)
      vq_matmul (K5-VQ)        M in {128, 8} x (3072, 768) (ffn.wv)
      wkv4_seq (K2)            (B, T, C) = (8, 16, 768), prefix masks
      rwkv4_block_decode (K3)  B = 8, D = 768, F = 3072, on layer 0 of the
                               W8 tree and of the MIXED tree, on every
                               resident block (the grid is printed) and
                               bit for bit on grids of 1 and 7 blocks
      rwkv4_model_decode (K4)  B = 8, all 12 layers of the prepared MIXED
                               slabs, on every resident block (one
                               cooperative launch, the grid printed); bit
                               for bit equal to 12 K3 launches and to
                               itself on grids of 1 and 7 blocks; timed
                               beside those 12 K3 launches
    Each chunk matmul's decode is checked bit for bit: identity rows pick
    out the decoded plane, which must equal unpack_leaf; its M 8 call's
    rows equal the M 128 call's first rows bit for bit.  One
    `prefill_chunk` (B 8, C 16) is timed on each rwkv4 engine's params
    (and on rwkv6-7b's in phase 5), its K5 launches counted.
    Tolerances, against the plain version's output `ref`:
      K5 (all planes), K2  elementwise |d| <= 2^-7 |ref| + 2^-20 max|ref|:
              both sides accumulate in f32 in another order and round to
              bf16 (K5) or snap a bf16 carry (K2), so an output may move by
              one bf16 step (at most 2^-7 relative), and by nothing more.
      K3      max|d| <= 2^-6 max|ref| and mean|d| <= 2^-11 mean|ref| per
              output: a LayerNorm sum in another order can flip one bf16
              rounding, which then travels through later matvecs as a few
              bf16 steps at most; a misplaced rounding moves most elements
              and shows in the mean.
      K4      first, bit for bit equal to 12 K3 launches on the same
              layers, each of which is held to K3's tolerance against
              K3's plain version on that layer's inputs; then, per
              output, max|d| <= K4_MAX_REL max|ref| and mean|d| <=
              K4_MEAN_REL mean|ref|: K3's flips, carried through 12
              layers of random weights, each moving every later one,
              spread as far as the plain version run on the CPU sits from
              itself on the card (K4_* is 1.25x what that plain pair
              alone reads, PERF.md).
    Times come from CUDA events around single launches, with the 50 MB L2
    flushed (a 512 MB memset) before each, as the serving loop meets them,
    and the card kept busy while the host enqueues the launch (`_time_ms`).
 3. rwkv4-169m engines, two serving paths, each with every launch counter
    set to 0 just before its run and read just after; each kernel of the
    path must have launched.  Each serves 8 seeded requests (prompts of
    5-40 tokens, 32 greedy tokens each) with max_batch=8, prefill_chunk=16,
    and each request's stream must equal the same engine serving it alone,
    bit for bit:
      block  ServingEngine(quantized=True, fused_decode="block",
             fused_prefill=True): W8 weights, K5 + K2 + K3
      model  ServingEngine(quantized=True, plane_policy=MIXED,
             fused_decode="model", fused_prefill=True): W8 / W4 / VQ
             planes, K5 + K5-W4 + K5-VQ + K2 + K4
    Teacher-forced logits of each path's kernels (a 16-token prefill
    chunk, then 32 decode steps) are held with fixed bounds (TF_BOUNDS)
    against an f32 witness of the same model and against the plain bf16
    per-op path on the card; the plain bf16 paths on the card and on the
    CPU are held against the witness beside it, so the line shows how far
    bf16 alone moves the logits (`phase_teacher_forced`).
 4. rwkv4-169m under the paper's hardware numerics (LUT exp, PWL σ, LUT
    division, A9 activations), W8 weights:
      expsig (K9)              exp_kernel and sigmoid_kernel over every f32
                               bit pattern but NaN (2^32 in chunks of
                               2^28, ±inf included) and every bf16 one but
                               NaN: bit for bit against the plain version
                               on the card (a 2^24 sample also against it
                               on the CPU); timed at 2^24 f32
      wkv4_seq (K2-hw)         (8, 16, 768), prefix masks, the bf16 carry,
                               both tables: bit for bit
      dpot_w8_matmul_f32x      (128, 768, 768), att.wo: decode bit for bit,
      (K5 f32-x)               outputs within K·2^-24·(|x| @ |w|); the
                               ptxas lines of its f32-x instances
      rwkv4_block_decode       layer 0, B = 8, with the tables; bit for
      (K3-hw)                  bit on grids of 1 and 7 blocks
      rwkv4_model_decode       the 12 layers of the prepared hw stack; bit
      (K4-hw)                  for bit equal to 12 K3-hw launches and to
                               itself on grids of 1 and 7 blocks
    K9 and K2-hw are bit for bit: every operation is one IEEE rounding
    (hw_units.cuh, -fmad=false) and no sum changes order.  K3-hw is held
    per output within 1.25x the worst relative gap its plain hw version
    reads between the CPU and the card in the same run (K4's recipe), and
    K4-hw within HW_SPREAD (1.25·√2) times that gap over its 12 layers: a
    LayerNorm sum or matvec in another order can flip a bf16 rounding at
    the element that sets an A9 scale, which moves the whole tensor's
    codes, and through 12 layers the kernel and the plain version on the
    card are two such orders (the reason for √2 is at HW_SPREAD).  Then
    the hw greedy run, the way serve_legacy wraps the step: 8 seeded
    prompts of 5-40 tokens through prefill_chunk(hw=True) in chunks of
    16, then greedy_decode over 32 steps, through
    decode_step_fused(hw=True) (K3-hw) and through the prepared K4-hw
    form, each twice (block, model, model, block; a path's rate is over
    its two runs), each run with its counters set to 0
    before and read after (K5, K5 f32-x, K2-hw, K9's σ and K3-hw or
    K4-hw must launch); the two paths' logits equal bit for bit.  Then
    teacher-forced hw logits (a 16-token prefill chunk, 32 K3-hw steps)
    against the plain per-op hw path on the card within 1.25x that plain
    path's CPU-vs-card gap, and the gap from hw to the exact numerics,
    printed as a reading of the paper's accuracy cost with no bound.
 5. rwkv6-7b at full width and depth (L32 D4096 H64 N64 F14336 V65536),
    W8 weights drawn on the card from the seed and packed leaf by leaf,
    one engine at a time (the first is freed before the second draws):
      dpot_w8_matmul (K5)      M in {128, 8} x (K, N) in {(4096, 4096),
                               (4096, 14336), (14336, 4096), (4096, 65536),
                               (4096, 160), (4096, 64), (64, 4096)}; the
                               decode on 128-row identity windows across
                               every slice boundary
      wkv6_seq (K6)            (B, T, H, N) = (8, 16, 64, 64), prefix
                               masks, the bf16 pool state in, bf16 carry
      rwkv6_block_decode (K7)  B = 8, layer 0; a lane alone bit for bit;
                               B = 16 (two 8-lane tiles) bit for bit
                               equal to two 8-lane calls
      rwkv6_model_decode (K7)  B = 8, all 32 layers of the prepared slabs;
                               bit for bit equal to 32 K7-block launches;
                               B = 16 as K7-block
    Tolerances: K5 elementwise as above, its floor the f32 summation bound
    K·2^-24·(|x| @ |w|) (at K = 4096 the order alone moves near-zero
    outputs past 2^-20 max|ref|); K6's final state bit for bit (its update
    has no sum), y elementwise against the plain version and bit for bit
    against the in-order reference (`wkv6_seq_inorder`); K7-block per output within K7B_* (layer 0
    and each of the 32 launches K7-model is held to), 1.25x the worst the
    plain version alone reads between the CPU and the card (a bf16 rounding
    of a 14336-term sum flips under another summation order); K7-model
    over all 32 layers within 1.25x the worst gap the plain version reads
    between the CPU and the card over the same 32 layers.  Then the two engine
    runs of phase 3 on the rwkv6 paths:
      rwkv6-block  fused_decode="block": K5 + K6 + K7-block
      rwkv6-model  fused_decode="model": K5 + K6 + K7-model
    and teacher-forced logits of each against an f32 witness and the plain
    bf16 path on the card (both computed layer by layer, each layer's
    planes decoded inside the loop), with TF_BOUNDS["rwkv6-*"]; the model
    path's logits must equal the block path's bit for bit.  The CPU plain
    pair is left out at 7B (~5 TFLOP on the host).
 6. The RWKV whole-sequence forward (the prefill step of both families):
      fused_layernorm (K11)    (rows, D) in K11_SHAPES: (32768, 4096) and
                               (8192, 768) in bf16 and f32, ragged rows, a
                               D without vector loads; timed at (32768,
                               4096) bf16 with F.layer_norm beside it
      wkv6_chunked_kernel      K10_SHAPES (one chunk; several; T = 96, the
      (K10)                    chunk halving to 32; N = 16; strong decay;
                               the forward's types at B1 T4096 H64 N64),
                               then rwkv6-7b's layer-0 operands at B1
                               T32768 H64 N64 (timed; bit for bit run to
                               run; one call is three CUDA launches)
    Tolerances: K11 one step of the output's type plus the f32 sum-order
    bound `_ln_floor`; K10 y and the final state within `_k10_bound`,
    (8·G + 2C + 2N + 16)·2^-24 of each output's magnitude (the plain
    version on absolute values) plus 2C·2^-23·max|log w| of it.  Then:
      rwkv4    rwkv4-169m at full width and depth, B 8, S 1024, bf16
               weights from the seed, exact and hw: build_prefill_step
               with every counter set to 0 just before and read just after
               (K11 26, K2 12; under hw K9 24), step ms, tokens/s, peak
               memory; K2 (K2-hw) on layer 0's operands at the forward's
               shape (B8 T1024 C768, zero state, no mask, f32 carry)
               against its plain version, elementwise as in phase 2 (bit
               for bit under hw); logits within RWKV4_FWD_BOUNDS of the
               plain path (the plain versions on the card) and an f32
               witness
      rwkv6    rwkv6-7b at full width and depth, bf16 weights drawn after
               the rwkv6 engines are freed, B 1, S 32768: K10 32, K11 66,
               no K6; finite logits; step ms, tokens/s, peak memory beside
               the matmul bound; at B 2, S 512 the logits within
               RWKV6_FWD_BOUNDS of the plain path and the f32 witness; at
               S 40, K6 32 and no K10, and K6 on layer 0's operands there
               (B2 T40 H64 N64, zero f32 state, no mask) against its
               plain version and the in-order reference, as in phase 5,
               and timed
 7. smollm-135m, the dense transformer, at full width and depth (L30
    D576 H9 KVH3 hd64 F1536 V49152, RMSNorm, SwiGLU, RoPE, tied), bf16
    weights drawn on the card from the seed:
      flash_attention (K13)    (B, S, H, KVH, d) = (8, 2048, 9, 3, 64)
                               causal bf16 (timed, SDPA beside it), S 512
                               and 600 (ragged), non-causal S 1000, d 96
                               (H 32 = KVH) and d 128 (H 24, KVH 8; timed,
                               SDPA beside it) at B 2, S 1024, f32 at S
                               700; the lse each time; the ptxas lines of
                               the bf16 tensor-core instances
    Tolerance: bf16 outputs within one bf16 step (2^-7 |ref|), f32 within
    2^-22 |ref|, each plus the f32 summation bound (Skv + d + 8)·2^-24·
    (p @ |v|) / l of that output (`_attn_floor`): both sides compute in
    f32 from the same inputs and sum in other orders.  Then:
      prefill  build_prefill_step on use_flash_kernel=True at B 8, S 2048,
               K13's counter set to 0 just before and read just after (it
               must read 30, one launch a layer); its logits against the
               plain-attention forward on the card and an f32 witness,
               within PREFILL_BOUNDS (TF_BOUNDS' recipe); the step timed
               beside the plain-attention step
      decode   serve_legacy (8 lanes, 32 greedy steps through the KV
               cache), then the K13 forward at B 8, S 512 against the
               per-token decode_step chain over the same tokens, within
               DECODE_SPREAD (1.25·√2) times the larger of the two
               paths' gaps to the f32 witness, read in the run
 8. smollm-135m's training at full width and depth:
      flash_attention_dq       K13_BWD_SHAPES: the train shape (B8 S2048
      (K13-dq),                H9 KVH3 d64, causal, bf16; timed, with the
      flash_attention_dkv      plain backward and SDPA's backward less its
      (K13-dkv)                forward beside it, and run twice: bit for
                               bit), test_torch_flash.py's shapes in f32,
                               phi3's d 96 (B2 S1024 H32) and d 128 (B2
                               S1024 H24 KVH8; timed as the train shape)
                               in bf16; the ptxas lines of the bf16
                               tensor-core instances
    Tolerance (`bwd_bounds`): one step of the output's type plus the f32
    summation floor (rep·Sq + Skv + d + 8)·2^-24 times the magnitude of
    what each output sums, ds's own error carried through; for bf16 dk and
    dv also rep·2^-8 times the group's per-head magnitudes, since the
    plain version rounds each query head and adds the group in bf16, as
    JAX does, where the kernel sums the group in f32 and rounds once.
    Then:
      train    step 0 through `loss_and_grads` at B 8, S 2048 (SyntheticLM
               tokens, f32 master weights from the seed, remat): K13's
               counters set to 0 just before and read just after (60
               forward, the forward and its recompute, 30 dq, 30 dkv, and
               the loss's K12 and K12-bwd once each);
               its loss and gradients per leaf against the plain-attention
               step and an f32 witness within TRAIN_BOUNDS (1.25x, and
               1.25·√2x, the plain path's first reading against the
               witness: TF_BOUNDS' recipe); one plain-attention
               step timed; then `train_model` for 3 AdamW steps, the
               counters again (3 x 60, 30, 30, 1, 1), finite losses, each step's
               ms, tokens/s and the peak device memory beside the step's
               operations bound (`_train_ops`, ~23.1 TFLOP); one more
               step split into the host's enqueue time, the whole step
               and the device's span (events), and a profiled one for
               the device's busy time and its 8 largest names
 9. rwkv4-169m's training at full width and depth:
      fused_cross_entropy      (rows, V) = (8192, 50277) (rwkv4's train
      (K12), _bwd (K12-bwd)    step) and (16384, 49152) (smollm's), bf16:
                               the NLL within 2^-16 + 2^-21 |ref| of the
                               plain version, the gradient through the
                               autograd Function within one bf16 step plus
                               2^-16 |g|·p (p the entry's probability) of
                               the plain version's autograd one; the
                               backward twice, bit for bit; timed
                               beside the plain version and F.cross_entropy
                               (forward, and autograd backward)
      wkv4_seq_bwd (K2-bwd)    layer 0's WKV operands of the train step
                               (B8 T1024 C768, zero state), per output max
                               2^-10 of max|ref|, mean 2^-13 of mean|ref|
                               against the plain version's autograd
                               gradient; bit for bit run to run
      fused_layernorm_bwd      layer 0's ln1 operands ((8192, 768) bf16):
      (K11-bwd)                one bf16 step plus the sum-order floors of
                               its row means and column sums; bit for bit
                               run to run; F.layer_norm's backward beside
    Then:
      train    step 0 through `loss_and_grads` at B 8, S 1024 (SyntheticLM
               tokens, f32 masters from the seed, remat), every counter set
               to 0 just before and read just after (K11 50, K11-bwd 26,
               K2 24, K2-bwd 12, K12 1, K12-bwd 1); loss and gradients per
               leaf against the plain path (the plain versions of K2, K11
               and K12 on the card, timed) and an f32 witness within
               RWKV4_TRAIN_BOUNDS (TRAIN_BOUNDS' recipe); then
               `train_model` for 3 AdamW steps, the counters again (3x),
               each step's ms, tokens/s and peak memory beside the step's
               operations bound (~7.93 TFLOP); the trained params through
               an AsyncCheckpointer into build/ and back, bit for bit
10. The quantized serve step and the public kernel entry point (run where
    their weights are at hand: the rwkv4 part after phase 4, the rest
    after phase 5's model-path engine, on its packed W8 tree, before
    phase 6):
      quantized step           build_serve_step(variant="quantized") at
                               B 128 (decode_32k's batch) on the engines'
                               packed W8 trees, rwkv4-169m and rwkv6-7b
                               at full width and depth: a warm step and 3
                               timed ones (ms a step, tokens/s, peak
                               memory); every step's logits and the final
                               state bit for bit equal to the base step on
                               unpack_params(tree); no kernel launches
      serve_legacy             rwkv4-169m, quantized=True (JAX's batch 4,
                               32 tokens): tokens/s; its fake-quantized
                               tree bit for bit equal, leaf by leaf, to
                               the same weights fake-quantized on the CPU
      dpot_matmul (K1),        through repro_torch.kernels.ops, M in {8,
      dpot_matmul_w4 (K8)      128} with bf16 x, on rwkv6-7b's layer-0
                               att.wr (4096 x 4096), ffn.wk (4096 x
                               14336), ffn.wv (14336 x 4096) and head
                               (4096 x 65536), W8 as packed and W4 packed
                               from them by pack_leaf; K8 also on
                               rwkv4-169m MIXED's W4 att.wk (768 x 768)
                               and head (768 x 50277); K1 at bench_kernels'
                               (8, 1024, 1024) with f32 x.  The counted
                               run calls each case once (9 K1, 12 K8).
                               Both are the EXACT instances of K5's
                               tensor-core kernel (csrc/chunk_matmul.cu):
                               each row's bound is max(bytes / 3.35 TB/s,
                               pieces·2·M·K·N / 989 TFLOP/s bf16), pieces
                               the MMAs a weight (K1 2 or 6, K8 1 or 3 for
                               a bf16 or f32 x), the f32 CUDA-core figure
                               (2·M·K·N / 67 TFLOP/s) beside it
    Tolerances (`phase_k1_k8`): against the plain version on the card,
    each output within K·2^-24·(|x| @ |w|) plus one step of its type (each
    row prints max |d| / that bound), and the decode bit for bit (identity
    rows: 128 rows of each plane, and every code at its column scales);
    against the quantized step's own bf16 product x @ unpack_leaf(leaf),
    within 2^-8·(|x| @ |w|) plus one bf16 step.
11. The other weight forms of the decode and prefill kernels (run where
    their weights are at hand: rwkv4 after phase 3 and in phase 4, the
    MIXED rwkv6 engine after phase 10's rwkv6 part, K7 on bf16 in phase 6
    before K10):
      rwkv4 bf16               ServingEngine(quantized=False,
                               fused_decode="model", fused_prefill=True):
                               K3 on layer 0 (K3's rule), K4 over the 12
                               layers (bit for bit 12 K3 launches; K4's
                               recipe, 1.25x its plain version's
                               CPU-vs-card gap, read in the run: K4_*
                               holds MIXED's reading), the engine run
                               (K2 + K4), one
                               decode_step_fused step (K3)
      K5-W4, K5-VQ f32-x       (128, 768, 768) on att.wo of trees packed
                               all W4 and all VQ, beside K5 f32-x: decode
                               bit for bit, the f32 summation bound; then
                               prefill_chunk(hw=True) on each tree (B 8, C
                               16, prefix masks): the f32-x form once a
                               layer, logits and state within 1.25x the
                               per-op hw path's CPU-vs-card gap
      rwkv6 MIXED              ServingEngine(plane_policy=MIXED,
                               fused_decode="model", fused_prefill=True) at
                               full width and depth: K7-model bit for bit
                               32 K7-block launches, each within K7B_* of
                               the plain version on the card; a lane alone
                               bit for bit; the W4 and VQ decodes on
                               identity windows; the engine run (K5,
                               K5-W4, K5-VQ, K6, K7-model); teacher-forced
                               logits within TF_BOUNDS["rwkv6-model"]'s
                               kernel-vs-plain bounds of the plain bf16
                               path on the same tree; one
                               decode_step_fused step (K7-block)
      rwkv6 bf16               K7 on phase 6's bf16 tree as MIXED (its slab
                               stack built there, 15 GB, and dropped before
                               K10), one step through each kernel path
12. The rest of the engine, plan and registry (run where their weights
    are at hand):
      engine runs   every phase-3-style engine run (`phase_engine`) now
                    attaches fresh ServingCounters and asserts their counts
                    (8 admitted and finished, 256 decode tokens, the
                    prompts' sum of prefill tokens, 8 TTFT samples) and
                    trace_counts {"decode": 1, "prefill": 1}; its line
                    carries TTFT, inter-token latency and occupancy
      all logits    prefill_chunk_logits against prefill_chunk on the W8
                    trees of rwkv4-169m (after phase 3) and rwkv6-7b
                    (after phase 5), B 8, C 16, prefix masks: row
                    n_valid - 1 and the states bit for bit, invalid rows
                    zero; the head's K5 alone at M 128 timed beside its
                    plain version and torch.matmul
      state dtype   an rwkv4-169m per-op engine with an f32 pool serves 8
                    requests, each equal to itself served alone; an f32
                    state on each fused path raises in build_plan with
                    every serving counter at 0 (after phase 10's rwkv4
                    part), then greedy_decode with sample_temp 0.8: the
                    same generator seed, the same tokens; temperature 0,
                    the greedy stream
      truncated     rwkv6-7b's model-path engine cut to 4 of 32 layers
                    (truncate_params): one prefill chunk (K5 + K6) and 8
                    K7-model steps give truncate_state of the full
                    model's state, bit for bit
      serve trained phase 9's trained and checkpoint-restored rwkv4-169m
                    tree through ServingEngine(params=, quantized=True,
                    fused_decode="model", fused_prefill=True): the plan
                    serves the trained codes (a leaf's checksum), the
                    engine run (K5, K2, K4), teacher-forced logits within
                    TF_BOUNDS["model"], then one request cancelled after
                    4 ticks: outcome "cancelled", the others' streams
                    unchanged
13. The prefix cache and self-speculative decode (run after the all-
    logits phases, on the engines' own weight draws through `_replan`):
      prefix cache  rwkv4-169m MIXED, model path, chunked prefill, 8
                    slots, chunk 16: 8 requests sharing a 64-token prefix
                    after a warm-up request: 8 hits, cached_tokens 512,
                    prefill_tokens the suffixes' sum, streams bit for bit
                    a cacheless engine's, K4, K5 and K2 launched,
                    trace_counts 1 / 1, check_state; device_slots 1 and
                    host_slots 8 (spills, host hits, the same streams); a
                    W8 engine sharing the cache gets no hit.  rwkv6-7b W8
                    model path: a second request resumes a 32-token
                    prefix, bit for bit; one lane state's bytes
      speculative   rwkv4-169m MIXED model path, phase_engine's 8 requests
                    × 32 tokens, k 1, 2, 4 at draft depth 6 (K4 on the
                    truncated stack): identity (a) (the real drafter's
                    stream equal to an all-reject and an all-accept
                    stub's, greedy and sampled at 0.8), JAX's
                    trace_counts, drafted = accepted + rejected, the
                    rollback snapshot intact after every draft and verify;
                    a request cancelled from its own on_token mid-tick;
                    aligned weights (att.wo, ffn.wv zero past layer 0),
                    depth 1 (K3), k 4: acceptance >= 0.9; a cache hit then
                    speculation; identity (c): verify rows teacher-forced
                    within TF_BOUNDS["model"]; finding (d): k 1 against k
                    4 streams, and op by op where one window of 4 and four
                    of 1 first differ; K2 at T 1, 2, 4 and the head's K5-W4
                    at M 8·k against their plain versions; tokens/s at
                    each k beside the plain engine's; the verify logits'
                    host copy.  rwkv6-7b W8 model path, k 4, depth 16
                    (K7-model on 16 layers): identity (a) with the reject
                    stub, trace_counts, K6 at T 1, 2, 4
14. The SLO layer, crash-safe snapshots and fault drills, on rwkv4-169m's
    MIXED model path at full width (K4, K5 / -W4 / -VQ, K2; 8 slots,
    chunk 16), run after the speculative phase; each drill against the
    streams of a run that never crashed or was never poisoned, bit for bit:
      crash resume  phase_engine's 8 requests × 32 tokens (odd ones
                    sampled), a snapshot every 2 ticks, EngineCrash at tick
                    3, ServingEngine.restore (the plan rebuilt from the
                    seed, its weights' checksums verified), drain; the same
                    with k 2 (K4 drafting on 6 layers, K5 + K2 verifying)
                    and with the prefix cache (64-token shared prefix);
                    a child process (`chip_smoke.py --crash-child DIR
                    TICK`, its output kept apart) SIGKILLed at tick 17 by
                    `crash_at_tick` "sigkill", restored by this process
      faults        a lane poisoned with NaN at tick 4, quarantined by the
                    sentinel and replayed; a burst of 12 past max_queue 4
                    under backpressure (8 refused) and under shed (8
                    shed); deadlines on a fake clock (4 evicted, the other
                    4 streams unchanged)
      given weights after phase 9: the trained tree served with params=,
                    crashed at tick 5, restored with params= (without it
                    ValueError, with the seed's weights IntegrityError)
    Each line carries K4 / K5 / K2 launches, the snapshot save time (the
    synchronous part: a capture, and the join of the previous background
    write) and one capture alone, the bytes on disk, the restore time, the
    weights' checksum time and the card's name and power limit.
15. The `kernels` JSON line (thirty-three entries: the nine kernels, then
    K9 and the hardware-numerics forms of K2, K5, K3 and K4, then K13,
    K13-dq and K13-dkv, then K10 and K11, then K12, K12-bwd, K2-bwd and
    K11-bwd, then K1 and K8, then phase 11's forms: K3 and K4 on bf16,
    K5-W4 and K5-VQ f32-x, K7-block and K7-model on MIXED and on bf16;
    the entries of K2, K2-hw and K6 carry their forward-shape checks under
    "forward_check", their errors in max_abs_err and their shapes in
    shapes; K5's entry carries the head at M 128 of both models under
    "all_logits_head", K5-W4's the MIXED head at M 8·k under
    "verify_head", K2's and K6's the verify windows under
    "verify_windows"; then, from phase 16, K10-bwd and K6-bwd: thirty-five
    entries), the card's name and power limit, and the last line {"ok":
    true, "device": {...}}.
16. rwkv6-7b's training at full width (D 4096, H 64, N 64, F 14336, V
    65536), cut to 4 of its 32 layers (f32 masters, gradients and AdamW
    moments of the full depth need ~120 GB), run last:
      wkv6_chunked_bwd         layer 0's WKV operands of the train step
      (K10-bwd)                (B4 T1024 H64 N64, bf16 r, k, v, f32 w,
                               the zero state) and an f32 instance: through
                               the autograd Function against the plain
                               version of its passes on the card, per
                               output max 2^-10 (bf16 outputs 2^-7) and
                               mean 2^-13 of the magnitude of what it sums,
                               plus a log's last bit (`_wkv6_bwd_ok`); bit
                               for bit run to run; timed beside the plain
                               version and its bound
      wkv6_seq_bwd (K6-bwd)    the same at B2 T40 H64 N64 (f32), the K6
                               route's step
    Then:
      train    step 0 through `loss_and_grads` at B 4, S 1024, every
               counter set to 0 just before and read just after (K11 18,
               K11-bwd 10, K10 8, K10-bwd 4, K12 1, K12-bwd 1); loss and
               gradients per leaf against the plain path (the plain
               versions of K10, K11 and K12 on the card, timed) and an f32
               witness within RWKV6_TRAIN_BOUNDS; `train_model` for 3
               AdamW steps, the counters again (3x), each step's ms,
               tokens/s and peak memory beside the step's operations bound;
               one more step split (`_step_split`); then step 0 at B 2, S
               40 (K6 8, K6-bwd 4, no K10), its gradients finite and as
               near the f32 witness as 1.25·√2 times the plain path's.
17. The training drill and the analysis tools:
      train_drill  (after phase 9's restore) the example's fault drill,
                   `examples/train_rwkv4_torch.py`'s `run_drill` on
                   rwkv4-mini (L6 D384 F1536 V8192, f32), B 16, S 128,
                   100 steps under TrainingSupervisor, a checkpoint every
                   10, a HostFailure at step 60, the restore: params bit
                   for bit equal to the committed checkpoint, one restart,
                   JAX's log strings, K2, K2-bwd, K11, K11-bwd, K12 and
                   K12-bwd launched for every step run, the loss down,
                   and `train_model` resumed from the same checkpoint
                   ending on the same params bit for bit (deterministic
                   algorithms scoped to the phase)
      split        phase_split's readings, each taken where its model is
                   built (`_reading`): one decode tick of the rwkv4 MIXED
                   and the rwkv6-7b W8 model-path engines
                   (`phase_decode_tick`), each prefill chunk of phase 2
                   and 5, the rwkv6-7b forward at B 1, S 32768, and the
                   rwkv6-7b train step by model line: host enqueue, whole
                   call, device span and busy time and device time by
                   kernel name (by model line and op for the train step)
                   from torch.profiler, beside `launch/op_analysis.py`'s
                   count of one more call on the same CUDA tensors and its
                   roofline (`launch/roofline.py`)
      dryrun       `python -m repro_torch.launch.dryrun --rwkv4`, a child
                   process started after the build and waited for last:
                   every cell of ASSIGNED_ARCHS and RWKV4_ARCHS x SHAPES
                   counted at full size on meta tensors; one line per cell
                   and the ok / skip / error counts; an error fails

Weights are random, from a seed.  Imports nothing of JAX.
"""
from __future__ import annotations

import atexit
import contextlib
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
import types
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

SEED = 0
DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
PEAK_BF16_FLOPS = 989e12       # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12         # H100 SXM f32 outside the tensor cores
REPS = 10
SLEEP_CYCLES = 4_000_000       # ~2 ms at the H100's 1.98 GHz boost clock
# Teacher-forced bounds on the kernel paths' logits (phase_teacher_forced),
# per path: 1.25x what that path's plain bf16 paths alone read on an H100.
#   block (PERF.md, PR 11 run 4): to the f32 witness mean 0.01409 (card) /
#     0.01403 (CPU), max 0.0143 of max|f32|, argmax agreement 0.9545 at the
#     least; CPU vs card mean 0.01511, max 0.0163 of max|ref|.
#   model, MIXED planes (PERF.md, PR 12 run 2): to the f32 witness mean
#     0.014061, max 0.01480 of max|f32|, argmax agreement 0.9394, outside
#     the block path's 0.94, so the path has its own constants; against the
#     plain path it keeps the block path's (run 3 reads its CPU-vs-card
#     pair beside them).
TF_BOUNDS = {
    "block": {"mean_rel_f32": 0.018,    # mean |d| / mean |f32|, witness
              "max_rel_f32": 0.018,     # max |d| / max |f32|, witness
              "argmax_f32": 0.94,       # argmax agreement with the witness
              "mean_rel_plain": 0.019,  # mean |d| / mean |ref|, plain path
              "max_rel_plain": 0.021},  # max |d| / max |ref|, plain path
    "model": {"mean_rel_f32": 0.0176, "max_rel_f32": 0.0185,
              "argmax_f32": 0.924, "mean_rel_plain": 0.019,
              "max_rel_plain": 0.021},
    # rwkv6-7b, both paths: 1.25x what the plain bf16 path on the card read
    # against the f32 witness in its first run (PERF.md §6: mean 0.31395, max
    # 1.6428 of max|f32| 4.9809, argmax agreement 0.39394: its disagreement
    # 1.25x), and for kernel vs plain, two bf16 paths each that far from
    # the witness, 1.25·√2x (max relative to max|plain| 5.15625).  Rounding
    # noise grows through 32 layers of random weights until every bf16
    # path sits ~31% from the witness, so these catch only a gross fault;
    # the model path's logits are also held bit for bit to the block
    # path's (phase_teacher_forced6), and the kernels per layer (phase 4).
    "rwkv6-block": {"mean_rel_f32": 0.3924, "max_rel_f32": 0.4123,
                    "argmax_f32": 0.2424, "mean_rel_plain": 0.5550,
                    "max_rel_plain": 0.5632},
    "rwkv6-model": {"mean_rel_f32": 0.3924, "max_rel_f32": 0.4123,
                    "argmax_f32": 0.2424, "mean_rel_plain": 0.5550,
                    "max_rel_plain": 0.5632},
}
# K3 against its plain version (phase 2), per output, relative to max|ref|
# and mean|ref| (the reason is in the docstring)
K3_MAX_REL, K3_MEAN_REL = 2.0 ** -6, 2.0 ** -11
# K4 against its plain version (phase 2): 1.25x the plain version's own
# CPU-vs-card gap alone, the largest over the six outputs (PERF.md, PR 12
# run 2: max 0.01136 of max|ref|, mean 0.005799 of mean|ref|)
K4_MAX_REL, K4_MEAN_REL = 0.0142, 0.00725
# K7-block against its plain version, per output (layer 0, and each of
# the 32 launches K7-model is held to): max |d| <= K7B_MAX_REL max|ref| and
# mean |d| <= K7B_MEAN_REL mean|ref|, 1.25x the worst the plain version
# alone reads between the CPU and the card over all 32 layers and the four
# outputs (PERF.md §6, K7: max 0.007843, mean 0.0009667), as K4_*
# are.  K3's 2^-11 mean does not hold at rwkv6-7b's width: the bf16
# rounding of a 14336-term sum flips under another summation order on a
# sizeable share of the outputs, the plain version's CPU run as much as
# the kernel (the K7 phases print that pair every run).  K7-model over all
# 32 layers is held to 1.25x the worst relative gap the plain version
# reads between the CPU and the card over the same 32 layers, computed in
# the run: through 32 layers of random weights a flip moves every later
# layer, and the gap grows to ~2% of mean|ref| (PERF.md §6, K7).
K7B_MAX_REL, K7B_MEAN_REL = 0.0098, 0.00121
# K4-hw against its plain hw version on the card: within HW_SPREAD times
# the worst relative gap that plain version reads between the CPU and the
# card in the same run.  K4's 1.25x failed for a right K4-hw (PERF.md §6,
# the hardware numerics: x mean gap 0.01746 against the plain pair's
# 0.01372, 1.27x, with K4-hw equal to 12 K3-hw launches bit for bit):
# through 12 layers A9 turns each flipped bf16 rounding into a moved
# scale, and the kernel's k-ordered sums and the card's cuBLAS order are
# two independent orders, each about as far from a third as the CPU's,
# so their gap may reach √2 times the pair's (as the rwkv6 TF_BOUNDS'
# 1.25·√2 allow).  K3-hw (one layer) and the hw teacher-forced logits
# keep K4's 1.25x.
HW_SPREAD = 1.25 * 2 ** 0.5
# smollm-135m's prefill logits (phase_prefill), the TF_BOUNDS recipe:
# 1.25x what the plain-attention bf16 path read against the f32 witness
# on an H100 (PERF.md §6, the first smollm-135m reading: mean 0.024553,
# max 0.032391 of max|f32|, argmax agreement 0.93774, its disagreement
# 1.25x), and for
# the kernel path against the plain one, two bf16 paths each that far
# from the witness, 1.25·√2x (the rwkv6 recipe).  Through 30 layers of
# random weights every bf16 path sits ~2.5% from the witness and the two
# paths ~2.3% from each other, so these catch a gross fault; K13 itself
# is held per shape in phase_k13.
PREFILL_BOUNDS = {"mean_rel_f32": 0.0307, "max_rel_f32": 0.0405,
                  "argmax_f32": 0.922, "mean_rel_plain": 0.0434,
                  "max_rel_plain": 0.0573}
# the decode chain against the K13 forward (phase_decode): two bf16 paths
# summing in other orders, each a bf16 noise distance from the f32
# witness, so their gap may reach √2 times the larger of those distances
# (the rwkv6 TF_BOUNDS' reasoning), with a quarter of headroom
DECODE_SPREAD = 1.25 * 2 ** 0.5
# the MIXED plane policy: W4 for att.wk and the head, VQ for ffn.wv, W8
# elsewhere (tests/test_fused_decode.py), so every decode branch runs
MIXED_OVERRIDES = ((r"\['att'\]\['wk'\]", "w4"),
                   (r"\['ffn'\]\['wv'\]", "vq"),
                   (r"\['head'\]", "w4"))


def _bound(nbytes: float, ops: float, peak: float):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _time_ms(fn, flush, reps: int = REPS, sleeps: int = 1) -> float:
    """Device time of one call of `fn`, L2-cold, averaged over `reps`: a
    512 MB memset flushes the L2, then a device-side sleep (`sleeps` times
    SLEEP_CYCLES, for a call that enqueues many launches) keeps the card
    busy while the host runs the wrapper and enqueues the launch, so the
    events bracket the device's work and not the host's."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES * sleeps)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / reps


def _elementwise_ok(out, ref, floor=None):
    """|d| <= 2^-7 |ref| + floor, the floor 2^-20 max|ref| unless given."""
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    if floor is None:
        floor = 2.0 ** -20 * r.max()
    ok = bool((d <= 2.0 ** -7 * r + floor).all())
    return ok, float(d.max())


def _sum_order_floor(x, w_bf):
    """The f32 summation bound K·2^-24·(|x| @ |w|) of each output: two
    sums of the same K products in other orders differ by at most that,
    which near a zero output can pass 2^-7 of it."""
    from repro_torch.device import exact_matmuls
    with exact_matmuls():
        return x.shape[1] * 2.0 ** -24 * (x.float().abs()
                                          @ w_bf.float().abs())


def _spread_ok(out, ref, max_rel, mean_rel):
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    ok = bool(d.max() <= max_rel * r.max()) and bool(
        d.mean() <= mean_rel * r.mean())
    return ok, float(d.max()), float(d.mean() / r.mean())


def _line(obj):
    print(json.dumps(obj), flush=True)


def phase_build():
    from repro_torch.kernels.build import build, load_library
    t0 = time.perf_counter()
    _, log = build()
    load_library()
    usage = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln
             or "Compiling entry" in ln]
    _BUILD_USAGE[:] = usage
    _line({"phase": "build", "seconds": time.perf_counter() - t0,
           "ptxas": usage})
    return usage


# the build's ptxas lines (phase_build), for rows that print a kernel's
_BUILD_USAGE: list = []


def _k2_ptxas(hw, mask, snap):
    """The ptxas lines of K2's instances for one form (both copy widths:
    csrc/wkv4_seq.cu's template <HW, VEC, MASK, SNAP>)."""
    b = lambda f: f"Lb{int(f)}E"
    return _registers(_BUILD_USAGE, "wkv4_seq_kernelI" + b(hw) + "Lb.E"
                      + b(mask) + b(snap))


def _registers(usage, kernel):
    """The ptxas lines of the entry functions whose (mangled) name matches
    the regular expression `kernel`: the entry, then its register and
    spill lines."""
    out, keep = [], False
    for ln in usage:
        if "Compiling entry" in ln:
            keep = re.search(kernel, ln) is not None
        if keep:
            out.append(ln)
    return out


def _eye_windows(K, plan, rows=128):
    """Identity-row windows of `rows` rows that cross every slice boundary
    of `plan` (and cover row 0 and row K - 1): (first row, x) pairs, x
    picking out rows first .. first + rows - 1 of the decoded plane."""
    rows = min(rows, K)
    firsts = sorted({max(0, min(K - rows, b - rows // 2)) for b in
                     [0, K] + [s * plan.slice_len
                               for s in range(1, plan.slices)]})
    out = []
    for r0 in firsts:
        x = torch.zeros((rows, K), dtype=torch.bfloat16, device=DEV)
        x[torch.arange(rows), r0 + torch.arange(rows)] = 1
        out.append((r0, x))
    return out


def phase_k5(params, cfg, flush, wide=False):
    """K5 at the (K, N) of a model's matmuls and its head (at rwkv6-7b
    also the low-rank maa_w1, td_w1 and td_w2), M = 128 (a prefill chunk
    of 8 lanes) and 8 (a decode step; its x the first 8 rows of the M
    128 call's, whose outputs it must equal bit for bit).  The decode is
    checked bit for bit: at rwkv4-169m by the whole identity, at rwkv6-7b
    (`wide`) by 128-row identity windows across every slice boundary of
    the plan.  There the elementwise rule's floor is the f32 summation
    bound (`_sum_order_floor`): with K = 4096 the order alone moves
    near-zero outputs by more than 2^-20 max|ref| (PERF.md §6, K7).  Each
    row carries the plan's blocks and slices."""
    from repro_torch.core.quant.serving import unpack_leaf
    from repro_torch.device import exact_matmuls
    from repro_torch.kernels.fused_prefill import (
        chunk_matmul_plan, dpot_w8_matmul, dpot_w8_matmul_plain)
    blocks = params["blocks"]
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab
    leaves = {"att.wr": blocks["att"]["wr"], "ffn.wk": blocks["ffn"]["wk"],
              "ffn.wv": blocks["ffn"]["wv"], "head": params["head"]}
    for k in ("maa_w1", "td_w1", "td_w2"):
        if k in blocks["att"]:
            leaves[k] = blocks["att"][k]
    gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    rows = []

    def lib_ms(x, w_bf):
        with exact_matmuls():     # f32 reductions, as K5 and its plain
            return _time_ms(lambda: torch.matmul(x, w_bf), flush)
    for what, leaf in leaves.items():
        wq = leaf["packed"] if leaf["packed"].dim() == 2 else \
            leaf["packed"][0]
        scale = leaf["scale"].reshape(-1)
        K, N = wq.shape
        w_bf = unpack_leaf({"packed": wq, "scale": scale.reshape(1, -1)})
        plan = chunk_matmul_plan(128, K, N)
        # bit-exact decode: identity rows pick out the decoded weights
        if wide:
            for r0, eye in _eye_windows(K, plan):
                if not torch.equal(dpot_w8_matmul(eye, wq, scale),
                                   w_bf[r0:r0 + eye.shape[0]]):
                    raise AssertionError(
                        f"K5 W8 decode differs from unpack_leaf at (K, N) "
                        f"= {(K, N)}, rows {r0}..")
        else:
            eye = torch.eye(K, dtype=torch.bfloat16, device=DEV)
            if not torch.equal(dpot_w8_matmul(eye, wq, scale), w_bf):
                raise AssertionError(f"K5 W8 decode differs from "
                                     f"unpack_leaf at (K, N) = {(K, N)}")
        x128 = torch.randn((128, K), generator=gen, device=DEV).to(
            torch.bfloat16)
        out128 = None
        for M in (128, 8):
            x = x128[:M]
            out = dpot_w8_matmul(x, wq, scale)
            ref = dpot_w8_matmul_plain(x, wq, scale)
            ok, err = _elementwise_ok(
                out, ref, _sum_order_floor(x, w_bf) if wide else None)
            if not ok:
                raise AssertionError(f"K5 {(M, K, N)}: max |d| {err}")
            if out128 is None:
                out128 = out
            elif not torch.equal(out, out128[:M]):
                raise AssertionError(f"K5 {(M, K, N)}: rows differ from "
                                     "the first rows of the M 128 call")
            nbytes = M * K * 2 + K * N + N * 4 + M * N * 2
            bms, by = _bound(nbytes, 2.0 * M * N * K, PEAK_BF16_FLOPS)
            p = chunk_matmul_plan(M, K, N)
            row = {"kernel": "dpot_w8_matmul", "model": cfg.name,
                   "matrix": what, "M": M, "K": K, "N": N,
                   "max_abs_err": err, "decode_bit_exact": True,
                   "rows_equal_m128": True, "blocks": p.blocks,
                   "slices": p.slices,
                   "kernel_ms": _time_ms(
                       lambda: dpot_w8_matmul(x, wq, scale), flush),
                   "plain_ms": _time_ms(
                       lambda: dpot_w8_matmul_plain(x, wq, scale), flush),
                   "library_ms": lib_ms(x, w_bf),
                   "bound_ms": bms, "bound_by": by}
            _line(row)
            rows.append(row)
    return rows


def phase_k5_planes(params, cfg, flush, wide=False):
    """K5-W4 on att.wk (layer 0) and the head, K5-VQ on ffn.wv (layer 0)
    of the MIXED tree: decode bit-exact against unpack_leaf, outputs
    against the plain versions, the M 8 call's rows equal to the M 128
    call's first rows, times beside the byte bound.  At rwkv6-7b (`wide`)
    the decode is checked as `phase_k5` checks it there, on 128-row
    identity windows across every slice boundary of the plane's plan, and
    the elementwise rule's floor is the f32 summation bound
    (`_sum_order_floor`)."""
    from repro_torch.core.quant.serving import leaf_plane, unpack_leaf
    from repro_torch.device import exact_matmuls
    from repro_torch.kernels.fused_prefill import (
        chunk_matmul_plan, dpot_w4_matmul, dpot_w4_matmul_plain, vq_matmul,
        vq_matmul_plain)
    blocks = params["blocks"]
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab
    wk, wv, head = blocks["att"]["wk"], blocks["ffn"]["wv"], params["head"]
    w4 = lambda codes, scale: ({"packed4": codes, "scale": scale[None]},
                               dpot_w4_matmul, dpot_w4_matmul_plain)
    cases = [((D, D), wk["packed4"][0], wk["scale"].reshape(-1)),
             ((D, V), head["packed4"], head["scale"].reshape(-1)),
             ((F, D), wv["vq_idx"][0], wv["codebook"].reshape(-1))]
    gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
    rows = []
    for (K, N), codes, aux in cases:
        if codes.shape[0] == K:           # VQ indices (K, N)
            leaf, fn, plain = ({"vq_idx": codes, "codebook": aux},
                               vq_matmul, vq_matmul_plain)
        else:                             # W4 nibble pairs (K/2, N)
            leaf, fn, plain = w4(codes, aux)
        w_bf = unpack_leaf(leaf)
        if wide:
            plan = chunk_matmul_plan(128, K, N, leaf_plane(leaf))
            for r0, eye in _eye_windows(K, plan):
                if not torch.equal(fn(eye, codes, aux),
                                   w_bf[r0:r0 + eye.shape[0]]):
                    raise AssertionError(
                        f"{fn.__name__} decode differs from unpack_leaf at "
                        f"(K, N) = {(K, N)}, rows {r0}..")
        else:
            eye = torch.eye(K, dtype=torch.bfloat16, device=DEV)
            if not torch.equal(fn(eye, codes, aux), w_bf):
                raise AssertionError(f"{fn.__name__} decode differs from "
                                     f"unpack_leaf at (K, N) = {(K, N)}")
        x128 = torch.randn((128, K), generator=gen, device=DEV).to(
            torch.bfloat16)
        out128 = None
        for M in (128, 8):
            x = x128[:M]
            out, ref = fn(x, codes, aux), plain(x, codes, aux)
            ok, err = _elementwise_ok(
                out, ref, _sum_order_floor(x, w_bf) if wide else None)
            if not ok:
                raise AssertionError(f"{fn.__name__} {(M, K, N)}: "
                                     f"max |d| {err}")
            if out128 is None:
                out128 = out
            elif not torch.equal(out, out128[:M]):
                raise AssertionError(f"{fn.__name__} {(M, K, N)}: rows "
                                     "differ from the M 128 call's")
            nbytes = (M * K * 2 + codes.numel() + aux.numel()
                      * aux.element_size() + M * N * 2)
            bms, by = _bound(nbytes, 2.0 * M * N * K, PEAK_BF16_FLOPS)
            with exact_matmuls():
                lib = _time_ms(lambda: torch.matmul(x, w_bf), flush)
            p = chunk_matmul_plan(M, K, N, leaf_plane(leaf))
            row = {"kernel": fn.__name__, "model": cfg.name, "M": M,
                   "K": K, "N": N, "max_abs_err": err,
                   "decode_bit_exact": True,
                   "rows_equal_m128": True, "blocks": p.blocks,
                   "slices": p.slices,
                   "kernel_ms": _time_ms(lambda: fn(x, codes, aux), flush),
                   "plain_ms": _time_ms(lambda: plain(x, codes, aux),
                                        flush),
                   "library_ms": lib, "bound_ms": bms, "bound_by": by}
            _line(row)
            rows.append(row)
    return rows


def phase_prefill_chunk(engine, label, flush):
    """One prefill_chunk (B 8, C 16) on an engine's prepared params, as
    the engine calls it: its time (L2-cold, `_time_ms`; where the host
    takes longer than `SLEEP_CYCLES` to enqueue the chunk, the time is the
    host's), the bound its plane bytes set (every plane's codes and aux
    read once) and the K5 launches it makes, counted from 0 around one
    call.  Then `_reading` (phase_split) of one more chunk: host and
    device split, device time by kernel name (K5 and the rest), the
    count and its roofline."""
    from repro_torch.core.quant.serving import (
        CODES_KEY, is_packed_leaf, leaf_plane)
    from repro_torch.kernels.fused_prefill import (
        dpot_w4_matmul, dpot_w8_matmul, vq_matmul)
    from repro_torch.tree import leaves_with_path
    model, prep = engine.model, engine.plan.prepared
    B, C = 8, 16
    toks = torch.randint(0, model.cfg.vocab, (B, C), device=DEV,
                         generator=torch.Generator(device=DEV).manual_seed(
                             SEED + 7))
    valid = torch.ones((B, C), dtype=torch.bool, device=DEV)
    state = model.init_decode_state(B, 0, device=DEV)

    def call():
        with torch.inference_mode():
            return model.prefill_chunk(prep.prefill, state, toks, valid)
    counters = (dpot_w8_matmul, dpot_w4_matmul, vq_matmul)
    for fn in counters:
        fn.launches = 0
    _, logits = call()
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    if launches["dpot_w8_matmul"] == 0:
        raise AssertionError(f"prefill_chunk {label}: K5 never launched")
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"prefill_chunk {label}: non-finite logits")
    nbytes = 0
    for _, leaf in leaves_with_path(prep.prefill, is_leaf=is_packed_leaf):
        plane = leaf_plane(leaf) if is_packed_leaf(leaf) else None
        if plane is not None:
            aux = leaf["codebook" if plane == "vq" else "scale"]
            nbytes += (leaf[CODES_KEY[plane]].numel()
                       + aux.numel() * aux.element_size())
    row = {"phase": "prefill_chunk", "model": label, "B": B, "C": C,
           "ms": _time_ms(call, flush), "plane_bytes": nbytes,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "k5_launches": launches}
    _line(row)
    _reading(f"prefill chunk {label} B{B} C{C}", call)
    return row


def phase_k2(cfg, flush):
    from repro_torch.kernels.wkv4 import wkv4_seq, wkv4_seq_plain
    B, T, C = 8, 16, cfg.d_model
    g = torch.Generator(device=DEV).manual_seed(SEED + 2)
    rn = lambda *s: torch.randn(s, generator=g, device=DEV)
    k, v = rn(B, T, C), rn(B, T, C)
    w, u = torch.exp(0.5 * rn(C)), 0.5 * rn(C)
    bf = lambda t: t.to(torch.bfloat16).float()   # a bf16 pool state
    a0, b0, o0 = bf(rn(B, C)), bf(rn(B, C).abs() + 0.5), bf(rn(B, C) - 1)
    valid = torch.zeros((B, T), dtype=torch.bool, device=DEV)
    for i, n in enumerate((16, 9, 0, 1, 16, 5, 12, 16)):
        valid[i, :n] = True
    args = (k, v, w, u, a0, b0, o0)
    kw = {"valid": valid, "carry_dtype": "bfloat16"}
    y, fin = wkv4_seq(*args, **kw)
    y_p, fin_p = wkv4_seq_plain(*args, **kw)
    err = 0.0
    for name, o, r in zip(("y", "a", "b", "o"), (y, *fin), (y_p, *fin_p)):
        ok, e = _elementwise_ok(o, r)
        if not ok:
            raise AssertionError(f"K2 {name}: max |d| {e}")
        err = max(err, e)
    nbytes = 4 * (3 * B * T * C + 2 * C + 6 * B * C) + 4 * B * T
    bms, by = _bound(nbytes, 20.0 * B * T * C, PEAK_F32_FLOPS)
    row = {"kernel": "wkv4_seq", "B": B, "T": T, "C": C,
           "max_abs_err": err,
           "kernel_ms": _time_ms(lambda: wkv4_seq(*args, **kw), flush),
           "plain_ms": _time_ms(lambda: wkv4_seq_plain(*args, **kw), flush),
           "library_ms": None, "bound_ms": bms, "bound_by": by,
           "ptxas": _k2_ptxas(False, True, True)}
    _line(row)
    return row


def _k3_check(out, ref, where):
    """K3's outputs (x, new state) against its plain version's; returns
    the largest max |d| and mean |d| / mean |ref| over the six."""
    from repro_torch.kernels.fused_decode import STATE_KEYS
    err, mean_rel = 0.0, 0.0
    for name in ("x",) + STATE_KEYS:
        o = out[0] if name == "x" else out[1][name]
        r = ref[0] if name == "x" else ref[1][name]
        ok, e, m = _spread_ok(o, r, K3_MAX_REL, K3_MEAN_REL)
        if not ok:
            raise AssertionError(f"K3 {where} {name}: max |d| {e}, mean "
                                 f"rel {m}")
        err, mean_rel = max(err, e), max(mean_rel, m)
    return err, mean_rel


def _k3_grids(call, out):
    """K3 on grids of 1 and 7 blocks (`call(grid)`) against `out`, the
    full grid's outputs, bit for bit; returns the full grid's blocks."""
    from repro_torch.kernels.fused_decode import rwkv4_block_decode
    full = rwkv4_block_decode.grid
    for grid in (1, 7):
        got = call(grid)
        if not (torch.equal(got[0], out[0]) and all(
                torch.equal(got[1][k], out[1][k]) for k in out[1])):
            raise AssertionError(f"K3 on {grid} blocks differs from K3 on "
                                 f"{full}")
    return full


def _k4_grids(stack, st, x, out):
    """K4 on grids of 1 and 7 blocks against `out`, the full grid's
    outputs, bit for bit; returns the full grid's blocks."""
    from repro_torch.kernels.fused_decode import rwkv4_model_decode
    full = rwkv4_model_decode.grid
    for grid in (1, 7):
        got = rwkv4_model_decode(stack, st, x, grid=grid)
        if not (torch.equal(got[0], out[0]) and all(
                torch.equal(got[1][k], out[1][k]) for k in out[1])):
            raise AssertionError(f"K4 on {grid} blocks differs from K4 on "
                                 f"{full}")
    return full


def _k4_against_k3(stack, st, x, out, flush, check=None):
    """K4's outputs `out` against 12 K3 launches chained over the same
    layers (the stack's `_luts` as K3's tables), bit for bit; `check(o3,
    lp, st_l, x_l, l)` holds each K3 launch to its plain version.  Returns
    the 12 launches' time (`_time_ms`, the layers unfused beforehand)."""
    from repro_torch.core.quant.serving import unfuse_layer
    from repro_torch.kernels.fused_decode import (
        STATE_KEYS, rwkv4_block_decode)
    aux = [a[0] for a in stack.aux]
    layers = []
    for l in range(stack.n_layers):
        lp = unfuse_layer({k: s[l] for k, s in stack.slabs.items()}, aux,
                          stack.manifest, stack.tdef)
        layers.append((lp, lp.pop("_luts", None)))

    def chain(check=None):
        x3, new3 = x, []
        for l, (lp, luts) in enumerate(layers):
            st_l = {k: st[k][l] for k in STATE_KEYS}
            o3 = rwkv4_block_decode(lp, st_l, x3, luts=luts)
            if check is not None:
                check(o3, lp, st_l, x3, l)
            x3, s3 = o3
            new3.append(s3)
        return x3, new3
    x3, new3 = chain(check)
    if not (torch.equal(out[0], x3) and all(
            torch.equal(out[1][k], torch.stack([s[k] for s in new3]))
            for k in STATE_KEYS)):
        raise AssertionError(f"K4 differs from {len(layers)} K3 launches")
    return _time_ms(chain, flush, sleeps=len(layers))


def _k4_plan(stack, D, F, hw):
    """K4's plan at B = 8 (kernels/fused_decode.py:tile_plan)."""
    from repro_torch.kernels.fused_decode import tile_plan
    bf16 = "uint8" not in stack.slabs
    p = tile_plan(8, 8, D, F, bf16, hw)
    return {"kc": p.kc, "ns": p.stages, "smem": p.smem, "bb": p.bb}


def phase_k3(params, cfg, flush, planes="w8"):
    from repro_torch.core.quant.serving import (
        broadcast_packed_scales, cast_compute)
    from repro_torch.kernels.fused_decode import (
        rwkv4_block_decode, rwkv4_block_decode_plain)
    from repro_torch.models.rwkv4 import _layer
    from repro_torch.tree import leaves_with_path
    B, D, F = 8, cfg.d_model, cfg.d_ff
    blocks = broadcast_packed_scales(
        cast_compute(params, torch.bfloat16)["blocks"], cfg.n_layers)
    lp = _layer(blocks, 0)
    g = torch.Generator(device=DEV).manual_seed(SEED + 3)
    rn = lambda: torch.randn((B, D), generator=g, device=DEV)
    bf = torch.bfloat16
    x = rn().to(bf)
    st = {"att_x": rn().to(bf), "ffn_x": rn().to(bf),
          "wkv_a": rn().to(bf), "wkv_b": (rn().abs() + 0.5).to(bf),
          "wkv_o": (rn() - 1).to(bf)}
    out = rwkv4_block_decode(lp, st, x)
    err, mean_rel = _k3_check(out, rwkv4_block_decode_plain(lp, st, x),
                              f"layer 0 ({planes})")
    grid = _k3_grids(lambda g: rwkv4_block_decode(lp, st, x, grid=g), out)
    # the layer's own tensors (codes, scales or codebook, vectors), then
    # x and the state in and out
    nbytes = (sum(t.numel() * t.element_size()
                  for _, t in leaves_with_path(lp))
              + 2 * 6 * B * D + 2 * 6 * B * D)
    ops = 2.0 * B * (5 * D * D + 2 * D * F)
    bms, by = _bound(nbytes, ops, PEAK_BF16_FLOPS)
    row = {"kernel": "rwkv4_block_decode", "planes": planes, "B": B, "D": D,
           "F": F, "grid": grid, "bitwise_equal_on_grids": [1, 7],
           "max_abs_err": err, "max_mean_rel_err": mean_rel,
           "bytes": nbytes,
           "kernel_ms": _time_ms(lambda: rwkv4_block_decode(lp, st, x),
                                 flush),
           "plain_ms": _time_ms(lambda: rwkv4_block_decode_plain(lp, st, x),
                                flush),
           "library_ms": None, "bound_ms": bms, "bound_by": by}
    _line(row)
    return row


def phase_k4(engine, flush, planes="mixed", stack=None, role=None):
    """K4 on the model-path engine's prepared slabs (MIXED planes, or
    plain bf16 weights; or `stack`, another stack of the engine's model,
    such as the drafter's truncated one) at B = 8: bit for bit equal to L
    K3 launches over the same layers, each K3 launch within K3_* of K3's
    plain version on the same inputs, and K4 within K4_* of its own plain
    version (on another form than MIXED, K4_*'s recipe applied to that
    form: 1.25x the gap its plain version reads between the CPU and the
    card in this run); its time beside the byte bound."""
    from repro_torch.kernels.fused_decode import (
        STATE_KEYS, rwkv4_block_decode_plain, rwkv4_model_decode,
        rwkv4_model_decode_plain)
    if stack is None:
        stack = engine.plan.prepared.decode["blocks"]
    cfg = engine.model.cfg
    L, B, D, F = stack.n_layers, 8, cfg.d_model, cfg.d_ff
    g = torch.Generator(device=DEV).manual_seed(SEED + 4)
    rn = lambda *s: torch.randn(s, generator=g, device=DEV)
    bf = torch.bfloat16
    x = rn(B, D).to(bf)
    st = {"att_x": rn(L, B, D).to(bf), "ffn_x": rn(L, B, D).to(bf),
          "wkv_a": rn(L, B, D).to(bf),
          "wkv_b": (rn(L, B, D).abs() + 0.5).to(bf),
          "wkv_o": (rn(L, B, D) - 1).to(bf)}
    x4, new4 = rwkv4_model_decode(stack, st, x)
    grid = _k4_grids(stack, st, x, (x4, new4))
    errs = {"max": 0.0, "mean": 0.0}

    def held(o3, lp, st_l, x_l, l):
        e, m = _k3_check(o3, rwkv4_block_decode_plain(lp, st_l, x_l),
                         f"layer {l} ({planes})")
        errs["max"], errs["mean"] = max(errs["max"], e), max(errs["mean"], m)
    k3xL_ms = _k4_against_k3(stack, st, x, (x4, new4), flush, held)
    k3_err, k3_mean = errs["max"], errs["mean"]
    from repro_torch.core.quant.serving import FusedLayerStack
    from repro_torch.tree import tree_map
    xp, newp = rwkv4_model_decode_plain(stack, st, x)
    cpu = lambda t: t.cpu()
    xc, newc = rwkv4_model_decode_plain(
        FusedLayerStack(tree_map(cpu, stack.slabs),
                        tuple(map(cpu, stack.aux)), stack.manifest,
                        stack.tdef), tree_map(cpu, st), x.cpu())
    pairs = [("x", x4, xp, xc)] + [
        (k, new4[k], newp[k], newc[k]) for k in STATE_KEYS]
    err, mean_rel, rel = 0.0, 0.0, {"kernel": {}, "plain_cpu": {}}
    for name, o, r, c in pairs:
        scale_max = float(r.float().abs().max())
        for who, got in (("kernel", o), ("plain_cpu", c.to(DEV))):
            d = (got.float() - r.float()).abs()
            rel[who][name] = {
                "max_rel": float(d.max()) / scale_max,
                "mean_rel": float(d.mean() / r.float().abs().mean())}
    # K4_* is the MIXED planes' reading of the recipe; another form takes
    # the recipe itself, 1.25x its own plain pair's gap in this run
    bounds = (K4_MAX_REL, K4_MEAN_REL) if planes == "mixed" else tuple(
        1.25 * max(g[m] for g in rel["plain_cpu"].values())
        for m in ("max_rel", "mean_rel"))
    for name, o, r, _ in pairs:
        ok, e, m = _spread_ok(o, r, *bounds)
        if not ok:
            _line({"kernel": "rwkv4_model_decode", "gaps_to_plain": rel})
            raise AssertionError(f"K4 {name}: max |d| {e}, mean rel {m}")
        err, mean_rel = max(err, e), max(mean_rel, m)
    w_bytes = sum(s.numel() * s.element_size() for s in stack.slabs.values())
    aux_bytes = sum(a.numel() * a.element_size() for a in stack.aux)
    nbytes = (w_bytes + aux_bytes + 2 * 5 * L * B * D * 2   # state in, out
              + 2 * B * D * 2)                              # x in, out
    ops = 2.0 * B * L * (5 * D * D + 2 * D * F)
    bms, by = _bound(nbytes, ops, PEAK_BF16_FLOPS)
    kernel_ms = _time_ms(lambda: rwkv4_model_decode(stack, st, x), flush)
    row = {"kernel": "rwkv4_model_decode", "planes": planes,
           **({"role": role} if role else {}), "L": L, "B": B,
           "D": D, "F": F, "grid": grid, "bitwise_equal_on_grids": [1, 7],
           "plan": _k4_plan(stack, D, F, False),
           "equals_k3_per_layer": True,
           "k3_per_layer_vs_plain": {"max_abs_err": k3_err,
                                     "max_mean_rel_err": k3_mean},
           "max_abs_err": err, "max_mean_rel_err": mean_rel,
           "gaps_to_plain": rel,
           "bounds": {"max_rel": bounds[0], "mean_rel": bounds[1]},
           "weight_bytes": w_bytes, "aux_bytes": aux_bytes, "bytes": nbytes,
           "kernel_ms": kernel_ms, f"k3x{L}_ms": k3xL_ms,
           f"ratio_to_k3x{L}": kernel_ms / k3xL_ms,
           "plain_ms": _time_ms(
               lambda: rwkv4_model_decode_plain(stack, st, x), flush),
           "library_ms": None, "bound_ms": bms, "bound_by": by,
           "ratio_to_bound": kernel_ms / bms}
    _line(row)
    return row


def _engine_prompts(V):
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, V, int(n)).tolist()
            for n in rng.integers(5, 41, 8)]


def phase_engine(engine, counters, path):
    """8 seeded requests (5-40-token prompts, 32 new tokens) through an
    engine with fresh `ServingCounters`, every counter in `counters` set
    to 0 just before the run and read just after: each kernel launched,
    the snapshot's counts (8 admitted and finished, 256 decode tokens, the
    prompts' sum of prefill tokens, 8 TTFT samples), each program built
    once, and each stream equal to the same request served alone.  Its
    tokens_per_s is decode tokens over the run's wall time."""
    from repro_torch.runtime.monitor import ServingCounters
    V = engine.model.cfg.vocab
    prompts = _engine_prompts(V)
    engine.counters = engine.scheduler.counters = ServingCounters()
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [engine.submit(p, max_new_tokens=32) for p in prompts]
    snap = engine.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    want = {"admitted": 8, "finished": 8, "cancelled": 0,
            "decode_tokens": 256, "prefill_tokens": sum(map(len, prompts))}
    got = {k: snap[k] for k in want}
    if got != want or len(engine.counters.ttft_s) != 8:
        raise AssertionError(f"{path}: counters {got} (want {want}), "
                             f"{len(engine.counters.ttft_s)} TTFT samples")
    if engine.trace_counts != {"decode": 1, "prefill": 1}:
        raise AssertionError(f"trace_counts {engine.trace_counts}")
    streams = [h.tokens for h in handles]
    for s in streams:
        if len(s) != 32 or not all(0 <= t < V for t in s):
            raise AssertionError(f"bad stream {s}")
    for i, p in enumerate(prompts):
        h = engine.submit(p, max_new_tokens=32)
        engine.run()
        if h.tokens != streams[i]:
            raise AssertionError(f"request {i}: batched stream differs from "
                                 f"serving it alone")
    if engine.trace_counts != {"decode": 1, "prefill": 1}:
        raise AssertionError(f"trace_counts {engine.trace_counts}")
    _line({"phase": "engine", "path": path, "requests": 8, "new_tokens": 32,
           "prompt_lens": [len(p) for p in prompts],
           "tokens_per_s": snap["decode_tokens"] / seconds,
           "seconds": seconds, "ticks": snap["ticks"], "launches": launches,
           "counters": {k: snap[k] for k in (
               "admitted", "finished", "prefill_tokens", "decode_tokens",
               "mean_ttft_s", "ttft_p50_s", "ttft_p99_s", "mean_itl_s",
               "itl_p50_s", "itl_p99_s", "mean_latency_s",
               "mean_active_slots", "peak_active_slots")},
           "trace_counts": engine.trace_counts,
           "solo_equals_batched": True})
    return launches


def _kernel_logits(engine, toks, C):
    """The engine's kernel path: one prefill chunk (K5s + K2), then decode
    steps (K3 per layer or one K4, the head through K5), each on the
    weight form its path prepared.  Logits after the chunk and each
    step."""
    model, prep = engine.model, engine.plan.prepared
    step = model.decode_step_fused_model if prep.decode_path == "model" \
        else model.decode_step_fused
    B = toks.shape[0]
    valid = torch.ones((B, C), dtype=torch.bool, device=toks.device)
    with torch.inference_mode():
        s = model.init_decode_state(B, 0, device=toks.device)
        s, lg = model.prefill_chunk(prep.prefill, s, toks[:, :C], valid)
        out = [lg]
        for j in range(C, toks.shape[1]):
            lg, s = step(prep.decode, s, toks[:, j:j + 1], 0)
            out.append(lg)
    return torch.stack(out).float()


def _plain_logits(model, params, toks, C, dtype=torch.bfloat16):
    """The plain per-op path over the same tokens, token by token.  With
    dtype=float32 it is the f32 witness: the same W8 weights (decoded and
    rounded to bf16 as every path sees them, then widened exactly), with
    the state, the activations and every product in f32."""
    from repro_torch.core.quant.serving import cast_compute
    from repro_torch.models.registry import get_model
    from repro_torch.serving.plan import maybe_unpack
    p = cast_compute(maybe_unpack(params, True), torch.bfloat16)
    if dtype != torch.bfloat16:
        model = get_model(dataclasses.replace(
            model.cfg, dtype=str(dtype).replace("torch.", "")))
        p = cast_compute(p, dtype)
    out = []
    with torch.inference_mode():
        s = model.init_decode_state(toks.shape[0], 0, dtype=dtype,
                                    device=toks.device)
        for j in range(toks.shape[1]):
            lg, s = model.decode_step(p, s, toks[:, j:j + 1], 0)
            if j >= C - 1:
                out.append(lg)
    return torch.stack(out).float()


def _gap(out, ref):
    """max |d|, mean |d| / mean |ref|, and the share of points whose
    argmax over the vocabulary agrees."""
    d = (out - ref).abs()
    return {"max_abs": float(d.max()),
            "mean_rel": float(d.mean() / ref.abs().mean()),
            "argmax_agree": float((out.argmax(-1) == ref.argmax(-1))
                                  .float().mean())}


def phase_teacher_forced(engine, label=None):
    """Kernel path vs the plain per-op path on the card, on the same tokens
    (8 lanes: a 16-token prefill chunk, then 32 decode steps), both held
    against an f32 witness of the same model, with the plain path on the
    CPU beside them.

    Every bf16 path at this width sits a bf16 noise distance from the f32
    witness; the kernel path must sit no farther than the plain bf16 paths
    do (on the card and on the CPU, which differ only in summation order),
    within the fixed bounds TF_BOUNDS of its path.  The bounds come from
    the readings of the committed script on an H100 (PERF.md, PR 11 run 4
    and PR 12 run 2): what the plain bf16 paths alone read, against the
    witness and against each other, with a quarter of headroom.  They catch a kernel that is wrong (its
    logits move by their own size); a rounding made at the wrong place is
    caught by the per-kernel checks of phase 2, not here."""
    from repro_torch.tree import tree_map
    model, cfg = engine.model, engine.model.cfg
    params = engine.plan.prepared.raw
    g = torch.Generator(device=DEV).manual_seed(SEED + 7)
    B, C, S = 8, 16, 32
    toks = torch.randint(0, cfg.vocab, (B, C + S), generator=g,
                         device=DEV, dtype=torch.int32)
    out = _kernel_logits(engine, toks, C)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("kernel-path logits are not finite")
    if out.shape != (S + 1, B, 1, cfg.vocab):
        raise AssertionError(f"logits shape {tuple(out.shape)}")
    ref = _plain_logits(model, params, toks, C)
    f32 = _plain_logits(model, params, toks, C, torch.float32)
    max_f32, max_ref = float(f32.abs().max()), float(ref.abs().max())
    cpu = _plain_logits(model, tree_map(lambda t: t.cpu(), params),
                        toks.cpu(), C).to(DEV)
    gaps = {"kernel_vs_plain": _gap(out, ref),
            "kernel_vs_f32": _gap(out, f32),
            "plain_card_vs_f32": _gap(ref, f32),
            "plain_cpu_vs_f32": _gap(cpu, f32),
            "plain_cpu_vs_card": _gap(cpu, ref)}
    path = engine.plan.prepared.decode_path
    tb = TF_BOUNDS[path]
    kp, kf = gaps["kernel_vs_plain"], gaps["kernel_vs_f32"]
    near_f32 = lambda gp: (gp["mean_rel"] <= tb["mean_rel_f32"]
                           and gp["max_abs"] <= tb["max_rel_f32"] * max_f32
                           and gp["argmax_agree"] >= tb["argmax_f32"])
    ok = (near_f32(kf) and kp["mean_rel"] <= tb["mean_rel_plain"]
          and kp["max_abs"] <= tb["max_rel_plain"] * max_ref)
    _line({"phase": "teacher_forced", "path": path,
           **({"label": label} if label else {}), "steps": S + 1,
           "lanes": B, "max_abs_f32": max_f32, "gaps": gaps,
           "bounds": {"kernel_vs_f32": {
                          "mean_rel": tb["mean_rel_f32"],
                          "max_abs": tb["max_rel_f32"] * max_f32,
                          "argmax_agree": tb["argmax_f32"]},
                      "kernel_vs_plain": {
                          "mean_rel": tb["mean_rel_plain"],
                          "max_abs": tb["max_rel_plain"] * max_ref}},
           "plain_card_within_f32_bound": near_f32(gaps["plain_card_vs_f32"]),
           "within_bound": ok})
    if not ok:
        raise AssertionError(f"teacher-forced logits out of bounds: {gaps}")


# ---------------------------------------------------------------------------
# rwkv4-169m under the paper's hardware numerics: K9, K2-hw, K5 f32-x,
# K3-hw, K4-hw, and an hw greedy run through both decode paths
# ---------------------------------------------------------------------------

HW_OUTPUTS = ("x",) + ("att_x", "ffn_x", "wkv_a", "wkv_b", "wkv_o")


def _bits_equal(out, ref, skip):
    """Bit for bit where `skip` is False (f32 or bf16 views as ints)."""
    it = torch.int32 if out.dtype == torch.float32 else torch.int16
    return bool(((out.view(it) == ref.view(it)) | skip).all())


def phase_k9(flush):
    """K9 over every f32 bit pattern but NaN (2^32 inputs in chunks of
    2^28) and every bf16 pattern but NaN, both modes, bit for bit against
    the plain version on the card (a 2^24 sample also against it on the
    CPU); then timed at 2^24 f32 elements."""
    from repro_torch.kernels.expsig import (
        exp_kernel, exp_kernel_plain, sigmoid_kernel, sigmoid_kernel_plain)
    modes = ((exp_kernel, exp_kernel_plain), (sigmoid_kernel,
                                              sigmoid_kernel_plain))
    n_checked = 0
    step = 1 << 28
    for lo in range(-(1 << 31), 1 << 31, step):
        x = torch.arange(lo, lo + step, dtype=torch.int64, device=DEV).to(
            torch.int32).view(torch.float32)
        nan = torch.isnan(x)
        for fn, plain in modes:
            if not _bits_equal(fn(x), plain(x), nan):
                raise AssertionError(f"K9 {fn.__name__} differs from its "
                                     f"plain version in f32 chunk {lo}")
        n_checked += int((~nan).sum())
        del x, nan
    xb = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32,
                      device=DEV).to(torch.int16).view(torch.bfloat16)
    nanb = torch.isnan(xb)
    for fn, plain in modes:
        if not _bits_equal(fn(xb), plain(xb), nanb):
            raise AssertionError(f"K9 {fn.__name__} differs from its plain "
                                 "version in bf16")
    g = torch.Generator(device=DEV).manual_seed(SEED + 11)
    xs = torch.randint(-(1 << 31), 1 << 31, (1 << 24,), generator=g,
                       device=DEV, dtype=torch.int64).to(torch.int32).view(
                           torch.float32)
    for fn, plain in modes:
        if not _bits_equal(fn(xs), plain(xs.cpu()).to(DEV), torch.isnan(xs)):
            raise AssertionError(f"K9 {fn.__name__} differs from its plain "
                                 "version on the CPU")
    x = torch.randn((1 << 24,), generator=g, device=DEV) * 8
    bms, by = _bound(2 * 4 * x.numel(), 10.0 * x.numel(), PEAK_F32_FLOPS)
    rows = []
    for fn, plain in modes:
        row = {"kernel": fn.__name__, "N": x.numel(), "dtype": "float32",
               "max_abs_err": 0.0, "f32_inputs_checked": n_checked,
               "bf16_inputs_checked": int((~nanb).sum()),
               "kernel_ms": _time_ms(lambda: fn(x), flush),
               "plain_ms": _time_ms(lambda: plain(x), flush),
               "library_ms": None, "bound_ms": bms, "bound_by": by}
        _line(row)
        rows.append(row)
    return rows


def _hw_luts():
    from repro_torch.core.approx.units import lut_tensor
    return {"exp": lut_tensor("exp", DEV), "div": lut_tensor("div", DEV)}


def phase_k2_hw(cfg, flush):
    """K2 with the EXP and DIV tables at the prefill's shape, prefix masks
    and the bf16 carry, bit for bit against its plain version (every op is
    one IEEE rounding in both, and no sum changes order)."""
    from repro_torch.kernels.wkv4 import wkv4_seq, wkv4_seq_plain
    B, T, C = 8, 16, cfg.d_model
    g = torch.Generator(device=DEV).manual_seed(SEED + 12)
    rn = lambda *s: torch.randn(s, generator=g, device=DEV)
    k, v = rn(B, T, C), rn(B, T, C)
    w, u = torch.exp(0.5 * rn(C)), 0.5 * rn(C)
    bf = lambda t: t.to(torch.bfloat16).float()
    a0, b0, o0 = bf(rn(B, C)), bf(rn(B, C).abs() + 0.5), bf(rn(B, C) - 1)
    valid = torch.zeros((B, T), dtype=torch.bool, device=DEV)
    for i, n in enumerate((16, 9, 0, 1, 16, 5, 12, 16)):
        valid[i, :n] = True
    luts = _hw_luts()
    args = (k, v, w, u, a0, b0, o0)
    kw = {"valid": valid, "carry_dtype": "bfloat16",
          "exp_table": luts["exp"], "div_table": luts["div"]}
    y, fin = wkv4_seq(*args, **kw)
    y_p, fin_p = wkv4_seq_plain(*args, **kw)
    err = 0.0
    for name, o, r in zip(("y", "a", "b", "o"), (y, *fin), (y_p, *fin_p)):
        e = float((o - r).abs().max())
        if not torch.equal(o, r):
            raise AssertionError(f"K2-hw {name} differs from its plain "
                                 f"version: max |d| {e}, "
                                 f"{int((o != r).sum())} elements")
        err = max(err, e)
    nbytes = 4 * (3 * B * T * C + 2 * C + 6 * B * C + 512) + 4 * B * T
    bms, by = _bound(nbytes, 40.0 * B * T * C, PEAK_F32_FLOPS)
    row = {"kernel": "wkv4_seq", "numerics": "hw", "B": B, "T": T, "C": C,
           "max_abs_err": err, "bit_exact": True,
           "kernel_ms": _time_ms(lambda: wkv4_seq(*args, **kw), flush),
           "plain_ms": _time_ms(lambda: wkv4_seq_plain(*args, **kw), flush),
           "library_ms": None, "bound_ms": bms, "bound_by": by,
           "ptxas": _k2_ptxas(True, True, True)}
    _line(row)
    return row


F32X_AUX = {"w8": "scale", "w4": "scale", "vq": "codebook"}
F32X_FN = {"w8": "dpot_w8_matmul", "w4": "dpot_w4_matmul", "vq": "vq_matmul"}


def phase_k5_f32x(trees, cfg, flush, usage):
    """K5's f32-activation forms at att.wo's prefill shape (128, 768, 768),
    each on layer 0's att.wo of a tree packed in its plane (W8, W4, VQ):
    the decode bit for bit (identity rows), each output within the f32
    summation bound K·2^-24·(|x| @ |w|) of the plain version.  One row a
    plane, the first with the ptxas lines of the f32-x instances of
    chunk_mm_kernel.  bound_ms is the lesser of two least times for the
    same function: its products as f32 FMAs at 67 TFLOP/s, or as the
    three bf16 products a weight that the kernel runs (x split in three)
    at 989 TFLOP/s; `bound_form` names which, `bound_by` whether the
    operations or the bytes set it."""
    from repro_torch.core.quant.serving import CODES_KEY, unpack_leaf
    from repro_torch.device import exact_matmuls
    from repro_torch.kernels import fused_prefill as fp
    rows = []
    for plane, params in trees.items():
        leaf = params["blocks"]["att"]["wo"]
        codes = leaf[CODES_KEY[plane]][0]
        aux = leaf[F32X_AUX[plane]].reshape(-1)
        fn = getattr(fp, F32X_FN[plane] + "_f32x")
        plain = getattr(fp, F32X_FN[plane] + "_plain")
        K, N, M = cfg.d_model, cfg.d_model, 128
        w_bf = unpack_leaf({CODES_KEY[plane]: codes,
                            F32X_AUX[plane]: aux.reshape(1, -1)})
        eye = torch.eye(K, device=DEV)
        if not torch.equal(fn(eye, codes, aux), w_bf.float()):
            raise AssertionError(f"{fn.__name__} decode differs from "
                                 "unpack_leaf")
        g = torch.Generator(device=DEV).manual_seed(SEED + 13)
        x = torch.randn((M, K), generator=g, device=DEV)
        out = fn(x, codes, aux)
        ref = plain(x, codes, aux)
        d = (out - ref).abs()
        if not bool((d <= _sum_order_floor(x, w_bf)).all()):
            raise AssertionError(f"{fn.__name__}: max |d| {float(d.max())} "
                                 "passes the f32 summation bound")
        nbytes = (M * K * 4 + codes.numel() + aux.numel() * aux.element_size()
                  + M * N * 4)
        forms = {"f32 FMAs": _bound(nbytes, 2.0 * M * N * K, PEAK_F32_FLOPS),
                 "three bf16 products": _bound(nbytes, 6.0 * M * N * K,
                                               PEAK_BF16_FLOPS)}
        form = min(forms, key=lambda f: forms[f][0])
        bms, by = forms[form]
        w32 = w_bf.float()
        with exact_matmuls():
            lib = _time_ms(lambda: torch.matmul(x, w32), flush)
        row = {"kernel": fn.__name__, "M": M, "K": K, "N": N,
               "max_abs_err": float(d.max()), "decode_bit_exact": True,
               "kernel_ms": _time_ms(lambda: fn(x, codes, aux), flush),
               "plain_ms": _time_ms(lambda: plain(x, codes, aux), flush),
               "library_ms": lib, "bound_ms": bms, "bound_by": by,
               "bound_form": form}
        if not rows:
            row["ptxas"] = _registers(usage,
                                      r"chunk_mm_kernel.*Lb1ELb0EE")
        _line(row)
        rows.append(row)
    return rows


def _hw_state(cfg, lead, seed):
    g = torch.Generator(device=DEV).manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=DEV)
    bf = torch.bfloat16
    D = cfg.d_model
    st = {"att_x": rn(*lead, D).to(bf), "ffn_x": rn(*lead, D).to(bf),
          "wkv_a": rn(*lead, D).to(bf),
          "wkv_b": (rn(*lead, D).abs() + 0.5).to(bf),
          "wkv_o": (rn(*lead, D) - 1).to(bf)}
    return st, rn(lead[-1], D).to(bf)


def _hw_check(out, ref, cpu, what, factor):
    """Kernel vs plain (card) per output, within `factor` times the worst
    relative gap the plain version reads between the CPU and the card over
    the six outputs.  Returns the readings."""
    pick = lambda o, n: o[0] if n == "x" else o[1][n]
    rel = {"kernel": {}, "plain_cpu": {}}
    for n in HW_OUTPUTS:
        r = pick(ref, n).float()
        for who, got in (("kernel", pick(out, n)),
                         ("plain_cpu", pick(cpu, n).to(DEV))):
            d = (got.float() - r).abs()
            rel[who][n] = {"max_rel": float(d.max() / r.abs().max()),
                           "mean_rel": float(d.mean() / r.abs().mean())}
    bound = {m: factor * max(v[m] for v in rel["plain_cpu"].values())
             for m in ("max_rel", "mean_rel")}
    bad = [n for n in HW_OUTPUTS if any(rel["kernel"][n][m] > bound[m]
                                      for m in bound)]
    if bad:
        _line({"kernel": what, "gaps_to_plain": rel, "bounds": bound})
        raise AssertionError(f"{what} {bad} out of bounds {bound}")
    return rel, bound


def _to_cpu(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.cpu(), tree)


def phase_k3_hw(params, cfg, flush):
    """K3 with the EXP and DIV tables on layer 0 of the W8 tree, B = 8,
    against its plain hw version on the card, within 1.25x the plain hw
    version's own CPU-vs-card gap."""
    from repro_torch.core.quant.serving import (
        broadcast_packed_scales, cast_compute)
    from repro_torch.kernels.fused_decode import (
        rwkv4_block_decode, rwkv4_block_decode_plain)
    from repro_torch.models.rwkv4 import _hw_numerics_with_tables, _layer
    from repro_torch.tree import leaves_with_path
    B, D, F = 8, cfg.d_model, cfg.d_ff
    lp = _layer(broadcast_packed_scales(
        cast_compute(params, torch.bfloat16)["blocks"], cfg.n_layers), 0)
    st, x = _hw_state(cfg, (B,), SEED + 14)
    luts = _hw_luts()
    nm = _hw_numerics_with_tables(luts["exp"], luts["div"])
    out = rwkv4_block_decode(lp, st, x, luts=luts)
    ref = rwkv4_block_decode_plain(lp, st, x, nm)
    cl = _to_cpu(luts)
    cpu = rwkv4_block_decode_plain(
        _to_cpu(lp), _to_cpu(st), x.cpu(),
        _hw_numerics_with_tables(cl["exp"], cl["div"]))
    rel, bound = _hw_check(out, ref, cpu, "K3-hw", 1.25)
    grid = _k3_grids(
        lambda g: rwkv4_block_decode(lp, st, x, luts=luts, grid=g), out)
    nbytes = (sum(t.numel() * t.element_size()
                  for _, t in leaves_with_path(lp))
              + 2 * 6 * B * D + 2 * 6 * B * D + 2 * 256 * 4)
    ops = 2.0 * B * (5 * D * D + 2 * D * F)
    bms, by = _bound(nbytes, ops, PEAK_BF16_FLOPS)
    row = {"kernel": "rwkv4_block_decode", "numerics": "hw", "planes": "w8",
           "B": B, "D": D, "F": F, "grid": grid,
           "bitwise_equal_on_grids": [1, 7],
           "max_abs_err": max(float((o.float() - r.float()).abs().max())
                              for o, r in zip((out[0], *out[1].values()),
                                              (ref[0], *ref[1].values()))),
           "gaps_to_plain": rel, "bounds": bound, "bytes": nbytes,
           "kernel_ms": _time_ms(
               lambda: rwkv4_block_decode(lp, st, x, luts=luts), flush),
           "plain_ms": _time_ms(
               lambda: rwkv4_block_decode_plain(lp, st, x, nm), flush),
           "library_ms": None, "bound_ms": bms, "bound_by": by}
    _line(row)
    return row


def phase_k4_hw(stack, cfg, flush):
    """K4 over the 12 layers of the prepared W8 hw stack at B = 8: bit for
    bit equal to 12 K3-hw launches, then against its plain hw version on
    the card within HW_SPREAD times the plain version's own CPU-vs-card
    gap."""
    from repro_torch.core.quant.serving import FusedLayerStack
    from repro_torch.kernels.fused_decode import (
        rwkv4_model_decode, rwkv4_model_decode_plain)
    L, B, D, F = cfg.n_layers, 8, cfg.d_model, cfg.d_ff
    st, x = _hw_state(cfg, (L, B), SEED + 15)
    x4, new4 = rwkv4_model_decode(stack, st, x)
    grid = _k4_grids(stack, st, x, (x4, new4))
    k3xL_ms = _k4_against_k3(stack, st, x, (x4, new4), flush)
    ref = rwkv4_model_decode_plain(stack, st, x)
    cpu_stack = FusedLayerStack(_to_cpu(stack.slabs),
                                tuple(a.cpu() for a in stack.aux),
                                stack.manifest, stack.tdef)
    cpu = rwkv4_model_decode_plain(cpu_stack, _to_cpu(st), x.cpu())
    rel, bound = _hw_check((x4, new4), ref, cpu, "K4-hw", HW_SPREAD)
    w_bytes = sum(s.numel() * s.element_size() for s in stack.slabs.values())
    aux_bytes = sum(a.numel() * a.element_size() for a in stack.aux)
    nbytes = w_bytes + aux_bytes + 2 * 5 * L * B * D * 2 + 2 * B * D * 2
    ops = 2.0 * B * L * (5 * D * D + 2 * D * F)
    bms, by = _bound(nbytes, ops, PEAK_BF16_FLOPS)
    kernel_ms = _time_ms(lambda: rwkv4_model_decode(stack, st, x), flush)
    row = {"kernel": "rwkv4_model_decode", "numerics": "hw", "planes": "w8",
           "L": L, "B": B, "D": D, "F": F, "grid": grid,
           "bitwise_equal_on_grids": [1, 7],
           "plan": _k4_plan(stack, D, F, True),
           "equals_k3_per_layer": True,
           "max_abs_err": max(float((o.float() - r.float()).abs().max())
                              for o, r in zip((x4, *new4.values()),
                                              (ref[0], *ref[1].values()))),
           "gaps_to_plain": rel, "bounds": bound, "bytes": nbytes,
           "kernel_ms": kernel_ms, f"k3x{L}_ms": k3xL_ms,
           f"ratio_to_k3x{L}": kernel_ms / k3xL_ms,
           "plain_ms": _time_ms(
               lambda: rwkv4_model_decode_plain(stack, st, x), flush),
           "library_ms": None, "bound_ms": bms, "bound_by": by,
           "ratio_to_bound": kernel_ms / bms}
    _line(row)
    return row


class _Recorded:
    """A model whose decode_step is `step` and whose logits are kept: the
    way serve_legacy wraps the hw step, with the logits recorded."""

    def __init__(self, step):
        self.step, self.logits = step, []

    def decode_step(self, params, state, tokens, pos):
        lg, state = self.step(params, state, tokens, pos)
        self.logits.append(lg)
        return lg, state


def _hw_prefill(model, params, prompts, C):
    """Prompts of any length through prefill_chunk(hw=True) in chunks of
    C with prefix masks; returns the state and each lane's last logits."""
    from repro_torch.models import rwkv4
    B = len(prompts)
    n = max(len(p) for p in prompts)
    toks = torch.zeros((B, -(-n // C) * C), dtype=torch.int32, device=DEV)
    lens = torch.tensor([len(p) for p in prompts], device=DEV)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p, dtype=torch.int32, device=DEV)
    state = model.init_decode_state(B, 0, device=DEV)
    last = None
    for c0 in range(0, toks.shape[1], C):
        valid = torch.arange(c0, c0 + C, device=DEV)[None, :] < lens[:, None]
        state, lg = rwkv4.prefill_chunk(params, state, toks[:, c0:c0 + C],
                                        valid, 0, model.cfg, hw=True)
        last = lg if last is None else torch.where(
            valid.any(1)[:, None, None], lg, last)
    return state, last


def phase_hw_greedy(params, prep, model):
    """8 lanes of seeded prompts (5-40 tokens) through prefill_chunk(hw)
    in chunks of 16, then greedy_decode over 32 steps, with
    decode_step_fused(hw) (K3-hw per layer) and with the prepared K4-hw
    form, each path twice in the order block, model, model, block (one
    run of ~0.3 s on the host's clock moves by a third from run to run:
    a path's rate is over its two runs); every counter of the path set to
    0 before and read after each run; the two paths' logits bit for bit
    equal, and equal run to run."""
    from repro_torch.kernels.expsig import exp_kernel, sigmoid_kernel
    from repro_torch.kernels.fused_decode import (
        rwkv4_block_decode, rwkv4_model_decode)
    from repro_torch.kernels.fused_prefill import (
        dpot_w8_matmul, dpot_w8_matmul_f32x)
    from repro_torch.kernels.wkv4 import wkv4_seq
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.models import rwkv4
    cfg = model.cfg
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(5, 41, 8)]
    common = (dpot_w8_matmul, dpot_w8_matmul_f32x, wkv4_seq, sigmoid_kernel,
              exp_kernel)
    paths = {
        "hw-block": (lambda p, s, t, pos: rwkv4.decode_step_fused(
            p, s, t, pos, cfg, hw=True), params, rwkv4_block_decode),
        "hw-model": (lambda p, s, t, pos: rwkv4.decode_step_fused_model(
            p, s, t, pos, cfg, hw=True), prep, rwkv4_model_decode)}
    out, by_path, took = {}, {}, {}
    for name in ("hw-block", "hw-model", "hw-model", "hw-block"):
        step, p, decode_kernel = paths[name]
        counters = common + (decode_kernel,)
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        with torch.inference_mode():
            state, last = _hw_prefill(model, params, prompts, 16)
            first = torch.argmax(last[:, -1].float(), -1)[:, None].to(
                torch.int32)
            rec = _Recorded(step)
            toks, _ = greedy_decode(rec, p, state, first, 32)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        if min(launches[f.__name__] for f in counters
               if f is not exp_kernel) == 0:
            raise AssertionError(f"{name}: a kernel never launched: "
                                 f"{launches}")
        run = (toks, torch.stack([last] + rec.logits))
        if name in out and not all(map(torch.equal, out[name], run)):
            raise AssertionError(f"{name}: two runs differ")
        out[name] = run
        by_path[name] = launches
        took.setdefault(name, []).append(seconds)
        if len(took[name]) == 2:
            _line({"phase": "hw_greedy", "path": name, "lanes": 8,
                   "prompt_lens": [len(q) for q in prompts],
                   "new_tokens": 32, "seconds": took[name],
                   "tokens_per_s": 2 * 8 * 32 / sum(took[name]),
                   "launches": launches})
    (tb, lb), (tm_, lm) = out["hw-block"], out["hw-model"]
    if not (torch.equal(lb, lm) and torch.equal(tb, tm_)):
        raise AssertionError("the hw model path's logits differ from the "
                             "hw block path's")
    if not bool(torch.isfinite(lb.float()).all()):
        raise AssertionError("hw logits are not finite")
    return by_path


def phase_hw_teacher_forced(params, model):
    """The hw kernel path (a 16-token prefill chunk, then 32 K3-hw decode
    steps) against the plain per-op hw path on the card, on the same
    tokens, within 1.25x what the plain hw path reads between the CPU and
    the card; then the gap from hw to the exact numerics (the
    plain bf16 path), a reading of the paper's accuracy cost with no
    bound."""
    from repro_torch.models import rwkv4
    from repro_torch.serving.plan import maybe_unpack
    from repro_torch.core.quant.serving import cast_compute
    cfg = model.cfg
    g = torch.Generator(device=DEV).manual_seed(SEED + 7)
    B, C, S = 8, 16, 32
    toks = torch.randint(0, cfg.vocab, (B, C + S), generator=g,
                         device=DEV, dtype=torch.int32)
    valid = torch.ones((B, C), dtype=torch.bool, device=DEV)
    with torch.inference_mode():
        s = model.init_decode_state(B, 0, device=DEV)
        s, lg = rwkv4.prefill_chunk(params, s, toks[:, :C], valid, 0, cfg,
                                    hw=True)
        kern = [lg]
        for j in range(C, C + S):
            lg, s = rwkv4.decode_step_fused(params, s, toks[:, j:j + 1], 0,
                                            cfg, hw=True)
            kern.append(lg)
    kern = torch.stack(kern).float()

    def plain(p, tk):
        p = cast_compute(maybe_unpack(p, True), torch.bfloat16)
        out = []
        with torch.inference_mode():
            s = model.init_decode_state(B, 0, device=tk.device)
            for j in range(C + S):
                lg, s = rwkv4.decode_step(p, s, tk[:, j:j + 1], 0, cfg,
                                          hw=True)
                if j >= C - 1:
                    out.append(lg)
        return torch.stack(out).float()
    ref = plain(params, toks)
    cpu = plain(_to_cpu(params), toks.cpu()).to(DEV)
    exact = _plain_logits(model, params, toks, C)
    gaps = {"kernel_vs_plain": _gap(kern, ref),
            "plain_cpu_vs_card": _gap(cpu, ref),
            "hw_vs_exact": _gap(ref, exact),
            "hw_kernel_vs_exact": _gap(kern, exact)}
    kp, pc = gaps["kernel_vs_plain"], gaps["plain_cpu_vs_card"]
    bound = {"mean_rel": 1.25 * pc["mean_rel"],
             "max_abs": 1.25 * pc["max_abs"]}
    ok = kp["mean_rel"] <= bound["mean_rel"] and \
        kp["max_abs"] <= bound["max_abs"] and \
        bool(torch.isfinite(kern).all())
    _line({"phase": "hw_teacher_forced", "steps": S + 1, "lanes": B,
           "max_abs_plain": float(ref.abs().max()), "gaps": gaps,
           "bounds": bound, "within_bound": ok})
    if not ok:
        raise AssertionError(f"hw teacher-forced logits out of bounds: "
                             f"{gaps}")


def _hw_scan(model, params, toks, valid):
    """The per-op hw step scanned over a chunk with the engine's masked
    commits, from the fresh state: (each lane's last valid logits, the
    state)."""
    from repro_torch.core.quant.serving import cast_compute
    from repro_torch.models import rwkv4
    from repro_torch.serving.plan import maybe_unpack
    p = cast_compute(maybe_unpack(params, True), torch.bfloat16)
    B, C = toks.shape
    with torch.inference_mode():
        s = model.init_decode_state(B, 0, device=toks.device)
        last = None
        for t in range(C):
            lg, sn = rwkv4.decode_step(p, s, toks[:, t:t + 1], 0, model.cfg,
                                       hw=True)
            ok = valid[:, t]
            s = {k: torch.where(ok[None, :, None], sn[k], s[k]) for k in s}
            last = torch.where(ok[:, None, None], lg,
                               torch.zeros_like(lg) if last is None else last)
    return last, s


def phase_hw_prefill_planes(model, trees):
    """prefill_chunk(hw=True) (B 8, C 16, prefix masks) on rwkv4-169m
    trees packed W4 and VQ, as a user calls it: att.wo's f32 x goes
    through K5-W4's or K5-VQ's f32-x form once a layer, every counter of
    the path set to 0 before and read after.  The last logits and the
    state against the per-op hw step scanned over the chunk on the card,
    within 1.25x what that per-op path reads between the CPU and the card
    (the hw teacher-forced recipe, `_hw_check`)."""
    from repro_torch.kernels.expsig import sigmoid_kernel
    from repro_torch.kernels.fused_prefill import (
        dpot_w4_matmul, dpot_w4_matmul_f32x, vq_matmul, vq_matmul_f32x)
    from repro_torch.kernels.wkv4 import wkv4_seq
    from repro_torch.models import rwkv4
    cfg = model.cfg
    B, C = 8, 16
    g = torch.Generator(device=DEV).manual_seed(SEED + 21)
    toks = torch.randint(0, cfg.vocab, (B, C), generator=g, device=DEV,
                         dtype=torch.int32)
    valid = torch.zeros((B, C), dtype=torch.bool, device=DEV)
    for i, n in enumerate((16, 9, 0, 1, 16, 5, 12, 16)):
        valid[i, :n] = True
    by_path = {}
    for plane, params in trees.items():
        bf, f32x = {"w4": (dpot_w4_matmul, dpot_w4_matmul_f32x),
                    "vq": (vq_matmul, vq_matmul_f32x)}[plane]
        counters = (bf, f32x, wkv4_seq, sigmoid_kernel)
        for fn in counters:
            fn.launches = 0
        with torch.inference_mode():
            st, lg = rwkv4.prefill_chunk(
                params, model.init_decode_state(B, 0, device=DEV), toks,
                valid, 0, cfg, hw=True)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}
        if min(launches.values()) == 0 or \
                launches[f32x.__name__] != cfg.n_layers:
            raise AssertionError(f"hw prefill {plane}: launches {launches}")
        if not bool(torch.isfinite(lg.float()).all()):
            raise AssertionError(f"hw prefill {plane}: non-finite logits")
        ref = _hw_scan(model, params, toks, valid)
        cpu = _hw_scan(model, _to_cpu(params), toks.cpu(), valid.cpu())
        rel, bound = _hw_check((lg, st), ref, cpu, f"hw prefill {plane}",
                               1.25)
        by_path[f"hw-prefill-{plane}"] = launches
        _line({"phase": "hw_prefill", "planes": plane, "B": B, "C": C,
               "launches": launches, "gaps_to_plain": rel,
               "bounds": bound})
    return by_path


def phase_path_step(model, params, path, counters, name):
    """One decode step (B 8, the fresh state, seeded tokens) through a
    kernel path as a user calls it: "block" decode_step_fused, "model"
    decode_step_fused_model; every counter set to 0 before and read
    after, each must have launched; finite logits of the vocabulary's
    width."""
    step = model.decode_step_fused if path == "block" \
        else model.decode_step_fused_model
    B = 8
    toks = torch.randint(0, model.cfg.vocab, (B, 1), device=DEV,
                         dtype=torch.int32,
                         generator=torch.Generator(device=DEV).manual_seed(
                             SEED + 31))
    for fn in counters:
        fn.launches = 0
    with torch.inference_mode():
        lg, _ = step(params, model.init_decode_state(B, 0, device=DEV), toks,
                     0)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    if min(launches.values()) == 0:
        raise AssertionError(f"{name}: a kernel never launched: {launches}")
    if lg.shape != (B, 1, model.cfg.vocab) or \
            not bool(torch.isfinite(lg.float()).all()):
        raise AssertionError(f"{name}: logits {tuple(lg.shape)}, finite "
                             f"{bool(torch.isfinite(lg.float()).all())}")
    _line({"phase": "path_step", "path": name, "B": B, "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# rwkv6-7b: K6, K7-block, K7-model, and the two kernel paths end to end
# ---------------------------------------------------------------------------

STATE6 = ("att_x", "ffn_x", "wkv_s")


def _state6(cfg, lead, seed):
    """Random bf16 rwkv6 state leaves with leading dims `lead` and a
    residual x (B, D)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=DEV).to(
        torch.bfloat16)
    D, H, N = cfg.d_model, cfg.n_heads, cfg.rwkv_head_dim
    return ({"att_x": rn(*lead, D), "ffn_x": rn(*lead, D),
             "wkv_s": rn(*lead, H, N, N)}, rn(lead[-1], D))


def _state6_bytes(st) -> int:
    return sum(t.numel() * t.element_size() for t in st.values())


K6_PREFIXES = (16, 9, 0, 1, 16, 5, 12, 16)   # phase_k6's valid prefixes


def _k6_operands(B, T, H, N, seed, prefixes=None):
    """K6's operands as the prefill hands them: N(0, 1) r, k, v, w =
    exp(-exp(N(0, 1/4))), u = N(0, 1/4), a bf16 pool state; the valid
    mask from `prefixes` (each row's count of leading valid steps; every
    step where None) and the bf16 carry."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=DEV)
    args = (rn(B, T, H, N), rn(B, T, H, N), rn(B, T, H, N),
            torch.exp(-torch.exp(0.5 * rn(B, T, H, N))), 0.5 * rn(H, N),
            rn(B, H, N, N).to(torch.bfloat16))
    valid = torch.zeros((B, T), dtype=torch.bool, device=DEV)
    for i in range(B):
        valid[i, :T if prefixes is None else prefixes[i]] = True
    return args, {"valid": valid, "carry_dtype": "bfloat16"}


def _k6_bound(B, T, H, N, s0_bytes, masked):
    """K6's bytes (r, k, v, w, y f32; u; the state in at s0_bytes and out
    in f32; valid) and its bound, bytes at 3.35 TB/s or its 7 f32
    operations a term at 67 TFLOP/s: (nbytes, bound_ms, bound_by)."""
    nbytes = (4 * 5 * B * T * H * N + 4 * H * N
              + (s0_bytes + 4) * B * H * N * N + (4 * B * T if masked else 0))
    return (nbytes, *_bound(nbytes, 7.0 * B * T * H * N * N,
                            PEAK_F32_FLOPS))


def _k6_check(args, kw, what):
    """K6 against its plain version, the final state bit for bit (its
    update has no sum) and y within K2's elementwise rule (the plain
    version's einsum sums n in its own order), and y bit for bit against
    the in-order reference (`wkv6_seq_inorder`: n in order from +0, eager
    ops).  Returns (y's max |d| to the plain version, the outputs)."""
    from repro_torch.kernels.wkv6 import (
        wkv6_seq, wkv6_seq_inorder, wkv6_seq_plain)
    y, sf = wkv6_seq(*args, **kw)
    y_p, sf_p = wkv6_seq_plain(*args, **kw)
    ok, err = _elementwise_ok(y, y_p)
    if not ok:
        raise AssertionError(f"K6 {what} y: max |d| {err}")
    if not torch.equal(sf, sf_p):
        raise AssertionError(f"K6 {what}: final state differs from the "
                             "plain version")
    y_o, sf_o = wkv6_seq_inorder(*args, **kw)
    if not (torch.equal(y.view(torch.int32), y_o.view(torch.int32))
            and torch.equal(sf_o, sf_p)):
        raise AssertionError(f"K6 {what} y: not the in-order reference's "
                             f"bits (max |d| {float((y - y_o).abs().max())})")
    return err, (y, sf)


def phase_k6(flush):
    """K6 at the prefill's shape, (B, T, H, N) = (8, 16, 64, 64), prefix
    masks, the bf16 pool state in and the bf16 carry (`_k6_check`)."""
    from repro_torch.kernels.wkv6 import wkv6_seq, wkv6_seq_plain
    B, T, H, N = 8, 16, 64, 64
    args, kw = _k6_operands(B, T, H, N, SEED + 8, K6_PREFIXES)
    err, _ = _k6_check(args, kw, "prefill shape")
    nbytes, bms, by = _k6_bound(B, T, H, N, 2, True)
    row = {"kernel": "wkv6_seq", "B": B, "T": T, "H": H, "N": N,
           "max_abs_err": err, "state_bit_exact": True,
           "y_inorder_bit_exact": True, "bytes": nbytes,
           "kernel_ms": _time_ms(lambda: wkv6_seq(*args, **kw), flush),
           "plain_ms": _time_ms(lambda: wkv6_seq_plain(*args, **kw), flush),
           "library_ms": None, "bound_ms": bms, "bound_by": by}
    _line(row)
    return row


def _k7_check(out, ref, where, cpu=None):
    """K7's outputs (x, new state) against its plain version's, per output:
    max |d| <= K7B_MAX_REL max|ref| and mean |d| <= K7B_MEAN_REL
    mean|ref|, or, given `cpu` (the plain version's output on the CPU from
    the same inputs), within 1.25x the worst relative gap that pair reads
    over the four outputs.  Returns the largest max |d|, mean |d| /
    mean|ref| and the two relative bounds."""
    max_rel, mean_rel = K7B_MAX_REL, K7B_MEAN_REL
    if cpu is not None:
        g = _rel_gaps(cpu, ref).values()
        max_rel = 1.25 * max(v["max_rel"] for v in g)
        mean_rel = 1.25 * max(v["mean_rel"] for v in g)
    err, worst = 0.0, 0.0
    for name in ("x",) + STATE6:
        pick = lambda o: o[0] if name == "x" else o[1][name]
        r = pick(ref).float()
        d = (pick(out).float() - r).abs()
        e, m = float(d.max()), float(d.mean() / r.abs().mean())
        if e > max_rel * float(r.abs().max()) or m > mean_rel:
            raise AssertionError(f"K7 {where} {name}: max |d| {e}, mean "
                                 f"rel {m}; bounds {max_rel}, {mean_rel}")
        err, worst = max(err, e), max(worst, m)
    return err, worst, max_rel, mean_rel


def _k7_ops(cfg, B, L=1):
    """Multiply-adds of the layer's matvecs, twice, per lane, and the WKV
    step's 7·H·N² per lane."""
    from repro_torch.models.rwkv6 import MAA_RANK, TD_RANK
    D, F, H, N = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.rwkv_head_dim
    macs = D * (2 * 5 * MAA_RANK + 2 * TD_RANK) + 6 * D * D + 2 * D * F
    return L * B * (2.0 * macs + 7.0 * H * N * N)


def _k7_block_bytes(lp, st, x) -> int:
    """The bytes one K7-block call must move: the layer's own tensors
    (codes, scales or codebooks, vectors), x in and out, the state in and
    out."""
    from repro_torch.tree import leaves_with_path
    w = sum(t.numel() * t.element_size() for _, t in leaves_with_path(lp))
    return w + 2 * x.numel() * x.element_size() + 2 * _state6_bytes(st)


def _k7_model_bytes(stack, st, x) -> int:
    """The bytes one K7-model call must move: the slabs, the shared scales
    and codebooks, the state in and out, x in and out."""
    w = sum(t.numel() * t.element_size() for t in stack.slabs.values())
    aux = sum(a.numel() * a.element_size() for a in stack.aux)
    return w + aux + 2 * _state6_bytes(st) + 2 * x.numel() * x.element_size()


def _cpu_plain_block(lp, st, x, cfg):
    """K7-block's plain version on the CPU, the result back on the card."""
    from repro_torch.kernels.fused_decode import rwkv6_block_decode_plain
    from repro_torch.tree import tree_map
    cpu = lambda t: t.cpu()
    xo, so = rwkv6_block_decode_plain(tree_map(cpu, lp), tree_map(cpu, st),
                                      cpu(x), cfg)
    return xo.to(DEV), {k: v.to(DEV) for k, v in so.items()}


def _worst(per_layer, who):
    """The largest gap over the layers, per output and measure."""
    return {name: {m: max(g[who][name][m] for g in per_layer)
                   for m in ("max_rel", "mean_rel")}
            for name in ("x",) + STATE6}


def _k7_sixteen(call, wrapper, cfg, lead, what):
    """K7 at B = 16 (two 8-lane tiles, two launches) against two 8-lane
    calls on the same lanes, bit for bit: a lane's bits do not depend on
    its tile.  `lead` is the state's leading (layer) dims."""
    st, x = _state6(cfg, lead + (16,), SEED + 11)
    before = wrapper.launches
    xo, so = call(st, x)
    if wrapper.launches != before + 2:
        raise AssertionError(f"{what} at B = 16 launched "
                             f"{wrapper.launches - before} times, not 2")
    ax = len(lead)
    for i in (0, 8):
        xt, stt = call({k: v.narrow(ax, i, 8) for k, v in st.items()},
                       x[i:i + 8])
        if not (torch.equal(xt, xo[i:i + 8]) and all(
                torch.equal(stt[k], so[k].narrow(ax, i, 8))
                for k in STATE6)):
            raise AssertionError(f"{what} at B = 16: lanes {i}-{i + 7} "
                                 "differ from an 8-lane call")
    _line({"kernel": wrapper.__name__, "B": 16, "tiles": 2,
           "equals_two_8_lane_calls": True})


def phase_k7_block(engine, flush, usage):
    """K7-block on layer 0 of the engine's rwkv6-7b W8 tree at B = 8,
    against its plain version within K7B_* per output (the plain version
    on the CPU beside it), bit for bit for a lane alone; time, byte bound
    and ptxas registers."""
    from repro_torch.core.quant.serving import (
        broadcast_packed_scales, cast_compute)
    from repro_torch.kernels.fused_decode import (
        rwkv6_block_decode, rwkv6_block_decode_plain)
    from repro_torch.models.rwkv4 import _layer
    from repro_torch.tree import leaves_with_path
    cfg = engine.model.cfg
    B = 8
    blocks = broadcast_packed_scales(
        cast_compute(engine.plan.prepared.raw, torch.bfloat16)["blocks"],
        cfg.n_layers)
    lp = _layer(blocks, 0)
    st, x = _state6(cfg, (B,), SEED + 9)
    out = rwkv6_block_decode(lp, st, x, cfg)
    ref = rwkv6_block_decode_plain(lp, st, x, cfg)
    cpu = _cpu_plain_block(lp, st, x, cfg)
    gaps = {"kernel_vs_plain": _rel_gaps(out, ref),
            "plain_cpu_vs_card": _rel_gaps(cpu, ref)}
    _line({"kernel": "rwkv6_block_decode", "layer": 0, "gaps": gaps})
    err, mean_rel, _, _ = _k7_check(out, ref, "block, layer 0")
    one = rwkv6_block_decode(lp, {k: v[5:6] for k, v in st.items()},
                             x[5:6], cfg)
    if not (torch.equal(one[0][0], out[0][5]) and all(
            torch.equal(one[1][k][0], out[1][k][5]) for k in STATE6)):
        raise AssertionError("K7-block: a lane alone differs from the batch")
    _k7_sixteen(lambda s, xx: rwkv6_block_decode(lp, s, xx, cfg),
                rwkv6_block_decode, cfg, (), "K7-block")
    w_bytes = sum(t.numel() * t.element_size()
                  for _, t in leaves_with_path(lp))
    nbytes = _k7_block_bytes(lp, st, x)
    bms, by = _bound(nbytes, _k7_ops(cfg, B), PEAK_BF16_FLOPS)
    row = {"kernel": "rwkv6_block_decode", "model": cfg.name, "B": B,
           "D": cfg.d_model, "F": cfg.d_ff, "H": cfg.n_heads,
           "max_abs_err": err, "max_mean_rel_err": mean_rel, "gaps": gaps,
           "bounds": {"max_rel": K7B_MAX_REL, "mean_rel": K7B_MEAN_REL},
           "lane_alone_bit_exact": True, "weight_bytes": w_bytes,
           "bytes": nbytes,
           "kernel_ms": _time_ms(lambda: rwkv6_block_decode(lp, st, x, cfg),
                                 flush),
           "plain_ms": _time_ms(
               lambda: rwkv6_block_decode_plain(lp, st, x, cfg), flush, 3),
           "library_ms": None, "bound_ms": bms, "bound_by": by,
           "ptxas": _registers(usage, "rwkv6_decode_kernel")}
    _line(row)
    return row


def phase_k7_model(engine, flush, usage):
    """K7-model over the engine's prepared 32-layer slabs at B = 8: bit for
    bit equal to 32 K7-block launches, each of which holds K7B_* against
    the plain version on its own inputs (the plain version on the CPU
    beside it, layer by layer); then against its own plain version over
    all 32 layers, within 1.25x what that plain version reads between the
    CPU and the card from the same inputs."""
    from repro_torch.core.quant.serving import FusedLayerStack, unfuse_layer
    from repro_torch.kernels.fused_decode import (
        rwkv6_block_decode, rwkv6_block_decode_plain, rwkv6_model_decode,
        rwkv6_model_decode_plain)
    from repro_torch.tree import tree_map
    stack = engine.plan.prepared.decode["blocks"]
    cfg = engine.model.cfg
    L, B = cfg.n_layers, 8
    st, x = _state6(cfg, (L, B), SEED + 10)
    xm, newm = rwkv6_model_decode(stack, st, x, cfg)
    aux = [a[0] for a in stack.aux]
    xb, newb, checks, per_layer = x, [], [], []
    for l in range(L):
        lp = unfuse_layer({k: s[l] for k, s in stack.slabs.items()}, aux,
                          stack.manifest, stack.tdef)
        st_l = {k: st[k][l] for k in STATE6}
        out = rwkv6_block_decode(lp, st_l, xb, cfg)
        ref = rwkv6_block_decode_plain(lp, st_l, xb, cfg)
        per_layer.append({
            "kernel": _rel_gaps(out, ref),
            "plain_cpu": _rel_gaps(_cpu_plain_block(lp, st_l, xb, cfg),
                                   ref)})
        checks.append((out, ref))
        xb = out[0]
        newb.append(out[1])
    _line({"kernel": "rwkv6_block_decode", "layers": L,
           "worst_over_layers": {"kernel_vs_plain": _worst(per_layer,
                                                           "kernel"),
                                 "plain_cpu_vs_card": _worst(per_layer,
                                                             "plain_cpu")},
           "x_mean_rel_by_layer": {
               who: [g[who]["x"]["mean_rel"] for g in per_layer]
               for who in ("kernel", "plain_cpu")}})
    kb_err, kb_mean = 0.0, 0.0
    for l, (out, ref) in enumerate(checks):
        e, m, _, _ = _k7_check(out, ref, f"block, layer {l}")
        kb_err, kb_mean = max(kb_err, e), max(kb_mean, m)
    del checks
    if not (torch.equal(xm, xb) and all(
            torch.equal(newm[k], torch.stack([s[k] for s in newb]))
            for k in STATE6)):
        raise AssertionError(f"K7-model differs from {L} K7-block launches")
    _k7_sixteen(lambda s, xx: rwkv6_model_decode(stack, s, xx, cfg),
                rwkv6_model_decode, cfg, (L,), "K7-model")
    ref = rwkv6_model_decode_plain(stack, st, x, cfg)
    cpu = lambda t: t.cpu()
    on_cpu = rwkv6_model_decode_plain(
        FusedLayerStack(tree_map(cpu, stack.slabs),
                        tuple(map(cpu, stack.aux)), stack.manifest,
                        stack.tdef), tree_map(cpu, st), cpu(x), cfg)
    on_cpu = (on_cpu[0].to(DEV), {k: v.to(DEV) for k, v in on_cpu[1].items()})
    gaps = {"kernel_vs_plain": _rel_gaps((xm, newm), ref),
            "plain_cpu_vs_card": _rel_gaps(on_cpu, ref)}
    _line({"kernel": "rwkv6_model_decode", "layers": L, "gaps": gaps})
    err, mean_rel, max_b, mean_b = _k7_check((xm, newm), ref,
                                             f"model, {L} layers", on_cpu)
    w_bytes = sum(s.numel() * s.element_size() for s in stack.slabs.values())
    aux_bytes = sum(a.numel() * a.element_size() for a in stack.aux)
    nbytes = _k7_model_bytes(stack, st, x)
    bms, by = _bound(nbytes, _k7_ops(cfg, B, L), PEAK_BF16_FLOPS)
    row = {"kernel": "rwkv6_model_decode", "model": cfg.name, "L": L,
           "B": B, "D": cfg.d_model, "F": cfg.d_ff, "H": cfg.n_heads,
           "equals_block_per_layer": True,
           "block_per_layer_vs_plain": {"max_abs_err": kb_err,
                                        "max_mean_rel_err": kb_mean},
           "max_abs_err": err, "max_mean_rel_err": mean_rel, "gaps": gaps,
           "bounds": {"max_rel": max_b, "mean_rel": mean_b},
           "weight_bytes": w_bytes, "aux_bytes": aux_bytes, "bytes": nbytes,
           "kernel_ms": _time_ms(
               lambda: rwkv6_model_decode(stack, st, x, cfg), flush),
           "plain_ms": _time_ms(
               lambda: rwkv6_model_decode_plain(stack, st, x, cfg), flush, 2),
           "library_ms": None, "bound_ms": bms, "bound_by": by,
           "ptxas": _registers(usage, "rwkv6_decode_kernel")}
    _line(row)
    return row


def _rel_gaps(out, ref):
    """Per output of a K7 call: max |d| / max|ref| and mean |d| /
    mean|ref|."""
    gaps = {}
    for name in ("x",) + STATE6:
        o = out[0] if name == "x" else out[1][name]
        r = (ref[0] if name == "x" else ref[1][name]).float()
        d = (o.float() - r).abs()
        gaps[name] = {"max_rel": float(d.max() / r.abs().max()),
                      "mean_rel": float(d.mean() / r.abs().mean())}
    return gaps


def _plain_logits6(model, raw, toks, C, dtype):
    """rwkv6's plain per-op path over the same tokens: `decode_step` token
    by token, computed layer by layer (layer l at every position, then
    layer l+1: the same ops in another order of the loops), so that each
    layer's W8 planes are decoded once, inside the loop, and the 14 GB
    bf16 (28 GB f32) tree never exists whole.  With dtype=float32 it is
    the f32 witness: the W8 weights decoded and rounded to bf16, then
    widened exactly, the state, activations and products in f32."""
    from repro_torch.core.quant.serving import (
        broadcast_packed_scales, is_packed_leaf, unpack_leaf)
    from repro_torch.device import exact_matmuls
    from repro_torch.models import layers as L
    from repro_torch.models.rwkv4 import _layer
    from repro_torch.models.rwkv6 import block_decode
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(model.cfg, dtype=str(dtype).replace(
        "torch.", ""))
    plain = lambda t: (unpack_leaf(t) if is_packed_leaf(t) else t).to(
        torch.bfloat16).to(dtype)
    B, S = toks.shape
    blocks = broadcast_packed_scales(raw["blocks"], cfg.n_layers)
    with torch.inference_mode(), exact_matmuls():
        xs = raw["embed"][toks.long()].to(dtype)
        xs = L.apply_norm(tree_map(plain, raw["ln0"]), xs)
        for l in range(cfg.n_layers):
            lp = tree_map(plain, _layer(blocks, l), is_leaf=is_packed_leaf)
            st = {k: v[0] for k, v in model.module.init_decode_state(
                cfg, B, 0, dtype, toks.device).items()}
            outs = []
            for t in range(S):
                x, st = block_decode(lp, st, xs[:, t], cfg)
                outs.append(x)
            xs = torch.stack(outs, dim=1)
            del lp
        head = plain(raw["head"])
        xf = L.apply_norm(tree_map(plain, raw["ln_f"]), xs[:, C - 1:])
        logits = xf @ head
    return logits.transpose(0, 1)[:, :, None].float()   # (S-C+1, B, 1, V)


def phase_teacher_forced6(engine, refs):
    """rwkv6's kernel path vs the plain per-op path on the card, both held
    against the f32 witness, on the same tokens (8 lanes: a 16-token
    prefill chunk, then 32 decode steps).  The plain path and the witness
    do not depend on the kernel path, so `refs` keeps them for the second
    path.  The CPU pair of phase 3 is left out here: ~5 TFLOP on the
    host."""
    model, cfg = engine.model, engine.model.cfg
    B, C, S = 8, 16, 32
    if not refs:
        g = torch.Generator(device=DEV).manual_seed(SEED + 7)
        refs["toks"] = toks = torch.randint(
            0, cfg.vocab, (B, C + S), generator=g, device=DEV,
            dtype=torch.int32)
        raw = engine.plan.prepared.raw
        refs["ref"] = _plain_logits6(model, raw, toks, C, torch.bfloat16)
        refs["f32"] = _plain_logits6(model, raw, toks, C, torch.float32)
        refs["head_codes"] = raw["head"]["packed"].sum(dtype=torch.int64)
    if not torch.equal(engine.plan.prepared.raw["head"]["packed"].sum(
            dtype=torch.int64), refs["head_codes"]):
        raise AssertionError("the rwkv6 engines drew different weights")
    toks, ref, f32 = refs["toks"], refs["ref"], refs["f32"]
    out = _kernel_logits(engine, toks, C)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("kernel-path logits are not finite")
    if out.shape != (S + 1, B, 1, cfg.vocab) or out.shape != ref.shape:
        raise AssertionError(f"logits shape {tuple(out.shape)}")
    max_f32, max_ref = float(f32.abs().max()), float(ref.abs().max())
    gaps = {"kernel_vs_plain": _gap(out, ref),
            "kernel_vs_f32": _gap(out, f32),
            "plain_card_vs_f32": _gap(ref, f32)}
    # how far the plain path sits from the witness, step by step: the
    # noise grows through the steps (prefill chunk first)
    by_step = [float((ref[i] - f32[i]).abs().mean() / f32[i].abs().mean())
               for i in range(S + 1)]
    path = "rwkv6-" + engine.plan.prepared.decode_path
    # K7-model equals 32 K7-block launches, and the prefill is shared, so
    # the two paths' logits are the same bits
    same = refs.setdefault("kernel", out) is out or torch.equal(
        out, refs["kernel"])
    tb = TF_BOUNDS[path]
    kp, kf = gaps["kernel_vs_plain"], gaps["kernel_vs_f32"]
    ok = (kf["mean_rel"] <= tb["mean_rel_f32"]
          and kf["max_abs"] <= tb["max_rel_f32"] * max_f32
          and kf["argmax_agree"] >= tb["argmax_f32"]
          and kp["mean_rel"] <= tb["mean_rel_plain"]
          and kp["max_abs"] <= tb["max_rel_plain"] * max_ref)
    _line({"phase": "teacher_forced", "path": path, "steps": S + 1,
           "lanes": B, "max_abs_f32": max_f32, "max_abs_plain": max_ref,
           "gaps": gaps, "plain_card_vs_f32_mean_rel_by_step": by_step,
           "bounds": tb, "within_bound": ok, "equals_block_path": same})
    if not ok:
        raise AssertionError(f"teacher-forced logits out of bounds: {gaps}")
    if not same:
        raise AssertionError("the rwkv6 model path's logits differ from "
                             "the block path's")


def _decode_windows(fn, codes, aux, w_bf, rows=128):
    """`fn`'s decode on identity windows of `rows` rows, at the plane's
    first and last rows, against w_bf (unpack_leaf's) bit for bit."""
    K = w_bf.shape[0]
    rows = min(rows, K)
    for r0 in (0, K - rows):
        x = torch.zeros((rows, K), device=DEV)
        x[torch.arange(rows), r0 + torch.arange(rows)] = 1
        if not torch.equal(fn(x, codes, aux), w_bf[r0:r0 + rows].float()):
            raise AssertionError(f"{fn.__name__}: rows {r0}.. decode other "
                                 "than unpack_leaf")


def phase_k7_form(model, raw, stack, flush, form):
    """K7 on a rwkv6-7b tree of another weight form (MIXED planes, or plain
    bf16 weights) at B = 8: K7-model over the prepared slabs bit for bit
    equal to 32 K7-block launches, each of which holds K7B_* against the
    plain version on its own inputs (on the card); a lane alone bit for
    bit; under MIXED the W4 and VQ decodes (att.wk, ffn.wv of layer 0)
    bit for bit against unpack_leaf on identity windows, through K5-W4's
    and K5-VQ's f32-x forms, which share K7's decode functions
    (csrc/common.cuh).  The times and byte bounds of both forms; rows
    (block, model)."""
    from repro_torch.core.quant.serving import (
        CODES_KEY, broadcast_packed_scales, cast_compute, unpack_leaf)
    from repro_torch.kernels import fused_prefill as fp
    from repro_torch.kernels.fused_decode import (
        rwkv6_block_decode, rwkv6_block_decode_plain, rwkv6_model_decode,
        rwkv6_model_decode_plain)
    from repro_torch.models.rwkv4 import _layer
    from repro_torch.tree import leaves_with_path
    cfg = model.cfg
    L, B = cfg.n_layers, 8
    blocks = broadcast_packed_scales(
        cast_compute(raw, torch.bfloat16)["blocks"], L)
    st, x = _state6(cfg, (L, B), SEED + 30)
    xm, newm = rwkv6_model_decode(stack, st, x, cfg)
    xb, newb, kb_err, kb_mean = x, [], 0.0, 0.0
    for l in range(L):
        lp = _layer(blocks, l)
        st_l = {k: st[k][l] for k in STATE6}
        out = rwkv6_block_decode(lp, st_l, xb, cfg)
        e, m, _, _ = _k7_check(out, rwkv6_block_decode_plain(
            lp, st_l, xb, cfg), f"{form} block, layer {l}")
        kb_err, kb_mean = max(kb_err, e), max(kb_mean, m)
        xb = out[0]
        newb.append(out[1])
    if not (torch.equal(xm, xb) and all(
            torch.equal(newm[k], torch.stack([s[k] for s in newb]))
            for k in STATE6)):
        raise AssertionError(f"K7-model {form} differs from {L} K7-block "
                             "launches")
    del newb
    lp = _layer(blocks, 0)
    st0 = {k: v[0] for k, v in st.items()}
    out0 = rwkv6_block_decode(lp, st0, x, cfg)
    one = rwkv6_block_decode(lp, {k: v[5:6] for k, v in st0.items()},
                             x[5:6], cfg)
    if not (torch.equal(one[0][0], out0[0][5]) and all(
            torch.equal(one[1][k][0], out0[1][k][5]) for k in STATE6)):
        raise AssertionError(f"K7-block {form}: a lane alone differs")
    if form == "mixed":
        for path, plane in (("wk", "w4"), ("wv", "vq")):
            leaf = raw["blocks"]["att" if path == "wk" else "ffn"][path]
            codes = leaf[CODES_KEY[plane]][0]
            aux = leaf[F32X_AUX[plane]].reshape(-1)
            w_bf = unpack_leaf({CODES_KEY[plane]: codes,
                                F32X_AUX[plane]: aux.reshape(1, -1)})
            _decode_windows(getattr(fp, F32X_FN[plane] + "_f32x"), codes,
                            aux, w_bf)
    w0 = sum(t.numel() * t.element_size() for _, t in leaves_with_path(lp))
    b_bytes = _k7_block_bytes(lp, st0, x)
    bms, by = _bound(b_bytes, _k7_ops(cfg, B), PEAK_BF16_FLOPS)
    block = {"kernel": "rwkv6_block_decode", "planes": form,
             "model": cfg.name, "B": B, "D": cfg.d_model, "F": cfg.d_ff,
             "H": cfg.n_heads, "max_abs_err": kb_err,
             "max_mean_rel_err": kb_mean,
             "bounds": {"max_rel": K7B_MAX_REL, "mean_rel": K7B_MEAN_REL},
             "lane_alone_bit_exact": True, "weight_bytes": w0,
             "bytes": b_bytes,
             "kernel_ms": _time_ms(
                 lambda: rwkv6_block_decode(lp, st0, x, cfg), flush),
             "plain_ms": _time_ms(
                 lambda: rwkv6_block_decode_plain(lp, st0, x, cfg), flush, 3),
             "library_ms": None, "bound_ms": bms, "bound_by": by,
             "ptxas": _registers(_BUILD_USAGE, "rwkv6_decode_kernel")}
    _line(block)
    w_bytes = sum(t.numel() * t.element_size() for t in stack.slabs.values())
    aux_bytes = sum(a.numel() * a.element_size() for a in stack.aux)
    m_bytes = _k7_model_bytes(stack, st, x)
    bms, by = _bound(m_bytes, _k7_ops(cfg, B, L), PEAK_BF16_FLOPS)
    mrow = {"kernel": "rwkv6_model_decode", "planes": form,
            "model": cfg.name, "L": L, "B": B, "D": cfg.d_model,
            "F": cfg.d_ff, "H": cfg.n_heads, "equals_block_per_layer": True,
            "max_abs_err": kb_err, "max_mean_rel_err": kb_mean,
            "weight_bytes": w_bytes, "aux_bytes": aux_bytes,
            "bytes": m_bytes,
            "kernel_ms": _time_ms(
                lambda: rwkv6_model_decode(stack, st, x, cfg), flush),
            "plain_ms": _time_ms(
                lambda: rwkv6_model_decode_plain(stack, st, x, cfg), flush,
                2),
            "library_ms": None, "bound_ms": bms, "bound_by": by,
            "ptxas": _registers(_BUILD_USAGE, "rwkv6_decode_kernel")}
    _line(mrow)
    return block, mrow


def phase_k7_bf16(model, params, flush):
    """K7 on the forward section's plain bf16 rwkv6-7b tree: the slab stack
    built here (another 15 GB) and dropped on return; `phase_k7_form`,
    then one decode step through each kernel path as a user calls it."""
    from repro_torch.kernels.fused_decode import (
        rwkv6_block_decode, rwkv6_model_decode)
    from repro_torch.models.rwkv6 import prepare_fused_model_params
    prep = prepare_fused_model_params(params, model.cfg)
    rows = phase_k7_form(model, params, prep["blocks"], flush, "bf16")
    paths = {"rwkv6-bf16-block": phase_path_step(
                 model, params, "block", (rwkv6_block_decode,),
                 "rwkv6-bf16-block"),
             "rwkv6-bf16-model": phase_path_step(
                 model, prep, "model", (rwkv6_model_decode,),
                 "rwkv6-bf16-model")}
    return rows, paths


def phase_teacher_forced6_plain(engine):
    """rwkv6's kernel path on another weight form (the MIXED engine) vs the
    plain bf16 per-op path on the same tree, on the card, on
    phase_teacher_forced6's tokens: no farther than that phase's W8 path
    may sit from its plain path (TF_BOUNDS["rwkv6-model"]'s kernel-vs-plain
    bounds).  The f32 witness is left out (the W8 path reads it)."""
    model, cfg = engine.model, engine.model.cfg
    B, C, S = 8, 16, 32
    g = torch.Generator(device=DEV).manual_seed(SEED + 7)
    toks = torch.randint(0, cfg.vocab, (B, C + S), generator=g, device=DEV,
                         dtype=torch.int32)
    ref = _plain_logits6(model, engine.plan.prepared.raw, toks, C,
                         torch.bfloat16)
    out = _kernel_logits(engine, toks, C)
    if not bool(torch.isfinite(out).all()) or out.shape != ref.shape:
        raise AssertionError(f"kernel-path logits {tuple(out.shape)}, "
                             f"finite {bool(torch.isfinite(out).all())}")
    tb = TF_BOUNDS["rwkv6-model"]
    max_ref = float(ref.abs().max())
    kp = _gap(out, ref)
    ok = kp["mean_rel"] <= tb["mean_rel_plain"] and \
        kp["max_abs"] <= tb["max_rel_plain"] * max_ref
    _line({"phase": "teacher_forced", "path": "rwkv6-mixed-model",
           "steps": S + 1, "lanes": B, "max_abs_plain": max_ref,
           "gaps": {"kernel_vs_plain": kp},
           "bounds": {"mean_rel": tb["mean_rel_plain"],
                      "max_abs": tb["max_rel_plain"] * max_ref},
           "within_bound": ok})
    if not ok:
        raise AssertionError(f"MIXED teacher-forced logits out of bounds: "
                             f"{kp}")


# ---------------------------------------------------------------------------
# smollm-135m: the dense transformer's prefill through K13, and its decode
# ---------------------------------------------------------------------------


def _attn_floor(q, k, v, causal):
    """The f32 summation bound of each K13 output: (Skv + d + 8)·2^-24
    times (p @ |v|) / l, the most that summing the scores and p·v in
    another order (and an exp a few ulps off) can move it; near a zero
    output it passes any bound relative to that output (K5's rwkv6 floor,
    for attention)."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    mag = flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                causal=causal)
    return (k.shape[1] + q.shape[-1] + 8) * 2.0 ** -24 * mag


def _attn_bound(B, Sq, Skv, H, KVH, d, causal, elem):
    """K13's least time: q, k, v read and out written once; 4·d operations
    for each (query, key) pair the mask keeps (two products), at the peak
    of the inputs' type."""
    nbytes = elem * (2 * B * Sq * H * d + 2 * B * Skv * KVH * d)
    if causal:
        pairs = sum(min(i + 1, Skv) for i in range(Sq))
    else:
        pairs = Sq * Skv
    peak = PEAK_BF16_FLOPS if elem == 2 else PEAK_F32_FLOPS
    return _bound(nbytes, 4.0 * d * pairs * B * H, peak)


# K13's shapes: smollm-135m's prefill first (timed), then the routing
# threshold, a ragged length, a full (non-causal) case, phi3's and
# minitron's head layouts, and f32 with the lse
K13_SHAPES = (
    (8, 2048, 9, 3, 64, True, torch.bfloat16),
    (8, 512, 9, 3, 64, True, torch.bfloat16),
    (8, 600, 9, 3, 64, True, torch.bfloat16),
    (2, 1000, 9, 3, 64, False, torch.bfloat16),
    (2, 1024, 32, 32, 96, True, torch.bfloat16),
    (2, 1024, 24, 8, 128, True, torch.bfloat16),
    (2, 700, 9, 3, 64, True, torch.float32),
)


def phase_k13(flush, usage):
    """K13 against its plain version at every shape of K13_SHAPES: bf16
    outputs within one bf16 step (|d| <= 2^-7 |ref|), f32 outputs within
    2^-22 |ref|, each plus the f32 summation bound `_attn_floor`; the lse
    within (Skv + d + 8)·2^-24·(1 + max|lse|).  Both sides compute in f32
    from the same inputs and differ only in the order of their sums.
    Timed at the first shape and at the bf16 d 128 one, with
    F.scaled_dot_product_attention (is_causal, enable_gqa) as the library
    yardstick, which the port never calls.  The first row carries the
    ptxas lines of the bf16 tensor-core instances."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    rows = []
    for i, (B, S, H, KVH, d, causal, dt) in enumerate(K13_SHAPES):
        g = torch.Generator(device=DEV).manual_seed(SEED + 40 + i)
        rn = lambda *s: torch.randn(s, generator=g, device=DEV).to(dt)
        q, k, v = rn(B, S, H, d), rn(B, S, KVH, d), rn(B, S, KVH, d)
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        ref, lse_p = flash_attention_plain(q, k, v, causal=causal,
                                           return_lse=True)
        rel = 2.0 ** -7 if dt == torch.bfloat16 else 2.0 ** -22
        dd = (out.float() - ref.float()).abs()
        if not bool((dd <= rel * ref.float().abs()
                     + _attn_floor(q, k, v, causal)).all()):
            raise AssertionError(f"K13 {K13_SHAPES[i]}: max |d| "
                                 f"{float(dd.max())}")
        dl = float((lse - lse_p).abs().max())
        if dl > (S + d + 8) * 2.0 ** -24 * (1.0 + float(lse_p.abs().max())):
            raise AssertionError(f"K13 {K13_SHAPES[i]}: lse max |d| {dl}")
        elem = 2 if dt == torch.bfloat16 else 4
        bms, by = _attn_bound(B, S, S, H, KVH, d, causal, elem)
        row = {"kernel": "flash_attention", "B": B, "S": S, "H": H,
               "KVH": KVH, "d": d, "causal": causal, "dtype": str(dt),
               "max_abs_err": float(dd.max()), "lse_max_abs_err": dl,
               "bound_ms": bms, "bound_by": by}
        if i == 0:
            row["ptxas"] = _registers(usage, "flash_fwd_tc_kernel")
        if i == 0 or (d == 128 and dt == torch.bfloat16):
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            row.update(
                kernel_ms=_time_ms(
                    lambda: flash_attention(q, k, v, causal=causal), flush),
                plain_ms=_time_ms(lambda: flash_attention_plain(
                    q, k, v, causal=causal), flush),
                library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True), flush))
        _line(row)
        rows.append(row)
        del q, k, v, out, ref, lse, lse_p, dd
    return rows


def _smollm(use_flash_kernel, dtype="bfloat16"):
    from repro_torch.models.registry import get_model
    cfg = get_model("smollm-135m").cfg
    return get_model(dataclasses.replace(
        cfg, use_flash_kernel=use_flash_kernel, dtype=dtype))


def _logits_gaps(out, ref):
    """_gap over (B, S, V) logits, with the scale each is relative to."""
    out, ref = out.float(), ref.float()
    gaps = _gap(out, ref)
    gaps["max_rel"] = gaps["max_abs"] / float(ref.abs().max())
    return gaps


def phase_prefill(params):
    """smollm-135m's prefill step at full width and depth (L30 D576 H9
    KVH3 hd64 F1536 V49152), B = 8, S = 2048, through K13: the step from
    `build_prefill_step` on a model with use_flash_kernel, K13's counter
    set to 0 just before the step and read just after (it must read 30,
    one launch a layer).  Its logits are held against the same forward
    with the plain attention on the card and against an f32 witness of
    the same model (the bf16 weights widened exactly, f32 activations and
    products, the plain attention) within PREFILL_BOUNDS.  Then the step
    is timed, with the plain-attention step beside it."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.core.quant.serving import cast_compute
    B, S = 8, 2048
    flash, plain = _smollm(True), _smollm(False)
    g = torch.Generator(device=DEV).manual_seed(SEED + 50)
    toks = torch.randint(0, flash.cfg.vocab, (B, S), generator=g,
                         device=DEV)
    step, plain_step = build_prefill_step(flash), build_prefill_step(plain)
    batch = {"tokens": toks}
    with torch.inference_mode():
        flash_attention.launches = 0
        logits = step(params, batch)
        torch.cuda.synchronize()
        launches = flash_attention.launches
        if launches != flash.cfg.n_layers:
            raise AssertionError(f"K13 launched {launches} times in the "
                                 f"prefill step, not {flash.cfg.n_layers}")
        if logits.shape != (B, S, flash.cfg.vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError("prefill logits: bad shape or not finite")
        ref = plain_step(params, batch)
        witness = build_prefill_step(_smollm(False, "float32"))(
            cast_compute(params, torch.float32), batch)
        gaps = {"kernel_vs_f32": _logits_gaps(logits, witness),
                "plain_vs_f32": _logits_gaps(ref, witness),
                "kernel_vs_plain": _logits_gaps(logits, ref)}
        del ref, witness
        times = {}
        for name, fn in (("plain", plain_step), ("k13", step),
                         ("k13_2", step), ("plain_2", plain_step)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(params, batch)
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0) * 1e3
    tb = PREFILL_BOUNDS
    kf, kp = gaps["kernel_vs_f32"], gaps["kernel_vs_plain"]
    ok = (kf["mean_rel"] <= tb["mean_rel_f32"]
          and kf["max_rel"] <= tb["max_rel_f32"]
          and kf["argmax_agree"] >= tb["argmax_f32"]
          and kp["mean_rel"] <= tb["mean_rel_plain"]
          and kp["max_rel"] <= tb["max_rel_plain"])
    step_ms = (times["k13"] + times["k13_2"]) / 2
    row = {"phase": "prefill", "arch": "smollm-135m", "B": B, "S": S,
           "k13_launches": launches, "gaps": gaps, "bounds": tb,
           "within_bound": ok, "step_ms": times,
           "prefill_tokens_per_s": B * S / (step_ms / 1e3)}
    _line(row)
    if not ok:
        raise AssertionError(f"prefill logits out of bounds: {gaps}")
    return {"smollm-prefill": {"flash_attention": launches}}


def phase_decode(params):
    """The dense transformer's KV-cache decode: `serve_legacy` at full
    width and depth (8 seeded first tokens, 32 greedy steps, a cache of
    40 positions; no kernel, it prints its tokens/s), then the slice's
    consistency check at B = 8, S = 512: the K13 forward's logits against
    the per-token `decode_step` chain over the same 512 tokens (the plain
    attention against the cache, written in place).  Both are bf16 paths
    that sum in other orders, so the chain is held within DECODE_SPREAD
    (1.25·√2) times the larger of the two paths' own gaps to an f32
    witness of the same model on the same tokens, read in the run."""
    from repro_torch.core.quant.serving import cast_compute
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import serve_legacy
    t0 = time.perf_counter()
    toks = serve_legacy("smollm-135m", smoke=False, batch=8, n_tokens=32,
                        seed=SEED, device=DEV)
    legacy_s = time.perf_counter() - t0
    V = _smollm(False).cfg.vocab
    if toks.shape != (8, 33) or int(toks.min()) < 0 or int(toks.max()) >= V:
        raise AssertionError(f"serve_legacy tokens {tuple(toks.shape)}")
    B, S = 8, 512
    flash = _smollm(True)
    g = torch.Generator(device=DEV).manual_seed(SEED + 51)
    seq = torch.randint(0, V, (B, S), generator=g, device=DEV)
    with torch.inference_mode():
        before = flash_attention.launches
        fwd = flash.forward(params, {"tokens": seq})[0]
        if flash_attention.launches != before + flash.cfg.n_layers:
            raise AssertionError("the S = 512 forward did not run K13 in "
                                 "every layer")
        witness = _smollm(False, "float32").forward(
            cast_compute(params, torch.float32), {"tokens": seq})[0]
        state = flash.init_decode_state(B, S, device=DEV)
        steps = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(S):
            lg, state = flash.decode_step(params, state, seq[:, t:t + 1], t)
            steps.append(lg[:, 0])
        torch.cuda.synchronize()
        chain_s = time.perf_counter() - t0
        chain = torch.stack(steps, dim=1)
        gaps = {"chain_vs_forward": _logits_gaps(chain, fwd),
                "chain_vs_f32": _logits_gaps(chain, witness),
                "forward_vs_f32": _logits_gaps(fwd, witness)}
    spread = max(gaps["chain_vs_f32"]["mean_rel"],
                 gaps["forward_vs_f32"]["mean_rel"])
    spread_max = max(gaps["chain_vs_f32"]["max_rel"],
                     gaps["forward_vs_f32"]["max_rel"])
    cf = gaps["chain_vs_forward"]
    ok = (cf["mean_rel"] <= DECODE_SPREAD * spread
          and cf["max_rel"] <= DECODE_SPREAD * spread_max)
    _line({"phase": "decode", "arch": "smollm-135m",
           "serve_legacy": {"batch": 8, "new_tokens": 32,
                            "seconds_with_init": legacy_s},
           "chain": {"B": B, "S": S, "seconds": chain_s,
                     "tokens_per_s": B * S / chain_s},
           "gaps": gaps, "bound_factor": DECODE_SPREAD, "within_bound": ok})
    if not ok:
        raise AssertionError(f"decode chain vs forward out of bounds: "
                             f"{gaps}")


# K13's backward: smollm-135m's train shape (timed), test_torch_flash.py's
# shapes (f32), phi3's d = 96 and minitron's d = 128 (timed), both bf16
K13_BWD_SHAPES = (
    (8, 2048, 9, 3, 64, True, torch.bfloat16),
    (2, 64, 4, 4, 32, True, torch.float32),
    (1, 128, 4, 2, 64, True, torch.float32),
    (2, 32, 2, 2, 16, False, torch.float32),
    (1, 256, 8, 1, 64, True, torch.float32),
    (1, 96, 9, 3, 64, True, torch.float32),
    (1, 48, 4, 4, 96, True, torch.float32),
    (2, 1024, 32, 32, 96, True, torch.bfloat16),
    (2, 1024, 24, 8, 128, True, torch.bfloat16),
)


def _bwd_bound(B, Sq, Skv, H, KVH, d, causal, elem, dots, outs):
    """K13-dq's or K13-dkv's least time: q, k, v, dout read once, lse and
    D (f32) once, its outputs (`outs`: "q" for dq, "kv" for dk and dv)
    written once; 2·d operations a (query, key) pair the mask keeps, for
    each of its `dots` products (kernel_traffic's counts: dq 3, dkv 4)."""
    qb, kb = elem * B * Sq * H * d, elem * B * Skv * KVH * d
    nbytes = 2 * qb + 2 * kb + 2 * 4 * B * H * Sq + (
        qb if outs == "q" else 2 * kb)
    pairs = (sum(min(i + 1, Skv) for i in range(Sq)) if causal
             else Sq * Skv)
    peak = PEAK_BF16_FLOPS if elem == 2 else PEAK_F32_FLOPS
    return _bound(nbytes, dots * 2.0 * d * pairs * B * H, peak)


def phase_k13_bwd(flush, usage):
    """K13-dq and K13-dkv against the plain backward at every shape of
    K13_BWD_SHAPES, within `bwd_bounds`; the two kernels timed at the
    train shape and at the bf16 d 128 one, each run twice there (bit for
    bit), with the plain backward and the library's backward
    (torch.autograd.grad through F.scaled_dot_product_attention(is_causal,
    enable_gqa) less its forward), which the port never calls.  The first
    row carries the ptxas lines of the bf16 tensor-core instances."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        _delta, bwd_bounds, flash_attention, flash_attention_bwd,
        flash_attention_bwd_plain, flash_attention_dkv, flash_attention_dq)
    rows = []
    for i, (B, S, H, KVH, d, causal, dt) in enumerate(K13_BWD_SHAPES):
        g = torch.Generator(device=DEV).manual_seed(SEED + 60 + i)
        rn = lambda *s: torch.randn(s, generator=g, device=DEV).to(dt)
        q, k, v, do = rn(B, S, H, d), rn(B, S, KVH, d), rn(B, S, KVH, d), \
            rn(B, S, H, d)
        o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        ref = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
        errs = []
        for name, x, r, bnd in zip(("dq", "dk", "dv"), got, ref, bwd_bounds(
                q, k, v, o, lse, do, causal, ref)):
            dd = (x.float() - r.float()).abs()
            if not bool((dd <= bnd).all()):
                raise AssertionError(f"K13 backward {K13_BWD_SHAPES[i]} "
                                     f"{name}: max |d| {float(dd.max())}")
            errs.append(float(dd.max()))
            del dd, bnd
        elem = 2 if dt == torch.bfloat16 else 4
        row = {"kernel": "flash_attention_bwd", "B": B, "S": S, "H": H,
               "KVH": KVH, "d": d, "causal": causal, "dtype": str(dt),
               "max_abs_err": {"dq": errs[0], "dk": errs[1],
                               "dv": errs[2]}}
        if i == 0:
            row["ptxas"] = _registers(usage, "flash_d(q|kv)_tc_kernel")
        if i == 0 or (d == 128 and dt == torch.bfloat16):
            again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError("K13's backward is not bit for bit "
                                     f"repeatable at {K13_BWD_SHAPES[i]}")
            delta = _delta(o, do)
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            dot = do.transpose(1, 2).contiguous()
            sdpa = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
            lib_fb = _time_ms(lambda: torch.autograd.grad(
                sdpa(), (qt, kt, vt), dot), flush)
            lib_f = _time_ms(sdpa, flush)
            row.update(
                bit_repeatable=True,
                dq_ms=_time_ms(lambda: flash_attention_dq(
                    q, k, v, o, lse, do, causal=causal, delta=delta), flush),
                dkv_ms=_time_ms(lambda: flash_attention_dkv(
                    q, k, v, o, lse, do, causal=causal, delta=delta), flush),
                plain_ms=_time_ms(lambda: flash_attention_bwd_plain(
                    q, k, v, o, lse, do, causal=causal), flush, 3),
                library_ms=lib_fb - lib_f, library_fwd_bwd_ms=lib_fb,
                library_fwd_ms=lib_f)
            for which, dots, outs in (("dq", 3, "q"), ("dkv", 4, "kv")):
                bms, by = _bwd_bound(B, S, S, H, KVH, d, causal, elem, dots,
                                     outs)
                row[f"{which}_bound_ms"], row[f"{which}_bound_by"] = bms, by
            del qt, kt, vt, dot, again
        _line(row)
        rows.append(row)
        del q, k, v, do, o, lse, got, ref
    return rows


# smollm-135m's train step 0 (phase_train), per gradient leaf and for the
# loss: the relative gap mean|d| / mean|witness| (|d| / |witness| for the
# loss) of the K13 path to the f32 witness within 1.25x what the
# plain-attention bf16 path read against it on an H100, and of the K13
# path to the plain path within 1.25·√2x that reading (two bf16 paths,
# each that far from the witness): TF_BOUNDS' recipe, from the first
# reading on an H100, in PERF.md §6.  Through 30 layers of random weights
# every bf16 path's gradients sit 1.3–4.3% (mean) from the witness.
_TRAIN_PLAIN = {
    "blocks.dense.attn.wk": 0.026668, "blocks.dense.attn.wo": 0.017821,
    "blocks.dense.attn.wq": 0.027003, "blocks.dense.attn.wv": 0.017657,
    "blocks.dense.ln1.scale": 0.018228, "blocks.dense.ln2.scale": 0.021509,
    "blocks.dense.mlp.wg": 0.021737, "blocks.dense.mlp.wi": 0.022711,
    "blocks.dense.mlp.wo": 0.021686, "embed": 0.043065,
    "ln_f.scale": 0.013545, "loss": 6.464e-05}
TRAIN_BOUNDS = {
    "kernel_vs_f32": {n: 1.25 * v for n, v in _TRAIN_PLAIN.items()},
    "kernel_vs_plain": {n: 1.25 * 2 ** 0.5 * v
                        for n, v in _TRAIN_PLAIN.items()}}


def _grad_gaps(got, ref):
    """Per leaf of two gradient trees: mean |d| / mean |ref|."""
    from repro_torch.tree import leaves_with_path
    r = dict(leaves_with_path(ref))
    return {".".join(p): float((g.float() - r[p].float()).abs().mean()
                               / r[p].float().abs().mean())
            for p, g in leaves_with_path(got)}


def _train_ops(model, B, S):
    """The train step's operations: 6·N·T for the matmuls (N the weights,
    the tied embedding counted once, as the head), 2·N_blocks·T for remat's
    re-forward of the blocks, and 11 attention products a layer (the
    forward 2, its recompute 2, dq 3, dkv 4) of 2·d operations per causal
    (query, key) pair and head."""
    cfg = model.cfg
    N = model.param_count()
    n_blocks = N - cfg.vocab * cfg.d_model - cfg.d_model   # less embed, ln_f
    T = B * S
    pairs = S * (S + 1) // 2
    attn = 11 * 2.0 * cfg.resolved_head_dim * pairs * B * cfg.n_heads
    return {"matmuls": 6.0 * N * T, "remat": 2.0 * n_blocks * T,
            "attention": cfg.n_layers * attn}


def _split(call, finish=None, *, by_line=False):
    """One more call of `call`, after a warm one, split: the host's time
    to enqueue it (until `call` returns), the whole call (until
    `finish(out)` returns: a read back to the host, default a
    synchronize) and the device's span between events recorded around
    it; then a third call under torch.profiler for the device's busy time
    (the sum of the device-side events' time: kernels, memcpys, memsets;
    the host-side ops that launch them also carry it and are not counted;
    None where the profiler sees no device event) and the 8 names that
    take most of it.  With `by_line` the profiled call runs under
    `_LineMarks`, and the device time of every aten op is keyed by the
    model line that issued it and the op's name; device time no aten op
    claims (the hand-written kernels, launched through ctypes) is
    `unclaimed_device_ms`.  The profiled call's host times are not used:
    tracing slows the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    finish = finish or (lambda out: torch.cuda.synchronize())
    finish(call())
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    s.record()
    out = call()
    t1 = time.perf_counter()
    e.record()
    finish(out)
    t2 = time.perf_counter()
    torch.cuda.synchronize()
    del out
    marks = _LineMarks() if by_line else contextlib.nullcontext()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with marks:
            finish(call())
        torch.cuda.synchronize()
    # the device-side spans of `_LineMarks`' ranges are no device work
    dev = [(k.key, k.self_device_time_total / 1e3)
           for k in prof.key_averages() if k.device_type == DeviceType.CUDA
           and not k.key.startswith(_LineMarks.PREFIX)]
    busy = sum(ms for _, ms in dev)
    res = {"enqueue_ms": (t1 - t0) * 1e3, "step_ms": (t2 - t0) * 1e3,
           "device_span_ms": s.elapsed_time(e),
           "device_busy_ms": busy if dev else None,
           "top_device_ms": [[n[:80], ms] for n, ms in
                             sorted(dev, key=lambda x: -x[1])[:8]]}
    if by_line:
        lines = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CPU and \
                    ev.name.startswith(_LineMarks.PREFIX):
                key = ev.name[len(_LineMarks.PREFIX):]
                lines[key] = lines.get(key, 0.0) + \
                    ev.device_time_total / 1e3
        res["top_device_ms_by_line"] = [
            [k, ms] for k, ms in sorted(lines.items(), key=lambda x: -x[1])
            [:16]]
        res["unclaimed_device_ms"] = busy - sum(lines.values())
    return res


class _LineMarks(TorchDispatchMode):
    """Runs each aten op inside a profiler range named "line: <the model
    line that issued it> | <op>": the first frame under
    repro_torch/models/ on the Python stack
    (`launch/op_analysis.model_line`), or for an op the autograd engine
    issues outside the model's Python, its backward node ("backward
    <node>").  The range's device time is the op's kernels' time."""

    PREFIX = "line: "

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from repro_torch.launch.op_analysis import model_line
        where = model_line()
        if where is None:
            node = torch._C._current_autograd_node()
            where = ("outside models/" if node is None
                     else f"backward {node.name()}")
        name = f"{self.PREFIX}{where} | {func.overloadpacket.__name__}"
        with torch.profiler.record_function(name):
            return func(*args, **(kwargs or {}))


def _reading(name, call, finish=None, *, by_line=False):
    """One of phase_split's readings: `_split` of `call`, and beside it
    `launch/op_analysis.py`'s count of one more call on the same CUDA
    tensors (its FLOPs, bytes, kernel launches and 8 largest ops by bytes,
    keyed by model line with `by_line`) and the roofline of that count
    (`launch/roofline.py`, H100 SXM peaks).  Prints and returns it."""
    from repro_torch.launch import roofline
    from repro_torch.launch.op_analysis import analyze_call
    split = _split(call, finish, by_line=by_line)
    m = analyze_call(lambda: (finish or (lambda o: None))(call()),
                     stack=by_line)
    torch.cuda.synchronize()
    r = roofline.analyze(m)
    row = {"split": name, **split,
           "count": {"flops": m.flops, "hbm_bytes": m.hbm_bytes,
                     "flop_counter_flops": m.flop_counter_flops,
                     "kernels": m.kernels, "seconds": m.seconds,
                     "top_ops_by_bytes": [[k, st.count, st.flops, st.bytes]
                                          for k, st in m.top(8)]},
           "roofline": {"compute_ms": r.compute_s * 1e3,
                        "memory_ms": r.memory_s * 1e3,
                        "collective_ms": r.collective_s * 1e3,
                        "bottleneck": r.bottleneck}}
    _line(row)
    return row


def _step_split(model, params, batch, *, by_line=False):
    """`_split` of one more train step on `params` (a fresh AdamW state),
    its finish the loss read back, as `train_model` times a step; with
    `by_line`, `_reading`'s count and roofline of one more step
    beside it."""
    from repro_torch.launch.steps import build_train_step
    step_fn, _, (init_opt, _) = build_train_step(model)
    st = {"params": params, "opt": init_opt(params)}

    def call():
        st["params"], st["opt"], m = step_fn(st["params"], st["opt"], batch)
        return m
    finish = lambda m: float(m["loss"])
    if by_line:
        return _reading(f"train {model.cfg.name} L{model.cfg.n_layers}",
                        call, finish, by_line=True)
    return _split(call, finish)


def phase_train():
    """smollm-135m's train step at full width and depth (L30 D576 H9 KVH3
    hd64 F1536 V49152), B = 8, S = 2048, SyntheticLM tokens, f32 master
    weights from the seed, AdamW, remat, every layer's attention through
    K13, K13-dq and K13-dkv, the loss through K12 and K12-bwd.  Step 0's
    loss and gradients (`loss_and_grads`, the train step's own) with the
    K13 and K12 counters set to 0 just before and read just after (60
    forward, 30 dq, 30 dkv, one K12, one K12-bwd) are held against the
    same step with the plain attention and K12's plain version (bf16,
    under `_PlainKernels`) and against an f32 witness (the f32 config on
    the same weights, both plain), per leaf (TRAIN_BOUNDS, set against
    that plain path).  The plain step is timed under `_PlainKernels` too.
    Then `train_model` runs 3 steps with the counters set to 0 just before
    and read just after (3 x those); losses finite; the steps' ms,
    tokens/s and the peak device memory, beside the step's operations
    bound; then `_step_split` on the trained weights."""
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.fused_ce import (
        fused_cross_entropy, fused_cross_entropy_bwd)
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_dkv, flash_attention_dq)
    from repro_torch.launch.steps import build_train_step, loss_and_grads
    from repro_torch.launch.train import train_model
    B, S, steps = 8, 2048, 3
    flash, plain = _smollm(True), _smollm(False)
    counters = (flash_attention, flash_attention_dq, flash_attention_dkv,
                fused_cross_entropy, fused_cross_entropy_bwd)
    L = flash.cfg.n_layers
    per_step = (2 * L, L, L, 1, 1)
    params = flash.init_params(SEED, DEV)
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in SyntheticLM(
        vocab=flash.cfg.vocab, seq_len=S, global_batch=B,
        seed=SEED).batch(0).items()}
    for c in counters:
        c.launches = 0
    (loss_k, _), g_k = loss_and_grads(flash, params, batch)
    torch.cuda.synchronize()
    step0 = tuple(c.launches for c in counters)
    if step0 != per_step:
        raise AssertionError(f"step 0 launched K13, dq, dkv, K12, K12-bwd "
                             f"{step0} times, not {per_step}")
    with _PlainKernels():
        (loss_p, _), g_p = loss_and_grads(plain, params, batch)
        (loss_w, _), g_w = loss_and_grads(_smollm(False, "float32"), params,
                                          batch)
    losses = [float(x) for x in (loss_k, loss_p, loss_w)]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"step 0 losses not finite: {losses}")
    gaps = {"kernel_vs_f32": _grad_gaps(g_k, g_w),
            "plain_vs_f32": _grad_gaps(g_p, g_w),
            "kernel_vs_plain": _grad_gaps(g_k, g_p)}
    for who, x in (("kernel_vs_f32", losses[0]), ("plain_vs_f32", losses[1]),
                   ("kernel_vs_plain", losses[0])):
        ref = losses[1] if who == "kernel_vs_plain" else losses[2]
        gaps[who]["loss"] = abs(x - ref) / abs(ref)
    del g_k, g_p, g_w
    bounds = TRAIN_BOUNDS
    bad = {(w, n): gaps[w][n] for w in bounds for n in bounds[w]
           if gaps[w][n] > bounds[w][n]}
    _line({"phase": "train_step0", "arch": "smollm-135m", "B": B, "S": S,
           "losses": {"k13": losses[0], "plain": losses[1],
                      "f32": losses[2]},
           "launches": {c.__name__: n for c, n in zip(counters, step0)},
           "gaps": gaps, "bounds": bounds, "within_bound": not bad})
    if bad:
        raise AssertionError(f"train step 0 out of bounds: {bad}")
    del params, batch
    _release()
    # the plain-attention step, timed once beside the K13 steps
    p_plain = plain.init_params(SEED, DEV)
    step_p, _, (init_p, _) = build_train_step(plain)
    opt_p = init_p(p_plain)
    b0 = {k: torch.from_numpy(v).to(DEV) for k, v in SyntheticLM(
        vocab=plain.cfg.vocab, seq_len=S, global_batch=B,
        seed=SEED).batch(0).items()}
    with _PlainKernels():
        step_p(p_plain, opt_p, b0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_p(p_plain, opt_p, b0)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    del p_plain, opt_p, b0
    _release()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    out = train_model(flash, steps=steps, global_batch=B, seq_len=S,
                      seed=SEED, device=DEV, log_every=1)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    want = {c.__name__: steps * n for c, n in zip(counters, per_step)}
    if launches != want:
        raise AssertionError(f"{steps} train steps launched {launches}, not "
                             f"{want}")
    if not all(np.isfinite(out["losses"])):
        raise AssertionError(f"train losses not finite: {out['losses']}")
    ops = _train_ops(flash, B, S)
    step_ms = [t * 1e3 for t in out["step_s"]]
    steady = sum(step_ms[1:]) / len(step_ms[1:])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    split = _step_split(flash, out["params"], {
        k: torch.from_numpy(v).to(DEV) for k, v in SyntheticLM(
            vocab=flash.cfg.vocab, seq_len=S, global_batch=B,
            seed=SEED).batch(steps).items()})
    _line({"phase": "train", "arch": "smollm-135m", "B": B, "S": S,
           "steps": steps, "losses": out["losses"], "step_ms": step_ms,
           "plain_attention_step_ms": plain_ms,
           "train_tokens_per_s": B * S / (steady / 1e3),
           "max_memory_allocated_gib": peak,
           "launches": launches, "ops": ops,
           "bound_ms": sum(ops.values()) / PEAK_BF16_FLOPS * 1e3,
           "split": split})
    del out
    _release()
    return {"smollm-train": launches}


# ---------------------------------------------------------------------------
# The RWKV whole-sequence forward: K10 (chunked WKV-6), K11 (LayerNorm), and
# the forwards of rwkv4-169m and rwkv6-7b through them
# ---------------------------------------------------------------------------

# K10's shapes (B, T, H, N, s0, decay shift, bf16 r/k/v): a chunk, several
# chunks of the real head size, a ragged T (the chunk halves to 32), the
# smoke model's N = 16, strong decay, where e^L underflows to 0, and the
# forward's types (bf16 r, k, v; f32 w) at a mid size
K10_SHAPES = (
    (1, 64, 1, 64, False, 0.0, False),
    (2, 256, 4, 64, True, 0.0, False),
    (2, 96, 4, 64, True, 0.0, True),
    (2, 128, 4, 16, True, 0.0, True),
    (1, 256, 4, 64, True, 3.0, False),
    (1, 4096, 64, 64, False, 0.0, True),
)
# K11's shapes (rows, D, dtype): rwkv6-7b's forward rows at B1 S32768 (the
# first, timed), rwkv4-169m's at B8 S1024, in both types, then ragged row
# counts and a D that takes no vector loads
K11_SHAPES = (
    (32768, 4096, torch.bfloat16), (32768, 4096, torch.float32),
    (8192, 768, torch.bfloat16), (8192, 768, torch.float32),
    (1000, 4096, torch.bfloat16), (37, 768, torch.float32),
    (5, 100, torch.bfloat16),
)
# The forwards' logits, the TF_BOUNDS recipe: 1.25x what the plain path
# (the plain versions on the card) read against the f32 witness in its
# first run on an H100 (its argmax disagreement 1.25x), and 1.25·√2x that
# for the kernel path against the plain one, two bf16 paths each that far
# from the witness (PERF.md §6, the RWKV forward's entry, run 2):
#   rwkv4-169m exact (B8 S1024): mean 0.013894, max 0.015126 of max|f32|,
#     argmax agreement 0.96704;
#   rwkv4-169m hw: mean 0.046184, max 0.048522, argmax 0.89514 (the hw
#     numerics in f32 are the witness);
#   rwkv6-7b (B2 S512, 32 layers): mean 0.31101, max 0.42432, argmax
#     0.42578, the ~31% every bf16 path sits from the witness after 32
#     random layers, so this one catches a gross fault only; K10 and K11
#     are held per call above.
RWKV4_FWD_BOUNDS = {
    False: {"mean_rel_f32": 0.0174, "max_rel_f32": 0.019,
            "argmax_f32": 0.9588, "mean_rel_plain": 0.0246,
            "max_rel_plain": 0.0268},
    True: {"mean_rel_f32": 0.0578, "max_rel_f32": 0.0607,
           "argmax_f32": 0.8689, "mean_rel_plain": 0.0817,
           "max_rel_plain": 0.0858},
}
RWKV6_FWD_BOUNDS = {"mean_rel_f32": 0.3888, "max_rel_f32": 0.5305,
                    "argmax_f32": 0.2822, "mean_rel_plain": 0.5499,
                    "max_rel_plain": 0.7502}


def _k10_bound(r, k, v, w, u, s0):
    """The most that K10 and its plain version, two f32 evaluations of the
    same chunked WKV-6 in other orders, may differ by per output of y and
    S: (8·G + 2C + 2N + 16)·2^-24 times the output's magnitude (the plain
    version on |r|, |k|, |v|, |u|, |s0|, each sum's absolute terms; the
    state's error carried through G chunks), plus 2C·2^-23·max|log w| of
    it, for the card's log a last bit off the kernel's logf, which moves
    every L after it.  Returns (y bound, S bound, relative factor)."""
    from repro_torch.kernels.wkv6 import chunk_length, wkv6_chunked_plain
    B, T, H, N = r.shape
    C = chunk_length(T)
    G = T // C
    mag = wkv6_chunked_plain(r.float().abs(), k.float().abs(),
                             v.float().abs(), w, u.abs(),
                             None if s0 is None else s0.abs())
    logw = float(torch.log(torch.clamp(w.float(), min=1e-38)).abs().max())
    rel = (8 * G + 2 * C + 2 * N + 16) * 2.0 ** -24 \
        + 2 * C * 2.0 ** -23 * logw
    return rel * mag[0], rel * mag[1], rel


def _k10_cost(r, w, s0):
    """K10's bytes (r, k, v, w read once in their types, u, s0, y and the
    final state) and operations: a chunk of C tokens needs, per head, 4CN²
    multiply-adds (the inter-chunk product and the state update), 7·N per
    strictly-lower pair (C(C-1)/2 of them: a subtraction, an exponential,
    three products and sums), ~15·C·N elementwise operations (log, cumsum,
    the decays, the bonus) and 2N²; each exponential and log counts as one
    operation at the f32 rate."""
    from repro_torch.kernels.wkv6 import chunk_length
    B, T, H, N = r.shape
    C = chunk_length(T)
    elems = B * T * H * N
    nbytes = (3 * r.element_size() + w.element_size() + 4) * elems \
        + 4 * H * N + 4 * B * H * N * N * (2 if s0 is not None else 1)
    pairs = C * (C - 1) // 2
    ops = B * H * (T // C) * (4 * C * N * N + 7 * pairs * N + 15 * C * N
                              + 2 * N * N)
    return nbytes, ops


def _k10_two_level_ops(r, v):
    """The work of K10's two-level form (`csrc/wkv6_chunked.cu`) on these
    shapes: (CUDA-core operations, bf16 tensor-core flops).  Per chunk of C
    tokens and head: 7·N per strictly-lower pair inside the 16-row diagonal
    blocks (the exact pairwise exponents), ~15·C·N elementwise (log,
    cumsum, decays, bonus) plus 3·C·N for the rows' and 3·N per earlier key
    of each sub-chunk for the keys' factored decays, and 2N² for the state
    update; the products ΔS_g and (r e^Lprev) @ S (2·C·N² each), the
    factored blocks below the diagonal and att @ v (2N a pair), each
    counted once per bf16 piece product the kernel runs: six for f32 x
    f32, three for f32 x a bf16 v (six for an f32 v)."""
    from repro_torch.kernels.wkv6 import chunk_length
    B, T, H, N = r.shape
    C = chunk_length(T)
    chunks = B * H * (T // C)
    n_sub = -(-C // 16)
    lens = [min(16, C - 16 * a) for a in range(n_sub)]
    pairs = C * (C - 1) // 2
    diag = sum(x * (x - 1) // 2 for x in lens)
    keys = sum(16 * a for a in range(n_sub))
    pv = 3 if v.dtype == torch.bfloat16 else 6
    cuda_ops = chunks * (7 * N * diag + 15 * C * N + 3 * C * N
                         + 3 * N * keys + 2 * N * N)
    mma_flops = chunks * 2 * N * (C * N * (pv + 6) + 6 * (pairs - diag)
                                  + pv * pairs)
    return cuda_ops, mma_flops


def _k10_bound_ms(r, v, w, s0):
    """K10's least time and its parts: the larger of its bytes
    (`_k10_cost`) over 3.35 TB/s and the two-level form's CUDA-core
    operations at the f32 rate plus its piece products at the bf16
    tensor-core rate (`_k10_two_level_ops`); beside it the one-level form's
    operations (`_k10_cost`) at the f32 rate, the bound before K10 ran its
    products on the tensor cores."""
    nbytes, ops = _k10_cost(r, w, s0)
    cuda_ops, mma_flops = _k10_two_level_ops(r, v)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (cuda_ops / PEAK_F32_FLOPS + mma_flops / PEAK_BF16_FLOPS) * 1e3
    return {"bytes": nbytes, "ops": cuda_ops, "mma_flops": mma_flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_bound_ms": t_bytes, "ops_bound_ms": t_ops,
            "one_level_ops": ops,
            "one_level_f32_bound_ms": ops / PEAK_F32_FLOPS * 1e3}


def _k10_check(what, r, k, v, w, u, s0, flush=None):
    """K10 against its plain version within `_k10_bound`; timed (the plain
    version once, it takes ~1 s at B1 T32768) when `flush` is given."""
    from repro_torch.kernels.wkv6 import (
        chunk_length, wkv6_chunked_kernel, wkv6_chunked_plain)
    y, S = wkv6_chunked_kernel(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    y_p, S_p = wkv6_chunked_plain(r, k, v, w, u, s0)
    by, bS, rel = _k10_bound(r, k, v, w, u, s0)
    dy, dS = (y - y_p).abs(), (S - S_p).abs()
    ok = bool((dy <= by).all()) and bool((dS <= bS).all()) and bool(
        torch.isfinite(y).all()) and bool(torch.isfinite(S).all())
    B, T, H, N = r.shape
    row = {"kernel": "wkv6_chunked_kernel", "what": what, "B": B, "T": T,
           "H": H, "N": N, "C": chunk_length(T), "s0": s0 is not None,
           "rkv_dtype": str(r.dtype), "max_abs_err": float(
               torch.maximum(dy.max(), dS.max())),
           "y_max_abs_err": float(dy.max()), "S_max_abs_err": float(dS.max()),
           # the largest |d| / (bound / rel): the error in units of the
           # outputs' magnitude, against the bound's factor `rel`
           "y_err_per_mag": float((dy * rel / by.clamp(min=1e-30)).max()),
           "S_err_per_mag": float((dS * rel / bS.clamp(min=1e-30)).max()),
           "bound_rel": rel, "within_bound": ok,
           **_k10_bound_ms(r, v, w, s0), "library_ms": None}
    if flush is not None:
        row["kernel_ms"] = _time_ms(
            lambda: wkv6_chunked_kernel(r, k, v, w, u, s0), flush)
        row["plain_ms"] = _time_ms(
            lambda: wkv6_chunked_plain(r, k, v, w, u, s0), flush, reps=1)
    _line(row)
    if not ok:
        raise AssertionError(f"K10 {what} {(B, T, H, N)}: y max |d| "
                             f"{float(dy.max())}, S max |d| "
                             f"{float(dS.max())}")
    return row


def _layer0_input(params, toks):
    """Layer 0's parameters and its TimeMix input, ln1(ln0(embed)), as an
    RWKV forward computes them on bf16 weights."""
    from repro_torch.models.layers import layernorm_kernel
    from repro_torch.models.rwkv4 import _layer
    lp = _layer(params["blocks"], 0)
    x = params["embed"][toks.long()].to(torch.bfloat16)
    return lp, layernorm_kernel(lp["ln1"], layernorm_kernel(params["ln0"], x))


def _rwkv6_layer0_operands(model, params, toks):
    """Layer 0's WKV operands of rwkv6's forward on `toks`: r, k, v bf16,
    w and u f32, as `_time_mix_seq` hands them to K10."""
    from repro_torch.models import rwkv6
    with torch.no_grad():
        lp, h = _layer0_input(params, toks)
        r, k, v, w, u, _ = rwkv6._wkv_operands(lp["att"], h, model.cfg)
    return r, k, v, w, u


def phase_k10(flush, layer0):
    """K10 against its plain version at every shape of K10_SHAPES (random
    operands, w = exp(-exp(0.5·z + shift))), then on rwkv6-7b's layer-0
    operands at B1 T32768, timed there, within `_k10_bound`."""
    from repro_torch.kernels.wkv6 import wkv6_chunked_kernel
    rows = []
    for i, (B, T, H, N, with_s0, shift, bf) in enumerate(K10_SHAPES):
        g = torch.Generator(device=DEV).manual_seed(SEED + 60 + i)
        rn = lambda *s: torch.randn(s, generator=g, device=DEV)
        dt = torch.bfloat16 if bf else torch.float32
        r, k, v = (rn(B, T, H, N).to(dt) for _ in range(3))
        w = torch.exp(-torch.exp(0.5 * rn(B, T, H, N) + shift))
        s0 = rn(B, H, N, N) if with_s0 else None
        rows.append(_k10_check("random", r, k, v, w, 0.5 * rn(H, N), s0))
    rows.append(_k10_check("rwkv6-7b layer 0", *layer0, None, flush))
    y = wkv6_chunked_kernel(*layer0)[0]
    if not torch.equal(y, wkv6_chunked_kernel(*layer0)[0]):
        raise AssertionError("K10 is not repeatable bit for bit")
    return rows


def _ln_floor(x, gamma, beta, eps=1e-5):
    """The f32 sum-order bound of each LayerNorm output: the row's mean and
    E[x²] summed in another order move by up to (D + 2)·2^-24 of their
    absolute sums, which moves var, then rsqrt (a few ulps apart on the
    two sides), then (x − μ)·rs·γ + β, each op one more rounding."""
    u = 2.0 ** -24
    x32 = x.float()
    D = x.shape[-1]
    mu = x32.mean(-1, keepdim=True)
    ex2 = (x32 * x32).mean(-1, keepdim=True)
    var = ex2 - mu * mu
    em = (D + 2) * u * x32.abs().mean(-1, keepdim=True)
    e_var = (D + 2) * u * ex2 + 2 * mu.abs() * em + 2 * u * (ex2 + mu * mu)
    rs = torch.rsqrt(var + eps)
    rel_rs = 0.5 * e_var / (var + eps) + 4 * u
    yn = (x32 - mu).abs() * rs
    g, b = gamma.float().abs(), beta.float().abs()
    return g * (em * rs + yn * rel_rs) + 4 * u * (yn * g + b)


def phase_k11(flush):
    """K11 against its plain version at every shape of K11_SHAPES (x = 2z +
    0.5, γ and β standard normal, in x's type): |d| <= one step of the
    output's type (2^-7 |ref| in bf16, 2^-22 in f32) plus the f32 sum-order
    bound `_ln_floor`.  Timed at the first shape, with F.layer_norm (the
    same function in two passes; the port never calls it) beside it."""
    import torch.nn.functional as F
    from repro_torch.kernels.fused_layernorm import (
        fused_layernorm, fused_layernorm_plain)
    rows = []
    for i, (R, D, dt) in enumerate(K11_SHAPES):
        g = torch.Generator(device=DEV).manual_seed(SEED + 70 + i)
        rn = lambda *s: torch.randn(s, generator=g, device=DEV)
        x = (2 * rn(R, D) + 0.5).to(dt)
        gamma, beta = rn(D).to(dt), rn(D).to(dt)
        out = fused_layernorm(x, gamma, beta)
        ref = fused_layernorm_plain(x, gamma, beta)
        step = 2.0 ** -7 if dt == torch.bfloat16 else 2.0 ** -22
        d = (out.float() - ref.float()).abs()
        ok = bool((d <= step * ref.float().abs()
                   + 1.01 * _ln_floor(x, gamma, beta)).all())
        elem = x.element_size()
        bms, by = _bound(2 * R * D * elem + 2 * D * elem, 7.0 * R * D,
                         PEAK_F32_FLOPS)
        row = {"kernel": "fused_layernorm", "R": R, "D": D,
               "dtype": str(dt), "max_abs_err": float(d.max()),
               "within_bound": ok, "bound_ms": bms, "bound_by": by}
        if i == 0:
            row.update(
                kernel_ms=_time_ms(lambda: fused_layernorm(x, gamma, beta),
                                   flush),
                plain_ms=_time_ms(
                    lambda: fused_layernorm_plain(x, gamma, beta), flush),
                library_ms=_time_ms(lambda: F.layer_norm(
                    x, (D,), gamma, beta, 1e-5), flush))
        _line(row)
        if not ok:
            raise AssertionError(f"K11 {(R, D, dt)}: max |d| {float(d.max())}")
        rows.append(row)
        del x, out, ref, d
    return rows


class _PlainKernels:
    """Inside the block the RWKV forwards call the plain versions of K2,
    K6, K9, K10 and K11 (on the card), and `loss_fn` K12's: the plain path
    that each kernel path is held to."""

    def __enter__(self):
        from repro_torch.kernels.expsig import sigmoid_kernel_plain
        from repro_torch.kernels.fused_ce import fused_cross_entropy_plain
        from repro_torch.kernels.fused_layernorm import fused_layernorm_plain
        from repro_torch.kernels.wkv4 import wkv4_seq_plain
        from repro_torch.kernels.wkv6 import (
            wkv6_chunked_plain, wkv6_seq_plain)
        from repro_torch.models import layers, registry, rwkv4, rwkv6
        swaps = ((rwkv6, "wkv6_chunked_kernel", wkv6_chunked_plain),
                 (rwkv6, "wkv6_seq", wkv6_seq_plain),
                 (rwkv4, "wkv4_seq", wkv4_seq_plain),
                 (layers, "fused_layernorm", fused_layernorm_plain),
                 (rwkv4, "sigmoid_kernel", sigmoid_kernel_plain),
                 (registry, "fused_cross_entropy",
                  fused_cross_entropy_plain))
        self.saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
        for m, n, fn in swaps:
            setattr(m, n, fn)
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def _path_counters():
    """The launch counters of the RWKV forwards' and train steps' kernels."""
    from repro_torch.kernels.expsig import sigmoid_kernel
    from repro_torch.kernels.fused_ce import (
        fused_cross_entropy, fused_cross_entropy_bwd)
    from repro_torch.kernels.fused_layernorm import (
        fused_layernorm, fused_layernorm_bwd)
    from repro_torch.kernels.wkv4 import wkv4_seq, wkv4_seq_bwd
    from repro_torch.kernels.wkv6 import (
        wkv6_chunked_bwd, wkv6_chunked_kernel, wkv6_seq, wkv6_seq_bwd)
    return (fused_layernorm, fused_layernorm_bwd, wkv4_seq, wkv4_seq_bwd,
            fused_cross_entropy, fused_cross_entropy_bwd, sigmoid_kernel,
            wkv6_chunked_kernel, wkv6_seq, wkv6_chunked_bwd, wkv6_seq_bwd)


def _counted(fn, want, what):
    """The main-path run: every counter of `_path_counters` set to 0 just
    before fn runs and read just after; they must read `want` (absent
    names 0).  Returns fn's result and the counts."""
    counters = _path_counters()
    for c in counters:
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    got = {c.__name__: c.launches for c in counters}
    full = {c.__name__: want.get(c.__name__, 0) for c in counters}
    if got != full:
        raise AssertionError(f"{what} launched {got}, not {full}")
    return out, got


def _run_counted(step, params, batch, want, what):
    """A forward step counted by `_counted`, its logits finite."""
    logits, got = _counted(lambda: step(params, batch), want, what)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{what}: logits not finite")
    return logits, got


def _timed_steps(step, params, batch, n=2):
    """Host-clock ms of `n` calls of `step`, each ending in a synchronize,
    and the peak device memory over them."""
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(params, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        del out
    return ms, torch.cuda.max_memory_allocated() / 2 ** 30


def _fwd_gaps(model, params, batch, hw, bounds):
    """The kernel path's logits against the plain path (the plain versions
    on the card) and an f32 witness (the f32 config on the bf16 weights
    widened exactly, the plain versions), within `bounds`."""
    from repro_torch.core.quant.serving import cast_compute
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models.registry import get_model
    step = build_prefill_step(model, hw=hw)
    out = step(params, batch)
    with _PlainKernels():
        ref = step(params, batch)
        witness = build_prefill_step(get_model(dataclasses.replace(
            model.cfg, dtype="float32")), hw=hw)(
            cast_compute(params, torch.float32), batch)
    gaps = {"kernel_vs_f32": _logits_gaps(out, witness),
            "plain_vs_f32": _logits_gaps(ref, witness),
            "kernel_vs_plain": _logits_gaps(out, ref)}
    kf, kp = gaps["kernel_vs_f32"], gaps["kernel_vs_plain"]
    ok = (kf["mean_rel"] <= bounds["mean_rel_f32"]
          and kf["max_rel"] <= bounds["max_rel_f32"]
          and kf["argmax_agree"] >= bounds["argmax_f32"]
          and kp["mean_rel"] <= bounds["mean_rel_plain"]
          and kp["max_rel"] <= bounds["max_rel_plain"])
    return gaps, ok


def _k2_fwd_check(model, params, toks, hw, flush):
    """K2 on rwkv4-169m layer 0's operands as the forward hands them (B8
    T1024 C768: the zero state, no valid mask, the f32 carry; the EXP and
    DIV tables under hw) against its plain version on the same inputs:
    under hw bit for bit (phase_k2_hw's reason), else within phase_k2's
    elementwise rule.  The kernel timed L2-cold, the plain version once
    (a Python loop over T)."""
    from repro_torch.kernels.wkv4 import wkv4_seq, wkv4_seq_plain
    from repro_torch.models import rwkv4
    with torch.no_grad():
        lp, h = _layer0_input(params, toks)
        _, args, kw = rwkv4._wkv_operands(lp["att"], h,
                                          rwkv4._seq_numerics(hw))
    y, fin = wkv4_seq(*args, **kw)
    y_p, fin_p = wkv4_seq_plain(*args, **kw)
    err, exact = 0.0, True
    for name, o, r in zip(("y", "a", "b", "o"), (y, *fin), (y_p, *fin_p)):
        ok, e = _elementwise_ok(o, r)
        exact = exact and torch.equal(o, r)
        if not (exact if hw else ok):
            raise AssertionError(f"K2{'-hw' if hw else ''} forward shape "
                                 f"{name}: max |d| {e}")
        err = max(err, e)
    B, T, C = args[0].shape
    nbytes = 4 * (3 * B * T * C + 2 * C + 6 * B * C + (512 if hw else 0))
    bms, by = _bound(nbytes, (40.0 if hw else 20.0) * B * T * C,
                     PEAK_F32_FLOPS)
    row = {"kernel": "wkv4_seq", "numerics": "hw" if hw else "exact",
           "what": "rwkv4-169m layer 0, forward", "B": B, "T": T, "C": C,
           "max_abs_err": err, "bit_exact": exact,
           "kernel_ms": _time_ms(lambda: wkv4_seq(*args, **kw), flush),
           "plain_ms": _time_ms(lambda: wkv4_seq_plain(*args, **kw), flush,
                                reps=1),
           "library_ms": None, "bound_ms": bms, "bound_by": by,
           "ptxas": _k2_ptxas(hw, False, False)}
    _line(row)
    return row


def phase_rwkv4_forward(model, params, hw, flush):
    """rwkv4-169m's forward at full width and depth, B 8, S 1024 (the
    RWKV-4-Pile models' training context), through build_prefill_step
    under the exact or the hardware numerics: the counters read K11 26
    (2L + 2), K2 12 and, under hw, K9 24 (σ twice a layer); K2 held to
    its plain version on layer 0's operands (`_k2_fwd_check`); finite
    logits held to the plain path and the f32 witness within
    RWKV4_FWD_BOUNDS; step ms, tokens/s and peak device memory.  Returns
    the path's launches and the K2 check's row."""
    from repro_torch.launch.steps import build_prefill_step
    B, S, L = 8, 1024, model.cfg.n_layers
    g = torch.Generator(device=DEV).manual_seed(SEED + 80)
    batch = {"tokens": torch.randint(0, model.cfg.vocab, (B, S), generator=g,
                                     device=DEV)}
    step = build_prefill_step(model, hw=hw)
    want = {"fused_layernorm": 2 * L + 2, "wkv4_seq": L,
            "sigmoid_kernel": 2 * L if hw else 0}
    path = "rwkv4-forward" + ("-hw" if hw else "")
    logits, launches = _run_counted(step, params, batch, want, path)
    if logits.shape != (B, S, model.cfg.vocab):
        raise AssertionError(f"{path}: logits {tuple(logits.shape)}")
    del logits
    k2 = _k2_fwd_check(model, params, batch["tokens"], hw, flush)
    ms, peak = _timed_steps(step, params, batch)
    gaps, ok = _fwd_gaps(model, params, batch, hw, RWKV4_FWD_BOUNDS[hw])
    _line({"phase": "forward", "path": path, "arch": model.cfg.name, "B": B,
           "S": S, "launches": launches, "step_ms": ms,
           "tokens_per_s": B * S / (sum(ms) / len(ms) / 1e3),
           "max_memory_allocated_gib": peak, "gaps": gaps,
           "bounds": RWKV4_FWD_BOUNDS[hw], "within_bound": ok})
    if not ok:
        raise AssertionError(f"{path} logits out of bounds: {gaps}")
    return {path: launches}, k2


def _k6_fwd_check(model, params, toks):
    """K6 on rwkv6-7b layer 0's operands as the forward hands them at a
    length that is no multiple of the chunk (B2 T40 H64 N64: r, k, v
    widened from bf16, the zero f32 state, no valid mask, the f32 carry),
    held as phase_k6 holds it (`_k6_check`), and timed."""
    from repro_torch.kernels.wkv6 import wkv6_seq, wkv6_seq_plain
    r, k, v, w, u = _rwkv6_layer0_operands(model, params, toks)
    B, T, H, N = r.shape
    args = (r.float(), k.float(), v.float(), w, u,
            torch.zeros((B, H, N, N), dtype=torch.float32, device=DEV))
    err, _ = _k6_check(args, {}, "forward shape")
    _, bms, by = _k6_bound(B, T, H, N, 4, False)
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=DEV)
    row = {"kernel": "wkv6_seq", "what": "rwkv6-7b layer 0, forward S40",
           "B": B, "T": T, "H": H, "N": N, "max_abs_err": err,
           "state_bit_exact": True, "y_inorder_bit_exact": True,
           "kernel_ms": _time_ms(lambda: wkv6_seq(*args), flush),
           "plain_ms": _time_ms(lambda: wkv6_seq_plain(*args), flush),
           "bound_ms": bms, "bound_by": by}
    _line(row)
    return row


def _rwkv6_fwd_ops(cfg, B, S):
    """The rwkv6 forward's matmul operations, 2·(weights in products)·B·S:
    per layer wr, wk, wv, wg, wo (5·D²), the ddlerp and decay low-rank
    products (D·5·32 + 5·32·D, D·64 + 64·D), the channel mix (D² + 2·D·F);
    then the head, D·V."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab
    per_layer = 5 * D * D + 2 * 5 * 32 * D + 2 * 64 * D + D * D + 2 * D * F
    return 2.0 * (cfg.n_layers * per_layer + D * V) * B * S


def phase_rwkv6_forward(model, params, toks):
    """rwkv6-7b's forward at full width and depth, B 1, S 32768 (the
    prefill_32k cell's length; its batch of 32 cut to 1 to fit one card),
    through build_prefill_step: the counters read K10 32, K11 66 and no
    K6; finite logits; step ms, tokens/s and peak device memory beside the
    matmul bound.  Then at B 2, S 512 the logits against the plain path
    and the f32 witness within RWKV6_FWD_BOUNDS, and at S 40 (not a
    multiple of the chunk) K6 32 times and no K10, then K6 held to its
    plain version on layer 0's operands there (`_k6_fwd_check`).  Returns
    the paths' launches and the K6 check's row.  After the timed steps,
    `_reading` (phase_split) of one more forward: the device time outside
    K10 and K11 by kernel name, the count and its roofline."""
    from repro_torch.launch.steps import build_prefill_step
    L = model.cfg.n_layers
    B, S = toks.shape
    step = build_prefill_step(model)
    batch = {"tokens": toks}
    logits, launches = _run_counted(
        step, params, batch, {"wkv6_chunked_kernel": L,
                              "fused_layernorm": 2 * L + 2},
        "rwkv6-forward")
    if logits.shape != (B, S, model.cfg.vocab):
        raise AssertionError(f"rwkv6 forward: logits {tuple(logits.shape)}")
    del logits
    ms, peak = _timed_steps(step, params, batch)
    _reading(f"forward rwkv6-7b B{B} S{S}", lambda: step(params, batch))
    _release()
    ops = _rwkv6_fwd_ops(model.cfg, B, S)
    g = torch.Generator(device=DEV).manual_seed(SEED + 81)
    short = {"tokens": torch.randint(0, model.cfg.vocab, (2, 512),
                                     generator=g, device=DEV)}
    gaps, ok = _fwd_gaps(model, params, short, False, RWKV6_FWD_BOUNDS)
    _release()
    odd = {"tokens": short["tokens"][:, :40].contiguous()}
    _, launches40 = _run_counted(step, params, odd, {
        "wkv6_seq": L, "fused_layernorm": 2 * L + 2}, "rwkv6-forward S40")
    k6 = _k6_fwd_check(model, params, odd["tokens"])
    _line({"phase": "forward", "path": "rwkv6-forward",
           "arch": model.cfg.name, "B": B, "S": S, "launches": launches,
           "step_ms": ms, "tokens_per_s": B * S / (sum(ms) / len(ms) / 1e3),
           "max_memory_allocated_gib": peak, "matmul_ops": ops,
           "bound_ms": ops / PEAK_BF16_FLOPS * 1e3,
           "short_B2_S512": {"gaps": gaps, "bounds": RWKV6_FWD_BOUNDS,
                             "within_bound": ok},
           "S40_launches": launches40})
    if not ok:
        raise AssertionError(f"rwkv6 forward logits out of bounds: {gaps}")
    return {"rwkv6-forward": launches, "rwkv6-forward-s40": launches40}, k6


# ---------------------------------------------------------------------------
# rwkv4-169m's training: K12 and K12-bwd (the loss), K2-bwd and K11-bwd,
# the train step through them, and a checkpoint round trip
# ---------------------------------------------------------------------------

# K12's shapes (rows, V): rwkv4-169m's train step (B8 S1024 V50277) and
# smollm-135m's (B8 S2048 V49152), bf16 logits as the steps give them
K12_SHAPES = ((8192, 50277), (16384, 49152))
RWKV4_TRAIN_B, RWKV4_TRAIN_S = 8, 1024
# rwkv4-169m's train step 0 (phase_rwkv4_train), TRAIN_BOUNDS' recipe:
# per leaf mean |d| / mean |ref| (and the loss's relative gap), 1.25x what
# the plain path (the plain versions of K2, K11 and K12 on the card) read
# against the f32 witness in its first run on an H100 (PERF.md §6; the
# kernel path read 0.97–1.17x these there), and 1.25·√2x that
# for the kernel path against the plain one.
RWKV4_TRAIN_PLAIN = {
    "blocks.att.time_decay": 0.015229, "blocks.att.time_first": 0.014809,
    "blocks.att.time_mix_k": 0.011941, "blocks.att.time_mix_r": 0.017411,
    "blocks.att.time_mix_v": 0.013607, "blocks.att.wk": 0.012512,
    "blocks.att.wo": 0.0070425, "blocks.att.wr": 0.012031,
    "blocks.att.wv": 0.0069252, "blocks.ffn.time_mix_k": 0.014369,
    "blocks.ffn.time_mix_r": 0.015615, "blocks.ffn.wk": 0.010063,
    "blocks.ffn.wr": 0.011629, "blocks.ffn.wv": 0.0056013,
    "blocks.ln1.bias": 0.0048016, "blocks.ln1.scale": 0.0075631,
    "blocks.ln2.bias": 0.0054561, "blocks.ln2.scale": 0.0097185,
    "embed": 0.017582, "head": 0.0073783, "ln0.bias": 0.0050478,
    "ln0.scale": 0.0085883, "ln_f.bias": 0.0020366, "ln_f.scale": 0.0045826,
    "loss": 3.6961e-05}
RWKV4_TRAIN_BOUNDS = {
    "kernel_vs_f32": {n: 1.25 * v for n, v in RWKV4_TRAIN_PLAIN.items()},
    "kernel_vs_plain": {n: 1.25 * 2 ** 0.5 * v
                        for n, v in RWKV4_TRAIN_PLAIN.items()}}


def _ce_ok(x, nll, ref, dx, dx_ref, g):
    """K12 within 2^-16 + 2^-21 |ref| of the plain NLL, K12-bwd within one
    step of its type plus 2^-16 |g|·p of each entry, p = exp(x − lse) its
    probability (the reasons are in
    tests/test_torch_cuda.py:test_fused_cross_entropy)."""
    d = (nll - ref).abs()
    ok = bool((d <= 2.0 ** -16 + 2.0 ** -21 * ref.abs()).all())
    step = 2.0 ** -7 if dx.dtype == torch.bfloat16 else 2.0 ** -22
    x32 = x.float()
    p = torch.exp(x32 - torch.logsumexp(x32, dim=-1, keepdim=True))
    del x32
    dd = (dx.float() - dx_ref.float()).abs()
    ok_b = bool((dd <= step * dx_ref.float().abs()
                 + 2.0 ** -16 * g[:, None] * p).all())
    return ok and ok_b, float(d.max()), float(dd.max())


def _grad_ms(out, inputs, grad, flush, reps=REPS):
    """The device time of one autograd backward of `out` (its graph kept)."""
    return _time_ms(lambda: torch.autograd.grad(out, inputs, grad,
                                                retain_graph=True),
                    flush, reps)


def phase_k12(flush):
    """K12 and K12-bwd against their plain versions at K12_SHAPES (logits
    3·N(0, 1) in bf16, seeded labels, row cotangents g uniform in [0, 1)):
    the NLL, and the gradient through the autograd Function against the
    plain version's autograd gradient (`_ce_ok`); the backward twice, bit
    for bit.  Timed each: K12 beside the plain forward (log-softmax in f32
    and the gather) and F.cross_entropy(logits.float(), reduction="none")
    (the port never calls it); K12-bwd beside the plain version's autograd
    backward and F.cross_entropy's."""
    import torch.nn.functional as F
    from repro_torch.kernels.fused_ce import (
        fused_cross_entropy, fused_cross_entropy_bwd,
        fused_cross_entropy_plain)
    rows = []
    for i, (N, V) in enumerate(K12_SHAPES):
        g = torch.Generator(device=DEV).manual_seed(SEED + 90 + i)
        x = (3 * torch.randn((N, V), generator=g, device=DEV)).to(
            torch.bfloat16)
        lbl = torch.randint(0, V, (N,), generator=g, device=DEV,
                            dtype=torch.int32)
        gr = torch.rand((N,), generator=g, device=DEV)
        xa = x.clone().requires_grad_()
        nll = fused_cross_entropy(xa, lbl)
        (dx,) = torch.autograd.grad(nll, xa, gr)
        xr = x.clone().requires_grad_()
        ref = fused_cross_entropy_plain(xr, lbl)
        (dx_ref,) = torch.autograd.grad(ref, xr, gr, retain_graph=True)
        ok, err, err_b = _ce_ok(x, nll.detach(), ref.detach(), dx, dx_ref,
                                gr)
        lse = torch.logsumexp(x.float(), dim=-1)
        again = [fused_cross_entropy_bwd(x, lbl, lse, gr) for _ in range(2)]
        repeat = torch.equal(again[0], again[1])
        del again, dx, dx_ref
        elem = x.element_size()
        fb, fby = _bound(N * V * elem + 3 * N * 4, 4.0 * N * V,
                         PEAK_F32_FLOPS)
        bb, bby = _bound(2 * N * V * elem + 3 * N * 4, 4.0 * N * V,
                         PEAK_F32_FLOPS)
        xl = x.clone().requires_grad_()
        lib = F.cross_entropy(xl.float(), lbl.long(), reduction="none")
        with torch.no_grad():
            row = {"kernel": "fused_cross_entropy", "N": N, "V": V,
                   "dtype": "bfloat16", "max_abs_err": err,
                   "bwd_max_abs_err": err_b, "within_bound": ok,
                   "bwd_bit_repeat": repeat,
                   "kernel_ms": _time_ms(
                       lambda: fused_cross_entropy(x, lbl), flush),
                   "plain_ms": _time_ms(
                       lambda: fused_cross_entropy_plain(x, lbl), flush),
                   "library_ms": _time_ms(lambda: F.cross_entropy(
                       x.float(), lbl.long(), reduction="none"), flush),
                   "bound_ms": fb, "bound_by": fby,
                   "bwd_kernel_ms": _time_ms(
                       lambda: fused_cross_entropy_bwd(x, lbl, lse, gr),
                       flush)}
        row.update(bwd_plain_ms=_grad_ms(ref, xr, gr, flush),
                   bwd_library_ms=_grad_ms(lib, xl, gr, flush),
                   bwd_bound_ms=bb, bwd_bound_by=bby)
        _line(row)
        if not (ok and repeat):
            raise AssertionError(f"K12 {(N, V)}: nll {err}, dx {err_b}, "
                                 f"bit repeat {repeat}")
        rows.append(row)
        del x, xa, xr, xl, nll, ref, lib, lse
        _release()
    return rows


def _rwkv4_train_model():
    from repro_torch.models.registry import get_model
    cfg = get_model("rwkv4-169m").cfg
    return get_model(dataclasses.replace(cfg, dtype="bfloat16"))


def _train_batch(cfg, step=0):
    from repro_torch.data import SyntheticLM
    return {k: torch.from_numpy(v).to(DEV) for k, v in SyntheticLM(
        vocab=cfg.vocab, seq_len=RWKV4_TRAIN_S,
        global_batch=RWKV4_TRAIN_B, seed=SEED).batch(step).items()}


def _rwkv4_layer0(model, params, batch):
    """Layer 0's ln1 operands (x, γ, β) and WKV operands (k, v, w, u, the
    zero state) of the train step's forward, from the compute cast of the
    f32 masters."""
    from repro_torch.models import rwkv4
    from repro_torch.models.layers import layernorm_kernel
    cast = model.cast_params(params)
    with torch.no_grad():
        lp = rwkv4._layer(cast["blocks"], 0)
        x = layernorm_kernel(cast["ln0"], cast["embed"][
            batch["tokens"].long()].to(torch.bfloat16))
        h = layernorm_kernel(lp["ln1"], x)
        _, args, _ = rwkv4._wkv_operands(lp["att"], h, rwkv4._Std)
    return (x, lp["ln1"]["scale"], lp["ln1"]["bias"]), args


def phase_k2_bwd(layer0, flush):
    """K2-bwd on layer 0's WKV operands of rwkv4-169m's train step (B8
    T1024 C768, the zero state) with a seeded N(0, 1) output gradient:
    through the autograd Function against the plain version's autograd
    gradient, per output max |d| <= 2^-10 max|ref| and mean |d| <= 2^-13
    mean|ref| (tests/test_torch_cuda.py:test_wkv4_seq_bwd says why); twice,
    bit for bit.  Timed: the kernel L2-cold, the plain autograd backward
    once (a loop over T); no library call computes it."""
    from repro_torch.kernels.wkv4 import k2_plan, wkv4_seq, wkv4_seq_bwd, \
        wkv4_seq_plain
    k, v, w, u, a0, b0, o0 = layer0
    B, T, C = k.shape
    gy = torch.randn((B, T, C), device=DEV,
                     generator=torch.Generator(device=DEV).manual_seed(
                         SEED + 91))
    ins = [t.clone().requires_grad_() for t in (k, v, w, u)]
    y, _ = wkv4_seq(*ins, a0, b0, o0)
    got = torch.autograd.grad(y, ins, gy)
    ref_ins = [t.clone().requires_grad_() for t in (k, v, w, u)]
    y_ref, _ = wkv4_seq_plain(*ref_ins, a0, b0, o0)
    ref = torch.autograd.grad(y_ref, ref_ins, gy, retain_graph=True)
    errs, ok = {}, True
    for name, a, r in zip(("gk", "gv", "gw", "gu"), got, ref):
        good, e, mean = _spread_ok(a, r, 2.0 ** -10, 2.0 ** -13)
        errs[name] = {"max_abs": e, "mean_rel": mean}
        ok = ok and good and bool(torch.isfinite(a).all())
    again = wkv4_seq_bwd(k, v, w, u, a0, b0, o0, gy)
    repeat = all(torch.equal(a, b) for a, b in zip(again, got))
    del again
    # the function's bytes: k, v, gy read, gk, gv written, w, u read, gw,
    # gu written; the (a, b, o) checkpoints that the kernel writes at the
    # start of every chunk and reads back are its design's, reported
    # beside as scratch_bytes
    nbytes = 4 * (5 * B * T * C + 4 * C)
    bms, by = _bound(nbytes, 60.0 * B * T * C, PEAK_F32_FLOPS)
    row = {"kernel": "wkv4_seq_bwd", "what": "rwkv4-169m layer 0, train",
           "B": B, "T": T, "C": C,
           "max_abs_err": max(e["max_abs"] for e in errs.values()),
           "errors": errs, "within_bound": ok, "bit_repeat": repeat,
           "kernel_ms": _time_ms(
               lambda: wkv4_seq_bwd(k, v, w, u, a0, b0, o0, gy), flush),
           "plain_ms": _grad_ms(y_ref, ref_ins, gy, flush, reps=1),
           "library_ms": None, "bound_ms": bms, "bound_by": by,
           "scratch_bytes": 2 * k2_plan(B, T, C).checkpoint_bytes,
           "ptxas": _registers(_BUILD_USAGE, "wkv4_bwd_kernel")}
    _line(row)
    if not (ok and repeat):
        raise AssertionError(f"K2-bwd: {errs}, bit repeat {repeat}")
    return row


def phase_k11_bwd(ln1, flush):
    """K11-bwd on layer 0's ln1 operands of rwkv4-169m's train step
    ((8192, 768) bf16 x, bf16 γ and β) with a seeded N(0, 1) bf16 output
    gradient: through the autograd Function against the plain version's
    autograd gradient, dx within one bf16 step plus (D + 64)·2^-24
    rs·(|dx̂| + mean|dx̂| + |x̂|·mean|dx̂·x̂|), dγ and dβ within one step plus
    (R + 16)·2^-24 of Σ|dy·x̂| and Σ|dy| (tests/test_torch_cuda.py:
    test_fused_layernorm_bwd); twice, bit for bit.  Timed beside the plain
    version's autograd backward and F.layer_norm's."""
    import torch.nn.functional as F
    from repro_torch.kernels.fused_layernorm import (
        fused_layernorm, fused_layernorm_bwd, fused_layernorm_plain)
    x, gamma, beta = (t.detach().contiguous() for t in ln1)
    D = x.shape[-1]
    R = x.numel() // D
    dy = torch.randn(x.shape, device=DEV, generator=torch.Generator(
        device=DEV).manual_seed(SEED + 92)).to(x.dtype)

    def graph(fn):
        ins = [t.clone().requires_grad_() for t in (x, gamma, beta)]
        return fn(*ins), ins
    out, ins = graph(fused_layernorm)
    got = torch.autograd.grad(out, ins, dy)
    ref_out, ref_ins = graph(fused_layernorm_plain)
    ref = torch.autograd.grad(ref_out, ref_ins, dy, retain_graph=True)
    lib_out, lib_ins = graph(lambda a, g, b: F.layer_norm(a, (D,), g, b,
                                                          1e-5))
    x32, dy32 = x.float().reshape(R, D), dy.float().reshape(R, D)
    mu = x32.mean(-1, keepdim=True)
    rs = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) - mu * mu + 1e-5)
    xh = (x32 - mu) * rs
    dxh = dy32 * gamma.float()
    floors = (
        ((D + 64) * 2.0 ** -24 * rs * (
            dxh.abs() + dxh.abs().mean(-1, keepdim=True)
            + xh.abs() * (dxh * xh).abs().mean(-1, keepdim=True))
         ).reshape(x.shape),
        (R + 16) * 2.0 ** -24 * (dy32 * xh).abs().sum(0),
        (R + 16) * 2.0 ** -24 * dy32.abs().sum(0))
    errs, ok = {}, True
    for name, a, r, fl in zip(("dx", "dgamma", "dbeta"), got, ref, floors):
        d = (a.float() - r.float()).abs()
        errs[name] = float(d.max())
        ok = ok and bool((d <= 2.0 ** -7 * r.float().abs() + fl).all())
    again = fused_layernorm_bwd(x, gamma, beta, dy)
    repeat = all(torch.equal(a, b) for a, b in zip(again, got))
    del again, floors
    elem = x.element_size()
    bms, by = _bound(3 * R * D * elem + 3 * D * elem, 12.0 * R * D,
                     PEAK_F32_FLOPS)
    row = {"kernel": "fused_layernorm_bwd", "what":
           "rwkv4-169m layer 0 ln1, train", "R": R, "D": D,
           "dtype": str(x.dtype), "max_abs_err": max(errs.values()),
           "errors": errs, "within_bound": ok, "bit_repeat": repeat,
           "kernel_ms": _time_ms(
               lambda: fused_layernorm_bwd(x, gamma, beta, dy), flush),
           "plain_ms": _grad_ms(ref_out, ref_ins, dy, flush),
           "library_ms": _grad_ms(lib_out, lib_ins, dy, flush),
           "bound_ms": bms, "bound_by": by}
    _line(row)
    if not (ok and repeat):
        raise AssertionError(f"K11-bwd: {errs}, bit repeat {repeat}")
    return row


def _rwkv4_train_per_step(L):
    """Launches of one rwkv4 train step under remat: K11 at ln0, ln_f and
    twice a layer, again in each layer's recompute; K2 once a layer and
    again in the recompute; each backward once per forward call."""
    return {"fused_layernorm": 4 * L + 2, "fused_layernorm_bwd": 2 * L + 2,
            "wkv4_seq": 2 * L, "wkv4_seq_bwd": L,
            "fused_cross_entropy": 1, "fused_cross_entropy_bwd": 1}


def _rwkv4_train_ops(model, B, S):
    """6·N·T for the products (N = the weights in products: the blocks'
    matrices and the head; the embedding is a gather) and 2·N_blocks·T for
    remat's re-forward of the blocks."""
    cfg = model.cfg
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab
    n_blocks = cfg.n_layers * (5 * D * D + 2 * D * F)
    T = B * S
    return {"matmuls": 6.0 * (n_blocks + D * V) * T,
            "remat": 2.0 * n_blocks * T}


def _train_gaps(model, params, batch, kernel_out, f32_per_step=None):
    """Step 0's loss and gradients through the kernels (`kernel_out`, the
    counted run's), the plain path (the plain versions on the card, timed)
    and the f32 witness (the f32 config, the plain versions): (losses,
    gaps per leaf, plain ms, whether every kernel gradient is finite).
    With `f32_per_step`, also the f32 config through the kernels, counted
    by `_counted` to launch those kernels (gaps "f32_kernel_vs_f32", its
    loss a fourth loss), and the witness's own conditioning: the f32
    config, plain versions, on the master weights rounded to the compute
    dtype and nothing else rounded ("rounded_weights_vs_f32")."""
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.tree import leaves_with_path, tree_map
    (loss_k, _), g_k = kernel_out
    m32 = type(model)(cfg=dataclasses.replace(model.cfg, dtype="float32"),
                      module=model.module)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _PlainKernels():
        (loss_p, _), g_p = loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        (loss_w, _), g_w = loss_and_grads(m32, params, batch)
    losses = [float(x) for x in (loss_k, loss_p, loss_w)]
    gaps = {"kernel_vs_f32": _grad_gaps(g_k, g_w),
            "plain_vs_f32": _grad_gaps(g_p, g_w),
            "kernel_vs_plain": _grad_gaps(g_k, g_p)}
    for who, x, ref in (("kernel_vs_f32", losses[0], losses[2]),
                        ("plain_vs_f32", losses[1], losses[2]),
                        ("kernel_vs_plain", losses[0], losses[1])):
        gaps[who]["loss"] = abs(x - ref) / abs(ref)
    finite = all(bool(torch.isfinite(g).all())
                 for _, g in leaves_with_path(g_k))
    del g_p
    if f32_per_step is not None:
        ((loss_f, _), g_f), _ = _counted(
            lambda: loss_and_grads(m32, params, batch), f32_per_step,
            "the f32 step through the kernels")
        losses.append(float(loss_f))
        gaps["f32_kernel_vs_f32"] = _grad_gaps(g_f, g_w)
        gaps["f32_kernel_vs_f32"]["loss"] = abs(
            losses[3] - losses[2]) / abs(losses[2])
        finite = finite and all(bool(torch.isfinite(g).all())
                                for _, g in leaves_with_path(g_f))
        del g_f
        rounded = tree_map(lambda t: t.float(), model.cast_params(params))
        with _PlainKernels():
            (loss_r, _), g_r = loss_and_grads(m32, rounded, batch)
        gaps["rounded_weights_vs_f32"] = _grad_gaps(g_r, g_w)
        gaps["rounded_weights_vs_f32"]["loss"] = abs(
            float(loss_r) - losses[2]) / abs(losses[2])
        del g_r, rounded
    return losses, gaps, plain_ms, finite


def phase_rwkv4_train():
    """rwkv4-169m's training at full width and depth (L12 D768 F3072
    V50277), B 8, S 1024, SyntheticLM tokens, f32 master weights from the
    seed, AdamW, remat.  Step 0 (`loss_and_grads`) with every counter set
    to 0 just before and read just after (`_rwkv4_train_per_step`); its
    loss and gradients per leaf against the plain path (the plain versions
    of K2, K11 and K12 on the card) and an f32 witness (the f32 config, the
    plain versions), within RWKV4_TRAIN_BOUNDS; the plain step timed.
    Then `train_model` for 3 steps, the counters again (3x), finite
    losses, each step's ms, tokens/s and the peak device memory beside the
    step's operations bound; then the trained params through an
    AsyncCheckpointer into the checkout's build/ and back, bit for bit;
    then one more step split by `_step_split` (host enqueue, device span
    and busy time, the 8 kernels that take most of it).
    Returns the path's launches, the model and the restored tree (served
    by `phase_serve_trained`)."""
    import shutil
    from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import train_model
    from repro_torch.tree import leaves_with_path
    B, S, steps = RWKV4_TRAIN_B, RWKV4_TRAIN_S, 3
    model = _rwkv4_train_model()
    L = model.cfg.n_layers
    per_step = _rwkv4_train_per_step(L)
    params = model.init_params(SEED, DEV)
    batch = _train_batch(model.cfg)
    out, _ = _counted(lambda: loss_and_grads(model, params, batch),
                      per_step, "rwkv4 train step 0")
    losses, gaps, plain_ms, finite = _train_gaps(model, params, batch, out)
    del out
    if not all(np.isfinite(losses)):
        raise AssertionError(f"rwkv4 step 0 losses not finite: {losses}")
    bounds = RWKV4_TRAIN_BOUNDS
    bad = {(w, n): gaps[w][n] for w in bounds for n in bounds[w]
           if gaps[w][n] > bounds[w][n]}
    _line({"phase": "train_step0", "arch": "rwkv4-169m", "B": B, "S": S,
           "losses": {"kernels": losses[0], "plain": losses[1],
                      "f32": losses[2]},
           "launches": per_step, "plain_step_ms": plain_ms, "gaps": gaps,
           "bounds": bounds, "within_bound": not bad})
    if bad or not finite:
        raise AssertionError(f"rwkv4 train step 0 out of bounds: {bad}, "
                             f"finite gradients {finite}")
    del params, batch
    _release()
    torch.cuda.reset_peak_memory_stats()
    out, launches = _counted(
        lambda: train_model(model, steps=steps, global_batch=B, seq_len=S,
                            seed=SEED, device=DEV, log_every=1),
        {n: steps * c for n, c in per_step.items()}, "rwkv4 train")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(out["losses"])):
        raise AssertionError(f"train losses not finite: {out['losses']}")
    ops = _rwkv4_train_ops(model, B, S)
    step_ms = [t * 1e3 for t in out["step_s"]]
    steady = sum(step_ms[1:]) / len(step_ms[1:])
    ck_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ck_dir, ignore_errors=True)
    t0 = time.perf_counter()
    ck = AsyncCheckpointer(str(ck_dir))
    ck.save(steps, out["params"])
    save_s = time.perf_counter() - t0
    ck.wait()
    back = restore_checkpoint(str(ck_dir), steps, out["params"])
    ck_s = time.perf_counter() - t0
    equal = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves_with_path(out["params"]), leaves_with_path(back)))
    shutil.rmtree(ck_dir, ignore_errors=True)
    split = _step_split(model, out["params"], _train_batch(model.cfg))
    _line({"phase": "train", "arch": "rwkv4-169m", "B": B, "S": S,
           "steps": steps, "losses": out["losses"], "step_ms": step_ms,
           "train_tokens_per_s": B * S / (steady / 1e3),
           "max_memory_allocated_gib": peak, "launches": launches,
           "ops": ops, "bound_ms": sum(ops.values()) / PEAK_BF16_FLOPS * 1e3,
           "checkpoint": {"bit_equal": equal, "save_return_s": save_s,
                          "save_restore_s": ck_s}, "split": split})
    if not equal:
        raise AssertionError("the checkpoint round trip changed a bit")
    del out
    _release()
    return {"rwkv4-train": launches}, model, back


# ---------------------------------------------------------------------------
# rwkv6-7b's training at full width, cut in depth: K10-bwd and K6-bwd on
# layer 0's operands, the train step through them
# ---------------------------------------------------------------------------

# rwkv6-7b at depth 4 of 32 (the one-card memory cut: ~1.42 B params, ~23
# GB of f32 masters, gradients and AdamW moments), B 4, S 1024 (K10), and
# the K6 route's short step at B 2, S 40 (no multiple of the chunk)
RWKV6_TRAIN_L, RWKV6_TRAIN_B, RWKV6_TRAIN_S = 4, 4, 1024
RWKV6_SHORT_B, RWKV6_SHORT_S = 2, 40
# rwkv6's train step 0 (phase_rwkv6_train), TRAIN_BOUNDS' recipe: per leaf
# mean |d| / mean |ref|, 1.25x what the plain path (the plain versions of
# K10, K11 and K12 on the card) read against the f32 witness in its first
# run on an H100 (PERF.md §6), and 1.25·√2x that for the kernel
# path against the plain one.  The loss is one number, its gap a chance
# like a leaf's max (RWKV4_TRAIN_BOUNDS' reasoning for the max: two bf16
# paths each a bf16 noise distance from the witness may sit √2 apart), so
# it is held within 1.25·√2x against the witness too (a factor chosen
# after the kernel path read 1.55x the plain one's 4.5e-5 there).  At 4096
# wide every bf16 path's gradients sit far from the f32 witness (mean gaps
# 0.3-4.4, u's 21): this random init's gradient is ill-conditioned, and
# the witness itself moves most of that far on its weights rounded to bf16
# ("rounded_weights_vs_f32" in `_train_gaps`).  So these catch a gross
# fault only; the f32 step through the kernels is held tightly
# (RWKV6_TRAIN_F32_BOUNDS), and K10-bwd and K6-bwd per output in their
# phases.
RWKV6_TRAIN_PLAIN = {
    "blocks.att.ln_x.bias": 0.66711, "blocks.att.ln_x.scale": 0.6503,
    "blocks.att.maa_w1": 2.2043, "blocks.att.maa_w2": 1.9794,
    "blocks.att.td_w1": 0.4961, "blocks.att.td_w2": 0.32269,
    "blocks.att.time_decay": 0.31895, "blocks.att.time_faaaa": 21.293,
    "blocks.att.time_maa": 2.4447, "blocks.att.time_maa_x": 2.6944,
    "blocks.att.wg": 0.67161, "blocks.att.wk": 0.81749,
    "blocks.att.wo": 0.62675, "blocks.att.wr": 0.87346,
    "blocks.att.wv": 0.68523, "blocks.ffn.time_mix_k": 0.95074,
    "blocks.ffn.time_mix_r": 0.85632, "blocks.ffn.wk": 0.54264,
    "blocks.ffn.wr": 0.63695, "blocks.ffn.wv": 0.27395,
    "blocks.ln1.bias": 3.915, "blocks.ln1.scale": 3.4594,
    "blocks.ln2.bias": 0.42289, "blocks.ln2.scale": 0.75788,
    "embed": 0.47872, "head": 0.015909, "ln0.bias": 3.1744,
    "ln0.scale": 4.3661, "ln_f.bias": 0.0020398, "ln_f.scale": 0.0099271,
    "loss": 4.5141e-05}
RWKV6_TRAIN_BOUNDS = {
    "kernel_vs_f32": {n: (1.25 * 2 ** 0.5 if n == "loss" else 1.25) * v
                      for n, v in RWKV6_TRAIN_PLAIN.items()},
    "kernel_vs_plain": {n: 1.25 * 2 ** 0.5 * v
                        for n, v in RWKV6_TRAIN_PLAIN.items()}}
# the f32 config's step 0 through the kernels (K10 / K6 and their
# backwards on f32 r, k, v; K11 and K12 on f32) against the f32 witness
# (the same config, the plain versions), per leaf and the loss, at S 1024
# and at S 40: the same recipe on the first reading (PR 34 run 4), each
# reading at least 2^-24, f32 rounding that the model's conditioning
# carries into the gradients.  A zeroed gradient reads 1, a flipped one 2.
RWKV6_TRAIN_F32_READ = {
    1024: {
        "blocks.att.ln_x.bias": 2.2098e-05,
        "blocks.att.ln_x.scale": 3.9801e-05, "blocks.att.maa_w1": 5.2354e-05,
        "blocks.att.maa_w2": 5.1151e-05, "blocks.att.td_w1": 6.5106e-05,
        "blocks.att.td_w2": 5.2437e-05, "blocks.att.time_decay": 5.1566e-05,
        "blocks.att.time_faaaa": 0.0002479, "blocks.att.time_maa": 5.28e-05,
        "blocks.att.time_maa_x": 5.8257e-05, "blocks.att.wg": 4.0963e-05,
        "blocks.att.wk": 5.6934e-05, "blocks.att.wo": 4.0189e-05,
        "blocks.att.wr": 5.745e-05, "blocks.att.wv": 4.0644e-05,
        "blocks.ffn.time_mix_k": 3.7737e-05,
        "blocks.ffn.time_mix_r": 3.7402e-05, "blocks.ffn.wk": 3.2372e-05,
        "blocks.ffn.wr": 3.4098e-05, "blocks.ffn.wv": 1.8613e-05,
        "blocks.ln1.bias": 6.7228e-05, "blocks.ln1.scale": 6.3292e-05,
        "blocks.ln2.bias": 1.5527e-05, "blocks.ln2.scale": 3.2395e-05,
        "embed": 4.0435e-05, "head": 2.6695e-06, "ln0.bias": 4.3744e-05,
        "ln0.scale": 6.2499e-05, "ln_f.bias": 1.9819e-07,
        "ln_f.scale": 1.5568e-06, "loss": 0.0},
    40: {
        "blocks.att.ln_x.bias": 4.2776e-05,
        "blocks.att.ln_x.scale": 3.1085e-05, "blocks.att.maa_w1": 5.5951e-05,
        "blocks.att.maa_w2": 4.7432e-05, "blocks.att.td_w1": 2.4911e-05,
        "blocks.att.td_w2": 1.9656e-05, "blocks.att.time_decay": 1.9393e-05,
        "blocks.att.time_faaaa": 0.00013813,
        "blocks.att.time_maa": 5.3866e-05,
        "blocks.att.time_maa_x": 6.4793e-05, "blocks.att.wg": 3.1198e-05,
        "blocks.att.wk": 3.045e-05, "blocks.att.wo": 2.9947e-05,
        "blocks.att.wr": 3.1002e-05, "blocks.att.wv": 3.1443e-05,
        "blocks.ffn.time_mix_k": 3.7816e-05,
        "blocks.ffn.time_mix_r": 3.7429e-05, "blocks.ffn.wk": 3.16e-05,
        "blocks.ffn.wr": 3.3785e-05, "blocks.ffn.wv": 2.8324e-05,
        "blocks.ln1.bias": 6.9653e-05, "blocks.ln1.scale": 6.4533e-05,
        "blocks.ln2.bias": 3.6801e-05, "blocks.ln2.scale": 3.6636e-05,
        "embed": 3.5739e-05, "head": 2.1185e-06, "ln0.bias": 7.6533e-05,
        "ln0.scale": 7.4048e-05, "ln_f.bias": 1.4219e-07,
        "ln_f.scale": 2.2036e-06, "loss": 0.0}}
RWKV6_TRAIN_F32_BOUNDS = {
    S: {n: (1.25 * 2 ** 0.5 if n == "loss" else 1.25) * max(v, 2.0 ** -24)
        for n, v in read.items()}
    for S, read in RWKV6_TRAIN_F32_READ.items()}


def _rwkv6_train_model():
    from repro_torch.models.registry import get_model
    cfg = get_model("rwkv6-7b").cfg
    return get_model(dataclasses.replace(cfg, n_layers=RWKV6_TRAIN_L,
                                         dtype="bfloat16"))


def _rwkv6_batch(cfg, B, S, step=0):
    from repro_torch.data import SyntheticLM
    return {k: torch.from_numpy(v).to(DEV) for k, v in SyntheticLM(
        vocab=cfg.vocab, seq_len=S, global_batch=B, seed=SEED).batch(
            step).items()}


def _wkv6_bwd_ok(got, ref, mag, w, C, bf16_outputs):
    """Each output of a WKV-6 backward against its plain version on the
    card: max |d| <= (2^-10 + λ)·max M and mean |d| <= (2^-13 + λ)·mean M,
    M the output's magnitude (the plain passes on |r|, |k|, |v|, |u|,
    |dy|, every term positive: the sum of its absolute terms), 2^-10 and
    2^-13 K2-bwd's (f32 sums of up to C·N terms, and of G chunks' state
    gradients, in another order: ~(C + N + G)·2^-24 ~ 2^-16 of M), λ =
    2C·2^-23·max|log w| for a log a last bit apart on the two sides,
    which moves every L after it (the forward's `_k10_bound`).  The first
    `bf16_outputs` outputs are bf16, each side rounding its f32 value
    once: their max may move by one bf16 step, 2^-7 of M.  Returns (ok,
    {name: {"max_abs", "max_per_mag", "mean_per_mag"}})."""
    lam = 2 * C * 2.0 ** -23 * float(
        torch.log(torch.clamp(w.float(), min=1e-38)).abs().max())
    errs, ok = {}, True
    for i, (name, a, b, m) in enumerate(zip(("dr", "dk", "dv", "dw", "du"),
                                            got, ref, mag)):
        d = (a.float() - b.float()).abs()
        m = m.float()
        mx = (2.0 ** -7 if i < bf16_outputs else 2.0 ** -10) + lam
        errs[name] = {"max_abs": float(d.max()),
                      "max_per_mag": float(d.max() / m.max()),
                      "mean_per_mag": float(d.mean() / m.mean())}
        ok = ok and bool(torch.isfinite(a).all()) and bool(
            d.max() <= mx * m.max()) and bool(
            d.mean() <= (2.0 ** -13 + lam) * m.mean())
    return ok, errs


def _k10_bwd_cost(B, T, H, N, C, rkv_bytes, w_bytes):
    """(bytes, operations) of the chunked WKV-6 backward: r, k, v, w, dy
    and the chunk states S_(g-1) read, dr, dk, dv, dw written, once each
    (u and du are small); per chunk and column the products (r e^Lp)ᵀ dy,
    S dy, G v and Gᵀ (k e^(Ltot - L)) (C·N each), VD (C²), the pairwise
    terms of A, dr, dk and dv (4·C(C-1)/2) and the dw walk (2·C(C-1)/2)
    at 2 operations a multiply-add, and C(C-1)/2 exponentials at one: the
    table E[t, i] = e^(Lp_t - L_i), i < t, which dr, dk, A and the walk
    share."""
    G = T // C
    elems = B * T * H * N
    nbytes = 3 * 2 * elems * rkv_bytes + 2 * elems * w_bytes \
        + 4 * elems + 4 * B * H * G * N * N
    macs = 4 * C * N + C * C + 6 * C * (C - 1) // 2
    ops = B * H * G * N * (2.0 * macs + C * (C - 1) // 2)
    return nbytes, ops


def _k10_bwd_two_level_ops(B, T, H, N, rkv_bytes):
    """The work of K10-bwd's two-level form (`csrc/wkv6_chunked_bwd.cu`)
    on these shapes: (CUDA-core operations, bf16 tensor-core flops).  Per
    chunk of C tokens and column: 13 for each strictly-lower pair inside
    the 16-row diagonal blocks (its decay, one product of the running
    e^l, shared by dr, dk, A and the dw walk: r E, k E, their products
    with X, VD and k, and X's update), ~24 a row (log w and e^l, the decay
    products D' and D'', R' and K'', the walk's Q̃, dw, dk, dr and du terms)
    and 2N for rowsum(S ⊙ G).  The products, each counted once per bf16
    piece product the kernel runs (f32 x f32: three with bf16 r, k, v,
    whose operands go in as two pieces, six with f32 r, k, v, three
    pieces; f32 x v: two with a bf16 v, six with an f32 v): (r e^Lp)ᵀ dy,
    VD for i <= t, S dy, XI's VD K' and A's blocks below the diagonal (one
    each a pair across sub-chunks), P̃_b over the keys up to sub-chunk b's
    end (VDᵀ R''_b over the rows past it, v (E_b G)ᵀ over N), Aᵀ dy over
    every pair and (K'' E_b) G."""
    from repro_torch.kernels.wkv6 import chunk_length
    C = chunk_length(T)
    chunks = B * H * (T // C)
    ns = -(-C // 16)
    lens = [min(16, C - 16 * b) for b in range(ns)]
    diag = sum(x * (x - 1) // 2 for x in lens)
    pairs = C * (C - 1) // 2
    off = pairs - diag
    keys = [min(16 * (b + 1), C) for b in range(ns)]
    rows = [C - k for k in keys]
    ff, fv = (3, 2) if rkv_bytes == 2 else (6, 6)
    cuda_ops = chunks * N * (13 * diag + 24 * C + 2 * N)
    macs = (ff * C * N * N + fv * N * (pairs + C) + ff * C * N * N
            + ff * N * off + ff * N * sum(k * r for k, r in zip(keys, rows))
            + fv * N * N * sum(keys) + ff * N * off + ff * N * pairs
            + ff * C * N * N)
    return cuda_ops, chunks * 2 * macs


def _k10_bwd_bound_ms(B, T, H, N, C, rkv_bytes, w_bytes):
    """K10-bwd's least time and its parts: the larger of its bytes
    (`_k10_bwd_cost`) over 3.35 TB/s and the two-level form's CUDA-core
    operations at the f32 rate plus its piece products at the bf16
    tensor-core rate (`_k10_bwd_two_level_ops`); beside it the one-level
    form's operations (`_k10_bwd_cost`) at the f32 rate, the bound before
    K10-bwd ran its products on the tensor cores."""
    nbytes, ops = _k10_bwd_cost(B, T, H, N, C, rkv_bytes, w_bytes)
    cuda_ops, mma_flops = _k10_bwd_two_level_ops(B, T, H, N, rkv_bytes)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (cuda_ops / PEAK_F32_FLOPS + mma_flops / PEAK_BF16_FLOPS) * 1e3
    return {"bytes": nbytes, "ops": cuda_ops, "mma_flops": mma_flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_bound_ms": t_bytes, "ops_bound_ms": t_ops,
            "one_level_ops": ops,
            "one_level_f32_bound_ms": ops / PEAK_F32_FLOPS * 1e3}


def phase_k10_bwd(layer0, flush):
    """K10-bwd on layer 0's WKV operands of rwkv6-7b's train step (B4 T1024
    H64 N64: bf16 r, k, v, f32 w, the zero state) and on an f32 instance
    of them, with a seeded N(0, 1) output gradient: through the autograd
    Function (K10 once, K10-bwd once) against the plain version of its
    passes on the card within `_wkv6_bwd_ok`; again from the forward's
    workspace, bit for bit.  Timed (the bf16 instance): the kernel
    L2-cold beside the plain version once and the bound
    (`_k10_bwd_bound_ms`: bytes or the two-level form's work, the
    one-level f32 figure beside it); no library call computes it."""
    from repro_torch.kernels.wkv6 import (
        _chunked_forward, wkv6_chunked_bwd, wkv6_chunked_bwd_plain,
        wkv6_chunked_kernel)
    r, k, v, w, u = layer0
    B, T, H, N = r.shape
    dy = torch.randn((B, T, H, N), device=DEV,
                     generator=torch.Generator(device=DEV).manual_seed(
                         SEED + 93))
    rows = []
    for rkv in (r, r.float()):
        ops_ = (rkv, k.to(rkv.dtype), v.to(rkv.dtype), w, u)
        ins = [t.clone().requires_grad_() for t in ops_]
        n0 = (wkv6_chunked_kernel.launches, wkv6_chunked_bwd.launches)
        y, _ = wkv6_chunked_kernel(*ins)
        got = torch.autograd.grad(y, ins, dy)
        torch.cuda.synchronize()
        launched = (wkv6_chunked_kernel.launches - n0[0],
                    wkv6_chunked_bwd.launches - n0[1])
        del y, ins
        ref = wkv6_chunked_bwd_plain(*ops_, dy)
        mag = wkv6_chunked_bwd_plain(*(t.abs() for t in ops_[:3]), w,
                                     u.abs(), dy.abs())
        bf = 3 if rkv.dtype == torch.bfloat16 else 0
        ok, errs = _wkv6_bwd_ok(got, ref, mag, w, 64, bf)
        del ref, mag
        ws = _chunked_forward(*ops_)[2]
        call = lambda: wkv6_chunked_bwd(*ops_, dy, workspace=ws)
        again = call()
        repeat = all(torch.equal(a, b) for a, b in zip(again, got))
        del again, got
        row = {"kernel": "wkv6_chunked_bwd",
               "what": "rwkv6-7b layer 0, train", "B": B, "T": T, "H": H,
               "N": N, "C": 64, "rkv_dtype": str(rkv.dtype),
               "launches_fwd_bwd": launched,
               "max_abs_err": max(e["max_abs"] for e in errs.values()),
               "errors": errs, "within_bound": ok, "bit_repeat": repeat,
               **_k10_bwd_bound_ms(B, T, H, N, 64, rkv.element_size(), 4),
               "library_ms": None,
               "ptxas": _registers(_BUILD_USAGE,
                                   "(chunk|state)_grad_kernelILi64")}
        if bf:
            row["kernel_ms"] = _time_ms(call, flush)
            row["plain_ms"] = _time_ms(
                lambda: wkv6_chunked_bwd_plain(*ops_, dy), flush, reps=1)
        _line(row)
        del ws
        if not (ok and repeat and launched == (1, 1)):
            raise AssertionError(f"K10-bwd {rkv.dtype}: {errs}, bit repeat "
                                 f"{repeat}, launches {launched}")
        rows.append(row)
    return rows


def phase_k6_bwd(layer0, flush):
    """K6-bwd on layer 0's WKV operands of the K6 route's train step (B2
    T40 H64 N64: r, k, v widened from bf16, f32 w, the zero f32 state)
    with a seeded N(0, 1) output gradient: through the autograd Function
    (K6 once, K6-bwd once) against the plain version of its passes on the
    card within `_wkv6_bwd_ok` (all f32); again, bit for bit; timed beside
    the plain version (a loop over T) and the bound.  `_time_ms`'s floor
    of ~5 µs (the dirty L2 its flush leaves) is part of the reading: the
    function's bound is 4.4 µs."""
    from repro_torch.kernels.wkv6 import (
        wkv6_seq, wkv6_seq_bwd, wkv6_seq_bwd_plain)
    r, k, v, w, u = layer0
    B, T, H, N = r.shape
    ops_ = (r.float(), k.float(), v.float(), w, u)
    s0 = torch.zeros((B, H, N, N), device=DEV)
    dy = torch.randn((B, T, H, N), device=DEV,
                     generator=torch.Generator(device=DEV).manual_seed(
                         SEED + 94))
    ins = [t.clone().requires_grad_() for t in ops_]
    n0 = (wkv6_seq.launches, wkv6_seq_bwd.launches)
    y, _ = wkv6_seq(*ins, s0)
    got = torch.autograd.grad(y, ins, dy)
    torch.cuda.synchronize()
    launched = (wkv6_seq.launches - n0[0], wkv6_seq_bwd.launches - n0[1])
    ref = wkv6_seq_bwd_plain(*ops_, s0, dy)
    mag = wkv6_seq_bwd_plain(*(t.abs() for t in ops_[:3]), w, u.abs(), s0,
                             dy.abs())
    ok, errs = _wkv6_bwd_ok(got, ref, mag, torch.ones(1), 1, 0)
    call = lambda: wkv6_seq_bwd(*ops_, s0, dy)
    repeat = all(torch.equal(a, b) for a, b in zip(call(), got))
    # r, k, v, w, dy read and dr, dk, dv, dw written, f32; per step and
    # (n, m): the state's update w·S + k·v 3, dr's S dy 2, dk's G v 2,
    # dv's Gᵀ k 2, dw's S ⊙ G 2 and G's update w·G + r·dy 3, 14 operations
    # (the bonus terms u k (v·dy) are O(N) a step)
    bms, by = _bound(9 * 4 * B * T * H * N, 14.0 * B * T * H * N * N,
                     PEAK_F32_FLOPS)
    row = {"kernel": "wkv6_seq_bwd", "what": "rwkv6-7b layer 0, train S40",
           "B": B, "T": T, "H": H, "N": N, "launches_fwd_bwd": launched,
           "max_abs_err": max(e["max_abs"] for e in errs.values()),
           "errors": errs, "within_bound": ok, "bit_repeat": repeat,
           "kernel_ms": _time_ms(call, flush),
           "plain_ms": _time_ms(
               lambda: wkv6_seq_bwd_plain(*ops_, s0, dy), flush, reps=1),
           "library_ms": None, "bound_ms": bms, "bound_by": by,
           "ptxas": _registers(_BUILD_USAGE, "seq_bwd_kernelILi64")}
    _line(row)
    if not (ok and repeat and launched == (1, 1)):
        raise AssertionError(f"K6-bwd: {errs}, bit repeat {repeat}, "
                             f"launches {launched}")
    return row


def _rwkv6_train_per_step(L, chunked=True):
    """Launches of one rwkv6 train step under remat: K11 at ln0, ln_f and
    twice a layer, again in each layer's recompute; K10 (or K6) once a
    layer and again in the recompute; each backward once per forward
    call."""
    fwd, bwd = ("wkv6_chunked_kernel", "wkv6_chunked_bwd") if chunked \
        else ("wkv6_seq", "wkv6_seq_bwd")
    return {"fused_layernorm": 4 * L + 2, "fused_layernorm_bwd": 2 * L + 2,
            fwd: 2 * L, bwd: L, "fused_cross_entropy": 1,
            "fused_cross_entropy_bwd": 1}


def _rwkv6_train_ops(model, B, S):
    """6·N·T for the products (N the weights in products: per layer wr,
    wk, wv, wg, wo, the ddlerp and decay low-rank matrices, the channel
    mix, as `_rwkv6_fwd_ops` counts them, and the head) and 2·N_blocks·T
    for remat's re-forward of the blocks."""
    cfg = model.cfg
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab
    n_blocks = cfg.n_layers * (6 * D * D + 2 * 5 * 32 * D + 2 * 64 * D
                               + 2 * D * F)
    T = B * S
    return {"matmuls": 6.0 * (n_blocks + D * V) * T,
            "remat": 2.0 * n_blocks * T}


def phase_rwkv6_train():
    """rwkv6-7b's training at full width (D 4096, H 64, N 64, F 14336, V
    65536) cut to 4 of its 32 layers, B 4, S 1024, SyntheticLM tokens, f32
    master weights from the seed, AdamW, remat, bf16 compute.  Step 0
    (`loss_and_grads`) with every counter set to 0 just before and read
    just after (`_rwkv6_train_per_step`: K11 18, K11-bwd 10, K10 8,
    K10-bwd 4, K12 1, K12-bwd 1); its loss and gradients per leaf against
    the plain path and the f32 witness (`_train_gaps`) within
    RWKV6_TRAIN_BOUNDS.  Then `train_model` for 3 steps, the counters
    again (3x), finite losses, each step's ms, tokens/s and the peak
    device memory beside the step's operations bound, and one more step
    split by `_step_split` by model line (phase_split's fourth reading:
    the eager ops' device time keyed by the line of models/ that issued
    them, the count by model line and its roofline).  Then the K6 route: step 0 at B 2, S 40 (K6 8,
    K6-bwd 4), finite gradients, each leaf's mean gap to the f32 witness
    within 1.25·√2 times the plain path's own (the recipe read in the
    same run).  At both lengths the f32 config also runs step 0 through
    the kernels (the same launches), each leaf and the loss within
    RWKV6_TRAIN_F32_BOUNDS of the f32 witness, and the witness is rerun
    on the weights rounded to bf16 (`_train_gaps`).  Returns the paths'
    launches."""
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import train_model
    B, S, steps = RWKV6_TRAIN_B, RWKV6_TRAIN_S, 3
    model = _rwkv6_train_model()
    L = model.cfg.n_layers
    per_step = _rwkv6_train_per_step(L)
    params = model.init_params(SEED, DEV)
    batch = _rwkv6_batch(model.cfg, B, S)
    out, _ = _counted(lambda: loss_and_grads(model, params, batch),
                      per_step, "rwkv6 train step 0")
    losses, gaps, plain_ms, finite = _train_gaps(model, params, batch, out,
                                                 f32_per_step=per_step)
    del out
    bounds = {**RWKV6_TRAIN_BOUNDS,
              "f32_kernel_vs_f32": RWKV6_TRAIN_F32_BOUNDS[S]}
    bad = {(w, n): gaps[w][n] for w in bounds for n in bounds[w]
           if gaps[w][n] > bounds[w][n]}
    _line({"phase": "train_step0", "arch": "rwkv6-7b", "L": L, "B": B,
           "S": S, "losses": {"kernels": losses[0], "plain": losses[1],
                              "f32": losses[2], "f32_kernels": losses[3]},
           "launches": per_step, "plain_step_ms": plain_ms, "gaps": gaps,
           "bounds": bounds, "within_bound": not bad})
    if bad or not finite or not all(np.isfinite(losses)):
        raise AssertionError(f"rwkv6 train step 0 out of bounds: {bad}, "
                             f"finite gradients {finite}, losses {losses}")
    del params, batch
    _release()
    torch.cuda.reset_peak_memory_stats()
    out, launches = _counted(
        lambda: train_model(model, steps=steps, global_batch=B, seq_len=S,
                            seed=SEED, device=DEV, log_every=1),
        {n: steps * c for n, c in per_step.items()}, "rwkv6 train")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(out["losses"])):
        raise AssertionError(f"rwkv6 train losses: {out['losses']}")
    ops = _rwkv6_train_ops(model, B, S)
    step_ms = [t * 1e3 for t in out["step_s"]]
    steady = sum(step_ms[1:]) / len(step_ms[1:])
    split = _step_split(model, out["params"], _rwkv6_batch(model.cfg, B, S),
                        by_line=True)
    _line({"phase": "train", "arch": "rwkv6-7b", "L": L, "B": B, "S": S,
           "params": model.param_count(), "steps": steps,
           "losses": out["losses"], "step_ms": step_ms,
           "train_tokens_per_s": B * S / (steady / 1e3),
           "max_memory_allocated_gib": peak, "launches": launches,
           "ops": ops, "bound_ms": sum(ops.values()) / PEAK_BF16_FLOPS * 1e3,
           "split": split})
    del out
    _release()
    # the K6 route: S 40 is no multiple of the chunk
    Bs, Ss = RWKV6_SHORT_B, RWKV6_SHORT_S
    per40 = _rwkv6_train_per_step(L, chunked=False)
    params = model.init_params(SEED, DEV)
    short = _rwkv6_batch(model.cfg, Bs, Ss)
    out, launches40 = _counted(
        lambda: loss_and_grads(model, params, short), per40,
        "rwkv6 train step 0 S40")
    losses40, gaps40, plain40_ms, finite40 = _train_gaps(
        model, params, short, out, f32_per_step=per40)
    del out
    bad40 = {n: g for n, g in gaps40["kernel_vs_f32"].items()
             if g > 1.25 * 2 ** 0.5 * gaps40["plain_vs_f32"][n]}
    bad40.update({("f32", n): gaps40["f32_kernel_vs_f32"][n]
                  for n, b in RWKV6_TRAIN_F32_BOUNDS[Ss].items()
                  if gaps40["f32_kernel_vs_f32"][n] > b})
    _line({"phase": "train_step0", "arch": "rwkv6-7b", "route": "K6",
           "L": L, "B": Bs, "S": Ss, "losses": losses40,
           "launches": launches40, "plain_step_ms": plain40_ms,
           "gaps": gaps40, "within_bound": not bad40, "finite": finite40})
    if bad40 or not finite40 or not all(np.isfinite(losses40)):
        raise AssertionError(f"rwkv6 S40 step 0: {bad40}, finite "
                             f"{finite40}, losses {losses40}")
    del params, short
    _release()
    return {"rwkv6-train": launches, "rwkv6-train-s40": launches40}


# --- the ninth slice: K1 and K8 through kernels/ops.py, the quantized serve
# --- step, serve_legacy(quantized=True)

def _k1k8_planes(raw6, w4_rwkv4):
    """(operand name, plane, codes, scale (N,)) of every K1 / K8 case:
    rwkv6-7b's layer-0 att.wr, ffn.wk, ffn.wv and the head as packed W8 in
    the engine's tree; bench_kernels' serving matvec weights (1024 x 1024,
    N(0, 0.05), packed W8 here); the four rwkv6 matrices packed W4 by
    pack_leaf from their decoded W8 weights; rwkv4-169m MIXED's W4 leaves
    (layer-0 att.wk and the head)."""
    from repro_torch.core.quant.delta_pot import (
        FORMAT_W8, dpot_dequantize, dpot_unpack_int8)
    from repro_torch.core.quant.policy import PLANE_W4
    from repro_torch.core.quant.serving import pack_leaf
    b = raw6["blocks"]
    planes = []
    for name, leaf in (("att.wr", b["att"]["wr"]), ("ffn.wk", b["ffn"]["wk"]),
                       ("ffn.wv", b["ffn"]["wv"]), ("head", raw6["head"])):
        codes = leaf["packed"][0] if leaf["packed"].dim() == 3 \
            else leaf["packed"]
        planes.append((f"rwkv6-7b {name}", "w8", codes,
                       leaf["scale"].reshape(-1).contiguous()))
    g = torch.Generator(device=DEV).manual_seed(SEED + 91)
    bench = pack_leaf("['w']", torch.randn((1024, 1024), generator=g,
                                           device=DEV) * 0.05)
    planes.append(("bench_kernels 1024x1024", "w8", bench["packed"],
                   bench["scale"].reshape(-1)))
    for name, _, codes, scale in planes[:4]:
        w = dpot_dequantize(dpot_unpack_int8(codes, scale[None, :],
                                             FORMAT_W8.ks))
        l4 = pack_leaf("['w']", w, PLANE_W4)
        del w
        planes.append((name + " as W4", "w4", l4["packed4"],
                       l4["scale"].reshape(-1)))
    for name, leaf in w4_rwkv4.items():
        planes.append((name, "w4", leaf["packed4"],
                       leaf["scale"].reshape(-1).contiguous()))
    return planes


def _k1k8_decode_exact(fn, plain_plane, codes, scale, w4, g):
    """Identity rows pick the decoded f32 plane out of the kernel: 128
    sampled rows of the real plane (the first and last among them), and
    a plane holding every code (256 W8 bytes; 16 W4 nibbles, each in both
    halves of a byte) at this plane's column scales; both bit for bit
    against the plain version's dpot_dequantize."""
    K = codes.shape[0] * (2 if w4 else 1)
    rows = torch.unique(torch.cat([
        torch.tensor([0, K - 1], device=DEV),
        torch.randint(0, K, (126,), generator=g, device=DEV)]))
    eye = torch.zeros((rows.numel(), K), device=DEV)
    eye[torch.arange(rows.numel(), device=DEV), rows] = 1.0
    plane = plain_plane(codes, scale)
    if not torch.equal(fn(eye, codes, scale), plane[rows]):
        raise AssertionError("decoded rows differ from the plain plane")
    N = scale.numel()
    if w4:
        lo = torch.arange(16, dtype=torch.uint8, device=DEV)
        every = (lo | (lo.flip(0) << 4))[:, None].expand(16, N).contiguous()
    else:
        every = torch.arange(256, dtype=torch.uint8, device=DEV)[
            :, None].expand(256, N).contiguous()
    Ke = every.shape[0] * (2 if w4 else 1)
    if not torch.equal(fn(torch.eye(Ke, device=DEV), every, scale),
                       plain_plane(every, scale)):
        raise AssertionError("a code decodes otherwise than the plain "
                             "version")


def phase_k1_k8(raw6, w4_rwkv4, flush, usage):
    """K1 (dpot_matmul) and K8 (dpot_matmul_w4) through the public entry
    point `repro_torch.kernels.ops`, on the operands of `_k1k8_planes`,
    M in {8, 128} with bf16 x (8 the serving matvec, 128 the quantized
    step's batch) and bench_kernels' own (8, 1024, 1024) with f32 x.

    The main-path run: both counters set to 0, every case called once
    through ops, the counters read (each must equal its number of
    cases).  Then each output against the plain version on the card:
    within K·2^-24·(|x| @ |w|) plus one step of the output's type; the
    decode bit for bit (`_k1k8_decode_exact`); and the bf16 cases against
    the quantized step's own product x @ unpack_leaf(leaf) (bf16
    weights, f32 accumulation, as decode_step runs it under
    exact_matmuls): within 2^-8·(|x| @ |w|) plus one bf16 step, since each
    bf16 weight sits within 2^-9 relative of K1's f32 weight and each f32
    sum within K·2^-24 (at most 2^-10.2 at K = 14336).  Times: the
    kernel L2-cold (`_time_ms`), the plain version and torch.matmul of
    x.float() on the pre-decoded f32 plane (TF32 off), 3 reps each,
    beside max(bytes / 3.35 TB/s, pieces·2·M·K·N / 989 TFLOP/s): the
    kernels are K5's tensor-core kernel, one bf16 MMA for each piece of x
    (one for bf16, three for f32) and of the weight (W8 two, W4 one).  The
    f32 CUDA-core figure max(bytes, 2·M·K·N / 67 TFLOP/s) is printed
    beside it (`f32_fma_bound_ms`), and each row's largest |d| over its
    bound (`err_over_bound`).  The first row carries the ptxas lines of
    the EXACT instances."""
    from repro_torch.core.quant.delta_pot import (
        FORMAT_W4, FORMAT_W8, dpot_dequantize, dpot_unpack_int8,
        dpot_unpack_nibbles)
    from repro_torch.core.quant.serving import unpack_leaf
    from repro_torch.device import exact_matmuls
    from repro_torch.kernels import ops
    from repro_torch.kernels.dpot_matmul import (
        dpot_matmul_plain, dpot_matmul_w4_plain)

    def plain_plane(w4):
        unpack = dpot_unpack_nibbles if w4 else dpot_unpack_int8
        ks = FORMAT_W4.ks if w4 else FORMAT_W8.ks
        return lambda c, s: dpot_dequantize(unpack(c, s[None, :], ks))
    planes = _k1k8_planes(raw6, w4_rwkv4)
    g = torch.Generator(device=DEV).manual_seed(SEED + 92)
    cases = []
    for name, plane, codes, scale in planes:
        Ms = (8,) if name.startswith("bench") else (8, 128)
        dt = torch.float32 if name.startswith("bench") else torch.bfloat16
        K = codes.shape[0] * (2 if plane == "w4" else 1)
        for M in Ms:
            x = torch.randn((M, K), generator=g, device=DEV).to(dt)
            cases.append((name, plane, codes, scale, x))
    fns = {"w8": ops.dpot_matmul, "w4": ops.dpot_matmul_w4}
    for fn in fns.values():
        fn.launches = 0
    outs = [fns[p](x, c, s) for _, p, c, s, x in cases]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in fns.values()}
    want = {fns[p].__name__: sum(c[1] == p for c in cases) for p in fns}
    if launches != want:
        raise AssertionError(f"ops launched {launches}, not {want}")
    rows, checked = [], set()
    for (name, plane, codes, scale, x), out in zip(cases, outs):
        w4 = plane == "w4"
        fn = fns[plane]
        plain = dpot_matmul_w4_plain if w4 else dpot_matmul_plain
        M, K = x.shape
        N = scale.numel()
        ref = plain(x, codes, scale)
        w32 = plain_plane(w4)(codes, scale)
        with exact_matmuls():
            mag = x.double().abs() @ w32.double().abs()
        eps = torch.finfo(x.dtype).eps
        o, r = out.double(), ref.double()
        d = (o - r).abs()
        bound = K * 2.0 ** -24 * mag + eps * torch.maximum(o.abs(), r.abs())
        if not bool((d <= bound).all()):
            raise AssertionError(f"{fn.__name__} {name} M={M}: max |d| "
                                 f"{float(d.max())} passes the bound")
        over = float((d / bound).max())
        if (name, plane) not in checked:
            _k1k8_decode_exact(fn, plain_plane(w4), codes, scale, w4, g)
            checked.add((name, plane))
        row = {"kernel": fn.__name__, "operand": name, "M": M, "K": K,
               "N": N, "x": str(x.dtype).replace("torch.", ""),
               "max_abs_err": float(d.max()), "err_over_bound": over,
               "decode_bit_exact": True}
        if x.dtype == torch.bfloat16:
            leaf = {"packed4" if w4 else "packed": codes,
                    "scale": scale[None, :]}
            with exact_matmuls():     # as decode_step computes it
                prod = (x @ unpack_leaf(leaf)).double()
            dp = (o - prod).abs()
            bp = 2.0 ** -8 * mag + eps * torch.maximum(o.abs(), prod.abs())
            if not bool((dp <= bp).all()):
                raise AssertionError(f"{fn.__name__} {name} M={M}: the "
                                     "quantized step's product differs by "
                                     f"{float(dp.max())}, past its bound")
            row["step_product_max_abs_gap"] = float(dp.max())
            row["step_product_gap_over_bound"] = float((dp / bp).max())
            del prod, dp, bp
        nbytes = (M * K * x.element_size() + codes.numel() + N * 4
                  + M * N * x.element_size())
        pieces = (1 if w4 else 2) * (1 if x.dtype == torch.bfloat16 else 3)
        bms, by = _bound(nbytes, pieces * 2.0 * M * K * N, PEAK_BF16_FLOPS)
        f32_bms, _ = _bound(nbytes, 2.0 * M * K * N, PEAK_F32_FLOPS)
        xf = x.float()
        with exact_matmuls():
            lib = _time_ms(lambda: torch.matmul(xf, w32), flush, reps=3)
        row.update({
            "kernel_ms": _time_ms(lambda: fn(x, codes, scale), flush),
            "plain_ms": _time_ms(lambda: plain(x, codes, scale), flush,
                                 reps=3),
            "library_ms": lib, "bound_ms": bms, "bound_by": by,
            "mma_pieces": pieces, "f32_fma_bound_ms": f32_bms})
        if not rows:   # the EXACT instances (K1's and K8's) of K5's kernel
            row["ptxas"] = _registers(usage, r"chunk_mm_kernel.*Lb1EE")
        _line(row)
        rows.append(row)
        del ref, w32, mag, d, bound, xf
    return rows, launches


def phase_quantized_step(model, packed, B, name):
    """`build_serve_step(model, variant="quantized")` at batch B on the
    packed W8 tree: a warm step and 3 timed steps (host clock, each ending
    in a synchronize), greedy tokens fed back; ms a step, tokens/s, peak
    memory.  Then the "base" step on unpack_params(tree), from the same
    fresh state on the same tokens: every step's logits and the final
    state equal the quantized step's bit for bit (the same operations on
    the same weights).  The step decodes its codes with unpack_params (as
    JAX's does, inside the step) and calls no kernel of ours: every
    counter reads 0."""
    from repro_torch.core.quant.serving import unpack_params
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.tree import leaves_with_path
    step_q = build_serve_step(model, variant="quantized")
    step_b = build_serve_step(model, variant="base")
    g = torch.Generator(device=DEV).manual_seed(SEED + 93)
    toks = [torch.randint(0, model.cfg.vocab, (B, 1), generator=g,
                          device=DEV, dtype=torch.int32)]
    counters = _path_counters() + (ops.dpot_matmul, ops.dpot_matmul_w4)
    for c in counters:
        c.launches = 0
    logits, ms = [], []
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        state = model.init_decode_state(B, 0, device=DEV)
        for i in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, state = step_q(packed, state, toks[-1], i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(lg)
            toks.append(torch.argmax(lg[:, -1].float(), -1)[:, None].to(
                torch.int32))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = {c.__name__: c.launches for c in counters}
        if any(launches.values()):
            raise AssertionError(f"the quantized step launched {launches}")
        final_q = state
        plain = unpack_params(packed)
        state = model.init_decode_state(B, 0, device=DEV)
        for i in range(4):
            lg, state = step_b(plain, state, toks[i], i)
            if not torch.equal(lg, logits[i]):
                raise AssertionError(f"{name}: step {i}'s logits differ "
                                     "from the base step's")
        for (p, a), (_, b) in zip(leaves_with_path(state),
                                  leaves_with_path(final_q)):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: state {p} differs from the "
                                     "base step's")
        del plain
    if not all(bool(torch.isfinite(lg.float()).all()) for lg in logits):
        raise AssertionError(f"{name}: logits not finite")
    step_ms = sum(ms[1:]) / 3
    _line({"phase": "quantized_step", "model": name, "B": B,
           "warm_ms": ms[0], "step_ms": ms[1:], "ms_per_step": step_ms,
           "tokens_per_s": B / (step_ms / 1e3),
           "max_memory_allocated_gib": peak,
           "equal_to_base_on_unpacked": True, "launches": launches})
    return launches


def phase_serve_legacy_quantized():
    """serve_legacy("rwkv4-169m", smoke=False, quantized=True) on the
    card (JAX's defaults: batch 4, 32 tokens): its printed lines and
    tokens/s; finite tokens of the right shape; its fake-quantized tree
    (read through a spy on `fake_quantize_tree`) equal, bit for bit and
    leaf by leaf, to the same weights fake-quantized on the CPU."""
    import contextlib
    import io
    import re
    from repro_torch.core.quant.policy import QuantPolicy
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as S
    from repro_torch.tree import leaves_with_path, tree_map
    seen = {}
    real = S.fake_quantize_tree

    def spy(params, policy):
        seen["in"], seen["out"] = params, real(params, policy)
        return seen["out"]
    counters = _path_counters() + (ops.dpot_matmul, ops.dpot_matmul_w4)
    for c in counters:
        c.launches = 0
    buf = io.StringIO()
    S.fake_quantize_tree = spy
    try:
        with contextlib.redirect_stdout(buf):
            toks = S.serve_legacy("rwkv4-169m", smoke=False, quantized=True,
                                  device=DEV)
    finally:
        S.fake_quantize_tree = real
    launches = {c.__name__: c.launches for c in counters}
    text = buf.getvalue()
    print(text, end="", flush=True)
    if tuple(toks.shape) != (4, 33) or not bool(
            ((toks >= 0) & (toks < 50277)).all()):
        raise AssertionError(f"serve_legacy tokens {tuple(toks.shape)}")
    tps = float(re.search(r"\(([\d,]+) tok/s\)", text).group(1).replace(
        ",", ""))
    t0 = time.perf_counter()
    cpu = real(tree_map(lambda t: t.cpu(), seen["in"]), QuantPolicy())
    cpu_s = time.perf_counter() - t0
    n = 0
    for (path, a), (_, b) in zip(leaves_with_path(seen["out"]),
                                 leaves_with_path(cpu)):
        if not torch.equal(a.cpu().view(torch.int32),
                           b.view(torch.int32)):
            raise AssertionError(f"fake-quantized leaf {path} differs "
                                 "between the card and the CPU")
        n += 1
    _line({"phase": "serve_legacy_quantized", "model": "rwkv4-169m",
           "batch": 4, "tokens": 32, "tokens_per_s": tps,
           "leaves_bit_equal_card_vs_cpu": n, "cpu_fake_quant_s": cpu_s,
           "launches": launches})
    return launches


# --- the twenty-first slice: a given tree, the counters, cancel, f32
# --- state, the truncated models and the all-position prefill logits

def _serving_counters():
    """The launch counters of every kernel a serving path can reach."""
    from repro_torch.kernels.fused_decode import (
        rwkv4_block_decode, rwkv4_model_decode, rwkv6_block_decode,
        rwkv6_model_decode)
    from repro_torch.kernels.fused_prefill import (
        dpot_w4_matmul, dpot_w8_matmul, vq_matmul)
    from repro_torch.kernels.wkv4 import wkv4_seq
    from repro_torch.kernels.wkv6 import wkv6_seq
    return (dpot_w8_matmul, dpot_w4_matmul, vq_matmul, wkv4_seq, wkv6_seq,
            rwkv4_block_decode, rwkv4_model_decode, rwkv6_block_decode,
            rwkv6_model_decode)


def _leaf_sum(t) -> int:
    """A checksum of a leaf: the sum of its bytes."""
    return int(t.contiguous().view(torch.uint8).sum(dtype=torch.int64))


def phase_serve_trained(model, restored):
    """The tree `phase_rwkv4_train` trained and restored from its
    checkpoint, served through `ServingEngine(params=restored,
    quantized=True, fused_decode="model", fused_prefill=True)` with fresh
    ServingCounters: the packed raw tree holds the trained weights (a
    leaf's codes are pack_leaf of the trained leaf, not of the seed's),
    `phase_engine`'s run (K5, K2 and K4 launched, the counts, built once,
    solo equal to batched), teacher-forced logits within
    TF_BOUNDS["model"]; then the 8 requests again with request 3
    cancelled after 4 ticks: its outcome "cancelled", the snapshot's
    cancelled 1 and finished 7, every other stream unchanged.  Returns
    the run's launches."""
    from repro_torch.core.quant.serving import pack_leaf
    from repro_torch.kernels.fused_decode import rwkv4_model_decode
    from repro_torch.kernels.fused_prefill import dpot_w8_matmul
    from repro_torch.kernels.wkv4 import wkv4_seq
    from repro_torch.runtime.monitor import ServingCounters
    from repro_torch.serving import ServingEngine
    t0 = time.perf_counter()
    engine = ServingEngine(model, params=restored, quantized=True,
                           fused_decode="model", fused_prefill=True,
                           max_batch=8, prefill_chunk=16,
                           counters=ServingCounters(), device=DEV)
    build_s = time.perf_counter() - t0
    key = "['blocks']['att']['wr']"
    served = engine.plan.prepared.raw["blocks"]["att"]["wr"]["packed"]
    trained = pack_leaf(key, restored["blocks"]["att"]["wr"])["packed"]
    seeded = pack_leaf(key, model.init_params(SEED, DEV)["blocks"]["att"][
        "wr"])["packed"]
    sums = {"served": _leaf_sum(served), "trained": _leaf_sum(trained),
            "seed": _leaf_sum(seeded)}
    if not torch.equal(served, trained) or torch.equal(served, seeded):
        raise AssertionError(f"the plan does not serve the trained tree: "
                             f"{sums}")
    del trained, seeded
    if engine.plan.build_config["from_seed"]:
        raise AssertionError("build_config says the weights are the seed's")
    launches = phase_engine(engine, (dpot_w8_matmul, wkv4_seq,
                                     rwkv4_model_decode), "serve-trained")
    phase_teacher_forced(engine, label="trained rwkv4-169m W8")
    # cancel request 3 after 4 ticks: the others' streams stay as they were
    prompts = _engine_prompts(model.cfg.vocab)
    handles = [engine.submit(p, max_new_tokens=32) for p in prompts]
    engine.run()
    ref = [h.tokens for h in handles]
    engine.counters = engine.scheduler.counters = ServingCounters()
    handles = [engine.submit(p, max_new_tokens=32) for p in prompts]
    for _ in range(4):
        engine.step()
    victim = handles[3]
    n_before = len(victim.tokens)
    if not engine.cancel(victim) or engine.cancel(victim):
        raise AssertionError("cancel: the request was not in flight once")
    snap = engine.run()
    others = [h.tokens for i, h in enumerate(handles) if i != 3]
    ok = (victim.outcome == "cancelled" and victim.tokens == ref[3][
        :n_before] and snap["cancelled"] == 1 and snap["finished"] == 7
        and others == [t for i, t in enumerate(ref) if i != 3]
        and all(h.outcome == "finished" for i, h in enumerate(handles)
                if i != 3))
    _line({"phase": "serve_trained", "arch": model.cfg.name,
           "engine_build_s": build_s, "leaf_checksums": sums,
           "build_config": engine.plan.build_config,
           "launches": launches, "trace_counts": engine.trace_counts,
           "cancel": {"victim_tokens": n_before,
                      "outcome": victim.outcome,
                      "cancelled": snap["cancelled"],
                      "finished": snap["finished"],
                      "others_unchanged": others == [
                          t for i, t in enumerate(ref) if i != 3]},
           "ok": ok})
    if not ok:
        raise AssertionError("cancelling a request moved another stream, "
                             "or its outcome or counts are wrong")
    return launches


def phase_truncated6(engine):
    """rwkv6-7b at full width cut to its first 4 of 32 layers:
    `model.truncated(4)` on `truncate_params(packed, 4)` runs one prefill
    chunk (B 8, C 16; K5 + K6) and 8 decode steps on K7-model (its slabs
    prepared from the truncated tree), every serving counter set to 0
    just before and read just after; its state must equal
    `truncate_state` of the full model's state after the same tokens (the
    engine's prepared forms, K7-model over 32 layers), bit for bit."""
    model, prep = engine.model, engine.plan.prepared
    depth, B, C, steps = 4, 8, 16, 8
    toks = torch.randint(0, model.cfg.vocab, (B, C + steps), device=DEV,
                         dtype=torch.int32,
                         generator=torch.Generator(device=DEV).manual_seed(
                             SEED + 21))
    valid = torch.ones((B, C), dtype=torch.bool, device=DEV)

    def run(m, prefill, decode):
        with torch.inference_mode():
            s = m.init_decode_state(B, 0, device=DEV)
            s, _ = m.prefill_chunk(prefill, s, toks[:, :C], valid)
            for j in range(C, C + steps):
                _, s = m.decode_step_fused_model(decode, s,
                                                 toks[:, j:j + 1], 0)
        torch.cuda.synchronize()
        return s
    full = run(model, prep.prefill, prep.decode)
    tm = model.truncated(depth)
    tp = model.truncate_params(prep.raw, depth)
    t0 = time.perf_counter()
    t_prefill = tm.prepare_path_params(tm.prefill_paths()["chunked"], tp)
    t_decode = tm.prepare_fused_model_params(tp)
    prep_s = time.perf_counter() - t0
    counters = _serving_counters()
    for fn in counters:
        fn.launches = 0
    cut = run(tm, t_prefill, t_decode)
    launches = {fn.__name__: fn.launches for fn in counters
                if fn.launches}
    want = model.truncate_state(full, depth)
    equal = {k: bool(torch.equal(cut[k], want[k])) for k in cut}
    shapes = {k: list(cut[k].shape) for k in cut}
    ok = all(equal.values()) and all(
        launches.get(n, 0) > 0 for n in ("dpot_w8_matmul", "wkv6_seq",
                                         "rwkv6_model_decode"))
    _line({"phase": "truncated6", "arch": model.cfg.name, "depth": depth,
           "of": model.cfg.n_layers, "B": B, "C": C, "decode_steps": steps,
           "prepare_s": prep_s, "launches": launches, "state_shapes": shapes,
           "state_bits_equal": equal, "ok": ok})
    if not ok:
        raise AssertionError(f"truncated rwkv6 state differs from the full "
                             f"model's first layers: {equal}, {launches}")
    return {"truncated6": launches}


ALL_LOGITS_LENS = (16, 16, 9, 1, 0, 16, 5, 12)


def phase_all_logits(engine, label, flush):
    """`prefill_chunk_logits` against `prefill_chunk` on an engine's
    prepared W8 tree (B 8, C 16, prefix masks ALL_LOGITS_LENS, a fresh
    state), every serving counter set to 0 just before the all-position
    call and read just after: row n_valid - 1 equal to the last-valid
    logits bit for bit, invalid rows zero, the states equal bit for bit.
    Then the head's K5 alone at M 128 (the all-position head's shape) on
    a seeded x, beside its plain version and torch.matmul on the decoded
    plane, and both chunk calls timed (`_time_ms`)."""
    from repro_torch.core.quant.serving import unpack_leaf
    from repro_torch.device import exact_matmuls
    from repro_torch.kernels.fused_prefill import (
        dpot_w8_matmul, dpot_w8_matmul_plain)
    model, prep = engine.model, engine.plan.prepared
    B, C = 8, 16
    g = torch.Generator(device=DEV).manual_seed(SEED + 23)
    toks = torch.randint(0, model.cfg.vocab, (B, C), device=DEV,
                         dtype=torch.int32, generator=g)
    lens = torch.tensor(ALL_LOGITS_LENS, device=DEV)
    valid = torch.arange(C, device=DEV)[None, :] < lens[:, None]
    state = model.init_decode_state(B, 0, device=DEV)

    def last():
        with torch.inference_mode():
            return model.prefill_chunk(prep.prefill, state, toks, valid)

    def rows():
        with torch.inference_mode():
            return model.prefill_chunk_logits(prep.prefill, state, toks,
                                              valid)
    s1, l1 = last()
    counters = _serving_counters()
    for fn in counters:
        fn.launches = 0
    s2, l2 = rows()
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters if fn.launches}
    rows_equal = all(bool(torch.equal(l2[b, n - 1], l1[b, 0]))
                     for b, n in enumerate(ALL_LOGITS_LENS) if n)
    invalid_zero = not bool(l2[~valid].any())
    states_equal = all(bool(torch.equal(s1[k], s2[k])) for k in s1)
    finite = bool(torch.isfinite(l2.float()).all())
    head = prep.prefill["head"]
    wq, scale = head["packed"], head["scale"].reshape(-1)
    K, N = wq.shape
    M = B * C
    x = torch.randn((M, K), generator=g, device=DEV).to(torch.bfloat16)
    w_bf = unpack_leaf({"packed": wq, "scale": scale.reshape(1, -1)})
    out = dpot_w8_matmul(x, wq, scale)
    ok_k5, err = _elementwise_ok(out, dpot_w8_matmul_plain(x, wq, scale),
                                 _sum_order_floor(x, w_bf))
    bms, by = _bound(M * K * 2 + K * N + N * 4 + M * N * 2,
                     2.0 * M * N * K, PEAK_BF16_FLOPS)
    with exact_matmuls():
        lib = _time_ms(lambda: torch.matmul(x, w_bf), flush)
    k5 = {"kernel": "dpot_w8_matmul", "matrix": "head", "M": M, "K": K,
          "N": N, "max_abs_err": err,
          "kernel_ms": _time_ms(lambda: dpot_w8_matmul(x, wq, scale), flush),
          "plain_ms": _time_ms(
              lambda: dpot_w8_matmul_plain(x, wq, scale), flush),
          "library_ms": lib, "bound_ms": bms, "bound_by": by}
    ok = (rows_equal and invalid_zero and states_equal and finite and ok_k5
          and launches.get("dpot_w8_matmul", 0) > 0)
    _line({"phase": "all_logits", "model": label, "B": B, "C": C,
           "n_valid": list(ALL_LOGITS_LENS), "launches": launches,
           "last_row_bits_equal": rows_equal, "invalid_rows_zero":
           invalid_zero, "states_bits_equal": states_equal,
           "chunk_ms": _time_ms(last, flush),
           "all_logits_chunk_ms": _time_ms(rows, flush),
           "head_k5": k5, "ok": ok})
    if not ok:
        raise AssertionError(f"all-position logits {label}: rows equal "
                             f"{rows_equal}, invalid zero {invalid_zero}, "
                             f"states equal {states_equal}, K5 {ok_k5}")
    return {"all-logits " + label: launches}, k5


def phase_state_dtype():
    """An f32 pool: an rwkv4-169m per-op engine (plain weights from the
    seed, state_dtype=torch.float32) serves 8 requests on the card (5-40
    token prompts, 8 new tokens), its pool f32 and each stream equal to
    the request served alone; then build_plan with an f32 state on each
    fused path raises ValueError with every serving counter still 0."""
    from repro_torch.serving import ServingEngine, build_plan
    eng = ServingEngine("rwkv4-169m", smoke=False, max_batch=8,
                        prefill_chunk=16, state_dtype=torch.float32,
                        device=DEV)
    dtypes = sorted({str(v.dtype) for v in eng.pool.state.values()})
    prompts = _engine_prompts(eng.model.cfg.vocab)
    t0 = time.perf_counter()
    handles = [eng.submit(p, max_new_tokens=8) for p in prompts]
    snap = eng.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    solo_ok = True
    for p, h in zip(prompts, handles):
        one = eng.submit(p, max_new_tokens=8)
        eng.run()
        solo_ok &= one.tokens == h.tokens
    del eng
    _release()
    counters = _serving_counters()
    for fn in counters:
        fn.launches = 0
    raised = {}
    for kw in (dict(fused_decode="model"), dict(fused_decode="block"),
               dict(fused_prefill=True)):
        try:
            build_plan("rwkv4-169m", smoke=False, quantized=True,
                       state_dtype=torch.float32, device=DEV, **kw)
            raised[str(kw)] = False
        except ValueError:
            raised[str(kw)] = True
    after = {fn.__name__: fn.launches for fn in counters}
    ok = (dtypes == ["torch.float32"] and solo_ok and all(raised.values())
          and not any(after.values()) and snap["decode_tokens"] == 64
          and snap["finished"] == 8)
    _line({"phase": "state_dtype", "arch": "rwkv4-169m", "path": "per_op",
           "pool_dtypes": dtypes, "requests": 8, "new_tokens": 8,
           "seconds": seconds, "tokens_per_s": snap["decode_tokens"] / seconds,
           "solo_equals_batched": solo_ok, "fused_f32_raises": raised,
           "launches_after_raises": after, "ok": ok})
    if not ok:
        raise AssertionError("f32 state: pool, streams or the fused-path "
                             "refusal wrong")


def phase_greedy_sample(params, model):
    """greedy_decode on rwkv4-169m (per-op decode_step, B 4, 16 tokens)
    with sample_temp=0.8: two runs from generators of one seed give the
    same tokens; sample_temp=0 with a generator gives the greedy stream."""
    from repro_torch.launch.serve import greedy_decode
    B, n = 4, 16
    first = torch.randint(0, model.cfg.vocab, (B, 1), device=DEV,
                          dtype=torch.int32,
                          generator=torch.Generator(device=DEV).manual_seed(
                              SEED + 25))

    def run(**kw):
        st = model.init_decode_state(B, 0, device=DEV)
        return greedy_decode(model, params, st, first, n, **kw)[0]
    gen = lambda: torch.Generator(device=DEV).manual_seed(SEED + 26)
    t0 = time.perf_counter()
    a = run(sample_temp=0.8, rng=gen())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    b = run(sample_temp=0.8, rng=gen())
    greedy = run()
    zero = run(sample_temp=0.0, rng=gen())
    ok = (torch.equal(a, b) and torch.equal(zero, greedy)
          and bool(((a >= 0) & (a < model.cfg.vocab)).all()))
    _line({"phase": "greedy_sample", "arch": model.cfg.name, "B": B,
           "tokens": n, "sample_temp": 0.8, "ms_per_step": ms,
           "same_seed_same_tokens": bool(torch.equal(a, b)),
           "temp0_equals_greedy": bool(torch.equal(zero, greedy)),
           "sampled_differs_from_greedy": not bool(torch.equal(a, greedy)),
           "ok": ok})
    if not ok:
        raise AssertionError("sampled greedy_decode is not reproducible, or "
                             "sample_temp=0 is not the greedy stream")


# ---------------------------------------------------------------------------
# The recurrent-state prefix cache and self-speculative decode
# ---------------------------------------------------------------------------


def _sync():
    if DEV == "cuda" and torch.cuda.is_available():
        torch.cuda.synchronize()


def _replan(plan, raw=None, k=None, depth=None):
    """A new ExecutionPlan on `plan`'s paths and prepared forms (or on the
    packed tree `raw`, its path forms prepared here), speculative with a
    window of `k` and a drafter of `depth` layers (default half the stack)
    when `k` is given: engines on one weight draw, each with its own
    programs and trace_counts."""
    from repro_torch.serving.plan import (ExecutionPlan, SpeculativePath,
                                          prepare_draft)
    model, prep = plan.model, plan.prepared
    if raw is not None:
        prep = dataclasses.replace(
            prep, raw=raw,
            decode=model.prepare_path_params(plan.decode_desc, raw),
            prefill=model.prepare_path_params(plan.prefill_desc, raw))
    sp = None
    if k is not None:
        depth = max(1, model.cfg.n_layers // 2) if depth is None else depth
        sp = SpeculativePath(k=k, draft_depth=depth,
                             desc=model.draft_paths()["truncated"])
        prep = dataclasses.replace(prep, draft=None if k == 1 else
                                   prepare_draft(model, plan.decode_desc.name,
                                                 prep.raw, depth))
    return ExecutionPlan(model, prep, plan.decode_desc, plan.prefill_desc,
                         prefill_chunk=plan.prefill_chunk,
                         max_len=plan.max_len, state_dtype=plan.state_dtype,
                         device=plan.device, speculative=sp)


def _serve(engine, prompts, n_new, *, temperature=0.0, counters=(),
           sequential=False):
    """Serve `prompts` (request i seeded SEED + 100 + i) with fresh
    ServingCounters (the cache's too), every counter in `counters` set to
    0 just before and read just after: (streams, snapshot, seconds,
    launches, handles).  `sequential` serves each request alone, one
    after the other."""
    from repro_torch.runtime.monitor import ServingCounters
    c = ServingCounters()
    engine.counters = engine.scheduler.counters = c
    if engine.prefix_cache is not None:
        engine.prefix_cache.counters = c
    for fn in counters:
        fn.launches = 0
    _sync()
    t0 = time.perf_counter()
    hs = []
    for i, p in enumerate(prompts):
        hs.append(engine.submit(p, max_new_tokens=n_new,
                                temperature=temperature, seed=SEED + 100 + i))
        if sequential:
            engine.run()
    snap = engine.run()
    _sync()
    seconds = time.perf_counter() - t0
    return ([h.tokens for h in hs], snap, seconds,
            {fn.__name__: fn.launches for fn in counters}, hs)


def _stub_drafter(engine, streams, kind):
    """Replace the engine's drafter by a stub that knows each request's
    stream (`streams`, in submission order from the engine's next rid):
    "accept" drafts the continuation, "reject" the next token + 1 mod V,
    "ragged" accepts on even slots and rejects on odd ones.  Returns the
    real drafter, to put back.  The CPU tests use it too."""
    sched, S = engine.scheduler, engine.pool.max_slots
    km1, V, base = engine.speculative - 1, engine.model.cfg.vocab, \
        engine._next_rid
    real = sched.draft_fn

    def draft(state, toks):
        out = np.zeros((S, km1), np.int32)
        for slot, meta in sched.slots.items():
            if meta.phase != "decode":
                continue
            s, g = streams[meta.req.rid - base], len(meta.generated)
            if kind == "accept" or (kind == "ragged" and slot % 2 == 0):
                out[slot] = [s[min(g + i, len(s) - 1)] for i in range(km1)]
            else:
                out[slot] = (s[min(g, len(s) - 1)] + 1) % V
        return out
    sched.draft_fn = draft
    return real


def _snapshot_guard(engine):
    """Wrap the engine's drafter and verifier: the rollback snapshot (the
    pool state a tick's draft and first verify read) is cloned when first
    seen and compared with its clone after each draft and verify call of
    the tick.  Returns the record {"ticks", "checks", "intact"}.  The
    on-card tests use it too."""
    sched = engine.scheduler
    draft, verify = sched.draft_fn, sched.verify_fn
    rec, saved = {"ticks": 0, "checks": 0, "intact": True}, {}

    def keep(state):
        if saved.get("ref") is not state:
            saved["ref"] = state
            saved["copy"] = {k: v.clone() for k, v in state.items()}
            rec["ticks"] += 1

    def check():
        rec["checks"] += 1
        rec["intact"] &= all(torch.equal(saved["ref"][k], v)
                             for k, v in saved["copy"].items())

    def d(state, toks):
        keep(state)
        out = draft(state, toks)
        check()
        return out

    def v(state, window, valid):
        if state is sched._spec_snapshot:
            keep(state)
        out = verify(state, window, valid)
        check()
        return out
    if draft is not None:
        sched.draft_fn = d
    sched.verify_fn = v
    return rec


def _spec_counts(k, rolled_back=True):
    """JAX's trace_counts of a speculative engine after serving."""
    want = {"decode": 0, "prefill": 1, "verify": 1,
            "rollback": int(k > 1 and rolled_back)}
    if k > 1:
        want["draft"] = 1
    return want


def _first_diff(a, b):
    """(request, position) of the first token where two stream lists
    differ, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        for j, (s, t) in enumerate(zip(x, y)):
            if s != t:
                return [i, j]
        if len(x) != len(y):
            return [i, min(len(x), len(y))]
    return None


def _k2_windows(cfg, flush):
    """K2 at the verify windows' shapes, B 8, T 1, 2, 4 (prefix masks), the
    bf16 pool state in and the bf16 carry, against its plain version."""
    from repro_torch.kernels.wkv4 import wkv4_seq, wkv4_seq_plain
    rows = []
    for T in (1, 2, 4):
        B, C = 8, cfg.d_model
        g = torch.Generator(device=DEV).manual_seed(SEED + 40 + T)
        rn = lambda *s: torch.randn(s, generator=g, device=DEV)
        k, v = rn(B, T, C), rn(B, T, C)
        w, u = torch.exp(0.5 * rn(C)), 0.5 * rn(C)
        bf = lambda t: t.to(torch.bfloat16).float()
        args = (k, v, w, u, bf(rn(B, C)), bf(rn(B, C).abs() + 0.5),
                bf(rn(B, C) - 1))
        valid = torch.zeros((B, T), dtype=torch.bool, device=DEV)
        for i, n in enumerate((T, T - 1, 0, 1, T, T, T // 2, T)):
            valid[i, :n] = True
        kw = {"valid": valid, "carry_dtype": "bfloat16"}
        y, fin = wkv4_seq(*args, **kw)
        y_p, fin_p = wkv4_seq_plain(*args, **kw)
        err = 0.0
        for name, o, r in zip(("y", "a", "b", "o"), (y, *fin),
                              (y_p, *fin_p)):
            ok, e = _elementwise_ok(o, r)
            if not ok:
                raise AssertionError(f"K2 T {T} {name}: max |d| {e}")
            err = max(err, e)
        nbytes = 4 * (3 * B * T * C + 2 * C + 6 * B * C) + 4 * B * T
        bms, by = _bound(nbytes, 20.0 * B * T * C, PEAK_F32_FLOPS)
        row = {"kernel": "wkv4_seq", "role": "verify window", "B": B,
               "T": T, "C": C, "max_abs_err": err,
               "kernel_ms": _time_ms(lambda: wkv4_seq(*args, **kw), flush),
               "plain_ms": _time_ms(lambda: wkv4_seq_plain(*args, **kw),
                                    flush),
               "library_ms": None, "bound_ms": bms, "bound_by": by}
        _line(row)
        rows.append(row)
    return rows


def _k6_windows(flush):
    """K6 at the verify windows' shapes, (B, T, H, N) = (8, 1 / 2 / 4, 64,
    64), prefix masks, the bf16 pool state and carry (`_k6_check`)."""
    from repro_torch.kernels.wkv6 import wkv6_seq, wkv6_seq_plain
    rows = []
    for T in (1, 2, 4):
        B, H, N = 8, 64, 64
        args, kw = _k6_operands(B, T, H, N, SEED + 50 + T,
                                (T, T - 1, 0, 1, T, T, T // 2, T))
        err, _ = _k6_check(args, kw, f"verify window T {T}")
        nbytes, bms, by = _k6_bound(B, T, H, N, 2, True)
        row = {"kernel": "wkv6_seq", "role": "verify window", "B": B,
               "T": T, "H": H, "N": N, "max_abs_err": err,
               "state_bit_exact": True, "y_inorder_bit_exact": True,
               "kernel_ms": _time_ms(lambda: wkv6_seq(*args, **kw), flush),
               "plain_ms": _time_ms(lambda: wkv6_seq_plain(*args, **kw),
                                    flush),
               "library_ms": None, "bound_ms": bms, "bound_by": by}
        _line(row)
        rows.append(row)
    return rows


def _head_windows(head, S, ks, flush):
    """The head's K5 (its plane's form) at the verify heads' M = S·k,
    against its plain version, beside torch.matmul on the decoded plane."""
    from repro_torch.core.quant.serving import leaf_plane, unpack_leaf
    from repro_torch.device import exact_matmuls
    from repro_torch.kernels import fused_prefill as fp
    plane = leaf_plane(head)
    fn, plain, codes = {
        "w8": (fp.dpot_w8_matmul, fp.dpot_w8_matmul_plain, "packed"),
        "w4": (fp.dpot_w4_matmul, fp.dpot_w4_matmul_plain, "packed4")}[plane]
    wq, scale = head[codes], head["scale"].reshape(-1)
    w_bf = unpack_leaf(head)
    K, N = w_bf.shape
    g = torch.Generator(device=DEV).manual_seed(SEED + 60)
    rows = []
    for k in ks:
        M = S * k
        x = torch.randn((M, K), generator=g, device=DEV).to(torch.bfloat16)
        ok, err = _elementwise_ok(fn(x, wq, scale), plain(x, wq, scale),
                                  _sum_order_floor(x, w_bf))
        if not ok:
            raise AssertionError(f"K5 head {plane} M {M}: max |d| {err}")
        nbytes = M * K * 2 + wq.numel() + N * 4 + M * N * 2
        bms, by = _bound(nbytes, 2.0 * M * N * K, PEAK_BF16_FLOPS)
        with exact_matmuls():
            lib = _time_ms(lambda: torch.matmul(x, w_bf), flush)
        row = {"kernel": fn.__name__, "matrix": "head", "role":
               "verify head", "M": M, "K": K, "N": N, "max_abs_err": err,
               "kernel_ms": _time_ms(lambda: fn(x, wq, scale), flush),
               "plain_ms": _time_ms(lambda: plain(x, wq, scale), flush),
               "library_ms": lib, "bound_ms": bms, "bound_by": by}
        _line(row)
        rows.append(row)
    return rows


def _logits_to_host_ms(S, k, V, reps=10):
    """The host copy a speculative tick makes of its verify logits: (S, k,
    V) bf16 on the card to f32 numpy, ms a copy (host clock, synced)."""
    t = torch.zeros((S, k, V), dtype=torch.bfloat16, device=DEV)
    t.float().cpu().numpy()
    _sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        t.float().cpu().numpy()
    return (time.perf_counter() - t0) * 1e3 / reps


def _prefix_traffic(V, prefix_len, seed):
    """A shared `prefix_len`-token prefix, a warm-up prompt (the prefix and
    one token) and 8 prompts of the prefix and 5-40 tokens of their own."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, V, prefix_len).tolist()
    warm = prefix + rng.integers(0, V, 1).tolist()
    prompts = [prefix + rng.integers(0, V, int(n)).tolist()
               for n in rng.integers(5, 41, 8)]
    return prefix, warm, prompts


def phase_prefix_cache(model_engine, w8_engine):
    """The prefix cache on rwkv4-169m's MIXED model path (K4, K5 + K2; 8
    slots, chunk 16): 8 requests sharing a 64-token prefix, each with 5-40
    tokens of its own, × 32 new tokens, after a warm-up request (the
    prefix and one token) that publishes the prefix's boundary states.
    Asserts 8 hits, cached_tokens 8 × 64, prefill_tokens the suffixes'
    sum, the streams bit for bit a cacheless engine's, K4, K5 and K2
    launched, trace_counts {"decode": 1, "prefill": 1}, check_state; then
    the same requests one after the other with device_slots 1 and
    host_slots 8 (spills and host hits, the streams unchanged); then a W8
    block-path engine sharing the cache gets no hit from the MIXED
    entries.  Prints the mean TTFT with and without the cache."""
    from repro_torch.kernels.fused_decode import rwkv4_model_decode
    from repro_torch.kernels.fused_prefill import (
        dpot_w4_matmul, dpot_w8_matmul, vq_matmul)
    from repro_torch.kernels.wkv4 import wkv4_seq
    from repro_torch.serving import PrefixCacheConfig, ServingEngine
    plan = model_engine.plan
    V = plan.model.cfg.vocab
    prefix, warm, prompts = _prefix_traffic(V, 64, SEED + 30)
    suffix = sum(len(p) - len(prefix) for p in prompts)
    counters = (dpot_w8_matmul, dpot_w4_matmul, vq_matmul, wkv4_seq,
                rwkv4_model_decode)
    # the cacheless reference on its own plan: warm-up, then the 8
    plain = ServingEngine(plan.model, plan=_replan(plan), max_batch=8,
                          device=DEV)
    (w_ref,), _, _, _, _ = _serve(plain, [warm], 32)
    ref, snap0, _, _, _ = _serve(plain, prompts, 32)
    cached = ServingEngine(plan.model, plan=_replan(plan), max_batch=8,
                           prefix_cache=True, device=DEV)
    cache = cached.prefix_cache
    (w_got,), _, _, _, _ = _serve(cached, [warm], 32)
    got, snap, seconds, launches, _ = _serve(cached, prompts, 32,
                                             counters=counters)
    cache.check_state()
    want = {"cache_hits": 8, "cache_misses": 0,
            "cached_tokens": 8 * len(prefix), "prefill_tokens": suffix,
            "finished": 8}
    counts = {k: snap[k] for k in want}
    main_ok = (counts == want and got == ref and w_got == w_ref
               and min(launches.values()) > 0
               and cached.trace_counts == {"decode": 1, "prefill": 1})
    # the spill tier: one device slot, the requests one after the other
    spill = ServingEngine(plan.model, plan=_replan(plan), max_batch=8,
                          prefix_cache=PrefixCacheConfig(device_slots=1,
                                                         host_slots=8),
                          device=DEV)
    _serve(spill, [warm], 32)
    s_got, s_snap, _, _, _ = _serve(spill, prompts, 32, sequential=True)
    spill.prefix_cache.check_state()
    s_stats = spill.prefix_cache.snapshot()
    spill_ok = (s_got == ref and s_stats["spills"] > 0
                and s_stats["host_hits"] > 0 and s_snap["cache_hits"] == 8)
    # a W8 engine sharing the MIXED entries' cache: another variant
    w8 = ServingEngine(plan.model, plan=_replan(w8_engine.plan), max_batch=8,
                       prefix_cache=cache, device=DEV)
    _, w8_snap, _, _, _ = _serve(w8, prompts, 4)
    variants = [str(e.plan.cache_variant()) for e in (cached, w8)]
    iso_ok = (w8_snap["cache_hits"] == 0 and w8_snap["cache_misses"] == 8
              and variants[0] != variants[1])
    cache.check_state()
    ok = main_ok and spill_ok and iso_ok
    _line({"phase": "prefix_cache", "arch": plan.model.cfg.name,
           "planes": "MIXED", "decode": plan.decode_desc.name,
           "prefill": plan.prefill_desc.name, "slots": 8,
           "chunk": plan.prefill_chunk, "prefix": len(prefix),
           "suffix_lens": [len(p) - len(prefix) for p in prompts],
           "new_tokens": 32, "counts": counts, "want": want,
           "streams_bit_equal": got == ref and w_got == w_ref,
           "launches": launches, "trace_counts": cached.trace_counts,
           "mean_ttft_s": {"cache": snap["mean_ttft_s"],
                           "no_cache": snap0["mean_ttft_s"]},
           "mean_cache_probe_s": snap["mean_cache_probe_s"],
           "mean_state_copy_s": snap["mean_state_copy_s"],
           "tokens_per_s": snap["decode_tokens"] / seconds,
           "cache": cache.snapshot(),
           "spill": {"stats": s_stats, "cache_hits": s_snap["cache_hits"],
                     "streams_bit_equal": s_got == ref},
           "w8_shared": {"variants": variants,
                         "cache_hits": w8_snap["cache_hits"],
                         "cache_misses": w8_snap["cache_misses"]},
           "ok": ok})
    if not ok:
        raise AssertionError(f"prefix cache: main {main_ok}, spill "
                             f"{spill_ok}, variant isolation {iso_ok}")
    return {"prefix-cache": launches}


def phase_prefix_cache6(engine):
    """The prefix cache on rwkv6-7b's W8 model path (K7-model, K5 + K6):
    two requests sharing a 32-token prefix, served one after the other;
    the second hits and streams the uncached engine's tokens bit for bit.
    Prints one lane state's bytes."""
    from repro_torch.kernels.fused_decode import rwkv6_model_decode
    from repro_torch.kernels.fused_prefill import dpot_w8_matmul
    from repro_torch.kernels.wkv6 import wkv6_seq
    from repro_torch.serving import ServingEngine
    plan = engine.plan
    V = plan.model.cfg.vocab
    rng = np.random.default_rng(SEED + 31)
    prefix = rng.integers(0, V, 32).tolist()
    prompts = [prefix + rng.integers(0, V, n).tolist() for n in (5, 9)]
    counters = (dpot_w8_matmul, wkv6_seq, rwkv6_model_decode)
    ref, _, _, _, _ = _serve(engine, prompts, 16, sequential=True)
    cached = ServingEngine(plan.model, plan=_replan(plan), max_batch=8,
                           prefix_cache=True, device=DEV)
    got, snap, seconds, launches, _ = _serve(cached, prompts, 16,
                                             counters=counters,
                                             sequential=True)
    cached.prefix_cache.check_state()
    lane = cached.pool.read_slot(0)
    lane_bytes = sum(t.numel() * t.element_size() for t in lane.values())
    ok = (got == ref and snap["cache_hits"] == 1
          and snap["cached_tokens"] == 32 and min(launches.values()) > 0)
    _line({"phase": "prefix_cache6", "arch": plan.model.cfg.name,
           "planes": "W8", "decode": plan.decode_desc.name, "prefix": 32,
           "suffix_lens": [5, 9], "new_tokens": 16,
           "cache_hits": snap["cache_hits"],
           "cached_tokens": snap["cached_tokens"],
           "streams_bit_equal": got == ref, "launches": launches,
           "lane_state_bytes": lane_bytes,
           "lane_state_shapes": {k: list(v.shape) for k, v in lane.items()},
           "mean_state_copy_s": snap["mean_state_copy_s"],
           "cache": cached.prefix_cache.snapshot(), "ok": ok})
    if not ok:
        raise AssertionError(f"rwkv6 prefix cache: hits "
                             f"{snap['cache_hits']}, equal {got == ref}, "
                             f"launches {launches}")
    return {"prefix-cache6": launches}


def _zero_tail(leaf, depth):
    """A matmul leaf whose layers >= depth decode to exact zeros: W8 / W4
    codes 0; VQ indices of a codebook entry set to 0 (the entry nearest 0,
    which layers < depth keep using as 0); a plain tensor zeroed."""
    from repro_torch.core.quant.serving import CODES_KEY, leaf_plane
    plane = leaf_plane(leaf)
    if plane is None:
        out = leaf.clone()
        out[depth:] = 0
        return out
    out = {k: v.clone() for k, v in leaf.items()}
    if plane == "vq":
        z = int(out["codebook"].float().abs().argmin())
        out["codebook"].view(-1)[z] = 0
        out["vq_idx"][depth:] = z
    else:
        out[CODES_KEY[plane]][depth:] = 0
    return out


def _aligned_tree(raw, depth):
    """bench_speculative's aligned weights on a packed tree: att.wo and
    ffn.wv decode to zero for layers >= depth, so those blocks add nothing
    to the residual and a depth-layer drafter predicts the full model."""
    b = raw["blocks"]
    blocks = {**b, "att": {**b["att"], "wo": _zero_tail(b["att"]["wo"],
                                                        depth)},
              "ffn": {**b["ffn"], "wv": _zero_tail(b["ffn"]["wv"], depth)}}
    return {**raw, "blocks": blocks}


def _verify_teacher_forced(engine, ks, refs=None):
    """Identity (c): the verifier's rows teacher-forced (8 lanes: a
    16-token prefill chunk, then 32 tokens in windows of k through
    prefill_chunk_logits) against the plain bf16 path and the f32 witness
    of phase_teacher_forced (rwkv4), or of phase_teacher_forced6 (`refs`,
    its tokens, plain path and witness, kept for rwkv6), within TF_BOUNDS
    of the engine's path.  Also returns, for finding (d), each k's rows,
    the state at each window's start and the 32 teacher-forced tokens."""
    model, cfg = engine.model, engine.model.cfg
    prep = engine.plan.prepared
    B, C, S = 8, 16, 32
    if refs is None:
        g = torch.Generator(device=DEV).manual_seed(SEED + 7)
        toks = torch.randint(0, cfg.vocab, (B, C + S), generator=g,
                             device=DEV, dtype=torch.int32)
        ref = _plain_logits(model, prep.raw, toks, C)
        f32 = _plain_logits(model, prep.raw, toks, C, torch.float32)
        tb = TF_BOUNDS[prep.decode_path]
    else:
        toks, ref, f32 = refs["toks"], refs["ref"], refs["f32"]
        tb = TF_BOUNDS["rwkv6-" + prep.decode_path]
    max_f32, max_ref = float(f32.abs().max()), float(ref.abs().max())
    out, rows, starts = {}, {}, {}
    for k in ks:
        starts[k] = []
        with torch.inference_mode():
            s = model.init_decode_state(B, 0, device=DEV)
            s, lg = model.prefill_chunk(
                prep.prefill, s, toks[:, :C],
                torch.ones((B, C), dtype=torch.bool, device=DEV))
            seq = [lg]
            for w in range(C, C + S, k):
                starts[k].append(s)
                s, r = model.prefill_chunk_logits(
                    prep.prefill, s, toks[:, w:w + k],
                    torch.ones((B, k), dtype=torch.bool, device=DEV))
                seq += [r[:, j:j + 1] for j in range(k)]
        lg = torch.stack(seq).float()
        rows[k] = lg
        kf, kp = _gap(lg, f32), _gap(lg, ref)
        ok = (kf["mean_rel"] <= tb["mean_rel_f32"]
              and kf["max_abs"] <= tb["max_rel_f32"] * max_f32
              and kf["argmax_agree"] >= tb["argmax_f32"]
              and kp["mean_rel"] <= tb["mean_rel_plain"]
              and kp["max_abs"] <= tb["max_rel_plain"] * max_ref
              and bool(torch.isfinite(lg).all()))
        out[k] = {"verify_vs_f32": kf, "verify_vs_plain": kp,
                  "within_bound": ok}
    return out, (rows, starts, toks[:, C:]), {
        "mean_rel_f32": tb["mean_rel_f32"],
                       "max_abs_f32": tb["max_rel_f32"] * max_f32,
                       "argmax_f32": tb["argmax_f32"],
                       "mean_rel_plain": tb["mean_rel_plain"],
                       "max_abs_plain": tb["max_rel_plain"] * max_ref}


def _window_ops(engine, s0, win):
    """Finding (d) op by op: from state `s0`, the verify program over the
    window `win` (B, k) against k windows of 1, compared bit for bit: the
    whole verify (rows and state), then each layer's block (x and every
    state leaf) up to the first that differs, and there each op with that
    layer's own inputs: ln1's and ln2's rows, each matrix's K5 rows (M 8·k
    against M 8) and K2 over T k against k steps of T 1; with no layer
    differing, ln_f's and the head's rows on the last layer's output."""
    from repro_torch.core.quant.serving import (broadcast_packed_scales,
                                                cast_compute)
    from repro_torch.kernels.fused_prefill import chunk_matmul, shifted_prev
    from repro_torch.kernels.wkv4 import wkv4_seq
    from repro_torch.models import layers as L
    from repro_torch.models.rwkv4 import (STATE_KEYS, _chunk_numerics,
                                          _layer, block_prefill)
    model, cfg = engine.model, engine.model.cfg
    dt, f32 = getattr(torch, cfg.dtype), torch.float32
    prep = engine.plan.prepared.prefill
    p = cast_compute(prep, dt)
    blocks = broadcast_packed_scales(p["blocks"], cfg.n_layers)
    B, k = win.shape
    ones = lambda n: torch.ones((B, n), dtype=torch.bool, device=DEV)
    eq = lambda a, b: bool(torch.equal(a, b))
    nm = _chunk_numerics(False)
    per_pos = lambda f, a: all(eq(f(a)[:, j:j + 1], f(a[:, j:j + 1]))
                               for j in range(k))
    out = {"k": k}
    with torch.inference_mode():
        s1, rows = model.prefill_chunk_logits(prep, s0, win, ones(k))
        rs, cur = [], s0
        for j in range(k):
            cur, rj = model.prefill_chunk_logits(prep, cur, win[:, j:j + 1],
                                                 ones(1))
            rs.append(rj)
        out["verify_rows"] = eq(rows, torch.cat(rs, 1))
        out["verify_state"] = {n: eq(s1[n], cur[n]) for n in s1}
        x = L.apply_norm(p["ln0"], p["embed"][win.long()].to(dt))
        out["first_layer_differing"] = None
        for layer in range(cfg.n_layers):
            lp = _layer(blocks, layer)
            st = {n: s0[n][layer] for n in STATE_KEYS}
            xo, so = block_prefill(lp, st, x, ones(k), nm)
            xs, cur = [], st
            for j in range(k):
                xj, cur = block_prefill(lp, cur, x[:, j:j + 1], ones(1), nm)
                xs.append(xj)
            diff = {"x": not eq(xo, torch.cat(xs, 1)),
                    **{n: not eq(so[n], cur[n]) for n in so}}
            if any(diff.values()):
                out["first_layer_differing"] = layer
                out["outputs_differing"] = [n for n, d in diff.items() if d]
                break
            x = xo
        if out["first_layer_differing"] is None:
            xf = L.apply_norm(p["ln_f"], x)
            out["ops_after_the_layers"] = {
                "ln_f": per_pos(lambda a: L.apply_norm(p["ln_f"], a), x),
                "k5_head": per_pos(
                    lambda a: chunk_matmul(a, p["head"], dt), xf)}
            return out
        h = L.apply_norm(lp["ln1"], x)
        ops = {"ln1": per_pos(lambda a: L.apply_norm(lp["ln1"], a), x),
               "ln2": per_pos(lambda a: L.apply_norm(lp["ln2"], a), x)}
        for grp, names in (("att", ("wr", "wk", "wv", "wo")),
                           ("ffn", ("wr", "wk"))):
            for n in names:
                ops[f"k5_{grp}_{n}"] = per_pos(
                    lambda a, w=lp[grp][n]: chunk_matmul(a, w, dt), h)
        kf = torch.relu(chunk_matmul(h, lp["ffn"]["wk"], dt))
        ops["k5_ffn_wv"] = per_pos(
            lambda a: chunk_matmul(a, lp["ffn"]["wv"], dt), kf)
        pa = lp["att"]
        hx = shifted_prev(h.to(st["att_x"].dtype), st["att_x"], ones(k))
        mix = lambda m: nm.act_q(h * pa[m] + hx * (1.0 - pa[m]))
        kk = chunk_matmul(mix("time_mix_k"), pa["wk"], dt).to(f32)
        vv = chunk_matmul(mix("time_mix_v"), pa["wv"], dt).to(f32)
        w, u = torch.exp(pa["time_decay"].to(f32)), pa["time_first"].to(f32)
        abc = [st[n].to(f32) for n in ("wkv_a", "wkv_b", "wkv_o")]
        y, fin = wkv4_seq(kk, vv, w, u, *abc, valid=ones(k),
                          carry_dtype="bfloat16")
        ys, cur = [], abc
        for j in range(k):
            yj, cur = wkv4_seq(kk[:, j:j + 1], vv[:, j:j + 1], w, u, *cur,
                               valid=ones(1), carry_dtype="bfloat16")
            ys.append(yj)
        ops["k2_y"] = eq(y, torch.cat(ys, 1))
        ops["k2_state"] = all(eq(a, b) for a, b in zip(fin, cur))
        out["ops_at_first_layer"] = ops
    return out


def _finding_d(engine, streams, rows, starts, toks):
    """Finding (d): the k 1, 2 and 4 streams compared, the teacher-forced
    rows of k 1 against k 2 and 4 (the first differing row's window, lanes
    and position), and `_window_ops` from the k 4 path's state at the
    start of the first window of 4 whose rows differ from four of 1 (or
    of the last window when none differs)."""
    out = {"k1_equals_k4_streams": streams[1] == streams[4],
           "k1_k4_first_diff": _first_diff(streams[1], streams[4]),
           "k1_equals_k2_streams": streams[1] == streams[2]}
    first = None
    for k in (2, 4):
        d = (rows[1] != rows[k]).any(dim=-1)[..., 0]   # (1 + S, B)
        where = torch.nonzero(d)
        key = f"teacher_forced_rows_k1_vs_k{k}"
        if not len(where):
            out[key] = {"equal": True}
            continue
        i = int(where[0, 0])                 # row i: after token C + i - 1
        out[key] = {"equal": False, "rows_differing": int(d.sum()),
                    "first_row": i, "lanes": torch.nonzero(
                        d[i])[:, 0].tolist()}
        if k == 4:
            first = (i - 1) // 4
    w = len(starts[4]) - 1 if first is None else first
    same = all(torch.equal(starts[4][w][n], starts[1][4 * w][n])
               for n in starts[4][w])
    out["window_probe"] = {"window": w, "start_states_equal": same,
                           **_window_ops(engine, starts[4][w],
                                         toks[:, 4 * w:4 * w + 4])}
    return out


def _drafter_tokens(spec, depth, state, tok):
    """`draft_fn(8)`'s tokens from `state` after `tok`, beside the greedy
    chain of the truncated tree's block path (K3 / K7-block a layer, its
    weights prepared from `truncate_params` apart from the drafter's
    slabs) and one step's state of the drafter's own form
    (`prepared.draft`) with that of the full model's decode form: the
    drafted tokens and the first step's logits equal bit for bit, and the
    drafter's state `truncate_state` of the full model's, bit for bit."""
    from repro_torch.serving.plan import prepare_draft
    plan = spec.plan
    model, prep = plan.model, plan.prepared
    tm = model.truncated(depth)
    block = prepare_draft(model, "block", prep.raw, depth)
    with torch.inference_mode():
        _, full = model.decode_step_fused_model(prep.decode, state, tok, 0)
        lg_d, cut = tm.decode_step_fused_model(
            prep.draft, model.truncate_state(state, depth), tok, 0)
        st, t, chain, first = model.truncate_state(state, depth), tok, [], None
        for _ in range(plan.speculative.k - 1):
            lg, st = tm.decode_step_fused(block, st, t, 0)
            first = lg if first is None else first
            t = torch.argmax(lg[:, 0].float(), dim=-1).to(torch.int32)[:, None]
            chain.append(t)
    drafted = plan.draft_fn(8)(state, tok)
    _sync()
    want = model.truncate_state(full, depth)
    return {"state_bits_equal_full_models": {
                k: bool(torch.equal(cut[k], want[k])) for k in cut},
            "first_logits_equal_block_path": bool(torch.equal(lg_d, first)),
            "tokens_equal_block_chain": bool(torch.equal(
                drafted, torch.cat(chain, 1))),
            "drafted": drafted.tolist()}


def _served_state(engine, seed):
    """A state after one 16-token prefill chunk on 8 lanes (the engine's
    prefill form) and the next token."""
    model, prep = engine.model, engine.plan.prepared
    B, C = 8, 16
    toks = torch.randint(0, model.cfg.vocab, (B, C + 1), device=DEV,
                         dtype=torch.int32,
                         generator=torch.Generator(device=DEV).manual_seed(
                             seed))
    with torch.inference_mode():
        s = model.init_decode_state(B, 0, device=DEV)
        s, _ = model.prefill_chunk(
            prep.prefill, s, toks[:, :C],
            torch.ones((B, C), dtype=torch.bool, device=DEV))
    return s, toks[:, C:]


def _drafter4(engine, spec, flush):
    """The rwkv4 drafter of the speculative engine `spec`: phase_k4's
    checks on its truncated stack's slabs (`prepared.draft`, L = the
    draft depth: bit for bit that many K3 launches, each within K3_* of
    its plain version, K4 within K4_* of its own, timed beside its
    bound), then `_drafter_tokens` from a served state.  Returns K4's row
    at that depth."""
    plan = spec.plan
    depth = plan.speculative.draft_depth
    row = phase_k4(spec, flush, stack=plan.prepared.draft["blocks"],
                   role="drafter")
    state, tok = _served_state(engine, SEED + 33)
    rec = _drafter_tokens(spec, depth, state, tok)
    ok = (all(rec["state_bits_equal_full_models"].values())
          and rec["first_logits_equal_block_path"]
          and rec["tokens_equal_block_chain"])
    _line({"phase": "drafter", "arch": plan.model.cfg.name, "depth": depth,
           "of": plan.model.cfg.n_layers, "k": plan.speculative.k, **rec,
           "ok": ok})
    if not ok:
        raise AssertionError(f"rwkv4 drafter at depth {depth}: {rec}")
    return row


def _drafter6(engine, spec, flush):
    """The rwkv6 drafter of the speculative engine `spec`: K7-model on its
    truncated stack's slabs (`prepared.draft`, L = the draft depth) at
    B = 8, bit for bit equal to L K7-block launches on the full engine's
    first L layers (unfused from the full slabs), each within K7B_* of its
    plain version on its own inputs; the gaps to K7-model's own plain
    version at that depth, both timed beside the bound; then
    `_drafter_tokens` from a served state.  Returns K7-model's row at that
    depth."""
    from repro_torch.core.quant.serving import unfuse_layer
    from repro_torch.kernels.fused_decode import (
        rwkv6_block_decode, rwkv6_block_decode_plain, rwkv6_model_decode,
        rwkv6_model_decode_plain)
    plan = spec.plan
    cfg, depth = plan.model.cfg, plan.speculative.draft_depth
    stack, full = plan.prepared.draft["blocks"], \
        engine.plan.prepared.decode["blocks"]
    L, B = stack.n_layers, 8
    st, x = _state6(cfg, (L, B), SEED + 12)
    xm, newm = rwkv6_model_decode(stack, st, x, cfg)
    aux = [a[0] for a in full.aux]
    xb, newb, kb_err, kb_mean = x, [], 0.0, 0.0
    for l in range(L):
        lp = unfuse_layer({k: s[l] for k, s in full.slabs.items()}, aux,
                          full.manifest, full.tdef)
        st_l = {k: st[k][l] for k in STATE6}
        out = rwkv6_block_decode(lp, st_l, xb, cfg)
        e, m, _, _ = _k7_check(out, rwkv6_block_decode_plain(lp, st_l, xb,
                                                             cfg),
                               f"drafter block, layer {l}")
        kb_err, kb_mean = max(kb_err, e), max(kb_mean, m)
        xb = out[0]
        newb.append(out[1])
    if not (torch.equal(xm, xb) and all(
            torch.equal(newm[k], torch.stack([s[k] for s in newb]))
            for k in STATE6)):
        raise AssertionError(f"K7-model on the drafter's {L} layers differs "
                             f"from {L} K7-block launches on the full slabs")
    ref = rwkv6_model_decode_plain(stack, st, x, cfg)
    err = max(float((o.float() - r.float()).abs().max()) for o, r in zip(
        (xm, *(newm[k] for k in STATE6)), (ref[0], *(ref[1][k]
                                                     for k in STATE6))))
    bms, by = _bound(_k7_model_bytes(stack, st, x), _k7_ops(cfg, B, L),
                     PEAK_BF16_FLOPS)
    row = {"kernel": "rwkv6_model_decode", "role": "drafter",
           "model": cfg.name, "L": L, "B": B, "D": cfg.d_model,
           "F": cfg.d_ff, "H": cfg.n_heads,
           "equals_block_per_layer_of_the_full_slabs": True,
           "block_per_layer_vs_plain": {"max_abs_err": kb_err,
                                        "max_mean_rel_err": kb_mean},
           "max_abs_err": err, "gaps": _rel_gaps((xm, newm), ref),
           "kernel_ms": _time_ms(
               lambda: rwkv6_model_decode(stack, st, x, cfg), flush),
           "plain_ms": _time_ms(
               lambda: rwkv6_model_decode_plain(stack, st, x, cfg), flush, 2),
           "library_ms": None, "bound_ms": bms, "bound_by": by}
    _line(row)
    del ref
    state, tok = _served_state(engine, SEED + 34)
    rec = _drafter_tokens(spec, depth, state, tok)
    ok = (all(rec["state_bits_equal_full_models"].values())
          and rec["first_logits_equal_block_path"]
          and rec["tokens_equal_block_chain"])
    _line({"phase": "drafter", "arch": cfg.name, "depth": depth,
           "of": cfg.n_layers, "k": plan.speculative.k, **rec, "ok": ok})
    if not ok:
        raise AssertionError(f"rwkv6 drafter at depth {depth}: {rec}")
    return row


def phase_speculative(engine, flush):
    """Self-speculative decode on rwkv4-169m's MIXED model path (chunked
    prefill), the 8 requests of phase_engine × 32 new tokens, k 1, 2 and
    4 at the default draft depth (6 of 12 layers).  For each k: identity
    (a), greedy and seeded-sampled (temperature 0.8), the real drafter's
    stream equal bit for bit to an all-reject and an all-accept stub's;
    trace_counts JAX's; drafted == accepted + rejected; K5, K2 and (k > 1)
    K4 on the truncated stack launched; the rollback snapshot intact
    after every draft and verify.  Then: a request cancelled from its own
    on_token mid-tick (outcome "cancelled", nothing in flight, the other
    streams unchanged); aligned weights (att.wo, ffn.wv zero past layer
    0) with draft depth 1, k 4 (the drafter on K3): acceptance >= 0.9; a
    cache hit followed by speculative decode; identity (c) and finding
    (d); K2 at T 1, 2, 4 and the head's K5 at M 8·k against their plain
    versions; the k 4 drafter held at its depth (`_drafter4`); tokens/s
    at each k beside the plain engine's."""
    from repro_torch.kernels.fused_decode import (rwkv4_block_decode,
                                                  rwkv4_model_decode)
    from repro_torch.kernels.fused_prefill import (
        dpot_w4_matmul, dpot_w8_matmul, vq_matmul)
    from repro_torch.kernels.wkv4 import wkv4_seq
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.plan import draft_path
    plan = engine.plan
    model, V = plan.model, plan.model.cfg.vocab
    depth = max(1, model.cfg.n_layers // 2)
    # the drafter's kernel: K4 on the truncated stack, K3 on one layer
    drafter = {"model": "rwkv4_model_decode", "block": "rwkv4_block_decode"}[
        draft_path(plan.decode_desc.name, depth)]
    prompts = _engine_prompts(V)
    counters = (dpot_w8_matmul, dpot_w4_matmul, vq_matmul, wkv4_seq,
                rwkv4_model_decode, rwkv4_block_decode)
    plain = ServingEngine(model, plan=_replan(plan), max_batch=8, device=DEV)
    base, p_snap, p_s, _, _ = _serve(plain, prompts, 32)
    by_k, runs, streams, paths = {}, {}, {}, {}
    engines = {}
    for k in (1, 2, 4):
        eng = engines[k] = ServingEngine(model, plan=_replan(plan, k=k),
                                         max_batch=8, device=DEV)
        guard = _snapshot_guard(eng)
        got, snap, secs, launches, _ = _serve(eng, prompts, 32,
                                              counters=counters)
        sched = eng.scheduler
        sched.verify_fn = eng.plan.verify_fn(8)
        if k > 1:
            sched.draft_fn = eng.plan.draft_fn(8)
        streams[k] = got
        paths[f"speculative-k{k}"] = launches
        sampled, s_snap, _, _, _ = _serve(eng, prompts, 32, temperature=0.8)
        ident = {}
        for kind in ("reject", "accept") if k > 1 else ():
            for temp, want in ((0.0, got), (0.8, sampled)):
                real = _stub_drafter(eng, want, kind)
                st, _, _, _, _ = _serve(eng, prompts, 32, temperature=temp)
                sched.draft_fn = real
                ident[f"{kind}_t{temp}"] = st == want
        tc = dict(eng.trace_counts)
        ok = (all(ident.values()) and guard["intact"] and guard["checks"] > 0
              and tc == _spec_counts(k)
              and snap["drafted_tokens"] == snap["accepted_tokens"]
              + snap["rejected_tokens"]
              and all(launches[n] > 0 for n in (
                  "dpot_w8_matmul", "dpot_w4_matmul", "vq_matmul",
                  "wkv4_seq"))
              and (launches[drafter] > 0) == (k > 1)
              and snap["finished"] == 8 and snap["decode_tokens"] == 256)
        by_k[k] = {"identity_a": ident, "snapshot": guard,
                   "trace_counts": tc, "launches": launches,
                   "ticks": snap["ticks"],
                   "drafted": snap["drafted_tokens"],
                   "accepted": snap["accepted_tokens"],
                   "rejected": snap["rejected_tokens"],
                   "acceptance_rate": snap["acceptance_rate"],
                   "tokens_per_s": snap["decode_tokens"] / secs,
                   "mean_itl_s": snap["mean_itl_s"],
                   "equals_plain_engine": got == base,
                   "sampled_acceptance_rate": s_snap["acceptance_rate"],
                   "ok": ok}
        runs[k] = ok
    # the k 4 engine's drafter: K4 on the truncated stack, held at its depth
    k4_draft = _drafter4(engine, engines[4], flush)
    # a request cancelled from its own on_token during a speculative tick
    eng = engines[4]
    sched = eng.scheduler
    hs = [eng.submit(p, max_new_tokens=32, seed=SEED + 100 + i)
          for i, p in enumerate(prompts)]
    victim, orig, fired = hs[3], sched.on_token, []

    def on_token(req, tok):
        orig(req, tok)
        if (req.rid == victim.rid and not fired and len(victim.tokens) >= 5
                and sched._spec_snapshot is not None):
            fired.append(len(victim.tokens))
            eng.cancel(victim)
    sched.on_token = on_token
    eng.run()
    sched.on_token = orig
    cancel = {"fired_at": fired, "outcome": victim.outcome,
              "victim_prefix": victim.tokens == streams[4][3][
                  :len(victim.tokens)],
              "snapshot_none": sched._spec_snapshot is None,
              "inflight_empty": sched._spec_inflight == {},
              "others_unchanged": [h.tokens for i, h in enumerate(hs)
                                   if i != 3] ==
              [s for i, s in enumerate(streams[4]) if i != 3],
              "slots_free": eng.pool.n_free == 8}
    cancel_ok = bool(fired) and victim.outcome == "cancelled" and all(
        v for k_, v in cancel.items() if k_ not in ("fired_at", "outcome"))
    # aligned weights: the depth-1 drafter (K3 on layer 0) against 12 layers
    aligned = _aligned_tree(plan.prepared.raw, 1)
    a_plain = ServingEngine(model, plan=_replan(plan, raw=aligned),
                            max_batch=8, device=DEV)
    a_base, _, _, _, _ = _serve(a_plain, prompts, 32)
    a_spec = ServingEngine(model, plan=_replan(plan, raw=aligned, k=4,
                                               depth=1),
                           max_batch=8, device=DEV)
    a_got, a_snap, _, a_launch, _ = _serve(a_spec, prompts, 32,
                                           counters=counters)
    aligned_rec = {"acceptance_rate": a_snap["acceptance_rate"],
                   "drafted": a_snap["drafted_tokens"],
                   "accepted": a_snap["accepted_tokens"],
                   "launches": a_launch,
                   "equals_plain_engine": a_got == a_base}
    aligned_ok = (a_snap["acceptance_rate"] >= 0.9
                  and a_launch["rwkv4_block_decode"] > 0)
    # a cache hit, then speculative decode: the uncached run's tokens
    rng = np.random.default_rng(SEED + 32)
    pre = rng.integers(0, V, 32).tolist()
    two = [pre + [3], pre + rng.integers(0, V, 7).tolist()]
    c_ref, _, _, _, _ = _serve(engines[4], two, 16, sequential=True)
    c_eng = ServingEngine(model, plan=_replan(plan, k=4), max_batch=8,
                          prefix_cache=True, device=DEV)
    c_got, c_snap, _, _, _ = _serve(c_eng, two, 16, sequential=True)
    cache_ok = c_got == c_ref and c_snap["cache_hits"] == 1
    # identity (c), finding (d)
    tf, (rows, starts, tf_toks), bounds = _verify_teacher_forced(
        engine, (1, 2, 4))
    tf_ok = all(v["within_bound"] for v in tf.values())
    finding = _finding_d(engine, streams, rows, starts, tf_toks)
    finding["plain_engine_equals_k1"] = base == streams[1]
    k2w = _k2_windows(model.cfg, flush)
    head = _head_windows(plan.prepared.prefill["head"], 8, (1, 2, 4), flush)
    host_ms = {k: _logits_to_host_ms(8, k, V) for k in (1, 2, 4)}
    ok = all(runs.values()) and cancel_ok and aligned_ok and cache_ok \
        and tf_ok
    _line({"phase": "speculative", "arch": model.cfg.name, "planes": "MIXED",
           "decode": plan.decode_desc.name, "prefill": plan.prefill_desc.name,
           "requests": 8, "new_tokens": 32, "draft_depth": depth,
           "drafter_kernel": drafter,
           "plain_engine": {"tokens_per_s": p_snap["decode_tokens"] / p_s,
                            "ticks": p_snap["ticks"],
                            "mean_itl_s": p_snap["mean_itl_s"]},
           "by_k": by_k, "cancel_in_own_on_token": cancel,
           "aligned_depth1_k4": aligned_rec,
           "cache_hit_then_speculative": {
               "streams_bit_equal": c_got == c_ref,
               "cache_hits": c_snap["cache_hits"]},
           "identity_c": tf, "identity_c_bounds": bounds,
           "finding_d": finding, "logits_to_host_ms": host_ms,
           "ok": ok})
    if not ok:
        raise AssertionError(
            f"speculative: runs {runs}, cancel {cancel_ok}, aligned "
            f"{aligned_ok} ({a_snap['acceptance_rate']}), cache {cache_ok}, "
            f"identity (c) {tf_ok}")
    paths["speculative-aligned"] = a_launch
    return paths, k2w, head, k4_draft


def phase_speculative6(engine, flush, refs):
    """Self-speculative decode on rwkv6-7b's W8 model path: k 4, draft
    depth 16 (K7-model on 16 of 32 layers drafts, K5 at M 32 and K6 over
    the window verify), 4 requests × 16 new tokens: identity (a) with an
    all-reject stub, trace_counts JAX's, drafted == accepted + rejected,
    every kernel launched, the snapshot intact; the drafter held at its
    depth (`_drafter6`); identity (c) at k 4 against phase_teacher_forced6's
    plain path and witness (`refs`); K6 at T 1, 2, 4 against its plain
    version; tokens/s beside the plain engine's."""
    from repro_torch.kernels.fused_decode import (rwkv6_block_decode,
                                                  rwkv6_model_decode)
    from repro_torch.kernels.fused_prefill import dpot_w8_matmul
    from repro_torch.kernels.wkv6 import wkv6_seq
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.plan import draft_path
    plan = engine.plan
    model, V = plan.model, plan.model.cfg.vocab
    depth = model.cfg.n_layers // 2           # 16 of rwkv6-7b's 32
    drafter = {"model": rwkv6_model_decode, "block": rwkv6_block_decode}[
        draft_path(plan.decode_desc.name, depth)].__name__
    prompts = _engine_prompts(V)[:4]
    counters = (dpot_w8_matmul, wkv6_seq, rwkv6_model_decode,
                rwkv6_block_decode)
    base, p_snap, p_s, _, _ = _serve(engine, prompts, 16)
    t0 = time.perf_counter()
    eng = ServingEngine(model, plan=_replan(plan, k=4, depth=depth),
                        max_batch=8, device=DEV)
    _sync()
    prep_s = time.perf_counter() - t0
    guard = _snapshot_guard(eng)
    got, snap, secs, launches, _ = _serve(eng, prompts, 16,
                                          counters=counters)
    sched = eng.scheduler
    sched.verify_fn, sched.draft_fn = eng.plan.verify_fn(8), \
        eng.plan.draft_fn(8)
    real = _stub_drafter(eng, got, "reject")
    rej, _, _, _, _ = _serve(eng, prompts, 16)
    sched.draft_fn = real
    tc = dict(eng.trace_counts)
    k7_draft = _drafter6(engine, eng, flush)
    tf, _, bounds = _verify_teacher_forced(engine, (4,), refs)
    tf_ok = tf[4]["within_bound"]
    k6w = _k6_windows(flush)
    ok = (rej == got and tc == _spec_counts(4) and guard["intact"] and tf_ok
          and guard["checks"] > 0
          and snap["drafted_tokens"] == snap["accepted_tokens"]
          + snap["rejected_tokens"] and snap["decode_tokens"] == 64
          and all(launches[n] > 0 for n in ("dpot_w8_matmul", "wkv6_seq",
                                            drafter)))
    _line({"phase": "speculative6", "arch": model.cfg.name, "planes": "W8",
           "decode": plan.decode_desc.name, "k": 4, "draft_depth": depth,
           "drafter_kernel": drafter,
           "requests": 4, "new_tokens": 16, "draft_prepare_s": prep_s,
           "identity_a_reject": rej == got, "trace_counts": tc,
           "snapshot": guard, "launches": launches, "ticks": snap["ticks"],
           "drafted": snap["drafted_tokens"],
           "accepted": snap["accepted_tokens"],
           "rejected": snap["rejected_tokens"],
           "acceptance_rate": snap["acceptance_rate"],
           "tokens_per_s": snap["decode_tokens"] / secs,
           "plain_engine_tokens_per_s": p_snap["decode_tokens"] / p_s,
           "equals_plain_engine": got == base,
           "identity_c": tf, "identity_c_bounds": bounds,
           "logits_to_host_ms": _logits_to_host_ms(8, 4, V), "ok": ok})
    if not ok:
        raise AssertionError(f"rwkv6 speculative: reject stub equal "
                             f"{rej == got}, trace_counts {tc}, snapshot "
                             f"{guard}, launches {launches}, identity (c) "
                             f"{tf_ok}")
    return {"speculative6": launches}, k6w, k7_draft


# the order of a phase row's dimensions in a `kernels` entry's shapes
# --- the SLO layer, crash-safe snapshots and fault drills ------------------------

_CARD: list = []


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    if not _CARD:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True)
        _CARD.append(smi.stdout.strip().splitlines()[0])
    return _CARD[0]


def _mixed_model_kw() -> dict:
    """The arguments of main's rwkv4-169m MIXED model-path engine (the
    SIGKILL drill's child builds the same engine from them)."""
    from repro_torch.core.quant.policy import PlanePolicy
    return dict(smoke=False, quantized=True, fused_prefill=True, max_batch=8,
                prefill_chunk=16, seed=SEED, device=DEV, fused_decode="model",
                plane_policy=PlanePolicy(default="w8",
                                         overrides=MIXED_OVERRIDES))


def _drill_counters():
    """The launch counters of the MIXED model path: K5, K5-W4, K5-VQ, K2
    and K4."""
    from repro_torch.kernels.fused_decode import rwkv4_model_decode
    from repro_torch.kernels.fused_prefill import (
        dpot_w4_matmul, dpot_w8_matmul, vq_matmul)
    from repro_torch.kernels.wkv4 import wkv4_seq
    return (dpot_w8_matmul, dpot_w4_matmul, vq_matmul, wkv4_seq,
            rwkv4_model_decode)


def _counted_run(counters, fn):
    """fn() with every counter set to 0 just before and read just after:
    (fn's result, the counts)."""
    for c in counters:
        c.launches = 0
    out = fn()
    _sync()
    return out, {c.__name__: c.launches for c in counters}


def _drill_traffic(engine, prompts, n_new=32):
    """Submit `prompts` × `n_new` tokens: even requests greedy, odd ones
    sampled at 0.8 from their own seeds (a resume must restore their
    generators mid-stream)."""
    return [engine.submit(p, max_new_tokens=n_new,
                          temperature=0.8 if i % 2 else 0.0,
                          seed=SEED + 100 + i)
            for i, p in enumerate(prompts)]


def _oracle_streams(engine, prompts, warm=None):
    """The streams of a run that never crashes (a warm-up first)."""
    if warm is not None:
        engine.submit(warm, max_new_tokens=32)
        engine.run()
    hs = _drill_traffic(engine, prompts)
    engine.run()
    _sync()
    return [h.tokens for h in hs]


def _build_dir() -> Path:
    """The checkout's `build/` (gitignored), where the drills' snapshot
    directories go."""
    d = Path(__file__).resolve().parent / "build"
    d.mkdir(exist_ok=True)
    return d


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def _restore_and_drain(directory, hs, counters, **kw):
    """ServingEngine.restore(directory) (timed), then drain it with the
    counters set to 0 just before: (every request's stream — a restored
    handle's resumed + tokens, else the pre-crash handle's —, the
    restored engine, restore seconds, the drain's launches)."""
    from repro_torch.serving import ServingEngine
    _sync()
    t0 = time.perf_counter()
    restored = ServingEngine.restore(str(directory), snapshot=None, **kw)
    _sync()
    restore_s = time.perf_counter() - t0
    handles, tick = restored.handles, restored.scheduler._tick_no
    _, launches = _counted_run(counters, restored.run)
    streams = [handles[h.rid].resumed + handles[h.rid].tokens
               if h.rid in handles else h.tokens for h in hs]
    return streams, restored, restore_s, launches, tick


def _k4_k5(launches) -> bool:
    """K4 and one of K5 / K5-W4 launched."""
    return launches["rwkv4_model_decode"] > 0 and (
        launches["dpot_w8_matmul"] + launches["dpot_w4_matmul"]) > 0


def _crash_drill(name, make_engine, prompts, oracle, directory, crash,
                 counters, warm=None, **restore_kw):
    """One in-process crash drill: an engine (`make_engine(fault_injector=,
    snapshot=)`) serves `prompts` (after `warm`, served to completion)
    with a snapshot every 2 ticks and raises EngineCrash at the top of the
    `crash`-th tick of that traffic; `ServingEngine.restore` rebuilds it
    from the newest committed snapshot and drains it.  Every stream must
    equal `oracle` bit for bit, and K4 and K5 must launch both before the
    crash and after the restore.  Returns the drill's record."""
    from repro_torch.runtime.monitor import (EngineCrash,
                                             ServingFaultInjector)
    from repro_torch.serving import EngineSnapshot, SnapshotConfig
    inj = ServingFaultInjector()
    eng = make_engine(fault_injector=inj,
                      snapshot=SnapshotConfig(str(directory), every=2))
    if warm is not None:
        eng.submit(warm, max_new_tokens=32)
        eng.run()
    crash += eng.scheduler._tick_no
    inj.schedule[crash] = [("crash_at_tick", None)]
    hs = _drill_traffic(eng, prompts)
    crashed = False

    def serve():
        nonlocal crashed
        try:
            eng.run()
        except EngineCrash:
            crashed = True
    _, before = _counted_run(counters, serve)
    eng.snapshot_manager.wait()
    save_s = list(eng.counters.snapshot_wall_s)
    # the capture alone (a save also joins the previous background write)
    _sync()
    t0 = time.perf_counter()
    EngineSnapshot.capture(eng, eng.scheduler._tick_no)
    capture_s = time.perf_counter() - t0
    streams, restored, restore_s, after, tick = _restore_and_drain(
        directory, hs, counters, **restore_kw)
    ok = (crashed and streams == oracle
          and restored.counters.restores == 1
          and restored.pool.n_free == restored.pool.max_slots
          and _k4_k5(before) and _k4_k5(after))
    rec = {"drill": name, "crash_tick": crash, "restored_at_tick": tick,
           "resumed_lanes": restored.counters.resumed_lanes,
           "streams_bit_equal": streams == oracle,
           "first_diff": _first_diff(streams, oracle),
           "launches_before_crash": before, "launches_after_restore": after,
           "snapshots_written": len(save_s),
           "snapshot_save_s": {"mean": sum(save_s) / max(len(save_s), 1),
                               "max": max(save_s, default=0.0)},
           "capture_s": capture_s,
           "snapshot_bytes": _dir_bytes(Path(directory)),
           "restore_s": restore_s, "ok": ok}
    del restored, eng
    return rec


def _crash_child(directory: str, tick: int) -> int:
    """The SIGKILL drill's child process: main's MIXED model-path engine,
    snapshots every 2 ticks into `directory`, phase_engine's traffic, and
    `crash_at_tick` "sigkill" at the top of tick `tick`.  Returns only if
    the kill did not fire."""
    from repro_torch.runtime.monitor import ServingFaultInjector
    from repro_torch.serving import ServingEngine, SnapshotConfig
    inj = ServingFaultInjector(schedule={tick: [("crash_at_tick",
                                                 "sigkill")]})
    eng = ServingEngine("rwkv4-169m", **_mixed_model_kw(), fault_injector=inj,
                        snapshot=SnapshotConfig(directory, every=2))
    _drill_traffic(eng, _engine_prompts(eng.model.cfg.vocab))
    eng.run()
    return 3


def phase_crash_resume(engine):
    """Crash-safe serving on rwkv4-169m's MIXED model path at full width
    (K4 every decode tick; K5, K5-W4, K5-VQ and K2 every prefill chunk;
    8 slots, chunk 16), phase_engine's 8 requests × 32 tokens, even ones
    greedy, odd ones sampled at 0.8.  Four drills, each against the
    streams of a run that never crashed, bit for bit:
      in-process    snapshots every 2 ticks, EngineCrash at the top of
                    tick 3 (mid-prefill), ServingEngine.restore (the plan
                    rebuilt from the seed, its checksums verified), drain;
      speculative   the same with k 2 (the drafter K4 on 6 layers, K5 + K2
                    verifying), crash at tick 9;
      prefix cache  a warm-up request, then 8 requests sharing a 64-token
                    prefix, crash 3 ticks into them: the cache comes back
                    from the snapshot and the streams are the cached run's;
      SIGKILL       a child process (this script, `--crash-child`) builds
                    the same engine, serves the same traffic and is
                    SIGKILLed by `crash_at_tick` "sigkill" at tick 17; its
                    output is kept out of this script's; the parent
                    restores the directory it left.
    Each drill's line: K4 / K5 / K2 launches before the crash and after
    the restore, the snapshot save time (the synchronous part: a capture
    and the join of the previous background write) and one capture
    alone, the bytes on disk, the restore time; the phase line adds the
    weights' checksum time and the card.  Returns the launches by
    drill."""
    import tempfile
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.snapshot import param_checksums
    plan = engine.plan
    V = plan.model.cfg.vocab
    prompts = _engine_prompts(V)
    counters = _drill_counters()
    root = Path(tempfile.mkdtemp(prefix="crash_resume_", dir=_build_dir()))
    t0 = time.perf_counter()
    param_checksums(plan.prepared)
    checksum_s = time.perf_counter() - t0
    oracle = _oracle_streams(ServingEngine(plan.model, plan=plan,
                                           max_batch=8, device=DEV), prompts)

    def on(p):
        return lambda **kw: ServingEngine(p.model, plan=p, max_batch=8,
                                          device=DEV, **kw)
    drills = [_crash_drill("in-process", on(plan), prompts, oracle,
                           root / "inproc", 3, counters)]
    depth = max(1, plan.model.cfg.n_layers // 2)     # 6 of 12
    spec = _replan(plan, k=2, depth=depth)
    spec.build_config = {**plan.build_config, "speculative": 2,
                         "draft_depth": depth}
    s_oracle = _oracle_streams(on(spec)(), prompts)
    drills.append(_crash_drill("speculative", on(spec), prompts, s_oracle,
                               root / "spec", 9, counters))
    del spec
    prefix, warm, c_prompts = _prefix_traffic(V, 64, SEED + 30)
    cached = lambda **kw: on(plan)(prefix_cache=True, **kw)
    c_oracle = _oracle_streams(cached(), c_prompts, warm=warm)
    drills.append(_crash_drill("prefix cache", cached, c_prompts, c_oracle,
                               root / "cache", 3, counters, warm=warm))
    # SIGKILL: the kernels are built, so the child only loads them
    kill_dir = root / "sigkill"
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--crash-child",
         str(kill_dir), "17"], capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    from repro_torch.serving import load_snapshot
    step, _ = load_snapshot(str(kill_dir))
    # every request is still in flight at ticks 14-16 (32 new tokens
    # each), so the restored handles hold every stream
    hs = [types.SimpleNamespace(rid=i, tokens=[]) for i in range(8)]
    streams, restored, restore_s, after, _ = _restore_and_drain(
        kill_dir, hs, counters)
    # the kill may tear tick 16's write (its thread still writing): the
    # restore then takes tick 14's, as a torn write must
    kill_ok = (child.returncode == -9 and step in (14, 16)
               and streams == oracle
               and restored.counters.resumed_lanes == 8 and _k4_k5(after))
    drills.append({"drill": "SIGKILL", "crash_tick": 17,
                   "child_returncode": child.returncode,
                   "child_seconds": child_s, "child_stderr_tail":
                   None if kill_ok else child.stderr[-2000:],
                   "restored_step": step,
                   "resumed_lanes": restored.counters.resumed_lanes,
                   "streams_bit_equal": streams == oracle,
                   "first_diff": _first_diff(streams, oracle),
                   "launches_after_restore": after,
                   "snapshot_bytes": _dir_bytes(kill_dir),
                   "restore_s": restore_s, "ok": kill_ok})
    del restored
    shutil.rmtree(root)
    for d in drills:
        _line({"phase": "crash_resume", **d})
    ok = all(d["ok"] for d in drills)
    _line({"phase": "crash_resume", "arch": plan.model.cfg.name,
           "planes": "MIXED", "decode": plan.decode_desc.name,
           "prefill": plan.prefill_desc.name, "slots": 8,
           "chunk": plan.prefill_chunk, "checksum_s": checksum_s,
           "checksummed_planes": len(param_checksums(plan.prepared)),
           "drills_ok": {d["drill"]: d["ok"] for d in drills},
           "card": _card(), "ok": ok})
    if not ok:
        raise AssertionError(
            "crash resume: " + ", ".join(d["drill"] for d in drills
                                         if not d["ok"]) + " failed")
    return {f"crash-{d['drill'].replace(' ', '-').lower()}":
            d["launches_after_restore"] for d in drills}


def phase_faults(engine):
    """The sentinel, the overload policies and deadlines on rwkv4-169m's
    MIXED model path at full width:
      quarantine    sentinel_every 1, `corrupt_state_leaf` on request 3 at
                    tick 4: the lane is quarantined (counted once) and the
                    request replayed; every stream equals the clean run's
                    bit for bit, no slot leaks;
      backpressure  max_queue 4, 12 requests submitted before a tick: 4
                    accepted, 8 refused with Overloaded (no handle left),
                    the 4 finish; backpressured 8;
      shed          max_queue 4, 12 requests of priority i // 4: each
                    more urgent arrival sheds the youngest least urgent
                    queued request: 8 shed, 4 (priority 2) finish;
      deadline      a fake clock; requests 0-3 with a 5 s deadline, 4-7
                    with none; after 4 ticks the clock moves 10 s: 0-3 end
                    "deadline" with their slots freed, 4-7 finish with the
                    clean run's streams bit for bit.
    Each with its K4 / K5 / K2 launches and the counters' outcomes."""
    from repro_torch.runtime.monitor import (ServingCounters,
                                             ServingFaultInjector)
    from repro_torch.serving import (AdmissionPolicy, Overloaded,
                                     ServingEngine, ServingSLO)
    plan = engine.plan
    prompts = _engine_prompts(plan.model.cfg.vocab)
    counters = _drill_counters()
    eng = lambda **kw: ServingEngine(plan.model, plan=plan, max_batch=8,
                                     device=DEV, **kw)
    oracle = _oracle_streams(eng(), prompts)
    recs = {}
    # quarantine and replay
    inj = ServingFaultInjector(schedule={4: [("corrupt_state_leaf", 3)]})
    q = eng(fault_injector=inj, sentinel_every=1)
    hs = _drill_traffic(q, prompts)
    _, launches = _counted_run(counters, q.run)
    streams = [h.tokens for h in hs]
    recs["quarantine"] = {
        "fired": [list(f) for f in inj.fired],
        "quarantined_lanes": q.counters.quarantined_lanes,
        "streams_bit_equal": streams == oracle,
        "first_diff": _first_diff(streams, oracle),
        "replayed_resumed": hs[3].resumed, "launches": launches,
        "ok": (q.counters.quarantined_lanes == 1 and streams == oracle
               and hs[3].resumed == [] and q.pool.n_free == 8
               and min(launches.values()) > 0)}
    # the overload policies: a burst of 12 before the first tick
    for policy in ("backpressure", "shed"):
        o = eng(slo=ServingSLO(admission=AdmissionPolicy(
            max_queue=4, overload=policy)))
        hs, refused = [], 0
        for i in range(12):
            try:
                hs.append(o.submit(prompts[i % 8], max_new_tokens=8,
                                   priority=i // 4 if policy == "shed"
                                   else 0))
            except Overloaded:
                refused += 1
        _, launches = _counted_run(counters, o.run)
        outcomes = {}
        for h in hs:
            outcomes[h.outcome] = outcomes.get(h.outcome, 0) + 1
        snap = o.counters.snapshot()
        want = ({"finished": 4} if policy == "backpressure"
                else {"finished": 4, "shed": 8})
        recs[policy] = {
            "submitted": 12, "refused": refused, "outcomes": outcomes,
            "handles_left": len(o.handles),
            "counters": {k: snap[k] for k in ("finished", "shed",
                                              "backpressured")},
            "launches": launches,
            "ok": (outcomes == want and refused == (
                8 if policy == "backpressure" else 0)
                and snap["backpressured"] == refused
                and snap["shed"] == want.get("shed", 0)
                and snap["finished"] == 4 and not o.handles
                and o.pool.n_free == 8)}
    # deadlines on a fake clock
    clock = types.SimpleNamespace(t=0.0)
    d = eng(counters=ServingCounters(clock=lambda: clock.t))
    hs = [d.submit(p, max_new_tokens=32, temperature=0.8 if i % 2 else 0.0,
                   seed=SEED + 100 + i, deadline_s=5.0 if i < 4 else None)
          for i, p in enumerate(prompts)]

    def run_deadline():
        for _ in range(4):
            d.step()
        clock.t += 10.0
        d.run()
    _, launches = _counted_run(counters, run_deadline)
    snap = d.counters.snapshot()
    recs["deadline"] = {
        "outcomes": [h.outcome for h in hs],
        "counters": {k: snap[k] for k in ("finished", "deadline_evicted")},
        "survivors_bit_equal": [h.tokens for h in hs[4:]] == oracle[4:],
        "launches": launches,
        "ok": ([h.outcome for h in hs] == ["deadline"] * 4 + ["finished"] * 4
               and snap["deadline_evicted"] == 4 and snap["finished"] == 4
               and [h.tokens for h in hs[4:]] == oracle[4:]
               and d.pool.n_free == 8)}
    for name, rec in recs.items():
        _line({"phase": "faults", "drill": name, **rec})
    ok = all(r["ok"] for r in recs.values())
    _line({"phase": "faults", "arch": plan.model.cfg.name, "planes": "MIXED",
           "drills_ok": {k: r["ok"] for k, r in recs.items()},
           "card": _card(), "ok": ok})
    if not ok:
        raise AssertionError("fault drills: " + ", ".join(
            k for k, r in recs.items() if not r["ok"]) + " failed")
    return {"quarantine": recs["quarantine"]["launches"]}


def phase_restore_trained(model, restored):
    """Crash and restore with given weights: phase 9's trained and
    checkpoint-restored rwkv4-169m tree served through
    ServingEngine(params=, quantized=True, fused_decode="model",
    fused_prefill=True) (`build_config["from_seed"]` False), an
    EngineCrash at tick 5, then: restore without params= raises
    ValueError, with the seed's weights IntegrityError, with the trained
    tree the streams of a run that never crashed, bit for bit."""
    import tempfile
    from repro_torch.serving import IntegrityError, ServingEngine
    d = Path(tempfile.mkdtemp(prefix="restore_trained_", dir=_build_dir()))
    engine = ServingEngine(model, params=restored, quantized=True,
                           fused_decode="model", fused_prefill=True,
                           max_batch=8, prefill_chunk=16, device=DEV)
    plan = engine.plan
    prompts = _engine_prompts(model.cfg.vocab)
    oracle = _oracle_streams(engine, prompts)
    counters = _drill_counters()
    make = lambda **kw: ServingEngine(model, plan=plan, max_batch=8,
                                      device=DEV, **kw)
    refusals = {}
    try:
        ServingEngine.restore(str(d))
    except FileNotFoundError:
        refusals["empty"] = "FileNotFoundError"
    rec = _crash_drill("given weights", make, prompts, oracle, d, 5,
                       counters, params=restored)
    try:
        ServingEngine.restore(str(d))
    except ValueError as e:
        refusals["no params"] = type(e).__name__
    try:
        ServingEngine.restore(str(d), params=model.init_params(SEED, DEV))
    except IntegrityError as e:
        refusals["seed weights"] = type(e).__name__
    _release()
    shutil.rmtree(d)
    ok = rec["ok"] and refusals == {"empty": "FileNotFoundError",
                                    "no params": "ValueError",
                                    "seed weights": "IntegrityError"}
    _line({"phase": "restore_trained", **rec,
           "from_seed": plan.build_config["from_seed"],
           "refusals": refusals, "card": _card(), "ok": ok})
    if not ok:
        raise AssertionError(f"restore with given weights: {rec}, "
                             f"{refusals}")
    return rec["launches_after_restore"]


# ---------------------------------------------------------------------------
# The training drill and the analysis tools: phase_train_drill, the decode
# ticks of phase_split (the other readings sit in the phases that build
# their models), phase_dryrun
# ---------------------------------------------------------------------------

DRILL_STEPS, DRILL_EVERY = 100, 10
DRILL_LOG = ["failure at step {fail}: hosts [3]",
             "restored, resuming at step {back}"]


def _example(name: str):
    """The example module examples/<name>.py, loaded by path."""
    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_train_drill():
    """The example's drill (`examples/train_rwkv4_torch.py --drill`) on
    the card: rwkv4-mini (L6 D384 F1536 V8192, f32, no remat), B 16, S
    128, DRILL_STEPS steps driven by `TrainingSupervisor`, a checkpoint
    every DRILL_EVERY, a `HostFailure` at 60% of the run, the restore from
    `latest_step` (a fresh optimizer).  Checks: the restored params equal
    the committed checkpoint bit for bit; one restart and JAX's log
    strings; K2, K2-bwd, K11, K11-bwd, K12 and K12-bwd launched per step
    as the model needs, for every step run (counters set to 0 just before
    the supervised run, read just after); finite losses, the last below
    the first; and `train_model` resumed from the restored checkpoint
    ends on the supervised run's params bit for bit.  Both runs take
    the example's `deterministic()` (torch.use_deterministic_algorithms
    scoped to them: the embedding's gradient accumulates by atomics
    otherwise); the same resume once more without it reads whether the
    card needs it (not a check).  Returns the path's launches."""
    from repro_torch.kernels.fused_ce import (
        fused_cross_entropy, fused_cross_entropy_bwd)
    from repro_torch.kernels.fused_layernorm import (
        fused_layernorm, fused_layernorm_bwd)
    from repro_torch.kernels.wkv4 import wkv4_seq, wkv4_seq_bwd
    ex = _example("train_rwkv4_torch")
    model = ex.get_model(ex.CFG_100M)
    L = model.cfg.n_layers
    d = _build_dir() / "train_drill"
    shutil.rmtree(d, ignore_errors=True)
    kw = dict(steps=DRILL_STEPS, batch=16, seq=128, ckpt_dir=d,
              ckpt_every=DRILL_EVERY, device=DEV)
    counters = (wkv4_seq, wkv4_seq_bwd, fused_layernorm, fused_layernorm_bwd,
                fused_cross_entropy, fused_cross_entropy_bwd)
    per_step = {"wkv4_seq": L, "wkv4_seq_bwd": L,
                "fused_layernorm": 2 * L + 2,
                "fused_layernorm_bwd": 2 * L + 2,
                "fused_cross_entropy": 1, "fused_cross_entropy_bwd": 1}
    with ex.deterministic():
        for c in counters:
            c.launches = 0
        drill = ex.run_drill(model, **kw)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        shutil.copytree(d / "resume", d / "free" / "resume")
        t0 = time.perf_counter()
        resumed = ex.resume_run(model, **kw)
        resume_s = time.perf_counter() - t0
        same = ex.tree_bits_equal(resumed["params"], drill["params"])
    free = ex.resume_run(model, **{**kw, "ckpt_dir": d / "free"})
    same_free = ex.tree_bits_equal(free["params"], drill["params"])
    shutil.rmtree(d)
    losses = drill["losses"]
    want_log = [DRILL_LOG[0].format(fail=drill["fail_at"]),
                DRILL_LOG[1].format(back=drill["restored_step"])]
    want = {n: c * len(losses) for n, c in per_step.items()}
    row = {"phase": "train_drill", "model": model.cfg.name, "B": 16,
           "S": 128, "steps": DRILL_STEPS, "steps_run": len(losses),
           "fail_at": drill["fail_at"],
           "restored_step": drill["restored_step"],
           "restored_bits_equal": drill["restored_equal"],
           "restarts": drill["restarts"], "log": drill["log"],
           "launches": launches, "first_loss": losses[0],
           "last_loss": losses[-1], "seconds": drill["seconds"],
           "resume_seconds": resume_s,
           "resumed_bits_equal": same,
           "resumed_bits_equal_without_deterministic": same_free}
    _line(row)
    bad = []
    if drill["restored_equal"] is not True:
        bad.append("restored params differ from the checkpoint")
    if drill["restarts"] != 1 or drill["log"] != want_log:
        bad.append(f"log {drill['log']} (want {want_log})")
    if launches != want:
        bad.append(f"launches {launches} (want {want})")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        bad.append(f"losses {losses[0]} -> {losses[-1]}")
    if not same:
        bad.append("train_model resumed differs from the supervised run")
    if bad:
        raise AssertionError(f"train drill: {bad}")
    return {"train-drill": launches}


def phase_decode_tick(engine, label):
    """phase_split's first reading: one decode tick of `engine`'s path.  A
    fresh engine on the same prepared weights (its own programs, no
    prefix cache) takes 8 requests (8-token prompts, 24 new tokens); once
    every request holds its first token the ticks decode, and `_reading`
    splits one (after a warm tick) and counts one more.  The engine is
    then drained."""
    from repro_torch.serving import ServingEngine
    plan = engine.plan
    eng = ServingEngine(plan.model, plan=_replan(plan), max_batch=8,
                        device=DEV)
    V = plan.model.cfg.vocab
    g = torch.Generator().manual_seed(SEED + 91)
    handles = [eng.submit(torch.randint(0, V, (8,), generator=g).tolist(),
                          max_new_tokens=24) for _ in range(8)]
    while not all(h.tokens for h in handles):
        eng.step()
    row = _reading(f"decode tick {label}", eng.step)
    eng.run()
    if not all(len(h.tokens) == 24 for h in handles):
        raise AssertionError(f"decode tick {label}: streams cut short")
    return row


def _start_dryrun(src: Path):
    """phase_dryrun's count, started as a child process beside the card's
    phases: `python -m repro_torch.launch.dryrun --rwkv4` (every cell of
    ASSIGNED_ARCHS and RWKV4_ARCHS x SHAPES at full size, on meta
    tensors, on the host only), its output in build/dryrun.log."""
    log = _build_dir() / "dryrun.log"
    env = {**os.environ, "PYTHONPATH": str(src)}
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--rwkv4"],
            stdout=f, stderr=subprocess.STDOUT, env=env,
            cwd=str(src.parent))
    return proc, log


def phase_dryrun(proc, log: Path):
    """Wait for the dry run's child: one line per cell (its bottleneck and
    the three roofline terms, or why it is skipped), and the ok / skip /
    error counts.  Any error cell, or no ok cell, fails the run."""
    rc = proc.wait(timeout=900)
    text = log.read_text()
    cells = [ln for ln in text.splitlines() if ln.startswith("[")]
    for ln in cells:
        _line({"dryrun": ln})
    m = re.search(r"done: (\d+) ok, (\d+) skip, (\d+) error", text)
    counts = dict(zip(("ok", "skip", "error"),
                      map(int, m.groups()))) if m else None
    _line({"phase": "dryrun", "rc": rc, "cells": len(cells),
           "counts": counts})
    if rc != 0 or counts is None or counts["error"] or not counts["ok"]:
        raise AssertionError(f"dry run: rc {rc}, counts {counts}:\n"
                             + text[-3000:])
    return counts


_SHAPE_KEYS = ("M", "K", "N", "L", "B", "T", "C", "D", "F", "H", "S", "KVH",
               "d")


def _kernel_row(name, source, replaces, rows, launches, note=None):
    """One entry of the `kernels` line from a kernel's phase rows: times
    and bounds summed over the shapes, one call each."""
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches["main"],
           "launches_by_path": launches["by_path"],
           "max_abs_err": max(r["max_abs_err"] for r in rows),
           "ms": sum(r["kernel_ms"] for r in rows),
           "plain_ms": sum(r["plain_ms"] for r in rows),
           "bound_ms": sum(r["bound_ms"] for r in rows),
           "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
           else "operations",
           "library_ms": None if rows[0]["library_ms"] is None
           else sum(r["library_ms"] for r in rows),
           "shapes": [[r[k] for k in _SHAPE_KEYS if k in r] for r in rows]}
    if note:
        row["note"] = note
    return row


def _timed(name, fn, *args, **kw):
    """Run one phase; print its seconds and the device memory it peaked
    at."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    _line({"phase_done": name, "seconds": time.perf_counter() - t0,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30})
    return out


def _release():
    """Return the device memory of engines the caller has dropped, before
    the next engine draws its weights."""
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    if sys.argv[1:2] == ["--crash-child"]:
        return _crash_child(sys.argv[2], int(sys.argv[3]))
    from repro_torch.core.quant.policy import PLANE_VQ, PLANE_W4, PlanePolicy
    from repro_torch.kernels.fused_decode import (
        rwkv4_block_decode, rwkv4_model_decode, rwkv6_block_decode,
        rwkv6_model_decode)
    from repro_torch.kernels.fused_prefill import (
        dpot_w4_matmul, dpot_w8_matmul, vq_matmul)
    from repro_torch.kernels.wkv4 import wkv4_seq
    from repro_torch.kernels.wkv6 import wkv6_seq
    from repro_torch.core.quant.serving import pack_leaf, unpack_params
    from repro_torch.models.rwkv4 import prepare_fused_model_params
    from repro_torch.serving import ServingEngine
    from repro_torch.tree import keystr

    t_start = time.perf_counter()
    usage = _timed("build", phase_build)
    # the dry run counts on the host, beside the card's phases
    dry_proc, dry_log = _start_dryrun(src)
    atexit.register(lambda: dry_proc.poll() is None and (
        dry_proc.kill(), dry_proc.wait()))
    common = dict(smoke=False, quantized=True, fused_prefill=True,
                  max_batch=8, prefill_chunk=16, seed=SEED, device=DEV)
    # rwkv4-169m: the block path (W8) and the model path (MIXED planes)
    block = ServingEngine("rwkv4-169m", fused_decode="block", **common)
    model = ServingEngine("rwkv4-169m", **_mixed_model_kw())
    cfg = block.model.cfg
    w8, mixed = block.plan.prepared.raw, model.plan.prepared.raw
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=DEV)
    k5 = _timed("K5", phase_k5, w8, cfg, flush)
    k5p = _timed("K5-W4, K5-VQ", phase_k5_planes, mixed, cfg, flush)
    k2 = _timed("K2", phase_k2, cfg, flush)
    k3 = _timed("K3", phase_k3, w8, cfg, flush)
    _timed("K3 mixed", phase_k3, mixed, cfg, flush, planes="mixed")
    k4 = _timed("K4", phase_k4, model, flush)
    _timed("prefill chunk block", phase_prefill_chunk, block, "rwkv4-169m W8",
           flush)
    _timed("prefill chunk model", phase_prefill_chunk, model,
           "rwkv4-169m MIXED", flush)
    by_path = {
        "block": _timed("engine block", phase_engine, block,
                        (dpot_w8_matmul, wkv4_seq, rwkv4_block_decode),
                        "block"),
        "model": _timed("engine model", phase_engine, model,
                        (dpot_w8_matmul, dpot_w4_matmul, vq_matmul, wkv4_seq,
                         rwkv4_model_decode), "model")}
    _timed("teacher forced block", phase_teacher_forced, block)
    _timed("teacher forced model", phase_teacher_forced, model)
    paths, head4 = _timed("all logits rwkv4-169m", phase_all_logits, block,
                          "rwkv4-169m W8", flush)
    by_path.update(paths)
    # the prefix cache and self-speculative decode on the MIXED model path
    by_path.update(_timed("prefix cache rwkv4-169m", phase_prefix_cache,
                          model, block))
    paths, k2w, head_w, k4d = _timed("speculative rwkv4-169m",
                                     phase_speculative, model, flush)
    by_path.update(paths)
    # crash-safe snapshots, the sentinel and the SLO layer on the same path
    by_path.update(_timed("crash resume rwkv4-169m", phase_crash_resume,
                          model))
    by_path.update(_timed("fault drills rwkv4-169m", phase_faults, model))
    _timed("split decode tick rwkv4-169m", phase_decode_tick, model,
           "rwkv4-169m MIXED model")
    # rwkv4-169m on plain bf16 weights (quantized=False): K3 and K4 on bf16
    # matrices, the model-path engine, one block-path step
    plain4 = ServingEngine("rwkv4-169m", fused_decode="model",
                           **{**common, "quantized": False})
    bf4 = plain4.plan.prepared.raw
    k3bf = _timed("K3 bf16", phase_k3, bf4, cfg, flush, planes="bf16")
    k4bf = _timed("K4 bf16", phase_k4, plain4, flush, planes="bf16")
    by_path["rwkv4-bf16-model"] = _timed(
        "engine rwkv4-bf16-model", phase_engine, plain4,
        (wkv4_seq, rwkv4_model_decode), "rwkv4-bf16-model")
    by_path["rwkv4-bf16-block"] = _timed(
        "step rwkv4-bf16-block", phase_path_step, plain4.model, bf4, "block",
        (rwkv4_block_decode,), "rwkv4-bf16-block")
    del plain4, bf4
    # the paper's hardware numerics on rwkv4-169m, W8 weights
    k9 = _timed("K9", phase_k9, flush)
    k2h = _timed("K2-hw", phase_k2_hw, cfg, flush)
    # rwkv4-169m packed all W4 and all VQ: K5-W4's and K5-VQ's f32-x forms
    # (att.wo under hw), alone and in prefill_chunk(hw=True)
    packed4 = {plane: block.model.init_params(
        SEED, DEV, leaf_fn=lambda p, t, pol=pol: pack_leaf(keystr(p), t, pol))
        for plane, pol in (("w4", PLANE_W4), ("vq", PLANE_VQ))}
    k5f = _timed("K5 f32-x", phase_k5_f32x, {"w8": w8, **packed4}, cfg,
                 flush, usage)
    by_path.update(_timed("hw prefill W4, VQ", phase_hw_prefill_planes,
                          block.model, packed4))
    del packed4
    k3h = _timed("K3-hw", phase_k3_hw, w8, cfg, flush)
    hw_prep = prepare_fused_model_params(w8, cfg, hw=True)
    k4h = _timed("K4-hw", phase_k4_hw, hw_prep["blocks"], cfg, flush)
    by_path.update(_timed("hw greedy", phase_hw_greedy, w8, hw_prep,
                          block.model))
    _timed("hw teacher forced", phase_hw_teacher_forced, w8, block.model)
    # the quantized serve step at decode_32k's batch, serve_legacy's
    # fake-quantized decode; rwkv4 MIXED's W4 leaves kept for K8
    by_path["rwkv4-quantized-step"] = _timed(
        "quantized step rwkv4-169m", phase_quantized_step, block.model, w8,
        128, "rwkv4-169m")
    by_path["serve-legacy-quantized"] = _timed(
        "serve_legacy quantized", phase_serve_legacy_quantized)
    # an f32 pool on the per-op path, and greedy_decode's sampling
    _timed("state dtype", phase_state_dtype)
    _timed("greedy sample", phase_greedy_sample, unpack_params(w8),
           block.model)
    w4_rwkv4 = {
        "rwkv4-169m att.wk (MIXED W4)": {
            "packed4": mixed["blocks"]["att"]["wk"]["packed4"][0].clone(),
            "scale": mixed["blocks"]["att"]["wk"]["scale"].clone()},
        "rwkv4-169m head (MIXED W4)": {
            k: v.clone() for k, v in mixed["head"].items()}}
    del block, model, w8, mixed, hw_prep
    _release()

    # rwkv6-7b at full width and depth, W8: one engine at a time; the plain
    # path and the f32 witness are computed once and kept for both paths
    refs6 = {}
    eng6 = _timed("rwkv6 block engine", ServingEngine, "rwkv6-7b",
                  fused_decode="block", **common)
    cfg6 = eng6.model.cfg
    k5_6 = _timed("K5 rwkv6", phase_k5, eng6.plan.prepared.raw, cfg6, flush,
                  wide=True)
    _timed("prefill chunk rwkv6", phase_prefill_chunk, eng6, "rwkv6-7b W8",
           flush)
    k6 = _timed("K6", phase_k6, flush)
    k7b = _timed("K7-block", phase_k7_block, eng6, flush, usage)
    by_path["rwkv6-block"] = _timed(
        "engine rwkv6-block", phase_engine, eng6,
        (dpot_w8_matmul, wkv6_seq, rwkv6_block_decode), "rwkv6-block")
    _timed("teacher forced rwkv6-block", phase_teacher_forced6, eng6, refs6)
    del eng6
    _release()
    eng6 = _timed("rwkv6 model engine", ServingEngine, "rwkv6-7b",
                  fused_decode="model", **common)
    k7m = _timed("K7-model", phase_k7_model, eng6, flush, usage)
    del flush
    by_path["rwkv6-model"] = _timed(
        "engine rwkv6-model", phase_engine, eng6,
        (dpot_w8_matmul, wkv6_seq, rwkv6_model_decode), "rwkv6-model")
    _timed("teacher forced rwkv6-model", phase_teacher_forced6, eng6, refs6)
    # the all-position head and the depth-truncated model on its tree
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=DEV)
    paths, head6 = _timed("all logits rwkv6-7b", phase_all_logits, eng6,
                          "rwkv6-7b W8", flush)
    by_path.update(paths)
    del flush
    by_path.update(_timed("truncated rwkv6-7b", phase_truncated6, eng6))
    by_path.update(_timed("prefix cache rwkv6-7b", phase_prefix_cache6, eng6))
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=DEV)
    paths, k6w, k7d = _timed("speculative rwkv6-7b", phase_speculative6,
                             eng6, flush, refs6)
    by_path.update(paths)
    del flush
    _timed("split decode tick rwkv6-7b", phase_decode_tick, eng6,
           "rwkv6-7b W8 model")
    # the engine's packed W8 tree outlives the engine: K1 and K8 through
    # kernels/ops.py on its matrices, then the quantized serve step on it
    raw6, model6 = eng6.plan.prepared.raw, eng6.model
    del eng6
    _release()
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=DEV)
    k1k8, by_path["ops"] = _timed("K1, K8", phase_k1_k8, raw6, w4_rwkv4,
                                  flush, usage)
    del flush, w4_rwkv4
    _release()
    by_path["rwkv6-quantized-step"] = _timed(
        "quantized step rwkv6-7b", phase_quantized_step, model6, raw6, 128,
        "rwkv6-7b")
    del raw6, model6
    _release()
    # rwkv6-7b on the paper's mixed planes (W4 att.wk and head, VQ ffn.wv):
    # the model-path engine, K7 on its tree (block and model), its
    # teacher-forced logits, one block-path step
    mixed6 = _timed("rwkv6 MIXED engine", ServingEngine, "rwkv6-7b",
                    fused_decode="model",
                    plane_policy=PlanePolicy(default="w8",
                                             overrides=MIXED_OVERRIDES),
                    **common)
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=DEV)
    k5p6 = _timed("K5-W4, K5-VQ rwkv6", phase_k5_planes,
                  mixed6.plan.prepared.raw, mixed6.model.cfg, flush,
                  wide=True)
    k7mx = _timed("K7 MIXED", phase_k7_form, mixed6.model,
                  mixed6.plan.prepared.raw,
                  mixed6.plan.prepared.decode["blocks"], flush, "mixed")
    del flush
    by_path["rwkv6-mixed-model"] = _timed(
        "engine rwkv6-mixed-model", phase_engine, mixed6,
        (dpot_w8_matmul, dpot_w4_matmul, vq_matmul, wkv6_seq,
         rwkv6_model_decode), "rwkv6-mixed-model")
    _timed("teacher forced rwkv6-mixed-model", phase_teacher_forced6_plain,
           mixed6)
    by_path["rwkv6-mixed-block"] = _timed(
        "step rwkv6-mixed-block", phase_path_step, mixed6.model,
        mixed6.plan.prepared.raw, "block", (rwkv6_block_decode,),
        "rwkv6-mixed-block")
    del mixed6
    _release()

    # the RWKV whole-sequence forward: K11 and K10, then rwkv4-169m (exact
    # and hw) and rwkv6-7b, each on bf16 weights drawn on the card
    from repro_torch.models.registry import get_model
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=DEV)
    k11 = _timed("K11", phase_k11, flush)
    m4 = get_model("rwkv4-169m")
    p4 = m4.cast_params(m4.init_params(SEED, DEV))
    k2_fwd = {}
    for hw in (False, True):
        paths, k2_fwd[hw] = _timed(
            "forward rwkv4-169m" + (" hw" if hw else ""),
            phase_rwkv4_forward, m4, p4, hw, flush)
        by_path.update(paths)
    del p4
    _release()
    m6 = get_model("rwkv6-7b")
    p6 = _timed("rwkv6 bf16 weights", m6.init_params, SEED, DEV,
                torch.bfloat16)
    toks6 = torch.randint(0, m6.cfg.vocab, (1, 32768), device=DEV,
                          generator=torch.Generator(device=DEV).manual_seed(
                              SEED + 82))
    k7bf, paths = _timed("K7 bf16", phase_k7_bf16, m6, p6, flush)
    by_path.update(paths)
    _release()
    k10 = _timed("K10", phase_k10, flush,
                 _rwkv6_layer0_operands(m6, p6, toks6))
    del flush
    _release()
    paths, k6_fwd = _timed("forward rwkv6-7b", phase_rwkv6_forward, m6, p6,
                           toks6)
    by_path.update(paths)
    del p6, toks6
    _release()

    # smollm-135m at full width and depth: K13, the prefill step through
    # it, and the KV-cache decode
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=DEV)
    k13 = _timed("K13", phase_k13, flush, usage)
    del flush
    smollm = _smollm(False)
    params = smollm.cast_params(smollm.init_params(SEED, DEV))
    by_path.update(_timed("prefill smollm-135m", phase_prefill, params))
    _timed("decode smollm-135m", phase_decode, params)
    del params
    _release()
    # smollm-135m's training: K13's backward, then the train step
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=DEV)
    k13b = _timed("K13 backward", phase_k13_bwd, flush, usage)
    del flush
    _release()
    by_path.update(_timed("train smollm-135m", phase_train))
    # rwkv4-169m's training: K12 and K12-bwd, K2-bwd and K11-bwd on layer
    # 0's operands of the train step, then the train step through them
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=DEV)
    k12 = _timed("K12", phase_k12, flush)
    m4t = _rwkv4_train_model()
    ln1, wkv = _rwkv4_layer0(m4t, m4t.init_params(SEED, DEV),
                             _train_batch(m4t.cfg))
    k2b = _timed("K2-bwd", phase_k2_bwd, wkv, flush)
    k11b = _timed("K11-bwd", phase_k11_bwd, ln1, flush)
    del ln1, wkv, flush
    _release()
    paths, m4t, restored = _timed("train rwkv4-169m", phase_rwkv4_train)
    by_path.update(paths)
    # the trained and restored tree served through the engine
    by_path["serve-trained"] = _timed("serve trained rwkv4-169m",
                                      phase_serve_trained, m4t, restored)
    by_path["restore-trained"] = _timed("restore trained rwkv4-169m",
                                        phase_restore_trained, m4t, restored)
    del restored
    _release()
    # the example's fault-tolerance drill on rwkv4-mini
    by_path.update(_timed("train drill rwkv4-mini", phase_train_drill))
    _release()
    # rwkv6-7b's training at full width, 4 of its 32 layers: K10-bwd and
    # K6-bwd on layer 0's operands of its train steps, then the steps
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=DEV)
    m6t = _rwkv6_train_model()
    cast6 = m6t.cast_params(m6t.init_params(SEED, DEV))
    wkv10, wkv6 = (_rwkv6_layer0_operands(m6t, cast6, _rwkv6_batch(
        m6t.cfg, b, s_)["tokens"]) for b, s_ in (
            (RWKV6_TRAIN_B, RWKV6_TRAIN_S), (RWKV6_SHORT_B, RWKV6_SHORT_S)))
    del cast6
    _release()
    k10b = _timed("K10-bwd", phase_k10_bwd, wkv10, flush)
    k6b = _timed("K6-bwd", phase_k6_bwd, wkv6, flush)
    del wkv10, wkv6, flush
    _release()
    by_path.update(_timed("train rwkv6-7b", phase_rwkv6_train))

    def launches(name, main_path):
        return {"main": by_path[main_path][name],
                "by_path": {p: n.get(name, 0) for p, n in by_path.items()}}
    w4_rows = [r for r in k5p if r["kernel"] == "dpot_w4_matmul"]
    vq_rows = [r for r in k5p if r["kernel"] == "vq_matmul"]
    summed = "times and bounds summed over the shapes, one call each"
    k5_row = _kernel_row(
        "dpot_w8_matmul", "src/repro_torch/csrc/chunk_matmul.cu",
        "src/repro/kernels/fused_prefill.py:84", k5,
        launches("dpot_w8_matmul", "block"), summed + ", rwkv4-169m")
    k5_row["rwkv6_7b"] = {
        k: v for k, v in _kernel_row(
            "dpot_w8_matmul", "", "", k5_6,
            launches("dpot_w8_matmul", "rwkv6-block")).items()
        if k in ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err",
                 "shapes")}
    # the head alone at M 128, the shape of prefill_chunk_logits' head
    k5_row["all_logits_head"] = {"rwkv4-169m": head4, "rwkv6-7b": head6}
    # K5-W4 and K5-VQ at rwkv6-7b's MIXED shapes, beside their rwkv4 rows
    planes_rows = []
    for name, rows in (("dpot_w4_matmul", w4_rows), ("vq_matmul", vq_rows)):
        entry = _kernel_row(name, "src/repro_torch/csrc/chunk_matmul.cu",
                            "src/repro/kernels/fused_prefill.py:" + (
                                "117" if name == "dpot_w4_matmul" else
                                "146"), rows, launches(name, "model"),
                            summed + ", rwkv4-169m")
        entry["rwkv6_7b"] = {
            k: v for k, v in _kernel_row(
                name, "", "", [r for r in k5p6 if r["kernel"] == name],
                launches(name, "rwkv6-mixed-model")).items()
            if k in ("launches", "ms", "plain_ms", "bound_ms", "library_ms",
                     "max_abs_err", "shapes")}
        planes_rows.append(entry)
    # the verify head (MIXED: W4) at M = 8·k, k 1, 2, 4
    planes_rows[0]["verify_head"] = head_w
    kernels = [k5_row, *planes_rows,
        _kernel_row("wkv4_seq", "src/repro_torch/csrc/wkv4_seq.cu",
                    "src/repro/kernels/wkv4.py:101", [k2],
                    launches("wkv4_seq", "block")),
        dict(_kernel_row("rwkv4_block_decode",
                         "src/repro_torch/csrc/rwkv4_block_decode.cu",
                         "src/repro/kernels/fused_decode.py:77", [k3],
                         launches("rwkv4_block_decode", "block")),
             grid=k3["grid"]),
        _kernel_row("rwkv4_model_decode",
                    "src/repro_torch/csrc/rwkv4_model_decode.cu",
                    "src/repro/kernels/fused_decode.py:182", [k4],
                    launches("rwkv4_model_decode", "model")),
        _kernel_row("wkv6_seq", "src/repro_torch/csrc/wkv6_seq.cu",
                    "src/repro/kernels/wkv6.py:141", [k6],
                    launches("wkv6_seq", "rwkv6-block")),
        _kernel_row("rwkv6_block_decode",
                    "src/repro_torch/csrc/rwkv6_block_decode.cu",
                    "src/repro/kernels/fused_decode.py:77", [k7b],
                    launches("rwkv6_block_decode", "rwkv6-block")),
        _kernel_row("rwkv6_model_decode",
                    "src/repro_torch/csrc/rwkv6_model_decode.cu",
                    "src/repro/kernels/fused_decode.py:182", [k7m],
                    launches("rwkv6_model_decode", "rwkv6-model")),
        _kernel_row("expsig", "src/repro_torch/csrc/expsig.cu",
                    "src/repro/kernels/expsig.py:56", k9, {
                        "main": sum(by_path["hw-block"][f] for f in (
                            "exp_kernel", "sigmoid_kernel")),
                        "by_path": {p: n.get("exp_kernel", 0)
                                    + n.get("sigmoid_kernel", 0)
                                    for p, n in by_path.items()}},
                    "K9: exp_kernel (mode 0, expsig.py:71) and "
                    "sigmoid_kernel (mode 1, :77), times summed over the "
                    "two modes at 2^24 f32; on the main path the hw "
                    "prefill's sigma"),
        _kernel_row("wkv4_seq[hw]", "src/repro_torch/csrc/wkv4_seq.cu",
                    "src/repro/kernels/wkv4.py:101", [k2h],
                    launches("wkv4_seq", "hw-block"),
                    "K2 with exp_table/div_table"),
        _kernel_row("dpot_w8_matmul_f32x",
                    "src/repro_torch/csrc/chunk_matmul.cu",
                    "src/repro/kernels/fused_prefill.py:84", k5f[:1],
                    launches("dpot_w8_matmul_f32x", "hw-block"),
                    "K5 with an f32 activation (att.wo under hw)"),
        dict(_kernel_row("rwkv4_block_decode[hw]",
                         "src/repro_torch/csrc/rwkv4_block_decode.cu",
                         "src/repro/kernels/fused_decode.py:77", [k3h],
                         launches("rwkv4_block_decode", "hw-block"),
                         "K3 with the _luts operands"), grid=k3h["grid"]),
        _kernel_row("rwkv4_model_decode[hw]",
                    "src/repro_torch/csrc/rwkv4_model_decode.cu",
                    "src/repro/kernels/fused_decode.py:182", [k4h],
                    launches("rwkv4_model_decode", "hw-model"),
                    "K4 with the _luts operands"),
        _kernel_row("flash_attention",
                    "src/repro_torch/csrc/flash_attention.cu",
                    "src/repro/kernels/flash_attention.py:306", k13[:1],
                    launches("flash_attention", "smollm-prefill"),
                    "K13 forward, timed at smollm-135m's prefill (B8 S2048 "
                    "H9 KVH3 d64, causal, bf16); the other shapes are "
                    "checked only (their lines above)"),
    ]
    k10_row = _kernel_row(
        "wkv6_chunked_kernel", "src/repro_torch/csrc/wkv6_chunked.cu",
        "src/repro/kernels/wkv6.py:74", k10[-1:],
        launches("wkv6_chunked_kernel", "rwkv6-forward"),
        "K10, timed on rwkv6-7b's layer-0 operands at B1 T32768 H64 N64 "
        "(bf16 r, k, v; f32 w); the other shapes are checked only; a "
        "launch counted here is one wrapper call, three CUDA launches")
    k10_row["max_abs_err"] = max(r["max_abs_err"] for r in k10)
    k10_row["shapes"] = [[r[k] for k in ("B", "T", "H", "N")] for r in k10]
    k11_row = _kernel_row(
        "fused_layernorm", "src/repro_torch/csrc/fused_layernorm.cu",
        "src/repro/kernels/fused_layernorm.py:35", k11[:1],
        launches("fused_layernorm", "rwkv6-forward"),
        "K11, timed at (32768, 4096) bf16, rwkv6-7b's forward rows; "
        "library_ms is F.layer_norm on the same rows (two passes)")
    k11_row["max_abs_err"] = max(r["max_abs_err"] for r in k11)
    k11_row["shapes"] = [[r["R"], r["D"]] for r in k11]
    main = k13b[0]
    for which, key, line in (("dq", "flash_attention_dq", 150),
                             ("dkv", "flash_attention_dkv", 172)):
        errs = [r["max_abs_err"][n] for r in k13b
                for n in (("dq",) if which == "dq" else ("dk", "dv"))]
        kernels.append({
            "name": key, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"src/repro/kernels/flash_attention.py:{line}",
            "launches": by_path["smollm-train"][key],
            "launches_by_path": {p: n.get(key, 0)
                                 for p, n in by_path.items()},
            "max_abs_err": max(errs), "ms": main[f"{which}_ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main[f"{which}_bound_ms"],
            "bound_by": main[f"{which}_bound_by"],
            "library_ms": main["library_ms"],
            "shapes": [[r[k] for k in ("B", "S", "H", "KVH", "d")]
                       for r in k13b],
            "note": f"K13-{which}, timed at smollm-135m's train shape (B8 "
                    "S2048 H9 KVH3 d64, causal, bf16); plain_ms is the "
                    "whole plain backward (dq, dk, dv) and library_ms the "
                    "whole SDPA backward less its forward; launches: the "
                    "3-step train run"})
    kernels += [k10_row, k11_row]
    # the training slice's kernels, launches from the 3-step rwkv4 run
    bwd_rows = [{k[4:] if k.startswith("bwd_") else k: v
                 for k, v in r.items() if k.startswith("bwd_")
                 or k in ("N", "V")} for r in k12]
    kernels += [
        _kernel_row("fused_cross_entropy", "src/repro_torch/csrc/fused_ce.cu",
                    "src/repro/kernels/fused_ce.py:136", k12[:1],
                    launches("fused_cross_entropy", "rwkv4-train"),
                    "K12, timed at rwkv4-169m's train rows (8192, 50277) "
                    "bf16; smollm-135m's (16384, 49152) on its line above; "
                    "library_ms is F.cross_entropy(logits.float(), "
                    "reduction='none')"),
        _kernel_row("fused_cross_entropy_bwd",
                    "src/repro_torch/csrc/fused_ce.cu",
                    "src/repro/kernels/fused_ce.py:61", bwd_rows[:1],
                    launches("fused_cross_entropy_bwd", "rwkv4-train"),
                    "K12-bwd, timed as K12; plain_ms and library_ms are "
                    "the autograd backward of the plain version and of "
                    "F.cross_entropy"),
        _kernel_row("wkv4_seq_bwd", "src/repro_torch/csrc/wkv4_bwd.cu",
                    "src/repro/core/wkv/wkv4.py:61", [k2b],
                    launches("wkv4_seq_bwd", "rwkv4-train"),
                    "K2-bwd: no TPU kernel, the backward XLA derives from "
                    "wkv4_scan; timed on rwkv4-169m's layer-0 operands at "
                    "B8 T1024 C768; plain_ms the autograd backward of the "
                    "plain step loop"),
        _kernel_row("fused_layernorm_bwd",
                    "src/repro_torch/csrc/fused_layernorm.cu",
                    "src/repro/models/layers.py:31", [k11b],
                    launches("fused_layernorm_bwd", "rwkv4-train"),
                    "K11-bwd: no TPU kernel, the backward XLA derives from "
                    "apply_norm's LayerNorm; timed on rwkv4-169m's layer-0 "
                    "ln1 operands (8192, 768) bf16; library_ms F.layer_norm's "
                    "autograd backward"),
    ]
    for entry in kernels[-4:-2]:
        entry["shapes"] = [[r["N"], r["V"]] for r in k12]
        entry["max_abs_err"] = max(r["max_abs_err"] for r in (
            k12 if entry["name"] == "fused_cross_entropy" else bwd_rows))
    kernels[-1]["shapes"] = [[k11b["R"], k11b["D"]]]
    # K2 and K6 over the verify windows (T 1, 2, 4), held in the speculative
    # phases: their errors joined, their rows beside
    for entry in kernels:
        rows = {"wkv4_seq": k2w, "wkv6_seq": k6w}.get(entry["name"])
        if rows is not None:
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       *(r["max_abs_err"] for r in rows))
            entry["shapes"] += [[r[k] for k in _SHAPE_KEYS if k in r]
                                for r in rows]
            entry["verify_windows"] = [
                {k: r[k] for k in ("T", "kernel_ms", "plain_ms", "bound_ms",
                                   "bound_by")} for r in rows]
    # K4 and K7-model on the drafters' truncated stacks (L 6 and L 16),
    # held in the speculative phases: their errors joined, their rows beside
    for entry in kernels:
        row = {"rwkv4_model_decode": k4d,
               "rwkv6_model_decode": k7d}.get(entry["name"])
        if row is not None:
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       row["max_abs_err"])
            entry["shapes"].append([row[k] for k in _SHAPE_KEYS if k in row])
            entry["drafter"] = {k: row[k] for k in (
                "L", "kernel_ms", "plain_ms", "bound_ms", "bound_by")}
    # the ninth slice: K1 and K8 through kernels/ops.py
    for name, line in (("dpot_matmul", 68), ("dpot_matmul_w4", 124)):
        kernels.append(_kernel_row(
            name, "src/repro_torch/csrc/chunk_matmul.cu",
            f"src/repro/kernels/dpot_matmul.py:{line}",
            [r for r in k1k8 if r["kernel"] == name], launches(name, "ops"),
            summed + "; the operands in each phase line; library_ms is "
            "torch.matmul of x.float() on the pre-decoded f32 plane"))
    # K2 and K6 as the RWKV forwards call them: checked there, their
    # errors and shapes joined to the entries above, their times beside
    for entry in kernels:
        check = {"wkv4_seq": k2_fwd[False], "wkv4_seq[hw]": k2_fwd[True],
                 "wkv6_seq": k6_fwd}.get(entry["name"])
        if check is not None:
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       check["max_abs_err"])
            entry["shapes"].append([check[k] for k in _SHAPE_KEYS
                                    if k in check])
            entry["forward_check"] = {k: check[k] for k in (
                "what", "kernel_ms", "plain_ms", "bound_ms", "bound_by")
                if k in check}
    # the eleventh slice: the weight forms the earlier rows' kernels now take
    kernels += [
        dict(_kernel_row("rwkv4_block_decode[bf16]",
                         "src/repro_torch/csrc/rwkv4_block_decode.cu",
                         "src/repro/kernels/fused_decode.py:77", [k3bf],
                         launches("rwkv4_block_decode", "rwkv4-bf16-block"),
                         "K3 on plain bf16 weights (quantized=False), "
                         "layer 0"), grid=k3bf["grid"]),
        _kernel_row("rwkv4_model_decode[bf16]",
                    "src/repro_torch/csrc/rwkv4_model_decode.cu",
                    "src/repro/kernels/fused_decode.py:182", [k4bf],
                    launches("rwkv4_model_decode", "rwkv4-bf16-model"),
                    "K4 on plain bf16 weights; the bf16 engine's path"),
        _kernel_row("dpot_w4_matmul_f32x",
                    "src/repro_torch/csrc/chunk_matmul.cu",
                    "src/repro/kernels/fused_prefill.py:117", k5f[1:2],
                    launches("dpot_w4_matmul_f32x", "hw-prefill-w4"),
                    "K5-W4 with an f32 activation (att.wo under hw, "
                    "PLANE_W4)"),
        _kernel_row("vq_matmul_f32x", "src/repro_torch/csrc/chunk_matmul.cu",
                    "src/repro/kernels/fused_prefill.py:146", k5f[2:3],
                    launches("vq_matmul_f32x", "hw-prefill-vq"),
                    "K5-VQ with an f32 activation (att.wo under hw, "
                    "PLANE_VQ)"),
        _kernel_row("rwkv6_block_decode[mixed]",
                    "src/repro_torch/csrc/rwkv6_block_decode.cu",
                    "src/repro/kernels/fused_decode.py:77", k7mx[:1],
                    launches("rwkv6_block_decode", "rwkv6-mixed-block"),
                    "K7-block on the MIXED planes (W4 att.wk, VQ ffn.wv), "
                    "layer 0"),
        _kernel_row("rwkv6_model_decode[mixed]",
                    "src/repro_torch/csrc/rwkv6_model_decode.cu",
                    "src/repro/kernels/fused_decode.py:182", k7mx[1:],
                    launches("rwkv6_model_decode", "rwkv6-mixed-model"),
                    "K7-model on the MIXED planes; the MIXED engine's path"),
        _kernel_row("rwkv6_block_decode[bf16]",
                    "src/repro_torch/csrc/rwkv6_block_decode.cu",
                    "src/repro/kernels/fused_decode.py:77", k7bf[:1],
                    launches("rwkv6_block_decode", "rwkv6-bf16-block"),
                    "K7-block on plain bf16 weights, layer 0"),
        _kernel_row("rwkv6_model_decode[bf16]",
                    "src/repro_torch/csrc/rwkv6_model_decode.cu",
                    "src/repro/kernels/fused_decode.py:182", k7bf[1:],
                    launches("rwkv6_model_decode", "rwkv6-bf16-model"),
                    "K7-model on plain bf16 weights"),
    ]
    # the twenty-fourth slice: rwkv6's backward kernels, launches from the
    # 3-step rwkv6 run (K10-bwd) and its S 40 step (K6-bwd)
    k10b_row = _kernel_row(
        "wkv6_chunked_bwd", "src/repro_torch/csrc/wkv6_chunked_bwd.cu",
        "src/repro/core/wkv/wkv6.py:58", k10b[:1],
        launches("wkv6_chunked_bwd", "rwkv6-train"),
        "K10-bwd: no TPU kernel, the backward XLA derives from "
        "wkv6_chunked; timed on rwkv6-7b's layer-0 operands of the train "
        "step (B4 T1024 H64 N64, bf16 r, k, v; f32 w), the f32 instance "
        "checked only; a launch counted here is one wrapper call, four "
        "CUDA launches; plain_ms the plain version of its passes")
    k10b_row["max_abs_err"] = max(r["max_abs_err"] for r in k10b)
    k10b_row["shapes"] = [[r[k] for k in ("B", "T", "H", "N")]
                          + [r["rkv_dtype"]] for r in k10b]
    kernels += [
        k10b_row,
        _kernel_row("wkv6_seq_bwd", "src/repro_torch/csrc/wkv6_seq_bwd.cu",
                    "src/repro/core/wkv/wkv6.py:38", [k6b],
                    launches("wkv6_seq_bwd", "rwkv6-train-s40"),
                    "K6-bwd: no TPU kernel, the backward XLA derives from "
                    "wkv6_scan; timed on rwkv6-7b's layer-0 operands of the "
                    "S 40 train step (B2 T40 H64 N64, f32); _time_ms's ~5 "
                    "us floor is part of the reading; two CUDA launches a "
                    "call; plain_ms the plain version of its passes")]
    _timed("dry run", phase_dryrun, dry_proc, dry_log)
    _line({"phase_done": "all", "seconds": time.perf_counter() - t_start})
    _line({"kernels": kernels})
    print(_card(), flush=True)
    _line({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
