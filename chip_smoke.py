"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds every CUDA source of ``repro_torch`` from this
               checkout (one nvcc per source, all at once); cuobjdump's
               SASS must show int8 MMAs (IMMA) in every fused ABFP kernel
               and bf16 MMAs (HMMA) in every tensor-core flash kernel; the
               flash kernels' registers and spill bytes are reported;
  3. kernels — each CUDA kernel against its plain PyTorch version: kernels
               1-3 at the serving path's full smollm-360m shapes (tile 128,
               gain 8, noise 0.5): kernels 1-2 bit-equal (0 flips), kernel
               3 within one bf16 ULP at lengths 0 / 1 / 512 / mixed; the
               decode route (one launch) at M = 1 to 8 on every weight
               shape of a layer, the QKV triple and the LM head, bit-equal
               to the plain version; the ABFP core's routes (the fused
               launch at each row block and the two-launch route) at M = 9
               to 2,048 on three weight shapes, and the LM head (not
               L2-resident: the wrapper's 32-row blocks and 64-row blocks)
               at M = 17 and 40, bit-equal to the plain version; kernels
               1, 3 and 5 at phase 23's shapes (``wide_kernel_checks``);
               kernel 4 (unpacked ABFP matmul) at the evaluation forward's
               shapes (M = 4 x 512 and M = 4, every weight shape of a layer
               and the LM head) bit-equal to kernel 1 on the packed weight
               and within kernel 1's bar of its plain version; kernel 5
               (flash attention) at (4, 512, 15 / 5 heads, 64), causal,
               non-causal and windowed, on bf16 (tensor cores) and on f32
               (the FMA kernel), within one bf16 ULP (rtol
               2**-7, atol 1e-5; f32: rtol 1e-5, atol 2e-5) of its plain
               version;
  4. serve   — the port's ServingEngine (``repro_torch.launch.serve``'s
               engine) serves 8 requests on full-width smollm-360m in
               ``abfp_fused`` mode, capacity 4; every request must finish,
               no logits may be NaN, and every kernel must have launched
               (launch counts zeroed just before, read just after; the
               launches of each pass are read around it, by pass kind);
  4b. graphs — every pass shape (decode, prefill 16 / 64 / 128) captured
               into a CUDA graph: two consecutive passes with two keys
               from the served state, by replay and eagerly through the
               kernels, must give bit-equal logits and sampled tokens, and
               the two keys' logits must differ; then the phase-4 workload
               served eagerly, with graphs (blocking, simulated clock) and
               with graphs + overlap (wall clock), in turns (eager,
               graphs, overlap, overlap, graphs, eager), each a fresh
               engine with the launch counts zeroed just before and read
               just after: 8 of 8 requests, phase 4's greedy streams,
               kernels 1-3 launched (a replay counts the launches its
               capture recorded); decode tick and prefill pass medians,
               tokens/s and tick utilization of each run;
  5. compare — the first prefill pass and decode tick once through the
               kernels and once through the plain versions: every kernel
               call of the kernel run against its plain version on its own
               inputs (phase 3's bars: kernels 1, 2 and 4 with 0 flips),
               the logits' max-abs difference
               (bar DECODE_LOGIT_BAR) and share of equal greedy tokens,
               and the tick rerun with kernel 3's plain version, which must
               then equal the plain run bit for bit;
  6. time    — each kernel's device time for one decode tick's worth of
               its launches (CUDA graph replay of the serving weights and
               caches), its plain version's time and its bound; kernels
               1-2 on the decode route and on the two-launch route, in
               turns; kernel 1's
               prefill pass on its route and on the two-launch route, and
               one layer's seven matmuls and the LM head at M = 16 to 2,048
               on every route, in turns;
  7. evaluate — this slice's main path: ``evaluate_abfp`` of full
               smollm-360m with flash attention over 2 batches of 4 x 513
               tokens in ``abfp_kernel`` mode (tile 128, gain 8, noise
               0.5), then in float; launch counts zeroed just before and
               read just after (exactly 2 x 225 of kernel 4 and 2 x 32 of
               kernel 5); the first forward once more, read around it
               (225 / 32), every kernel call held against its plain version
               on its own inputs, its logits against the plain forward's
               (bar EVAL_LOGIT_BAR), and the forward rerun with kernel 5's
               plain version, which must equal the plain forward bit for
               bit; DNF's ``capture_histograms`` on one batch (32 per-layer
               stds);
  8. eval time — kernel 4's and kernel 5's device time for one forward's
               launches (graph replay), eager and plain times, bounds,
               ``scaled_dot_product_attention``'s time on kernel 5's inputs;
               in turns, kernel 4 on its route and on the two-launch route
               (with the peak device memory of each) and kernel 5 on the
               tensor cores and on the FMA kernel (its f32 route, on the
               same inputs cast to f32); the whole forward's host
               time and its issue time (host clock to the last enqueue);
  9. profile — a profiler breakdown of one decode tick, one prefill pass,
               one evaluation forward and one graph replay of a decode
               tick and of a 128-token prefill pass, with the pass's
               kernel launches (the
               profiler's own set-up may fail and is then skipped; an error
               in a profiled pass fails the run);
 10. train  — the training path on full smollm-360m (bf16 weights from
               seed 0, synthetic batches of 4 x 129 tokens): the train
               driver (``repro_torch.launch.train``, in this process) in
               float for 4 steps with a checkpoint every 2, then again to
               6 steps, which must resume from step 4 (finite losses and
               grad norms); the driver's QAT (``--quant qat``: abfp_ref,
               tile 128, gain 8, noise 0.5) for 2 steps, every weight
               moved; QAT in abfp_kernel mode through ``make_train_step``
               for 2 steps, kernel 4 launched exactly 225 times per step
               (counts zeroed before and read after each step), the loss
               on one batch and key through the kernels equal to the plain
               versions' and the train step's bit for bit, the gradients
               within TRAIN_GRAD_RTOL; kernel 1 under the ``dense_packed``
               straight-through Function at M = 512, output and dx
               bit-equal to the plain version's; DNF (histograms from one
               batch in abfp_kernel mode, the top half of the layers by
               std, 3 steps); the median step time and peak device memory
               of float, QAT abfp_ref, QAT abfp_kernel and DNF, and the
               DNF-to-QAT step-time ratio (a measurement, no bar), and a
               profiler breakdown of one float, QAT abfp_kernel and QAT
               abfp_ref step;
 11. paged  — phase 4's model served from a paged KV pool: replay
               against eager under two keys and two page tables, phase 4's
               workload eager and with graphs, an overload run and an
               open-loop Poisson run (see ``paged_phase``);
 12. faults — fault injection, detection and recovery on phase 4's served
               weights (see ``fault_phase``): (a) a stuck wq column pair
               and a drifted wv tile pair injected in place, kernel 2
               (decode route) and kernel 1 (M = 512) on them bit-equal to
               their plain versions (which read the canonical codes), the
               stuck columns exactly 0.0, then a detection round and a
               repair from the clean copy, every copy byte-equal to it and
               the outputs bit-equal to the pre-fault ones; (b) phase 4's
               workload under an explicit plan (a stuck LM-head column
               pair, a drifted MLP tile pair, a stuck wk column, a shard
               drop) eagerly, with graphs and with graphs + overlap, the
               launch counts zeroed just before each run and read just
               after: 8 of 8, conservation, every event injected, faults
               detected, repaired and requests requeued, the three runs'
               streams and counters equal; (c) ``FaultConfig(rate=0.05,
               seed=3)`` with graphs, recovery on against off: goodput on
               >= off, corrupted requests without recovery; (d) a rate-0
               plan with graphs: phase 4's streams and phase 4b's launch
               counts, in turns with no plan; (e) a detection round's host
               and device time, the reshard's time, and the rate-0 and
               no-plan decode-tick medians against phase 4b's.

 13. recurrent — the recurrent and hybrid families served at full width
               through ``repro_torch.launch.serve``'s configuration
               (``--arch ... --full --fused``: bf16 weights from seed 0,
               abfp_fused, tile 128, gain 8, noise 0.5, int8 KV, capacity
               4, max_len 512; see ``recurrent_phase``): (a)
               recurrentgemma-2b (18 RG-LRU + 8 local-attention layers,
               window 2,048) on phase 4's six prompt lengths and two
               prompts of 2,100 and 2,300 tokens (past max_len and past
               the window: fixed-state admission, the ring buffers wrap),
               16 greedy tokens each, served eagerly, with graphs and with
               graphs + overlap in turns (RG_TURNS), each run a fresh
               engine with the launch counts zeroed just before and read
               just after: 8 of 8, streams equal, no NaN logits, kernel 1
               201 times per decode tick and kernels 2 and 3 never (the
               windowed ticks take the packed chain and the plain int8
               attention, as the JAX package's do); every pass shape's
               replay against the eager pass under two keys (logits,
               sampled tokens and the whole state bit-equal, the keys'
               logits differ); the first prefill pass and decode tick
               through the kernels and the plain versions (every kernel-1
               call 0 flips on its own inputs, and then the logits
               bit-equal); decode and prefill medians, tokens/s, tick
               utilization, each graph capture's seconds, a profiler
               breakdown of a decode replay and a 128-token prefill replay,
               kernel 1's device time for one tick's 201 launches (and per
               weight shape) beside its bound, and the peak device memory;
               (b) xlstm-350m at XL_SERVE_LAYERS = 6 of its 24 layers (3
               mLSTM + 3 sLSTM, full width: the run's time limit) the same
               on the six short prompts, eager and with graphs (31
               kernel-1 launches per tick).
 14. moe    — full-width granite-moe-1b-a400m (24 layers, d_model 1,024,
               32 experts top-8, expert hidden 512) served as ``--arch
               granite-moe-1b-a400m --full --fused`` configures it (see
               ``moe_phase``), on phase 4's prompt lengths: (a) eagerly,
               with graphs and with graphs + overlap in turns, each run a
               fresh engine with the launch counts zeroed just before and
               read just after: 8 of 8, streams equal, no NaN logits,
               every decode tick exactly 2,329 kernel-1 launches (each
               layer's attn.wo and its experts' wi, wg, wo, and the head)
               and 24 each of kernels 2 and 3, every prefill pass 2,401 of
               kernel 1; (b) every pass shape's replay against the eager
               pass under two keys (logits, sampled tokens, KV state
               bit-equal; the keys' logits differ); the first prefill pass
               and decode tick through the kernels and the plain versions:
               every kernel-1/2 call 0 flips and every kernel-3 call within
               its card tests' bar (rtol 2**-7, atol 1e-6) on its own
               inputs, every layer's chosen experts
               equal, the logits within DECODE_LOGIT_BAR (bit-equal in the
               prefill pass, and in the tick with kernel 3's plain
               version); kernels 1-3's device time for one tick's launches
               (kernel 1 per weight shape too) beside their bounds, a
               profiler breakdown of a decode replay, capture seconds,
               peak device memory; (c) one cacheless ``forward`` of 2 x 128
               tokens in ``abfp_kernel`` with flash attention (2,401
               kernel-4 and 24 kernel-5 launches), through the kernels and
               the plain versions: finite logits within EVAL_LOGIT_BAR,
               the aux and the rows routed apart reported, and with
               kernel 5's plain version logits, aux and every layer's
               chosen experts bit-equal to the plain run's.

 15. encdec — the encoder-decoder family and the stub frontends (see
               ``encdec_phase``): (a) full-width whisper-base (6 + 6
               layers, d_model 512, 8 heads of 64, vocab 51,865) served as
               ``--arch whisper-base --full --fused`` configures it, capacity
               4, max_len 448, each of phase 4's eight prompt lengths with
               1,500 frames of ``audio_stub_features`` keyed (seed, uid),
               eagerly, with graphs and with graphs + overlap in turns:
               8 of 8, streams equal, every decode tick 31 / 6 / 6
               launches of kernels 1-3, every prefill pass 49 and every
               admission pass 48 of kernel 1; every pass shape's replay,
               the admission pass's too, bit-equal to the eager pass under
               two keys; admission host time, kernel 1's admission launches
               timed against their bound, profiles of a decode and an
               admission replay; (b) paged with graphs on a pool that
               preempts: 8 of 8, conservation, every re-admission's cross
               K/V bit-equal to the first admission's, and against the
               unpaged engine with kernel 3's plain version every request
               whose passes (shape, noise key, slot) are the same in both
               runs has the same stream (a preemption shifts the later
               passes' keys; where a request's passes part is reported);
               without noise every request never preempted has the same
               stream (the resumed ones' reported, beside the bits in
               which the re-prefill's 16-query attention forms differ from
               a tick's one-query forms);
               (c) kernel 1 at M = 1,500 on the encoder's
               weights at 0 flips, kernel 3 at group 1 within its bar,
               kernel 5 non-causal at (1,500, 1,500) and (128, 1,500) in
               bf16 and f32 within phase 3's bars, timed with bounds and
               SDPA; (d) an ``abfp_kernel`` + flash ``forward`` of 2 x 128
               tokens over 2 x 1,500 frames (97 kernel-4 and 18 kernel-5
               launches) against the plain versions (EVAL_LOGIT_BAR; with
               kernel 5's plain version bit-equal); (e) full-width
               phi-3-vision-4.2b (32 layers, d_model 3,072, 32 heads of
               96): an ``abfp_kernel`` + flash ``forward`` on 1 x 256 stub
               embeddings (225 / 32 launches) the same way, a 2-request
               ``abfp_fused`` graphs run and kernel 3 at D = 96 on its
               caches within its bar, and kernel 5 at D = 96 in bf16 and
               f32, timed.
 16. fleet  — the multi-model fleet (see ``fleet_phase``): (a) one
               ``ServingEngine(models=...)`` over full-width smollm-360m,
               whisper-base (1,500 stub frames per request from
               ``attach_features``), xlstm-350m (at XL_SERVE_LAYERS, as in
               phase 13b) and recurrentgemma-2b as ``--archs ... --full
               --fused`` configures them, capacity 8
               (2 slots per lane), max_len 448 for every lane, 16 greedy
               requests routed round-robin (phase 4's prompt draws folded
               into each lane's vocabulary), served eagerly, with graphs
               (blocking) and with graphs + overlap (one shared delivery
               stream, inflight 4): 16 of 16, every lane's conservation,
               ``ticks`` the lanes' sum, every lane's passes and greedy
               streams those of its requests served alone by a
               single-model engine (graphs, blocking, 2 slots), and the
               kernel launches the sum of those four single-model runs';
               per-lane TTFT / TPOT p50, tokens/s, the overlapped lanes'
               tick utilization; (b) a paged fleet, smollm-360m as ``dec``
               (4 slots on 6 pages of 128; 8 requests of 200 + 56 tokens
               need 2 pages each) beside xlstm-350m as ``rec`` (2 slots):
               ``dec`` paged and preempted at least once, ``rec`` without
               a pool, never preempted, with its single-model streams;
               12 of 12, conservation and ``preempt_ok``.
 17. family faults — fault plans on the MoE, hybrid and encoder-decoder
               models (see ``family_fault_phase``): granite-moe-1b-a400m,
               recurrentgemma-2b and whisper-base each serve their phase's
               8 requests (14, 13, 15) at capacity 4 under an explicit
               plan on sites the dense decoder lacks (a stuck column pair
               on every expert's ``moe/wo`` and drifted ``moe/wi`` tiles;
               ``groups/1/rglru/w_in``, ``groups/2/attn/wq`` and the
               remainder layer's ``extra/1/rglru/w_in``; the encoder's
               ``mlp/wi`` and the cross ``wk``), with recovery on, eagerly
               and with graphs: 8 of 8, conservation, every event's site
               detected and repaired (its columns remapped, its tiles
               re-quantized), after each run every site bit-equal to the
               clean pack with ``kcodes == kernel_layout(codes)`` and each
               ``PackedQKV`` a fresh concatenation, no served tensor
               moved, eager and graphs equal in counters, requests and
               streams; a rate-0 plan with graphs gives the family phase's
               streams and launches; each model's detection round (host
               ms, device busy ms) and reshard time.
 18. recurrent training — the cacheless forward, evaluation and training
               of the recurrent and hybrid families at full width, bf16
               weights from seed 0 (see ``recurrent_train_phase``): (a)
               ``evaluate_abfp`` of recurrentgemma-2b (flash on) and of
               xlstm-350m over 2 batches of 4 x 513 tokens in abfp_kernel
               (tile 128, gain 8, noise 0.5), then in float, the launches
               read around each forward (exactly 201 of kernel 4 and 8 of
               kernel 5, and 121 and 0; in float kernel 5 alone); a parity
               forward
               of 2 x 128 tokens through the kernels (every kernel-4 call
               0 flips and every kernel-5 call within phase 3's bar on its
               own inputs; logits bit-equal with kernel 5's plain version;
               through kernel 5 within the plain forward's own spread
               under a second noise key, and in float within
               EVAL_LOGIT_BAR of the plain versions');
               ``capture_histograms`` (26 and 24 per-layer stds); (b) a
               float forward of recurrentgemma-2b over 1 x 4,096 tokens
               with flash on (the 2,048 window masks and skips blocks):
               kernel 5's 8 calls (head dim 256) against the plain version
               (and one in f32 on the FMA kernel), their device time beside
               their bound, the plain version's and SDPA's under the same
               window mask; (c) training on batches of 4 x 129: xlstm-350m
               through the train driver in float (4 steps, a checkpoint
               every 2, resumed to 6), QAT abfp_kernel through
               ``make_train_step`` (2 steps, exactly 121 kernel-4 launches
               each, the loss on batch 0 through the kernels bit-equal to
               the plain versions' and the train step's, the gradients
               within TRAIN_GRAD_RTOL) and DNF (18a's histograms, the top
               half of the layers by std, 3 steps); recurrentgemma-2b float
               (2 steps) and QAT abfp_kernel (2 steps, 201 launches each,
               the same checks); every run's losses and gradient norms
               finite and every weight moved; the steps donate their state
               (in place: one AdamW state of 2.9 B parameters fits the
               card); median step time and peak device memory per recipe.
 19. abfp_ref — the paper's reference numerics served (``--full --quant
               abfp``: the ``abfp_ref`` tile scan on float weights, tile
               128, gain 8, noise 0.5; every dense call's key from the
               pass's key table in the pass buffers, split and drawn on the
               card inside the captured pass; see ``abfp_ref_phase``): (a)
               full-width smollm-360m at its first ABFP_REF_LAYERS layers
               on phase 4's first four requests (ABFP_REF_REQUESTS; both
               cut for the run's time limit), eagerly, with
               graphs (blocking) and with graphs + overlap, the launch
               counts zeroed just before each run and read just after:
               4 of 4, streams equal across the three, kernels 1-5 never
               launched; every pass shape's replay against the eager pass
               under two pass keys (logits and state bit-equal, the keys'
               logits differ); the workload's first prefill pass by replay
               bit-equal to the same pass through the host-key scan; decode
               and prefill medians, tokens/s, capture seconds, the peak
               device memory with every shape captured, and profiles of a
               decode replay and a 128-token prefill replay (kernels per
               replay, device busy time, the int64 elementwise kernels'
               share: the threefry); (b) full-width whisper-base, phase 15's
               first four requests with their 1,500-frame features, eagerly
               and with graphs: streams equal, the captured admission pass
               (the key table's encoder and root rows) bit-equal to the
               eager admission under two request keys, whose cross K/V
               differ; admission replay host times.
 20. mesh   — tensor-parallel serving on a virtual (data, model) mesh
               (every position on this card; see ``mesh_phase``) of
               full-width tinyllama-1.1b (22 layers, d_model 2,048, 32 / 4
               heads of 64, SwiGLU 5,632, vocab 32,000) as ``--arch
               tinyllama-1.1b --full --fused`` configures it: (a) the
               column-shard inputs of kernels 1, 2 and 4: at tp 2 and 4,
               kernel 1 on layer 0's mlp.wi forced through each route
               (decode at M = 4, fused at M = 512, two-launch at M =
               512), kernel 2 on attn.wq|wk|wv (tp 2) and wq|mlp.wi|mlp.wg
               (tp 4, where wk and wv are one block) at M = 4, kernel 4 on
               the float mlp.wi at M = 512: every shard's launch at its
               global column-block offset bit-equal to the same columns of
               the one-device launch and to its plain version with the
               offset (0 flips), a shard without its offset different;
               the shards' device times beside the one-device launch's;
               (b) phase 4's workload (prompts folded into the vocabulary)
               served with graphs without a mesh and at MESH_SHAPES, the
               launch counts zeroed just before each run and read just
               after: 8 of 8, every mesh's streams bit-equal to the run
               without one, every decode tick and prefill pass exactly
               MESH_LAUNCHES, every pass shape's replay bit-equal to the
               eager pass under two keys; decode tick, prefill pass and
               tokens/s of each mesh beside the run without one (reported:
               a virtual mesh only adds launches).
 21. mesh training — the training mesh and faults on a mesh (see
               ``mesh_train_phase``): (a) full-width granite-moe-1b-a400m
               (24 layers, d_model 1,024, 32 experts top-8 of 512, vocab
               49,155; bf16 weights from seed 0) trained on batches of
               4 x 129 through ``make_train_step(mesh=)`` on virtual (1, 4)
               and (2, 4) meshes: every MoE layer on the expert-parallel
               route (``moe_block_sharded``, float experts), float and QAT
               abfp_kernel (tile 128, gain 8, noise 0.5), MESH_TRAIN_STEPS
               donated steps each, the launch counts zeroed just before
               each step and read just after (float none; QAT exactly
               MESH_TRAIN_K4 of kernel 4: the attention projections and
               the head), every weight moved; the QAT loss on batch 0
               through the kernels bit-equal to the plain versions' and to
               the step's, the gradients within TRAIN_GRAD_RTOL; step
               medians past the first step and peak GiB; at capacity
               factor MESH_CF_CHECK one float forward per mesh: its loss
               within MESH_LOSS_RTOL of the forward's without a mesh, its
               aux within MESH_AUX_RTOL of the mean over the data shards of
               each shard's own aux without a mesh; (b) full-width
               tinyllama-1.1b on phase 20b's workload in abfp_fused with
               graphs on a (2, 4) mesh: under a rate-0 plan phase 20b's
               streams and MESH_LAUNCHES,
               and under a shard drop of shard 1 at tick MESH_DROP_TICK the
               mesh re-planned to (1, 4) in place (every captured pass
               kept), 1 reshard, conservation and 8 of 8 finished.
 22. dry run — the dry run's cost analysis against the card (see
               ``dryrun_phase``): five cells of full-width smollm-360m
               built by ``launch.dryrun.build_cell`` at cut shapes
               (DRYRUN_CELLS: float prefill 4 x 2,048 on a (1, 1) mesh and
               on a (1, 2) virtual mesh, where every dense weight runs one
               model shard at a time, float decode of 32 rows over a
               4,096-position state, a float train step on 8 x 512 tokens
               with 4 microbatches, remat, AdamW and the state donated, an
               ``abfp`` (``abfp_ref``) prefill 1 x 256), each traced on
               ``meta`` (``cost_analysis.traced_costs``), then run on the
               card with bf16 weights from seed 0: (a)
               ``FlopCounterMode``'s count of the card's run equal to the
               trace's whole-mesh count; (b) the peak allocated bytes
               above the bytes before the cell's inputs were made within
               DRYRUN_PEAK_RTOL or DRYRUN_PEAK_ATOL of the trace's
               whole-mesh ``live_bytes_global`` (one card holds every
               shard); (c) the median of DRYRUN_REPS timed runs after a
               warm-up (CUDA events) not below ``roofline_terms``'
               max(compute_s, memory_s) of the whole mesh's FLOPs and
               bytes with the H100 constants, the ratio printed; (d) on
               the mesh cell, the trace's sharded FLOPs the dense calls'
               (from the config), the per-device FLOPs their half plus
               the attention (15 query heads do not split over 2: whole,
               as GSPMD gathers them), and the logits within
               DRYRUN_MESH_LOGIT_BAR of the (1, 1) prefill's;
 23. dense   — full-width gemma-7b (16 / 16 heads of 256, GeGLU, the tied
               3,072 x 256,000 LM head behind the sqrt(d) embedding
               scale) and chatglm3-6b (32 / 2 heads of 128, partial
               rotary, vocab 65,024), all 28 layers, as ``--arch <a>
               --full --fused`` configures them (see ``dense_phase``): (a)
               phase 4's eight prompt lengths served eagerly, with graphs
               and with graphs + overlap: 8 of 8 with equal streams,
               kernels 1 / 2 / 3 launched 113 / 28 / 28 times per tick and
               kernel 1 197 times per prefill pass, every pass shape's
               replay bit-equal to the eager pass under two keys; (b) the
               first prefill pass and decode tick at the first
               DENSE_CHECK_LAYERS layers plus the head through the kernels
               and the plain versions: kernels 1-2 at 0 flips and kernel 3
               within its card tests' bar on every call's own inputs, the
               logits within DECODE_LOGIT_BAR and bit-equal with kernel 3's
               plain version; (c) one full-depth tick's worth of kernels
               1-3 timed beside its bound and the plain versions; (d) the
               ``abfp_kernel`` + flash evaluation forward over 4 x 512
               tokens at full depth (kernels 4 / 5 launched 197 / 28
               times; kernel 5's calls timed beside the bound, the plain
               version and SDPA) and at DENSE_CHECK_LAYERS layers against
               the plain versions (``eval_forward_runs``: EVAL_LOGIT_BAR,
               bit-equal with kernel 5's plain version).  Phase 3 checks
               kernels 3 and 5 at these head dims and groupings and kernel
               1 on a 3,072 x 256,000 head first (``wide_kernel_checks``).

The last two lines of standard output are the ``{"kernels": [...]}`` line
and ``{"ok": true, "device": {...}}``.  Weights are random from a seed.
Without CUDA, or without the ``repro_torch`` sources beside this file, it
exits 1 before printing anything to standard output.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
_T0 = time.perf_counter()       # the log lines' clock

# H100 SXM published peaks (dense): HBM bytes/s, int8 and bf16 tensor
# ops/s, f32 (non-tensor) flop/s.
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
# f32 operations of the ABFP epilogue per (row, K-tile, column): ADC scale,
# gain, noise (3), round, clamp (2), LSB, two rescales, gain divide, sum.
EPILOGUE_FLOPS = 13
# f32 operations of kernel 4's weight quantizer per weight element: abs,
# max, divide, multiply, round, clamp (2).
W_QUANT_FLOPS = 7
# Phase 5's bar on the first pass's logits (kernels vs plain versions): the
# first decode tick measured 0.52 on an H100, from kernel 3's one-ULP flips
# carried through 32 layers; twice that.
DECODE_LOGIT_BAR = 1.0
# Phase 7's bar on the evaluation forward's logits (kernels vs plain
# versions); kernel 4 is bit-equal, so what is left comes from kernel 5's
# f32 sum order moving activation codes (checked by the rerun with kernel
# 5's plain version).
EVAL_LOGIT_BAR = 1.0

SEED = 0
CAPACITY = 4
MAX_LEN = 512
MAX_NEW = 16
N_REQUESTS = 8
# The kernels of the serving path (the other two run on the evaluation
# path only).
SERVE_KERNELS = ("abfp_matmul_packed", "fused_qkv_packed",
                 "fused_quantized_decode_attention")
# The evaluation forward: batches of EVAL_BATCH x (EVAL_SEQ + 1) tokens.
EVAL_BATCH = 4
EVAL_SEQ = 512
EVAL_BATCHES = 2
EVAL_ROWS = EVAL_BATCH * EVAL_SEQ
# The training phase: batches of TRAIN_BATCH x (TRAIN_SEQ + 1) synthetic
# tokens (the port's ``DataConfig(49152, 128, 4, seed 0)``).
TRAIN_BATCH = 4
TRAIN_SEQ = 128
# Phase 10's bar on the abfp_kernel QAT gradients, kernels against plain
# versions (the forward and the loss are bit-equal): one bf16 ULP, since
# the backward's f32 matmuls and the embedding's scatter-add need not
# keep one order.
TRAIN_GRAD_RTOL = 2 ** -7
# Phase 11 (paged serving): the roomy pool of 11a (the unpaged footprint:
# CAPACITY x MAX_LEN / 128-token pages); 11b's overload workload (a burst
# of OVERLOAD_BURST requests at once, the rest OVERLOAD_GAP_S apart, a
# deadline OVERLOAD_DEADLINE_S after arrival on every third); 11c's open
# loop (Poisson arrivals at OPEN_RATE per second, prompts of 1 to 2 x
# OPEN_PROMPT_LEN - 1 tokens, goodput against OPEN_SLO_TTFT_S).
PAGED_POOL = 16
OVERLOAD_REQUESTS = 12
OVERLOAD_BURST = 8
OVERLOAD_GAP_S = 0.03
OVERLOAD_DEADLINE_S = 0.6
OPEN_REQUESTS = 16
OPEN_RATE = 40.0
OPEN_PROMPT_LEN = 64
OPEN_SLO_TTFT_S = 0.25
# Phase 12 (faults): 12b's explicit plan (tick, kind, site, what), spread
# over phase 4's run (32 passes without faults), the detection cadence of
# every fault run, 12c's seeded plan and the TTFT SLO its goodput counts
# against (in ticks: the graph runs are on the simulated clock; every
# request's TTFT fits it, so the goodput counts uncorrupted completions).
FAULT_EVENTS = (
    (3, "stuck_col", "lm_head", {"cols": (17, 40000)}),
    (9, "scale_drift", "groups/0/mlp/wi",
     {"tiles": ((1, 100), (6, 2000)), "factors": (1.2, 0.8)}),
    (15, "stuck_col", "groups/0/attn/wk", {"cols": (5,)}),
    (22, "shard_drop", "", {"shard": 0}))
FAULT_DETECT_EVERY = 2
FAULT_RATE, FAULT_SEED = 0.05, 3
FAULT_SLO_TTFT = 64.0
# Phase 13 (recurrent families): 13a's two prompts past MAX_LEN and past
# recurrentgemma-2b's 2,048-token window (their ring buffers wrap inside
# and across 128-token chunks), 13a's served runs in turns, and kernel 1's
# launches per decode tick: 18 RG-LRU layers x 8 + 8 attention layers x 7
# + the LM head, and per mLSTM / sLSTM layer pair 7 + 3, + the head.
# Phases 13b and 16 serve xlstm-350m at XL_SERVE_LAYERS of its 24 layers
# (full width): its per-token sLSTM folds make its eager passes and its
# graph captures (137 k kernels per 128-token pass at full depth) among
# the run's costliest, and the run has a time limit.
RG_LONG_PROMPTS = (2100, 2300)
RG_TURNS = ("eager", "graphs", "overlap")
RG_DECODE_K1 = 201
XL_SERVE_LAYERS = 6
XL_DECODE_K1 = XL_SERVE_LAYERS // 2 * (7 + 3) + 1
# Phase 14 (MoE): 14a's served runs in turns; 14c's evaluation forward of
# MOE_EVAL_BATCH x MOE_EVAL_SEQ tokens.
MOE_TURNS = ("eager", "graphs", "overlap")
MOE_EVAL_BATCH, MOE_EVAL_SEQ = 2, 128
# Phase 15 (encoder-decoder): whisper's 30 s window (3,000 mel frames
# after its stride-2 conv) and decoder context; 15b's pages and pool, small
# enough that phase 4's eight prompts preempt.
WHISPER_FRAMES = 1500
WHISPER_MAX_LEN = 448
WHISPER_PAGE = 32
WHISPER_POOL = 8
# Phase 16 (the fleet): the JAX fleet test's four lanes, the total slot
# count (2 per lane), 16 requests routed round-robin; 16b's paged fleet:
# 4 decoder slots whose 8 requests of 200 + 56 tokens need 2 pages of 128
# each, on a 6-page pool, beside 2 fixed-state slots.
FLEET_ARCHS = ("smollm-360m", "whisper-base", "xlstm-350m",
               "recurrentgemma-2b")
FLEET_CAPACITY = 8
FLEET_REQUESTS = 16
FLEET_INFLIGHT = 4
PAGED_FLEET_SPLIT = {"dec": 4, "rec": 2}
PAGED_FLEET_PAGE = 128
PAGED_FLEET_POOL = 6
PAGED_FLEET_PROMPT, PAGED_FLEET_NEW = 200, 56
# Phase 17 (faults on every family): each model's explicit plan on sites
# the dense decoder lacks (an MoE expert stack, RG-LRU and windowed
# attention groups, a remainder layer, the encoder, the cross-attention).
FAMILY_FAULTS = {
    "granite-moe-1b-a400m": (
        (3, "stuck_col", "groups/0/moe/wo", {"cols": (17, 900)}),
        (6, "scale_drift", "groups/0/moe/wi",
         {"tiles": ((0, 5), (7, 400)), "factors": (1.2, 0.8)})),
    "recurrentgemma-2b": (
        (3, "stuck_col", "groups/1/rglru/w_in", {"cols": (3, 2000)}),
        (6, "scale_drift", "groups/2/attn/wq",
         {"tiles": ((1, 9), (19, 2500)), "factors": (0.85, 1.15)}),
        (9, "stuck_col", "extra/1/rglru/w_in", {"cols": (11,)})),
    "whisper-base": (
        (3, "stuck_col", "encoder/layers/mlp/wi", {"cols": (5, 1900)}),
        (6, "scale_drift", "groups/0/cross/wk",
         {"tiles": ((0, 7), (3, 300)), "factors": (1.2, 0.8)})),
}
# Phase 18 (recurrent training): per arch, (layers, d_model, kernel-4 and
# kernel-5 launches per forward): 18 RG-LRU x 8 + 8 attention x 7 + the
# head, and the 8 windowed attention layers; 12 mLSTM x 7 + 12 sLSTM x 3 +
# the head.
RECURRENT_TRAIN = {"recurrentgemma-2b": (26, 2560, 201, 8),
                   "xlstm-350m": (24, 1024, 121, 0)}
# Phase 19 (abfp_ref served): the requests of each model, phase 4's first
# four (one prefill pass at bucket 128, 15 ticks) and phase 15's first four
# with their 1,500-frame features: an eager abfp_ref tick launches about
# 94 k kernels (2 s of host time), so the whole workload would take the
# run past its time limit.
ABFP_REF_REQUESTS = 4
# ... and smollm-360m served there at its first 4 of 32 layers (an eager
# tick at 32 layers takes about 2 s; the run's time limit since phase 23).
ABFP_REF_LAYERS = 4
# Phase 20: the virtual meshes served (data, model), and the kernel
# launches of each mesh's decode tick and prefill pass on full-width
# tinyllama-1.1b (22 layers; kernel 1 on wq/wk/wv/wo/wi/wg/wo per layer
# and the LM head, kernel 2 the fused QKV when wq, wk and wv all split,
# kernel 3 the attention, never split).  At tp 4, wk and wv (256 columns)
# and the LM head (250 blocks) do not split into whole 128-column blocks.
MESH_SHAPES = ((1, 2), (2, 2), (1, 4))
MESH_LAUNCHES = {
    1: {"decode": (89, 22, 22), "prefill": (155, 0, 0)},
    2: {"decode": (178, 44, 22), "prefill": (310, 0, 0)},
    4: {"decode": (485, 0, 22), "prefill": (485, 0, 0)},
}
# The served runs and the plain kernel checks of phase 20a take the first
# layer's weights; the model has all 22.
MESH_ARCH = "tinyllama-1.1b"
# Phase 21: the training mesh on full-width granite-moe-1b-a400m (the
# meshes, the donated steps per run, kernel 4's launches per QAT step on a
# mesh: 4 attention projections per layer and the head, the experts float
# on the expert-parallel route), the capacity factor of the check against
# the one-device forward and its bars (the reference MoE test's: loss
# 2e-2 relative to the one-device forward's, aux 5e-2 relative to the mean
# of the data shards' one-device aux: a mesh's aux is that mean, not the
# whole batch's); 21b's mesh and the tick of its shard drop.
MESH_TRAIN_ARCH = "granite-moe-1b-a400m"
MESH_TRAIN_SHAPES = ((1, 4), (2, 4))
MESH_TRAIN_STEPS = 3
MESH_TRAIN_K4 = 24 * 4 + 1
MESH_CF_CHECK = 8.0
MESH_LOSS_RTOL, MESH_AUX_RTOL = 2e-2, 5e-2
MESH_FAULT_SHAPE = (2, 4)
MESH_DROP_TICK = 6
# Phase 22: the dry run's cells against the card on full-width
# smollm-360m (label, (seq_len, global_batch, kind), quant, mesh shape),
# the microbatches of its train cell, the bar on the peak (the larger of a
# share of the trace's live bytes and a floor: the allocator's rounding
# and library workspaces the trace cannot see), the timed runs, and the
# bar on the (1, 2) mesh prefill's logits against the prefill's without a
# mesh (the float bar of phases 5 and 7: its row-parallel calls round each
# shard's bf16 product before their f32 sum, a last-bit move per call
# carried through 32 layers).
DRYRUN_ARCH = "smollm-360m"
DRYRUN_CELLS = (
    ("prefill", (2048, 4, "prefill"), "float", (1, 1)),
    ("prefill_mesh", (2048, 4, "prefill"), "float", (1, 2)),
    ("decode", (4096, 32, "decode"), "float", (1, 1)),
    ("train", (512, 8, "train"), "float", (1, 1)),
    ("abfp_prefill", (256, 1, "prefill"), "abfp", (1, 1)),
)
DRYRUN_MESH_LOGIT_BAR = 1.0
DRYRUN_MICROBATCHES = 4
DRYRUN_PEAK_RTOL = 0.10
DRYRUN_PEAK_ATOL = 64 * 2 ** 20
DRYRUN_REPS = 3
# Phase 23 (dense archs never served before): full width and 28 layers
# with the kernels; the passes held against the plain versions at the
# first DENSE_CHECK_LAYERS layers plus the head (plain versions at full
# depth would cost the run's time limit: one full-depth gemma-7b tick's
# kernel-1 calls take 0.6 s through them); the evaluation forward's tokens.
DENSE_ARCHS = ("gemma-7b", "chatglm3-6b")
DENSE_CHECK_LAYERS = 4
DENSE_EVAL_BATCH = 4
DENSE_EVAL_SEQ = 512
# Phase 3's checks at phase 23's shapes: (query heads, KV heads, head dim)
# of gemma-7b and chatglm3-6b, and gemma's tied LM head (K, N).
WIDE_HEADS = ((16, 16, 256), (32, 2, 128))
WIDE_HEAD = (3072, 256_000)
# The served workloads of phases 13-15 (prompts, features, the graphs
# run's streams and launches), which phase 17 serves again under fault
# plans and under a rate-0 plan.
WORKLOADS: dict = {}


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke {time.perf_counter() - _T0:7.1f}s] {msg}",
          flush=True)


def bits(t):
    """bf16 tensor -> int32 numpy bit patterns."""
    import torch
    u = t.detach().to(torch.bfloat16).cpu().view(torch.int16).numpy()
    return u.view(np.uint16).astype(np.int32)


def bf16_diff(got, want):
    """(one-ULP flips, elements, largest ULP distance, max-abs difference)
    of two bf16 tensors."""
    g, w = bits(got), bits(want)
    d = np.abs(g - w)
    return (int((d == 1).sum()), g.size, int(d.max()) if d.size else 0,
            float((got.float() - want.float()).abs().max()))


def bf16_flips(got, want, what: str, per_mille: bool = True,
               quiet: bool = False):
    """Check the bf16 bar (no difference beyond one ULP; with
    ``per_mille``, at most one flip in each started 1,000 elements);
    return (flips, elements, max-abs difference)."""
    n, size, ulp, err = bf16_diff(got, want)
    if ulp > 1:
        fail(f"{what}: a difference of {ulp} bf16 ULPs")
    if per_mille and n > -(-size // 1000):
        fail(f"{what}: {n}/{size} one-ULP flips")
    if not quiet:
        log(f"{what}: {n}/{size} one-ULP flips, max-abs {err:.3g}")
    return n, size, err


def median_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e))
    return statistics.median(out)


def graph_ms(fn, reps: int):
    """Device time of ``fn``'s launches: capture once, time the replays.
    Returns (ms, how)."""
    import torch
    fn()
    torch.cuda.synchronize()
    try:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
    except RuntimeError as e:
        log(f"graph capture refused ({e}); timing eagerly instead")
        return median_ms(fn, reps), "eager"
    return median_ms(g.replay, reps), "graph"


def k1_cost(m: int, pw, x_bytes: int):
    """(bytes, int8 ops, f32 ops) of one packed-matmul call, counting only
    what the function needs: K x N codes and ceil(K / tile) x N scales,
    not the zero padding of K to the tile and of N to 128 lanes."""
    t = -(-pw.k // pw.tile_width)
    b = (pw.k * pw.n_cols + t * pw.n_cols * 2
         + (t * 4 if pw.gains is not None else 0)
         + m * pw.k * x_bytes + m * pw.n_cols * 2)
    return b, 2 * m * pw.k * pw.n_cols, EPILOGUE_FLOPS * m * t * pw.n_cols


def k3_cost(lengths, s_max: int, kh: int, h: int, d: int):
    """(bytes, f32 ops) of one decode-attention call for these lengths."""
    vis = sum(min(int(v), s_max) for v in lengths)
    rep = h // kh
    b = vis * kh * (2 * d + 2 * 2) + 2 * len(lengths) * h * d * 2 \
        + 4 * len(lengths)
    return b, vis * kh * rep * (4 * d + 6)


def k4_cost(m: int, k: int, n: int, tile: int, w_bytes: int = 2,
            x_bytes: int = 2):
    """(bytes, int8 ops, f32 ops) of one unpacked-matmul call: the float
    weight read once, activations in, bf16 out; the integer tile dots; the
    ADC epilogue per (row, K-tile, column) and the weight quantizer."""
    t = -(-k // tile)
    b = k * n * w_bytes + m * k * x_bytes + m * n * 2
    return (b, 2 * m * k * n,
            EPILOGUE_FLOPS * m * t * n + W_QUANT_FLOPS * k * n)


def k5_cost(b: int, sq: int, skv: int, h: int, kh: int, d: int,
            causal: bool, window: int, nbytes: int = 2):
    """(bytes, dot ops, softmax ops) of one flash-attention call: q, k, v
    read once, out written once; per visible (query, key) pair the two
    dots (4 D) and the softmax update (6)."""
    qpos = np.arange(sq)[:, None]
    kpos = np.arange(skv)[None, :]
    valid = np.ones((sq, skv), bool)
    if causal:
        valid &= kpos <= qpos
    if window > 0:
        valid &= kpos > qpos - window
    pairs = int(valid.sum()) * b * h
    return (2 * b * sq * h * d + 2 * b * skv * kh * d) * nbytes, \
        pairs * 4 * d, pairs * 6


def allclose_bar(got, want, what: str, rtol: float = 2 ** -7,
                 atol: float = 1e-5, quiet: bool = False) -> float:
    """Fail unless |got - want| <= atol + rtol |want| everywhere; return the
    max-abs difference."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    bad = int((d > atol + rtol * w.abs()).sum())
    err = float(d.max()) if d.numel() else 0.0
    if bad:
        fail(f"{what}: {bad}/{d.numel()} elements beyond rtol {rtol:g}, "
             f"atol {atol:g} (max-abs {err:.3g})")
    if not quiet:
        log(f"{what}: max-abs {err:.3g} (rtol {rtol:g}, atol {atol:g})")
    return err


def bound(nbytes: float, int8_ops: float = 0.0, f32_ops: float = 0.0,
          bf16_ops: float = 0.0):
    t = {"bytes": nbytes / HBM_BPS,
         "operations": max(int8_ops / INT8_OPS, f32_ops / F32_FLOPS,
                           bf16_ops / BF16_FLOPS)}
    by = max(t, key=t.get)
    return t[by] * 1e3, by


def sass_mma_counts(lib) -> dict:
    """{kernel function: (IMMA, HMMA) instruction counts} from cuobjdump's
    SASS of a built library."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    r = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        fail(f"cuobjdump -sass {lib}: {r.stderr.strip()[:500]}")
    counts, cur = {}, None
    for line in r.stdout.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            counts[cur] = [0, 0]
        elif cur is not None:
            counts[cur][0] += " IMMA" in line
            counts[cur][1] += " HMMA" in line
    return {k: tuple(v) for k, v in counts.items()}


def resource_usage(lib) -> dict:
    """{kernel function: {"REG", "STACK", "LOCAL", ...}} from cuobjdump's
    resource usage of a built library (registers per thread; stack and
    local bytes, where a register spill lands)."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    r = subprocess.run([tool, "-res-usage", str(lib)], capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        fail(f"cuobjdump -res-usage {lib}: {r.stderr.strip()[:500]}")
    out, cur = {}, None
    for line in r.stdout.splitlines():
        if "Function" in line:
            cur = line.split("Function")[1].strip(" :")
        elif cur is not None and "REG:" in line:
            out[cur] = {k: int(v) for k, v in
                        (f.split(":", 1) for f in line.split()
                         if ":" in f and f.split(":", 1)[1].isdigit())}
            cur = None
    return out


def in_turns(fns: dict, time_fn) -> dict:
    """Time each of ``fns`` twice, in the order a, b, ..., ..., b, a; returns
    {name: (first, second)}."""
    out = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        out[name].append(time_fn(fns[name]))
    return {name: tuple(v) for name, v in out.items()}


def profile_pass(dev, fn, what: str, cpu: bool = True):
    """A profiler breakdown of one call of ``fn`` on the card (measurement
    only): host time, device busy time, kernel launches, the top kernels
    by device time and the device time of the int64 elementwise kernels
    (their names carry ``long``: the threefry's adds, shifts, ors, xors
    and masks); host activity is recorded too with ``cpu``.  None where
    the profiler's own import or set-up fails (an error in ``fn`` fails
    the run)."""
    import torch
    if dev.type != "cuda":
        return None
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CUDA]
                       + ([ProfilerActivity.CPU] if cpu else []))
        prof.__enter__()
    except Exception as e:   # the profiler's own set-up only
        log(f"profiler unavailable: {e!r}")
        return None
    try:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
    finally:
        prof.__exit__(None, None, None)
    # Device time (us) and launches by kernel name from the raw events:
    # ``key_averages()`` builds the whole event tree first, which takes
    # tens of seconds for a pass of 100 k kernels.
    dt, cnt = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            dt[e.name()] = dt.get(e.name(), 0.0) + e.duration_ns() / 1e3
            cnt[e.name()] = cnt.get(e.name(), 0) + 1
    total = sum(dt.values())
    top = [(k[:60], round(dt[k] / 1e3, 4), cnt[k])
           for k in sorted(dt, key=lambda k: -dt[k])[:8]]
    i64 = sum(v for k, v in dt.items() if "long" in k)
    res = {"host_ms": host * 1e3, "device_busy_ms": total / 1e3,
           "kernels": sum(cnt.values()), "top": top, "int64_ms": i64 / 1e3}
    log(f"profile of one {what}: host {host * 1e3:.2f} ms, device busy "
        f"{total / 1e3:.3f} ms ({total / 1e3 / (host * 1e3):.1%}) in "
        f"{res['kernels']} kernel launches (int64 elementwise "
        f"{i64 / 1e3:.3f} ms); top by device ms: {json.dumps(top)}")
    return res


def replay_against_eager(geng, xeng, served, shapes, vocab: int, rng,
                         what: str) -> dict:
    """Every pass shape of ``shapes`` from the state ``served``, under two
    keys, by replay (``geng``, captured on a GPU) and eagerly (``xeng``),
    both overlapped (they sample on the device): the logits, the sampled
    tokens and the whole state bit-equal, the two keys' logits different.
    Returns each shape's input fields."""
    import torch

    from repro_torch.core import prng
    from repro_torch.serving.runners import state_tensors

    fields_of = {}
    for shape in shapes:
        width = 1 if shape[0] == "decode" else shape[1]
        fields_of[shape] = fields = dict(
            tokens=rng.integers(1, vocab, (CAPACITY, width)),
            n_tokens=np.array([width, max(1, width // 2), 1, 0]),
            prev_mask=np.zeros(CAPACITY, bool),
            temps=np.zeros(CAPACITY, np.float32),
            uids=np.arange(CAPACITY), idxs=np.arange(CAPACITY) + 3)
        lgs = []
        for t, key in enumerate(prng.split(prng.PRNGKey(SEED + 7), 2)):
            outs = []
            for e in (geng, xeng):
                for dst, src in zip(state_tensors(e.state), served):
                    dst.copy_(src)
                io, _ = e._call(shape, key, **fields)
                outs.append((io.logits.clone(), io.sampled.clone(),
                             [x.clone() for x in state_tensors(e.state)]))
            (lg, sg, stg), (le, se, ste) = outs
            if not torch.isfinite(lg).all():
                fail(f"{what}: non-finite logits in a replay of {shape}")
            if not (torch.equal(lg, le) and torch.equal(sg, se) and all(
                    torch.equal(a, b) for a, b in zip(stg, ste))):
                fail(f"{what} {shape} pass {t}: the replay differs from the "
                     f"eager pass")
            lgs.append(lg)
        if torch.equal(lgs[0], lgs[1]):
            fail(f"{what} {shape}: the two keys' logits are equal (frozen "
                 f"seeds?)")
        if geng.device.type == "cuda" and geng._passes[shape].graph is None:
            fail(f"{what}: {shape} was not captured")
    log(f"{what}: replay against eager for "
        f"{[''.join(str(p_) for p_ in s_) for s_ in shapes]}: two keys "
        f"each, logits, sampled tokens and the whole state bit-equal, the "
        f"keys' logits differ")
    return fields_of


def serve_in_turns(eager, fresh, requests, shapes, per_pass: dict,
                   what: str):
    """The served runs in turns (MOE_TURNS): ``eager`` the eager engine,
    ``fresh(**kw)`` a new engine for the graphs and overlapped runs (every
    shape of ``shapes`` captured and timed before the timed window),
    ``requests()`` the workload anew.  The launch counts are zeroed just
    before each run and read just after; every run finishes every request
    with the eager run's streams, launches every serving kernel, and each
    pass of each kind of ``per_pass`` launches exactly its counts.
    Returns (the runs by mode, the eager streams, the overlapped engine)."""
    import torch

    from repro_torch.kernels import ops

    want = geng = None
    runs = {m: [] for m in MOE_TURNS}
    for mode in MOE_TURNS:
        e = eager if mode == "eager" else fresh(
            **{"graphs": {}, "overlap": dict(clock=time.perf_counter,
                                             overlap=True)}[mode])
        capture = {}
        if mode != "eager":
            for k in shapes:
                t1 = time.perf_counter()
                e._executable(k)
                torch.cuda.synchronize()
                capture["".join(str(p_) for p_ in k)] = \
                    time.perf_counter() - t1
            e._warmed_shapes.clear()
        rs = requests()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        fin = e.run(rs)
        e.close()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = ops.launch_counts()
        if len(fin) != len(rs) or any(
                not r.done or len(r.generated) != r.max_new_tokens
                for r in fin):
            fail(f"{what} {mode}: {len(fin)} of {len(rs)} requests finished")
        streams = {r.uid: r.generated for r in fin}
        if want is None:
            want = streams
        elif streams != want:
            bad = [u for u in want if streams[u] != want[u]]
            fail(f"{what} {mode}: the streams of requests {bad} differ from "
                 f"the eager run's")
        for kind, want_ in per_pass.items():
            if not e.per_pass[kind]:
                fail(f"{what} {mode}: no {kind} pass ran")
            for got in e.per_pass[kind]:
                if {n: v for n, v in got.items() if v} != want_:
                    fail(f"{what} {mode}: a {kind} pass launched {got}, "
                         f"want {want_}")
        if any(counts[n] <= 0 for n in SERVE_KERNELS):
            fail(f"{what} {mode}: a serving kernel was not launched: "
                 f"{counts}")
        med, cnt = e.pass_stats()
        toks = sum(len(r.generated) for r in fin)
        r_ = {"wall_s": wall, "tokens": toks, "tokens_per_s": toks / wall,
              "decode_ms": med["decode"] * 1e3,
              "prefill_ms": med["prefill"] * 1e3, "passes": e.ticks,
              "passes_by_kind": cnt,
              "tick_utilization": e.metrics.tick_utilization()["value"],
              "launches": counts, "capture_s": capture}
        if "admit" in per_pass:
            r_["admissions"] = len(e.per_pass["admit"])
        runs[mode].append(r_)
        log(f"{what} serve [{mode}]: {len(fin)}/{len(rs)} requests, {toks} "
            f"tokens in {wall:.3f}s ({r_['tokens_per_s']:.1f} tokens/s), "
            f"decode tick median {r_['decode_ms']:.3f} ms, prefill pass "
            f"median {r_['prefill_ms']:.3f} ms ({cnt}), "
            + (f"{r_['admissions']} admissions, " if "admit" in per_pass
               else "")
            + f"tick_utilization {r_['tick_utilization']}, capture s "
            f"{capture}, launches {counts}")
        if mode == "overlap":
            geng = e
        elif e is not eager:
            del e
            gc.collect()
    return runs, want, geng


def run_train_driver(argv: list, arch: str):
    """``python -m repro_torch.launch.train --arch ARCH`` in this process,
    on the card, on TRAIN_BATCH x TRAIN_SEQ batches; its lines are logged,
    its losses and grad norms must be finite.  Returns (result, text)."""
    import io

    from repro_torch.launch import train as train_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = train_cli.main(argv + [
            "--arch", arch, "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--seed", str(SEED), "--device", "cuda"])
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  {line}")
    if not np.isfinite(res["losses"] + res["grad_norms"]).all():
        fail(f"non-finite loss or grad_norm in the driver run {argv}")
    return res, text


def qat_kernel_checks(dev, params, tm, dcfg, kq, per_step, keys, measured,
                      what, donate: bool = False, mesh=None) -> dict:
    """QAT in abfp_kernel mode through ``make_train_step`` (AdamW), one
    step per key of ``keys`` on the synthetic batches of ``dcfg``, the
    launch counts zeroed just before each step and read just after (each
    exactly ``per_step``; the STE backward launches none); then the loss
    and gradients on batch 0 / key 0 through the kernels and through the
    plain versions: the loss bit for bit (and equal to the first step's),
    the gradients within TRAIN_GRAD_RTOL.  ``measured(mode, fn)`` runs the
    steps under a peak-memory reading.  ``donate`` runs them in place on a
    copy of ``params`` (one optimizer state on the card).  ``mesh`` goes
    to ``make_train_step`` and the forwards (expert-parallel MoE layers).
    Returns step times, losses, counts, how many weights moved, and the
    comparison."""
    import torch
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.data import batch_at_step
    from repro_torch.kernels import ops
    from repro_torch.models import Numerics, forward
    from repro_torch.optim import AdamW, constant
    from repro_torch.training import (
        TrainConfig,
        chunked_cross_entropy,
        make_train_step,
    )
    from repro_torch.training.train_lib import tokens_on, value_and_grad

    init, step = make_train_step(tm, AdamW(constant(1e-4)),
                                 TrainConfig(quant=kq), device=dev,
                                 donate=donate, mesh=mesh)

    def qat_kernel_run():
        start = tree_map(torch.clone, params) if donate else params
        st, times, losses, counts = init(start), [], [], []
        for i, key in enumerate(keys):
            batch = batch_at_step(dcfg, i)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            st, met = step(st, batch, key)
            losses.append(float(met["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            counts.append(ops.launch_counts())
            if not np.isfinite(float(met["grad_norm"])):
                fail(f"{what}: non-finite grad_norm")
        moved = sum(not torch.equal(a, b)
                    for a, b in zip(leaves(st.params), leaves(params)))
        return times, losses, counts, moved

    times, k_losses, counts, moved = measured("qat_abfp_kernel",
                                              qat_kernel_run)
    gc.collect()
    torch.cuda.empty_cache()
    for c in counts:
        if c != per_step:
            fail(f"{what}: an abfp_kernel QAT step launched {c}, expected "
                 f"{per_step}")
    if not np.isfinite(k_losses).all():
        fail(f"{what}: non-finite abfp_kernel QAT losses {k_losses}")
    log(f"{what}: QAT abfp_kernel (make_train_step, tile 128, gain 8, noise "
        f"0.5): losses {k_losses}, step {[round(t, 4) for t in times]} s, "
        f"kernel 4 launched {[c['abfp_matmul'] for c in counts]} times per "
        f"step, {moved}/{len(leaves(params))} weights moved")

    tokens = tokens_on(batch_at_step(dcfg, 0), dev)

    def loss_fn(plain):
        def fn(tree, toks, key):
            nx = Numerics(kq, key, plain=plain)
            hidden, aux = forward(tree, toks[:, :-1], tm, nx, mesh=mesh,
                                  return_hidden=True)
            loss = chunked_cross_entropy(tree, hidden, toks[:, 1:], tm, nx)
            return loss, loss, aux
        return fn

    ops.reset_launch_counts()
    lk, _, gk = value_and_grad(loss_fn(False), params, tokens, keys[0])
    if ops.launch_counts() != per_step:
        fail(f"{what}: the kernels' loss and gradients launched "
             f"{ops.launch_counts()}, expected {per_step}")
    ops.reset_launch_counts()
    lp, _, gp = value_and_grad(loss_fn(True), params, tokens, keys[0])
    if sum(ops.launch_counts().values()):
        fail(f"{what}: the plain versions' loss launched a kernel")
    if not torch.equal(lk, lp) or float(lk) != k_losses[0]:
        fail(f"{what}: QAT abfp_kernel loss through the kernels "
             f"{float(lk)!r}, plain versions {float(lp)!r}, train step "
             f"{k_losses[0]!r}")
    exact, grad_err = 0, 0.0
    for a, b in zip(leaves(gk), leaves(gp)):
        exact += int(torch.equal(a, b))
        grad_err = max(grad_err, allclose_bar(
            a, b, f"{what}: QAT abfp_kernel gradient, kernels vs plain "
            f"versions", rtol=TRAIN_GRAD_RTOL, atol=1e-6, quiet=True))
    log(f"{what}: QAT abfp_kernel on batch 0: loss {float(lk)!r} through the "
        f"kernels = plain versions = the train step's, bit for bit; "
        f"gradients: {exact}/{len(leaves(gk))} leaves bit-equal, max-abs "
        f"{grad_err:.3g} (bar rtol {TRAIN_GRAD_RTOL:g})")
    del gk, gp
    gc.collect()
    torch.cuda.empty_cache()
    return {"steps_s": times, "losses": k_losses, "counts": counts,
            "moved": moved, "qat_kernel_loss": float(lk),
            "grad_leaves_equal": exact, "grad_leaves": len(leaves(params)),
            "grad_max_abs": grad_err}


def train_phase(dev, params, rows: list) -> dict:
    """Phase 10: the training path on full smollm-360m (see the module
    docstring).  ``params`` are full smollm-360m's bf16 parameters from
    seed SEED; ``rows`` the kernel line's rows (kernel 4's gains its
    launches per QAT step).  Returns the phase's measurements."""
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.core.abfp import (
        QuantConfig,
        dequantize_packed,
        pack_abfp_weight,
    )
    from repro_torch.core.dnf import select_layers_by_std
    from repro_torch.core.tree import leaves
    from repro_torch.data import DataConfig, batch_at_step
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.optim import AdamW, constant
    from repro_torch.training import (
        TrainConfig,
        capture_histograms,
        make_train_step,
    )
    from repro_torch.training.finetune import make_dnf_train_step
    from repro_torch.training.train_lib import tokens_on

    tm = get_config("smollm-360m")
    if (tm.num_layers, tm.d_model, tm.vocab_size, tm.param_dtype,
            tm.remat) != (32, 960, 49152, torch.bfloat16, False):
        fail(f"unexpected training config {tm}")
    nl = tm.num_layers
    dcfg = DataConfig(tm.vocab_size, TRAIN_SEQ, TRAIN_BATCH, SEED)
    kq = QuantConfig(mode="abfp_kernel", tile_width=128, gain=8.0,
                     noise_lsb=0.5)
    out = {"steps_s": {}, "peak_gib": {}}

    def measured(mode, fn):
        """Run ``fn`` with the peak-memory counter reset just before."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = fn()
        torch.cuda.synchronize()
        out["peak_gib"][mode] = torch.cuda.max_memory_allocated() / 2 ** 30
        return res

    def driver(argv):
        return run_train_driver(argv, "smollm-360m")

    laps = [time.perf_counter()]

    def lap(what):
        """Log the seconds since the previous lap (the phase's own budget)."""
        laps.append(time.perf_counter())
        out.setdefault("laps_s", {})[what] = laps[-1] - laps[-2]
        log(f"phase 10 {what}: {laps[-1] - laps[-2]:.1f}s")

    def steady(times):
        """Median step time past the first step (warm-up) of a run."""
        return statistics.median(times[1:] if len(times) > 1 else times)

    # 10a. The float driver, 4 steps with checkpoints every 2, then resumed
    # to 6 steps: it must restore step 4.
    ck = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        f1, _ = measured("float", lambda: driver(
            ["--steps", "4", "--ckpt-every", "2", "--ckpt-dir", ck]))
        f2, text = driver(["--steps", "6", "--ckpt-every", "2",
                           "--ckpt-dir", ck])
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    if "[train] resumed from step 4" not in text or f2["start_step"] != 4 \
            or len(f2["losses"]) != 2:
        fail("the float driver did not resume from step 4")
    out["steps_s"]["float"] = f1["step_s"][1:] + f2["step_s"][1:]
    del f1, f2
    lap("float driver and resume")

    # 10b. QAT through the abfp_ref tile scan: the driver's --quant qat, 2
    # steps; every weight must have moved (a gradient reached it).
    q, _ = measured("qat_abfp_ref", lambda: driver(
        ["--steps", "2", "--quant", "qat"]))
    fresh = init_params(SEED, tm, device=dev)
    still = [i for i, (a, b) in enumerate(zip(leaves(q["state"].params),
                                              leaves(fresh)))
             if torch.equal(a, b)]
    if still:
        fail(f"QAT abfp_ref: {len(still)} weights did not move (leaves "
             f"{still[:8]})")
    out["steps_s"]["qat_abfp_ref"] = q["step_s"]
    del q, fresh
    lap("QAT abfp_ref driver")

    # 10c. QAT through kernel 4 (abfp_kernel) with make_train_step, 2 steps,
    # the launch counts zeroed just before each step and read just after;
    # the loss and gradients on batch 0 / key 0 against the plain versions.
    per_step = {name: 0 for name in ops.launch_counts()}
    per_step["abfp_matmul"] = 7 * nl + 1
    keys = [prng.fold_in(prng.PRNGKey(SEED + 1), i) for i in range(2)]
    qk = qat_kernel_checks(dev, params, tm, dcfg, kq, per_step, keys,
                           measured, "phase 10c")
    out["steps_s"]["qat_abfp_kernel"] = qk.pop("steps_s")
    counts = qk.pop("counts")
    for k in ("moved", "losses"):
        qk.pop(k)
    out.update(qk)
    tokens = tokens_on(batch_at_step(dcfg, 0), dev)
    lap("QAT abfp_kernel steps and the plain comparison")

    # 10d. Kernel 1 under the dense_packed straight-through Function, at
    # one layer's MLP input weight and M = TRAIN_BATCH x TRAIN_SEQ.
    pq = QuantConfig(mode="abfp_fused", tile_width=128, gain=8.0,
                     noise_lsb=0.5)
    pw = pack_abfp_weight(params["layers"][0]["mlp"]["wi"], pq,
                          adaptive_gain=True)
    gen = torch.Generator(device=dev).manual_seed(10)
    m = TRAIN_BATCH * TRAIN_SEQ
    x0 = torch.randn(m, tm.d_model, generator=gen, device=dev).to(
        torch.bfloat16)
    g = torch.randn(m, tm.d_ff, generator=gen, device=dev).to(torch.bfloat16)
    res = []
    for plain in (False, True):
        x = x0.clone().requires_grad_(True)
        ops.reset_launch_counts()
        y = ops.dense_packed(x, pw, pq, 4321, plain=plain)
        y.backward(g)
        torch.cuda.synchronize()
        if ops.launch_counts()["abfp_matmul_packed"] != (0 if plain else 1):
            fail(f"dense_packed STE launched {ops.launch_counts()}")
        res.append((y.detach(), x.grad))
    n, size, ulp, _ = bf16_diff(res[0][0], res[1][0])
    want_dx = (g.float() @ dequantize_packed(pw).t()).to(torch.bfloat16)
    if ulp or not torch.equal(res[0][1], res[1][1]) \
            or not torch.equal(res[0][1], want_dx):
        fail(f"kernel 1 under the dense_packed STE: output {n}/{size} "
             f"differ, dx equal {torch.equal(res[0][1], res[1][1])}")
    log(f"kernel 1 under the dense_packed STE Function, {tuple(pw.codes.shape)}"
        f" at M={m}: output and dx bit-equal to the plain version's")
    del res, x0, g, pw
    lap("kernel 1 under the STE")

    # 10e. DNF: histograms from one training batch in abfp_kernel mode, the
    # top half of the layers by std, 3 DNF steps.
    ops.reset_launch_counts()
    hists, stds = capture_histograms(params, tokens[:, :-1], tm, kq,
                                     key=prng.fold_in(prng.PRNGKey(SEED), 11))
    cap = ops.launch_counts()["abfp_matmul"]
    mask = select_layers_by_std([hists.layer(i) for i in range(nl)], 0.5)
    if len(stds) != nl or not np.isfinite(stds).all() or sum(mask) < nl // 2:
        fail(f"DNF capture: stds {stds}, mask {mask}")
    dinit, dstep = make_dnf_train_step(tm, AdamW(constant(1e-4)), hists,
                                       layer_mask=mask, device=dev)

    def dnf_run():
        st, times, losses = dinit(params), [], []
        for i in range(3):
            batch = batch_at_step(dcfg, i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, met = dstep(st, batch, prng.fold_in(prng.PRNGKey(SEED + 2),
                                                   i))
            losses.append(float(met["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return times, losses

    times, d_losses = measured("dnf", dnf_run)
    if not np.isfinite(d_losses).all():
        fail(f"non-finite DNF losses {d_losses}")
    out["steps_s"]["dnf"] = times
    log(f"DNF: capture on one batch (kernel 4 x {cap}), noise on layers "
        f"{[i for i, v in enumerate(mask) if v]}, 3 steps: losses "
        f"{d_losses}, step {[round(t, 4) for t in times]} s")
    lap("DNF capture and steps")

    # 10f. Where a step's time goes: one profiled step of float, QAT
    # abfp_kernel and QAT abfp_ref through make_train_step, each mode
    # already warm from the runs above, device activity only (measurement
    # only; the profiler's own set-up may fail and is then skipped).
    batch = batch_at_step(dcfg, 0)
    for mode in ("float", "abfp_kernel", "abfp_ref"):
        quant = kq.replace(mode=mode)
        pinit, pstep = make_train_step(tm, AdamW(constant(1e-4)),
                                       TrainConfig(quant=quant), device=dev)
        st = pinit(params)
        torch.cuda.synchronize()
        res = profile_pass(dev, lambda: pstep(st, batch, keys[0]),
                           f"{mode} train step", cpu=False)
        del st
        if res is None:
            break
        out.setdefault("profile", {})[mode] = {
            k: res[k] for k in ("host_ms", "device_busy_ms", "kernels")}
    lap("profiles")

    # 10g. Step times and peak memory of each mode.
    med = {k: steady(v) for k, v in out["steps_s"].items()}
    out["step_median_ms"] = {k: v * 1e3 for k, v in med.items()}
    out["dnf_over_qat_abfp_ref"] = med["dnf"] / med["qat_abfp_ref"]
    for k in med:
        log(f"train step {k}: median {med[k] * 1e3:.2f} ms (steps "
            f"{[round(t * 1e3, 2) for t in out['steps_s'][k]]} ms), peak "
            f"device memory {out['peak_gib'][k]:.3f} GiB")
    log(f"DNF step time / QAT abfp_ref step time: "
        f"{out['dnf_over_qat_abfp_ref']:.4f} (QAT / DNF "
        f"{1 / out['dnf_over_qat_abfp_ref']:.2f}x)")
    for row in rows:
        if row["name"] == "abfp_matmul":
            row["launches_per_qat_step"] = per_step["abfp_matmul"]
            row["qat_step_launches"] = [c["abfp_matmul"] for c in counts]
    ops.reset_launch_counts()
    return out


def paged_phase(dev, engine_cls, params, mcfg, quant, reqs, want_streams,
                rows: list) -> dict:
    """Phase 11: the paged, overload-controlled serving path on the served
    model (see the module docstring).  ``engine_cls`` is the NaN-checking
    engine of phase 4, ``params`` its packed weights, ``reqs`` and
    ``want_streams`` phase 4's workload and unpaged streams.  Annotates
    kernel rows with this path's launches; returns the measurements."""
    import torch

    from repro_torch.core import prng
    from repro_torch.kernels import ops
    from repro_torch.kernels.abfp_decode_fused import (
        quantized_decode_attention,
    )
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import layers as model_layers
    from repro_torch.serving import Request

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def engine(**kw):
        return engine_cls(params, mcfg, capacity=CAPACITY, max_len=MAX_LEN,
                          quant=quant, seed=SEED, device=dev, paged=True,
                          **kw)

    def live_state(state):
        """Every state tensor, the pools without their scratch page (it
        takes the dropped writes, in no defined order)."""
        return [t[:-1] if n.endswith("_pages") else t
                for layer in state["layers"] for n, t in layer["kv"].items()
                ] + [state["position"], state["page_table"]]

    def launched(counts, what):
        """The paged path runs kernel 1 only: its projections take the
        packed chain and its attention the plain version on the page view,
        as the JAX package's paged path does."""
        if counts["abfp_matmul_packed"] <= 0:
            fail(f"{what}: kernel 1 was not launched")
        other = {k: v for k, v in counts.items()
                 if k != "abfp_matmul_packed" and v}
        if other:
            fail(f"{what}: the paged path launched {other}")

    out = {}
    t_phase = time.perf_counter()
    wall = dict(clock=time.perf_counter, overlap=True)

    # 11a. Replay against eager: one prefill pass and one decode tick, by
    # replay and eagerly, each under two keys and two page tables, from
    # the same (fresh) state.
    geng, xeng = engine(pool_pages=PAGED_POOL, **wall), engine(
        pool_pages=PAGED_POOL, _graphs=False, **wall)
    if geng.page_size != quant.tile_width or geng.max_pages != 4:
        fail(f"paged engine: page size {geng.page_size}, "
             f"{geng.max_pages} pages per slot")
    s_ = PAGED_POOL
    tables = (np.array([[3, 7, 12, s_], [0, s_, s_, s_], [1, 2, s_, s_],
                        [s_, s_, s_, s_]], np.int32),
              np.array([[3, 7, 12, s_], [0, 14, s_, s_], [1, 2, 9, s_],
                        [5, s_, s_, s_]], np.int32))
    rng11 = np.random.default_rng(SEED + 11)
    for shape in (("prefill", 128), ("decode",)):
        width = 1 if shape[0] == "decode" else shape[1]
        fields = dict(
            tokens=rng11.integers(1, mcfg.vocab_size, (CAPACITY, width)),
            n_tokens=np.array([width, width // 2, 1, 0]),
            prev_mask=np.zeros(CAPACITY, bool),
            temps=np.zeros(CAPACITY, np.float32),
            uids=np.arange(CAPACITY), idxs=np.zeros(CAPACITY))
        lgs = []
        for t, (key, table) in enumerate(zip(
                prng.split(prng.PRNGKey(SEED + 11), 2), tables)):
            got = []
            for e in (geng, xeng):
                e._table[:] = table
                io, _ = e._call(shape, key, **fields)
                got.append((io.logits.clone(), io.sampled.clone()))
            sync()
            (lg, sg), (le, se) = got
            if not torch.isfinite(lg).all():
                fail(f"non-finite logits in a paged {shape} replay")
            if not (torch.equal(lg, le) and torch.equal(sg, se)):
                fail(f"paged {shape} pass {t}: replay differs from the "
                     f"eager pass ({int((lg != le).sum())} logits)")
            if not all(torch.equal(a, b) for a, b in zip(
                    live_state(geng.state), live_state(xeng.state))):
                fail(f"paged {shape} pass {t}: the replay's state "
                     f"differs from the eager pass's")
            lgs.append(lg)
        if torch.equal(lgs[0], lgs[1]):
            fail(f"paged {shape}: the two keys' logits are equal")
        if dev.type == "cuda" and geng._passes[shape].graph is None:
            fail(f"paged {shape} was not captured")
    out["decode_replay_profile"] = profile_pass(
        dev, lambda: geng._call(("decode",), prng.PRNGKey(SEED + 13),
                                **fields), "paged decode tick (graph replay)")
    geng.close()
    xeng.close()
    del geng, xeng
    log("paged replay against eager for prefill128 and decode: two keys "
        "and two page tables each, logits, sampled tokens and the state "
        "(pools but their scratch page, lengths, table) bit-equal, the "
        "keys' logits differ")

    # The phase-4 workload on a roomy pool (the unpaged footprint), eager
    # then with graphs twice; launch counts zeroed just before each run
    # and read just after.
    def closed(mode):
        e = engine(pool_pages=PAGED_POOL,
                   **({"_graphs": False} if mode == "eager" else {}))
        e.warmup()
        sync()
        rs = [Request(uid=r.uid, prompt=list(r.prompt),
                      max_new_tokens=MAX_NEW) for r in reqs]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        fin = e.run(rs)
        e.close()
        sync()
        wall_ = time.perf_counter() - t0
        counts = ops.launch_counts()
        launched(counts, f"paged {mode} serve")
        cons = e.metrics.conservation()
        if len(fin) != N_REQUESTS or not all(
                r.done and len(r.generated) == MAX_NEW for r in fin):
            fail(f"paged {mode} serve: {len(fin)} of {N_REQUESTS} finished")
        if not cons["ok"] or e.pool.stats().held:
            fail(f"paged {mode} serve: conservation {cons}, "
                 f"{e.pool.stats().held} pages held after drain")
        med, cnt = e.pass_stats()
        res = {"streams": {r.uid: r.generated for r in fin},
               "launches": counts, "wall_s": wall_,
               "tokens_per_s": N_REQUESTS * MAX_NEW / wall_,
               "decode_ms": med["decode"] * 1e3,
               "prefill_ms": med["prefill"] * 1e3, "passes": cnt,
               "per_pass": {k: sorted({r_["abfp_matmul_packed"]
                                       for r_ in v})
                            for k, v in e.per_pass.items()},
               "cached_pages": e.pool.stats().cached}
        log(f"paged serve [{mode}] {N_REQUESTS * MAX_NEW} tokens in "
            f"{wall_:.3f}s: {res['tokens_per_s']:.1f} tokens/s, decode tick "
            f"median {res['decode_ms']:.3f} ms, prefill pass median "
            f"{res['prefill_ms']:.3f} ms ({cnt}), kernel 1 launches per "
            f"pass {res['per_pass']}, launch counts {counts}, 0 pages held "
            f"after drain ({res['cached_pages']} cached)")
        del e
        gc.collect()
        return res

    runs = [closed(m) for m in ("eager", "graphs", "graphs")]
    for r_ in runs[1:]:
        bad = [u for u, s in runs[0]["streams"].items()
               if r_["streams"][u] != s]
        if bad:
            fail(f"paged graphs serve: the streams of requests {bad} differ "
                 f"from the paged eager run's")
    same = sum(runs[0]["streams"][u] == s for u, s in want_streams.items())
    # The unpaged engine with kernel 3's plain version (the attention the
    # paged path runs) must give the paged streams: the paging itself
    # changes no number.
    e = engine_cls(params, mcfg, capacity=CAPACITY, max_len=MAX_LEN,
                   quant=quant, seed=SEED, device=dev, _graphs=False)
    real = model_layers.fused_quantized_decode_attention
    model_layers.fused_quantized_decode_attention = \
        quantized_decode_attention
    try:
        fin = e.run([Request(uid=r.uid, prompt=list(r.prompt),
                             max_new_tokens=MAX_NEW) for r in reqs])
    finally:
        model_layers.fused_quantized_decode_attention = real
    bad = [r.uid for r in fin if r.generated != runs[0]["streams"][r.uid]]
    if bad or len(fin) != N_REQUESTS:
        fail(f"the unpaged engine with kernel 3's plain version differs "
             f"from the paged streams in requests {bad}")
    del e
    log(f"paged graphs streams equal the paged eager streams 8/8, and the "
        f"unpaged eager engine's with kernel 3's plain version 8/8; {same}/8"
        f" equal phase 4's unpaged streams (kernel 3's one-ULP flips part "
        f"a stream)")
    out["closed"] = {"eager": {k: v for k, v in runs[0].items()
                               if k != "streams"},
                     "graphs": [{k: v for k, v in r_.items()
                                 if k != "streams"} for r_ in runs[1:]],
                     "streams_equal_unpaged": same}
    serve_launches = runs[1]["launches"]

    # 11b. Overload: a tight pool, priorities, two tenants with a quota, a
    # queue watermark and deadlines, overlapped on the wall clock.  The
    # client submits each request when it arrives (so the watermark
    # applies); arrivals are OVERLOAD_GAP_S apart after the first burst.
    rng = np.random.default_rng(SEED + 12)
    plan = []
    for i in range(OVERLOAD_REQUESTS):
        plen = int(rng.integers(160, 381))
        plan.append(dict(uid=i, prompt=rng.integers(
            1, mcfg.vocab_size, plen).tolist(), max_new_tokens=24,
            priority=int(rng.integers(0, 3)), tenant=f"t{i % 2}",
            at=0.0 if i < OVERLOAD_BURST else
            (i - OVERLOAD_BURST + 1) * OVERLOAD_GAP_S))
    e = engine(pool_pages=8, policy="priority", tenant_quota=6,
               queue_watermark=6, **wall)
    e.warmup()
    sync()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pending, submitted, returned = list(plan), [], []
    while pending or len(e.scheduler) or any(
            s is not None for s in e.slots) or e._returned or \
            e._stream.pending() or e._delivered:
        now = time.perf_counter() - t0
        while pending and pending[0]["at"] <= now:
            p = pending.pop(0)
            r = Request(uid=p["uid"], prompt=p["prompt"],
                        max_new_tokens=p["max_new_tokens"],
                        priority=p["priority"], tenant=p["tenant"])
            if p["uid"] % 3 == 0:
                r.deadline = time.perf_counter() + OVERLOAD_DEADLINE_S
            e.submit(r)
            submitted.append(r)
        returned.extend(e.poll())
        if pending and not any(s is not None for s in e.slots):
            time.sleep(0.001)
    e.close()
    sync()
    wall_b = time.perf_counter() - t0
    counts_b = ops.launch_counts()
    launched(counts_b, "overload serve")
    cons = e.metrics.conservation()
    s = e.metrics.summary()
    fin = [r for r in submitted if r.done and not r.shed
           and not r.timed_out]
    shed = [r for r in submitted if r.shed]
    tout = [r for r in submitted if r.timed_out]
    if not (cons["ok"] and cons["preempt_ok"]):
        fail(f"overload serve: conservation {cons}")
    if cons["preempted"] <= 0:
        fail("overload serve: nothing was preempted (the pool did not "
             "saturate)")
    if len(fin) + len(shed) + len(tout) != OVERLOAD_REQUESTS or any(
            r.retry_after is None for r in shed):
        fail(f"overload serve: {len(fin)} finished, {len(shed)} shed, "
             f"{len(tout)} timed out of {OVERLOAD_REQUESTS}")
    if any(not r.generated for r in fin):
        fail("overload serve: a finished request has no tokens")
    if sorted(r.uid for r in returned) != sorted(r.uid for r in submitted):
        fail("overload serve: poll() did not return every request once")
    pool = s["pool"]
    med, cnt = e.pass_stats()
    out["overload"] = {
        "wall_s": wall_b, "finished": len(fin), "shed": len(shed),
        "timed_out": len(tout), "preempted": cons["preempted"],
        "resumed": cons["resumed"],
        "pressure_mean": pool["pressure_mean"],
        "pressure_max": pool["pressure_max"],
        "prefix_hits": pool["prefix_hits"], "cow_copies": pool["cow_copies"],
        "degraded_ticks": pool["degraded_ticks"], "passes": cnt,
        "decode_ms": med["decode"] and med["decode"] * 1e3,
        "prefill_ms": med["prefill"] and med["prefill"] * 1e3,
        "launches": counts_b,
        "retry_after_s": [r.retry_after - (r.arrival_time or 0.0)
                          for r in shed]}
    log(f"overload serve ({OVERLOAD_REQUESTS} requests, prompts "
        f"{min(len(p['prompt']) for p in plan)}-"
        f"{max(len(p['prompt']) for p in plan)} tokens, 24 new, pool 8 "
        f"pages, priority policy, 2 tenants with quota 6, watermark 6, "
        f"deadlines {OVERLOAD_DEADLINE_S}s on a third; overlapped, wall "
        f"clock) in {wall_b:.3f}s: {len(fin)} finished, {len(shed)} shed "
        f"(retry_after "
        f"{[round(v, 4) for v in out['overload']['retry_after_s']]} s "
        f"ahead), {len(tout)} timed out, {cons['preempted']} preemptions, "
        f"{cons['resumed']} resumes, pool pressure mean "
        f"{pool['pressure_mean']:.3f} / max {pool['pressure_max']:.3f}, "
        f"degraded ticks {pool['degraded_ticks']}, passes {cnt}, launch "
        f"counts {counts_b}; conservation ok, preempt_ok")
    del e
    gc.collect()

    # 11c. Open loop: Poisson arrivals through the CLI's workload on the
    # wall clock, paged and overlapped.
    args = serve_cli.build_parser().parse_args(
        ["--requests", str(OPEN_REQUESTS), "--arrival-rate",
         str(OPEN_RATE), "--prompt-len", str(OPEN_PROMPT_LEN), "--max-new",
         str(MAX_NEW), "--tenants", "2", "--seed", str(SEED)])
    reqs_c = serve_cli.poisson_workload(mcfg, args,
                                        np.random.default_rng(SEED))
    e = engine(**wall)
    e.warmup()
    sync()
    base = time.perf_counter()
    for r in reqs_c:
        r.arrival_time = base + r.arrival_time
        e.submit(r)
    ops.reset_launch_counts()
    done_c = e.drain()
    e.close()
    sync()
    wall_c = time.perf_counter() - base
    counts_c = ops.launch_counts()
    launched(counts_c, "open-loop serve")
    s = e.metrics.summary()
    if len(done_c) != OPEN_REQUESTS or not e.metrics.conservation()["ok"]:
        fail(f"open-loop serve: {len(done_c)} of {OPEN_REQUESTS} returned")
    tu = e.metrics.tick_utilization()
    good = e.metrics.goodput(OPEN_SLO_TTFT_S)
    out["open_loop"] = {
        "rate_per_s": OPEN_RATE, "wall_s": wall_c,
        "ttft_s": s["ttft"], "tpot_s": s["tpot"], "e2e_s": s["e2e"],
        "goodput_per_s": good, "slo_ttft_s": OPEN_SLO_TTFT_S,
        "tick_utilization": tu["value"],
        "max_queue_depth": s["queue_depth"]["max"],
        "preempted": s["requests"]["preempted"], "launches": counts_c}
    log(f"open-loop serve ({OPEN_REQUESTS} Poisson arrivals at {OPEN_RATE} "
        f"requests/s over "
        f"{reqs_c[-1].arrival_time - reqs_c[0].arrival_time:.3f}s, prompts "
        f"1-{2 * OPEN_PROMPT_LEN - 1} tokens, {MAX_NEW} new, paged, "
        f"overlapped) in {wall_c:.3f}s: TTFT p50 {s['ttft']['p50']:.4f} / "
        f"p99 {s['ttft']['p99']:.4f} s, TPOT p50 {s['tpot']['p50']:.4f} / "
        f"p99 {s['tpot']['p99']:.4f} s, E2E p50 {s['e2e']['p50']:.4f} / p99 "
        f"{s['e2e']['p99']:.4f} s, goodput {good:.3f} requests/s (TTFT <= "
        f"{OPEN_SLO_TTFT_S} s), tick_utilization {tu['value']:.4f}, max "
        f"queue depth {s['queue_depth']['max']}, {s['requests']['preempted']}"
        f" preemptions, launch counts {counts_c}")
    del e
    gc.collect()

    for row in rows:
        name = row["name"]
        row["launches_paged_serve"] = serve_launches.get(name, 0)
        row["launches_overload_serve"] = counts_b.get(name, 0)
        row["launches_open_loop_serve"] = counts_c.get(name, 0)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def fault_phase(dev, engine_cls, params, mcfg, quant, reqs, want_streams,
                graph_launches, graph_decode_ms, card, rows: list) -> dict:
    """Phase 12: fault injection, detection and recovery on the served
    model (see the module docstring).  ``engine_cls`` is the NaN-checking
    engine of phase 4, ``params`` its packed weights (shared, tensor for
    tensor, by every engine built from them: each fault run restores them
    from a clean copy and checks them byte for byte), ``reqs`` and
    ``want_streams`` phase 4's workload and streams, ``graph_launches``
    and ``graph_decode_ms`` phase 4b's graph run's launch counts and
    decode-tick medians.  Annotates kernel rows with this path's launches;
    returns the measurements."""
    import torch

    from repro_torch.core.abfp import kernel_layout
    from repro_torch.kernels import ops
    from repro_torch.kernels.abfp_decode_fused import (
        concat_qkv,
        fused_qkv_packed,
        fused_qkv_packed_ref,
    )
    from repro_torch.kernels.abfp_matmul import (
        DECODE_ROWS,
        abfp_matmul_packed,
        abfp_matmul_packed_ref,
        fused_rows,
    )
    from repro_torch.serving import FaultConfig, FaultPlan, Request
    from repro_torch.serving import faults as faultlib
    from repro_torch.serving.faults import FaultEvent

    out = {}
    t_phase = time.perf_counter()
    sites = faultlib.fault_sites(params)
    if [s_.path for s_ in sites] != [
            "groups/0/attn/wk", "groups/0/attn/wo", "groups/0/attn/wq",
            "groups/0/attn/wv", "groups/0/mlp/wg", "groups/0/mlp/wi",
            "groups/0/mlp/wo", "lm_head"]:
        fail(f"fault sites {[s_.path for s_ in sites]}")
    golden = faultlib.clone_sites(params)
    torch.cuda.synchronize()

    def i16(t):
        return t.view(torch.int16)

    def check_copies(p, what, against_golden=True):
        """All three copies of every packed weight agree (``kcodes ==
        kernel_layout(codes)``, each ``PackedQKV`` a fresh ``concat_qkv``
        of its pieces) and, with ``against_golden``, equal the clean copy
        byte for byte."""
        for site in sites:
            for a, b in zip(faultlib.site_leaves(p, site.path),
                            faultlib.site_leaves(golden, site.path)):
                if not torch.equal(a.kcodes, kernel_layout(a.codes)):
                    fail(f"{what}: {site.path} kcodes differ from the "
                         f"kernel layout of its codes")
                if against_golden and not (
                        torch.equal(a.codes, b.codes)
                        and torch.equal(a.kcodes, b.kcodes)
                        and torch.equal(i16(a.scales), i16(b.scales))):
                    fail(f"{what}: {site.path} differs from the clean copy")
        for la, lb in zip(p["layers"], golden["layers"]):
            at = la["attn"]
            qa, qb = at["qkv"], lb["attn"]["qkv"]
            fresh = concat_qkv((at["wq"], at["wk"], at["wv"]), quant)
            if not (torch.equal(qa.kcodes, fresh.kcodes)
                    and torch.equal(i16(qa.scales), i16(fresh.scales))):
                fail(f"{what}: a PackedQKV differs from its pieces")
            if against_golden and not (
                    torch.equal(qa.kcodes, qb.kcodes)
                    and torch.equal(i16(qa.scales), i16(qb.scales))):
                fail(f"{what}: a PackedQKV differs from the clean copy")

    # 12a. The faulted operands at the kernels: kernel 2 at decode size
    # and kernel 1 at M = 512 on layer 0's faulted projections.
    lp0 = params["layers"][0]
    pws = tuple(lp0["attn"][w] for w in ("wq", "wk", "wv"))
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    x4 = torch.randn(CAPACITY, mcfg.d_model, generator=gen,
                     device=dev).to(torch.bfloat16)
    x512 = torch.randn(512, mcfg.d_model, generator=gen,
                       device=dev).to(torch.bfloat16)
    nj, nt = pws[0].n_padded // 128, pws[0].num_tiles
    if fused_rows(CAPACITY, quant.tile_width, nj, quant, nt) != DECODE_ROWS \
            or fused_rows(512, quant.tile_width, nj, quant,
                          nt) == DECODE_ROWS:
        fail("phase 12a: kernel 2 at M=4 or kernel 1 at M=512 takes "
             "another route")

    def exact(got, want, what):
        n, size, ulp, _ = bf16_diff(got, want)
        if n or ulp or not torch.equal(got, want):
            fail(f"{what}: {n}/{size} flips against its plain version")

    def kernels(what):
        q = fused_qkv_packed(x4, pws, quant, (12, -13, 14),
                             qkv=lp0["attn"]["qkv"])
        for g, w, n in zip(q, fused_qkv_packed_ref(x4, pws, quant,
                                                   (12, -13, 14)), "qkv"):
            exact(g, w, f"kernel 2 ({n}, M={CAPACITY}) {what}")
        k1 = {}
        for n in ("wq", "wv"):
            k1[n] = abfp_matmul_packed(x512, lp0["attn"][n], quant, 21)
            exact(k1[n], abfp_matmul_packed_ref(x512, lp0["attn"][n], quant,
                                                21),
                  f"kernel 1 (attn.{n}, M=512) {what}")
        torch.cuda.synchronize()
        return q, k1

    pre_q, pre_k1 = kernels("before the faults")
    base = faultlib.fingerprint_round(params, sites)
    stuck = FaultEvent(0, "stuck_col", "groups/0/attn/wq", cols=(7, 700))
    drift = FaultEvent(0, "scale_drift", "groups/0/attn/wv",
                       tiles=((0, 11), (5, 300)), factors=(1.2, 0.8))
    for ev in (stuck, drift):
        faultlib.apply_event(params, ev)
    torch.cuda.synchronize()
    check_copies(params, "after the injections", against_golden=False)
    q, k1 = kernels("on the faulted weights")
    cols, dcols = list(stuck.cols), [j for _, j in drift.tiles]
    if q[0][:, cols].float().abs().max() != 0 or \
            k1["wq"][:, cols].float().abs().max() != 0:
        fail("phase 12a: a stuck column does not read 0.0 at the kernels")
    if not (pre_q[0][:, cols].float().abs().max() > 0
            and pre_k1["wq"][:, cols].float().abs().max() > 0):
        fail("phase 12a: the stuck columns read 0.0 before the fault")
    if torch.equal(q[2][:, dcols], pre_q[2][:, dcols]) or any(
            torch.equal(k1["wv"][:, j], pre_k1["wv"][:, j]) for j in dcols):
        fail("phase 12a: the drifted tiles did not reach the kernels")
    t0 = time.perf_counter()
    cur = faultlib.fingerprint_round(params, sites)
    dets = {s_.path: faultlib.detect_site(base[s_.path], cur[s_.path])
            for s_ in sites}
    t_first = time.perf_counter() - t0
    hits = {k: (d.stuck_cols, d.drifted) for k, d in dets.items()
            if not d.clean}
    if set(hits) != {stuck.path, drift.path} or \
            hits[stuck.path] != (stuck.cols, ()) or \
            not set(drift.tiles) <= set(hits[drift.path][1]):
        fail(f"phase 12a: detection found {hits}")
    faultlib.repair_stuck(params, golden, stuck.path, hits[stuck.path][0])
    faultlib.repair_drift(params, golden, drift.path, hits[drift.path][1])
    torch.cuda.synchronize()
    check_copies(params, "after the repair")
    q, k1 = kernels("after the repair")
    for g, w in list(zip(q, pre_q)) + [(k1[n], pre_k1[n]) for n in k1]:
        if not torch.equal(g, w):
            fail("phase 12a: the kernels' outputs after the repair differ "
                 "from the pre-fault outputs")
    log(f"phase 12a: stuck attn.wq columns {cols} and drifted attn.wv tiles "
        f"{list(drift.tiles)} injected in place into codes, kcodes, scales "
        f"and every layer's PackedQKV; kernel 2 (M={CAPACITY}, decode "
        f"route) and kernel 1 (M=512) on them 0 flips against their plain "
        f"versions, stuck columns 0.0; detection found {hits} "
        f"({t_first * 1e3:.2f} ms host, first round); after the repair "
        f"every copy byte-equal to the clean copy and the outputs bit-equal "
        f"to the pre-fault ones")

    # 12e, first half: one detection round on the clean array, its host
    # time (every leaf's fingerprint on the device, one copy, the verdicts
    # on the host) and the profiler's device time.
    def detect_round():
        c = faultlib.fingerprint_round(params, sites)
        return [faultlib.detect_site(base[s_.path], c[s_.path])
                for s_ in sites]

    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not all(d.clean for d in detect_round()):
            fail("phase 12: the clean array reads as faulted")
        host.append((time.perf_counter() - t0) * 1e3)
    prof = profile_pass(dev, detect_round, "fault detection round")
    busy = "not measured" if prof is None else \
        f"{prof['device_busy_ms']:.3f} ms"
    out["detect_round"] = {"host_ms": host,
                           "host_ms_median": statistics.median(host),
                           "profile": prof}
    n_leaves = sum(len(faultlib.site_leaves(params, s_.path))
                   for s_ in sites)
    log(f"phase 12e: one detection round ({len(sites)} sites, {n_leaves} "
        f"leaves, one device-to-host copy): {statistics.median(host):.3f} "
        f"ms host "
        f"(median of {[round(v, 3) for v in host]}), device busy {busy}; "
        f"{card}")

    # 12b-d. Served runs of phase 4's workload under fault plans.
    class FaultEngine(engine_cls):
        """Times each detection round and each reshard to a synchronized
        device."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.round_ms, self.reshard_ms = [], []

        def _detect_and_recover(self):
            t0 = time.perf_counter()
            n = len(self.reshard_ms)
            super()._detect_and_recover()
            torch.cuda.synchronize()
            if len(self.reshard_ms) == n:
                self.round_ms.append((time.perf_counter() - t0) * 1e3)

        def _reshard_and_requeue(self):
            t0 = time.perf_counter()
            super()._reshard_and_requeue()
            torch.cuda.synchronize()
            self.reshard_ms.append((time.perf_counter() - t0) * 1e3)

    def fault_run(mode, faults, recovery=True):
        kw = {"eager": dict(_graphs=False), "graphs": {},
              "overlap": dict(clock=time.perf_counter, overlap=True)}[mode]
        e = FaultEngine(params, mcfg, capacity=CAPACITY, max_len=MAX_LEN,
                        quant=quant, seed=SEED, device=dev, faults=faults,
                        recovery=recovery, detect_every=FAULT_DETECT_EVERY,
                        **kw)
        e.warmup()
        torch.cuda.synchronize()
        rs = [Request(uid=r.uid, prompt=list(r.prompt),
                      max_new_tokens=MAX_NEW) for r in reqs]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        fin = e.run(rs)
        e.close()
        torch.cuda.synchronize()
        wall_ = time.perf_counter() - t0
        counts = ops.launch_counts()
        what = (f"fault serve [{mode}, "
                f"{'no plan' if faults is None else 'a plan'}, recovery "
                f"{'on' if recovery else 'off'}]")
        cons = e.metrics.conservation()
        if len(fin) != N_REQUESTS or not all(
                r.done and len(r.generated) == MAX_NEW for r in fin):
            fail(f"{what}: {len(fin)} of {N_REQUESTS} finished")
        if not cons["ok"]:
            fail(f"{what}: conservation {cons}")
        for name, n in counts.items():
            if (n <= 0) == (name in SERVE_KERNELS):
                fail(f"{what}: kernel {name} was launched {n} times")
        med, cnt = e.pass_stats()
        s = e.metrics.summary()
        res = {"streams": {r.uid: r.generated for r in fin},
               "faults": dict(e.metrics.faults), "requests": s["requests"],
               "launches": counts, "wall_s": wall_, "ticks": e.ticks,
               "passes": cnt, "decode_ms": med["decode"] * 1e3,
               "prefill_ms": med["prefill"] * 1e3,
               "goodput": e.metrics.goodput(FAULT_SLO_TTFT),
               "goodput_with_corrupted": e.metrics.goodput(
                   FAULT_SLO_TTFT, include_corrupted=True),
               "round_ms": e.round_ms, "reshard_ms": e.reshard_ms}
        log(f"{what} in {wall_:.3f}s: {e.ticks} passes ({cnt}), decode "
            f"tick median {res['decode_ms']:.3f} ms, prefill pass median "
            f"{res['prefill_ms']:.3f} ms, faults {res['faults']}, requests "
            f"{s['requests']}, detection rounds (to a synchronized device) "
            f"{[round(v, 3) for v in e.round_ms]} ms, reshards "
            f"{[round(v, 3) for v in e.reshard_ms]} ms, launch counts "
            f"{counts}; {card}")
        # A run may end with a fault no round repaired (recovery off, or
        # an event after the last round): re-program the shared weights
        # from the clean copy before the next run, and check them.
        faultlib.restore_sites(e.params, golden)
        torch.cuda.synchronize()
        check_copies(e.params, f"after the {what}")
        del e
        gc.collect()
        torch.cuda.empty_cache()
        return res

    plan = FaultPlan([FaultEvent(t, k, p_, **x)
                      for t, k, p_, x in FAULT_EVENTS],
                     FaultConfig(rate=0.01))
    runs = {m: fault_run(m, plan) for m in ("eager", "graphs", "overlap")}
    for m, r_ in runs.items():
        f = r_["faults"]
        if f["injected"] != len(FAULT_EVENTS) or f["detected"] < 1 or min(
                f["cols_remapped"], f["tiles_requantized"],
                f["reshards"]) < 1 or r_["requests"]["requeued"] < 1:
            fail(f"fault serve [{m}]: counters {f}, requests "
                 f"{r_['requests']}")
        if m != "eager" and (r_["streams"] != runs["eager"]["streams"]
                             or f != runs["eager"]["faults"]):
            bad = [u for u, v in r_["streams"].items()
                   if v != runs["eager"]["streams"][u]]
            fail(f"fault serve [{m}]: streams of {bad} or counters {f} "
                 f"differ from the eager run's")
    out["plan"] = {m: {k: v for k, v in r_.items() if k != "streams"}
                   for m, r_ in runs.items()}
    log("phase 12b: the explicit plan eagerly, with graphs and with graphs "
        "+ overlap: 8/8, conservation, every event injected, faults "
        "detected, repaired and requests requeued; streams and counters "
        "equal across the three")

    cfg_c = FaultConfig(rate=FAULT_RATE, seed=FAULT_SEED)
    on = fault_run("graphs", cfg_c, recovery=True)
    off = fault_run("graphs", cfg_c, recovery=False)
    if not on["goodput"] >= off["goodput"]:
        fail(f"phase 12c: goodput with recovery {on['goodput']} < without "
             f"{off['goodput']}")
    if off["requests"]["corrupted"] <= 0:
        fail("phase 12c: no request corrupted without recovery")
    out["recovery"] = {k: {kk: vv for kk, vv in r_.items()
                           if kk != "streams"}
                       for k, r_ in (("on", on), ("off", off))}
    log(f"phase 12c: FaultConfig(rate={FAULT_RATE}, seed={FAULT_SEED}) with "
        f"graphs: goodput (TTFT <= {FAULT_SLO_TTFT} ticks, corrupted "
        f"excluded) {on['goodput']:.4f} requests/tick with recovery against "
        f"{off['goodput']:.4f} without; corrupted requests "
        f"{on['requests']['corrupted']} / {off['requests']['corrupted']}")

    # 12d. Zero overhead: a rate-0 plan against no plan, with graphs, in
    # turns (none, rate 0, rate 0, none): the same engine class at the same
    # point of the script, so the decode-tick medians compare the plan's
    # cost alone; phase 4b's graph medians are logged beside them.
    zero = {"none": [], "rate0": []}
    for k in ("none", "rate0", "rate0", "none"):
        zero[k].append(fault_run(
            "graphs", FaultConfig(rate=0.0) if k == "rate0" else None))
    for k, rs_ in zero.items():
        for r_ in rs_:
            if r_["streams"] != want_streams:
                fail(f"phase 12d: the {k} run changed phase 4's streams")
            if r_["launches"] != graph_launches:
                fail(f"phase 12d: the {k} run launched {r_['launches']} "
                     f"against phase 4b's {graph_launches}")
    dec = {k: [r_["decode_ms"] for r_ in rs_] for k, rs_ in zero.items()}
    out["zero"] = {k: [{kk: vv for kk, vv in r_.items() if kk != "streams"}
                       for r_ in rs_] for k, rs_ in zero.items()}
    out["decode_ms_phase4b_graphs"] = list(graph_decode_ms)
    out["reshard_ms"] = [v for r_ in runs.values() for v in r_["reshard_ms"]]
    log(f"phase 12d/e: with graphs, a rate-0 plan and no plan (in turns) "
        f"give phase 4's streams and phase 4b's launch counts; decode tick "
        f"medians: rate 0 {[round(v, 3) for v in dec['rate0']]} ms, no plan "
        f"{[round(v, 3) for v in dec['none']]} ms, phase 4b's graphs "
        f"{[round(v, 3) for v in graph_decode_ms]} ms; reshards (12b runs) "
        f"{[round(v, 3) for v in out['reshard_ms']]} ms; {card}")
    for row in rows:
        row["launches_fault_serve"] = runs["graphs"]["launches"].get(
            row["name"], 0)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def recurrent_phase(dev, engine_cls, short_lens, rows: list) -> dict:
    """Phase 13: the recurrent and hybrid families served at full width
    (see the module docstring): (a) recurrentgemma-2b on phase 4's six
    prompt lengths (``short_lens``) and RG_LONG_PROMPTS, (b) xlstm-350m on
    the six.  ``engine_cls`` is phase 4's NaN-checking engine.  Annotates
    kernel rows with this path's launches and kernel 1's row with its
    time per recurrentgemma decode tick; returns the measurements."""
    import torch

    from repro_torch.core import prng
    from repro_torch.kernels import ops
    from repro_torch.kernels.abfp_matmul import abfp_matmul_packed_ref
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import (
        Numerics,
        clone_state,
        decode_step,
        init_decode_state,
        init_params,
        prefill,
    )
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving.runners import state_tensors

    k1 = "abfp_matmul_packed"
    shapes = [("decode",)] + [("prefill", c) for c in (16, 64, 128)]

    def shape_name(k):
        return "".join(str(p_) for p_ in k)

    def family(arch, lens, k1_per_tick, turns) -> dict:
        res = {"arch": arch}
        torch.cuda.reset_peak_memory_stats()
        args = serve_cli.build_parser().parse_args(
            ["--arch", arch, "--full", "--fused", "--capacity",
             str(CAPACITY), "--max-len", str(MAX_LEN), "--max-new",
             str(MAX_NEW), "--seed", str(SEED)])
        mcfg, quant = serve_cli.model_and_quant(args)
        if quant.mode != "abfp_fused" or not mcfg.kv_quant:
            fail(f"phase 13 {arch}: unexpected serving config {quant}")
        if arch == "xlstm-350m":
            mcfg = dataclasses.replace(mcfg, num_layers=XL_SERVE_LAYERS)
        t0 = time.perf_counter()
        params = init_params(SEED, mcfg, device=dev)
        eng = engine_cls(params, mcfg, capacity=CAPACITY, max_len=MAX_LEN,
                         quant=quant, seed=SEED, device=dev, _graphs=False)
        torch.cuda.synchronize()
        res["init_and_pack_s"] = time.perf_counter() - t0
        del params
        packed = eng.params
        log(f"phase 13 {arch}: {mcfg.num_layers} layers "
            f"{mcfg.block_pattern}, d={mcfg.d_model}, vocab "
            f"{mcfg.vocab_size}, window {mcfg.window_size}, built and "
            f"packed in {res['init_and_pack_s']:.1f}s")
        rng = np.random.default_rng(SEED + 13)
        reqs = [Request(uid=i, prompt=rng.integers(1, mcfg.vocab_size,
                                                   n).tolist(),
                        max_new_tokens=MAX_NEW) for i, n in enumerate(lens)]
        if any(not eng.fits(r) for r in reqs):
            fail(f"phase 13 {arch}: a request does not fit")

        def fresh(**kw):
            return ServingEngine(packed, mcfg, capacity=CAPACITY,
                                 max_len=MAX_LEN, quant=quant, seed=SEED,
                                 device=dev, **kw)

        # The served runs, in turns: each a fresh engine (graphs captured
        # before its timed window, each shape timed), the launch counts
        # zeroed just before the run and read just after.
        want = None
        runs = {m: [] for m in ("eager", "graphs", "overlap")}
        for mode in turns:
            if mode == "eager" and want is None:
                e = eng
            else:
                e = fresh(**{"eager": dict(_graphs=False), "graphs": {},
                             "overlap": dict(clock=time.perf_counter,
                                             overlap=True)}[mode])
            capture = {}
            if mode != "eager":
                for k in shapes:
                    t1 = time.perf_counter()
                    e._executable(k)
                    torch.cuda.synchronize()
                    capture[shape_name(k)] = time.perf_counter() - t1
                e._warmed_shapes.clear()
            rs = [Request(uid=r.uid, prompt=list(r.prompt),
                          max_new_tokens=MAX_NEW) for r in reqs]
            ops.reset_launch_counts()
            t1 = time.perf_counter()
            fin = e.run(rs)
            e.close()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            counts = ops.launch_counts()
            if len(fin) != len(reqs) or any(
                    not r.done or len(r.generated) != MAX_NEW for r in fin):
                fail(f"phase 13 {arch} {mode}: {len(fin)} of {len(reqs)} "
                     f"requests finished")
            streams = {r.uid: r.generated for r in fin}
            if want is None:
                want = streams
                per_tick = sorted({p[k1] for p in e.per_pass["decode"]})
                other = {n: v for n, v in counts.items() if n != k1 and v}
                if per_tick != [k1_per_tick] or other:
                    fail(f"phase 13 {arch}: kernel 1 launched {per_tick} "
                         f"times per decode tick (want {k1_per_tick}), "
                         f"other kernels {other}")
            elif streams != want:
                bad = [u for u in want if streams[u] != want[u]]
                fail(f"phase 13 {arch} {mode}: the streams of requests "
                     f"{bad} differ from the eager run's")
            if counts[k1] <= 0:
                fail(f"phase 13 {arch} {mode}: kernel 1 was not launched")
            if mode != "eager":
                dec = e._passes[("decode",)].launches
                if dec.get(k1) != k1_per_tick or any(
                        v for n, v in dec.items() if n != k1):
                    fail(f"phase 13 {arch} {mode}: a decode replay holds "
                         f"{dec}, want {k1_per_tick} of kernel 1 only")
            med, cnt = e.pass_stats()
            toks = sum(len(r.generated) for r in fin)
            r_ = {"wall_s": wall, "tokens": toks, "tokens_per_s": toks / wall,
                  "decode_ms": med["decode"] * 1e3,
                  "prefill_ms": med["prefill"] * 1e3, "passes": e.ticks,
                  "passes_by_kind": cnt,
                  "tick_utilization": e.metrics.tick_utilization()["value"],
                  "launches": counts, "capture_s": capture}
            runs[mode].append(r_)
            log(f"phase 13 {arch} serve [{mode}]: {len(fin)}/{len(reqs)} "
                f"requests, {toks} tokens in {wall:.3f}s "
                f"({r_['tokens_per_s']:.1f} tokens/s), decode tick median "
                f"{r_['decode_ms']:.3f} ms, prefill pass median "
                f"{r_['prefill_ms']:.3f} ms ({cnt}), tick_utilization "
                f"{r_['tick_utilization']}, capture s {capture}, launches "
                f"{counts}")
            if e is not eng:
                del e
                gc.collect()
        res["runs"] = runs
        res["prompt_lens"] = [len(r.prompt) for r in reqs]
        WORKLOADS[arch] = {"prompts": [list(r.prompt) for r in reqs],
                           "features": None, "max_len": MAX_LEN,
                           "streams": want,
                           "launches": runs["graphs"][0]["launches"]}

        # Replay against eager: every pass shape from the eager run's final
        # state, two keys each, by replay and eagerly.
        served = [t.clone() for t in state_tensors(eng.state)]
        geng, xeng = fresh(clock=time.perf_counter, overlap=True), fresh(
            clock=time.perf_counter, overlap=True, _graphs=False)
        geng.warmup()
        fields_of = replay_against_eager(
            geng, xeng, served, shapes, mcfg.vocab_size,
            np.random.default_rng(SEED + 14), f"phase 13 {arch}")
        xeng.close()
        del xeng

        # Where a replay's device time goes (measurement only).
        key = prng.PRNGKey(SEED + 9)
        res["profile"] = {}
        for shape in (("decode",), ("prefill", 128)):
            for dst, src in zip(state_tensors(geng.state), served):
                dst.copy_(src)
            p_ = profile_pass(dev, lambda: geng._call(
                shape, key, **fields_of[shape]), f"{arch} "
                f"{shape_name(shape)} pass (graph replay)")
            res["profile"][shape_name(shape)] = p_
        geng.close()
        del geng, served

        # The first prefill pass and decode tick through the kernels and
        # through the plain versions; every kernel-1 call against its plain
        # version on its own inputs (0 flips).
        first = reqs[:CAPACITY]
        n_tok = np.array([min(len(r.prompt), 128) for r in first], np.int32)
        toks = np.zeros((CAPACITY, 128), np.int32)
        for i, r in enumerate(first):
            toks[i, :n_tok[i]] = r.prompt[:n_tok[i]]
        toks_t = torch.from_numpy(toks).to(dev)
        n_t = torch.from_numpy(n_tok).to(dev)
        key = prng.split(prng.PRNGKey(SEED))[1]
        key_d = prng.fold_in(key, 1)
        wrapper = ops.abfp_matmul_packed
        calls = []

        def recorded(x, pw, cfg, seed=None):
            y = wrapper(x, pw, cfg, seed)
            calls.append((x, pw, cfg, seed, y))
            return y

        def checked(kind):
            torch.cuda.synchronize()
            flips = err = 0.0
            for x, pw, cfg, seed, y in calls:
                f_, z_, ulp, e_ = bf16_diff(
                    y, abfp_matmul_packed_ref(x, pw, cfg, seed))
                if f_ or ulp:
                    fail(f"phase 13 {arch} first {kind}: kernel 1 differs "
                         f"from its plain version ({f_}/{z_} flips) at "
                         f"M={x.numel() // x.shape[-1]}, K={pw.k}, "
                         f"N={pw.n_cols}")
                err = max(err, e_)
            log(f"phase 13 {arch} first {kind}: {len(calls)} kernel-1 calls "
                f"on their own inputs, 0 flips against the plain version")
            return err

        def compare(kind, a, b):
            same = float((a.argmax(-1) == b.argmax(-1)).float().mean())
            err = float((a - b).abs().max())
            log(f"phase 13 {arch} first {kind}: logits max-abs difference "
                f"{err:.4g}, greedy tokens equal {same:.0%}")
            if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                fail(f"phase 13 {arch}: non-finite logits in the first "
                     f"{kind}")
            if not torch.equal(a, b):
                fail(f"phase 13 {arch} first {kind}: every kernel-1 call "
                     f"was bit-equal, yet the logits differ from the plain "
                     f"run's")
            return {"logits_max_abs": err, "greedy_equal": same}

        state0 = init_decode_state(mcfg, CAPACITY, MAX_LEN, device=dev)
        st_k, st_p = clone_state(state0), clone_state(state0)
        ops.abfp_matmul_packed = recorded
        try:
            lg_k, _ = prefill(packed, st_k, toks_t, n_t, mcfg,
                              Numerics(quant, key))
        finally:
            ops.abfp_matmul_packed = wrapper
        err = checked("prefill pass")
        calls.clear()
        lg_p, _ = prefill(packed, st_p, toks_t, n_t, mcfg,
                          Numerics(quant, key, plain=True))
        res["first_prefill"] = compare("prefill pass", lg_k, lg_p)
        tok = lg_k.argmax(-1).to(torch.int32)
        ops.abfp_matmul_packed = recorded
        try:
            lg_k, _ = decode_step(packed, st_k, tok, mcfg,
                                  Numerics(quant, key_d))
        finally:
            ops.abfp_matmul_packed = wrapper
        err = max(err, checked("decode tick"))
        if len(calls) != k1_per_tick:
            fail(f"phase 13 {arch}: the first decode tick made "
                 f"{len(calls)} kernel-1 calls, want {k1_per_tick}")
        lg_p, _ = decode_step(packed, st_p, tok, mcfg,
                              Numerics(quant, key_d, plain=True))
        res["first_decode"] = compare("decode tick", lg_k, lg_p)
        res["k1_max_abs_err"] = err

        # Kernel 1's device time for one decode tick's worth of its launches
        # (a graph replay of the tick's recorded calls), the plain version's
        # time, and the bound from the bytes and operations of these calls.
        tick = [(x, pw, cfg, seed) for x, pw, cfg, seed, _ in calls]
        calls.clear()
        nb = i8 = f32 = 0
        for x, pw, _, _ in tick:
            b_, i_, f_ = k1_cost(x.numel() // x.shape[-1], pw,
                                 x.element_size())
            nb, i8, f32 = nb + b_, i8 + i_, f32 + f_
        bms, by = bound(nb, i8, f32)
        ms, how = graph_ms(lambda: [wrapper(*c) for c in tick], 20)
        plain_ms = median_ms(lambda: [abfp_matmul_packed_ref(*c)
                                      for c in tick], 3)
        # Each weight shape of the tick alone (one call, graph replay),
        # against its own bound: where the tick's time over its bound goes.
        by_shape = {}
        for c in tick:
            x, pw = c[0], c[1]
            key_ = f"{pw.k}x{pw.n_cols}"
            if key_ in by_shape:
                by_shape[key_]["calls"] += 1
                continue
            b_, i_, f_ = k1_cost(x.numel() // x.shape[-1], pw,
                                 x.element_size())
            one_ms = graph_ms(lambda c=c: wrapper(*c), 20)[0]
            by_shape[key_] = {"calls": 1, "ms": one_ms,
                              "bound_ms": bound(b_, i_, f_)[0],
                              "gb_per_s": b_ / one_ms / 1e6}
        log(f"phase 13 {arch}: kernel 1 per weight shape (K x N: calls, ms "
            f"per call, bound ms, GB/s): " + json.dumps(
                {k_: [v["calls"], round(v["ms"], 4), round(v["bound_ms"], 4),
                      round(v["gb_per_s"], 1)] for k_, v in
                 by_shape.items()}))
        res["k1_tick"] = {"launches": len(tick), "ms": ms, "timing": how,
                          "plain_ms": plain_ms, "bound_ms": bms,
                          "bound_by": by, "bytes": nb,
                          "code_bytes": sum(pw.k * pw.n_cols
                                            for _, pw, _, _ in tick),
                          "by_shape": by_shape}
        log(f"phase 13 {arch}: kernel 1's {len(tick)} launches of one "
            f"decode tick take {ms:.4f} ms ({how}; plain version "
            f"{plain_ms:.3f} ms), bound {bms:.4f} ms by {by} "
            f"({nb / 1e9:.3f} GB)")
        res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del tick, st_k, st_p, state0, eng, packed
        gc.collect()
        torch.cuda.empty_cache()
        return res

    t_phase = time.perf_counter()
    out = {"recurrentgemma": family(
        "recurrentgemma-2b", list(short_lens) + list(RG_LONG_PROMPTS),
        RG_DECODE_K1, RG_TURNS)}
    log(f"phase 13a in {time.perf_counter() - t_phase:.1f}s")
    t_b = time.perf_counter()
    out["xlstm"] = family("xlstm-350m", short_lens, XL_DECODE_K1,
                          ("eager", "graphs"))
    log(f"phase 13b in {time.perf_counter() - t_b:.1f}s")
    rg = out["recurrentgemma"]
    for row in rows:
        name = row["name"]
        row["launches_recurrentgemma_serve"] = rg["runs"]["graphs"][0][
            "launches"].get(name, 0)
        row["launches_xlstm_serve"] = out["xlstm"]["runs"]["graphs"][0][
            "launches"].get(name, 0)
        if name == "abfp_matmul_packed":
            t_ = rg["k1_tick"]
            row.update({"recurrentgemma_tick_ms": t_["ms"],
                        "recurrentgemma_tick_plain_ms": t_["plain_ms"],
                        "recurrentgemma_tick_bound_ms": t_["bound_ms"],
                        "recurrentgemma_tick_bound_by": t_["bound_by"],
                        "launches_per_recurrentgemma_tick": t_["launches"],
                        "xlstm_tick_ms": out["xlstm"]["k1_tick"]["ms"],
                        "xlstm_tick_bound_ms":
                            out["xlstm"]["k1_tick"]["bound_ms"]})
            row["max_abs_err"] = max(row["max_abs_err"], rg["k1_max_abs_err"],
                                     out["xlstm"]["k1_max_abs_err"])
    out["seconds"] = time.perf_counter() - t_phase
    return out


def moe_phase(dev, engine_cls, lens, rows: list) -> dict:
    """Phase 14: full-width granite-moe-1b-a400m served as ``--arch
    granite-moe-1b-a400m --full --fused`` configures it, on phase 4's
    prompt lengths (``lens``), and its evaluation forward (see the module
    docstring).  ``engine_cls`` is phase 4's NaN-checking engine that
    records each pass's launches.  Annotates the kernel rows with this
    path's launches and times; returns the measurements."""
    import torch

    from repro_torch.core import prng
    from repro_torch.core.abfp import QuantConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.abfp_decode_fused import (
        fused_qkv_packed_ref,
        quantized_decode_attention,
    )
    from repro_torch.kernels.abfp_matmul import abfp_matmul_packed_ref
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import (
        Numerics,
        clone_state,
        decode_step,
        init_decode_state,
        init_params,
        prefill,
    )
    from repro_torch.models import layers as model_layers
    from repro_torch.models import moe as moe_lib
    from repro_torch.serving import Request
    from repro_torch.serving.runners import state_tensors

    t_phase = time.perf_counter()
    k1, k2, k3 = SERVE_KERNELS
    shapes = [("decode",)] + [("prefill", c) for c in (16, 64, 128)]
    res = {}

    torch.cuda.reset_peak_memory_stats()
    args = serve_cli.build_parser().parse_args(
        ["--arch", "granite-moe-1b-a400m", "--full", "--fused", "--capacity",
         str(CAPACITY), "--max-len", str(MAX_LEN), "--max-new", str(MAX_NEW),
         "--seed", str(SEED)])
    mcfg, quant = serve_cli.model_and_quant(args)
    if (mcfg.name, quant.mode) != ("granite-moe-1b-a400m", "abfp_fused") \
            or not mcfg.kv_quant:
        fail(f"phase 14: unexpected serving config {mcfg} {quant}")
    # Launches per decode tick: kernel 1 on each layer's attn.wo and its
    # experts' wi, wg and wo, and on the LM head; kernels 2 and 3 once per
    # layer.  Per prefill pass: kernel 1 on wq, wk, wv, wo and the experts,
    # and the head.  Per evaluation forward: kernel 4 on the same matmuls
    # as the prefill pass, kernel 5 once per layer.
    nl, ne = mcfg.num_layers, mcfg.num_experts
    per_tick = {k1: nl * (1 + 3 * ne) + 1, k2: nl, k3: nl}
    per_prefill = {k1: nl * (4 + 3 * ne) + 1}
    per_forward = {"abfp_matmul": per_prefill[k1], "flash_attention": nl}
    t0 = time.perf_counter()
    params = init_params(SEED, mcfg, device=dev)
    eng = engine_cls(params, mcfg, capacity=CAPACITY, max_len=MAX_LEN,
                     quant=quant, seed=SEED, device=dev, _graphs=False)
    torch.cuda.synchronize()
    res["init_and_pack_s"] = time.perf_counter() - t0
    packed = eng.params
    log(f"phase 14: granite-moe-1b-a400m ({mcfg.num_layers} layers, "
        f"d={mcfg.d_model}, {mcfg.num_experts} experts top-"
        f"{mcfg.experts_per_token}, expert hidden {mcfg.d_ff}, vocab "
        f"{mcfg.vocab_size}) built and packed in "
        f"{res['init_and_pack_s']:.1f}s")
    rng = np.random.default_rng(SEED + 15)
    reqs = [Request(uid=i, prompt=rng.integers(1, mcfg.vocab_size,
                                               n).tolist(),
                    max_new_tokens=MAX_NEW) for i, n in enumerate(lens)]

    def fresh(**kw):
        return engine_cls(packed, mcfg, capacity=CAPACITY, max_len=MAX_LEN,
                          quant=quant, seed=SEED, device=dev, **kw)

    # 14a. The served runs, in turns: each a fresh engine (graphs captured
    # before its timed window, each shape timed), the launch counts zeroed
    # just before the run and read just after, and every pass's launches
    # held to ``per_tick`` / ``per_prefill``.
    runs, want, geng = serve_in_turns(
        eng, fresh, lambda: [Request(uid=r.uid, prompt=list(r.prompt),
                                     max_new_tokens=MAX_NEW) for r in reqs],
        shapes, {"decode": per_tick, "prefill": per_prefill}, "phase 14")
    WORKLOADS[mcfg.name] = {"prompts": [list(r.prompt) for r in reqs],
                            "features": None, "max_len": MAX_LEN,
                            "streams": want,
                            "launches": runs["graphs"][0]["launches"]}
    res["runs"] = runs
    res["prompt_lens"] = [len(r.prompt) for r in reqs]
    res["per_decode_tick"], res["per_prefill_pass"] = per_tick, per_prefill

    # 14b. Replay against eager: every pass shape from the eager run's
    # final state, two keys each, by replay (the overlapped run's captured
    # engine) and eagerly.
    served = [t.clone() for t in state_tensors(eng.state)]
    xeng = fresh(clock=time.perf_counter, overlap=True, _graphs=False)
    fields_of = replay_against_eager(
        geng, xeng, served, shapes, mcfg.vocab_size,
        np.random.default_rng(SEED + 16), "phase 14")
    xeng.close()
    del xeng

    # Where a decode replay's device time goes (measurement only).
    for dst, src in zip(state_tensors(geng.state), served):
        dst.copy_(src)
    res["profile_decode"] = profile_pass(dev, lambda: geng._call(
        ("decode",), prng.PRNGKey(SEED + 9), **fields_of[("decode",)]),
        "granite-moe-1b-a400m decode pass (graph replay)")
    geng.close()
    del geng, served
    gc.collect()

    # The first prefill pass and decode tick through the kernels and
    # through the plain versions: every kernel-1/2 call at 0 flips and
    # every kernel-3 call within its bar on its own inputs, every layer's
    # chosen experts equal between the runs, the logits compared as phase
    # 5 compares them.
    first = reqs[:CAPACITY]
    n_tok = np.array([min(len(r.prompt), 128) for r in first], np.int32)
    toks = np.zeros((CAPACITY, 128), np.int32)
    for i, r in enumerate(first):
        toks[i, :n_tok[i]] = r.prompt[:n_tok[i]]
    toks_t = torch.from_numpy(toks).to(dev)
    n_t = torch.from_numpy(n_tok).to(dev)
    key = prng.split(prng.PRNGKey(SEED))[1]
    key_d = prng.fold_in(key, 1)
    sites = {k1: (ops, abfp_matmul_packed_ref),
             k2: (ops, lambda x, pws, cfg, seeds, qkv=None:
                  fused_qkv_packed_ref(x, pws, cfg, seeds)),
             k3: (model_layers, quantized_decode_attention)}
    calls = {n: [] for n in sites}
    eids = []

    @contextlib.contextmanager
    def recording(kernels: bool):
        """Record every layer's expert ids and, with ``kernels``, every
        kernel call (inputs and output)."""
        saved = {n: getattr(mod, n) for n, (mod, _) in sites.items()}
        route = moe_lib._route

        def rec_route(*a):
            out_ = route(*a)
            eids.append(out_[1])
            return out_

        def wrap(name, fn):
            def call(*a, **kw):
                y = fn(*a, **kw)
                calls[name].append((a, kw, y))
                return y
            return call

        moe_lib._route = rec_route
        if kernels:
            for n, (mod, _) in sites.items():
                setattr(mod, n, wrap(n, saved[n]))
        try:
            yield
        finally:
            moe_lib._route = route
            for n, (mod, _) in sites.items():
                setattr(mod, n, saved[n])

    errs = {n: 0.0 for n in sites}

    def check_calls(kind) -> bool:
        """Kernels 1-2 bit-equal to their plain versions; kernel 3 within
        its card tests' bar (rtol 2**-7, one bf16 ULP, atol 1e-6), its
        elements more than one ULP off counted and shown."""
        torch.cuda.synchronize()
        exact = True
        for name, rec in calls.items():
            n = size = wide = 0
            for a, kw, y in rec:
                want_ = sites[name][1](*a, **kw)
                for g, w in zip(*((y, want_) if isinstance(y, tuple)
                                  else ((y,), (want_,)))):
                    f_, z_, ulp, e_ = bf16_diff(g, w)
                    if name != k3 and (f_ or ulp):
                        fail(f"phase 14 first {kind}: {name} differs from "
                             f"its plain version ({f_}/{z_} flips)")
                    if name == k3:
                        allclose_bar(g, w, f"phase 14 first {kind}: {name}",
                                     rtol=2 ** -7, atol=1e-6, quiet=True)
                        far = np.abs(bits(g) - bits(w)) > 1
                        if far.any():
                            wide += int(far.sum())
                            log(f"phase 14 first {kind}: {name} elements "
                                f"more than one bf16 ULP from the plain "
                                f"version: got "
                                f"{g.float().cpu().numpy()[far][:4]}, want "
                                f"{w.float().cpu().numpy()[far][:4]}")
                    n, size = n + f_, size + z_
                    errs[name] = max(errs[name], e_)
            exact = exact and (name == k3 or n == 0)
            log(f"phase 14 first {kind}: {name} on its {len(rec)} calls' own "
                f"inputs against its plain version: {n}/{size} one-ULP "
                f"flips, {wide} elements further apart")
        return exact

    def compare(what, a, b, bar=None):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            fail(f"phase 14: non-finite logits in the first {what}")
        same = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        err = float((a - b).abs().max())
        log(f"phase 14 first {what}: logits max-abs difference {err:.4g}, "
            f"greedy tokens equal {same:.0%}")
        if bar is not None and err > bar:
            fail(f"phase 14 first {what}: logits differ by {err:.4g} > {bar}")
        return {"logits_max_abs": err, "greedy_equal": same}

    def same_experts(kind, got, want_):
        if len(got) != mcfg.num_layers or len(want_) != mcfg.num_layers or \
                not all(torch.equal(a, b) for a, b in zip(got, want_)):
            fail(f"phase 14 first {kind}: the chosen experts differ between "
                 f"the kernel run and the plain run")
        log(f"phase 14 first {kind}: the {mcfg.num_layers} layers' chosen "
            f"experts ({tuple(got[0].shape)} each) equal the plain run's")

    state0 = init_decode_state(mcfg, CAPACITY, MAX_LEN, device=dev)
    st_k, st_p = clone_state(state0), clone_state(state0)
    with recording(True):
        lg_k, _ = prefill(packed, st_k, toks_t, n_t, mcfg,
                          Numerics(quant, key))
    if len(calls[k1]) != per_prefill[k1] or calls[k2] or calls[k3]:
        fail(f"phase 14: the first prefill pass made "
             f"{ {n: len(c) for n, c in calls.items()} } kernel calls")
    exact = check_calls("prefill pass")
    for rec in calls.values():
        rec.clear()
    ids_k, eids[:] = list(eids), []
    with recording(False):
        lg_p, _ = prefill(packed, st_p, toks_t, n_t, mcfg,
                          Numerics(quant, key, plain=True))
    same_experts("prefill pass", ids_k, eids)
    eids.clear()
    res["first_prefill"] = compare("prefill pass, kernels vs plain versions",
                                   lg_k, lg_p, DECODE_LOGIT_BAR)
    if exact and not torch.equal(lg_k, lg_p):
        fail("phase 14: the prefill pass runs no kernel 3 and every kernel-1 "
             "call was bit-equal, yet its logits differ")
    tok = lg_k.argmax(-1).to(torch.int32)
    st_a = clone_state(st_p)
    with recording(True):
        lg_k, _ = decode_step(packed, st_k, tok, mcfg, Numerics(quant, key_d))
    tick = {n: [c for c in rec] for n, rec in calls.items()}
    if {n: len(c) for n, c in tick.items()} != per_tick:
        fail(f"phase 14: the first decode tick made "
             f"{ {n: len(c) for n, c in tick.items()} } kernel calls, want "
             f"{per_tick}")
    exact = check_calls("decode tick")
    for rec in calls.values():
        rec.clear()
    ids_k, eids[:] = list(eids), []
    with recording(False):
        lg_p, _ = decode_step(packed, st_p, tok, mcfg,
                              Numerics(quant, key_d, plain=True))
    same_experts("decode tick", ids_k, eids)
    eids.clear()
    res["first_decode"] = compare("decode tick, kernels vs plain versions",
                                  lg_k, lg_p, DECODE_LOGIT_BAR)
    saved3 = model_layers.fused_quantized_decode_attention
    model_layers.fused_quantized_decode_attention = quantized_decode_attention
    try:
        lg_a, _ = decode_step(packed, st_a, tok, mcfg, Numerics(quant, key_d))
    finally:
        model_layers.fused_quantized_decode_attention = saved3
    if exact and not torch.equal(lg_a, lg_p):
        fail("phase 14: the decode tick with kernel 3's plain version "
             "differs from the plain run, yet every kernel-1/2 call was "
             "bit-equal")
    log("phase 14 first decode tick with kernel 3's plain version: logits "
        "bit-equal to the plain run's")
    res["max_abs_err"] = dict(errs)
    del st_k, st_p, st_a, state0, lg_a

    # Device time of one decode tick's worth of each kernel's launches.
    timed = tick_kernel_times(
        {n: [(a, kw) for a, kw, _ in c] for n, c in tick.items()},
        "phase 14")
    res["tick"] = timed
    del tick, eng, packed
    gc.collect()
    torch.cuda.empty_cache()

    # 14c. One cacheless evaluation forward in abfp_kernel with flash
    # attention (kernel 4 on every matmul, kernel 5 per layer) through the
    # kernels, the plain versions and kernel 5's plain version (see
    # ``eval_forward_runs``): the kernel run's logits held to
    # EVAL_LOGIT_BAR as phase 7 holds its own, its aux and the rows routed
    # apart from the plain run's reported.
    emcfg = dataclasses.replace(mcfg, use_flash_attention=True)
    equant = QuantConfig(mode="abfp_kernel", tile_width=quant.tile_width,
                         gain=quant.gain, noise_lsb=quant.noise_lsb)
    etoks = torch.from_numpy(rng.integers(
        1, mcfg.vocab_size, (MOE_EVAL_BATCH, MOE_EVAL_SEQ)).astype(
        np.int32)).to(dev)
    ev, got_counts = eval_forward_runs(dev, params, etoks, emcfg, equant,
                                       prng.PRNGKey(SEED + 17), "phase 14c")
    if got_counts != per_forward:
        fail(f"phase 14c: the forward launched {got_counts}, want "
             f"{per_forward}")
    res["eval_forward"] = dict(ev, launches=got_counts)
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del params
    gc.collect()
    torch.cuda.empty_cache()

    g_ = runs["graphs"][0]["launches"]
    for row in rows:
        name = row["name"]
        row["launches_granite_serve"] = g_.get(name, 0)
        row["launches_granite_eval_forward"] = got_counts.get(name, 0)
        if name in timed:
            t_ = timed[name]
            row.update({"granite_tick_ms": t_["ms"],
                        "granite_tick_plain_ms": t_["plain_ms"],
                        "granite_tick_bound_ms": t_["bound_ms"],
                        "granite_tick_bound_by": t_["bound_by"],
                        "launches_per_granite_tick": t_["launches"]})
            row["max_abs_err"] = max(row["max_abs_err"], errs[name])
    res["seconds"] = time.perf_counter() - t_phase
    return res


def encdec_phase(dev, engine_cls, lens, rows: list) -> dict:
    """Phase 15: full-width whisper-base served as ``--arch whisper-base
    --full --fused`` configures it, with 1,500-frame stub audio per
    request, and full-width phi-3-vision-4.2b on stub embeddings (see the
    module docstring).  ``engine_cls`` is phase 4's NaN-checking engine
    that records each pass's launches; ``lens`` phase 4's prompt lengths.
    Annotates the kernel rows; returns the measurements."""
    import torch

    from repro_torch.core import prng
    from repro_torch.core.abfp import QuantConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.abfp_decode_fused import (
        fused_quantized_decode_attention,
        quantized_decode_attention,
    )
    from repro_torch.kernels.abfp_matmul import (
        abfp_matmul_packed,
        abfp_matmul_packed_ref,
    )
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_ref,
    )
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import frontends, init_params
    from repro_torch.models import layers as model_layers
    from repro_torch.serving import EncDecRunner, Request
    from repro_torch.serving.runners import state_tensors

    t_phase = time.perf_counter()
    k1, k2, k3 = SERVE_KERNELS
    shapes = [("decode",)] + [("prefill", c) for c in (16, 64, 128)]
    res = {}
    enc_len = WHISPER_FRAMES

    class EncEngine(engine_cls):
        """Records each admission pass's launches (as the passes'), the
        cross K/V every admission writes, and the passes that computed
        each request's rows: (shape, key, slot) of every decode tick and
        prefill pass, by request uid."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.per_pass["admit"] = []
            self.encoded = {}
            self.passes_of = {}

        def _admit_pass(self, i, req):
            self._counted("admit", super()._admit_pass, i, req)
            self.encoded.setdefault(req.uid, []).append(
                [e[n][i].clone() for e in self.state["enc"]
                 for n in ("k", "v")])

        def _call(self, shape, key, **fields):
            n = fields.get("n_tokens")
            for i, r in enumerate(self.slots):
                if r is not None and (n is None or n[i] > 0):
                    self.passes_of.setdefault(r.uid, []).append(
                        (shape, tuple(int(w) for w in key), i))
            return super()._call(shape, key, **fields)

    torch.cuda.reset_peak_memory_stats()
    args = serve_cli.build_parser().parse_args(
        ["--arch", "whisper-base", "--full", "--fused", "--capacity",
         str(CAPACITY), "--max-len", str(WHISPER_MAX_LEN), "--max-new",
         str(MAX_NEW), "--seed", str(SEED)])
    mcfg, quant = serve_cli.model_and_quant(args)
    if (mcfg.name, quant.mode) != ("whisper-base", "abfp_fused") \
            or not mcfg.kv_quant or not mcfg.is_encoder_decoder:
        fail(f"phase 15: unexpected serving config {mcfg} {quant}")
    # Launches: a decode tick runs kernel 2 (wq|wk|wv) and kernel 3 per
    # layer and kernel 1 on attn.wo, cross wq and wo, mlp wi and wo, and
    # the head; a prefill pass kernel 1 on all eight matmuls of a layer
    # and the head; an admission pass kernel 1 on each encoder layer's six
    # matmuls and on every decoder layer's cross wk and wv (M = enc_len).
    nl, ne = mcfg.num_layers, mcfg.num_encoder_layers
    per_pass = {"decode": {k1: 5 * nl + 1, k2: nl, k3: nl},
                "prefill": {k1: 8 * nl + 1},
                "admit": {k1: 6 * ne + 2 * nl}}
    t0 = time.perf_counter()
    params = init_params(SEED, mcfg, device=dev)
    runner = EncDecRunner(mcfg, enc_len=enc_len)
    eng = EncEngine(params, mcfg, capacity=CAPACITY, max_len=WHISPER_MAX_LEN,
                    runner=runner, quant=quant, seed=SEED, device=dev,
                    _graphs=False)
    torch.cuda.synchronize()
    res["init_and_pack_s"] = time.perf_counter() - t0
    packed = eng.params
    log(f"phase 15: whisper-base ({ne} + {nl} layers, d={mcfg.d_model}, "
        f"{mcfg.num_heads} heads of {mcfg.resolved_head_dim}, vocab "
        f"{mcfg.vocab_size}, {enc_len} frames) built and packed in "
        f"{res['init_and_pack_s']:.1f}s")
    rng = np.random.default_rng(SEED + 18)
    prompts = [rng.integers(1, mcfg.vocab_size, n).tolist() for n in lens]
    feats = [frontends.audio_stub_features(
        prng.fold_in(prng.PRNGKey(SEED), uid), 1, enc_len, mcfg.d_model,
        dtype=mcfg.activation_dtype, device=dev)[0].cpu()
        for uid in range(len(lens))]

    def requests():
        return [Request(uid=i, prompt=list(p), max_new_tokens=MAX_NEW,
                        features=feats[i]) for i, p in enumerate(prompts)]

    def fresh(**kw):
        return EncEngine(packed, mcfg, capacity=CAPACITY,
                         max_len=WHISPER_MAX_LEN, runner=runner,
                         **{"quant": quant, **kw}, seed=SEED, device=dev)

    # 15a. The served runs, in turns (the admission pass captured and
    # timed with the other shapes).
    runs, want, geng = serve_in_turns(eng, fresh, requests,
                                      shapes + [("admit",)], per_pass,
                                      "phase 15")
    WORKLOADS[mcfg.name] = {"prompts": [list(p_) for p_ in prompts],
                            "features": feats, "max_len": WHISPER_MAX_LEN,
                            "streams": want,
                            "launches": runs["graphs"][0]["launches"]}
    res["runs"] = runs
    res["prompt_lens"] = list(lens)
    res["per_pass"] = per_pass
    res["streams_distinct_tokens"] = len({t for s in want.values()
                                          for t in s})

    # Replay against eager: every pass shape from the eager run's final
    # state under two keys, and the admission pass under two request keys
    # (uids): the whole state, the cross K/V rows included, bit-equal
    # between replay and eager, the two keys' cross K/V different.
    served = [t.clone() for t in state_tensors(eng.state)]
    xeng = fresh(clock=time.perf_counter, overlap=True, _graphs=False)
    fields_of = replay_against_eager(
        geng, xeng, served, shapes, mcfg.vocab_size,
        np.random.default_rng(SEED + 19), "phase 15")
    encs = []
    for uid in (100, 101):
        req = Request(uid=uid, prompt=[1], max_new_tokens=1,
                      features=feats[uid % len(feats)])
        outs = []
        for e in (geng, xeng):
            for dst, src in zip(state_tensors(e.state), served):
                dst.copy_(src)
            e._admit_pass(1, req)
            outs.append([x.clone() for x in state_tensors(e.state)])
        if not all(torch.equal(a, b) for a, b in zip(*outs)):
            fail(f"phase 15: the admission pass of uid {uid} by replay "
                 f"differs from the eager pass")
        encs.append([x.clone() for e_ in xeng.state["enc"]
                     for x in (e_["k"][1], e_["v"][1])])
    if all(torch.equal(a, b) for a, b in zip(*encs)):
        fail("phase 15: two request keys gave equal cross K/V (frozen "
             "seeds?)")
    if geng._passes[("admit",)].graph is None:
        fail("phase 15: the admission pass was not captured")
    log("phase 15: the admission pass by replay against eager under two "
        "request keys: the whole state bit-equal, the keys' cross K/V "
        "differ")

    # The admission pass: host time to a synchronized device (replay),
    # kernel 1's device time for its launches (their recorded calls,
    # replayed in a graph) and its bound; profiles of a decode replay and
    # an admission replay.
    req0 = Request(uid=0, prompt=[1], max_new_tokens=1, features=feats[0])
    admit_ms = []
    for _ in range(5):
        t1 = time.perf_counter()
        geng._admit_pass(0, req0)
        torch.cuda.synchronize()
        admit_ms.append((time.perf_counter() - t1) * 1e3)
    res["admit_host_ms"] = statistics.median(admit_ms)
    rec = []
    saved1 = ops.abfp_matmul_packed

    def rec1(*a, **kw):
        rec.append(a)
        return saved1(*a, **kw)

    ops.abfp_matmul_packed = rec1
    try:
        xeng._admit_pass(0, req0)
    finally:
        ops.abfp_matmul_packed = saved1
    if len(rec) != per_pass["admit"][k1]:
        fail(f"phase 15: the admission pass made {len(rec)} kernel-1 calls")
    nb = i8 = f32 = 0
    for x, pw, _, _ in rec:
        b_, i_, f_ = k1_cost(x.numel() // x.shape[-1], pw, x.element_size())
        nb, i8, f32 = nb + b_, i8 + i_, f32 + f_
    ms, how = graph_ms(lambda: [saved1(*c) for c in rec], 10)
    bms, by = bound(nb, i8, f32)
    res["admit_k1"] = {"launches": len(rec), "ms": ms, "timing": how,
                       "plain_ms": median_ms(lambda: [
                           abfp_matmul_packed_ref(*c) for c in rec], 1),
                       "bound_ms": bms, "bound_by": by}
    log(f"phase 15: kernel 1's {len(rec)} launches of one admission "
        f"pass (M={enc_len}) take {ms:.4f} ms ({how}; plain "
        f"{res['admit_k1']['plain_ms']:.3f} ms), bound {bms:.4f} ms by "
        f"{by}; the admission pass {res['admit_host_ms']:.2f} ms host "
        f"time (replay, to a synchronized device)")
    for dst, src in zip(state_tensors(geng.state), served):
        dst.copy_(src)
    res["profile_decode"] = profile_pass(dev, lambda: geng._call(
        ("decode",), prng.PRNGKey(SEED + 9), **fields_of[("decode",)]),
        "whisper-base decode pass (graph replay)")
    res["profile_admit"] = profile_pass(
        dev, lambda: geng._admit_pass(0, req0),
        "whisper-base admission pass (graph replay)")
    del rec
    xeng.close()
    geng.close()
    del xeng, geng, served

    # 15b. Re-admission after preemption: paged with graphs on a pool
    # small enough to preempt (8 of 8, conservation, at least one
    # preemption, every re-admission's cross K/V bit-equal to the
    # request's first admission: the key is the request's uid), against
    # the unpaged engine with kernel 3's plain version (the attention the
    # paged tick runs; phase 11 shows the paging changes no number).  Each
    # pass draws its noise from the engine's next key, and a preemption
    # changes the sequence of passes, so under noise a stream is held
    # where the request's passes (shape, key, slot) are the same in both
    # runs, and where they part is reported.  Without noise (the keys draw
    # nothing) every request never preempted keeps its stream; a resumed
    # request re-prefills its generated tokens through the S-query forms
    # of the self- and cross-attention, not a tick's one-query forms, and
    # the bits in which those forms differ are counted at whisper's
    # shapes; its stream is reported.
    def paged_pair(q, what):
        real3 = model_layers.fused_quantized_decode_attention
        model_layers.fused_quantized_decode_attention = \
            quantized_decode_attention
        try:
            ref = fresh(quant=q, _graphs=False)
            ref_streams = {r.uid: r.generated for r in ref.run(requests())}
        finally:
            model_layers.fused_quantized_decode_attention = real3
        e = fresh(quant=q, paged=True, page_size=WHISPER_PAGE,
                  pool_pages=WHISPER_POOL)
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        fin = {r.uid: r for r in e.run(requests())}
        e.close()
        wall = time.perf_counter() - t1
        pre = e.metrics.summary()["requests"]["preempted"]
        if len(fin) != len(lens) or not e.metrics.conservation()["ok"] or \
                any(len(r.generated) != MAX_NEW for r in fin.values()):
            fail(f"phase 15b {what}: {len(fin)} of {len(lens)} finished, "
                 f"conservation {e.metrics.conservation()}")
        twice = sorted(u for u, v in e.encoded.items() if len(v) > 1)
        if pre < 1 or not twice:
            fail(f"phase 15b {what}: {pre} preemptions, {twice} admitted "
                 f"twice")
        for u in twice:
            v = e.encoded[u]
            if not all(all(torch.equal(a, b) for a, b in zip(v[0], w_))
                       for w_ in v[1:]):
                fail(f"phase 15b {what}: request {u}'s re-admission "
                     f"encoded other cross K/V")
        out = {"wall_s": wall, "preempted": pre, "readmitted": twice,
               "launches": ops.launch_counts(),
               "pool": dataclasses.asdict(e.pool.stats()),
               "streams_equal_unpaged": sum(
                   r.generated == ref_streams[u] for u, r in fin.items())}
        log(f"phase 15b {what}: paged with graphs ({WHISPER_POOL} pages of "
            f"{WHISPER_PAGE}): {len(fin)}/{len(lens)} finished, {pre} "
            f"preemptions, requests {twice} re-admitted with cross K/V "
            f"bit-equal to their first admission, "
            f"{out['streams_equal_unpaged']} of {len(fin)} streams equal "
            f"the unpaged run's (kernel 3's plain version); {wall:.2f}s")
        return out, fin, ref_streams, e.passes_of, ref.passes_of

    out, fin, ref_streams, pas, ref_pas = paged_pair(quant, "noisy")
    kept = sorted(u for u in ref_streams if pas[u] == ref_pas[u])
    bad = [u for u in kept if fin[u].generated != ref_streams[u]]
    if not kept or bad:
        fail(f"phase 15b: requests {kept} kept their passes, yet the "
             f"streams of {bad} differ from the unpaged run's")
    parted = {}
    for u in sorted(set(ref_streams) - set(kept)):
        a, b = pas[u], ref_pas[u]
        parted[u] = {"first_pass_apart": next(
            (j for j, (x, y) in enumerate(zip(a, b)) if x != y),
            min(len(a), len(b))), "passes": len(a), "passes_unpaged": len(b),
            "preempted": fin[u].preempted,
            "stream_equal": fin[u].generated == ref_streams[u]}
    out.update(kept_passes=kept, parted=parted,
               streams_equal_15a=sum(r.generated == want[u]
                                     for u, r in fin.items()),
               unpaged_equal_15a=sum(s == want[u]
                                     for u, s in ref_streams.items()))
    log(f"phase 15b: requests {kept} kept their passes and their streams; "
        f"the others' passes part at {parted}; "
        f"{out['streams_equal_15a']} of {len(fin)} paged streams equal "
        f"15a's, the unpaged run with kernel 3's plain version "
        f"{out['unpaged_equal_15a']}")
    res["paged"] = out
    out0, fin, ref_streams, _, _ = paged_pair(
        dataclasses.replace(quant, noise_lsb=0.0), "without noise")
    bad = [u for u, r in fin.items()
           if not r.preempted and r.generated != ref_streams[u]]
    if bad:
        fail(f"phase 15b without noise: requests {bad} were never preempted, "
             f"yet their streams differ from the unpaged run's")
    out0["resumed_stream_equal"] = {u: r.generated == ref_streams[u]
                                    for u, r in fin.items() if r.preempted}
    h, kh, hd = mcfg.num_heads, mcfg.num_kv_heads, mcfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(16)
    q = torch.randn(1, 16, h, hd, device=dev, generator=gen).to(
        torch.bfloat16)
    codes = [torch.randint(-127, 128, (1, WHISPER_MAX_LEN, kh, hd),
                           dtype=torch.int8, device=dev, generator=gen)
             for _ in "kv"]
    scales = [(torch.rand(1, WHISPER_MAX_LEN, kh, device=dev, generator=gen)
               * 4).to(torch.bfloat16) for _ in "kv"]
    kv_ = (codes[0], scales[0], codes[1], scales[1])
    enc_kv = [torch.randn(1, enc_len, kh, hd, device=dev, generator=gen).to(
        torch.bfloat16) for _ in "kv"]
    pos = torch.arange(100, 116, device=dev)[None]
    forms = {
        "self": (model_layers.quantized_chunk_attention(q, *kv_, q_pos=pos),
                 torch.cat([quantized_decode_attention(
                     q[:, j:j + 1], *kv_, lengths=pos[0, j:j + 1] + 1)
                     for j in range(16)], 1)),
        "cross": (model_layers.chunked_attention(
            q, *enc_kv, causal=False, chunk=mcfg.attn_chunk),
            torch.cat([model_layers.chunked_attention(
                q[:, j:j + 1], *enc_kv, causal=False, chunk=mcfg.attn_chunk)
                for j in range(16)], 1))}
    out0["forms_bits_apart"] = {k_: [int((a != b).sum()), a.numel()]
                                for k_, (a, b) in forms.items()}
    log(f"phase 15b without noise: every request never preempted keeps its "
        f"stream; the resumed requests' streams equal "
        f"{out0['resumed_stream_equal']}; the 16-query forms against 16 "
        f"one-query calls (bf16 elements apart, of): "
        f"{out0['forms_bits_apart']}")
    res["paged_noise_free"] = out0
    del fin, pas, ref_pas, forms, q, codes, scales, kv_, enc_kv
    gc.collect()

    # 15c. Kernels against their plain versions at whisper's shapes:
    # kernel 1 at M = enc_len on the encoder's weights (0 flips), kernel 3
    # at group 1 on a served-size cache (its bar), kernel 5 non-causal at
    # (enc_len, enc_len) and (128, enc_len), bf16 and f32 (phase 3's
    # bars), each timed with its bound and SDPA's time.
    gen = torch.Generator(device=dev).manual_seed(15)
    lp = packed["encoder"]["layers"][0]
    e1 = 0.0
    for name, pw in (("encoder attn.wq", lp["attn"]["wq"]),
                     ("encoder mlp.wi", lp["mlp"]["wi"]),
                     ("encoder mlp.wo", lp["mlp"]["wo"]),
                     ("cross wk", packed["layers"][0]["cross"]["wk"])):
        x = torch.randn(enc_len, pw.k, generator=gen, device=dev).to(
            torch.bfloat16)
        n_, z_, ulp, err = bf16_diff(abfp_matmul_packed(x, pw, quant, 77),
                                     abfp_matmul_packed_ref(x, pw, quant, 77))
        if ulp:
            fail(f"phase 15c: kernel 1 {name} M={enc_len}: {n_}/{z_} flips")
        e1 = max(e1, err)
    log(f"phase 15c: kernel 1 at M={enc_len} (encoder attn.wq, mlp.wi, "
        f"mlp.wo, cross wk): 0 flips against the plain version")
    s3 = WHISPER_MAX_LEN
    codes = [torch.randint(-127, 128, (CAPACITY, s3, kh, hd),
                           dtype=torch.int8, device=dev, generator=gen)
             for _ in "kv"]
    scales = [(torch.rand(CAPACITY, s3, kh, device=dev, generator=gen) * 4)
              .to(torch.bfloat16) for _ in "kv"]
    q3 = torch.randn(CAPACITY, 1, h, hd, device=dev, generator=gen).to(
        torch.bfloat16)
    lens3 = torch.tensor([1, 107, s3, 64][:CAPACITY], dtype=torch.int32,
                         device=dev)
    a3 = (q3, codes[0], scales[0], codes[1], scales[1])
    e3 = allclose_bar(
        fused_quantized_decode_attention(*a3, lengths=lens3),
        quantized_decode_attention(*a3, lengths=lens3),
        f"phase 15c: kernel 3 at group 1 (H = KH = {h}, D = {hd}, S = {s3})",
        rtol=2 ** -7, atol=1e-6)
    k5 = {}
    e5 = 0.0
    for sq in (enc_len, 128):
        for dt in (torch.bfloat16, torch.float32):
            qkv = [torch.randn(shape, device=dev, generator=gen).to(dt)
                   for shape in ((1, sq, h, hd), (1, enc_len, kh, hd),
                                 (1, enc_len, kh, hd))]
            tol = (dict(rtol=2 ** -7, atol=1e-5) if dt == torch.bfloat16
                   else dict(rtol=1e-5, atol=2e-5))
            what = (f"phase 15c: kernel 5 non-causal (Sq, Skv) = ({sq}, "
                    f"{enc_len}), {h} heads of {hd}, "
                    f"{str(dt).split('.')[-1]}")
            e5 = max(e5, allclose_bar(
                flash_attention(*qkv, causal=False),
                flash_attention_ref(*qkv, causal=False), what, **tol))
            if dt == torch.bfloat16:
                b_, d_, f_ = k5_cost(1, sq, enc_len, h, kh, hd, False, 0)
                bms, by = bound(b_, 0.0, f_, d_)
                qt, kt, vt = (t.transpose(1, 2) for t in qkv)
                k5[f"{sq}x{enc_len}"] = {
                    "ms": graph_ms(lambda: flash_attention(
                        *qkv, causal=False), 20)[0],
                    "plain_ms": median_ms(lambda: flash_attention_ref(
                        *qkv, causal=False), 3),
                    "bound_ms": bms, "bound_by": by,
                    "library_ms": graph_ms(
                        lambda: torch.nn.functional
                        .scaled_dot_product_attention(qt, kt, vt), 20)[0]}
                log(f"{what}: {k5[f'{sq}x{enc_len}']}")
    res["k5_noncausal"] = k5

    # 15d. One abfp_kernel + flash forward of 2 x 128 decoder tokens over
    # 2 x enc_len frames, through the kernels, the plain versions, and the
    # kernels with kernel 5's plain version (which must equal the plain
    # run bit for bit: kernel 4 is exact).
    emcfg = dataclasses.replace(mcfg, use_flash_attention=True)
    equant = QuantConfig(mode="abfp_kernel", tile_width=quant.tile_width,
                         gain=quant.gain, noise_lsb=quant.noise_lsb)
    etoks = torch.from_numpy(rng.integers(
        1, mcfg.vocab_size, (2, 128)).astype(np.int32)).to(dev)
    efeats = torch.stack([feats[0], feats[1]]).to(dev)
    per_forward = {"abfp_matmul": 6 * ne + 2 * nl + 8 * nl + 1,
                   "flash_attention": ne + 2 * nl}
    ev, fwd_counts = eval_forward_runs(
        dev, params, etoks, emcfg, equant, prng.PRNGKey(SEED + 20),
        "phase 15d", encoder_features=efeats)
    if fwd_counts != per_forward:
        fail(f"phase 15d: the forward launched {fwd_counts}, want "
             f"{per_forward}")
    res["eval_forward"] = dict(ev, launches=fwd_counts)
    del params, packed, eng
    gc.collect()
    res["whisper_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # 15e. Full-width phi-3-vision-4.2b (head dim 96): one abfp_kernel +
    # flash forward on 1 x 256 stub embeddings against the plain versions;
    # a 2-request abfp_fused graphs run, kernel 3 at D = 96 on its caches
    # against the plain version; kernel 5 at D = 96 alone.
    pargs = serve_cli.build_parser().parse_args(
        ["--arch", "phi-3-vision-4.2b", "--full", "--fused", "--capacity", "2",
         "--max-len", "128", "--max-new", "8", "--seed", str(SEED)])
    pcfg, pquant = serve_cli.model_and_quant(pargs)
    if pcfg.frontend != "vision_stub" or pcfg.resolved_head_dim != 96:
        fail(f"phase 15e: unexpected config {pcfg}")
    t0 = time.perf_counter()
    pparams = init_params(SEED, pcfg, device=dev)
    log(f"phase 15e: phi-3-vision-4.2b ({pcfg.num_layers} layers, d="
        f"{pcfg.d_model}, {pcfg.num_heads} heads of "
        f"{pcfg.resolved_head_dim}) built in {time.perf_counter() - t0:.1f}s")
    emb = frontends.vision_stub_embeddings(
        prng.PRNGKey(SEED + 21), 1, 256, pcfg.d_model,
        dtype=pcfg.activation_dtype, device=dev)
    pl = pcfg.num_layers
    pe, pcounts = eval_forward_runs(
        dev, pparams, emb, dataclasses.replace(pcfg,
                                               use_flash_attention=True),
        equant, prng.PRNGKey(SEED + 22), "phase 15e")
    if pcounts != {"abfp_matmul": 7 * pl + 1,
                               "flash_attention": pl}:
        fail(f"phase 15e: the forward launched {pcounts}")
    res["phi_eval_forward"] = dict(pe, launches=pcounts)
    peng = engine_cls(pparams, pcfg, capacity=2, max_len=128, quant=pquant,
                      seed=SEED, device=dev)
    del pparams
    prng_ = np.random.default_rng(SEED + 23)
    preqs = [Request(uid=i, prompt=prng_.integers(1, pcfg.vocab_size,
                                                  n).tolist(),
                     max_new_tokens=8) for i, n in enumerate((40, 97))]
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    pfin = peng.run(preqs)
    wall = time.perf_counter() - t1
    pc = ops.launch_counts()
    if len(pfin) != 2 or any(len(r.generated) != 8 for r in pfin):
        fail("phase 15e: the phi-3-vision run did not finish 2 of 2")
    if any(pc[n] <= 0 for n in SERVE_KERNELS):
        fail(f"phase 15e: a serving kernel was not launched: {pc}")
    kv = peng.state["layers"][0]["kv"]
    q = torch.randn(2, 1, pcfg.num_heads, pcfg.resolved_head_dim,
                    device=dev, generator=gen).to(torch.bfloat16)
    a3 = (q, kv["k"], kv["k_scale"], kv["v"], kv["v_scale"])
    lens_p = kv["length"].clone()
    e3 = max(e3, allclose_bar(
        fused_quantized_decode_attention(*a3, lengths=lens_p),
        quantized_decode_attention(*a3, lengths=lens_p),
        f"phase 15e: kernel 3 at D = {pcfg.resolved_head_dim} on the "
        f"served caches (lengths {lens_p.tolist()})", rtol=2 ** -7,
        atol=1e-6))
    med, _ = peng.pass_stats()
    res["phi_serve"] = {"wall_s": wall, "decode_ms": med["decode"] * 1e3,
                        "prefill_ms": med["prefill"] * 1e3, "launches": pc}
    log(f"phase 15e: phi-3-vision served 2 of 2 with graphs in {wall:.2f}s "
        f"(decode tick median {res['phi_serve']['decode_ms']:.3f} ms), "
        f"launches {pc}")
    b_, f_ = k3_cost(lens_p.tolist(), kv["k"].shape[1], pcfg.num_kv_heads,
                     pcfg.num_heads, pcfg.resolved_head_dim)
    bms, by = bound(b_, 0.0, f_)
    k3_96 = {"ms": graph_ms(lambda: fused_quantized_decode_attention(
        *a3, lengths=lens_p), 20)[0],
             "plain_ms": median_ms(lambda: quantized_decode_attention(
                 *a3, lengths=lens_p), 5),
             "bound_ms": bms, "bound_by": by}
    log(f"phase 15e: kernel 3 at D = 96, one layer's call: {k3_96}")
    peng.close()
    del peng, kv, a3
    gc.collect()
    hp, dp = pcfg.num_heads, pcfg.resolved_head_dim
    k5_96 = None
    for dt in (torch.bfloat16, torch.float32):
        qkv = [torch.randn((1, 256, hp, dp), device=dev,
                           generator=gen).to(dt) for _ in range(3)]
        tol = (dict(rtol=2 ** -7, atol=1e-5) if dt == torch.bfloat16
               else dict(rtol=1e-5, atol=2e-5))
        e5 = max(e5, allclose_bar(
            flash_attention(*qkv), flash_attention_ref(*qkv),
            f"phase 15e: kernel 5 at D = {dp} (1 x 256, {hp} heads), causal, "
            f"{str(dt).split('.')[-1]}", **tol))
        if dt == torch.bfloat16:
            b_, d_, f_ = k5_cost(1, 256, 256, hp, hp, dp, True, 0)
            bms, by = bound(b_, 0.0, f_, d_)
            qt, kt, vt = (t.transpose(1, 2) for t in qkv)
            k5_96 = {"ms": graph_ms(lambda: flash_attention(*qkv), 20)[0],
                     "plain_ms": median_ms(lambda: flash_attention_ref(
                         *qkv), 3),
                     "bound_ms": bms, "bound_by": by,
                     "library_ms": graph_ms(
                         lambda: torch.nn.functional
                         .scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True),
                         20)[0]}
            log(f"phase 15e: kernel 5 at D = 96: {k5_96}")
    res["k3_d96"], res["k5_d96"] = k3_96, k5_96
    res["phi_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.empty_cache()

    g_ = runs["graphs"][0]["launches"]
    for row in rows:
        name = row["name"]
        row["launches_whisper_serve"] = g_.get(name, 0)
        row["launches_whisper_eval_forward"] = fwd_counts.get(name, 0)
        row["launches_phi3v_serve"] = pc.get(name, 0)
        row["launches_phi3v_eval_forward"] = pcounts.get(name, 0)
        if name == k1:
            a_ = res["admit_k1"]
            row.update({"whisper_admit_ms": a_["ms"],
                        "whisper_admit_plain_ms": a_["plain_ms"],
                        "whisper_admit_bound_ms": a_["bound_ms"],
                        "whisper_admit_bound_by": a_["bound_by"],
                        "launches_per_whisper_admit": a_["launches"]})
            row["max_abs_err"] = max(row["max_abs_err"], e1)
        if name == k3:
            row["d96"] = k3_96
            row["max_abs_err"] = max(row["max_abs_err"], e3)
        if name == "flash_attention":
            row["noncausal"] = k5
            row["d96"] = k5_96
            row["max_abs_err"] = max(row["max_abs_err"], e5)
    res["seconds"] = time.perf_counter() - t_phase
    return res


def fleet_phase(dev, engine_cls, rows: list, card: str) -> dict:
    """Phase 16: the multi-model fleet at full width (see the module
    docstring).  ``engine_cls`` is phase 4's NaN-checking engine, used for
    the single-model runs the fleet is held to.  Annotates kernel rows
    with the fleet run's launches; returns the measurements."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import init_params
    from repro_torch.serving import (
        EncDecRunner,
        FleetEngine,
        Request,
        ServingEngine,
        runner_for,
    )

    t_phase = time.perf_counter()
    res = {}
    args = serve_cli.build_parser().parse_args(
        ["--archs", ",".join(FLEET_ARCHS), "--full", "--fused",
         "--capacity", str(FLEET_CAPACITY), "--max-len",
         str(WHISPER_MAX_LEN), "--max-new", str(MAX_NEW), "--seed",
         str(SEED)])
    archs = serve_cli.resolve_archs(args)
    quant = serve_cli.quant_config(args)
    cfgs = {a: serve_cli.model_config(a, args) for a in archs}
    if quant.mode != "abfp_fused" or not all(c.kv_quant
                                             for c in cfgs.values()):
        fail(f"phase 16: unexpected serving config {quant}")
    cfgs["xlstm-350m"] = dataclasses.replace(cfgs["xlstm-350m"],
                                             num_layers=XL_SERVE_LAYERS)
    # Whisper's lane takes its 30 s window of stub frames.
    runners = {a: EncDecRunner(c, enc_len=WHISPER_FRAMES)
               if c.is_encoder_decoder else runner_for(c)
               for a, c in cfgs.items()}
    # The CLI's workload: phase 4's prompt draws routed round-robin over
    # the lanes, folded into each lane's vocabulary, the whisper lane's
    # requests given ``attach_features``' stub frames keyed (seed, uid).
    rng = np.random.default_rng(SEED)
    protos = []
    for i in range(FLEET_REQUESTS):
        plen = int(rng.integers(16, 101))
        prompt = rng.integers(1, cfgs[archs[0]].vocab_size, plen).tolist()
        name = archs[i % len(archs)]
        vmax = cfgs[name].vocab_size
        protos.append(Request(uid=i, prompt=[t % (vmax - 1) + 1
                                             for t in prompt],
                              max_new_tokens=MAX_NEW, model=name))
    serve_cli.attach_features(protos, runners, SEED)

    def requests(names=archs):
        return [Request(uid=r.uid, prompt=list(r.prompt),
                        max_new_tokens=r.max_new_tokens, model=r.model,
                        features=r.features)
                for r in protos if r.model in names]

    def finished(fin, want, what, lane_arch=None):
        """Every request of ``want`` finished with all its tokens, each in
        its lane's vocabulary (``lane_arch`` maps a lane to its arch)."""
        arch_of = lane_arch or {}
        if len(fin) != len(want) or any(
                not r.done or len(r.generated) != r.max_new_tokens
                for r in fin):
            fail(f"{what}: {len(fin)} of {len(want)} requests finished")
        if any(not 0 <= t < cfgs[arch_of.get(r.model, r.model)].vocab_size
               for r in fin for t in r.generated):
            fail(f"{what}: a token outside its lane's vocabulary")
        return {r.uid: r.generated for r in fin}

    # 16a, the reference: each lane's requests served alone by a
    # single-model engine (graphs, blocking) at the lane's capacity; the
    # first engine of each model packs the weights every later engine
    # shares.
    lane_slots = FLEET_CAPACITY // len(archs)
    packed, solo = {}, {}
    for a in archs:
        t0 = time.perf_counter()
        params = init_params(SEED, cfgs[a], device=dev)
        e = engine_cls(params, cfgs[a], runner=runners[a],
                       capacity=lane_slots, max_len=WHISPER_MAX_LEN,
                       quant=quant, seed=SEED, device=dev)
        del params
        packed[a] = e.params
        e.warmup()      # a capture's warm-up run launches kernels too
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        rs = requests((a,))
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        fin = e.run(rs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        solo[a] = {"streams": finished(fin, rs, f"phase 16a solo {a}"),
                   "launches": ops.launch_counts(), "ticks": e.ticks,
                   "wall_s": wall, "built_and_captured_s": built}
        log(f"phase 16a solo {a}: {len(fin)} requests at capacity "
            f"{lane_slots}, {e.ticks} passes in {wall:.3f}s, launches "
            f"{solo[a]['launches']} (built, packed and captured in "
            f"{built:.1f}s)")
        e.close()
        del e
        gc.collect()
    want_counts = {k: sum(solo[a]["launches"][k] for a in archs)
                   for k in solo[archs[0]]["launches"]}

    def fleet(mode, **kw):
        mode_kw = {"eager": dict(_graphs=False), "graphs": {},
                   "overlap": dict(clock=time.perf_counter, overlap=True,
                                   inflight=FLEET_INFLIGHT)}[mode]
        return ServingEngine(
            models={a: (packed[a], cfgs[a], runners[a]) for a in archs},
            capacity=FLEET_CAPACITY, max_len=WHISPER_MAX_LEN, quant=quant,
            seed=SEED, device=dev, **mode_kw, **kw)

    runs = {}
    for mode in ("eager", "graphs", "overlap"):
        what = f"phase 16a fleet [{mode}]"
        eng = fleet(mode)
        if not isinstance(eng, FleetEngine) or {
                n: l_.capacity for n, l_ in eng.lanes.items()} != {
                a: lane_slots for a in archs}:
            fail(f"{what}: not a fleet of {lane_slots} slots per lane")
        if mode == "overlap" and not all(
                l_._stream is eng._shared_stream
                for l_ in eng.lanes.values()):
            fail(f"{what}: the lanes do not share one delivery stream")
        capture = 0.0
        if mode != "eager":
            t0 = time.perf_counter()
            eng.warmup()
            torch.cuda.synchronize()
            capture = time.perf_counter() - t0
        rs = requests()
        if mode == "overlap":
            # The wall clock's arrivals: now, after the captures (the
            # fleet's clock was read when it was built).
            base = time.perf_counter()
            for r in rs:
                r.arrival_time = base
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        fin = eng.run(rs)
        eng.close()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        streams = finished(fin, rs, what)
        cons = eng.conservation()
        for a in archs:
            c, lane = cons[a], eng.lanes[a]
            if not c["ok"] or c["completed"] != FLEET_REQUESTS // len(archs):
                fail(f"{what}: lane {a} conservation {c}")
            if lane.ticks != solo[a]["ticks"]:
                fail(f"{what}: lane {a} ran {lane.ticks} passes, alone "
                     f"{solo[a]['ticks']}")
            bad = [u for u, v in solo[a]["streams"].items()
                   if streams[u] != v]
            if bad:
                fail(f"{what}: lane {a}'s streams of {bad} differ from the "
                     f"single-model run's")
        if eng.ticks != sum(l_.ticks for l_ in eng.lanes.values()):
            fail(f"{what}: ticks {eng.ticks} are not the lanes' sum")
        if counts != want_counts:
            fail(f"{what}: launched {counts}, the single-model runs "
                 f"{want_counts}")
        summ = eng.summary()
        toks = sum(len(r.generated) for r in fin)
        lanes = {a: {"ttft_p50": summ[a]["ttft"]["p50"],
                     "tpot_p50": summ[a]["tpot"]["p50"],
                     "passes": eng.lanes[a].ticks,
                     "tick_utilization":
                         eng.lanes[a].metrics.tick_utilization()["value"]}
                 for a in archs}
        runs[mode] = {"wall_s": wall, "tokens": toks,
                      "tokens_per_s": toks / wall, "passes": eng.ticks,
                      "capture_s": capture, "launches": counts,
                      "lanes": lanes}
        unit = "s" if mode == "overlap" else "ticks"
        log(f"{what}: {len(fin)}/{len(rs)} requests, {toks} tokens in "
            f"{wall:.3f}s ({toks / wall:.1f} tokens/s), {eng.ticks} passes "
            f"(the lanes' sum; each lane's equal to its single-model "
            f"run's), every lane's streams equal to its single-model run's, "
            f"launches {counts} = the four single-model runs' sum; captured "
            f"in {capture:.1f}s; per lane TTFT / TPOT p50 ({unit}) "
            + ", ".join(f"{a} {v['ttft_p50']:.4g} / {v['tpot_p50']:.4g}"
                        for a, v in lanes.items())
            + ("; tick_utilization " + ", ".join(
                f"{a} {v['tick_utilization']:.4f}"
                for a, v in lanes.items()) if mode == "overlap" else "")
            + f"; {card}")
        del eng, fin
        gc.collect()
    res["solo"] = {a: {k: v for k, v in r_.items() if k != "streams"}
                   for a, r_ in solo.items()}
    res["runs"] = runs

    # 16b. A paged fleet: the decoder lane on a pool too small for its
    # demand (it preempts), the fixed-state lane beside it with no pool
    # (never preempted: its streams are its 16a single-model run's).
    t_b = time.perf_counter()
    lanes = {"dec": "smollm-360m", "rec": "xlstm-350m"}
    rng = np.random.default_rng(SEED + 23)
    vd = cfgs["smollm-360m"].vocab_size
    dec_reqs = [Request(uid=200 + i, prompt=rng.integers(
                    1, vd, PAGED_FLEET_PROMPT).tolist(),
                    max_new_tokens=PAGED_FLEET_NEW, model="dec")
                for i in range(8)]
    rec_reqs = [dataclasses.replace(r, model="rec", generated=[])
                for r in requests(("xlstm-350m",))]
    eng = ServingEngine(
        models={n: (packed[a], cfgs[a], runners[a])
                for n, a in lanes.items()},
        capacity=sum(PAGED_FLEET_SPLIT.values()),
        model_split={"dec": PAGED_FLEET_SPLIT["dec"]},
        max_len=WHISPER_MAX_LEN, quant=quant, seed=SEED, device=dev,
        paged=True, page_size=PAGED_FLEET_PAGE, pool_pages=PAGED_FLEET_POOL)
    dec, rec = eng.lanes["dec"], eng.lanes["rec"]
    if not (dec.paged and dec.pool is not None
            and dec.pool.num_pages == PAGED_FLEET_POOL
            and dec.capacity == PAGED_FLEET_SPLIT["dec"]):
        fail("phase 16b: the decoder lane is not paged on the whole pool")
    if rec.paged or rec.pool is not None or rec.preemption:
        fail("phase 16b: the fixed-state lane has a pool")
    eng.warmup()
    torch.cuda.synchronize()
    rs = dec_reqs + rec_reqs
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    fin = eng.run(rs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    streams = finished(fin, rs, "phase 16b", lanes)
    cons = eng.conservation()
    if not (cons["dec"]["ok"] and cons["dec"]["preempt_ok"]
            and cons["rec"]["ok"]):
        fail(f"phase 16b: conservation {cons}")
    if cons["dec"]["preempted"] < 1 or cons["rec"]["preempted"] != 0:
        fail(f"phase 16b: preemptions dec {cons['dec']['preempted']}, rec "
             f"{cons['rec']['preempted']}")
    bad = [r.uid for r in rec_reqs
           if streams[r.uid] != solo["xlstm-350m"]["streams"][r.uid]]
    if bad:
        fail(f"phase 16b: the fixed-state lane's streams of {bad} differ "
             f"from its single-model run's")
    res["paged"] = {"wall_s": wall, "passes": eng.ticks,
                    "launches": counts,
                    "dec": {k: cons["dec"][k] for k in (
                        "completed", "preempted", "resumed")},
                    "rec": {k: cons["rec"][k] for k in (
                        "completed", "preempted")},
                    "pool_pressure_max":
                        dec.metrics.summary()["pool"]["pressure_max"],
                    "seconds": time.perf_counter() - t_b}
    log(f"phase 16b: paged fleet (dec: smollm-360m, "
        f"{PAGED_FLEET_SPLIT['dec']} slots on {PAGED_FLEET_POOL} pages of "
        f"{PAGED_FLEET_PAGE}; rec: xlstm-350m, {PAGED_FLEET_SPLIT['rec']} "
        f"slots, no pool) with graphs: {len(fin)}/{len(rs)} requests in "
        f"{wall:.3f}s, {eng.ticks} passes; dec preempted "
        f"{cons['dec']['preempted']} times (resumed "
        f"{cons['dec']['resumed']}, preempt_ok), rec 0 with its "
        f"single-model streams; launches {counts}")
    del eng, dec, rec, packed
    gc.collect()
    torch.cuda.empty_cache()

    g_ = runs["graphs"]["launches"]
    for row in rows:
        row["launches_fleet_serve"] = g_.get(row["name"], 0)
        row["launches_paged_fleet_serve"] = counts.get(row["name"], 0)
    res["seconds"] = time.perf_counter() - t_phase
    return res


def family_fault_phase(dev, engine_cls, rows: list, card: str) -> dict:
    """Phase 17: fault plans on every model family at full width (see the
    module docstring), on the workloads phases 13-15 served
    (``WORKLOADS``).  ``engine_cls`` is phase 4's NaN-checking engine.
    Annotates kernel rows with the graph runs' launches; returns the
    measurements."""
    import torch

    from repro_torch.core.abfp import kernel_layout
    from repro_torch.kernels import ops
    from repro_torch.kernels.abfp_decode_fused import PackedQKV, concat_qkv
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import init_params
    from repro_torch.serving import (
        EncDecRunner,
        FaultConfig,
        FaultPlan,
        Request,
        runner_for,
    )
    from repro_torch.serving import faults as faultlib
    from repro_torch.serving.faults import FaultEvent

    t_phase = time.perf_counter()
    res = {}

    class FaultEngine(engine_cls):
        """Times each detection round and each reshard to a synchronized
        device."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.round_ms, self.reshard_ms = [], []

        def _detect_and_recover(self):
            t0 = time.perf_counter()
            super()._detect_and_recover()
            torch.cuda.synchronize()
            self.round_ms.append((time.perf_counter() - t0) * 1e3)

        def _reshard_and_requeue(self):
            t0 = time.perf_counter()
            super()._reshard_and_requeue()
            torch.cuda.synchronize()
            self.reshard_ms.append((time.perf_counter() - t0) * 1e3)

    repaired = []
    real = (faultlib.repair_stuck, faultlib.repair_drift)

    def recording(fn, kind):
        def wrapped(params, clean, path, what):
            repaired.append((kind, path, tuple(what)))
            return fn(params, clean, path, what)
        return wrapped

    def i16(t):
        return t.view(torch.int16)

    def ptrs(p, sites):
        out = []
        for site in sites:
            for leaf in faultlib.site_leaves(p, site.path):
                out += [leaf.codes.data_ptr(), leaf.scales.data_ptr(),
                        leaf.kcodes.data_ptr()]
        return out

    def qkvs(p):
        return [lp["attn"]["qkv"] for lp in p["layers"]
                if isinstance(lp.get("attn", {}).get("qkv"), PackedQKV)]

    def check_clean(p, golden, sites, what):
        """Every site equals the clean pack byte for byte, ``kcodes ==
        kernel_layout(codes)``, each ``PackedQKV`` a fresh ``concat_qkv``
        of its pieces."""
        for site in sites:
            for a, b in zip(faultlib.site_leaves(p, site.path),
                            faultlib.site_leaves(golden, site.path)):
                if not (torch.equal(a.codes, b.codes)
                        and torch.equal(i16(a.scales), i16(b.scales))
                        and torch.equal(a.kcodes, kernel_layout(a.codes))):
                    fail(f"{what}: {site.path} differs from the clean pack")
        for q in qkvs(p):
            fresh = concat_qkv(q.pws, quant)
            if not (torch.equal(q.kcodes, fresh.kcodes)
                    and torch.equal(i16(q.scales), i16(fresh.scales))):
                fail(f"{what}: a PackedQKV differs from its pieces")

    for arch, events in FAMILY_FAULTS.items():
        t_arch = time.perf_counter()
        wl = WORKLOADS[arch]
        args = serve_cli.build_parser().parse_args(
            ["--arch", arch, "--full", "--fused", "--capacity",
             str(CAPACITY), "--max-len", str(wl["max_len"]), "--max-new",
             str(MAX_NEW), "--seed", str(SEED)])
        mcfg, quant = serve_cli.model_and_quant(args)
        runner = (EncDecRunner(mcfg, enc_len=WHISPER_FRAMES)
                  if mcfg.is_encoder_decoder else runner_for(mcfg))
        params = init_params(SEED, mcfg, device=dev)
        kw = dict(runner=runner, capacity=CAPACITY, max_len=wl["max_len"],
                  quant=quant, seed=SEED, device=dev,
                  detect_every=FAULT_DETECT_EVERY)
        first = FaultEngine(params, mcfg, **kw)      # packs the weights
        del params
        packed = first.params
        del first
        sites = faultlib.fault_sites(packed)
        by_path = {s_.path: s_ for s_ in sites}
        for _, kind, path, x in events:
            s_ = by_path.get(path)
            if s_ is None or any(c >= s_.n_cols for c in x.get("cols", ())) \
                    or any(t >= s_.n_tiles or j >= s_.n_cols
                           for t, j in x.get("tiles", ())):
                fail(f"phase 17 {arch}: no site {path} for {kind} {x}")
        golden = faultlib.clone_sites(packed)
        n_leaves = sum(len(faultlib.site_leaves(packed, s_.path))
                       for s_ in sites)
        plan = FaultPlan([FaultEvent(t, k, p_, **x)
                          for t, k, p_, x in events], FaultConfig(rate=0.01))

        def requests():
            return [Request(uid=i, prompt=list(p_), max_new_tokens=MAX_NEW,
                            features=None if wl["features"] is None
                            else wl["features"][i])
                    for i, p_ in enumerate(wl["prompts"])]

        def run(mode, faults):
            planned = isinstance(faults, FaultPlan)
            what = (f"phase 17 {arch} [{mode}, "
                    f"{'plan' if planned else 'rate 0'}]")
            e = FaultEngine(packed, mcfg, faults=faults,
                            **({"_graphs": False} if mode == "eager"
                               else {}), **kw)
            before = ptrs(e.params, sites) + [
                t.data_ptr() for q in qkvs(e.params)
                for t in (q.kcodes, q.scales)]
            if mode != "eager":
                e.warmup()
            torch.cuda.synchronize()
            rs = requests()
            repaired.clear()
            faultlib.repair_stuck = recording(real[0], "stuck_col")
            faultlib.repair_drift = recording(real[1], "scale_drift")
            try:
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                fin = e.run(rs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = ops.launch_counts()
            finally:
                faultlib.repair_stuck, faultlib.repair_drift = real
            if len(fin) != len(rs) or any(
                    not r.done or len(r.generated) != MAX_NEW for r in fin):
                fail(f"{what}: {len(fin)} of {len(rs)} requests finished")
            cons = e.metrics.conservation()
            if not cons["ok"]:
                fail(f"{what}: conservation {cons}")
            f = dict(e.metrics.faults)
            if planned:
                # Every event's site was detected and repaired: its stuck
                # columns remapped, its drifted tiles re-quantized.
                for _, kind, path, x in events:
                    got = [w for k, p_, w in repaired
                           if k == kind and p_ == path]
                    want = (tuple(x["cols"]) if kind == "stuck_col"
                            else tuple(x["tiles"]))
                    if not got or not set(want) <= set().union(*got):
                        fail(f"{what}: {kind} on {path} was not detected "
                             f"and repaired ({repaired}; counters {f}, "
                             f"{e.ticks} passes)")
                if f["injected"] != len(events) or f["detected"] < 1:
                    fail(f"{what}: counters {f}")
            check_clean(e.params, golden, sites, f"{what}, after the run")
            after = ptrs(e.params, sites) + [
                t.data_ptr() for q in qkvs(e.params)
                for t in (q.kcodes, q.scales)]
            if after != before:
                fail(f"{what}: a served tensor moved")
            s = e.metrics.summary()
            out = {"streams": {r.uid: r.generated for r in fin},
                   "faults": f, "requests": s["requests"], "wall_s": wall,
                   "passes": e.ticks, "launches": counts,
                   "round_ms": list(e.round_ms)}
            log(f"{what}: {len(fin)}/{len(rs)} requests in {wall:.3f}s, "
                f"{e.ticks} passes, faults {f}, requests requeued "
                f"{s['requests']['requeued']}, corrupted "
                f"{s['requests']['corrupted']}, repairs {repaired}, "
                f"detection rounds {[round(v, 3) for v in e.round_ms]} ms, "
                f"launches {counts}; after it every site equals the clean "
                f"pack and no served tensor moved")
            if mode == "graphs" and planned:
                # A reshard on the idle engine: every site re-programmed
                # from the spare and the state reset, to a synchronized
                # device.
                e._lost_shard = 0
                e._reshard_and_requeue()
                out["reshard_ms"] = list(e.reshard_ms)
                check_clean(e.params, golden, sites,
                            f"{what}, after a reshard")
            e.close()
            del e
            gc.collect()
            return out

        runs = {m: run(m, plan) for m in ("eager", "graphs")}
        if (runs["graphs"]["streams"] != runs["eager"]["streams"]
                or runs["graphs"]["faults"] != runs["eager"]["faults"]
                or runs["graphs"]["requests"] != runs["eager"]["requests"]):
            fail(f"phase 17 {arch}: eager and graphs differ: "
                 f"{runs['eager']['faults']} / {runs['graphs']['faults']}")
        if runs["graphs"]["requests"]["requeued"] < 1:
            fail(f"phase 17 {arch}: no request was requeued")
        zero = run("graphs", FaultConfig(rate=0.0))
        if zero["streams"] != wl["streams"] or \
                zero["launches"] != wl["launches"]:
            fail(f"phase 17 {arch}: a rate-0 plan gave other streams or "
                 f"launches ({zero['launches']}) than the family phase's "
                 f"({wl['launches']})")

        # One detection round on the clean array: host time (every leaf's
        # fingerprint on the device, one copy, the verdicts on the host)
        # and the profiler's device time.
        base = faultlib.fingerprint_round(packed, sites)

        def detect_round():
            c = faultlib.fingerprint_round(packed, sites)
            return [faultlib.detect_site(base[s_.path], c[s_.path])
                    for s_ in sites]

        host = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if not all(d.clean for d in detect_round()):
                fail(f"phase 17 {arch}: the clean array reads as faulted")
            host.append((time.perf_counter() - t0) * 1e3)
        prof = profile_pass(dev, detect_round,
                            f"phase 17 {arch} detection round")
        busy = None if prof is None else prof["device_busy_ms"]
        res[arch] = {
            "sites": len(sites), "leaves": n_leaves,
            "runs": {m: {k: v for k, v in r_.items() if k != "streams"}
                     for m, r_ in runs.items()},
            "rate0": {k: v for k, v in zero.items() if k != "streams"},
            "detect_round_host_ms": host,
            "detect_round_device_busy_ms": busy,
            "reshard_ms": runs["graphs"]["reshard_ms"],
            "seconds": time.perf_counter() - t_arch}
        log(f"phase 17 {arch}: the plan eagerly and with graphs: 8/8, "
            f"conservation, every event detected and repaired, equal "
            f"streams and counters; a rate-0 plan gives the family phase's "
            f"streams and launches; one detection round ({len(sites)} "
            f"sites, {n_leaves} leaves, one device-to-host copy) "
            f"{statistics.median(host):.3f} ms host (of "
            f"{[round(v, 3) for v in host]}), device busy "
            f"{'not measured' if busy is None else f'{busy:.3f} ms'}; "
            f"reshard {[round(v, 3) for v in res[arch]['reshard_ms']]} ms; "
            f"{res[arch]['seconds']:.1f}s; {card}")
        del packed, golden, base
        gc.collect()
        torch.cuda.empty_cache()

    for row in rows:
        row["launches_family_faults"] = sum(
            r_["runs"]["graphs"]["launches"].get(row["name"], 0)
            for r_ in res.values())
    res["seconds"] = time.perf_counter() - t_phase
    return res


def recurrent_train_phase(dev, rows: list) -> dict:
    """Phase 18: the cacheless forward, evaluation and training of the
    recurrent and hybrid families at full width (see the module
    docstring).  Annotates the kernel rows of kernels 4 and 5; returns the
    measurements."""
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.core.abfp import QuantConfig
    from repro_torch.core.dnf import select_layers_by_std
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.data import DataConfig, batch_at_step
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_ref,
    )
    from repro_torch.models import Numerics, forward, init_params, param_count
    from repro_torch.models import layers as model_layers
    from repro_torch.optim import AdamW, constant
    from repro_torch.training import (
        TrainConfig,
        capture_histograms,
        evaluate_abfp,
        finetune,
        make_dnf_train_step,
        make_train_step,
    )

    t_phase = time.perf_counter()
    kq = QuantConfig(mode="abfp_kernel", tile_width=128, gain=8.0,
                     noise_lsb=0.5)
    res = {"steps_s": {}, "peak_gib": {}}
    e5 = 0.0
    laps = [t_phase]

    def lap(what):
        laps.append(time.perf_counter())
        res.setdefault("laps_s", {})[what] = laps[-1] - laps[-2]
        log(f"phase 18 {what}: {laps[-1] - laps[-2]:.1f}s")

    def measured(mode, fn):
        """Run ``fn`` with the peak-memory counter reset just before."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        res["peak_gib"][mode] = torch.cuda.max_memory_allocated() / 2 ** 30
        return out

    def moved_all(new, old, what):
        still = [i for i, (a, b) in enumerate(zip(leaves(new), leaves(old)))
                 if torch.equal(a, b)]
        if still:
            fail(f"{what}: {len(still)} weights did not move (leaves "
                 f"{still[:8]})")

    models = {}
    for arch, want in RECURRENT_TRAIN.items():
        mcfg = get_config(arch)
        if (mcfg.num_layers, mcfg.d_model, mcfg.param_dtype, mcfg.remat,
                mcfg.use_flash_attention) != (
                    want[0], want[1], torch.bfloat16, False, False):
            fail(f"phase 18: unexpected config {mcfg}")
        t0 = time.perf_counter()
        params = init_params(SEED, mcfg, device=dev)
        torch.cuda.synchronize()
        log(f"phase 18: {arch} ({mcfg.num_layers} layers, "
            f"{param_count(params) / 1e9:.3f} B parameters) built in "
            f"{time.perf_counter() - t0:.1f}s")
        per_forward = {n: 0 for n in ops.launch_counts()}
        per_forward.update(abfp_matmul=want[2], flash_attention=want[3])
        emcfg = dataclasses.replace(mcfg, use_flash_attention=True)
        short = arch.split("-")[0]

        # 18a. evaluate_abfp over 2 batches of 4 x 513, the launches read
        # around each forward; the same in float; a parity forward of 2 x
        # 128; DNF's capture.
        rng = np.random.default_rng(SEED + 30)
        batches = [{"tokens": rng.integers(1, mcfg.vocab_size,
                                           (EVAL_BATCH, EVAL_SEQ + 1))
                    .astype(np.int32)} for _ in range(EVAL_BATCHES)]
        per_call = []
        real_forward = finetune.forward

        def counted_forward(*a, **kw):
            before = ops.launch_counts()
            out = real_forward(*a, **kw)
            after = ops.launch_counts()
            per_call.append({n: after[n] - before[n] for n in after})
            return out

        finetune.forward = counted_forward
        try:
            ekey = prng.PRNGKey(SEED + 31)
            t0 = time.perf_counter()
            acc_q = evaluate_abfp(params, batches, emcfg, kq, key=ekey)
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t0
            acc_f = evaluate_abfp(params, batches, emcfg,
                                  QuantConfig(mode="float"), key=ekey)
        finally:
            finetune.forward = real_forward
        float_forward = dict(per_forward, abfp_matmul=0)
        if per_call != [per_forward] * EVAL_BATCHES \
                + [float_forward] * EVAL_BATCHES:
            fail(f"phase 18a: {arch}'s evaluation forwards launched "
                 f"{per_call}, want {per_forward} per abfp_kernel forward "
                 f"and {float_forward} per float forward")
        log(f"phase 18a: evaluate_abfp of {arch} ({EVAL_BATCHES} batches of "
            f"{EVAL_BATCH} x {EVAL_SEQ + 1}, flash on) in {eval_s:.2f}s, "
            f"launches per forward {per_call[0]}: accuracy {acc_q:.6f} "
            f"(abfp_kernel, tile 128, gain 8, noise 0.5), {acc_f:.6f} "
            f"(float)")
        ptoks = torch.from_numpy(rng.integers(
            1, mcfg.vocab_size, (2, 128)).astype(np.int32)).to(dev)
        # The parity forward's bars.  In float, kernel 5's sum order moves
        # the logits smoothly: EVAL_LOGIT_BAR.  Under ABFP its one-ULP
        # flips move activation codes, and a recurrent state carries a
        # moved code to every later token (recurrentgemma-2b: 1.25 on an
        # H100, bit-equal with kernel 5's plain version); there the
        # bar is the model's own noise: the plain forward's logits under a
        # second noise key.
        pkey = prng.PRNGKey(SEED + 32)
        with torch.no_grad():
            la = forward(params, ptoks, emcfg, Numerics(kq, pkey,
                                                         plain=True))[0]
            lb = forward(params, ptoks, emcfg, Numerics(
                kq, prng.PRNGKey(SEED + 37), plain=True))[0]
            noise_floor = float((la - lb).abs().max())
            la = forward(params, ptoks, emcfg)[0]
            lb = forward(params, ptoks, emcfg, Numerics(
                QuantConfig(mode="float"), plain=True))[0]
            float_err = float((la - lb).abs().max())
            del la, lb
        log(f"phase 18a {arch}: the plain forward's logits under two noise "
            f"keys differ by {noise_floor:.4g} (the abfp_kernel parity "
            f"forward's bar); a float forward through kernel 5 differs from "
            f"its plain version's by {float_err:.4g} (bar "
            f"{EVAL_LOGIT_BAR})")
        if float_err > EVAL_LOGIT_BAR:
            fail(f"phase 18a: {arch}'s float forward through kernel 5 "
                 f"differs from the plain version's by {float_err:.4g}")
        ev, counts = eval_forward_runs(
            dev, params, ptoks, emcfg, kq, pkey, f"phase 18a {arch}",
            check_calls=True, bar=noise_floor)
        if counts != {n: v for n, v in per_forward.items() if v}:
            fail(f"phase 18a: {arch}'s parity forward launched {counts}")
        ev.update(noise_key_max_abs=noise_floor, float_k5_max_abs=float_err)
        e5 = max(e5, ev["k5_max_abs"])
        inputs = torch.from_numpy(batches[0]["tokens"][:, :-1]).to(dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        hists, stds = capture_histograms(params, inputs, emcfg, kq,
                                         key=prng.fold_in(ekey, 7))
        cap = ops.launch_counts()
        if len(stds) != mcfg.num_layers or not np.isfinite(stds).all() \
                or min(stds) <= 0:
            fail(f"phase 18a: {arch}'s capture_histograms gave stds {stds}")
        log(f"phase 18a: capture_histograms of {arch} on one batch in "
            f"{time.perf_counter() - t0:.2f}s (kernel 4 x "
            f"{cap['abfp_matmul']}, kernel 5 x {cap['flash_attention']}): "
            f"{len(stds)} per-layer dy stds "
            f"{json.dumps([float(f'{v:.4g}') for v in stds])}")
        res[short] = {"accuracy_abfp": acc_q, "accuracy_float": acc_f,
                      "eval_s": eval_s, "launches_per_forward": per_call[0],
                      "parity_forward": ev, "dnf_stds": stds,
                      "params_b": param_count(params) / 1e9}
        models[arch] = (mcfg, params, hists)
        lap(f"18a {arch}")

    # 18b. The window: one float forward of recurrentgemma-2b over 1 x
    # 4,096 tokens with flash on, so the 2,048 window masks and skips
    # blocks; kernel 5's 8 calls against the plain version, timed against
    # their bound and SDPA under the same window mask.
    rcfg, rparams, _ = models["recurrentgemma-2b"]
    wcfg = dataclasses.replace(rcfg, use_flash_attention=True)
    calls5 = []

    def rec5(*a, **kw):
        out = flash_attention(*a, **kw)
        calls5.append((a, kw))
        return out

    wtoks = torch.from_numpy(np.random.default_rng(SEED + 33).integers(
        1, rcfg.vocab_size, (1, 2 * rcfg.window_size)).astype(
            np.int32)).to(dev)
    model_layers.flash_attention = rec5
    ops.reset_launch_counts()
    try:
        with torch.no_grad():
            hidden, _ = forward(rparams, wtoks, wcfg, return_hidden=True)
        torch.cuda.synchronize()
    finally:
        model_layers.flash_attention = flash_attention
    wcount = ops.launch_counts()
    if wcount["flash_attention"] != 8 or len(calls5) != 8 or \
            sum(wcount.values()) != 8 or not torch.isfinite(hidden).all():
        fail(f"phase 18b: the windowed forward launched {wcount}")
    h, kh, hd = rcfg.num_heads, rcfg.num_kv_heads, rcfg.resolved_head_dim
    sw, win = wtoks.shape[1], rcfg.window_size
    for a, kw in calls5:
        if kw.get("window") != win or a[0].shape != (1, sw, h, hd):
            fail(f"phase 18b: kernel 5 was called with {a[0].shape} {kw}")
        e5 = max(e5, allclose_bar(flash_attention(*a, **kw),
                                  flash_attention_ref(*a, **kw),
                                  "phase 18b: a windowed kernel-5 call",
                                  quiet=True))
    a32 = [t.float() for t in calls5[0][0]]
    allclose_bar(flash_attention(*a32, causal=True, window=win),
                 flash_attention_ref(*a32, causal=True, window=win),
                 f"phase 18b: kernel 5 at D = {hd}, window {win}, f32 (FMA "
                 f"kernel)", rtol=1e-5, atol=2e-5)
    log(f"phase 18b: kernel 5's {len(calls5)} windowed calls (1 x {sw}, "
        f"{h} / {kh} heads of {hd}, window {win}) against the plain version "
        f"(rtol 2**-7, atol 1e-5): max-abs {e5:.3g}")
    b_, d_, f_ = k5_cost(1, sw, sw, h, kh, hd, True, win)
    bms, by = bound(b_ * 8, 0.0, f_ * 8, d_ * 8)
    qpos = torch.arange(sw, device=dev)
    mask = (qpos[None, :] <= qpos[:, None]) \
        & (qpos[None, :] > qpos[:, None] - win)
    sdpa_in = [(q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(
        h // kh, dim=1), v.transpose(1, 2).repeat_interleave(h // kh, dim=1))
        for (q, k, v), _ in calls5]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sd_err = float((sdpa(*sdpa_in[0], attn_mask=mask).transpose(1, 2)
                    .float() - flash_attention(*calls5[0][0], **calls5[0][1])
                    .float()).abs().max())
    win5 = {"ms": graph_ms(lambda: [flash_attention(*a, **kw)
                                    for a, kw in calls5], 10)[0],
            "plain_ms": median_ms(lambda: [flash_attention_ref(*a, **kw)
                                           for a, kw in calls5], 1),
            "bound_ms": bms, "bound_by": by,
            "library_ms": graph_ms(lambda: [sdpa(*t, attn_mask=mask)
                                            for t in sdpa_in], 10)[0],
            "sdpa_max_abs": sd_err,
            "work": f"8 layers x (1, {sw}, {h} / {kh} heads of {hd}), "
                    f"causal, window {win}, bf16"}
    log(f"phase 18b: kernel 5 over the windowed forward's 8 calls: "
        f"{json.dumps(win5)}")
    res["k5_d256_window"] = win5
    del calls5, sdpa_in, hidden, mask
    ops.reset_launch_counts()
    lap("18b window")

    # 18c. Training at full width on batches of TRAIN_BATCH x (TRAIN_SEQ +
    # 1): xlstm-350m through the driver (float, checkpoint, resume), QAT
    # abfp_kernel, DNF; recurrentgemma-2b float and QAT abfp_kernel.  Steps
    # donate their state (one optimizer state on the card).
    def steps_run(mcfg, params, quant, n, what):
        init, step = make_train_step(mcfg, AdamW(constant(1e-4)),
                                     TrainConfig(quant=quant), device=dev,
                                     donate=True)
        dcfg = DataConfig(mcfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, SEED)
        st, times, losses = init(tree_map(torch.clone, params)), [], []
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, met = step(st, batch_at_step(dcfg, i),
                           prng.fold_in(prng.PRNGKey(SEED + 34), i))
            losses.append(float(met["loss"]))
            gn = float(met["grad_norm"])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if not (np.isfinite(losses[-1]) and np.isfinite(gn)):
                fail(f"{what}: non-finite loss or grad_norm")
        moved_all(st.params, params, what)
        log(f"{what}: losses {losses}, step {[round(t, 4) for t in times]} "
            f"s, every weight moved")
        return times

    _, xparams, _ = models["xlstm-350m"]
    ck = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        f1, _ = measured("xlstm_float", lambda: run_train_driver(
            ["--steps", "4", "--ckpt-every", "2", "--ckpt-dir", ck],
            "xlstm-350m"))
        f2, text = run_train_driver(["--steps", "6", "--ckpt-every", "2",
                                     "--ckpt-dir", ck], "xlstm-350m")
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    if "[train] resumed from step 4" not in text or f2["start_step"] != 4 \
            or len(f2["losses"]) != 2:
        fail("phase 18c: the xlstm-350m driver did not resume from step 4")
    moved_all(f2["state"].params, xparams, "phase 18c: the xlstm driver")
    res["steps_s"]["xlstm_float"] = f1["step_s"][1:] + f2["step_s"][1:]
    del f1, f2
    lap("18c xlstm driver and resume")

    qkeys = [prng.fold_in(prng.PRNGKey(SEED + 35), i) for i in range(2)]
    qat = {}
    for arch in ("xlstm-350m", "recurrentgemma-2b"):
        mcfg, params, _ = models[arch]
        short = arch.split("-")[0]
        dcfg = DataConfig(mcfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, SEED)
        if arch == "recurrentgemma-2b":
            res["steps_s"]["recurrentgemma_float"] = measured(
                "recurrentgemma_float", lambda: steps_run(
                    mcfg, params, QuantConfig(mode="float"), 2,
                    "phase 18c: recurrentgemma-2b float"))
        per_step = {n: 0 for n in ops.launch_counts()}
        per_step["abfp_matmul"] = res[short]["launches_per_forward"][
            "abfp_matmul"]

        def measured_q(mode, fn, short=short):
            return measured(f"{short}_{mode}", fn)

        qk = qat_kernel_checks(dev, params, mcfg, dcfg, kq, per_step, qkeys,
                               measured_q, f"phase 18c {arch}", donate=True)
        if qk["moved"] != len(leaves(params)):
            fail(f"phase 18c: {arch} QAT abfp_kernel moved {qk['moved']} of "
                 f"{len(leaves(params))} weights")
        res["steps_s"][f"{short}_qat_abfp_kernel"] = qk.pop("steps_s")
        qat[arch] = qk
        lap(f"18c {arch} QAT abfp_kernel")

    # DNF on xlstm-350m: 18a's histograms, the top half of the layers by
    # std, 3 steps.
    mcfg, params, hists = models["xlstm-350m"]
    nl = mcfg.num_layers
    mask = select_layers_by_std([hists.layer(i) for i in range(nl)], 0.5)
    dinit, dstep = make_dnf_train_step(mcfg, AdamW(constant(1e-4)), hists,
                                       layer_mask=mask, device=dev)
    dcfg = DataConfig(mcfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, SEED)

    def dnf_run():
        st, times, losses = dinit(params), [], []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, met = dstep(st, batch_at_step(dcfg, i),
                            prng.fold_in(prng.PRNGKey(SEED + 36), i))
            losses.append(float(met["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        moved_all(st.params, params, "phase 18c: xlstm-350m DNF")
        return times, losses

    times, d_losses = measured("xlstm_dnf", dnf_run)
    if not np.isfinite(d_losses).all() or sum(mask) < nl // 2:
        fail(f"phase 18c: xlstm-350m DNF losses {d_losses}, mask {mask}")
    res["steps_s"]["xlstm_dnf"] = times
    log(f"phase 18c: xlstm-350m DNF (noise on layers "
        f"{[i for i, v in enumerate(mask) if v]}), 3 steps: losses "
        f"{d_losses}, step {[round(t, 4) for t in times]} s")
    lap("18c xlstm DNF")
    res["step_median_ms"] = {
        k: statistics.median(v[1:] if len(v) > 1 else v) * 1e3
        for k, v in res["steps_s"].items()}
    res["qat"] = qat
    for k, v in res["step_median_ms"].items():
        log(f"phase 18c: train step {k}: median {v:.2f} ms (steps "
            f"{[round(t * 1e3, 2) for t in res['steps_s'][k]]} ms), peak "
            f"device memory {res['peak_gib'].get(k, float('nan')):.3f} GiB")
    del models, params, hists, xparams, rparams
    gc.collect()
    torch.cuda.empty_cache()

    for row in rows:
        if row["name"] == "abfp_matmul":
            row["launches_per_recurrentgemma_forward"] = res["recurrentgemma"][
                "launches_per_forward"]["abfp_matmul"]
            row["launches_per_xlstm_forward"] = res["xlstm"][
                "launches_per_forward"]["abfp_matmul"]
            row["qat_step_launches_recurrentgemma"] = [
                c["abfp_matmul"] for c in qat["recurrentgemma-2b"]["counts"]]
            row["qat_step_launches_xlstm"] = [
                c["abfp_matmul"] for c in qat["xlstm-350m"]["counts"]]
        if row["name"] == "flash_attention":
            row["launches_per_recurrentgemma_forward"] = res["recurrentgemma"][
                "launches_per_forward"]["flash_attention"]
            row["d256_window"] = win5
            row["max_abs_err"] = max(row["max_abs_err"], e5)
    for q in qat.values():
        q.pop("counts")
    res["seconds"] = time.perf_counter() - t_phase
    return res


def abfp_ref_phase(dev, engine_cls, reqs, card: str) -> dict:
    """Phase 19: the paper's reference numerics served (``--quant abfp``:
    ``abfp_ref``, the tile scan on float weights, every dense call's key
    from the pass's device key table, the noise drawn on the card inside
    the captured passes; see the module docstring).  ``engine_cls`` is
    phase 4's NaN-checking engine, ``reqs`` phase 4's workload.  Returns
    the measurements."""
    import torch

    from repro_torch.core import prng
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import Numerics, init_params, prefill
    from repro_torch.serving import EncDecRunner, Request
    from repro_torch.serving.runners import state_tensors

    t_phase = time.perf_counter()
    res = {"card": card}
    shapes = [("decode",)] + [("prefill", c) for c in (16, 64, 128)]

    class HostKeyed(Numerics):
        """A pass's root Numerics that stays in key mode: every dense call
        gets its host key (split and copied to the card per call), the
        scan's route before the key table."""

        def as_table(self, *a, **kw):
            return self

    def zero_launches(what):
        got = ops.launch_counts()
        if any(got.values()):
            fail(f"phase 19 {what}: kernels 1-5 were launched: {got}")

    def serve_run(e, rs, what):
        """Serve ``rs`` on ``e`` (warmed), the launch counts zeroed just
        before and read just after: every request finished, no kernel
        1-5 launched; returns (streams, measurements)."""
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        fin = e.run(rs)
        e.close()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        zero_launches(what)
        if len(fin) != len(rs) or any(
                not r.done or len(r.generated) != r.max_new_tokens
                for r in fin):
            fail(f"phase 19 {what}: {len(fin)} of {len(rs)} finished")
        med, cnt = e.pass_stats()
        toks = sum(len(r.generated) for r in fin)
        out = {"wall_s": wall, "tokens": toks, "tokens_per_s": toks / wall,
               "decode_ms": med["decode"] * 1e3,
               "prefill_ms": med["prefill"] * 1e3, "passes_by_kind": cnt,
               "tick_utilization": e.metrics.tick_utilization()["value"],
               "launches": ops.launch_counts()}
        log(f"phase 19 {what}: {len(fin)}/{len(rs)} requests, {toks} tokens "
            f"in {wall:.3f}s ({out['tokens_per_s']:.2f} tokens/s), decode "
            f"tick median {out['decode_ms']:.3f} ms, prefill pass median "
            f"{out['prefill_ms']:.3f} ms ({cnt}), tick_utilization "
            f"{out['tick_utilization']:.4f}, kernels 1-5 launched 0 times")
        return {r.uid: list(r.generated) for r in fin}, out

    # 19a. smollm-360m at full width as ``--full --quant abfp`` configures
    # it, cut to its first ABFP_REF_LAYERS layers: bf16 weights from the
    # seed, kept float (no packing).
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = serve_cli.build_parser().parse_args(
        ["--full", "--quant", "abfp", "--capacity", str(CAPACITY),
         "--max-len", str(MAX_LEN), "--max-new", str(MAX_NEW), "--seed",
         str(SEED)])
    mcfg, quant = serve_cli.model_and_quant(args)
    if (mcfg.name, quant.mode, quant.tile_width, quant.gain,
            quant.noise_lsb) != ("smollm-360m", "abfp_ref", 128, 8.0, 0.5):
        fail(f"phase 19: unexpected serving config {mcfg.name} {quant}")
    mcfg = dataclasses.replace(mcfg, num_layers=ABFP_REF_LAYERS)
    params = init_params(SEED, mcfg, device=dev)

    def engine(**kw):
        return engine_cls(params, mcfg, capacity=CAPACITY, max_len=MAX_LEN,
                          quant=quant, seed=SEED, device=dev, **kw)

    def requests():
        return [Request(uid=r.uid, prompt=list(r.prompt),
                        max_new_tokens=MAX_NEW)
                for r in reqs[:ABFP_REF_REQUESTS]]

    xeng = engine(_graphs=False)
    init_state = [t.clone() for t in state_tensors(xeng.state)]
    want, res["eager"] = serve_run(xeng, requests(), "smollm-360m [eager]")
    served = [t.clone() for t in state_tensors(xeng.state)]

    geng = engine()
    capture = {}
    for k in shapes:
        t1 = time.perf_counter()
        geng._executable(k)
        torch.cuda.synchronize()
        capture["".join(str(p_) for p_ in k)] = time.perf_counter() - t1
    geng._warmed_shapes.clear()
    res["capture_s"] = capture
    res["kernels_per_replay"] = {}
    log(f"phase 19: captured {len(shapes)} pass shapes in "
        f"{sum(capture.values()):.2f}s: {json.dumps(capture)}")

    # Every captured shape's replay against the eager pass from the eager
    # run's final state under two pass keys: logits (and the whole state)
    # bit-equal, the two keys' logits different.
    replay_against_eager(geng, xeng, served, shapes, mcfg.vocab_size,
                         np.random.default_rng(SEED + 29), "phase 19")
    zero_launches("replays")

    # The first pass of the workload (the first four prompts, bucket 128,
    # the engine's first pass key) by replay against the same pass through
    # the host-key scan: logits bit-equal.
    first = reqs[:CAPACITY]
    width = 128
    toks = np.zeros((CAPACITY, width), np.int64)
    for i, r in enumerate(first):
        toks[i, :len(r.prompt)] = r.prompt
    n_tok = np.array([len(r.prompt) for r in first])
    key = prng.split(prng.PRNGKey(SEED))[1]
    for t, src in zip(state_tensors(geng.state), init_state):
        t.copy_(src)
    io, _ = geng._call(("prefill", width), key, tokens=toks,
                       n_tokens=n_tok, prev_mask=np.zeros(CAPACITY, bool))
    lg_graph = io.logits.clone()
    hstate = xeng.runner.init_state(CAPACITY, MAX_LEN, dev)
    t1 = time.perf_counter()
    lg_host, _ = prefill(params, hstate, torch.from_numpy(toks).to(dev),
                         torch.from_numpy(n_tok).to(dev), mcfg,
                         HostKeyed(quant, key))
    torch.cuda.synchronize()
    res["host_key_prefill_s"] = time.perf_counter() - t1
    if not torch.equal(lg_graph, lg_host.float()):
        fail(f"phase 19: the first prefill pass by replay differs from the "
             f"host-key scan's (max-abs "
             f"{float((lg_graph - lg_host.float()).abs().max()):.4g})")
    log(f"phase 19: the first prefill pass ({n_tok.tolist()} tokens) by "
        f"replay (device key table) equals the host-key scan's bit for "
        f"bit ({res['host_key_prefill_s']:.2f}s host-keyed)")

    # The served runs: graphs (blocking, simulated clock, the captured
    # engine from its initial state) and graphs + overlap (wall clock),
    # each with the eager run's streams.
    for t, src in zip(state_tensors(geng.state), init_state):
        t.copy_(src)
    streams, res["graphs"] = serve_run(geng, requests(),
                                       "smollm-360m [graphs]")
    if streams != want:
        fail(f"phase 19: the graphs run's streams differ from eager: "
             f"{[u for u in want if streams[u] != want[u]]}")
    oeng = engine(clock=time.perf_counter, overlap=True)
    for k in shapes[:1] + shapes[-1:]:      # the shapes the workload runs
        oeng._executable(k)
    oeng._warmed_shapes.clear()
    torch.cuda.synchronize()
    streams, res["overlap"] = serve_run(oeng, requests(),
                                        "smollm-360m [graphs + overlap]")
    if streams != want:
        fail(f"phase 19: the overlapped run's streams differ from eager: "
             f"{[u for u in want if streams[u] != want[u]]}")
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["reserved_gib"] = torch.cuda.memory_reserved() / 2**30
    log(f"phase 19: smollm-360m abfp_ref streams equal eager / graphs / "
        f"overlap; peak device memory {res['peak_gib']:.3f} GiB with "
        f"{len(geng._passes) + len(oeng._passes)} pass shapes captured "
        f"({res['reserved_gib']:.3f} "
        f"GiB reserved)")

    # Where a replay's device time goes: a decode tick and a 128-token
    # prefill pass, and the share of int64 elementwise kernels (the
    # threefry's operations).
    fields = {"decode": dict(tokens=np.ones((CAPACITY, 1), np.int64),
                             n_tokens=np.ones(CAPACITY, np.int64),
                             prev_mask=np.zeros(CAPACITY, bool)),
              "prefill128": dict(tokens=toks, n_tokens=n_tok,
                                 prev_mask=np.zeros(CAPACITY, bool))}
    res["profile"] = {}
    for name, shape in (("decode", ("decode",)),
                        ("prefill128", ("prefill", 128))):
        for t, src in zip(state_tensors(geng.state), served):
            t.copy_(src)
        prof = profile_pass(
            dev, lambda: geng._call(shape, key, **fields[name]),
            f"phase 19 {name} replay", cpu=False)
        res["profile"][name] = prof
        if prof is not None:
            res["kernels_per_replay"][name] = prof["kernels"]
            prof["int64_share"] = prof["int64_ms"] / prof["device_busy_ms"]
            log(f"phase 19 {name} replay: the int64 elementwise kernels "
                f"(the threefry) take {prof['int64_share']:.1%} of its "
                f"device time")
    geng.close()
    del xeng, geng, oeng, params
    gc.collect()
    torch.cuda.empty_cache()

    # 19b. whisper-base at full width in abfp_ref, 4 requests with 1,500
    # stub frames each (phase 15's prompts and features), eagerly and
    # with graphs: streams equal; the captured admission pass (its key
    # table's encoder rows and root row) against the eager admission.
    wl = WORKLOADS["whisper-base"]
    args = serve_cli.build_parser().parse_args(
        ["--arch", "whisper-base", "--full", "--quant", "abfp",
         "--capacity", str(CAPACITY), "--max-len", str(WHISPER_MAX_LEN),
         "--max-new", str(MAX_NEW), "--seed", str(SEED)])
    wcfg, wquant = serve_cli.model_and_quant(args)
    wparams = init_params(SEED, wcfg, device=dev)
    runner = EncDecRunner(wcfg, enc_len=WHISPER_FRAMES)

    def wrequests():
        return [Request(uid=i, prompt=list(p), max_new_tokens=MAX_NEW,
                        features=wl["features"][i])
                for i, p in enumerate(wl["prompts"][:ABFP_REF_REQUESTS])]

    def wengine(**kw):
        return engine_cls(wparams, wcfg, capacity=CAPACITY,
                          max_len=WHISPER_MAX_LEN, runner=runner,
                          quant=wquant, seed=SEED, device=dev, **kw)

    wx = wengine(_graphs=False)
    wwant, res["whisper_eager"] = serve_run(wx, wrequests(),
                                            "whisper-base [eager]")
    wg = wengine()
    t1 = time.perf_counter()
    wg.warmup()
    torch.cuda.synchronize()
    res["whisper_capture_s"] = time.perf_counter() - t1
    wstreams, res["whisper_graphs"] = serve_run(wg, wrequests(),
                                                "whisper-base [graphs]")
    if wstreams != wwant:
        fail(f"phase 19: whisper's graphs streams differ from eager: "
             f"{[u for u in wwant if wstreams[u] != wwant[u]]}")
    wserved = [t.clone() for t in state_tensors(wx.state)]
    encs = []
    for uid in (100, 101):
        req = Request(uid=uid, prompt=[1], max_new_tokens=1,
                      features=wl["features"][uid % ABFP_REF_REQUESTS])
        outs = []
        for e in (wg, wx):
            for dst, src in zip(state_tensors(e.state), wserved):
                dst.copy_(src)
            e._admit_pass(1, req)
            outs.append([x.clone() for x in state_tensors(e.state)])
        if not all(torch.equal(a, b) for a, b in zip(*outs)):
            fail(f"phase 19: whisper's admission pass of uid {uid} by "
                 f"replay differs from the eager pass")
        encs.append([x.clone() for e_ in wx.state["enc"]
                     for x in (e_["k"][1], e_["v"][1])])
    if all(torch.equal(a, b) for a, b in zip(*encs)):
        fail("phase 19: two admission keys gave equal cross K/V")
    if wg._passes[("admit",)].graph is None:
        fail("phase 19: whisper's admission pass was not captured")
    zero_launches("whisper admissions")
    admit_ms = []
    req0 = Request(uid=0, prompt=[1], max_new_tokens=1,
                   features=wl["features"][0])
    for _ in range(3):
        t1 = time.perf_counter()
        wg._admit_pass(0, req0)
        torch.cuda.synchronize()
        admit_ms.append((time.perf_counter() - t1) * 1e3)
    res["whisper_admit_ms"] = admit_ms
    log(f"phase 19: whisper-base abfp_ref streams equal eager / graphs; the "
        f"admission pass by replay equals eager under two request keys, "
        f"the keys' cross K/V differ; admission replay host ms "
        f"{[round(v, 2) for v in admit_ms]}")
    wg.close()
    del wx, wg, wparams
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    return res


def mesh_phase(dev, engine_cls, reqs, card: str, rows: list) -> dict:
    """Phase 20: tensor-parallel serving on virtual meshes (see the module
    docstring).  ``engine_cls`` is phase 4's NaN-checking engine that
    records each pass's launches, ``reqs`` phase 4's workload, ``rows``
    the kernel rows.  Returns the measurements."""
    import torch

    from repro_torch.core.abfp import QuantConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.abfp_decode_fused import (
        _fused_qkv_packed,
        concat_qkv,
        fused_qkv_packed_ref,
    )
    from repro_torch.kernels.abfp_matmul import (
        DECODE_ROWS,
        TWO_LAUNCH,
        _abfp_matmul,
        _abfp_matmul_packed,
        abfp_matmul_packed_ref,
        abfp_matmul_ref,
        fused_rows,
    )
    from repro_torch.kernels.ops import shard_columns
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.models.packing import pack_model_params
    from repro_torch.serving import Request
    from repro_torch.serving.runners import state_tensors

    t_phase = time.perf_counter()
    res = {"card": card}
    args = serve_cli.build_parser().parse_args(
        ["--full", "--fused", "--arch", MESH_ARCH, "--capacity",
         str(CAPACITY), "--max-len", str(MAX_LEN), "--max-new", str(MAX_NEW),
         "--seed", str(SEED)])
    mcfg, quant = serve_cli.model_and_quant(args)
    if (mcfg.name, mcfg.num_layers, mcfg.d_model, mcfg.d_ff,
            mcfg.vocab_size, quant.mode) != (MESH_ARCH, 22, 2048, 5632,
                                             32000, "abfp_fused"):
        fail(f"phase 20: unexpected serving config {mcfg.name} {quant}")
    params = init_params(SEED, mcfg, device=dev)
    packed = pack_model_params(params, quant, mcfg)
    torch.cuda.synchronize()
    lp = packed["layers"][0]
    gen = torch.Generator(device=dev).manual_seed(20)
    seeds = torch.tensor([2024, -5, 77], dtype=torch.int32, device=dev)

    def act(m, k):
        return torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)

    def same(got, want, what):
        n, size, ulp, _ = bf16_diff(got, want)
        if ulp:
            fail(f"phase 20a {what}: {n}/{size} one-ULP flips, largest {ulp}")

    def shards_check(what, tp, whole, outs, plains, unshifted=None):
        """Every shard's output against its columns of the one-device
        output and its plain version; a shard without its offset must
        differ (its noise is another block's)."""
        col = 0
        for t, (o, pl) in enumerate(zip(outs, plains)):
            same(o, whole[:, col:col + o.shape[1]],
                 f"{what} tp={tp} shard {t} against the one-device columns")
            same(o, pl, f"{what} tp={tp} shard {t} against its plain version")
            col += o.shape[1]
        if col != whole.shape[1]:
            fail(f"phase 20a {what} tp={tp}: the shards hold {col} columns, "
                 f"the one-device output {whole.shape[1]}")
        if unshifted is not None and torch.equal(unshifted, outs[-1]):
            fail(f"phase 20a {what} tp={tp}: the last shard without its "
                 f"offset equals it with the offset")

    # 20a. the column-shard inputs of kernels 1, 2 and 4.
    t_a = time.perf_counter()
    wi = lp["mlp"]["wi"]
    n, nb = quant.tile_width, wi.n_padded // 128
    routes = (("decode", 4, DECODE_ROWS),
              ("fused", 512, fused_rows(512, n, nb, quant, wi.num_tiles)),
              ("two-launch", 512, TWO_LAUNCH))
    qkv3 = {2: (lp["attn"]["wq"], lp["attn"]["wk"], lp["attn"]["wv"]),
            4: (lp["attn"]["wq"], lp["mlp"]["wi"], lp["mlp"]["wg"])}
    qk = QuantConfig(mode="abfp_kernel", tile_width=quant.tile_width,
                     gain=quant.gain, noise_lsb=quant.noise_lsb)
    wf = params["layers"][0]["mlp"]["wi"]
    timing, checked = {}, 0
    for tp in (2, 4):
        sh = shard_columns(wi, tp)
        for route, m, rws in routes:
            x = act(m, wi.k)
            whole = _abfp_matmul_packed(x, wi, quant, seeds[:1], rws)
            outs, plains = [], []
            for t, w_ in enumerate(sh.shards):
                off, nj = sh.grid(t)
                outs.append(_abfp_matmul_packed(x, w_, quant, seeds[:1], rws,
                                                off, nj))
                plains.append(abfp_matmul_packed_ref(
                    x, w_, quant, seeds[:1], col_block_offset=off,
                    num_col_blocks=nj))
            shards_check(f"kernel 1 mlp.wi {route} M={m}", tp, whole, outs,
                         plains, _abfp_matmul_packed(
                             x, sh.shards[-1], quant, seeds[:1], rws))
            checked += tp
        # Kernel 2 at decode size over three segments that all split.
        pws = qkv3[tp]
        pqkv = concat_qkv(pws, quant)
        x = act(4, pws[0].k)
        whole = _fused_qkv_packed(x, pws, quant, seeds, pqkv, DECODE_ROWS)
        shs = [shard_columns(w_, tp) for w_ in pws]
        locs, grids, outs, plains = [], [], [[], [], []], [[], [], []]
        for t in range(tp):
            loc = tuple(s_.shards[t] for s_ in shs)
            offs, njs = zip(*(s_.grid(t) for s_ in shs))
            locs.append((loc, concat_qkv(loc, quant)))
            grids.append((offs, njs))
            got = _fused_qkv_packed(x, loc, quant, seeds, locs[-1][1],
                                    DECODE_ROWS, offs, njs)
            want = fused_qkv_packed_ref(x, loc, quant, seeds,
                                        col_block_offsets=offs,
                                        num_col_blocks=njs)
            for i in range(3):
                outs[i].append(got[i])
                plains[i].append(want[i])
        for i, name in enumerate(("wq", "wk", "wv") if tp == 2
                                 else ("wq", "mlp.wi", "mlp.wg")):
            shards_check(f"kernel 2 segment {name} M=4", tp, whole[i],
                         outs[i], plains[i])
        checked += 3 * tp
        # Kernel 4: the weight quantizer on a float column shard, then
        # kernel 1's launch at the shard's offset.
        shf = shard_columns(wf, tp)
        x = act(512, wf.shape[0])
        whole4 = _abfp_matmul(x, wf, qk, seeds[:1], None)
        outs4, plains4 = [], []
        for t, w_ in enumerate(shf.shards):
            off, nj = shf.grid(t)
            outs4.append(_abfp_matmul(x, w_, qk, seeds[:1], None, off, nj))
            plains4.append(abfp_matmul_ref(x, w_, qk, seeds[:1],
                                           col_block_offset=off,
                                           num_col_blocks=nj))
        shards_check("kernel 4 mlp.wi M=512", tp, whole4, outs4, plains4,
                     _abfp_matmul(x, shf.shards[-1], qk, seeds[:1], None))
        checked += tp

        # Device times: the one-device launch against its tp shard
        # launches (graph replay), at the serving shapes (kernels 1-2 at
        # M = 4, kernel 4 at M = 512).
        x4 = act(4, wi.k)
        x512 = act(512, wf.shape[0])
        fns = {
            "abfp_matmul_packed": (
                lambda: _abfp_matmul_packed(x4, wi, quant, seeds[:1], None),
                lambda: [_abfp_matmul_packed(x4, w_, quant, seeds[:1], None,
                                             *sh.grid(t))
                         for t, w_ in enumerate(sh.shards)]),
            "fused_qkv_packed": (
                lambda: _fused_qkv_packed(x4, pws, quant, seeds, pqkv, None),
                lambda: [_fused_qkv_packed(x4, lc, quant, seeds, q3, None,
                                           *g_)
                         for (lc, q3), g_ in zip(locs, grids)]),
            "abfp_matmul": (
                lambda: _abfp_matmul(x512, wf, qk, seeds[:1], None),
                lambda: [_abfp_matmul(x512, w_, qk, seeds[:1], None,
                                      *shf.grid(t))
                         for t, w_ in enumerate(shf.shards)]),
        }
        for name, (one, per_shard) in fns.items():
            turns = in_turns({"one": one, "shards": per_shard},
                             lambda f: graph_ms(f, 20)[0])
            timing.setdefault(name, {})[f"tp{tp}"] = {
                "one_device_ms": statistics.mean(turns["one"]),
                "shards_ms": statistics.mean(turns["shards"]),
                "per_shard_ms": statistics.mean(turns["shards"]) / tp,
                "turns_ms": turns}
    res["kernel_checks"] = {"shard_launches_checked": checked,
                            "flips": 0, "seconds": time.perf_counter() - t_a}
    res["shard_timing"] = timing
    log(f"phase 20a: {checked} shard launches of kernels 1, 2 and 4 at tp 2 "
        f"and 4 (kernel 1 on the decode, fused and two-launch routes) "
        f"bit-equal to the one-device columns and to their plain versions "
        f"with their offsets (0 flips), a shard without its offset "
        f"different; device ms (one device / all shards): "
        + json.dumps({k: {t: [round(v["one_device_ms"], 4),
                              round(v["shards_ms"], 4)]
                          for t, v in d.items()}
                      for k, d in timing.items()}))
    del sh, shs, shf, locs
    gc.collect()
    torch.cuda.empty_cache()

    # 20b. the workload served without a mesh and on each mesh.
    vocab = mcfg.vocab_size
    shapes = [("decode",)] + [("prefill", c) for c in (16, 64, 128)]

    def requests():
        return [Request(uid=r.uid,
                        prompt=[t % (vocab - 1) + 1 for t in r.prompt],
                        max_new_tokens=MAX_NEW) for r in reqs]

    names = ("abfp_matmul_packed", "fused_qkv_packed",
             "fused_quantized_decode_attention")
    want = None
    res["serve"] = {}
    for shape in ((1, 1),) + MESH_SHAPES:
        label = "none" if shape == (1, 1) else f"{shape[0]}x{shape[1]}"
        mesh = None if shape == (1, 1) else make_host_mesh(*shape, dev)
        t1 = time.perf_counter()
        mp = packed if mesh is None else pack_model_params(packed, quant,
                                                           mcfg, mesh=mesh)

        def engine(**kw):
            return engine_cls(mp, mcfg, capacity=CAPACITY, max_len=MAX_LEN,
                              quant=quant, seed=SEED, device=dev, mesh=mesh,
                              **kw)

        geng = engine()
        capture = {}
        for k in shapes:
            t2 = time.perf_counter()
            geng._executable(k)
            torch.cuda.synchronize()
            capture["".join(str(p_) for p_ in k)] = time.perf_counter() - t2
        geng._warmed_shapes.clear()
        setup = time.perf_counter() - t1
        rs = requests()
        ops.reset_launch_counts()
        t2 = time.perf_counter()
        fin = geng.run(rs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t2
        counts = ops.launch_counts()
        if len(fin) != len(rs) or any(
                not r.done or len(r.generated) != r.max_new_tokens
                for r in fin):
            fail(f"phase 20b mesh {label}: {len(fin)} of {len(rs)} finished")
        streams = {r.uid: list(r.generated) for r in fin}
        if want is None:
            want = streams
        elif streams != want:
            fail(f"phase 20b mesh {label}: the streams of requests "
                 f"{[u for u in want if streams[u] != want[u]]} differ from "
                 f"the run without a mesh")
        tp = shape[1]
        for kind in ("decode", "prefill"):
            exp = {k: v for k, v in zip(names, MESH_LAUNCHES[tp][kind]) if v}
            if not geng.per_pass[kind]:
                fail(f"phase 20b mesh {label}: no {kind} pass ran")
            for got in geng.per_pass[kind]:
                if {k: v for k, v in got.items() if v} != exp:
                    fail(f"phase 20b mesh {label}: a {kind} pass launched "
                         f"{got}, want {exp}")
        med, cnt = geng.pass_stats()
        toks = sum(len(r.generated) for r in fin)
        r_ = {"setup_s": setup, "capture_s": capture, "wall_s": wall,
              "tokens": toks, "tokens_per_s": toks / wall,
              "decode_ms": med["decode"] * 1e3,
              "prefill_ms": med["prefill"] * 1e3, "passes_by_kind": cnt,
              "launches": counts,
              "launches_per_decode_tick": geng.per_pass["decode"][0],
              "launches_per_prefill_pass": geng.per_pass["prefill"][0]}
        served = [t.clone() for t in state_tensors(geng.state)]
        xeng = engine(_graphs=False)
        replay_against_eager(geng, xeng, served, shapes, vocab,
                             np.random.default_rng(SEED + 20),
                             f"phase 20b mesh {label}")
        res["serve"][label] = r_
        log(f"phase 20b mesh {label}: {len(fin)}/{len(rs)} requests, {toks} "
            f"tokens in {wall:.3f}s ({r_['tokens_per_s']:.1f} tokens/s), "
            f"graphs decode tick median {r_['decode_ms']:.3f} ms, prefill "
            f"pass median {r_['prefill_ms']:.3f} ms ({cnt}), launches per "
            f"decode tick {r_['launches_per_decode_tick']}, per prefill pass "
            f"{r_['launches_per_prefill_pass']}, streams equal to the run "
            f"without a mesh; set-up {setup:.1f}s")
        del geng, xeng, served, mp
        gc.collect()
        torch.cuda.empty_cache()

    for row in rows:
        name = row["name"]
        row["launches_mesh_serve"] = {
            k: v["launches"].get(name, 0) for k, v in res["serve"].items()}
        if name in timing:
            row["tp_shard_ms"] = timing[name]
    res["seconds"] = time.perf_counter() - t_phase
    return res, want


def mesh_train_phase(dev, engine_cls, reqs, want_streams, no_mesh_forward,
                     card: str, rows: list) -> dict:
    """Phase 21: the training mesh and faults on a mesh (see the module
    docstring).  ``engine_cls`` is phase 4's NaN-checking engine that
    records each pass's launches, ``reqs`` phase 4's workload,
    ``want_streams`` phase 20b's streams, ``no_mesh_forward`` phase 14c's
    launches of one granite forward without a mesh.  Annotates kernel 4's
    row with its launches per mesh step; returns the measurements."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.core.abfp import QuantConfig
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.data import DataConfig, batch_at_step
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import forward, init_params, param_count
    from repro_torch.models.packing import pack_model_params
    from repro_torch.optim import AdamW, constant
    from repro_torch.serving import FaultConfig, FaultPlan, Request
    from repro_torch.serving.faults import FaultEvent
    from repro_torch.training import (
        TrainConfig,
        chunked_cross_entropy,
        make_train_step,
    )
    from repro_torch.training.train_lib import tokens_on

    t_phase = time.perf_counter()
    res = {"card": card, "steps_s": {}, "peak_gib": {}, "losses": {}}

    def measured(mode, fn):
        """Run ``fn`` with the peak-memory counter reset just before."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        res["peak_gib"][mode] = torch.cuda.max_memory_allocated() / 2 ** 30
        return out

    # 21a. full-width granite trained on virtual meshes.
    mcfg = get_config(MESH_TRAIN_ARCH)
    if (mcfg.num_layers, mcfg.d_model, mcfg.num_experts,
            mcfg.experts_per_token, mcfg.d_ff, mcfg.vocab_size,
            mcfg.param_dtype, mcfg.remat) != (
                24, 1024, 32, 8, 512, 49155, torch.bfloat16, False):
        fail(f"phase 21: unexpected config {mcfg}")
    t0 = time.perf_counter()
    params = init_params(SEED, mcfg, device=dev)
    torch.cuda.synchronize()
    log(f"phase 21a: {MESH_TRAIN_ARCH} ({param_count(params) / 1e9:.3f} B "
        f"parameters) built in {time.perf_counter() - t0:.1f}s")
    dcfg = DataConfig(mcfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, SEED)
    kq = QuantConfig(mode="abfp_kernel", tile_width=128, gain=8.0,
                     noise_lsb=0.5)
    keys = [prng.fold_in(prng.PRNGKey(SEED + 21), i)
            for i in range(MESH_TRAIN_STEPS)]
    per_step = {name: 0 for name in ops.launch_counts()}
    per_step["abfp_matmul"] = MESH_TRAIN_K4

    def float_steps(mesh, label):
        init, step = make_train_step(mcfg, AdamW(constant(1e-4)),
                                     TrainConfig(), device=dev, donate=True,
                                     mesh=mesh)

        def run():
            st, times, losses = init(tree_map(torch.clone, params)), [], []
            for i, key in enumerate(keys):
                batch = batch_at_step(dcfg, i)
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                t1 = time.perf_counter()
                st, met = step(st, batch, key)
                losses.append([float(met[k]) for k in ("loss", "aux_loss",
                                                       "grad_norm")])
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t1)
                if sum(ops.launch_counts().values()):
                    fail(f"{label}: a float step launched "
                         f"{ops.launch_counts()}")
            moved = sum(not torch.equal(a, b)
                        for a, b in zip(leaves(st.params), leaves(params)))
            return times, losses, moved

        times, losses, moved = measured(label, run)
        if not np.isfinite(losses).all() or moved != len(leaves(params)):
            fail(f"{label}: losses {losses}, {moved} of "
                 f"{len(leaves(params))} weights moved")
        return times, losses

    for shape in MESH_TRAIN_SHAPES:
        mesh = make_host_mesh(*shape, dev)
        tag = f"{shape[0]}x{shape[1]}"
        label = f"phase 21a {tag} float"
        times, losses = float_steps(mesh, label)
        res["steps_s"][f"{tag}_float"] = times
        res["losses"][f"{tag}_float"] = losses
        log(f"{label}: {MESH_TRAIN_STEPS} donated steps, [loss, aux, "
            f"grad_norm] {losses}, step {[round(t, 4) for t in times]} s, "
            f"peak {res['peak_gib'][label]:.2f} GiB")
        label = f"phase 21a {tag} QAT abfp_kernel"

        def measured_q(mode, fn, label=label):
            return measured(label, fn)

        qk = qat_kernel_checks(dev, params, mcfg, dcfg, kq, per_step, keys,
                               measured_q, label, donate=True, mesh=mesh)
        if qk["moved"] != len(leaves(params)):
            fail(f"{label}: {qk['moved']} of {len(leaves(params))} weights "
                 f"moved")
        res["steps_s"][f"{tag}_qat_abfp_kernel"] = qk.pop("steps_s")
        res[f"{tag}_qat_abfp_kernel"] = qk
    res["step_median_s"] = {k: statistics.median(v[1:])
                            for k, v in res["steps_s"].items()}

    # The mesh forward against the one-device forward, nothing dropped.
    m8 = dataclasses.replace(mcfg, capacity_factor=MESH_CF_CHECK)
    toks = tokens_on(batch_at_step(dcfg, 0), dev)
    fwd, want_aux = {}, {}
    with torch.no_grad():
        for tag, mesh in [("none", None)] + [
                (f"{d}x{t}", make_host_mesh(d, t, dev))
                for d, t in MESH_TRAIN_SHAPES]:
            hidden, aux = forward(params, toks[:, :-1], m8, mesh=mesh,
                                  return_hidden=True)
            loss = chunked_cross_entropy(params, hidden, toks[:, 1:], m8,
                                         None)
            fwd[tag] = (float(loss), float(aux))
            del hidden
        for dp in sorted({d for d, _ in MESH_TRAIN_SHAPES}):
            rows_ = TRAIN_BATCH // dp
            want_aux[dp] = sum(
                float(forward(params, toks[i:i + rows_, :-1], m8)[1])
                for i in range(0, TRAIN_BATCH, rows_)) / dp
    for dp, tp_ in MESH_TRAIN_SHAPES:
        tag = f"{dp}x{tp_}"
        loss, aux = fwd[tag]
        if (not np.isfinite([loss, aux]).all()
                or abs(loss - fwd["none"][0]) > MESH_LOSS_RTOL
                * abs(fwd["none"][0])
                or abs(aux - want_aux[dp]) > MESH_AUX_RTOL * want_aux[dp]):
            fail(f"phase 21a: the mesh {tag} forward's (loss, aux) "
                 f"{(loss, aux)} against the one-device loss "
                 f"{fwd['none'][0]!r} and the data shards' mean aux "
                 f"{want_aux[dp]!r}")
    res["forward_cf8"] = {"loss_aux": fwd, "data_shard_mean_aux": want_aux}
    log(f"phase 21a: at capacity factor {MESH_CF_CHECK} the float forward's "
        f"(loss, aux) " + json.dumps(fwd) + f" against the one-device loss "
        f"(bar {MESH_LOSS_RTOL}) and the data shards' mean one-device aux "
        + json.dumps(want_aux) + f" (bar {MESH_AUX_RTOL})")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # 21b. full-width tinyllama served with graphs on a (2, 4) mesh under
    # a rate-0 plan and under a shard drop.
    t_b = time.perf_counter()
    args = serve_cli.build_parser().parse_args(
        ["--full", "--fused", "--arch", MESH_ARCH, "--capacity",
         str(CAPACITY), "--max-len", str(MAX_LEN), "--max-new", str(MAX_NEW),
         "--seed", str(SEED)])
    tcfg, quant = serve_cli.model_and_quant(args)
    packed = pack_model_params(init_params(SEED, tcfg, device=dev), quant,
                               tcfg)
    vocab = tcfg.vocab_size
    names = ("abfp_matmul_packed", "fused_qkv_packed",
             "fused_quantized_decode_attention")
    want_launch = {kind: {k: v for k, v in zip(
        names, MESH_LAUNCHES[MESH_FAULT_SHAPE[1]][kind]) if v}
        for kind in ("decode", "prefill")}
    plans = {"rate0": FaultConfig(rate=0.0),
             "shard_drop": FaultPlan(
                 [FaultEvent(MESH_DROP_TICK, "shard_drop", "", shard=1)],
                 FaultConfig(rate=0.01))}
    res["faults"] = {}
    for label, plan in plans.items():
        eng = engine_cls(packed, tcfg, capacity=CAPACITY, max_len=MAX_LEN,
                         quant=quant, seed=SEED, device=dev,
                         mesh=make_host_mesh(*MESH_FAULT_SHAPE, dev),
                         faults=plan, detect_every=FAULT_DETECT_EVERY)
        eng.warmup()
        built = {k: wp.graph for k, wp in eng._passes.items()}
        rs = [Request(uid=r.uid, prompt=[t % (vocab - 1) + 1
                                         for t in r.prompt],
                      max_new_tokens=MAX_NEW) for r in reqs]
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        fin = eng.run(rs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        cons = eng.metrics.conservation()
        if len(fin) != len(rs) or not all(r.done for r in fin) \
                or not cons["ok"]:
            fail(f"phase 21b {label}: {len(fin)} of {len(rs)} finished, "
                 f"conservation {cons}")
        streams = {r.uid: list(r.generated) for r in fin}
        for kind in ("decode", "prefill"):
            for got in eng.per_pass[kind]:
                if {k: v for k, v in got.items() if v} != want_launch[kind]:
                    fail(f"phase 21b {label}: a {kind} pass launched {got}, "
                         f"want {want_launch[kind]}")
        shape = tuple(eng.mesh.devices.shape)
        kept = all(eng._passes[k].graph is g for k, g in built.items())
        out = {"mesh_after": shape, "faults": dict(eng.metrics.faults),
               "conservation": cons, "wall_s": wall, "passes_kept": kept,
               "launches": ops.launch_counts()}
        if label == "rate0":
            parted = [u for u in want_streams
                      if streams[u] != want_streams[u]]
            if parted:
                fail(f"phase 21b rate0: the streams of requests {parted} "
                     f"differ from phase 20b's")
            if eng.metrics.faults["injected"] or shape != MESH_FAULT_SHAPE:
                fail(f"phase 21b rate0: {out}")
        elif (shape != (1, MESH_FAULT_SHAPE[1])
              or eng.metrics.faults["reshards"] != 1 or not kept):
            fail(f"phase 21b shard_drop: {out}")
        else:
            out["streams_equal_to_20b"] = sum(
                streams[u] == want_streams[u] for u in want_streams)
        res["faults"][label] = out
        log(f"phase 21b {label}: " + json.dumps(
            {k: v for k, v in out.items() if k != "launches"})
            + f", {len(fin)}/{len(rs)} requests in {wall:.3f}s")
        eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    res["faults_s"] = time.perf_counter() - t_b
    del packed
    gc.collect()
    torch.cuda.empty_cache()

    for row in rows:
        if row["name"] == "abfp_matmul":
            row["launches_mesh_qat_step"] = {
                t: [c["abfp_matmul"] for c in res[f"{t}_qat_abfp_kernel"][
                    "counts"]] for t in (f"{d}x{m}"
                                         for d, m in MESH_TRAIN_SHAPES)}
            row["launches_granite_forward_no_mesh"] = no_mesh_forward.get(
                "abfp_matmul", 0)
    for k in list(res):
        if k.endswith("_qat_abfp_kernel"):
            res[k].pop("counts")
    res["seconds"] = time.perf_counter() - t_phase
    return res


def dryrun_phase(dev, card: str) -> dict:
    """Phase 22: the dry run's cost analysis against the card (see the
    module docstring); returns each cell's figures."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.cost_analysis import roofline_terms

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    res = {"card": card, "cells": {}}

    def requested() -> int:
        return torch.cuda.memory_stats().get("requested_bytes.all.current", 0)

    # The four meta traces run here, one after another, before any cell
    # runs on the card: nothing else runs on the host while the cells are
    # timed.
    traces = {}
    for label, (seq, batch, kind), quant, shape in DRYRUN_CELLS:
        cell = dryrun.build_cell(DRYRUN_ARCH,
                                 ShapeConfig(label, seq, batch, kind),
                                 dryrun.make_mesh(shape), quant,
                                 microbatches=DRYRUN_MICROBATCHES)
        traces[label] = dryrun.trace_cell(cell)
        del traces[label]["out"], cell
    t_traces = time.perf_counter() - t_phase
    runs, outs = {}, {}
    for label, (seq, batch, kind), quant, shape in DRYRUN_CELLS:
        sc = ShapeConfig(label, seq, batch, kind)
        mesh = dryrun.make_mesh(shape)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base, base_req = torch.cuda.memory_allocated(), requested()
        cell = dryrun.build_cell(DRYRUN_ARCH, sc, mesh, quant,
                                 device=dev, seed=SEED,
                                 microbatches=DRYRUN_MICROBATCHES)
        torch.cuda.synchronize()
        r = {"inputs_bytes": torch.cuda.memory_allocated() - base,
             "inputs_requested_bytes": requested() - base_req}
        with FlopCounterMode(display=False) as fc:
            cell.fn(*cell.args)                          # the warm-up
        torch.cuda.synchronize()
        r["flops"] = fc.get_total_flops()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(DRYRUN_REPS):
            s_ = torch.cuda.Event(enable_timing=True)
            e_ = torch.cuda.Event(enable_timing=True)
            s_.record()
            out = cell.fn(*cell.args)
            e_.record()
            torch.cuda.synchronize()
            times.append(s_.elapsed_time(e_))
        if kind == "prefill":
            outs[label] = out.float().cpu()
        del out
        r["times_ms"] = times
        r["peak_bytes"] = torch.cuda.max_memory_allocated() - base
        r["peak_requested_bytes"] = torch.cuda.memory_stats().get(
            "requested_bytes.all.peak", 0) - base_req
        runs[label] = r
        del cell
    log(f"phase 22: the traces took {t_traces:.1f}s (" + ", ".join(
        f"{k} {v['seconds']:.1f}s, {v['ops']} ops"
        for k, v in traces.items()) + "), then the cells ran in "
        f"{time.perf_counter() - t_phase - t_traces:.1f}s")

    # One card runs every shard of a virtual mesh: its FLOPs, peak and
    # bound are the whole mesh's (at (1, 1) the per-device figures).
    for label, (seq, batch, kind), quant, shape in DRYRUN_CELLS:
        costs, r = traces[label], runs[label]
        if r["flops"] != costs["flops_global"]:
            fail(f"phase 22 {label}: the card counted {r['flops']} FLOPs, "
                 f"the trace {costs['flops_global']}")
        peak, live = r["peak_bytes"], costs["live_bytes_global"]
        terms = roofline_terms(costs["flops_global"],
                               costs["hbm_bytes_global"], 0.0, 1,
                               peak_flops=mesh_lib.PEAK_FLOPS_BF16,
                               hbm_bw=mesh_lib.HBM_BW,
                               ici_bw=mesh_lib.ICI_BW)
        bound_ms = 1e3 * max(terms["compute_s"], terms["memory_s"])
        ms = statistics.median(r["times_ms"])
        res["cells"][label] = dict(
            r, shape=[batch, seq, kind], quant=quant,
            hbm_bytes=costs["hbm_bytes"], live_bytes=live,
            peak_over_live=peak / live, memory=costs["memory"], ms=ms,
            bound_ms=bound_ms, bound_by=terms["bottleneck"],
            ms_over_bound=ms / bound_ms, trace_s=costs["seconds"],
            ops=costs["ops"], mesh=list(shape),
            flops_per_device=costs["flops"],
            live_bytes_per_device=costs["live_bytes"],
            per_device_rule=dryrun.per_device_rule(get_config(DRYRUN_ARCH),
                                                   kind),
            collectives=costs["collectives"])
        if shape != (1, 1):
            res["cells"][label].update(_mesh_cell_checks(
                label, costs, shape, batch * seq, batch, outs[label],
                outs[label.removesuffix("_mesh")]))
        log(f"phase 22 {label}: FLOPs {r['flops']} (card = trace), peak "
            f"{peak / 2 ** 30:.3f} GiB (requested "
            f"{r['peak_requested_bytes'] / 2 ** 30:.3f}) vs live "
            f"{live / 2 ** 30:.3f} GiB ({peak / live:.4f}), median "
            f"{ms:.3f} ms vs bound {bound_ms:.3f} ms "
            f"({terms['bottleneck']}, x{ms / bound_ms:.2f})")
        if abs(peak - live) > max(DRYRUN_PEAK_RTOL * live, DRYRUN_PEAK_ATOL):
            fail(f"phase 22 {label}: peak {peak} bytes above the baseline, "
                 f"the trace's live bytes {live} ({costs['memory']})")
        if ms < bound_ms:
            fail(f"phase 22 {label}: a median of {ms:.4f} ms below the "
                 f"roofline bound {bound_ms:.4f} ms ({terms})")
    gc.collect()
    torch.cuda.empty_cache()
    res["traces_s"] = t_traces
    res["seconds"] = time.perf_counter() - t_phase
    return res


def _mesh_cell_checks(label, costs, shape, tokens, rows, logits,
                      logits_one) -> dict:
    """Phase 22's mesh prefill cell: every dense call split over 'model'
    (the trace's sharded FLOPs are the dense calls' FLOPs, counted from
    the config), attention split too where the query heads split (15
    heads over 2 do not: it runs whole on each device, as GSPMD's reshape
    gathers it), so the per-device FLOPs are the sharded FLOPs over the
    model size plus the rest; the logits within DRYRUN_MESH_LOGIT_BAR of
    the prefill's without a mesh."""
    from repro_torch.configs import get_config

    m = get_config(DRYRUN_ARCH)
    tp = shape[-1]
    d, hd = m.d_model, m.resolved_head_dim
    qc, kc = m.num_heads * hd, m.num_kv_heads * hd
    per_token = d * qc + 2 * d * kc + qc * d + 3 * d * m.d_ff
    dense = 2 * tokens * m.num_layers * per_token + 2 * rows * d * m.vocab_size
    attn = costs["flops_global"] - dense
    split = dense + (attn if m.num_heads % tp == 0 else 0)
    got_split = costs["by_class"]["sharded"]["flops"]
    want_dev = split / tp + (costs["flops_global"] - split)
    if got_split != split or costs["flops"] != want_dev:
        fail(f"phase 22 {label}: sharded FLOPs {got_split} (want {split}), "
             f"per device {costs['flops']} (want {want_dev})")
    err = float((logits - logits_one).abs().max())
    agree = float((logits.argmax(-1) == logits_one.argmax(-1)).float().mean())
    log(f"phase 22 {label}: dense FLOPs {dense} split over {tp}, attention "
        f"{attn} {'split' if split > dense else 'whole'}; per device "
        f"{costs['flops']} of {costs['flops_global']}; logits "
        f"{err:.4f} from the no-mesh prefill's (bar "
        f"{DRYRUN_MESH_LOGIT_BAR}), argmax {agree:.3f} equal; events "
        + json.dumps(costs["collectives"]))
    if not np.isfinite(err) or err > DRYRUN_MESH_LOGIT_BAR:
        fail(f"phase 22 {label}: logits {err} from the no-mesh prefill's")
    return {"dense_flops": dense, "attention_flops": attn,
            "logits_max_abs_err": err, "argmax_equal": agree}


def dense_phase(dev, engine_cls, lens, rows: list) -> dict:
    """Phase 23: full-width gemma-7b and chatglm3-6b (28 layers each)
    served as ``--arch <a> --full --fused`` configures them, on phase 4's
    prompt lengths (``lens``), and their evaluation forwards (see the
    module docstring).  ``engine_cls`` is phase 4's NaN-checking engine
    that records each pass's launches.  Annotates the kernel rows with
    this path's launches and times; returns the measurements."""
    import torch

    from repro_torch.core import prng
    from repro_torch.core.abfp import QuantConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.abfp_decode_fused import (
        fused_qkv_packed_ref,
        quantized_decode_attention,
    )
    from repro_torch.kernels.abfp_matmul import abfp_matmul_packed_ref
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import (
        Numerics,
        clone_state,
        decode_step,
        forward,
        init_decode_state,
        init_params,
        prefill,
    )
    from repro_torch.models import layers as model_layers
    from repro_torch.serving import Request
    from repro_torch.serving.runners import state_tensors

    t_phase = time.perf_counter()
    k1, k2, k3 = SERVE_KERNELS
    shapes = [("decode",)] + [("prefill", c) for c in (16, 64, 128)]
    sites = {k1: (ops, abfp_matmul_packed_ref),
             k2: (ops, lambda x, pws, cfg, seeds, qkv=None:
                  fused_qkv_packed_ref(x, pws, cfg, seeds)),
             k3: (model_layers, quantized_decode_attention)}
    res = {}

    @contextlib.contextmanager
    def recording(calls, names):
        """Record every call (inputs and output) of the kernels ``names``
        (``sites``' wrappers, or kernel 5's) into ``calls``."""
        where = dict(sites, flash_attention=(model_layers, None))
        saved = {n: getattr(where[n][0], n) for n in names}

        def wrap(name, fn):
            def call(*a, **kw):
                y = fn(*a, **kw)
                calls[name].append((a, kw, y))
                return y
            return call

        for n in names:
            setattr(where[n][0], n, wrap(n, saved[n]))
        try:
            yield
        finally:
            for n in names:
                setattr(where[n][0], n, saved[n])

    for i, arch in enumerate(DENSE_ARCHS):
        what = f"phase 23 {arch}"
        t_arch = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        args = serve_cli.build_parser().parse_args(
            ["--arch", arch, "--full", "--fused", "--capacity",
             str(CAPACITY), "--max-len", str(MAX_LEN), "--max-new",
             str(MAX_NEW), "--seed", str(SEED)])
        mcfg, quant = serve_cli.model_and_quant(args)
        if (mcfg.name, mcfg.num_layers, quant.mode) != (arch, 28,
                                                        "abfp_fused") \
                or not mcfg.kv_quant:
            fail(f"{what}: unexpected serving config {mcfg} {quant}")
        nl, h = mcfg.num_layers, mcfg.num_heads
        kh, hd = mcfg.num_kv_heads, mcfg.resolved_head_dim
        # Launches per decode tick: kernel 1 on each layer's attn.wo and
        # mlp.wi / wg / wo and on the (tied, packed) LM head; kernels 2 and
        # 3 once per layer.  Per prefill pass: kernel 1 on wq, wk, wv, wo
        # and the MLP, and the head.  Per evaluation forward: kernel 4 on
        # the prefill pass's matmuls, kernel 5 once per layer.
        per_tick = {k1: 4 * nl + 1, k2: nl, k3: nl}
        per_prefill = {k1: 7 * nl + 1}
        per_forward = {"abfp_matmul": 7 * nl + 1, "flash_attention": nl}
        t0 = time.perf_counter()
        params = init_params(SEED, mcfg, device=dev)
        eng = engine_cls(params, mcfg, capacity=CAPACITY, max_len=MAX_LEN,
                         quant=quant, seed=SEED, device=dev, _graphs=False)
        torch.cuda.synchronize()
        out = {"init_and_pack_s": time.perf_counter() - t0,
               "head_dim": hd, "heads": [h, kh]}
        packed = eng.params
        head = packed["lm_head"]
        log(f"{what}: {nl} layers, d={mcfg.d_model}, {h} / {kh} heads of "
            f"{hd}, {mcfg.mlp_type} {mcfg.d_ff}, vocab {mcfg.vocab_size} "
            f"(LM head {head.k} x {head.n_cols}, tied "
            f"{mcfg.tie_embeddings}, rope fraction {mcfg.rope_fraction}) "
            f"built and packed in {out['init_and_pack_s']:.1f}s, "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated")
        rng = np.random.default_rng(SEED + 23 + i)
        reqs = [Request(uid=u, prompt=rng.integers(1, mcfg.vocab_size,
                                                   n).tolist(),
                        max_new_tokens=MAX_NEW) for u, n in enumerate(lens)]

        def fresh(**kw):
            return engine_cls(packed, mcfg, capacity=CAPACITY,
                              max_len=MAX_LEN, quant=quant, seed=SEED,
                              device=dev, **kw)

        # 23a. Served eagerly, with graphs and with graphs + overlap: 8 of
        # 8 with equal streams, every pass's launches held to per_tick /
        # per_prefill; every shape's replay against eager under two keys.
        runs, _, geng = serve_in_turns(
            eng, fresh, lambda: [Request(uid=r.uid, prompt=list(r.prompt),
                                         max_new_tokens=MAX_NEW)
                                 for r in reqs],
            shapes, {"decode": per_tick, "prefill": per_prefill}, what)
        out["runs"] = runs
        out["per_decode_tick"], out["per_prefill_pass"] = per_tick, \
            per_prefill
        served = [t.clone() for t in state_tensors(eng.state)]
        xeng = fresh(clock=time.perf_counter, overlap=True, _graphs=False)
        replay_against_eager(geng, xeng, served, shapes, mcfg.vocab_size,
                             np.random.default_rng(SEED + 24), what)
        xeng.close()
        geng.close()
        del xeng, geng, served, eng
        gc.collect()

        # 23b. The first prefill pass and decode tick of the first four
        # requests at depth DENSE_CHECK_LAYERS (the first layers and the
        # head) through the kernels and through the plain versions: every
        # kernel-1/2 call at 0 flips and every kernel-3 call within its
        # card tests' bar (``k3_bar``, phase 14's) of its plain version
        # on its own inputs; the logits within DECODE_LOGIT_BAR, and
        # bit-equal where every kernel-1/2 call was (kernel 3 swapped for
        # its plain version on the tick).
        m4 = dataclasses.replace(mcfg, num_layers=DENSE_CHECK_LAYERS)
        p4 = dict(packed, layers=packed["layers"][:DENSE_CHECK_LAYERS])
        first = reqs[:CAPACITY]
        n_tok = np.array([min(len(r.prompt), 128) for r in first], np.int32)
        toks = np.zeros((CAPACITY, 128), np.int32)
        for j, r in enumerate(first):
            toks[j, :n_tok[j]] = r.prompt[:n_tok[j]]
        toks_t = torch.from_numpy(toks).to(dev)
        n_t = torch.from_numpy(n_tok).to(dev)
        key = prng.split(prng.PRNGKey(SEED))[1]
        key_d = prng.fold_in(key, 1)
        calls = {n: [] for n in sites}
        errs = {n: 0.0 for n in sites}

        def check_calls(kind) -> bool:
            torch.cuda.synchronize()
            exact = True
            for name, rec in calls.items():
                n = size = 0
                for a, kw, y in rec:
                    want_ = sites[name][1](*a, **kw)
                    for g, w in zip(*((y, want_) if isinstance(y, tuple)
                                      else ((y,), (want_,)))):
                        f_, z_, ulp, e_ = bf16_diff(g, w)
                        if name == k3:
                            e_ = k3_bar(g, w, f"{what} first {kind}: {name}",
                                        quiet=True)
                        elif f_ or ulp:
                            fail(f"{what} first {kind}: {name} differs from "
                                 f"its plain version ({f_}/{z_} flips)")
                        n, size = n + f_, size + z_
                        errs[name] = max(errs[name], e_)
                exact = exact and (name == k3 or n == 0)
                log(f"{what} first {kind} (depth {DENSE_CHECK_LAYERS}): "
                    f"{name} on its {len(rec)} calls' own inputs against "
                    f"its plain version: {n}/{size} one-ULP flips")
                rec.clear()
            return exact

        def compare(kind, a, b, bar=None):
            if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                fail(f"{what}: non-finite logits in the first {kind}")
            same = float((a.argmax(-1) == b.argmax(-1)).float().mean())
            err = float((a - b).abs().max())
            log(f"{what} first {kind} (depth {DENSE_CHECK_LAYERS}): logits "
                f"max-abs difference {err:.4g}, greedy tokens equal "
                f"{same:.0%}")
            if bar is not None and err > bar:
                fail(f"{what} first {kind}: logits differ by {err:.4g} > "
                     f"{bar}")
            return {"logits_max_abs": err, "greedy_equal": same}

        state0 = init_decode_state(m4, CAPACITY, MAX_LEN, device=dev)
        st_k, st_p = clone_state(state0), clone_state(state0)
        with recording(calls, list(sites)):
            lg_k, _ = prefill(p4, st_k, toks_t, n_t, m4,
                              Numerics(quant, key))
        if len(calls[k1]) != 7 * DENSE_CHECK_LAYERS + 1 or calls[k2] \
                or calls[k3]:
            fail(f"{what}: the first prefill pass made "
                 f"{ {n: len(c) for n, c in calls.items()} } kernel calls")
        exact = check_calls("prefill pass")
        lg_p, _ = prefill(p4, st_p, toks_t, n_t, m4,
                          Numerics(quant, key, plain=True))
        out["first_prefill"] = compare("prefill pass", lg_k, lg_p,
                                       DECODE_LOGIT_BAR)
        if exact and not torch.equal(lg_k, lg_p):
            fail(f"{what}: the prefill pass runs no kernel 3 and every "
                 f"kernel-1 call was bit-equal, yet its logits differ")
        tok = lg_k.argmax(-1).to(torch.int32)
        st_a = clone_state(st_p)
        with recording(calls, list(sites)):
            lg_k, _ = decode_step(p4, st_k, tok, m4, Numerics(quant, key_d))
        want4 = {k1: 4 * DENSE_CHECK_LAYERS + 1, k2: DENSE_CHECK_LAYERS,
                 k3: DENSE_CHECK_LAYERS}
        if {n: len(c) for n, c in calls.items()} != want4:
            fail(f"{what}: the first decode tick made "
                 f"{ {n: len(c) for n, c in calls.items()} } kernel calls")
        exact = check_calls("decode tick")
        lg_p, _ = decode_step(p4, st_p, tok, m4,
                              Numerics(quant, key_d, plain=True))
        out["first_decode"] = compare("decode tick", lg_k, lg_p,
                                      DECODE_LOGIT_BAR)
        saved3 = model_layers.fused_quantized_decode_attention
        model_layers.fused_quantized_decode_attention = \
            quantized_decode_attention
        try:
            lg_a, _ = decode_step(p4, st_a, tok, m4, Numerics(quant, key_d))
        finally:
            model_layers.fused_quantized_decode_attention = saved3
        if exact and not torch.equal(lg_a, lg_p):
            fail(f"{what}: the decode tick with kernel 3's plain version "
                 f"differs from the plain run, yet every kernel-1/2 call "
                 f"was bit-equal")
        log(f"{what} first decode tick with kernel 3's plain version: "
            f"logits bit-equal to the plain run's")
        out["max_abs_err"] = dict(errs)
        del st_k, st_p, st_a, state0, lg_a, p4

        # 23c. One full-depth decode tick's worth of each kernel (the calls
        # of a 28-layer tick after the first prefill pass, recorded): device
        # time of their graph replay, the plain versions' time and the
        # bound from these calls' bytes and operations; kernel 1 per weight
        # shape too (the 256,000- or 65,024-column head among them).
        st = init_decode_state(mcfg, CAPACITY, MAX_LEN, device=dev)
        prefill(packed, st, toks_t, n_t, mcfg, Numerics(quant, key))
        with recording(calls, list(sites)):
            decode_step(packed, st, tok, mcfg, Numerics(quant, key_d))
        tick = {n: [(a, kw) for a, kw, _ in c] for n, c in calls.items()}
        for c in calls.values():
            c.clear()
        if {n: len(c) for n, c in tick.items()} != per_tick:
            fail(f"{what}: a full-depth decode tick made "
                 f"{ {n: len(c) for n, c in tick.items()} } kernel calls")
        timed = tick_kernel_times(tick, what)
        out["tick"] = timed
        del tick, st, packed, head
        gc.collect()
        torch.cuda.empty_cache()

        # 23d. The cacheless evaluation forward (abfp_kernel, tile 128, gain
        # 8, noise 0.5, flash attention on) over DENSE_EVAL_BATCH x
        # DENSE_EVAL_SEQ tokens at full depth through the kernels: launches
        # exactly per_forward, finite logits, host time; kernel 5's calls
        # timed (graph replay) beside their bound, the plain version and
        # SDPA.  Then at depth DENSE_CHECK_LAYERS through the kernels, the
        # plain versions and kernel 5's plain version (see
        # ``eval_forward_runs``: the logits within EVAL_LOGIT_BAR, the
        # kernel-5-plain run bit-equal to the plain run).
        emcfg = dataclasses.replace(mcfg, use_flash_attention=True)
        equant = QuantConfig(mode="abfp_kernel",
                             tile_width=quant.tile_width, gain=quant.gain,
                             noise_lsb=quant.noise_lsb)
        etoks = torch.from_numpy(rng.integers(
            1, mcfg.vocab_size, (DENSE_EVAL_BATCH, DENSE_EVAL_SEQ)).astype(
            np.int32)).to(dev)
        ekey = prng.PRNGKey(SEED + 25)
        calls5 = {"flash_attention": []}
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with recording(calls5, ["flash_attention"]), torch.no_grad():
            lg, _ = forward(params, etoks, emcfg, Numerics(equant, ekey))
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t1
        counts = {n: v for n, v in ops.launch_counts().items() if v}
        if counts != per_forward:
            fail(f"{what}: the evaluation forward launched {counts}, want "
                 f"{per_forward}")
        if not torch.isfinite(lg).all():
            fail(f"{what}: non-finite logits in the evaluation forward")
        del lg
        cs5 = [(a, kw) for a, kw, _ in calls5["flash_attention"]]
        calls5.clear()
        fa = model_layers.flash_attention
        b5, d5, f5 = k5_cost(DENSE_EVAL_BATCH, DENSE_EVAL_SEQ,
                             DENSE_EVAL_SEQ, h, kh, hd, True, 0)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        cs5_t = [tuple(t.transpose(1, 2).contiguous() for t in a[:3])
                 for a, _ in cs5]
        ms5, how5 = graph_ms(lambda: [fa(*a, **kw) for a, kw in cs5], 5)
        pms5 = median_ms(lambda: [flash_attention_ref(*a, **kw)
                                  for a, kw in cs5], 1)
        lib5 = graph_ms(lambda: [sdpa(q_, k_, v_, is_causal=True,
                                      enable_gqa=True)
                                 for q_, k_, v_ in cs5_t], 5)[0]
        bms5, by5 = bound(b5 * nl, 0.0, f5 * nl, d5 * nl)
        out["eval_forward"] = {"launches": counts, "host_s": host_s,
                               "tokens": [DENSE_EVAL_BATCH, DENSE_EVAL_SEQ]}
        out["flash"] = {"launches": len(cs5), "ms": ms5, "timing": how5,
                        "plain_ms": pms5, "library_ms": lib5,
                        "bound_ms": bms5, "bound_by": by5}
        log(f"{what}: evaluation forward {tuple(etoks.shape)} at full depth "
            f"({counts}) in {host_s:.2f}s host; kernel 5's {len(cs5)} calls "
            f"({DENSE_EVAL_BATCH} x {DENSE_EVAL_SEQ}, {h} / {kh} heads of "
            f"{hd}, causal, bf16) take {ms5:.4f} ms ({how5}; plain "
            f"{pms5:.3f} ms, SDPA {lib5:.4f} ms), bound {bms5:.4f} ms by "
            f"{by5}")
        del cs5, cs5_t
        ev, got_counts = eval_forward_runs(
            dev, dict(params, layers=params["layers"][:DENSE_CHECK_LAYERS]),
            etoks, dataclasses.replace(emcfg,
                                       num_layers=DENSE_CHECK_LAYERS),
            equant, ekey, f"{what} evaluation (depth {DENSE_CHECK_LAYERS})")
        if got_counts != {"abfp_matmul": 7 * DENSE_CHECK_LAYERS + 1,
                          "flash_attention": DENSE_CHECK_LAYERS}:
            fail(f"{what}: the depth-{DENSE_CHECK_LAYERS} forward launched "
                 f"{got_counts}")
        out["eval_check"] = ev
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del params, etoks
        gc.collect()
        torch.cuda.empty_cache()
        out["seconds"] = time.perf_counter() - t_arch
        g_ = runs["graphs"][0]
        log(f"{what}: 8/8 eager / graphs / overlap; launches per tick "
            f"{per_tick}, per prefill pass {per_prefill}; graphs tick "
            f"{g_['decode_ms']:.3f} ms, prefill pass {g_['prefill_ms']:.3f} "
            f"ms, {g_['tokens_per_s']:.1f} tokens/s; peak "
            f"{out['peak_memory_gb']:.1f} GiB; {out['seconds']:.1f}s")
        res[arch] = out

        slug = arch.replace("-", "_").replace(".", "_")
        for row in rows:
            name = row["name"]
            row[f"launches_{slug}_serve"] = g_["launches"].get(name, 0)
            row[f"launches_{slug}_eval_forward"] = counts.get(name, 0)
            t_ = timed.get(name) or (out["flash"] if name == "flash_attention"
                                     else None)
            if t_ is not None:
                row.update({f"{slug}_ms": t_["ms"],
                            f"{slug}_plain_ms": t_["plain_ms"],
                            f"{slug}_bound_ms": t_["bound_ms"],
                            f"{slug}_bound_by": t_["bound_by"]})
                if name == "flash_attention":
                    row[f"{slug}_library_ms"] = t_["library_ms"]
            if name in errs:
                row["max_abs_err"] = max(row["max_abs_err"], errs[name])
    res["seconds"] = time.perf_counter() - t_phase
    return res


def eval_forward_runs(dev, params, inputs, mcfg, quant, key, what,
                      encoder_features=None, check_calls: bool = False,
                      bar: float = EVAL_LOGIT_BAR):
    """One cacheless ``forward`` through the kernels (launch counts read
    around it), through the plain versions, and through the kernels with
    kernel 5's plain version, which must equal the plain run bit for bit
    (kernel 4 is exact, kernel 5 held allclose): logits, aux and, on an
    MoE model, every layer's chosen experts.  The kernel run's logits are
    held within EVAL_LOGIT_BAR of the plain run's; on an MoE model its aux
    and the (layer, token) rows whose chosen experts differ from the plain
    run's are reported (kernel 5's one-ULP flips can move activation codes
    and so a near-tied route).  ``check_calls``: every kernel-4 and
    kernel-5 call of the kernel run is recorded and held against its plain
    version on its own inputs (kernel 4 with 0 flips, kernel 5 within
    phase 3's bar).  ``bar``: the logits' bar (EVAL_LOGIT_BAR unless a
    phase states another).  Returns (measurements, launch counts)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.abfp_matmul import abfp_matmul_ref
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.models import Numerics, forward
    from repro_torch.models import layers as model_layers
    from repro_torch.models import moe as moe_lib

    out = {}
    saved5, route = model_layers.flash_attention, moe_lib._route
    saved4 = ops.abfp_matmul
    calls = {"abfp_matmul": [], "flash_attention": []}

    def recorder(name, fn):
        def call(*a, **kw):
            res_ = fn(*a, **kw)
            calls[name].append((a, kw, res_))
            return res_
        return call

    for how in ("kernels", "plain", "kernel 5 plain"):
        ids = []

        def rec_route(*a):
            r_ = route(*a)
            ids.append(r_[1])
            return r_

        moe_lib._route = rec_route
        if how == "kernel 5 plain":
            model_layers.flash_attention = flash_attention_ref
        if how == "kernels" and check_calls:
            ops.abfp_matmul = recorder("abfp_matmul", saved4)
            model_layers.flash_attention = recorder("flash_attention", saved5)
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        try:
            with torch.no_grad():
                lg, aux = forward(params, inputs, mcfg,
                                  Numerics(quant, key, plain=how == "plain"),
                                  encoder_features=encoder_features)
            torch.cuda.synchronize()
        finally:
            model_layers.flash_attention, moe_lib._route = saved5, route
            ops.abfp_matmul = saved4
        out[how] = (lg, aux, ids, time.perf_counter() - t1,
                    {n: v for n, v in ops.launch_counts().items() if v})
    lg_k, aux_k, ids_k, host_s, counts = out["kernels"]
    lg_p, aux_p, ids_p = out["plain"][:3]
    lg_a, aux_a, ids_a = out["kernel 5 plain"][:3]
    if not (torch.isfinite(lg_k).all() and torch.isfinite(aux_k).all()):
        fail(f"{what}: non-finite logits or aux")
    if not (torch.equal(lg_a, lg_p) and torch.equal(aux_a, aux_p)
            and len(ids_a) == len(ids_p)
            and all(torch.equal(a, b) for a, b in zip(ids_a, ids_p))):
        fail(f"{what}: with kernel 5's plain version the forward differs "
             f"from the plain run")
    err = float((lg_k - lg_p).abs().max())
    same = float((lg_k.argmax(-1) == lg_p.argmax(-1)).float().mean())
    res = {"host_s": host_s, "logits_max_abs": err, "argmax_equal": same,
           "logits_over_0p1": int(((lg_k - lg_p).abs() > 0.1).sum()),
           "rows_apart": int((lg_k != lg_p).any(-1).sum()),
           "rows": lg_k.numel() // lg_k.shape[-1]}
    for a, kw, got in calls["abfp_matmul"]:
        n, size, ulp, _ = bf16_diff(got, abfp_matmul_ref(*a, **kw))
        if ulp:
            fail(f"{what}: a kernel-4 call {tuple(a[0].shape)} x "
                 f"{tuple(a[1].shape)}: {n}/{size} one-ULP flips, largest "
                 f"{ulp} ULP, against its plain version")
    e5 = 0.0
    for a, kw, got in calls["flash_attention"]:
        e5 = max(e5, allclose_bar(got, flash_attention_ref(*a, **kw),
                                  f"{what}: a kernel-5 call", quiet=True))
    if check_calls:
        res.update(k4_calls=len(calls["abfp_matmul"]),
                   k5_calls=len(calls["flash_attention"]), k5_max_abs=e5)
        log(f"{what}: every call of the kernel run against its plain version"
            f" on its own inputs: kernel 4 {res['k4_calls']} calls, 0 flips;"
            f" kernel 5 {res['k5_calls']} calls, max-abs {e5:.3g} (rtol "
            f"2**-7, atol 1e-5)")
    del calls
    routed, equal = "", "logits and aux"
    if ids_k:
        equal = "logits, aux and every layer's chosen experts"
        res.update(
            aux=float(aux_k), aux_plain=float(aux_p),
            aux_equal=bool(torch.equal(aux_k, aux_p)),
            rows_routed_apart=sum(
                int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                for a, b in zip(ids_k, ids_p)),
            rows=sum(a.numel() // a.shape[-1] for a in ids_k))
        routed = (f"aux {res['aux']!r} through the kernels, "
                  f"{res['aux_plain']!r} through the plain versions (equal: "
                  f"{res['aux_equal']}); {res['rows_routed_apart']} of "
                  f"{res['rows']} (layer, token) rows chose other experts; ")
    log(f"{what}: evaluation forward {tuple(inputs.shape)} ({counts}) in "
        f"{host_s:.2f}s: {routed}logits max-abs {err:.4g} from the plain "
        f"run's, argmax equal {same:.1%}; with kernel 5's plain version "
        f"{equal} bit-equal to the plain run's")
    if err > bar:
        fail(f"{what}: logits differ from the plain run's by {err:.4g} > "
             f"{bar:.4g}")
    return res, counts


def tick_kernel_times(tick: dict, what: str) -> dict:
    """Device time of one decode tick's worth of each serving kernel's
    launches (a graph replay of the tick's recorded calls ``tick``, {name:
    [(args, kwargs), ...]}), the plain versions' time and the bound from
    these calls' bytes and operations (kernel 2's x read once for its
    three segments); kernel 1 per weight shape too.  Returns the timings
    by kernel name."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.abfp_decode_fused import (
        fused_qkv_packed_ref,
        quantized_decode_attention,
    )
    from repro_torch.kernels.abfp_matmul import abfp_matmul_packed_ref
    from repro_torch.models import layers as model_layers

    k1, k2, k3 = SERVE_KERNELS
    # (kernel, plain version, timed runs of the plain version)
    fns = {k1: (ops.abfp_matmul_packed, abfp_matmul_packed_ref, 1),
           k2: (ops.fused_qkv_packed,
                lambda x, pws, cfg, seeds, qkv=None: fused_qkv_packed_ref(
                    x, pws, cfg, seeds), 3),
           k3: (model_layers.fused_quantized_decode_attention,
                quantized_decode_attention, 3)}
    cost = {n: [0.0, 0.0, 0.0] for n in fns}    # bytes, int8 ops, f32 ops
    for name in (k1, k2):
        for a, _ in tick[name]:
            x = a[0]
            for pw in (a[1] if name == k2 else (a[1],)):
                for j, v in enumerate(k1_cost(x.numel() // x.shape[-1], pw,
                                              x.element_size())):
                    cost[name][j] += v
            if name == k2:
                cost[name][0] -= 2 * x.numel() * x.element_size()
    for a, kw in tick[k3]:
        b_, f_ = k3_cost(kw["lengths"].tolist(), a[1].shape[1],
                         a[1].shape[2], a[0].shape[2], a[0].shape[3])
        cost[k3][0] += b_
        cost[k3][2] += f_
    timed = {}
    for name, (fn, plain, reps) in fns.items():
        cs = tick[name]
        ms, how = graph_ms(lambda: [fn(*a, **kw) for a, kw in cs], 20)
        pms = median_ms(lambda: [plain(*a, **kw) for a, kw in cs], reps)
        bms, by = bound(*cost[name])
        timed[name] = {"launches": len(cs), "ms": ms, "timing": how,
                       "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                       "bytes": cost[name][0]}
        log(f"{what}: {name}'s {len(cs)} launches of one decode tick take "
            f"{ms:.4f} ms ({how}; plain versions {pms:.3f} ms), bound "
            f"{bms:.4f} ms by {by} ({cost[name][0] / 1e9:.3f} GB)")
    by_shape = {}
    for a, kw in tick[k1]:
        x, pw = a[0], a[1]
        key_ = f"{pw.k}x{pw.n_cols}"
        if key_ in by_shape:
            by_shape[key_]["calls"] += 1
            continue
        b_, i_, f_ = k1_cost(x.numel() // x.shape[-1], pw, x.element_size())
        one_ms = graph_ms(lambda a=a, kw=kw: fns[k1][0](*a, **kw), 20)[0]
        by_shape[key_] = {"calls": 1, "ms": one_ms,
                          "bound_ms": bound(b_, i_, f_)[0],
                          "gb_per_s": b_ / one_ms / 1e6}
    timed[k1].update(by_shape=by_shape, code_bytes=sum(
        a[1].k * a[1].n_cols for a, _ in tick[k1]))
    log(f"{what}: kernel 1 per weight shape (K x N: calls, ms per call, "
        f"bound ms, GB/s): " + json.dumps(
            {k_: [v["calls"], round(v["ms"], 4), round(v["bound_ms"], 4),
                  round(v["gb_per_s"], 1)] for k_, v in by_shape.items()}))
    return timed


def k3_bar(got, want, what: str, quiet: bool = False) -> float:
    """Kernel 3 against its plain version with its card tests' bar (rtol
    2**-7, one bf16 ULP, atol 1e-6; phase 14's): the one-ULP flips
    counted, and the elements further apart (softmax sums in another
    order, on outputs near 0) shown.  Returns the max-abs difference."""
    err = allclose_bar(got, want, what, rtol=2 ** -7, atol=1e-6, quiet=True)
    g, w = bits(got), bits(want)
    far = np.abs(g - w) > 1
    n = int((np.abs(g - w) == 1).sum())
    if far.any() or not quiet:
        log(f"{what}: {n}/{g.size} one-ULP flips, {int(far.sum())} "
            f"elements further apart (got "
            f"{got.float().cpu().numpy()[far][:4]}, want "
            f"{want.float().cpu().numpy()[far][:4]}), max-abs {err:.3g}")
    return err


def wide_kernel_checks(dev, gen, quant) -> dict:
    """Phase 3's checks at the shapes of gemma-7b and chatglm3-6b (phase
    23's path; see the module docstring), each against its plain version
    with phase 3's bars: kernel 3 at (4, 1, 16, 256) over 16 KV heads and
    (4, 1, 32, 128) over 2 KV heads (16 query heads per KV head: four
    blocks of four), lengths 0 / 1 / MAX_LEN / mixed, with its card tests'
    bar (``k3_bar``: at (4, 1, 32, 128) an element lies two bf16 ULPs from
    the plain version's on an H100); kernel 5 at 4 x 512, causal, D = 256 (16 / 16 heads) and D = 128 (32 /
    2 heads), on bf16 (tensor cores, rtol 2**-7, atol 1e-5) and f32 (the
    FMA kernel, rtol 1e-5, atol 2e-5); kernel 1's decode route on a
    3,072 x 256,000 packed head (gemma's tied LM head) at M = 4, 0 flips.
    Returns each kernel's max-abs difference."""
    import torch

    from repro_torch.core.abfp import pack_abfp_weight
    from repro_torch.kernels.abfp_decode_fused import (
        fused_quantized_decode_attention,
        quantized_decode_attention,
    )
    from repro_torch.kernels.abfp_matmul import (
        DECODE_ROWS,
        abfp_matmul_packed,
        abfp_matmul_packed_ref,
        fused_rows,
    )
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_ref,
    )

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    errs = {"abfp_matmul_packed": 0.0, "fused_quantized_decode_attention":
            0.0, "flash_attention": 0.0}
    for h, kh, d in WIDE_HEADS:
        q = randn(CAPACITY, 1, h, d)
        kc, vc = (torch.randint(-127, 128, (CAPACITY, MAX_LEN, kh, d),
                                generator=gen, device=dev, dtype=torch.int8)
                  for _ in "kv")
        ks, vs = ((torch.rand(CAPACITY, MAX_LEN, kh, generator=gen,
                              device=dev) * 4).to(torch.bfloat16)
                  for _ in "kv")
        for lens3 in ([1, MAX_LEN, 77, 300], [0, 1, MAX_LEN, 300]):
            lengths = torch.tensor(lens3, dtype=torch.int32, device=dev)
            got = fused_quantized_decode_attention(q, kc, ks, vc, vs,
                                                   lengths=lengths)
            want = quantized_decode_attention(q, kc, ks, vc, vs,
                                              lengths=lengths)
            errs["fused_quantized_decode_attention"] = max(
                errs["fused_quantized_decode_attention"], k3_bar(
                    got, want, f"kernel 3 {tuple(q.shape)} over {kh} KV "
                    f"heads, S_max={MAX_LEN} lengths {lens3}"))
        qa = randn(EVAL_BATCH, EVAL_SEQ, h, d)
        ka, va = (randn(EVAL_BATCH, EVAL_SEQ, kh, d) for _ in "kv")
        what = f"kernel 5 {tuple(qa.shape)} kv {tuple(ka.shape)} causal"
        got = flash_attention(qa, ka, va, causal=True)
        want = flash_attention_ref(qa, ka, va, causal=True)
        n, size, ulp, _ = bf16_diff(got, want)
        errs["flash_attention"] = max(errs["flash_attention"], allclose_bar(
            got, want, f"{what} bf16 tensor cores: {int((got != want).sum())}"
            f"/{size} differ ({n} by one bf16 ULP; largest {ulp} ULP)"))
        q32, k32, v32 = (t.float() for t in (qa, ka, va))
        allclose_bar(flash_attention(q32, k32, v32, causal=True),
                     flash_attention_ref(q32, k32, v32, causal=True),
                     f"{what} f32 (FMA kernel)", rtol=1e-5, atol=2e-5)
        del qa, ka, va, q32, k32, v32, got, want
    k, n = WIDE_HEAD
    pw = pack_abfp_weight(randn(k, n), quant,
                          adaptive_gain=quant.mode == "abfp_fused")
    if fused_rows(CAPACITY, quant.tile_width, pw.n_padded // 128, quant,
                  pw.num_tiles) != DECODE_ROWS:
        fail(f"kernel 1 on the {k} x {n} head does not take the decode "
             f"route at M={CAPACITY}")
    x = randn(CAPACITY, k)
    got = abfp_matmul_packed(x, pw, quant, 4242)
    want = abfp_matmul_packed_ref(x, pw, quant, 4242)
    n_, size, ulp, err = bf16_diff(got, want)
    if ulp:
        fail(f"kernel 1 on the {k} x {n} head M={CAPACITY}: {n_}/{size} "
             f"one-ULP flips, largest {ulp} ULP")
    errs["abfp_matmul_packed"] = err
    log(f"kernel 1 decode route on a {k} x {n} packed head ("
        f"{pw.k * pw.n_cols / 1e6:.0f} MB of codes) M={CAPACITY}: 0 flips "
        f"against the plain version")
    del pw, x, got, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return errs


def checked_engine_cls():
    """The serving engine the phases drive: it checks every fetched logits
    block for NaN and records each pass's kernel launches (the counts'
    growth across the pass) by pass kind."""
    from repro_torch.kernels import ops
    from repro_torch.serving import ServingEngine

    class CheckedEngine(ServingEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.per_pass = {"decode": [], "prefill": []}

        def _counted(self, kind, run, *a):
            before = ops.launch_counts()
            run(*a)
            after = ops.launch_counts()
            self.per_pass[kind].append(
                {k: after[k] - before[k] for k in after})

        def _prefill_pass(self, live):
            self._counted("prefill", super()._prefill_pass, live)

        def _decode_tick(self):
            self._counted("decode", super()._decode_tick)

        def _fetch_logits(self, kind, t0, logits, warm):
            lg = super()._fetch_logits(kind, t0, logits, warm)
            if not np.isfinite(lg).all():
                fail(f"non-finite logits in a {kind} pass")
            return lg

    return CheckedEngine


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build, ops
        from repro_torch.kernels.abfp_decode_fused import (
            _fused_qkv_packed,
            fused_qkv_packed,
            fused_qkv_packed_ref,
            fused_quantized_decode_attention,
            quantized_decode_attention,
        )
        from repro_torch.configs import get_config
        from repro_torch.core.abfp import QuantConfig, pack_abfp_weight
        from repro_torch.kernels.abfp_matmul import (
            DECODE_ROWS,
            _abfp_matmul,
            _abfp_matmul_packed,
            abfp_matmul,
            abfp_matmul_packed,
            abfp_matmul_packed_ref,
            abfp_matmul_ref,
            fused_rows,
        )
        from repro_torch.kernels.flash_attention import (
            flash_attention,
            flash_attention_ref,
        )
        from repro_torch.launch import serve as serve_cli
        from repro_torch.models import (
            Numerics,
            clone_state,
            decode_step,
            forward,
            init_decode_state,
            init_params,
            prefill,
        )
        from repro_torch.training import capture_histograms, evaluate_abfp
        from repro_torch.core import prng
    except ImportError as e:
        fail(f"the repro_torch sources are not beside this script ({e})")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not card:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(card, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    log(f"built {len(_build.SIGNATURES)} CUDA sources in "
        f"{time.perf_counter() - t0:.1f}s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    # The redesigned kernels must run on the tensor cores: int8 MMAs in the
    # fused ABFP core, bf16 MMAs in the bf16 flash kernel.
    for src, tag, col, op in (("abfp_matmul", "abfp_fused", 0, "IMMA"),
                              ("flash_attention", "flash_fwd_tc", 1, "HMMA")):
        found = {k: v[col] for k, v in
                 sass_mma_counts(_build.lib_path(src)).items() if tag in k}
        if not found or min(found.values()) == 0:
            fail(f"{src}: no {op} in the SASS of {tag}: {found}")
        log(f"SASS of {src}.cu: {op} per {tag} instantiation "
            f"{sorted(found.values())}")
    # Registers and spills (stack / local bytes) of the flash kernels by
    # head dim: at D = 256 the 16 x 256 f32 accumulator alone is 128
    # registers per thread.
    usage = {k: v for k, v in
             resource_usage(_build.lib_path("flash_attention")).items()
             if "flash_fwd" in k}
    log("flash_attention.cu resource usage (REG, STACK, LOCAL bytes) per "
        "instantiation: " + json.dumps(
            {k[k.index("flash_fwd"):][:24]: [v.get("REG"), v.get("STACK"),
                                              v.get("LOCAL")]
             for k, v in usage.items()}))

    # The served model, as ``python -m repro_torch.launch.serve --full
    # --fused`` builds it: full smollm-360m, abfp_fused (tile 128, gain 8,
    # noise 0.5), int8 KV cache.
    args = serve_cli.build_parser().parse_args(
        ["--full", "--fused", "--capacity", str(CAPACITY), "--max-len",
         str(MAX_LEN), "--max-new", str(MAX_NEW), "--seed", str(SEED)])
    mcfg, quant = serve_cli.model_and_quant(args)
    if (mcfg.name, mcfg.num_layers, mcfg.d_model, quant.mode) != (
            "smollm-360m", 32, 960, "abfp_fused") or not mcfg.kv_quant:
        fail(f"unexpected serving config {mcfg.name} {quant}")
    params = init_params(SEED, mcfg, device=dev)
    from repro_torch.serving import Request, ServingEngine
    CheckedEngine = checked_engine_cls()

    t0 = time.perf_counter()
    eng = CheckedEngine(params, mcfg, capacity=CAPACITY, max_len=MAX_LEN,
                        quant=quant, seed=SEED, device=dev, _graphs=False)
    torch.cuda.synchronize()
    log(f"packed smollm-360m ({mcfg.num_layers} layers, d={mcfg.d_model}, "
        f"vocab {mcfg.vocab_size}) in {time.perf_counter() - t0:.1f}s")
    layers = eng.params["layers"]
    lp0 = layers[0]

    # 3. kernels against their plain versions ------------------------------
    errs = {}
    gen = torch.Generator(device=dev).manual_seed(1)

    def act(m, k):
        return torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)

    def bit_equal(got, want, what: str) -> float:
        """Fail unless the bf16 tensors are equal bit for bit (the bar of
        kernels 1, 2 and 4); return the max-abs difference (0)."""
        n, size, ulp, err = bf16_diff(got, want)
        if ulp:
            fail(f"{what}: {n}/{size} one-ULP flips, largest {ulp} ULP")
        return err

    e1 = []
    for m in (4, 512):
        for name, pw in (("attn.wo", lp0["attn"]["wo"]),
                         ("mlp.wi", lp0["mlp"]["wi"]),
                         ("mlp.wo", lp0["mlp"]["wo"]),
                         ("lm_head", eng.params["lm_head"])):
            if name == "lm_head" and m != 4:
                continue
            x = act(m, pw.k)
            got = abfp_matmul_packed(x, pw, quant, 12345)
            want = abfp_matmul_packed_ref(x, pw, quant, 12345)
            e1.append(bit_equal(got, want, f"kernel 1 {name} M={m}"))
        log(f"kernel 1 at M={m} (attn.wo, mlp.wi, mlp.wo"
            f"{', lm_head' if m == 4 else ''}): 0 flips against the plain "
            f"version")
    # The decode route (one launch, M <= 8) on every weight of a layer, the
    # LM head and the QKV triple, against the plain versions and (kernel
    # 2) stand-alone kernel-1 calls.
    pws = tuple(lp0["attn"][w] for w in ("wq", "wk", "wv"))
    shapes = [(f"attn.{w}", lp0["attn"][w])
              for w in ("wq", "wk", "wv", "wo")] \
        + [(f"mlp.{w}", lp0["mlp"][w]) for w in ("wi", "wg", "wo")] \
        + [("lm_head", eng.params["lm_head"])]
    e2 = []
    for m in range(1, 9):
        for name, pw in shapes:
            if fused_rows(m, quant.tile_width, pw.n_padded // 128, quant,
                          pw.num_tiles) != DECODE_ROWS:
                fail(f"kernel 1 {name} M={m} does not take the decode route")
            x = act(m, pw.k)
            e1.append(bit_equal(abfp_matmul_packed(x, pw, quant, 77 + m),
                                abfp_matmul_packed_ref(x, pw, quant, 77 + m),
                                f"kernel 1 decode route {name} M={m}"))
        x = act(m, mcfg.d_model)
        sd = (m, -m, 3 * m)
        got = fused_qkv_packed(x, pws, quant, sd, qkv=lp0["attn"]["qkv"])
        want = fused_qkv_packed_ref(x, pws, quant, sd)
        for g, w, pw, s_, n in zip(got, want, pws, sd, ("q", "k", "v")):
            e2.append(bit_equal(g, w, f"kernel 2 decode route {n} M={m}"))
            bit_equal(g, abfp_matmul_packed(x, pw, quant, s_),
                      f"kernel 2 {n} M={m} against kernel 1")
    log("decode route at M = 1..8 on attn.wq/wk/wv/wo, mlp.wi/wg/wo, the "
        "lm_head and the QKV triple: 0 flips against the plain versions")
    errs["abfp_matmul_packed"] = max(e1)
    # The ABFP core's routes above decode size: the wrapper's own route,
    # the fused launch at every row block and the two-launch route, each
    # bit-equal to the plain version.
    for m in (9, 16, 64, 256, 512, 2048):
        picked = []
        for name, pw in (("mlp.wi", lp0["mlp"]["wi"]),
                         ("attn.wk", lp0["attn"]["wk"]),
                         ("mlp.wo", lp0["mlp"]["wo"])):
            x = act(m, pw.k)
            want = abfp_matmul_packed_ref(x, pw, quant, 321)
            picked.append(fused_rows(m, quant.tile_width,
                                     pw.n_padded // 128, quant,
                                     pw.num_tiles))
            for rows in (None, 0, 16, 32, 64):
                got = (abfp_matmul_packed(x, pw, quant, 321) if rows is None
                       else _abfp_matmul_packed(x, pw, quant, 321, rows))
                n, size, ulp, err = bf16_diff(got, want)
                if ulp:
                    fail(f"kernel 1 {name} M={m} route rows={rows}: {n}/"
                         f"{size} one-ULP flips, largest {ulp} ULP")
                e1.append(err)
        log(f"kernel 1 routes at M={m} (mlp.wi, attn.wk, mlp.wo; the "
            f"wrapper's row blocks {picked}; fused at 16/32/64 rows and "
            f"the two-launch route): 0 flips against the plain version")
    # The LM head does not stay in L2: the wrapper's 32-row blocks, and
    # 64-row blocks, at M that fill no whole block.
    pw = eng.params["lm_head"]
    for m in (17, 40):
        x = act(m, pw.k)
        rows = fused_rows(m, quant.tile_width, pw.n_padded // 128, quant,
                          pw.num_tiles)
        want = abfp_matmul_packed_ref(x, pw, quant, 321)
        for forced in (None, 64):
            got = (abfp_matmul_packed(x, pw, quant, 321) if forced is None
                   else _abfp_matmul_packed(x, pw, quant, 321, forced))
            n, size, ulp, err = bf16_diff(got, want)
            if ulp:
                fail(f"kernel 1 lm_head M={m} rows={forced or rows}: {n}/"
                     f"{size} one-ULP flips, largest {ulp} ULP")
            e1.append(err)
        log(f"kernel 1 lm_head {tuple(pw.codes.shape)} M={m} (the "
            f"wrapper's row block {rows}, and 64): 0 flips against the "
            f"plain version")
    torch.cuda.synchronize()
    x = act(CAPACITY, mcfg.d_model)
    seeds = (11, -22, 33)
    got = fused_qkv_packed(x, pws, quant, seeds, qkv=lp0["attn"]["qkv"])
    want = fused_qkv_packed_ref(x, pws, quant, seeds)
    errs["fused_qkv_packed"] = max(
        [bit_equal(g, w, f"kernel 2 {n} M={CAPACITY}")
         for g, w, n in zip(got, want, ("q", "k", "v"))] + e2)
    h, kh, hd = mcfg.num_heads, mcfg.num_kv_heads, mcfg.resolved_head_dim
    q = torch.randn(CAPACITY, 1, h, hd, generator=gen,
                    device=dev).to(torch.bfloat16)
    kc = torch.randint(-127, 128, (CAPACITY, MAX_LEN, kh, hd),
                       generator=gen, device=dev, dtype=torch.int8)
    vc = torch.randint(-127, 128, (CAPACITY, MAX_LEN, kh, hd),
                       generator=gen, device=dev, dtype=torch.int8)
    ks = (torch.rand(CAPACITY, MAX_LEN, kh, generator=gen, device=dev)
          * 4).to(torch.bfloat16)
    vs = (torch.rand(CAPACITY, MAX_LEN, kh, generator=gen, device=dev)
          * 4).to(torch.bfloat16)
    e3 = []
    for lens3 in ([1, MAX_LEN, 77, 300], [0, 1, MAX_LEN, 300]):
        lengths = torch.tensor(lens3, dtype=torch.int32, device=dev)
        got = fused_quantized_decode_attention(q, kc, ks, vc, vs,
                                               lengths=lengths)
        want = quantized_decode_attention(q, kc, ks, vc, vs, lengths=lengths)
        e3.append(bf16_flips(got, want, f"kernel 3 S_max={MAX_LEN} lengths "
                             f"{lens3}", per_mille=False)[2])
    errs["fused_quantized_decode_attention"] = max(e3)
    torch.cuda.synchronize()

    # Kernels 4-5 at the evaluation forward's shapes, on the unpacked
    # weights.
    emcfg = dataclasses.replace(get_config("smollm-360m"),
                                use_flash_attention=True)
    equant = QuantConfig(mode="abfp_kernel", tile_width=128, gain=8.0,
                         noise_lsb=0.5)
    if (emcfg.num_layers, emcfg.d_model, emcfg.vocab_size) != (
            32, 960, 49152) or params["lm_head"].dtype != torch.bfloat16:
        fail(f"unexpected evaluation config {emcfg}")
    lpu = params["layers"][0]
    e4 = []
    for m in (EVAL_ROWS, CAPACITY):
        for name, w in (("attn.wq", lpu["attn"]["wq"]),
                        ("attn.wk", lpu["attn"]["wk"]),
                        ("attn.wv", lpu["attn"]["wv"]),
                        ("attn.wo", lpu["attn"]["wo"]),
                        ("mlp.wi", lpu["mlp"]["wi"]),
                        ("mlp.wo", lpu["mlp"]["wo"]),
                        ("lm_head", params["lm_head"])):
            x = act(m, w.shape[0])
            got = abfp_matmul(x, w, equant, 4321)
            k1 = abfp_matmul_packed(x, pack_abfp_weight(w, equant), equant,
                                    4321)
            n, size, _, _ = bf16_diff(got, k1)
            if n or not torch.equal(got, k1):
                fail(f"kernel 4 {name} M={m}: differs from kernel 1 on the "
                     f"packed weight in {n}/{size} elements")
            e4.append(bf16_flips(
                got, abfp_matmul_ref(x, w, equant, 4321),
                f"kernel 4 {name} {tuple(w.shape)} M={m} (kernel 1 on the "
                f"packed weight: bit-equal); against its plain version")[2])
            del got, k1
    errs["abfp_matmul"] = max(e4)
    e5 = []
    for causal, window in ((True, 0), (False, 0), (True, 128)):
        qa = torch.randn(EVAL_BATCH, EVAL_SEQ, h, hd, generator=gen,
                         device=dev).to(torch.bfloat16)
        ka, va = (torch.randn(EVAL_BATCH, EVAL_SEQ, kh, hd, generator=gen,
                              device=dev).to(torch.bfloat16) for _ in "kv")
        what = (f"kernel 5 {tuple(qa.shape)} kv {tuple(ka.shape)} "
                f"causal={causal} window={window}")
        want = flash_attention_ref(qa, ka, va, causal=causal, window=window)
        got = flash_attention(qa, ka, va, causal=causal, window=window)
        n, size, ulp, _ = bf16_diff(got, want)
        e5.append(allclose_bar(
            got, want, f"{what} bf16 tensor cores: "
            f"{int((got != want).sum())}/{size} differ ({n} by one bf16 ULP;"
            f" largest {ulp} ULP)"))
        q32, k32, v32 = (t.float() for t in (qa, ka, va))
        allclose_bar(flash_attention(q32, k32, v32, causal=causal,
                                     window=window),
                     flash_attention_ref(q32, k32, v32, causal=causal,
                                         window=window),
                     f"{what} f32 (FMA kernel)", rtol=1e-5, atol=2e-5)
    errs["flash_attention"] = max(e5)
    torch.cuda.synchronize()
    for name, e_ in wide_kernel_checks(dev, gen, quant).items():
        errs[name] = max(errs[name], e_)

    # 4. serve (the main path) -------------------------------------------
    rng = np.random.default_rng(SEED)
    reqs = [Request(uid=i,
                    prompt=rng.integers(1, mcfg.vocab_size,
                                        int(rng.integers(16, 101))).tolist(),
                    max_new_tokens=MAX_NEW)
            for i in range(N_REQUESTS)]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    log(f"launch counts over the serve run: {launches}")
    if len(done) != N_REQUESTS or any(
            len(r.generated) != MAX_NEW or not r.done for r in done):
        fail("not every request finished with its tokens")
    if any(not 0 <= t < mcfg.vocab_size for r in done for t in r.generated):
        fail("a generated token is outside the vocabulary")
    for name, n in launches.items():
        if (n <= 0) == (name in SERVE_KERNELS):
            fail(f"kernel {name} was launched {n} times on the serving path")
    per_pass = {}
    for kind, rows_ in eng.per_pass.items():
        per_pass[kind] = {}
        for name in launches:
            vals = sorted({r[name] for r in rows_})
            per_pass[kind][name] = vals[0] if len(vals) == 1 else vals
    if any(sum(r[name] for rs in eng.per_pass.values() for r in rs) != n
           for name, n in launches.items()):
        fail("the per-pass launch counts do not add up to the run's")
    log(f"launches in the serve run per prefill pass {per_pass['prefill']}, "
        f"per decode tick {per_pass['decode']}")
    med, counts = eng.pass_stats()
    tokens = sum(len(r.generated) for r in done)
    log(f"served {len(done)} requests (prompts "
        f"{min(len(r.prompt) for r in reqs)}-"
        f"{max(len(r.prompt) for r in reqs)} tokens, max_new {MAX_NEW}) in "
        f"{wall:.2f}s: {tokens} tokens, {tokens / wall:.1f} tokens/s, "
        f"{counts['decode']} decode ticks (median "
        f"{med['decode'] * 1e3:.2f} ms), {counts['prefill']} prefill passes "
        f"(median {med['prefill'] * 1e3:.2f} ms), {eng.ticks} passes")
    for r in done[:2]:
        log(f"req {r.uid}: prompt[{len(r.prompt)}] -> {r.generated}")

    # 4b. graphs: every pass shape a CUDA graph; the overlapped runtime ---
    # Replay against eager: for each captured shape, two consecutive passes
    # with two keys from the served state (copied in place into both
    # engines), once by replay and once eagerly through the kernels:
    # logits and sampled tokens equal bit for bit, the two keys' logits
    # differ (frozen seeds would repeat them).
    from repro_torch.serving.runners import state_tensors
    served = [t.clone() for t in state_tensors(eng.state)]
    # The "draw" variants: the device sampler's Gumbel draw runs (rows at
    # temperatures 0.8 and 1.3 below); the greedy variants serve below.
    shapes4b = [("decode", "draw")] + [("prefill", c, "draw")
                                       for c in (16, 64, 128)]

    def shape_name(k):
        return "".join(str(p_) for p_ in k if p_ != "draw")

    def fresh_engine(**kw):
        return ServingEngine(eng.params, mcfg, capacity=CAPACITY,
                             max_len=MAX_LEN, quant=quant, seed=SEED,
                             device=dev, **kw)

    # Overlapped engines: their passes sample on the device.
    ov = dict(clock=time.perf_counter, overlap=True)
    geng, xeng = fresh_engine(**ov), fresh_engine(_graphs=False, **ov)
    t0 = time.perf_counter()
    geng.warmup()
    torch.cuda.synchronize()
    log(f"captured {len(geng._passes)} pass shapes into CUDA graphs in "
        f"{time.perf_counter() - t0:.2f}s; kernel launches per replay: "
        + json.dumps({shape_name(k):
                      {n: v for n, v in wp.launches.items() if v}
                      for k, wp in geng._passes.items()}))
    rng4 = np.random.default_rng(SEED + 1)
    for shape in shapes4b:
        width = 1 if shape[0] == "decode" else shape[1]
        for e in (geng, xeng):
            for t, src in zip(state_tensors(e.state), served):
                t.copy_(src)
        fields = dict(
            tokens=rng4.integers(1, mcfg.vocab_size, (CAPACITY, width)),
            n_tokens=np.array([width, max(1, width // 2), 1, 0]),
            prev_mask=np.zeros(CAPACITY, bool),
            temps=np.array([0.0, 0.8, 0.0, 1.3], np.float32),
            uids=np.arange(CAPACITY), idxs=np.arange(CAPACITY) + 3)
        lgs = []
        for t, key in enumerate(prng.split(prng.PRNGKey(SEED + 7), 2)):
            outs = []
            for e in (geng, xeng):
                io, _ = e._call(shape, key, **fields)
                outs.append((io.logits.clone(), io.sampled.clone()))
            (lg, sg), (le, se) = outs
            if not torch.isfinite(lg).all():
                fail(f"non-finite logits in a replay of {shape}")
            if not (torch.equal(lg, le) and torch.equal(sg, se)):
                fail(f"{shape} pass {t}: replay differs from the eager pass "
                     f"({int((lg != le).sum())} logits, "
                     f"{int((sg != se).sum())} sampled tokens)")
            lgs.append(lg)
        if torch.equal(lgs[0], lgs[1]):
            fail(f"{shape}: the two keys' logits are equal (frozen seeds?)")
        if geng._passes[shape].graph is None:
            fail(f"{shape} was not captured")
    log(f"replay against eager for {[shape_name(s_) for s_ in shapes4b]} "
        f"(the device draw's variants): two keys each, logits and sampled "
        f"tokens bit-equal, the keys' logits differ")
    xeng.close()
    del xeng

    # Serve with graphs, blocking on the simulated clock and overlapped on
    # the wall clock, against phase 4's eager engine, in turns (eager,
    # graphs, overlap, overlap, graphs, eager): each run a fresh engine
    # (warmed before its timed window), the launch counts zeroed just
    # before the run and read just after; every run must finish 8 of 8
    # with phase 4's greedy streams.
    want_streams = {r.uid: r.generated for r in done}

    def serve_run(mode: str) -> dict:
        kw = {"eager": dict(_graphs=False), "graphs": {},
              "overlap": dict(clock=time.perf_counter, overlap=True)}[mode]
        e = fresh_engine(**kw)
        e.warmup()
        torch.cuda.synchronize()
        rs = [Request(uid=r.uid, prompt=list(r.prompt),
                      max_new_tokens=MAX_NEW) for r in reqs]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        fin = e.run(rs)
        e.close()
        torch.cuda.synchronize()
        wall_ = time.perf_counter() - t0
        counts_ = ops.launch_counts()
        if len(fin) != N_REQUESTS or any(not r.done for r in fin):
            fail(f"{mode} serve: {len(fin)} of {N_REQUESTS} requests "
                 f"finished")
        bad = [r.uid for r in fin if r.generated != want_streams[r.uid]]
        if bad:
            fail(f"{mode} serve: the streams of requests {bad} differ from "
                 f"phase 4's eager streams")
        for name in SERVE_KERNELS:
            if counts_[name] <= 0:
                fail(f"{mode} serve: kernel {name} was not launched")
        med_, cnt_ = e.pass_stats()
        toks_ = sum(len(r.generated) for r in fin)
        util = e.metrics.tick_utilization()["value"]
        per_replay = {shape_name(k):
                      sum(wp.launches.values()) if wp.launches else None
                      for k, wp in e._passes.items()}
        out = {"wall_s": wall_, "tokens": toks_, "tokens_per_s": toks_ / wall_,
               "wall_per_pass_ms": wall_ / e.ticks * 1e3,
               "decode_ms": med_["decode"] * 1e3,
               "prefill_ms": med_["prefill"] * 1e3, "passes": e.ticks,
               "passes_by_kind": cnt_, "tick_utilization": util,
               "launches": counts_, "wrapper_launches_per_replay": per_replay,
               "straggler": e.metrics.summary()["straggler"]}
        del e
        gc.collect()
        torch.cuda.empty_cache()
        return out

    serve = {m: [] for m in ("eager", "graphs", "overlap")}
    for mode in ("eager", "graphs", "overlap", "overlap", "graphs", "eager"):
        serve[mode].append(serve_run(mode))
        r_ = serve[mode][-1]
        log(f"serve [{mode}] {r_['tokens']} tokens in {r_['wall_s']:.3f}s: "
            f"{r_['tokens_per_s']:.1f} tokens/s, decode tick median "
            f"{r_['decode_ms']:.3f} ms, prefill pass median "
            f"{r_['prefill_ms']:.3f} ms ({r_['passes_by_kind']}), wall per "
            f"pass {r_['wall_per_pass_ms']:.3f} ms, "
            f"tick_utilization {r_['tick_utilization']:.4f}, 8/8 streams "
            f"equal to phase 4's; launch counts {r_['launches']}")
    graph_serve_launches = serve["graphs"][0]["launches"]
    overlap_serve_launches = serve["overlap"][0]["launches"]
    summary4b = {m: {k: [r_[k] for r_ in v] for k in (
        "decode_ms", "prefill_ms", "tokens_per_s", "tick_utilization",
        "wall_s", "wall_per_pass_ms")} for m, v in serve.items()}
    log("serving in turns (eager, graphs, overlap, overlap, graphs, eager): "
        + json.dumps(summary4b))
    ops.reset_launch_counts()

    # 5. first pass: kernels against plain versions ----------------------
    # The first prefill pass and decode tick of the first four requests run
    # from one state through the kernels, then through the plain versions.
    # Every kernel call of the kernel run is recorded and held to its
    # phase-3 bar against its plain version on the same inputs (the served
    # activations, weights and caches).  Where every kernel-1/2 call of a
    # pass was bit-equal, the pass must give the plain run's logits bit for
    # bit once kernel 3 (the only other kernel) is swapped for its plain
    # version: a difference left in the logits then comes from kernel 3's
    # one-ULP flips alone.  The tick's logits may differ from the plain
    # run's by at most DECODE_LOGIT_BAR.
    from repro_torch.models import layers as model_layers
    state0 = init_decode_state(mcfg, CAPACITY, MAX_LEN, device=dev)
    first = reqs[:CAPACITY]
    n_tok = np.array([len(r.prompt) for r in first], np.int32)
    toks = np.zeros((CAPACITY, 128), np.int32)
    for i, r in enumerate(first):
        toks[i, :len(r.prompt)] = r.prompt
    toks_t = torch.from_numpy(toks).to(dev)
    n_t = torch.from_numpy(n_tok).to(dev)
    key = prng.split(prng.PRNGKey(SEED))[1]
    key_d = prng.fold_in(key, 1)
    sites = {"abfp_matmul_packed": (ops, abfp_matmul_packed_ref),
             "fused_qkv_packed": (ops, lambda x, pws, cfg, seeds,
                                  qkv=None: fused_qkv_packed_ref(
                                      x, pws, cfg, seeds)),
             "fused_quantized_decode_attention": (
                 model_layers, quantized_decode_attention),
             "abfp_matmul": (ops, abfp_matmul_ref),
             "flash_attention": (model_layers, lambda q, k, v, causal=True,
                                 window=0: flash_attention_ref(
                                     q, k, v, causal=causal,
                                     window=window))}
    # Kernels held to a tolerance, not to the bf16 bar (another sum order).
    loose = ("fused_quantized_decode_attention", "flash_attention")
    calls = {name: [] for name in sites}

    @contextlib.contextmanager
    def patched(mod, name, fn):
        old = getattr(mod, name)
        setattr(mod, name, fn)
        try:
            yield
        finally:
            setattr(mod, name, old)

    @contextlib.contextmanager
    def recording():
        with contextlib.ExitStack() as stack:
            for name, (mod, _) in sites.items():
                def call(*a, _fn=getattr(mod, name), _name=name, **kw):
                    out = _fn(*a, **kw)
                    calls[_name].append((a, kw, out))
                    return out
                stack.enter_context(patched(mod, name, call))
            yield

    def check_calls(kind) -> bool:
        """Each recorded call against its plain version (its max-abs
        difference joins the kernel's ``max_abs_err``); True when every
        call of the kernels held to the bf16 bar (1, 2, 4) was
        bit-equal."""
        torch.cuda.synchronize()
        exact = True
        for name, rec in calls.items():
            if not rec:
                continue
            n = size = 0
            err = 0.0
            for a, kw, out in rec:
                want = sites[name][1](*a, **kw)
                for g, w in zip(*((out, want) if isinstance(out, tuple)
                                  else ((out,), (want,)))):
                    if name == "flash_attention":
                        f, z = bf16_diff(g, w)[:2]
                        e = allclose_bar(g, w, f"{name} in the first {kind}",
                                         quiet=True)
                    else:
                        f, z, e = bf16_flips(
                            g, w, f"{name} in the first {kind}",
                            per_mille=name not in loose, quiet=True)
                    if f and name not in loose:
                        fail(f"{name} in the first {kind}: {f}/{z} one-ULP "
                             f"flips against its plain version")
                    n, size, err = n + f, size + z, max(err, e)
                del want
            if name not in loose:
                exact = exact and n == 0
            errs[name] = max(errs[name], err)
            log(f"first {kind}, {name} on its {len(rec)} calls' own "
                f"inputs against its plain version: {n}/{size} one-ULP "
                f"flips, max-abs {err:.3g}")
            rec.clear()
        return exact

    def compare(what, a, b, bar=None):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            fail(f"non-finite logits in the first {what}")
        same = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        n, err = int((a != b).sum()), float((a - b).abs().max())
        log(f"first {what}: logits max-abs difference {err:.4g} "
            f"(logits max-abs {float(b.abs().max()):.4g}; {n}/{a.numel()} "
            f"logits differ), greedy tokens equal {same:.0%}")
        if bar is not None and err > bar:
            fail(f"first {what}: logits differ by {err:.4g} > {bar}")
        return n

    st_k, st_p = clone_state(state0), clone_state(state0)
    with recording():
        lg_k, st_k = prefill(eng.params, st_k, toks_t, n_t, mcfg,
                             Numerics(quant, key))
    exact = check_calls("prefill pass")
    lg_p, st_p = prefill(eng.params, st_p, toks_t, n_t, mcfg,
                         Numerics(quant, key, plain=True))
    if compare("prefill pass, kernels vs plain versions", lg_k, lg_p,
               DECODE_LOGIT_BAR) and exact:
        fail("the prefill pass runs no kernel 3, yet its logits differ")
    tok = lg_k.argmax(-1).to(torch.int32)
    st_a = clone_state(st_p)
    with recording():
        lg_k, _ = decode_step(eng.params, st_k, tok, mcfg,
                              Numerics(quant, key_d))
    exact = check_calls("decode tick")
    lg_p, _ = decode_step(eng.params, st_p, tok, mcfg,
                          Numerics(quant, key_d, plain=True))
    compare("decode tick, kernels vs plain versions", lg_k, lg_p,
            DECODE_LOGIT_BAR)
    with patched(model_layers, "fused_quantized_decode_attention",
                 quantized_decode_attention):
        lg_a, _ = decode_step(eng.params, st_a, tok, mcfg,
                              Numerics(quant, key_d))
    if compare("decode tick, kernels but kernel 3's plain version vs plain "
               "versions", lg_a, lg_p) and exact:
        fail("the decode tick differs from the plain run with kernel 3 "
             "swapped out, yet every kernel-1/2 call was bit-equal")
    del st_k, st_p, st_a
    ops.reset_launch_counts()

    # 6. time: one decode tick's worth of each kernel --------------------
    # The seeds of the timed calls live in device memory, as a pass's seed
    # table does (int seeds cannot be captured into a graph).
    s7 = torch.tensor([7], dtype=torch.int32, device=dev)
    seeds_d = torch.tensor(seeds, dtype=torch.int32, device=dev)
    xb = torch.bfloat16
    x_d = act(CAPACITY, mcfg.d_model)
    x_f = act(CAPACITY, mcfg.d_ff)
    mats = [(lp["attn"]["wo"], x_d) for lp in layers] \
        + [(lp["mlp"][w], x_d) for lp in layers for w in ("wi", "wg")] \
        + [(lp["mlp"]["wo"], x_f) for lp in layers] \
        + [(eng.params["lm_head"], x_d)]
    c1 = np.sum([k1_cost(CAPACITY, pw, 2) for pw, _ in mats], axis=0)

    def k1_tick(fn=abfp_matmul_packed):
        for pw, xx in mats:
            fn(xx, pw, quant, s7)

    pf = act(CAPACITY * 128, mcfg.d_model)
    pf_f = act(CAPACITY * 128, mcfg.d_ff)
    pmats = [(lp["attn"][w], pf) for lp in layers
             for w in ("wq", "wk", "wv", "wo")] \
        + [(lp["mlp"][w], pf) for lp in layers for w in ("wi", "wg")] \
        + [(lp["mlp"]["wo"], pf_f) for lp in layers]
    cp = np.sum([k1_cost(CAPACITY * 128, pw, 2) for pw, _ in pmats], axis=0)

    def k1_prefill():
        for pw, xx in pmats:
            abfp_matmul_packed(xx, pw, quant, s7)

    def k2_tick(fn=None):
        for lp in layers:
            p3 = tuple(lp["attn"][w] for w in ("wq", "wk", "wv"))
            if fn is None:
                fused_qkv_packed(x_d, p3, quant, seeds_d,
                                 qkv=lp["attn"]["qkv"])
            else:
                fn(x_d, p3, quant, seeds_d, lp["attn"]["qkv"])

    # The two-launch route of kernels 1-2 (the earlier decode design), timed
    # against the decode route in turns.
    def k1_two_launch():
        k1_tick(lambda x, pw, cfg, sd: _abfp_matmul_packed(x, pw, cfg, sd, 0))

    def k2_two_launch():
        k2_tick(lambda x, p3, cfg, sd, qkv: _fused_qkv_packed(
            x, p3, cfg, sd, qkv, 0))

    c2 = np.sum([k1_cost(CAPACITY, lp["attn"][w], 2) for lp in layers
                 for w in ("wq", "wk", "wv")], axis=0)
    c2[0] -= 2 * (len(layers) * CAPACITY * mcfg.d_model * 2)  # x read once
    caches = [lp["kv"] for lp in eng.state["layers"]]
    lens = caches[0]["length"].clone()
    qd = torch.randn(CAPACITY, 1, h, hd, generator=gen,
                     device=dev).to(torch.bfloat16)

    def k3_tick(fn=fused_quantized_decode_attention):
        for c in caches:
            fn(qd, c["k"], c["k_scale"], c["v"], c["v_scale"], lengths=lens)

    b3, f3 = k3_cost(lens.tolist(), MAX_LEN, kh, h, hd)
    b3 *= len(caches)
    f3 *= len(caches)
    rows = []
    spec = [
        ("abfp_matmul_packed", "src/repro_torch/kernels/csrc/abfp_matmul.cu",
         "src/repro/kernels/abfp_matmul.py:437", "abfp_matmul_packed_pallas",
         k1_tick, k1_two_launch, lambda: k1_tick(abfp_matmul_packed_ref),
         bound(*c1),
         "one decode tick: 32 x (attn.wo, mlp.wi, mlp.wg, mlp.wo) + lm_head, "
         "M=4"),
        ("fused_qkv_packed", "src/repro_torch/kernels/csrc/abfp_matmul.cu",
         "src/repro/kernels/abfp_decode_fused.py:186", "fused_qkv_packed_pallas",
         k2_tick, k2_two_launch,
         lambda: k2_tick(lambda x, p3, cfg, sd, qkv: fused_qkv_packed_ref(
             x, p3, cfg, sd)), bound(*c2),
         "one decode tick: 32 x (wq|wk|wv), M=4"),
        ("fused_quantized_decode_attention",
         "src/repro_torch/kernels/csrc/decode_attention.cu",
         "src/repro/kernels/abfp_decode_fused.py:360",
         "fused_quantized_decode_attention",
         k3_tick, None, lambda: k3_tick(quantized_decode_attention),
         bound(b3, 0.0, f3),
         f"one decode tick: 32 layers, S_max={MAX_LEN}, lengths "
         f"{lens.tolist()}"),
    ]
    for name, src, repl, repl_fn, fn, two_fn, plain_fn, (bms, by), work \
            in spec:
        extra = {}
        if two_fn is None:
            ms, how = graph_ms(fn, 20)
        else:
            turns = in_turns({"route": fn, "two_launch": two_fn},
                             lambda f: graph_ms(f, 20)[0])
            ms = statistics.mean(turns["route"])
            how = "graph, mean of two turns"
            two = statistics.mean(turns["two_launch"])
            extra = {"turns_ms": turns["route"], "decode_two_launch_ms": two,
                     "decode_two_launch_turns_ms": turns["two_launch"]}
        eager = median_ms(fn, 5)
        pms = median_ms(plain_fn, 3)
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": repl, "replaces_function": repl_fn,
               "launches": launches[name],
               "launches_graph_serve": graph_serve_launches[name],
               "launches_overlap_serve": overlap_serve_launches[name],
               "launches_per_decode_tick": per_pass["decode"][name],
               "launches_per_prefill_pass": per_pass["prefill"][name],
               "max_abs_err": errs[name], "ms": ms, "plain_ms": pms,
               "bound_ms": bms, "bound_by": by, "library_ms": None,
               "work": work, "timing": how, "eager_ms": eager, **extra}
        rows.append(row)
        turn_txt = ""
        if extra:
            two = extra["decode_two_launch_ms"]
            turn_txt = (f" {extra['turns_ms']}; two-launch route {two:.4f} ms "
                        f"{extra['decode_two_launch_turns_ms']}, "
                        f"{two / ms:.2f}x")
        log(f"{name}: {ms:.4f} ms ({how}{turn_txt}), eager {eager:.3f} ms, "
            f"plain {pms:.3f} ms, bound {bms:.4f} ms ({by}) for {work}")
    def k1_prefill_two_launch():
        for pw, xx in pmats:
            _abfp_matmul_packed(xx, pw, quant, s7, 0)

    pt = in_turns({"route": k1_prefill, "two_launch": k1_prefill_two_launch},
                  lambda f: graph_ms(f, 5)[0])
    pms_ = statistics.mean(pt["route"])
    pb, pby = bound(*cp)
    rows[0]["prefill_pass_ms"] = pms_
    rows[0]["prefill_pass_two_launch_ms"] = statistics.mean(pt["two_launch"])
    rows[0]["prefill_pass_bound_ms"] = pb
    rows[0]["prefill_pass_bound_by"] = pby
    log(f"abfp_matmul_packed over one prefill pass (32 x 7 matmuls, "
        f"M={CAPACITY * 128}, row block "
        f"{fused_rows(CAPACITY * 128, 128, 8, quant, 8)} for 960 columns): "
        f"{pms_:.3f} ms (graph, in turns {pt['route']}), two-launch route "
        f"{pt['two_launch']} ms, bound {pb:.4f} ms ({pby})")

    # The row block and route by M: one layer's seven matmuls on every
    # route, in turns.
    sweep = {}
    layer7 = [lp0["attn"][w] for w in ("wq", "wk", "wv", "wo")] \
        + [lp0["mlp"][w] for w in ("wi", "wg", "wo")]
    for m in (16, 32, 64, 256, 512, 2048):
        xs = {pw.k: act(m, pw.k) for pw in layer7}

        def layer_at(rows, xs=xs):
            return lambda: [_abfp_matmul_packed(xs[pw.k], pw, quant, s7, rows)
                            for pw in layer7]

        t = in_turns({r: layer_at(r) for r in (0, 16, 32, 64)},
                     lambda f: graph_ms(f, 10)[0])
        sweep[m] = {("two_launch" if r == 0 else f"fused_{r}"):
                    statistics.mean(v) for r, v in t.items()}
        picked = [fused_rows(m, 128, pw.n_padded // 128, quant, pw.num_tiles)
                  for pw in layer7]
        shown = {k: round(v, 4) for k, v in sweep[m].items()}
        log(f"one layer's 7 matmuls at M={m}: ms by route (mean of two "
            f"turns) {json.dumps(shown)}; the wrapper's row blocks {picked}")
        del xs
    rows[0]["layer_ms_by_route"] = sweep
    # The same for the LM head, the one weight that does not stay in L2.
    head = eng.params["lm_head"]
    hsweep = {}
    for m in (16, 32, 48, 64, 512, 2048):
        x = act(m, head.k)
        t = in_turns({r: (lambda r=r: _abfp_matmul_packed(x, head, quant, s7,
                                                          r))
                      for r in (0, 16, 32, 64)},
                     lambda f: graph_ms(f, 10)[0])
        hsweep[m] = {("two_launch" if r == 0 else f"fused_{r}"):
                     statistics.mean(v) for r, v in t.items()}
        shown = {k: round(v, 4) for k, v in hsweep[m].items()}
        log(f"lm_head {tuple(head.codes.shape)} at M={m}: ms by route (mean "
            f"of two turns) {json.dumps(shown)}; the wrapper's row block "
            f"{fused_rows(m, 128, head.n_padded // 128, quant, head.num_tiles)}")
        del x
    rows[0]["lm_head_ms_by_route"] = hsweep
    ops.reset_launch_counts()

    # 7. evaluate: this slice's main path --------------------------------
    # evaluate_abfp over EVAL_BATCHES batches, the launch counts zeroed just
    # before and read just after.
    nl = emcfg.num_layers
    per_forward = {name: 0 for name in launches}
    per_forward.update(abfp_matmul=7 * nl + 1, flash_attention=nl)
    rng = np.random.default_rng(SEED)
    batches = [{"tokens": rng.integers(1, emcfg.vocab_size,
                                       (EVAL_BATCH, EVAL_SEQ + 1))
                .astype(np.int32)} for _ in range(EVAL_BATCHES)]
    ekey = prng.PRNGKey(SEED)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    acc_q = evaluate_abfp(params, batches, emcfg, equant, key=ekey)
    torch.cuda.synchronize()
    eval_wall = time.perf_counter() - t0
    elaunch = ops.launch_counts()
    log(f"launch counts over evaluate_abfp ({EVAL_BATCHES} batches of "
        f"{EVAL_BATCH} x {EVAL_SEQ + 1} tokens): {elaunch}")
    for name in ("abfp_matmul", "flash_attention"):
        if elaunch[name] <= 0:
            fail(f"kernel {name} was not launched on the evaluation path")
    if elaunch != {k: EVAL_BATCHES * v for k, v in per_forward.items()}:
        fail(f"evaluate_abfp launched {elaunch}, expected "
             f"{EVAL_BATCHES} x {per_forward}")
    acc_f = evaluate_abfp(params, batches, emcfg, QuantConfig(mode="float"),
                          key=ekey)
    log(f"evaluate_abfp on full smollm-360m (random weights, random tokens) "
        f"in {eval_wall:.2f}s: next-token accuracy {acc_q:.6f} under ABFP "
        f"(abfp_kernel, tile 128, gain 8, noise 0.5), {acc_f:.6f} in float")

    # The first batch's forward once more, read around it, every kernel
    # call held against its plain version, then the logits against the
    # plain forward's.  With every kernel-4 call bit-equal, the forward
    # rerun with kernel 5's plain version must equal the plain forward.
    inputs = torch.from_numpy(batches[0]["tokens"][:, :-1]).to(dev)
    k0 = prng.fold_in(ekey, 0)
    ops.reset_launch_counts()
    with recording():
        lg_k, _ = forward(params, inputs, emcfg, Numerics(equant, k0))
    got_counts = ops.launch_counts()
    if got_counts != per_forward:
        fail(f"one evaluation forward launched {got_counts}, expected "
             f"{per_forward}")
    exact = check_calls("evaluation forward")
    lg_p, _ = forward(params, inputs, emcfg,
                      Numerics(equant, k0, plain=True))
    eval_logit_err = float((lg_k - lg_p).abs().max())
    compare("evaluation forward, kernels vs plain versions", lg_k, lg_p,
            EVAL_LOGIT_BAR)
    with patched(model_layers, "flash_attention", flash_attention_ref):
        lg_a, _ = forward(params, inputs, emcfg, Numerics(equant, k0))
    if compare("evaluation forward, kernel 4 but kernel 5's plain version "
               "vs plain versions", lg_a, lg_p) and exact:
        fail("the evaluation forward differs from the plain run with kernel "
             "5 swapped out, yet every kernel-4 call was bit-equal")
    del lg_a, lg_p
    lg_f, _ = forward(params, inputs, emcfg, Numerics(QuantConfig(
        mode="float")))
    top1 = float((lg_f.argmax(-1) == lg_k.argmax(-1)).float().mean())
    log(f"evaluation forward: top-1 agreement between float and ABFP "
        f"logits {top1:.4f} over {lg_k.shape[0] * lg_k.shape[1]} positions")
    del lg_f, lg_k
    ops.reset_launch_counts()

    # DNF step 1 on one batch.
    t0 = time.perf_counter()
    _, stds = capture_histograms(params, inputs, emcfg, equant,
                                 key=prng.fold_in(ekey, 7))
    cap_counts = ops.launch_counts()
    if len(stds) != nl or not all(np.isfinite(stds)) or min(stds) <= 0:
        fail(f"capture_histograms gave per-layer stds {stds}")
    log(f"capture_histograms on one batch in {time.perf_counter() - t0:.2f}s"
        f" (kernel 4 x {cap_counts['abfp_matmul']}, kernel 5 x "
        f"{cap_counts['flash_attention']}): per-layer dy std "
        f"{json.dumps([float(f'{v:.4g}') for v in stds])}")
    ops.reset_launch_counts()

    # 8. eval time: one forward's worth of kernels 4 and 5 ----------------
    xe = act(EVAL_ROWS, emcfg.d_model)
    xf = act(EVAL_ROWS, emcfg.d_ff)
    lays = params["layers"]
    emats = [(lp["attn"][w], xe) for lp in lays
             for w in ("wq", "wk", "wv", "wo")] \
        + [(lp["mlp"][w], xe) for lp in lays for w in ("wi", "wg")] \
        + [(lp["mlp"]["wo"], xf) for lp in lays] \
        + [(params["lm_head"], xe)]
    if len(emats) != per_forward["abfp_matmul"]:
        fail("kernel 4's timed forward does not match the path's calls")
    c4 = np.sum([k4_cost(EVAL_ROWS, w.shape[0], w.shape[1], 128)
                 for w, _ in emats], axis=0)

    def k4_forward(fn=abfp_matmul):
        for w, xx in emats:
            fn(xx, w, equant, s7)

    qkv5 = [(torch.randn(EVAL_BATCH, EVAL_SEQ, h, hd, generator=gen,
                         device=dev).to(torch.bfloat16),
             torch.randn(EVAL_BATCH, EVAL_SEQ, kh, hd, generator=gen,
                         device=dev).to(torch.bfloat16),
             torch.randn(EVAL_BATCH, EVAL_SEQ, kh, hd, generator=gen,
                         device=dev).to(torch.bfloat16)) for _ in range(nl)]
    qkv5_t = [tuple(t.transpose(1, 2).contiguous() for t in a) for a in qkv5]

    def k5_forward(fn=flash_attention):
        for qq, kk, vv in qkv5:
            fn(qq, kk, vv, causal=True)

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_forward():
        for qq, kk, vv in qkv5_t:
            sdpa(qq, kk, vv, is_causal=True, enable_gqa=True)

    sd_err = float((sdpa(*qkv5_t[0], is_causal=True, enable_gqa=True)
                    .transpose(1, 2).float()
                    - flash_attention(*qkv5[0]).float()).abs().max())
    b5, d5, f5 = k5_cost(EVAL_BATCH, EVAL_SEQ, EVAL_SEQ, h, kh, hd, True, 0)
    # Host time of a forward to a synchronized device, and its issue time:
    # the host clock at the last enqueue, before the sync.
    host, issue = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward(params, inputs, emcfg, Numerics(equant, k0))
        issue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    fwd_host_ms = statistics.median(host)
    fwd_issue_ms = statistics.median(issue)
    log(f"one evaluation forward (4 x 512 tokens, abfp_kernel + flash): "
        f"host time {fwd_host_ms:.2f} ms (median of 3: "
        f"{[round(v, 2) for v in host]}), issue time {fwd_issue_ms:.2f} ms "
        f"(host clock to the last enqueue: {[round(v, 2) for v in issue]})")

    def peak_gib(fn) -> float:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() / 2**30

    def k4_two_launch():
        for w, xx in emats:
            _abfp_matmul(xx, w, equant, s7, 0)

    # The FMA kernel is kernel 5's f32 route: timed on the same inputs cast
    # to f32 (cast after the peak-memory reading, outside the timed calls).
    def k5_fma():
        for qq, kk, vv in qkv5_f32:
            flash_attention(qq, kk, vv)

    peaks = {"route": peak_gib(k4_forward), "two_launch": peak_gib(
        k4_two_launch)}
    log(f"peak device memory over one forward's kernel-4 calls (params "
        f"resident): {peaks['route']:.3f} GiB on the wrapper's route, "
        f"{peaks['two_launch']:.3f} GiB on the two-launch route")
    qkv5_f32 = [tuple(t.float() for t in qkv) for qkv in qkv5]
    espec = [
        ("abfp_matmul", "src/repro/kernels/abfp_matmul.py:309",
         "abfp_matmul_pallas", k4_forward, ("two_launch", k4_two_launch),
         lambda: k4_forward(abfp_matmul_ref), bound(*c4), None,
         f"one evaluation forward: 32 x (wq, wk, wv, wo, wi, wg, mlp.wo) + "
         f"lm_head, M={EVAL_ROWS}, bf16 weights"),
        ("flash_attention", "src/repro/kernels/flash_attention.py:99",
         "flash_attention", k5_forward, ("fma", k5_fma),
         lambda: k5_forward(flash_attention_ref),
         bound(b5 * nl, 0.0, f5 * nl, d5 * nl), sdpa_forward,
         f"one evaluation forward: 32 layers x (B={EVAL_BATCH}, S={EVAL_SEQ},"
         f" H={h}, KH={kh}, D={hd}) causal, bf16"),
    ]
    for name, repl, repl_fn, fn, (ab, ab_fn), plain_fn, (bms, by), lib_fn, \
            work in espec:
        src = ("src/repro_torch/kernels/csrc/abfp_matmul.cu"
               if name == "abfp_matmul"
               else "src/repro_torch/kernels/csrc/flash_attention.cu")
        turns = in_turns({"route": fn, ab: ab_fn},
                         lambda f: graph_ms(f, 10)[0])
        ms, ab_ms = statistics.mean(turns["route"]), statistics.mean(turns[ab])
        eager = median_ms(fn, 3)
        pms = median_ms(plain_fn, 1)
        lib_ms = graph_ms(lib_fn, 10)[0] if lib_fn is not None else None
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": repl, "replaces_function": repl_fn,
               "launches": elaunch[name],
               "launches_per_forward": per_forward[name],
               "max_abs_err": errs[name], "ms": ms, "plain_ms": pms,
               "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
               "work": work, "timing": "graph, mean of two turns",
               "turns_ms": turns["route"], f"{ab}_ms": ab_ms,
               f"{ab}_turns_ms": turns[ab], "eager_ms": eager,
               "forward_host_ms": fwd_host_ms,
               "forward_issue_ms": fwd_issue_ms}
        if name == "abfp_matmul":
            row["peak_gib"] = peaks["route"]
            row["peak_two_launch_gib"] = peaks["two_launch"]
        else:
            row["fma_bound_ms"] = bound(b5 * nl, 0.0, (d5 + f5) * nl)[0]
        rows.append(row)
        log(f"{name}: {ms:.4f} ms (graph, turns {turns['route']}), {ab} "
            f"route {ab_ms:.4f} ms (turns {turns[ab]}; {ab_ms / ms:.2f}x), "
            f"eager {eager:.3f} ms, plain {pms:.3f} ms, bound {bms:.4f} ms "
            f"({by}), library "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'} for {work}")
    log(f"kernel 5 against scaled_dot_product_attention on one layer's "
        f"inputs: max-abs {sd_err:.3g}")
    del qkv5, qkv5_f32, qkv5_t, xe, xf
    ops.reset_launch_counts()

    # 9. profile: where a pass's device time goes (measurement only) ------
    # Only the profiler's own import and set-up may fail (and are then
    # skipped); an error in a profiled pass fails the run.
    st = clone_state(state0)
    prefill(eng.params, st, toks_t, n_t, mcfg, Numerics(quant, key))
    tok = torch.zeros(CAPACITY, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    graph_fields = {
        ("decode",): dict(tokens=np.zeros((CAPACITY, 1)),
                          prev_mask=np.zeros(CAPACITY, bool),
                          temps=np.zeros(CAPACITY), uids=np.arange(CAPACITY),
                          idxs=np.zeros(CAPACITY)),
        ("prefill", 128): dict(tokens=toks, n_tokens=n_tok,
                               prev_mask=np.zeros(CAPACITY, bool),
                               temps=np.zeros(CAPACITY),
                               uids=np.arange(CAPACITY),
                               idxs=np.zeros(CAPACITY))}
    for kind in ("decode", "prefill", "evaluation forward",
                 "decode (graph replay)", "prefill (graph replay)"):
        stp = clone_state(st)
        shape = ("decode",) if kind.startswith("decode") else ("prefill", 128)
        if kind.endswith("(graph replay)"):
            for t, src in zip(state_tensors(geng.state), served):
                t.copy_(src)
        torch.cuda.synchronize()
        run = {"decode": lambda: decode_step(eng.params, stp, tok, mcfg,
                                             Numerics(quant, key)),
               "prefill": lambda: prefill(eng.params, stp, toks_t, n_t, mcfg,
                                          Numerics(quant, key)),
               "evaluation forward": lambda: forward(
                   params, inputs, emcfg, Numerics(equant, k0))}.get(
            kind, lambda: geng._call(shape, key, **graph_fields[shape]))
        if profile_pass(dev, run, f"{kind} pass") is None:
            break
    geng.close()
    del st, geng, served
    ops.reset_launch_counts()

    # 10. train: the training path on full smollm-360m ------------------
    served_params = eng.params
    del eng
    t0 = time.perf_counter()
    train = train_phase(dev, params, rows)
    log(f"train phase in {time.perf_counter() - t0:.1f}s: "
        f"{json.dumps(train)}")

    # 11. paged: the paged, overload-controlled serving path -------------
    del params
    gc.collect()
    torch.cuda.empty_cache()
    paged = paged_phase(dev, CheckedEngine, served_params, mcfg, quant, reqs,
                        want_streams, rows)
    log(f"paged phase in {paged['seconds']:.1f}s: {json.dumps(paged)}")

    # 12. faults: injection, detection and recovery on the served model ---
    faults = fault_phase(dev, CheckedEngine, served_params, mcfg, quant, reqs,
                         want_streams, graph_serve_launches,
                         summary4b["graphs"]["decode_ms"], card, rows)
    log(f"fault phase in {faults['seconds']:.1f}s: {json.dumps(faults)}")

    # 13. recurrent: the recurrent and hybrid families served -------------
    del served_params
    gc.collect()
    torch.cuda.empty_cache()
    rec = recurrent_phase(dev, CheckedEngine,
                          [len(r.prompt) for r in reqs[:6]], rows)
    log(f"recurrent phase in {rec['seconds']:.1f}s: {json.dumps(rec)}")

    # 14. moe: the MoE family served ------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    moe = moe_phase(dev, CheckedEngine, [len(r.prompt) for r in reqs], rows)
    log(f"moe phase in {moe['seconds']:.1f}s: {json.dumps(moe)}")

    # 15. encdec: whisper-base served, phi-3-vision at head dim 96 --------
    gc.collect()
    torch.cuda.empty_cache()
    enc = encdec_phase(dev, CheckedEngine, [len(r.prompt) for r in reqs],
                       rows)
    log(f"encdec phase in {enc['seconds']:.1f}s: {json.dumps(enc)}")

    # 16. fleet: four model families as lanes of one engine ---------------
    gc.collect()
    torch.cuda.empty_cache()
    flt = fleet_phase(dev, CheckedEngine, rows, card)
    log(f"fleet phase in {flt['seconds']:.1f}s: {json.dumps(flt)}")

    # 17. family faults: fault plans on the MoE, hybrid and enc-dec models -
    gc.collect()
    torch.cuda.empty_cache()
    ffl = family_fault_phase(dev, CheckedEngine, rows, card)
    log(f"family fault phase in {ffl['seconds']:.1f}s: {json.dumps(ffl)}")

    # 18. recurrent training: the cacheless forward, evaluation and
    # training of the recurrent and hybrid families -----------------------
    gc.collect()
    torch.cuda.empty_cache()
    rtr = recurrent_train_phase(dev, rows)
    log(f"recurrent training phase in {rtr['seconds']:.1f}s: "
        f"{json.dumps(rtr)}")

    # 19. abfp_ref: the paper's reference numerics served from the device
    # key table inside the captured passes ---------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    ref = abfp_ref_phase(dev, CheckedEngine, reqs, card)
    log(f"abfp_ref phase in {ref['seconds']:.1f}s: {json.dumps(ref)}")

    # 20. mesh: tensor-parallel serving on virtual meshes of one card -----
    gc.collect()
    torch.cuda.empty_cache()
    msh, mesh_streams = mesh_phase(dev, CheckedEngine, reqs, card, rows)
    log(f"mesh phase in {msh['seconds']:.1f}s: {json.dumps(msh)}")

    # 21. mesh training and faults on a mesh -----------------------------
    gc.collect()
    torch.cuda.empty_cache()
    mtr = mesh_train_phase(dev, CheckedEngine, reqs, mesh_streams,
                           moe["eval_forward"]["launches"], card, rows)
    log(f"mesh training phase in {mtr['seconds']:.1f}s: {json.dumps(mtr)}")

    # 22. the dry run's cost analysis against the card --------------------
    gc.collect()
    torch.cuda.empty_cache()
    dry = dryrun_phase(dev, card)
    log(f"dry-run phase in {dry['seconds']:.1f}s: {json.dumps(dry)}")

    # 23. dense: gemma-7b and chatglm3-6b at full width --------------------
    t0 = time.perf_counter()
    den = dense_phase(dev, CheckedEngine, [len(r.prompt) for r in reqs],
                      rows)
    log(f"dense phase in {den['seconds']:.1f}s: {json.dumps(den)}")

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
