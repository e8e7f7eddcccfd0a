#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. device and build: print the card's name and power limit (as
     ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
     gives them) and build every kernel from ``csrc/`` with nvcc, one
     process per source, all started together; the flash forward's
     instances, the dq and dk/dv kernels, the four matmul variants'
     kernels, the activation kernels of ``epilogue.cu``, the decode
     kernel's slot and paged instances and the nms mask, scan and finish
     kernels must spill no
     register (``-Xptxas -v``; all but the first three log theirs), every
     matmul
     kernel's SASS (``cuobjdump -sass``) must hold HGMMA and UTMALDG
     (counted with UTMASTG, of which noacc's must hold none) and the
     float32 dq and dk/dv kernels' HMMA (their 3xTF32 tensor-core
     products), or the run fails; the bf16 kernels (AMP) of the flash
     forward, dq and dk/dv (their own sources, on the bf16 tensor cores)
     and the bf16 instances of the act kernels among them, each held
     apart: no spill (the tensor-core forward, dq and dk/dv: at most
     ``TC_SPILL_LIMIT`` bytes, logged), HMMA in the bf16 forward, dq and
     dk/dv; the BN
     apply's, add+act's and the xent kernels' bf16 instances spill
     nothing either, nor does any instance of the whole-model optimizer
     update, nor the sampler's noise kernel;
  2. kernels against their plain PyTorch versions on the card, float32:
     the serving kernels at the serving slice's shapes (max abs error
     <= 1e-5; the flash forward through every block size it is built
     for), the decode contract bitwise (row p of the causal forward over
     a 512-token, 12-head sequence, through every block size, equal to
     the decode kernel's output at position p over a slot cache holding
     the same K/V, p in 0, 5, 64, 127, 128, 200, 255, 256, 300, 511;
     and over 1152 tokens, nine tiles, two rounds of the decode kernel's
     8-CTA cluster, p on the tile edges 0, 127, 128, 255, 511, 1023,
     1024, 1151), the decode kernel against its plain version at max_len
     512, 1152 and 0 (an empty cache: every slot writes zeros), the
     paged decode kernel against its plain version (1e-5) and bitwise
     against the slot kernel over the same K/V, scattered into pools
     through shuffled page tables whose trash page and unused pages hold
     large finite garbage, at page sizes 8, 16, 128 and 256, max_len 512
     and 1152 (at 256 a view of 1280 keys), at the slot checks'
     positions and the page edges, the
     training kernels at the training slice's shapes
     (1e-5 absolute for out, lse, nll and logp; 1e-5 relative to each
     tensor's max abs for dq, dk, dv and dlogits, which sum over 128 rows
     of O(1) terms), the xent forward also at V 1000, 30523, 50000,
     200003 and 600001 so that each of its instances (a warp, a cluster
     of 2, 4 or 8 CTAs, a block a row) launches and rows start on and off
     16-byte boundaries, with labels out of range in every case; the
     xent backward alone on ``XENT_BWD_CASES`` (V 1, 2, 3, 5, 1000, 30522
     and 30523, n below a tile and of whole tiles, n % 4 each of 0-3,
     labels 0, V - 1, -1 and V, g a scalar and per row), each case's
     max abs difference and bitwise equality printed, and past 2**31 - 1
     elements in chunks of whole rows (``XENT_BWD_CHUNKED``); the
     five epilogue kernels for every act type at the ResNet's stem and
     last-stage BN shapes and at odd sizes (9102 and 3003 elements:
     whole tiles, a rest and a tail; 5: below a tile), bitwise for
     identity, relu, leaky, softsign, add+relu and the BN apply, 5e-7 of
     the max abs for sigmoid, tanh and softrelu; then each kernel, its
     plain version and the one PyTorch library call that computes the
     same function timed with CUDA events at the main paths' shapes
     (the xent forward also beside ``log_softmax``, which writes the
     same logp; dq + dkv also against SDPA's backward in alternating
     turns), one event pair a call
     (``ms``: the wrapper's host cost included, the earlier protocol), and
     the kernel and the library call also by the probe's back-to-back
     slope timer over inputs rotated past the L2 (``device_ms``: device
     time alone, inputs read from memory as the bound counts them; see
     phase 7); the decode kernel's device time also at every slot on
     position 127 and 511; the paged decode kernel's at page size 16
     beside the slot kernel over the same K/V, the page-table gather +
     the slot kernel and SDPA over the gathered view, at the decode case
     and at phase 3's positions. Then the bf16 kernels (AMP) at the
     training slice's attention cases, the odd cases and Sq != Sk: the
     tensor-core forward, dq and dk/dv, which round p (and ds) to bf16
     before their products, within two bf16 ULPs of their own plain
     versions beyond the float32 tier and what a bf16 flip of p or ds
     near a rounding midpoint can move (``slack=True`` of the plain
     versions), within the reference's bf16 tier of the reference
     function (0.02 absolute for out, 2e-2 of the max abs for dq, dk and
     dv), lse within 1e-5 of the float32 kernel's; the act forward and
     backward for every act type at the epilogue check sizes, bitwise
     their float32 kernels on the widened inputs, rounded, and within
     one ULP of their plain versions; then each timed at the main path's
     shapes (attention at B 96 H 12 S 128 D 64, the act kernels at the
     pooler's 96 x 768 tanh, also at the ResNet stem shape in relu)
     beside its float32 instance, its plain version and the library call
     on bf16 (SDPA and its backward, ``torch.tanh`` / ``tanh_backward``,
     ``torch.relu`` / ``threshold_backward``), with bounds at bf16 bytes
     (the attention kernels' against one bf16 product at 989 TFLOP/s),
     forward + dq + dk/dv against SDPA's forward + backward on bf16, and
     in alternating turns dq + dk/dv against SDPA's backward and forward
     + dq + dk/dv against SDPA's forward + backward. Then the bf16
     instances of the ResNet path (rows 5b, 6b, 9b, 10b, 11b): the BN
     apply forward and backward at ResNet-50's nine BatchNorm shapes
     (identity) and add+relu at its four join shapes, every act type at
     the epilogue check shapes and the BN apply's odd inners, the xent
     forward on bf16 logits at every ``XENT_SHAPES`` case (each of its
     instances) and its backward writing bf16 on ``XENT_BWD_BF16_CASES``
     (8-element vectors: below a tile, whole tiles, rests and tails),
     each bitwise its float32 kernel on the widened inputs (rounded once)
     and within one bf16 ULP of its plain version beyond the float32
     tier; then each timed beside its float32 instance and the library
     call on bf16 (``batch_norm``, ``torch.mul``, none for add+relu,
     ``cross_entropy`` / ``log_softmax`` and ``cross_entropy``'s
     backward; the xent head at ResNet's 128 x 1000 and the MLM's 1920 x
     30522, where the xent forward's cluster instance is also timed at 1,
     2, 4 and 8 CTAs a row on bf16 logits and on them widened, in
     turns). Then the whole-model optimizer update (row 17): every rule
     (SGD, SGD + momentum, AdamW, with rescale, an lr and a wd
     multiplier, and a clip that clamps at least a fifth of the
     gradient) in every form (float32; bf16 without a master; bf16 with
     float32 masters) through the trainer's ``FusedUpdate`` against its
     plain version, the per-parameter loop of
     ``update_multi_precision``, bitwise (weights, states, masters,
     update counts) over 3 steps, with one launch of the form's instance
     a step, at odd lengths (a misaligned view, a parameter without a
     gradient) and at BERT-base's and ResNet-50's parameter lists; then
     timed at the pairs the trainer phases run (BERT-base with AdamW in
     every form, ResNet-50 with SGD + momentum in float32 and bf16)
     beside its bound, the plain loop and the ``_foreach_`` chain of the
     same expressions (not one call). Then the sampler's noise kernel
     (row 18, ``threefry_gumbel``) against its plain version at the
     step's 8 x 30522 keys and draws, the verify's 32 rows, a prefill's
     one and odd widths (1, 255, 257, 1000): the uniforms (its bits
     through the uniform) bitwise, the gumbel values within one float32
     ULP (``noise_ulps``); timed at the step's shape (no library call
     computes JAX's threefry gumbel), its bound counted from its SASS mix
     (``cuobjdump -sass``: float32, integer and special-function
     instructions a thread at each pipe's rate, all of them at the issue
     rate; ``sass_bound``);
  3. the serving slice: a BERT-base-width causal TransformerLM (vocab
     30522, units 768, hidden 3072, 12 layers, 12 heads, max_len 512,
     random weights from seed 0) frozen with the slot cache and served
     through ``InferenceSession.generate``: 16 concurrent requests,
     prompts of 8-256 tokens, 32 new tokens each. The kernels' launch
     counts are zeroed just before this run and must show 12 launches
     per prefill and per step; two requests are re-derived with the
     uncached ``full_forward`` after every token. 3p: the same requests
     through ``freeze_decode``'s default, the paged cache at page size 16
     (257 pages): the tokens must equal phase 3's token for token, with
     12 flash forward launches a prefill, 12 paged decode launches a step
     and no slot decode launch; its metrics beside phase 3's and
     ``cache_accounting()``. 3s: prefix sharing (16 prompts of one
     192-token prefix and 8-64-token suffixes, the prefix alone twice
     amid them: one prefill, >= 15 hits, >= 1 copy on write) and then
     speculative decoding of phase 3's prompts with 3 proposals a tick
     from a self-draft (acceptance >= 0.9, fewer ticks than tokens), exact
     launch counts, every token teacher-forced against ``full_forward``
     (a mismatch only at a tie within 1e-4). Every program of 3, 3p and
     3s (and of the draft) is a CUDA graph that the session's engine
     captures as it starts: the set must be the reference's (the ladder
     and the step; the paged ones add the page copy, and the verify under
     speculation), no request may build another, and each run is repeated
     with the same bodies uncaptured (``capture = False``), whose tokens
     and launch counts the captured run must equal; a replayed
     ``run_step`` at phase 2's positions is timed with CUDA events and
     profiled (its device busy share) beside the eager one. These
     programs are the knob's default, with sampling built in, so each
     prefill, step and verify call (the draft's too) launches the noise
     kernel once, and the counts must show it. 3a: sampled decoding and
     adapters at the same width through the paged default with sampling
     and an adapter pool of 8 rows of rank 8: 24
     requests of 32 tokens (3p's 16 prompts and 8 more of 8-256 tokens)
     in four kinds, greedy or sampled (temperature 0.8, top_p 0.9, seeds
     0-23) on the base or on one of 8 adapters (scale 10), which the 7
     rows must
     evict: the program set built at start and no other, the greedy base
     streams on 3p's prompts equal to 3p's, the whole mix uncaptured
     token for token, every adapter stream unlike its base twin, exact
     launches, no adapter reject; the sampled requests again with 3
     proposals a tick from a self-draft (base traffic's acceptance >=
     0.9), equal to the plain streams but where the plain run's top two
     perturbed scores lie within 1e-4; a program with the logit mask
     emitting no odd token id under a mask that forbids them; and the
     replayed step without extras, with sampling and with sampling and
     adapters, in turns. Every healthy serving run (3, 3p, 3s, 3a and 6b)
     ends by asserting zero degradation: the session's breaker closed,
     no token from the CPU fallback (one-shot: no fallback batch) and no
     stream marked degraded. 3f: the degraded path on the card, at the
     slice's width through the paged default with sampling: 8 requests
     (3p's first 8 prompts; 4 greedy, 4 sampled at temperature 0.8,
     top-p 0.95, seeds 0-7) of 16 tokens served healthy, then in a fresh
     session each under a scripted fault (``MXNET_TPU_FAULT``, set only
     here and unset in a ``finally`` that lets a failure through): (a)
     ``device_loss@serving.decode.17`` once, after every prefill and at
     least 2 steps: every stream completes degraded with the healthy
     tokens (where one differs, at a near-tie of the teacher-forced
     margin, counted), fallback tokens counted, ``retired['degraded']``
     8, the pool all free, no program built, and a clean request on the
     card after; (b) ``device_unavailable@serving.decode:3`` under a
     breaker of 3 failures and a 2 s reset: the breaker opens, the
     requests it refuses complete on the CPU, the half-open probe runs on
     the card and closes it (the time from the trip to the first card
     token printed); (c) ``worker_crash@serving.decode.17`` once: the
     streams fail with ``WorkerCrashError``, their slots free, the next
     request clean; (d) ``hang@serving.decode.17`` once: the stall
     artifact (``mxnet_tpu.stall.v1``, phase ``decode``) written and the
     streams degraded with the healthy tokens; after 6b, (e) 6b's frozen
     SSD-300 serves 2 images under ``device_loss@serving:1``: the batch
     re-served by ``run_fallback``, byte for byte its host block's
     output, whose heads are the card's within 6a's tolerance; the host
     detection of the card's heads and the served rows both keep the
     card's rows, every one (6a's matching; no slack excuses a
     difference), ``status()`` degraded, then ok after a clean batch. The
     card-side launches of 3f are exact and listed as ``degraded
     serving``; the CPU ms a degraded token and 3f's seconds are
     printed. 3h, after 6b and 3f (e): (a) phase 3p's program with 3s's
     speculation (``spec_k`` 3), its self-draft (the same weights frozen
     ``paged=False``) and 6b's frozen SSD-300 saved as
     ``mxnet_tpu.frozen.v1`` artifacts (seconds, bytes, manifest keys);
     (b) a fresh ``sys.executable`` process, its environment stripped of
     every ``MXNET_TPU_*`` variable but ``MXNET_TPU_SERVE_SPEC_K=3`` and
     ``MXNET_TPU_SERVE_SPEC_DRAFT`` (the draft's artifact), imports only
     the port, ``load_frozen``s both artifacts on the card, captures the
     reference's program sets (the draft's through the knob), and serves
     them behind one ``ServingHTTPServer`` (port 0; the decode session
     mounted as ``decode_session``); (c) driven over HTTP: 3a's 17th
     prompt alone to the cache's end (the first served token after the
     spawn, split into imports, load, capture and first token), 3p's 16
     greedy requests as NDJSON streams 8 at a time (token for token 3p's;
     tokens/s and TTFT beside 3p's), 3a's sampled base requests as plain
     bodies (equal to 3a's in-process streams at the same seeds), 6b's 8
     one-by-one images to ``/predict`` (bitwise 6b's responses; latency),
     ``/healthz`` 200, a malformed body 400 and a ``request_id`` echoed on
     a plain body; no request builds a program, speculation acceptance
     with the loaded draft >= 0.9, and the child's launch counts, zeroed
     before its first request, exact (3s's arithmetic over its engine's
     counts, one nms and 14 BN applies a ``/predict``), with plain paged
     steps among them; (d) a second child under
     ``device_loss@serving.decode.9:1`` with a breaker of one failure: the
     stream's done line ``degraded: true`` with the healthy tokens (a
     difference only at a near tie), ``/healthz`` 503 while the breaker is
     open. The children's launches join the ``kernels`` line. 3m, live
     migration at the slice's width (after 3a, and (c)-(d) with 3h's main
     child): (a) source A, 3a's program (page size 16, sampling, 8 rank-8
     adapters over 7 pool rows), serves 3a's 24 requests; once 8 streams
     have 8 tokens each, ``export_all`` gives 8 ``paged`` and 16 ``cold``
     payloads, which B (the same weights and adapters at page size 128)
     imports: each spliced stream equal to 3a's (a sampled one but at a
     near tie of the perturbed scores, < 1e-4), B's prefills the cold
     payloads, 8 in (the live imports), the handoff pages each live
     payload's at each page size; (b) 3s's 16 shared-prefix prompts ``prefill_only`` on A (15
     prefix hits exported extending, before any token), imported by B
     with no prefill, equal to 3s's greedy streams; exact launches for (a)
     and (b), neither pool's storage replaced; each live payload alone
     on B with an empty trie: import ms and its first continuation token
     beside a fresh ``generate(prompt + emitted)``'s TTFT; the export's
     gather + D2H and payload build apart, raw and JSON bytes; (c) 3h's
     main child (its endpoint's preemption hook armed, blocked in
     ``serve_until_drained``) streams 8 of 3p's greedy requests (128
     tokens, request ids), SIGTERM after 4 tokens each: done lines
     ``migrated``, ``/healthz`` 503 ``draining``, ``/generate`` and
     ``/import`` 503 ``Draining``, each payload from ``GET
     /drain?request_id=``, ``POST /import`` into B' (page 128, no draft)
     continuing each with unbroken indices, the first 32 tokens 3p's and
     every token teacher-forced, B' running no prefill, exact launches
     in the child and in B', the child printing ``handed_off`` 8 and
     exiting 75 within the 30 s drain budget; (d) ``/import`` of a
     payload with one base64 character changed, and of an
     adapter-pinned payload into B' (no adapters), 400. 3g, the port's
     ``ServingGateway`` (health period 0.25 s, resume and affinity on)
     over 3p's program, inside 3h after its children: a child process
     spawned as 3h's main child (3h's LM artifact and its draft) and six
     replicas in process (``relay``, ``pre``, ``first`` with the ladder
     to 384, ``second``, ``b128`` at page size 128, ``small`` with a
     4-page pool). The relay's cost: 3p's 16 requests 8 at a time straight to
     ``relay`` (cold), through a gateway and straight again (warm):
     TTFT p50 / p99 and tokens/s. (a) 3p's 16 streams through a gateway
     over the child and ``first``; once every stream on the child has 4
     tokens, SIGKILL: every stream ends with a done line and no error
     line, indices 0..31, ``resumed`` 1 on the moved ones (re-prefilled
     prompt + emitted on ``first``), 3p's tokens (a moved stream: but at
     a near tie, teacher-forced top-2 margin < 1e-4), ``/healthz``
     ``degraded``, ``resumes`` the moved streams. (d) tenant admission
     (rps 2, burst 2, 8 in flight) on ``first``: one tenant bursts 16,
     the other sends 1 every 0.5 s: the steady one only 200s, the burst
     typed 429s naming its tenant with ``Retry-After`` from its bucket,
     as many as ``mxnet_tpu_gateway_tenant_rejected_total`` on
     ``/metrics``. (c) ``pre`` the prefill class, ``b128`` and
     ``second`` the decode class: 3p's 16 greedy and 3a's 6 sampled base
     requests 8 at a time, then 3 fresh prompts (64, 128, 250 tokens) one
     at a time, each ``prefill_only`` then imported: spliced as many, no
     prefill on the decode side, ``migrated_out`` the sum of the
     ``migrated_in``, both decode replicas used, greedy 3p's, sampled
     3a's but at near ties, the fresh ones the tokens ``relay`` serves
     them monolithically (their TTFT beside); (e) one request with a
     client-minted
     ``X-Mxnet-Trace`` root: ``gw.request``, ``gw.route``, ``gw.relay``,
     ``gw.handoff``, ``gw.splice`` on the gateway's ``GET /trace``, one
     tree (``tree_verdict``), the replicas sent child headers of the same
     trace; then ``small`` refuses a 250-token prompt's payload (429, its
     pool) and the next decode replica takes it (``handoff.retries`` >=
     1). (b) ``first`` drains under 8 of 3p's streams (128 tokens) while
     ``b128``'s endpoint comes back: each payload from ``GET
     /drain?request_id=`` into ``b128`` by ``POST /import``, no prefill,
     ``migrations.spliced`` 8, ``migrated_in`` 8, the first 32 tokens
     3p's and every token teacher-forced. The in-process launches exact
     against the engines' counts (rows 1, 4p, 18), no program built by a
     request; the child's launches, read just before the kill, join the
     ``kernels`` line. 3l, after 3g: the port's load and chaos harness
     (``mxnet_tpu_torch.loadgen``) over rigs of 3p's program
     (``LOADGEN_RIG``: BERT-base widths, page size 16, 257 pages, 8
     slots, sampling). One replica (``ServingRig``; the loadgen MLP's
     relu, row 7, held bitwise to its plain version at every bucket):
     capacity search, overload at 2.5x the measured capacity, the full
     chaos script with the pool squeeze, the shared-prefix workload;
     3a's geometry (8 rank-8 adapters, 7 pool rows) for the adapter
     workload; gateway rigs of two replicas for the traced failover, the
     drain and the tenants (one traced request first: its tree and
     ``decompose_ttft`` printed), four (two a class) for the traced
     disaggregated drill. Every verdict holds but the latency budgets and
     what this geometry cannot reach (``LOADGEN_PRINTED``, printed);
     every drill tree holds the replicas' ``eng.*`` spans; each rig's
     launches (rows 1, 4p, 7, 18) exact against its engines' and
     sessions' counts, joining the ``kernels`` line;
  4. the training slice. 4a: a small BERT (2 layers, units 256, 4
     heads, vocab 1000) takes one forward and backward and then three
     ``ParallelTrainer`` AdamW steps on the card (kernels) and on the CPU
     (plain versions) from the same weights; losses agree to 1e-5 and
     gradients to 1e-4, both relative. 4b: BERT-base
     (``bert_12_768_12``, vocab 30522, dropout 0.1, random weights from
     seed 0) trains MLM + NSP with AdamW (lr 1e-4, wd 0.01) on a fixed
     batch of 96 x 128 tokens with 20 masked positions: 2 warm-up steps,
     then 10 timed steps, between which the launch counts are zeroed and
     read, and must show 12 flash forward, 12 dq, 12 dkv, 2 xent forward
     and 2 xent backward launches per step; losses are finite, the first
     lies within 1.5 of ln(30522) + ln(2), and the last three fall below
     it. 4a-amp: 4a's small BERT under ``amp='bf16'`` on the card
     against the CPU (loss and step losses 1e-2, gradients 2e-2 of their
     max abs: ``tests/test_torch_amp.py``'s tolerances). 4c: 4b's
     configuration, weights and batch under ``amp='bf16'`` (bf16 compute
     over float32 masters), 2 + 10 steps: per step exactly 12 bf16 flash
     forward, dq and dk/dv launches, one bf16 act forward and backward,
     2 float32 xent forward and backward, and nothing else; losses finite
     and falling, the first within rtol 6e-2 of 4b's; masters and AdamW
     state float32; step ms, samples/s, busy share, the profile groups
     (casts apart) and peak memory beside 4b's. Every trainer step also
     launches the whole-model optimizer update once a form of
     parameters (float32 here). 4a-cast: 4a's small BERT after
     ``cast('bfloat16')``, AdamW without and with ``multi_precision``,
     on the card against the CPU at 4a-amp's tolerances. 4d:
     ``bench_bert``'s accelerator configuration, 4b's weights and batch
     after ``cast('bfloat16')`` with AdamW on bf16 weights and state, 2
     + 10 steps: per step exactly 12 bf16 flash forward, dq and dk/dv
     launches, one bf16 act forward and backward, 2 bf16 xent forward
     (the MLM's cluster and NSP's warp instance) and backward, one
     ``multi_tensor_update.bf16``, nothing else; losses finite, the first
     within rtol 6e-2 of 4b's, each of the last three below it;
     parameters and state bf16; its metrics beside 4b's and 4c's. 4d-mp:
     the same with ``multi_precision`` (float32 masters and state, one
     ``multi_tensor_update.mp`` a step). Every trainer step here is one
     captured program from the second step on (the launch counts count
     its replays); at 4b's and 4d's configurations a captured trainer
     and its eager twin (``capture = False``), both under deterministic
     algorithms, take 12 steps that must agree bit for bit, losses and
     every parameter. 4e: at the small BERT, ``step_n`` over 12 copies
     of the batch bit for bit 12 steps (dropout 0.1), ``build`` /
     ``snapshot`` / ``restore`` and ``step_accum(x, y, 2)`` within 1e-5
     of one full-batch step with ``num_update`` 1 (eager, captured and
     replayed), and a captured dropout draw's replays equal to the
     eager draws of a generator seeded alike;
  5. the ResNet slice. 5a: a narrow v1 ResNet (``[2, 1, 1, 1]`` x ``[8,
     16, 32, 64, 128]``, 10 classes) takes one forward and backward and
     three SGD steps (lr 0.001) on the card and on the CPU from the same
     weights, on 4 x 3 x 64 x 64 images (loss and step losses 1e-5
     relative, gradients 5e-4 relative to their max abs, parameters and
     moving statistics 5e-5 absolute), and a frozen BatchNorm runs under
     autograd on both. 5b: ``resnet50_v1`` (Xavier weights from seed 0)
     trains with SGD (lr 0.1, momentum 0.9, wd 1e-4) on a fixed batch of
     128 x 3 x 224 x 224 images, 1000 classes: 2 warm-up + 10 timed
     steps with exact launch counts per step (53 BN apply, 33 act, 16
     add+act, 49 act backward, one xent each way, one whole-model SGD
     update), finite losses, the
     first within 1.5 of ln(1000), falling for two steps and by 1 in
     all; a profiled step; an inference forward (53 / 33 / 16). 5c: the
     trained net, its moving statistics recomputed for its weights, with
     every BatchNorm frozen (``use_global_stats``) fine-tunes 3 SGD steps
     (lr 0.01), which adds 53 BN apply backward launches a step; the
     losses must be finite and the moving statistics must not move.
     5a-amp: 5a's narrow ResNet on the card against the CPU under
     ``amp='bf16'`` and after ``cast('bfloat16')`` on bf16 images: loss
     within 1e-2 and step-0 gradients within 2e-2 of their max abs
     (4a-amp's tiers), three SGD steps within 6e-2.
     5d: 5b's net, weights and batch under ``amp='bf16'``, 2 + 10 steps:
     per step exactly 53 float32 BN apply (training widens the data), 33
     bf16 act, 16 bf16 add+act, 49 bf16 act backward, one float32 xent
     each way; first loss within 6e-2 of 5b's, falling as 5b's; img/s,
     step ms, the profile (casts apart) and peak memory beside 5b's; an
     inference forward (53 bf16 BN apply, 33 / 16); then 5c's frozen-BN
     fine-tuning under AMP (53 bf16 BN apply and 53 bf16 BN apply
     backward a step, statistics unchanged). 5e: the same net after
     ``cast('bfloat16')`` on bf16 images, SGD without ``multi_precision``
     (``bench_resnet``): per step 53 float32 BN apply, 33 / 16 / 49 bf16,
     one bf16 xent forward (bf16 logits) and backward (bf16 dlogits), one
     whole-model update of the bf16 weights and one of BatchNorm's
     float32 parameters;
     first loss within 6e-2 of 5b's, losses finite, the same metrics.
     5f: ResNet-50 at 5b's configuration, a captured trainer and its
     eager twin under deterministic algorithms, 12 steps bit for bit;
  6. the SSD detection serving slice. The nms kernel against its plain
     version on the card, keep masks bitwise equal: 16 x 7378 boxes
     class-aware at topk 400, 2 x 7378 class-agnostic with every box
     suppressing, N of 1, 100 and 129, all invalid, duplicates and zero
     areas, NaN coordinates, N of 300, 1500 and 3000 with and without
     class ids, the 64-box word and row-block edges (N of 63, 64 and 65
     both ways, topk 63, 64 and 65 at N 129) and N 8192, the cap. 6a:
     the tiny SSD of ``tests/test_image_ssd.py`` on 4 x 3 x 32 x 32 on the card and on the
     CPU (heads within 1e-5 of their max abs; the card's heads through
     the CPU's detection match the card's detections, given the
     margins). 6b: ``ssd_300(20)`` (Xavier weights from seed 0) behind
     ``MultiBoxDetection()``, frozen with buckets 1-16 and served through
     ``InferenceSession(max_batch=16, deadline_ms=5)``: 64 single-image
     requests (3 x 300 x 300, uniform in (-1, 1)) from 8 client threads,
     8 back to back each, then 8 one by one; launch counts exactly one
     nms and 14 BN apply a batch; every response (7378, 6), finite, with
     a kept row, and equal to its image run at the bucket its batch ran
     in; img/s, latency, peak memory, a profiled batch at bucket 16; the
     BN apply kernel bitwise against its plain version on the 14 inputs
     of a batch at bucket 16 (16 x 16 x 300 x 300 down to 16 x 128 x 4 x
     4); then the nms kernel bitwise against its plain version on that
     batch's inputs and on its first image, and both timed there with
     the bound, the time on 512 boxes an image, and the device times of
     its mask, scan (the ordered walk) and finish kernels apart, from a
     ``torch.profiler`` trace of wrapper calls on the served batch;
  7. the matmul probe slice. The geometry of the four variants at each
     probe shape (``matmul_geometry``), then the four bf16 tensor-core
     kernels (cur, noacc, ws, ep; all on the TMA / wgmma mainloop of
     ``csrc/matmul_sm90.cu``, whose SASS phase 1 checks) at odd shapes (M
     of 1 and 6272 + 77, N of 8 and 64, K of 8, 72 and 200, one 64-deep
     slice, N past a 256 tile, ...) into NaN-filled
     outputs: each within the float64
     bound |y - y64| <= ulp_bf16(|y64|) + K 2^-23 (|a| @ |b|), and within
     twice it of the plain version; cuBLAS (``torch.matmul``) held to the
     same bound. Then, with the launch counts zeroed, the probe's entry
     (``mxnet_tpu_torch.tools.probe_matmul_pipeline.run``) at its eight
     ResNet-50 1x1-conv shapes: the same checks, then cuBLAS, the plain
     version and the four kernels timed by its slope timer over inputs
     rotated past twice the L2, a line each with ms, GB/s, TFLOP/s and share of
     the bound (989 TFLOP/s bf16 dense, 3.35 TB/s); every variant must
     have launched.

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX; without a
CUDA card, or without the ``mxnet_tpu_torch`` package beside it, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-5                 # float32 reduction tier of the flash kernels
TIE = 1e-4                 # a top-2 logit gap below this is a tie
GRAD_REL = 1e-4            # phase 4a: gradients, relative to max abs
PEAK_BYTES_S = 3.35e12     # H100 SXM HBM3
PEAK_F32_FLOP_S = 67e12    # H100 SXM float32, CUDA cores (no tensor cores)
PEAK_TF32_FLOP_S = 495e12  # H100 SXM TF32 tensor cores, dense
PEAK_BF16_FLOP_S = 989e12  # H100 SXM bf16 tensor cores, dense

SLICE = dict(vocab=30522, units=768, hidden=3072, layers=12, heads=12,
             max_len=512)
SLOTS = 8
BUCKETS = (16, 32, 64, 128, 256)
REQUESTS = 16
NEW_TOKENS = 32
DECODE_POSITIONS = (0, 127, 128, 511, 5, 300, 64, 256)
# the paged cache (phases 2, 3p, 3s): the reference's default page size,
# and the page sizes the paged decode kernel is held to the slot one at
PAGE_SIZE = 16
PAGED_CHECK_SIZES = (8, 16, 128, 256)
# phase 3s: one 192-token prefix (12 pages) shared by 16 requests with
# suffixes of 8-64 tokens; speculative decoding with a self-draft
PREFIX_TOKENS = 192
SUFFIX_RANGE = (8, 64)
SPEC_K = 3
SPEC_ACCEPTANCE = 0.9      # tests/test_paged_decode.py's bar

# the training slice: the bench's on-chip BERT-base pretraining batch
TRAIN = dict(batch=96, seq=128, preds=20, vocab=30522, heads=12, d=64)
TRAIN_HYPER = {'learning_rate': 1e-4, 'wd': 0.01}
TRAIN_WARMUP, TRAIN_ITERS = 2, 10
SMALL_BERT = dict(vocab_size=1000, max_length=128, units=256,
                  hidden_size=1024, num_layers=2, num_heads=4, dropout=0.0)
SMALL_BATCH = dict(batch=4, seq=128, preds=8, lengths=(128, 97, 64, 1))
# AMP (phases 2, 4a-amp, 4c): the bf16 instances within one bf16 ULP of
# their plain versions beyond the float32 tier; the bf16 tensor-core flash
# forward and dk/dv within two of theirs beyond the float32 tier and the
# flips of p and ds, and within the reference's bf16 tier
# (mxnet_tpu/ops/pallas/__main__.py:88-103) of the reference function; the
# small BERT card vs CPU at tests/test_torch_amp.py's tolerances; 4c's
# first loss against 4b's at the reference's bf16 tier
# (tests/test_amp.py:152-164)
BF16_ULPS = 1.0
BF16_TC_ULPS = 2.0
BF16_OUT_TOL = 0.02
BF16_GRAD_REL = 2e-2
AMP_LOSS_RTOL = 1e-2
AMP_GRAD_REL = 2e-2
AMP_FIRST_LOSS_RTOL = 6e-2

# the epilogue kernels' checks: the stem BN of ResNet-50 at batch 128, a
# stage-4 BN, and odd sizes: 9102 and 3003 elements (whole 1024-float
# tiles of the activation kernels' stream, whole vectors past them and
# tails of 2 and 3) and 5 (below a tile, a tail of 1)
ULP = 5e-7
EPI_SHAPES = ((128, 64, 112, 112), (128, 2048, 7, 7), (2, 3, 37, 41),
              (3, 7, 11, 13), (1, 1, 1, 5))
EPI_EXACT_ACTS = ('identity', 'relu', 'leaky', 'softsign')
EPI_ULP_ACTS = ('sigmoid', 'tanh', 'softrelu')
EPI_KERNELS = ('bn_act_fwd', 'bn_act_bwd', 'act_fwd', 'act_bwd',
               'add_act_fwd')
# the BN apply at inners that are no multiple of 4, where a vector's
# elements take their own channels, (shape, axis): inner 49 (ResNet-50's
# 7 x 7 stage, below a tile and over 49 whole ones), 1 (the last axis,
# C 37: every vector spans four channels and wraps at C), 2 and 3 (two
# or three runs a vector, whole tiles and a tail), 25 and 9 (SSD's 5 x 5
# and 3 x 3 maps)
EPI_BN_CASES = (((2, 4, 7, 7), 1), ((16, 64, 7, 7), 1), ((64, 33, 3, 37), -1),
                ((5, 3, 7, 37), -1), ((2, 3, 1, 3), 1), ((40, 9, 11, 3), 2),
                ((128, 3, 25, 2), 2), ((3, 5, 7, 2), 2), ((16, 8, 5, 5), 1),
                ((16, 24, 3, 3), 1))

# the ResNet slice: the bench's on-chip ResNet-50 v1 batch and SGD
RESNET = dict(depth=50, batch=128, image=224, classes=1000)
RESNET_HYPER = {'learning_rate': 0.1, 'momentum': 0.9, 'wd': 1e-4}
RESNET_WARMUP, RESNET_ITERS = 2, 10
NARROW = dict(layers=[2, 1, 1, 1], channels=[8, 16, 32, 64, 128],
              classes=10)
NARROW_BATCH = (4, 3, 64, 64)
NARROW_HYPER = {'learning_rate': 0.001, 'momentum': 0.9, 'wd': 1e-4}
NARROW_GRAD_REL = 5e-4     # one-pass BN statistics over 16-4096 values
NARROW_NOISE_REL = 1e-5    # conv biases feeding a BN: exact gradient 0
NARROW_PARAM_TOL = 5e-5
# frozen-BN fine-tuning of the trained ResNet-50 (phase 5c)
FROZEN_HYPER = {'learning_rate': 0.01, 'momentum': 0.9, 'wd': 1e-4}
FROZEN_STEPS = 3
FROZEN_CALIBRATE = 44


def log(*args):
    print(*args, flush=True)


# -- phase 2: kernels against plain versions ---------------------------------


def attention_cases():
    """(seq, causal, lengths) cases of the prefill kernel check: causal
    with lengths < S, full non-causal, and a row set with no visible
    key (length 0)."""
    cases = []
    for s in (17, 200, 256):
        cases.append((s, True, s - 3))
        cases.append((s, False, None))
    cases.append((200, True, 0))
    return cases


DECODE_CHECK_POSITIONS = (0, 5, 64, 127, 128, 200, 255, 256, 300, 511)
# more than 8 tiles: the decode kernel's cluster of 8 CTAs walks two
# rounds, so CTA 0 holds tiles 0 and 8; positions on the tile edges
DECODE_LONG = 1152
DECODE_LONG_POSITIONS = (0, 127, 128, 255, 511, 1023, 1024, 1151)


def decode_identity(torch, kernels, q, k, v, positions, block_q):
    """The decode contract: row p of the causal forward kernel at
    ``block_q`` over ``q``, ``k``, ``v`` (1, H, S, D) against the decode
    kernel's output at position p over a slot cache of max_len S holding
    the same K/V (one slot a position). Returns ([torch.equal per
    position], max abs difference)."""
    _, heads, seq, d = q.shape
    n = len(positions)
    cache = [t[0].transpose(0, 1).reshape(1, seq, heads * d)
             .expand(n, seq, heads * d).contiguous() for t in (k, v)]
    qd = q[0][:, list(positions)].transpose(0, 1).reshape(n, heads * d)
    pos = torch.tensor(positions, dtype=torch.int32, device=q.device)
    dec = kernels.flash_decode_attention(qd.contiguous(), *cache, pos,
                                         heads).view(n, heads, d)
    out, _ = kernels.flash_attention_with_lse(q, k, v, None, True,
                                              block_q=block_q)
    rows = out[0][:, list(positions)].transpose(0, 1)
    return ([torch.equal(rows[i], dec[i]) for i in range(n)],
            (rows - dec).abs().max().item())


def paged_positions(view, page_size, base):
    """The positions a paged check covers in a view of ``view`` keys: the
    slot check's ``base`` and the page edges ps - 1, ps, 3 ps - 1 and
    3 ps, those below the view."""
    edges = (page_size - 1, page_size, 3 * page_size - 1, 3 * page_size)
    return tuple(sorted({p for p in base + edges if p < view}))


def paged_case(torch, randn, max_len, page_size, positions, units):
    """A pool holding one slot a position: the slot-layout K and V
    (``positions`` slots, view = max_pages x page_size rows, rows past
    max_len zero) scattered into pools through a shuffled page table,
    the entries wholly past a slot's position on the trash page, which
    holds large finite garbage with the unused pages. Returns (q,
    key_pool, value_pool, tables, positions, slot K, slot V): the slot K
    and V hold zeros where the pool holds garbage."""
    n = len(positions)
    max_pages = -(-max_len // page_size)
    view = max_pages * page_size
    pages = n * max_pages + 3
    dev = randn(1).device
    keys, values = randn(n, view, units), randn(n, view, units)
    keys[:, max_len:] = 0.0
    values[:, max_len:] = 0.0
    pools = [randn(pages, page_size, units) * 1e30 for _ in range(2)]
    gen = torch.Generator(device='cpu').manual_seed(page_size + max_len)
    order = torch.randperm(pages - 1, generator=gen)[:n * max_pages] + 1
    tables = order.view(n, max_pages).to(torch.int32)
    for s, p in enumerate(positions):
        tables[s, p // page_size + 1:] = 0       # the trash page
        keys[s, (p // page_size + 1) * page_size:] = 0.0
        values[s, (p // page_size + 1) * page_size:] = 0.0
    tables = tables.to(dev)
    for pool, slot in zip(pools, (keys, values)):
        used = tables.long().view(-1)
        live = used != 0
        pool[used[live]] = slot.view(n * max_pages, page_size,
                                     units)[live]
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    return randn(n, units), pools[0], pools[1], tables, pos, keys, values


def check_paged_kernel(torch, kernels, device, heads=12, d=64,
                       page_sizes=PAGED_CHECK_SIZES,
                       lengths=((512, DECODE_CHECK_POSITIONS),
                                (DECODE_LONG, DECODE_LONG_POSITIONS))):
    """The paged decode kernel against its plain version (``TOL``) and,
    bitwise, against the slot decode kernel over the same K/V, at each
    page size and view; returns the worst error against the plain
    version."""
    gen = torch.Generator(device='cpu').manual_seed(2)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(device)

    worst = 0.0
    for ps in page_sizes:
        for max_len, base in lengths:
            view = -(-max_len // ps) * ps
            checked = paged_positions(view, ps, base)
            q, kp, vp, tables, pos, keys, values = paged_case(
                torch, randn, max_len, ps, checked, heads * d)
            out = kernels.flash_paged_decode_attention(q, kp, vp, tables, pos,
                                                       heads)
            ref = kernels.flash_paged_decode_attention_reference(
                q, kp, vp, tables, pos, heads)
            slot = kernels.flash_decode_attention(q, keys, values, pos, heads)
            err = (out - ref).abs().max().item()
            equal = [torch.equal(out[i], slot[i]) for i in range(len(pos))]
            log('check flash_paged_decode_attention page_size=%d max_len=%d '
                '(view %d, %d pages) positions=%s: max_abs_err=%.3g against '
                'the plain version; bitwise the slot kernel: %s'
                % (ps, max_len, view, kp.shape[0], list(checked), err,
                   all(equal)))
            if not err <= TOL:
                raise AssertionError('flash_paged_decode_attention disagrees '
                                     'with its plain version: %g > %g'
                                     % (err, TOL))
            if not all(equal):
                raise AssertionError(
                    'flash_paged_decode_attention differs from the slot '
                    'kernel (page_size %d, max_len %d): %s'
                    % (ps, max_len, dict(zip(checked, equal))))
            worst = max(worst, err)
    return worst


def check_kernels(torch, kernels, device, heads=12, d=64, max_len=512,
                  positions=DECODE_POSITIONS):
    """Each kernel against its plain version on ``device``; returns
    {kernel name: max abs error}."""
    gen = torch.Generator(device='cpu').manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(device)

    worst = {'flash_attention_fwd': 0.0, 'flash_decode_fwd': 0.0}
    for s, causal, length in attention_cases():
        q, k, v = (randn(1, heads, s, d) for _ in range(3))
        lengths = None if length is None else torch.tensor(
            [length], dtype=torch.int32, device=device)
        ref, lse_ref = kernels.flash_attention_reference(q, k, v, lengths,
                                                         causal=causal)
        fin = ~torch.isneginf(lse_ref)
        # the block size the wrapper picks, then every one it is built for
        for bq in (None,) + kernels.FWD_BLOCK_Q:
            out, lse = kernels.flash_attention_with_lse(
                q, k, v, lengths, causal=causal, block_q=bq)
            if not torch.equal(torch.isneginf(lse),
                               torch.isneginf(lse_ref)):
                raise AssertionError('flash_attention lse: masked rows '
                                     'differ (S=%d causal=%s length=%s '
                                     'block_q=%s)' % (s, causal, length, bq))
            err = max((out - ref).abs().max().item(),
                      (lse[fin] - lse_ref[fin]).abs().max().item()
                      if fin.any() else 0.0)
            if length == 0 and out.abs().max().item() != 0.0:
                raise AssertionError('flash_attention: fully masked rows '
                                     'must be 0')
            log('check flash_attention S=%d causal=%s length=%s block_q=%s '
                'max_abs_err=%.3g' % (s, causal, length,
                                      bq or kernels.fwd_geometry(
                                          1, heads, s)[0], err))
            if not err <= TOL:
                raise AssertionError('flash_attention disagrees with its '
                                     'plain version: %g > %g' % (err, TOL))
            worst['flash_attention_fwd'] = max(worst['flash_attention_fwd'],
                                               err)
    for seq, checked in ((512, DECODE_CHECK_POSITIONS),
                         (DECODE_LONG, DECODE_LONG_POSITIONS)):
        q, k, v = (randn(1, heads, seq, d) for _ in range(3))
        for bq in kernels.FWD_BLOCK_Q:
            equal, diff = decode_identity(torch, kernels, q, k, v, checked,
                                          bq)
            log('check decode contract S=%d block_q=%d: forward row p '
                'bitwise equal to the decode step at p for p in %s: %s (max '
                'abs difference %g)' % (seq, bq, list(checked), equal, diff))
            if not all(equal):
                raise AssertionError('flash_attention row differs from the '
                                     'decode kernel (S=%d block_q=%d): %s'
                                     % (seq, bq, equal))
    units = heads * d
    for length, checked in ((max_len, positions),
                            (DECODE_LONG, DECODE_LONG_POSITIONS),
                            (0, (0, 300))):
        n = len(checked)
        keys, values = randn(n, length, units), randn(n, length, units)
        q = randn(n, units)
        pos = torch.tensor(checked, dtype=torch.int32, device=device)
        out = kernels.flash_decode_attention(q, keys, values, pos, heads)
        ref = kernels.flash_decode_attention_reference(q, keys, values, pos,
                                                       heads)
        err = (out - ref).abs().max().item()
        log('check flash_decode_attention max_len=%d positions=%s '
            'max_abs_err=%.3g' % (length, list(checked), err))
        if not err <= TOL:
            raise AssertionError('flash_decode_attention disagrees with its '
                                 'plain version: %g > %g' % (err, TOL))
        worst['flash_decode_fwd'] = max(worst['flash_decode_fwd'], err)
    return worst


def training_attention_cases(batch=TRAIN['batch'], seq=TRAIN['seq']):
    """(batch, seq, causal, lengths) cases of the backward kernels'
    check: the training shape, non-causal, with lengths below S in some
    rows; a causal case; a row set with no visible key; S 17 and 200."""
    lengths = [max(1, seq - (i % 5) * 23) for i in range(batch)]
    return [(batch, seq, False, lengths), (2, seq, True, [seq, seq - 28]),
            (2, 17, False, [17, 9]), (2, 200, True, [0, 180])]


def _errs(a, b):
    """(max abs error, max abs error relative to ``b``'s max abs)."""
    err = (a - b).abs().max().item()
    return err, err / max(b.abs().max().item(), 1e-30)


# the xent forward's cases: the MLM and NSP heads, ResNet's, an odd V
# (rows starting at every offset mod 16 bytes), V taking clusters of 4
# and of 8 CTAs (chunks above 16384 floats) and one past what a cluster
# holds; each of the forward's instances in one of them
XENT_SHAPES = ((1920, 30522), (96, 2), (128, 1000), (8, 30523), (16, 50000),
               (4, 200003), (4, 600001))


# the xent backward's own cases (rows, V), each with g per row and g a
# scalar: vectors crossing rows (more than once at V 1-3), n % 4 each of
# 0-3 (odd V at 4-7 rows), n below one tile (5 x 4), one whole tile (512 x
# 2) and whole tiles (128 x 1000, ResNet's head), the MLM's V and an odd
# V; rows 0-7 label columns 0, V - 1, -1 and V in turn (XENT_BWD_LABELS),
# the rest at random
XENT_BWD_CASES = ((4, 1), (5, 1), (6, 1), (7, 1), (2, 2), (3, 2), (512, 2),
                  (4, 3), (5, 3), (6, 3), (7, 3), (4, 5), (5, 5), (6, 5),
                  (7, 5), (128, 1000), (3, 1000), (2, 30522), (3, 30522),
                  (4, 30523), (5, 30523), (6, 30523), (7, 30523))
XENT_BWD_LABELS = (lambda v: 0, lambda v: v - 1, lambda v: -1, lambda v: v)
XENT_BWD_G = 0.37          # the scalar cotangent


def xent_bwd_inputs(torch, kernels, rows, v, gen, device):
    """``logp`` (the plain forward's, of logits randn * 3) and labels of a
    backward case: rows 0-7 take ``XENT_BWD_LABELS`` in turn, the rest a
    label in [0, V) from ``gen``."""
    x = (torch.randn(rows, v, generator=gen) * 3).to(device)
    lab = torch.randint(0, v, (rows,), generator=gen, dtype=torch.int32)
    for r in range(min(rows, 8)):
        lab[r] = XENT_BWD_LABELS[r % 4](v)
    lab = lab.to(device)
    return kernels.softmax_xent_forward_reference(x, lab)[1], lab


def xent_bwd_paths(cases, labels):
    """What the backward's stream meets over ``cases`` with the labels
    ``labels`` (a list of int lists, one a case): n % 4, whether n is
    below one tile or whole tiles, the lanes of the one-hot elements in
    their vectors, and whether a one-hot element lies in a vector that
    crosses rows."""
    tile = 1024
    paths = dict(n_mod_4=set(), below_tile=False, whole_tiles=False,
                 onehot_lanes=set(), onehot_crossing=False)
    for (rows, v), labs in zip(cases, labels):
        n = rows * v
        paths['n_mod_4'].add(n % 4)
        paths['below_tile'] |= n < tile
        paths['whole_tiles'] |= n % tile == 0
        for r, lab in enumerate(labs):
            if 0 <= lab < v:
                i = r * v + lab
                first = i - i % 4
                paths['onehot_lanes'].add(i % 4)
                paths['onehot_crossing'] |= (
                    first + 3 < n - n % 4 and first // v != (first + 3) // v)
    return paths


def check_xent_backward(torch, kernels, device, cases=XENT_BWD_CASES):
    """The xent backward kernel alone against its plain version on each
    of ``cases``, with g per row and g a scalar: within TOL relative to
    the plain result's max abs, finite; prints each case's max abs
    difference and whether it is bitwise equal. On the card the cases
    must reach every path of the stream (``xent_bwd_paths``). Returns
    the worst max abs error."""
    gen = torch.Generator(device='cpu').manual_seed(4)
    worst, labels = 0.0, []
    for rows, v in cases:
        logp, lab = xent_bwd_inputs(torch, kernels, rows, v, gen, device)
        labels.append(lab.tolist())
        for kind, g in (('row', torch.rand(rows, generator=gen).to(device)),
                        ('scalar', XENT_BWD_G)):
            dx = kernels.softmax_xent_backward(logp, lab, g)
            want = kernels.softmax_xent_backward_reference(logp, lab, g)
            err, rel = _errs(dx, want)
            log('check softmax_xent_bwd rows=%d V=%d n=%d (n %% 4 = %d, %d '
                'tiles) g %s: max_abs_err=%.3g rel_err=%.3g bitwise %s'
                % (rows, v, rows * v, rows * v % 4, rows * v // 1024, kind,
                   err, rel, bool(torch.equal(dx, want))))
            if not bool(torch.isfinite(dx).all()) or not rel <= TOL:
                raise AssertionError('softmax_xent_bwd disagrees with its '
                                     'plain version at rows %d V %d, g %s'
                                     % (rows, v, kind))
            worst = max(worst, err)
    paths = xent_bwd_paths(cases, labels)
    log('check softmax_xent_bwd paths: %s' % {k: sorted(p) if isinstance(
        p, set) else p for k, p in paths.items()})
    if device.type == 'cuda' and not (
            paths['n_mod_4'] == {0, 1, 2, 3} and paths['below_tile']
            and paths['whole_tiles'] and {0, 3} <= paths['onehot_lanes']
            and paths['onehot_crossing']):
        raise AssertionError('softmax_xent_bwd cases miss a path of the '
                             'stream: %s' % paths)
    return worst


# the backward past 2**31 - 1 elements, launched in chunks of whole rows:
# 70356 rows a chunk at V 30523 (a multiple of 4: each chunk starts on a
# row), and rows of 2**30 + 1 elements, one a chunk, each chunk after the
# first starting 1 or 2 elements into the row before (``lead``)
XENT_BWD_CHUNKED = ((70360, 30523), (3, 2 ** 30 + 1))


def check_xent_backward_chunks(torch, kernels, device,
                               cases=XENT_BWD_CHUNKED):
    """The xent backward on tensors of more than 2**31 - 1 elements (up
    to 13 GB each for logp and dx), launched in the chunks of
    ``xent_bwd_geometry``, labels at column 0 and V - 1 in the rows where
    chunks meet; held to the plain version slice by slice of rows, within
    TOL relative to each slice's max abs. Returns the worst max abs
    error."""
    gen = torch.Generator(device=device).manual_seed(5)
    worst = 0.0
    for rows, v in cases:
        chunks, _ = kernels.xent_bwd_geometry(rows, v)
        logp = torch.rand(rows, v, generator=gen, device=device).mul_(-12)
        lab = torch.randint(0, v, (rows,), generator=gen, device=device,
                            dtype=torch.int32)
        for c in chunks[1:]:
            lab[c.row] = v - 1
            lab[c.row + 1] = 0
        g = torch.rand(rows, generator=gen, device=device)
        dx = kernels.softmax_xent_backward(logp, lab, g)
        step = max(1, 2 ** 28 // v)
        err = rel = 0.0
        for r0 in range(0, rows, step):
            part = slice(r0, r0 + step)
            e, r = _errs(dx[part], kernels.softmax_xent_backward_reference(
                logp[part], lab[part], g[part]))
            err, rel = max(err, e), max(rel, r)
        log('check softmax_xent_bwd chunked rows=%d V=%d n=%d: %d launches '
            '(starts %s, leads %s): max_abs_err=%.3g rel_err=%.3g'
            % (rows, v, rows * v, len(chunks), [c.start for c in chunks],
               [c.lead for c in chunks], err, rel))
        if not rel <= TOL:
            raise AssertionError('softmax_xent_bwd disagrees with its plain '
                                 'version in chunks at rows %d V %d'
                                 % (rows, v))
        worst = max(worst, err)
        del logp, dx
        if device.type == 'cuda':
            torch.cuda.empty_cache()
    return worst


def check_training_kernels(torch, kernels, device, heads=TRAIN['heads'],
                           d=TRAIN['d'], cases=None,
                           xent_shapes=XENT_SHAPES,
                           xent_bwd_cases=XENT_BWD_CASES):
    """The training slice's kernels against their plain versions on
    ``device``: flash forward, dq and dkv on each attention case, the
    softmax-xent forward and backward on each (rows, V) with up to 3
    labels out of range. The forward outputs are held to TOL absolute,
    the gradients to TOL relative to their max abs. On the card the xent
    cases must launch every instance of the forward and rows both on and
    off a 16-byte boundary. Then the backward alone on
    ``xent_bwd_cases`` (:func:`check_xent_backward`). Returns {kernel
    name: worst max abs error}."""
    gen = torch.Generator(device='cpu').manual_seed(2)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(device)

    worst = dict.fromkeys(('flash_attention_fwd', 'flash_attention_dq',
                           'flash_attention_dkv', 'softmax_xent_fwd',
                           'softmax_xent_bwd'), 0.0)
    for b, s, causal, lengths in cases or training_attention_cases():
        q, k, v, do = (randn(b, heads, s, d) for _ in range(4))
        lens = torch.tensor(lengths, dtype=torch.int32, device=device)
        out, lse = kernels.flash_attention_with_lse(q, k, v, lens, causal)
        ref, lse_ref = kernels.flash_attention_reference(q, k, v, lens,
                                                         causal)
        if not torch.equal(torch.isneginf(lse), torch.isneginf(lse_ref)):
            raise AssertionError('flash_attention lse: masked rows differ')
        fin = ~torch.isneginf(lse_ref)
        fwd = max((out - ref).abs().max().item(),
                  (lse[fin] - lse_ref[fin]).abs().max().item())
        dq = kernels.flash_attention_dq(q, k, v, out, lse, do, lens, causal)
        dk, dv = kernels.flash_attention_dkv(q, k, v, out, lse, do, lens,
                                             causal)
        want = kernels.flash_attention_backward_reference(
            q, k, v, out, lse, do, lens, causal)
        errs = [_errs(a, w) for a, w in zip((dq, dk, dv), want)]
        rel = [r for _, r in errs]
        for name, t in (('dq', dq), ('dk', dk), ('dv', dv)):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError('flash_attention %s is not finite' % name)
        dead = lens == 0
        if dead.any() and any(t[dead].abs().max().item() != 0.0
                              for t in (dq, dk, dv)):
            raise AssertionError('flash_attention: a length-0 row set must '
                                 'give dq = dk = dv = 0')
        log('check flash backward B=%d H=%d S=%d causal=%s lengths %d..%d: '
            'fwd max_abs_err=%.3g, dq/dk/dv rel_err=%.3g/%.3g/%.3g '
            '(max_abs_err %.3g/%.3g/%.3g)'
            % (b, heads, s, causal, min(lengths), max(lengths), fwd, *rel,
               *(e for e, _ in errs)))
        if not fwd <= TOL or not max(rel) <= TOL:
            raise AssertionError('flash backward kernels disagree with '
                                 'their plain versions')
        worst['flash_attention_fwd'] = max(worst['flash_attention_fwd'], fwd)
        worst['flash_attention_dq'] = max(worst['flash_attention_dq'],
                                          errs[0][0])
        worst['flash_attention_dkv'] = max(worst['flash_attention_dkv'],
                                           errs[1][0], errs[2][0])
    kernels.reset_launch_counts()
    offsets = set()     # row starts mod 16 bytes
    for rows, vocab in xent_shapes:
        x = randn(rows, vocab) * 3
        lab = torch.randint(0, vocab, (rows,), generator=gen,
                            dtype=torch.int32).to(device)
        out = min(3, rows - 1)
        lab[:out] = torch.tensor([-1, vocab, vocab + 7][:out],
                                 dtype=torch.int32)
        g = torch.rand(rows, generator=gen).to(device)
        nll, logp = kernels.softmax_xent_forward(x, lab)
        nll_ref, logp_ref = kernels.softmax_xent_forward_reference(x, lab)
        fwd = max((nll - nll_ref).abs().max().item(),
                  (logp - logp_ref).abs().max().item())
        if out and nll[:out].abs().max().item() != 0.0:
            raise AssertionError('softmax_xent: an out-of-range label must '
                                 'give nll 0')
        dx = kernels.softmax_xent_backward(logp, lab, g)
        bwd, bwd_rel = _errs(dx, kernels.softmax_xent_backward_reference(
            logp, lab, g))
        offsets.update(r * vocab * 4 % 16 for r in range(rows))
        log('check softmax_xent rows=%d V=%d %s (%d labels out of range): '
            'nll/logp max_abs_err=%.3g, dlogits rel_err=%.3g (max_abs_err '
            '%.3g)' % (rows, vocab, tuple(kernels.xent_geometry(rows, vocab)),
                       out, fwd, bwd_rel, bwd))
        if not fwd <= TOL or not bwd_rel <= TOL:
            raise AssertionError('softmax_xent kernels disagree with their '
                                 'plain versions')
        worst['softmax_xent_fwd'] = max(worst['softmax_xent_fwd'], fwd)
        worst['softmax_xent_bwd'] = max(worst['softmax_xent_bwd'], bwd)
    if device.type == 'cuda':
        launched = {i for (name, i), n in kernels.instance_launches().items()
                    if name == 'softmax_xent_fwd' and n}
        log('check softmax_xent: forward instances launched %s, row starts '
            'mod 16 bytes %s' % (sorted(launched), sorted(offsets)))
        if launched != set(kernels.XENT_INSTANCES) or len(offsets) < 2:
            raise AssertionError('softmax_xent cases launched the instances '
                                 '%s of %s, row offsets %s'
                                 % (launched, kernels.XENT_INSTANCES,
                                    offsets))
    worst['softmax_xent_bwd'] = max(
        worst['softmax_xent_bwd'],
        check_xent_backward(torch, kernels, device, xent_bwd_cases))
    return worst


def time_ms(torch, fn, iters=30, warmup=5):
    """Median milliseconds of ``fn()`` by CUDA events, one event pair per
    call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, inputs):
    """Device milliseconds of one ``fn(*inputs)``, the host's cost left
    out: the probe's slope of n and 4n calls back to back, the host given
    a head start (``probe_matmul_pipeline.slope_ms``). The calls rotate
    over clones of the tensors ``inputs`` that together exceed twice the
    L2, so each call reads its inputs from memory, as the bound counts
    them (``inputs`` empty: the call reads what it holds)."""
    from mxnet_tpu_torch.tools.probe_matmul_pipeline import (cold_copies,
                                                              slope_ms)
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    copies = [inputs] + [tuple(t.clone() for t in inputs)
                         for _ in range(cold_copies(nbytes) - 1 if nbytes
                                        else 0)]
    return slope_ms(torch, lambda i: fn(*copies[i % len(copies)]))


def timings(torch, inputs, kernel, plain, library=None, library_inputs=None,
            plain_iters=30, plain_warmup=5, **row):
    """A row of the kernels table: ``kernel``, ``plain`` and ``library``
    (a callable or None) called on the tensors ``inputs`` (the library on
    ``library_inputs`` where given), timed one event pair a call on the
    same inputs (ms, plain_ms, library_ms), and the kernel and the library
    call back to back on inputs rotated past the L2 (device_ms,
    library_device_ms, :func:`device_ms`); ``row`` adds bound and
    shape."""
    lib_in = inputs if library_inputs is None else library_inputs
    row.update(
        ms=time_ms(torch, lambda: kernel(*inputs)),
        device_ms=device_ms(torch, kernel, inputs),
        plain_ms=time_ms(torch, lambda: plain(*inputs), iters=plain_iters,
                         warmup=plain_warmup),
        library_ms=(None if library is None
                    else time_ms(torch, lambda: library(*lib_in))),
        library_device_ms=(None if library is None
                           else device_ms(torch, library, lib_in)))
    return row


def bound(nbytes, flops, peak=PEAK_F32_FLOP_S):
    """(the least ms the card could take, 'bytes' or 'operations'):
    ``nbytes`` at 3.35 TB/s against ``flops`` at ``peak`` (67 TFLOP/s,
    float32 on the CUDA cores, unless the kernel runs other arithmetic;
    the bf16 matmuls' bound is the probe's ``bound_ms``)."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def time_kernels(torch, kernels, heads=12, d=64, seq=256, length=200):
    """Times of each kernel, its plain version and the library call at
    the main path's shapes: the prefill at the top bucket (a 200-token
    prompt in the 256 bucket), the decode step at 8 slots x 512."""
    F = torch.nn.functional
    dev = torch.device('cuda')
    gen = torch.Generator(device='cpu').manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    rows = {}
    q, k, v = (randn(1, heads, seq, d) for _ in range(3))
    lengths = torch.tensor([length], dtype=torch.int32, device=dev)
    ar = torch.arange(seq, device=dev)
    mask = (ar[None, :] <= ar[:, None]) & (ar[None, :] < length)
    visible = int(mask.sum().item())
    nbytes = 4 * q.numel() * 4 + heads * seq * 4 + 4
    flops = visible * heads * 4 * d
    b_ms, b_by = bound(nbytes, flops)
    rows['flash_attention_fwd'] = timings(
        torch, (q, k, v, lengths),
        lambda q, k, v, lengths: kernels.flash_attention(q, k, v, lengths,
                                                         causal=True),
        lambda q, k, v, lengths: kernels.flash_attention_reference(
            q, k, v, lengths, causal=True),
        lambda q, k, v, lengths: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask),
        bound_ms=b_ms, bound_by=b_by,
        shape='B1 H%d S%d D%d causal length %d, block_q %d, %d blocks'
        % ((heads, seq, d, length)
           + kernels.fwd_geometry(1, heads, seq)[:2]))

    units = heads * d
    keys, values = randn(SLOTS, 512, units), randn(SLOTS, 512, units)
    qd = randn(SLOTS, units)
    pos = torch.tensor(DECODE_POSITIONS, dtype=torch.int32, device=dev)
    live = sum(p + 1 for p in DECODE_POSITIONS)
    nbytes = 2 * live * units * 4 + 2 * qd.numel() * 4 + SLOTS * 4
    flops = live * units * 4
    b_ms, b_by = bound(nbytes, flops)
    kh = keys.view(SLOTS, 512, heads, d).transpose(1, 2)
    vh = values.view(SLOTS, 512, heads, d).transpose(1, 2)
    qh = qd.view(SLOTS, heads, 1, d)
    dmask = (torch.arange(512, device=dev)[None, :]
             <= pos.long()[:, None])[:, None, None, :]
    rows['flash_decode_fwd'] = timings(
        torch, (qd, keys, values, pos),
        lambda qd, keys, values, pos: kernels.flash_decode_attention(
            qd, keys, values, pos, heads),
        lambda qd, keys, values, pos: (
            kernels.flash_decode_attention_reference(qd, keys, values, pos,
                                                     heads)),
        F.scaled_dot_product_attention, library_inputs=(qh, kh, vh, dmask),
        bound_ms=b_ms, bound_by=b_by,
        shape='slots %d max_len 512 U %d heads %d positions %s'
        % (SLOTS, units, heads, list(DECODE_POSITIONS)))
    rows['flash_decode_fwd']['device_ms_at_pos'] = decode_at_positions(
        torch, kernels, qd, keys, values, pos, heads)
    return rows


def phase3_waves(seed=0, offset=16):
    """Phase 3's decode positions: its 16 prompt lengths (drawn as
    :func:`serve` draws them) in two waves of eight slots, ``offset``
    tokens into their new ones."""
    import numpy as np
    lens = np.random.RandomState(seed).randint(8, 257, size=REQUESTS)
    return [tuple(int(n) + offset for n in lens[w:w + SLOTS])
            for w in range(0, REQUESTS, SLOTS)]


def paged_bound(positions, units, slots, max_pages):
    """(bound ms, by) of one paged decode call: each visible K and V row
    read once, the page tables, q, positions and out once."""
    live = sum(p + 1 for p in positions)
    nbytes = (2 * live * units + slots * max_pages + 2 * slots * units
              + slots) * 4
    return bound(nbytes, live * units * 4)


def time_paged_decode(torch, kernels, heads=12, d=64, max_len=512,
                      page_size=PAGE_SIZE):
    """Times of the paged decode kernel at phase 2's decode case (8
    slots, max_len 512, ``DECODE_POSITIONS``, page size 16) and at phase
    3's positions (:func:`phase3_waves`), each beside the slot kernel
    over the same K/V, the reference's structure (the page-table gather,
    then the slot kernel) and SDPA over the gathered view."""
    F = torch.nn.functional
    dev = torch.device('cuda')
    gen = torch.Generator(device='cpu').manual_seed(3)
    units = heads * d

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def paged(q, kp, vp, tables, pos):
        return kernels.flash_paged_decode_attention(q, kp, vp, tables, pos,
                                                    heads)

    def gather_slot(q, kp, vp, tables, pos):
        n = q.shape[0]
        return kernels.flash_decode_attention(
            q, kp[tables.long()].view(n, -1, units),
            vp[tables.long()].view(n, -1, units), pos, heads)

    def sdpa_inputs(q, keys, values, pos):
        n, view = keys.shape[:2]
        mask = (torch.arange(view, device=dev)[None, :]
                <= pos.long()[:, None])[:, None, None, :]
        return (q.view(n, heads, 1, d),
                keys.view(n, view, heads, d).transpose(1, 2),
                values.view(n, view, heads, d).transpose(1, 2), mask)

    def case(positions):
        q, kp, vp, tables, pos, keys, values = paged_case(
            torch, randn, max_len, page_size, positions, units)
        gk = kp[tables.long()].view(len(positions), -1, units)
        gv = vp[tables.long()].view(len(positions), -1, units)
        return (q, kp, vp, tables, pos), (q, keys, values, pos), \
            sdpa_inputs(q, gk, gv, pos)

    inputs, slot_in, lib_in = case(DECODE_POSITIONS)
    b_ms, b_by = paged_bound(DECODE_POSITIONS, units, SLOTS,
                             inputs[3].shape[1])
    row = timings(
        torch, inputs, paged,
        lambda *a: kernels.flash_paged_decode_attention_reference(*a, heads),
        F.scaled_dot_product_attention, library_inputs=lib_in,
        bound_ms=b_ms, bound_by=b_by,
        shape='slots %d max_len 512 page_size %d (%d pages) U %d heads %d '
        'positions %s; library: SDPA over the gathered view'
        % (SLOTS, page_size, inputs[1].shape[0], units, heads,
           list(DECODE_POSITIONS)))
    row['slot_device_ms'] = device_ms(
        torch, lambda *a: kernels.flash_decode_attention(*a, heads), slot_in)
    row['gather_slot_device_ms'] = device_ms(torch, gather_slot, inputs)
    row['at_phase3'] = []
    for wave in phase3_waves():
        inputs, slot_in, lib_in = case(wave)
        row['at_phase3'].append(dict(
            positions=list(wave), device_ms=device_ms(torch, paged, inputs),
            slot_device_ms=device_ms(
                torch, lambda *a: kernels.flash_decode_attention(*a, heads),
                slot_in),
            gather_slot_device_ms=device_ms(torch, gather_slot, inputs),
            library_device_ms=device_ms(torch, F.scaled_dot_product_attention,
                                        lib_in),
            bound_ms=paged_bound(wave, units, SLOTS, inputs[3].shape[1])[0]))
    return {'flash_paged_decode_fwd': row}


def decode_at_positions(torch, kernels, qd, keys, values, pos, heads):
    """Device ms of the decode kernel with every slot on one position
    (127: one tile a (slot, head) and no chain; 511: four tiles and a
    chain of four), each beside its bytes bound, so that the chain's
    share shows."""
    slots, units = qd.shape
    at_pos = {}
    for p in (127, 511):
        same = torch.full_like(pos, p)
        nbytes = 2 * slots * (p + 1) * units * 4 + 2 * qd.numel() * 4
        at_pos[p] = dict(
            device_ms=device_ms(torch, lambda *a: (
                kernels.flash_decode_attention(*a, heads)),
                (qd, keys, values, same)),
            bound_ms=bound(nbytes, slots * (p + 1) * units * 4)[0])
    return at_pos


def time_training_kernels(torch, kernels, batch=TRAIN['batch'],
                          heads=TRAIN['heads'], seq=TRAIN['seq'],
                          d=TRAIN['d'], vocab=TRAIN['vocab']):
    """Times of the training slice's kernels, their plain versions and
    the library calls at the shapes of phase 4b: attention over B x H =
    96 x 12, S 128, D 64, non-causal, every length 128 (the flash
    forward as ``flash_attention_fwd`` at the training shape); the xent
    head at the MLM shape, 1920 x 30522, with in-range labels (the
    library's cross entropy refuses others)."""
    F = torch.nn.functional
    dev = torch.device('cuda')
    gen = torch.Generator(device='cpu').manual_seed(3)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    rows = {}
    q, k, v, do = (randn(batch, heads, seq, d) for _ in range(4))
    lens = torch.full((batch,), seq, dtype=torch.int32, device=dev)
    out, lse = kernels.flash_attention_with_lse(q, k, v, lens)
    shape = 'B%d H%d S%d D%d non-causal lengths %d' % (batch, heads, seq, d,
                                                       seq)
    visible = batch * heads * seq * seq     # (query, key) pairs
    tensor_b = q.numel() * 4
    lse_b, lens_b = lse.numel() * 4, batch * 4
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs)

    def sdpa_bwd():
        # reads the graph's saved q, k, v and output: 151 MB, past the L2
        return torch.autograd.grad(sdpa_out, (qs, ks, vs), do,
                                   retain_graph=True)

    b_ms, b_by = bound(4 * tensor_b + lse_b + lens_b, visible * 4 * d)
    rows['flash_attention_fwd'] = timings(
        torch, (q, k, v, lens), kernels.flash_attention_with_lse,
        kernels.flash_attention_reference,
        lambda q, k, v, lens: F.scaled_dot_product_attention(q, k, v),
        bound_ms=b_ms, bound_by=b_by,
        shape=shape + ', block_q %d, %d blocks'
        % kernels.fwd_geometry(batch, heads, seq)[:2])
    # dq's three products run on the tensor cores in 3xTF32: three TF32
    # products each; the float32 CUDA-core bound of earlier runs beside it
    b_ms, b_by = bound(6 * tensor_b + lse_b + lens_b, 3 * visible * 6 * d,
                       PEAK_TF32_FLOP_S)
    rows['flash_attention_dq'] = timings(
        torch, (q, k, v, out, lse, do, lens), kernels.flash_attention_dq,
        kernels.flash_attention_dq_reference, sdpa_bwd, library_inputs=(),
        bound_ms=b_ms, bound_by=b_by,
        bound_cuda_core_ms=bound(6 * tensor_b + lse_b + lens_b,
                                 visible * 6 * d)[0],
        shape=shape + '; bound: 3xTF32 at 495 TFLOP/s; library: SDPA '
        'backward (dq, dk and dv together)')
    # dkv's four products likewise
    b_ms, b_by = bound(7 * tensor_b + lse_b + lens_b, 3 * visible * 8 * d,
                       PEAK_TF32_FLOP_S)
    rows['flash_attention_dkv'] = timings(
        torch, (q, k, v, out, lse, do, lens), kernels.flash_attention_dkv,
        kernels.flash_attention_dkv_reference, sdpa_bwd, library_inputs=(),
        bound_ms=b_ms, bound_by=b_by,
        bound_cuda_core_ms=bound(7 * tensor_b + lse_b + lens_b,
                                 visible * 8 * d)[0],
        shape=shape + '; bound: 3xTF32 at 495 TFLOP/s; library: SDPA '
        'backward (dq, dk and dv together)')
    # dq + dkv as a step runs them against SDPA's backward, in turns
    # (pair, SDPA, SDPA, pair, pair, SDPA): the spread of the comparison
    # within this run
    ins = (q, k, v, out, lse, do, lens)

    def pair(*t):
        return kernels.flash_attention_dq(*t), kernels.flash_attention_dkv(*t)

    turns = {'dq+dkv': [], 'sdpa_backward': []}
    for name in ('dq+dkv', 'sdpa_backward', 'sdpa_backward', 'dq+dkv',
                 'dq+dkv', 'sdpa_backward'):
        turns[name].append(device_ms(torch, pair, ins) if name == 'dq+dkv'
                           else device_ms(torch, sdpa_bwd, ()))
    rows['flash_attention_dq']['pair_turns_device_ms'] = turns
    del q, k, v, do, out, lse, qs, ks, vs, sdpa_out, ins

    n = batch * TRAIN['preds']
    x = randn(n, vocab) * 3
    lab = torch.randint(0, vocab, (n,), generator=gen,
                        dtype=torch.int32).to(dev)
    lab64 = lab.long()
    nll, logp = kernels.softmax_xent_forward(x, lab)
    # the mean's cotangent, as autograd hands it to the backward
    g = torch.full((n,), 1.0 / n, device=dev)
    shape = 'rows %d V %d' % (n, vocab)
    # per element: the max, the shift, exp, the sum and the log-prob
    b_ms, b_by = bound(2 * x.numel() * 4 + 3 * n * 4, 5 * x.numel())
    rows['softmax_xent_fwd'] = timings(
        torch, (x, lab), kernels.softmax_xent_forward,
        kernels.softmax_xent_forward_reference,
        lambda x, lab: F.cross_entropy(x, lab, reduction='none'),
        library_inputs=(x, lab64), bound_ms=b_ms, bound_by=b_by,
        shape=shape + ', %s; library: cross_entropy(reduction=none), '
        'nll_loss(log_softmax(x)): it writes the logp too, into a temporary'
        % (kernels.xent_geometry(n, vocab),))
    # the one call that writes the same logp
    row = rows['softmax_xent_fwd']
    row['log_softmax_ms'] = time_ms(
        torch, lambda: F.log_softmax(x, dim=-1))
    row['log_softmax_device_ms'] = device_ms(
        torch, lambda x: F.log_softmax(x, dim=-1), (x,))
    xs = x.detach().clone().requires_grad_(True)
    ce = F.cross_entropy(xs, lab64, reduction='sum') / n

    def ce_bwd():
        # reads the graph's saved log-probabilities: 234 MB, past the L2
        return torch.autograd.grad(ce, xs, retain_graph=True)

    # per element: exp, the one-hot subtract and the scale by g
    b_ms, b_by = bound(2 * x.numel() * 4 + 2 * n * 4, 3 * x.numel())
    rows['softmax_xent_bwd'] = timings(
        torch, (logp, lab, g), kernels.softmax_xent_backward,
        kernels.softmax_xent_backward_reference, ce_bwd, library_inputs=(),
        bound_ms=b_ms, bound_by=b_by,
        shape=shape + '; library: backward alone of cross_entropy'
        '(reduction=sum)')
    row = rows['softmax_xent_bwd']
    row['bound_share'] = row['bound_ms'] / row['device_ms']
    return rows


# -- phase 2: the bf16 instances (AMP) -----------------------------------------

BF16_KERNELS = ('flash_attention_fwd.bf16', 'flash_attention_dq.bf16',
                'flash_attention_dkv.bf16', 'act_fwd.bf16', 'act_bwd.bf16')


def bf16_ulps(torch, got, want, tier=0.0):
    """Largest |got - want| - ``tier`` over elements (0 where negative),
    in bf16 ULPs of the larger magnitude of the two (2^(e - 7) for a value
    in [2^e, 2^(e + 1))). ``tier`` is the float32 kernels' tolerance: two
    float32 sums in other orders move an element near 0 by up to it,
    many of that element's bf16 ULPs (a number, or a tensor of
    per-element tolerances such as the flip slack of the bf16 tensor-core
    kernels' plain versions)."""
    from mxnet_tpu_torch.ops.kernels.attention import bf16_ulp
    g, w = got.float(), want.float()
    ulp = bf16_ulp(torch.maximum(g.abs(), w.abs()))
    return (torch.clamp((g - w).abs() - tier, min=0) / ulp).max().item()


def _bitwise_rounded(torch, got, f32):
    """``got`` (bf16) equal to the float32 result ``f32`` rounded to bf16
    (to nearest even)."""
    return torch.equal(got, f32.to(torch.bfloat16))


# the bf16 kernels' odd cases beyond training_attention_cases(): a row
# set with no visible key at S 200, S 17 with lengths down to 1, and Sq !=
# Sk both ways, (batch, Sq, Sk, causal, lengths)
BF16_ODD_CASES = ((2, 200, 200, True, [200, 0]), (3, 17, 17, False, [17, 9, 1]),
                  (2, 100, 300, False, [300, 250]), (2, 300, 100, True,
                                                     [100, 37]))


def check_bf16_kernels(torch, kernels, device, heads=TRAIN['heads'],
                       d=TRAIN['d'], cases=None, epi_shapes=EPI_SHAPES):
    """The bf16 kernels (AMP) on ``device``: the flash forward, dq and
    dk/dv on each attention case (``cases``: (batch, Sq, Sk, causal,
    lengths); default every case of :func:`training_attention_cases` and
    :data:`BF16_ODD_CASES`), the act forward and backward for every act
    type at each epilogue shape.

    The forward, dq and dk/dv run on the bf16 tensor cores and round p
    (and ds) to bf16 before their products, another function than the
    float32 kernels': each is held to its own plain version
    (``flash_attention_bf16_reference``,
    ``flash_attention_dq_bf16_reference``,
    ``flash_attention_dkv_bf16_reference``) within :data:`BF16_TC_ULPS`
    bf16 ULPs beyond the float32 tier (TOL absolute for out, TOL of the
    max abs for dq, dk and dv) and the plain version's ``slack`` (what a
    bf16 flip of a p or ds near a rounding midpoint can move: the card's
    sums and exp2 differ from torch's in the last float32 bits), and to
    the reference function (``flash_attention_reference``,
    ``flash_attention_dq_reference``, ``flash_attention_dkv_reference``)
    within the reference's bf16 tier (:data:`BF16_OUT_TOL` absolute,
    :data:`BF16_GRAD_REL` of the max abs); the forward's lse within TOL of
    the float32 kernel's on the widened inputs. The act kernels are
    bitwise their float32 kernels on the widened inputs, rounded, and
    within :data:`BF16_ULPS` of their plain versions beyond the float32
    tier (0). Returns {kernel name: worst max abs error against its plain
    version}."""
    bf = torch.bfloat16
    gen = torch.Generator(device='cpu').manual_seed(6)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(device)

    worst = dict.fromkeys(BF16_KERNELS, 0.0)

    def hold(name, bitwise, ulps, err, where):
        if not bitwise or not ulps <= BF16_ULPS:
            raise AssertionError('%s at %s: bitwise the float32 kernel %s, %.3g '
                                 'bf16 ULPs from its plain version'
                                 % (name, where, bitwise, ulps))
        worst[name] = max(worst[name], err)

    def hold_tc(name, ulps, ref_err, limit, err, where):
        if not (ulps <= BF16_TC_ULPS and ref_err <= limit):
            raise AssertionError('%s at %s: %.3g bf16 ULPs from its plain '
                                 'version beyond the tier and flips (limit '
                                 '%g), %.3g from the reference function '
                                 '(limit %g)' % (name, where, ulps,
                                                 BF16_TC_ULPS, ref_err,
                                                 limit))
        worst[name] = max(worst[name], err)

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    all_cases = cases or (
        [(b, s, s, c, lens) for b, s, c, lens in training_attention_cases()]
        + list(BF16_ODD_CASES))
    for b, sq, sk, causal, lengths in all_cases:
        q, do = (randn(b, heads, sq, d).to(bf) for _ in range(2))
        k, v = (randn(b, heads, sk, d).to(bf) for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32, device=device)
        w = [t.float() for t in (q, k, v, do)]
        where = 'B=%d Sq=%d Sk=%d causal=%s lengths %d..%d' % (
            b, sq, sk, causal, min(lengths), max(lengths))
        out, lse = kernels.flash_attention_with_lse(q, k, v, lens, causal)
        _, lse32 = kernels.flash_attention_with_lse(*w[:3], lens, causal)
        plain, _, flips = kernels.flash_attention_bf16_reference(
            q, k, v, lens, causal, slack=True)
        ref, _ = kernels.flash_attention_reference(q, k, v, lens, causal)
        fin = ~torch.isneginf(lse32)
        lse_err = (lse[fin] - lse32[fin]).abs().max().item() if fin.any() \
            else 0.0
        if not (torch.equal(torch.isneginf(lse), ~fin) and lse_err <= TOL):
            raise AssertionError('flash_attention_fwd.bf16 at %s: lse %.3g '
                                 'from the float32 kernel\'s (limit %g) or '
                                 'its -inf rows differ' % (where, lse_err,
                                                           TOL))
        fwd_ulps = bf16_ulps(torch, out, plain, TOL + flips)
        fwd_ref = err(out, ref)
        hold_tc('flash_attention_fwd.bf16', fwd_ulps, fwd_ref, BF16_OUT_TOL,
                err(out, plain), where)
        dq = kernels.flash_attention_dq(q, k, v, out, lse, do, lens, causal)
        dk, dv = kernels.flash_attention_dkv(q, k, v, out, lse, do, lens,
                                             causal)
        dq_plain, dq_flips = kernels.flash_attention_dq_bf16_reference(
            q, k, v, out, lse, do, lens, causal, slack=True)
        dq_ref = kernels.flash_attention_dq_reference(q, k, v, out, lse, do,
                                                      lens, causal)
        dk_plain, dv_plain, dk_flips, dv_flips = \
            kernels.flash_attention_dkv_bf16_reference(
                q, k, v, out, lse, do, lens, causal, slack=True)
        dk_ref, dv_ref = kernels.flash_attention_dkv_reference(
            q, k, v, out, lse, do, lens, causal)
        grads = []
        for t, pl, fl, rf in ((dq, dq_plain, dq_flips, dq_ref),
                              (dk, dk_plain, dk_flips, dk_ref),
                              (dv, dv_plain, dv_flips, dv_ref)):
            top = max(rf.float().abs().max().item(), 1e-30)
            tier = TOL * pl.float().abs().max().item()
            grads.append((bf16_ulps(torch, t, pl, tier + fl),
                          err(t, rf) / top, err(t, pl),
                          bf16_ulps(torch, t, pl, tier)))
        log('check bf16 flash %s: fwd %.3g ULPs from its plain version '
            'beyond the tier and flips (%.3g without the flips), max abs '
            '%.3g from it, %.3g from the reference function, lse %.3g from '
            'the float32 kernel\'s; dq / dk / dv %s ULPs beyond the tier and '
            'flips (%s without the flips), %s of the max abs from the '
            'reference function, max abs %s from the plain version'
            % (where, fwd_ulps, bf16_ulps(torch, out, plain, TOL),
               err(out, plain), fwd_ref, lse_err,
               ['%.3g' % x[0] for x in grads], ['%.3g' % x[3] for x in grads],
               ['%.3g' % x[1] for x in grads],
               ['%.3g' % x[2] for x in grads]))
        for name, (u, r, e, _) in zip(
                ('flash_attention_dq.bf16', 'flash_attention_dkv.bf16',
                 'flash_attention_dkv.bf16'), grads):
            hold_tc(name, u, r, BF16_GRAD_REL, e, where)
        del q, k, v, do, w, out, plain, ref, dq, dk, dv, flips
        del dq_plain, dq_flips, dq_ref
        del dk_plain, dv_plain, dk_flips, dv_flips, dk_ref, dv_ref
    for shape in epi_shapes:
        x, g = (torch.randn(shape, generator=gen).mul(3).to(device, bf)
                for _ in range(2))
        for act in EPI_EXACT_ACTS + EPI_ULP_ACTS:
            slope = 0.25 if act == 'leaky' else 0.0
            y = kernels.act_forward(x, act, slope)
            o = kernels.act_forward_reference(x, act, slope)
            ulps_f = bf16_ulps(torch, y, o)
            hold('act_fwd.bf16', _bitwise_rounded(
                torch, y, kernels.act_forward(x.float(), act, slope)), ulps_f,
                (y.float() - o.float()).abs().max().item(),
                '%s %s' % (shape, act))
            dx = kernels.act_backward(g, o, act, slope)
            dref = kernels.act_backward_reference(g, o, act, slope)
            ulps_b = bf16_ulps(torch, dx, dref)
            hold('act_bwd.bf16', _bitwise_rounded(torch, dx, kernels.act_backward(
                g.float(), o.float(), act, slope)), ulps_b,
                (dx.float() - dref.float()).abs().max().item(),
                '%s %s' % (shape, act))
            log('check bf16 act %s act=%s: fwd / bwd bitwise the float32 '
                'kernel, %.3g / %.3g bf16 ULPs from the plain version'
                % (shape, act, ulps_f, ulps_b))
        del x, g
    return worst


def time_bf16_kernels(torch, kernels, batch=TRAIN['batch'],
                      heads=TRAIN['heads'], seq=TRAIN['seq'], d=TRAIN['d'],
                      pooler=(TRAIN['batch'], 768),
                      stem=(RESNET['batch'], 64, 112, 112)):
    """Times of the bf16 instances at phase 4c's shapes, each beside its
    float32 instance (``f32_device_ms``, the same inputs widened), its
    plain version and the library call on bf16: attention at B x H x S x D
    = 96 x 12 x 128 x 64 against SDPA and SDPA's backward; the act kernels
    at the pooler's tanh (96 x 768) against ``torch.tanh`` and
    ``tanh_backward``, and at the ResNet stem shape in relu against
    ``torch.relu`` and ``threshold_backward`` (``at_stem``). Bounds: the
    bytes at bf16 widths (lse float32) at 3.35 TB/s against the
    arithmetic each performs, one bf16 product each at 989 TFLOP/s (the
    tensor-core kernels). The forward's row also carries ``group``:
    forward + dq + dk/dv against SDPA's forward + backward on bf16, device
    ms; dq's row ``pair_turns_device_ms``: dq + dk/dv against SDPA's
    backward, and ``group_turns_device_ms``: forward + dq + dk/dv against
    SDPA's forward + backward, each in alternating turns."""
    F = torch.nn.functional
    dev = torch.device('cuda')
    bf = torch.bfloat16
    gen = torch.Generator(device='cpu').manual_seed(7)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    rows = {}
    q, k, v, do = (randn(batch, heads, seq, d) for _ in range(4))
    lens = torch.full((batch,), seq, dtype=torch.int32, device=dev)
    qb, kb, vb, dob = (t.to(bf) for t in (q, k, v, do))
    outb, lse = kernels.flash_attention_with_lse(qb, kb, vb, lens)
    out = outb.float()
    shape = 'B%d H%d S%d D%d non-causal lengths %d, bf16' % (batch, heads,
                                                            seq, d, seq)
    visible = batch * heads * seq * seq
    tensor_b = qb.numel() * 2
    lse_b, lens_b = lse.numel() * 4, batch * 4
    qs, ks, vs = (t.detach().clone().requires_grad_(True)
                  for t in (qb, kb, vb))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (qs, ks, vs), dob,
                                   retain_graph=True)

    b_ms, b_by = bound(4 * tensor_b + lse_b + lens_b, visible * 4 * d,
                       PEAK_BF16_FLOP_S)
    rows['flash_attention_fwd.bf16'] = timings(
        torch, (qb, kb, vb, lens), kernels.flash_attention_with_lse,
        kernels.flash_attention_bf16_reference,
        lambda q, k, v, lens: F.scaled_dot_product_attention(q, k, v),
        bound_ms=b_ms, bound_by=b_by,
        f32_device_ms=device_ms(torch, kernels.flash_attention_with_lse,
                                (q, k, v, lens)),
        shape=shape + ', block_q %d, %d blocks; bound: one bf16 product at '
        '989 TFLOP/s; library: SDPA on bf16'
        % kernels.fwd_bf16_geometry(batch, heads, seq)[:2])
    ins, ins32 = (qb, kb, vb, outb, lse, dob, lens), (q, k, v, out, lse, do,
                                                       lens)
    for name, fn, plain, nbytes, flops, peak, what in (
            ('flash_attention_dq.bf16', kernels.flash_attention_dq,
             kernels.flash_attention_dq_bf16_reference, 6 * tensor_b,
             visible * 6 * d, PEAK_BF16_FLOP_S,
             'one bf16 product at 989 TFLOP/s'),
            ('flash_attention_dkv.bf16', kernels.flash_attention_dkv,
             kernels.flash_attention_dkv_bf16_reference, 7 * tensor_b,
             visible * 8 * d, PEAK_BF16_FLOP_S,
             'one bf16 product at 989 TFLOP/s')):
        b_ms, b_by = bound(nbytes + lse_b + lens_b, flops, peak)
        rows[name] = timings(
            torch, ins, fn, plain, sdpa_bwd, library_inputs=(),
            bound_ms=b_ms, bound_by=b_by,
            f32_device_ms=device_ms(torch, fn, ins32),
            shape=shape + '; bound: %s; library: SDPA backward on bf16 (dq, '
            'dk and dv together)' % what)
    # the attention group of a 4c layer: the three kernels against SDPA's
    # forward + backward, device ms of this run
    names = ('flash_attention_fwd.bf16', 'flash_attention_dq.bf16',
             'flash_attention_dkv.bf16')
    rows[names[0]]['group'] = dict(
        kernels_device_ms=sum(rows[n]['device_ms'] for n in names),
        sdpa_device_ms=(rows[names[0]]['library_device_ms']
                        + rows[names[1]]['library_device_ms']),
        bound_ms=sum(rows[n]['bound_ms'] for n in names))

    # dq + dk/dv as a step runs them against SDPA's backward, and forward +
    # dq + dk/dv against SDPA's forward + backward, in turns (kernels,
    # SDPA, SDPA, kernels, kernels, SDPA): the spread of each comparison
    # within this run
    def pair(*t):
        return kernels.flash_attention_dq(*t), kernels.flash_attention_dkv(*t)

    def group(q, k, v, lens, dob):
        o, l = kernels.flash_attention_with_lse(q, k, v, lens)
        return pair(q, k, v, o, l, dob, lens)

    def sdpa_group(q, k, v, dob):
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        return torch.autograd.grad(F.scaled_dot_product_attention(qs, ks, vs),
                                   (qs, ks, vs), dob)

    order = ('kernels', 'sdpa', 'sdpa', 'kernels', 'kernels', 'sdpa')
    for key, kern, kern_in, lib, lib_in in (
            ('pair_turns_device_ms', pair, ins, sdpa_bwd, ()),
            ('group_turns_device_ms', group, (qb, kb, vb, lens, dob),
             sdpa_group, (qb, kb, vb, dob))):
        turns = {'kernels': [], 'sdpa': []}
        for who in order:
            turns[who].append(device_ms(torch, kern, kern_in) if who ==
                              'kernels' else device_ms(torch, lib, lib_in))
        rows[names[1]][key] = turns
    del q, k, v, do, qb, kb, vb, dob, outb, out, lse, qs, ks, vs, sdpa_out
    del ins, ins32
    torch.cuda.empty_cache()

    x, g = (randn(*pooler).to(bf) for _ in range(2))
    o = kernels.act_forward_reference(x, 'tanh')
    n = x.numel()
    b_ms, b_by = bound(4 * n, n)
    rows['act_fwd.bf16'] = timings(
        torch, (x,), lambda x: kernels.act_forward(x, 'tanh'),
        lambda x: kernels.act_forward_reference(x, 'tanh'), torch.tanh,
        bound_ms=b_ms, bound_by=b_by,
        f32_device_ms=device_ms(torch, lambda x: kernels.act_forward(
            x, 'tanh'), (x.float(),)),
        shape='%s tanh bf16 (the pooler); library: torch.tanh' % (pooler,))
    # g * (1 - out^2): a product, a difference and a product an element
    b_ms, b_by = bound(6 * n, 3 * n)
    rows['act_bwd.bf16'] = timings(
        torch, (g, o), lambda g, o: kernels.act_backward(g, o, 'tanh'),
        lambda g, o: kernels.act_backward_reference(g, o, 'tanh'),
        torch.ops.aten.tanh_backward, bound_ms=b_ms, bound_by=b_by,
        f32_device_ms=device_ms(torch, lambda g, o: kernels.act_backward(
            g, o, 'tanh'), (g.float(), o.float())),
        shape='%s tanh bf16 (the pooler); library: aten.tanh_backward'
        % (pooler,))
    xs, gs = (torch.randn(stem, generator=gen).to(dev, bf) for _ in range(2))
    os_ = torch.relu(xs)
    ns = xs.numel()
    rows['act_fwd.bf16']['at_stem'] = dict(
        shape='%s relu bf16; library: torch.relu' % (stem,),
        device_ms=device_ms(torch, lambda x: kernels.act_forward(x, 'relu'),
                            (xs,)),
        library_device_ms=device_ms(torch, torch.relu, (xs,)),
        bound_ms=bound(4 * ns, ns)[0])
    rows['act_bwd.bf16']['at_stem'] = dict(
        shape='%s relu bf16; library: aten.threshold_backward' % (stem,),
        device_ms=device_ms(torch, lambda g, o: kernels.act_backward(
            g, o, 'relu'), (gs, os_)),
        library_device_ms=device_ms(
            torch, lambda g, o: torch.ops.aten.threshold_backward(g, o, 0),
            (gs, os_)),
        bound_ms=bound(6 * ns, ns)[0])
    return rows


def _bn_pairs(kernels, x, g, scale, mean, beta, axis, act, slope):
    """(kernel name, kernel result, plain result) of the two BN apply
    kernels with (C,) coefficients along ``axis``; the backward reads the
    plain forward's output."""
    out = kernels.bn_act_forward_reference(x, scale, mean, beta, axis, act,
                                           slope)
    return [
        ('bn_act_fwd', kernels.bn_act_forward(x, scale, mean, beta, axis,
                                              act, slope), out),
        ('bn_act_bwd', kernels.bn_act_backward(g, out, scale, axis, act,
                                               slope),
         kernels.bn_act_backward_reference(g, out, scale, axis, act,
                                           slope)),
    ]


def _epi_pairs(kernels, x, y, g, scale, mean, beta, act, slope):
    """(kernel name, kernel result, plain result) of the five epilogue
    kernels on one input set (the BN apply along axis 1); the backward
    kernels read the plain forward's output."""
    out = kernels.act_forward_reference(x, act, slope)
    return [
        ('act_fwd', kernels.act_forward(x, act, slope), out),
        ('act_bwd', kernels.act_backward(g, out, act, slope),
         kernels.act_backward_reference(g, out, act, slope)),
        ('add_act_fwd', kernels.add_act_forward(x, y, act, slope),
         kernels.add_act_forward_reference(x, y, act, slope)),
    ] + _bn_pairs(kernels, x, g, scale, mean, beta, 1, act, slope)


def _check_pairs(pairs, act, where, worst):
    """Each (name, kernel result, plain result) of ``pairs``: bitwise for
    the exact acts, 5e-7 of the plain result's max abs for the
    transcendental ones; raises naming ``where``, else folds each max
    abs error into ``worst`` and returns {name: error}."""
    errs = {}
    for name, got, want in pairs:
        err, rel = _errs(got, want)
        errs[name] = err
        ok = got.equal(want) if act in EPI_EXACT_ACTS else rel <= ULP
        if not ok:
            raise AssertionError(
                '%s (%s) disagrees with its plain version at %s: max abs '
                'err %.3g, rel %.3g' % (name, act, where, err, rel))
        worst[name] = max(worst[name], err)
    return errs


def _bn_coeffs(torch, c, gen, device):
    scale = torch.rand(c, generator=gen, device=device) + 0.5
    mean, beta = (torch.randn(c, generator=gen, device=device)
                  for _ in range(2))
    return scale, mean, beta


def check_epilogue_kernels(torch, kernels, device, shapes=EPI_SHAPES,
                           bn_cases=EPI_BN_CASES):
    """The five epilogue kernels against their plain versions on
    ``device`` for every act type at each shape, and the two BN apply
    kernels at each (shape, axis) of ``bn_cases``: bitwise for the exact
    acts, 5e-7 of the plain result's max abs for the transcendental ones;
    a cotangent that is an expanded (stride-0) view is made dense.
    Returns {kernel name: worst max abs error}."""
    gen = torch.Generator(device=device).manual_seed(4)
    worst = dict.fromkeys(EPI_KERNELS, 0.0)

    def how(act):
        return 'bitwise' if act in EPI_EXACT_ACTS else 'rel <= %g' % ULP

    for shape, axis in bn_cases:
        x, g = (torch.randn(shape, generator=gen, device=device) * 3
                for _ in range(2))
        c = shape[axis]
        coeffs = _bn_coeffs(torch, c, gen, device)
        inner = math.prod(shape[axis % len(shape) + 1:])
        for act in EPI_EXACT_ACTS + EPI_ULP_ACTS:
            slope = 0.25 if act == 'leaky' else 0.0
            errs = _check_pairs(
                _bn_pairs(kernels, x, g, *coeffs, axis, act, slope), act,
                '%s axis %d (C %d, inner %d)' % (shape, axis, c, inner),
                worst)
            log('check bn apply %s axis=%d (C %d, inner %d) act=%s: '
                'max_abs_err %s (%s)' % (shape, axis, c, inner, act, {
                    k: '%.3g' % v for k, v in errs.items()}, how(act)))
    for shape in shapes:
        x, y, g = (torch.randn(shape, generator=gen, device=device) * 3
                   for _ in range(3))
        scale, mean, beta = _bn_coeffs(torch, shape[1], gen, device)
        for act in EPI_EXACT_ACTS + EPI_ULP_ACTS:
            slope = 0.25 if act == 'leaky' else 0.0
            errs = _check_pairs(_epi_pairs(kernels, x, y, g, scale, mean,
                                           beta, act, slope), act, shape,
                                worst)
            log('check epilogue %s act=%s: max_abs_err %s (%s)'
                % (shape, act, {k: '%.3g' % v for k, v in errs.items()},
                   how(act)))
        gexp = g[:1, :1, :1, :1].expand(shape)
        out = kernels.act_forward_reference(x, 'relu')
        if not torch.equal(kernels.act_backward(gexp, out, 'relu'),
                           kernels.act_backward_reference(gexp, out, 'relu')):
            raise AssertionError('act_bwd disagrees on an expanded '
                                 'cotangent')
        del x, y, g, out, gexp
    return worst


def time_epilogue_kernels(torch, kernels, batch=RESNET['batch']):
    """Times of the epilogue kernels, their plain versions and the library
    calls at ResNet-50's largest shapes of the step: the stem BN and relu
    (batch x 64 x 112 x 112) for the BN apply and act kernels (identity
    for the BN apply, as the training step calls it; relu for the act
    kernels), the first stage's block join (batch x 256 x 56 x 56) for
    add+relu. Bounds: bytes, each input read once and each output written
    once, at 3.35 TB/s."""
    F = torch.nn.functional
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(5)
    stem, join = (batch, 64, 112, 112), (batch, 256, 56, 56)
    x, g = (torch.randn(stem, generator=gen, device=dev) for _ in range(2))
    c, eps = stem[1], 1e-5
    gamma = torch.rand(c, generator=gen, device=dev) + 0.5
    var = torch.rand(c, generator=gen, device=dev) + 0.5
    mean, beta = (torch.randn(c, generator=gen, device=dev)
                  for _ in range(2))
    scale = torch.rsqrt(var + eps) * gamma
    out = torch.relu(x)
    n = x.numel()
    rows = {}
    b_ms, b_by = bound(8 * n + 12 * c, 3 * n)
    rows['bn_act_fwd'] = timings(
        torch, (x, scale, mean, beta), kernels.bn_act_forward,
        kernels.bn_act_forward_reference,
        lambda x, mean, var, gamma, beta: F.batch_norm(
            x, mean, var, gamma, beta, training=False, eps=eps),
        library_inputs=(x, mean, var, gamma, beta),
        bound_ms=b_ms, bound_by=b_by,
        shape='%s identity; library: batch_norm(training=False)' % (stem,))
    # identity: dx = g * scale[c] reads g and scale only; the saved
    # output is passed but an identity act's derivative never reads it
    b_ms, b_by = bound(8 * n + 4 * c, n)
    rows['bn_act_bwd'] = timings(
        torch, (g, x, scale), kernels.bn_act_backward,
        kernels.bn_act_backward_reference,
        lambda g, x, scale: torch.mul(g, scale.view(1, -1, 1, 1)),
        bound_ms=b_ms, bound_by=b_by,
        shape='%s identity; library: torch.mul(g, scale[c])' % (stem,))
    b_ms, b_by = bound(8 * n, n)
    rows['act_fwd'] = timings(
        torch, (x,), lambda x: kernels.act_forward(x, 'relu'),
        lambda x: kernels.act_forward_reference(x, 'relu'), torch.relu,
        bound_ms=b_ms, bound_by=b_by,
        shape='%s relu; library: torch.relu' % (stem,))
    b_ms, b_by = bound(12 * n, n)
    rows['act_bwd'] = timings(
        torch, (g, out), lambda g, out: kernels.act_backward(g, out, 'relu'),
        lambda g, out: kernels.act_backward_reference(g, out, 'relu'),
        lambda g, out: torch.ops.aten.threshold_backward(g, out, 0),
        bound_ms=b_ms, bound_by=b_by,
        shape='%s relu; library: aten.threshold_backward' % (stem,))
    del x, g, out
    xj, yj = (torch.randn(join, generator=gen, device=dev)
              for _ in range(2))
    nj = xj.numel()
    b_ms, b_by = bound(12 * nj, 2 * nj)
    rows['add_act_fwd'] = timings(
        torch, (xj, yj), lambda x, y: kernels.add_act_forward(x, y, 'relu'),
        lambda x, y: kernels.add_act_forward_reference(x, y, 'relu'),
        bound_ms=b_ms, bound_by=b_by,
        shape='%s relu; library: none (aten._add_relu, the one call that '
        'computes relu(x + y), has no CUDA kernel)' % (join,))
    return rows


# -- phase 2: the bf16 instances of the ResNet path (rows 5b-11b) -----------

BF16_ROWS = ('bn_act_fwd.bf16', 'bn_act_bwd.bf16', 'add_act_fwd.bf16',
             'softmax_xent_fwd.bf16', 'softmax_xent_bwd.bf16')
# every BatchNorm shape of a ResNet-50 v1 step at batch 128 (the stem, the
# three of each bottleneck at its stage's width, the projections) and its
# four residual-join shapes
RESNET_BN_SHAPES = ((128, 64, 112, 112), (128, 64, 56, 56),
                    (128, 256, 56, 56), (128, 128, 28, 28),
                    (128, 512, 28, 28), (128, 256, 14, 14),
                    (128, 1024, 14, 14), (128, 512, 7, 7), (128, 2048, 7, 7))
RESNET_JOIN_SHAPES = ((128, 256, 56, 56), (128, 512, 28, 28),
                      (128, 1024, 14, 14), (128, 2048, 7, 7))
# the backward writing bf16 (8 elements a vector, 2048 a tile): below a
# tile with n % 8 of 3 and 7, whole tiles, a rest and a tail, ResNet's
# head and the MLM head
XENT_BWD_BF16_CASES = ((7, 5), (5, 3), (1024, 2), (128, 1000), (3, 30523),
                       (6, 30523), (1920, 30522))


def check_bf16_rows(torch, kernels, device, bn_shapes=RESNET_BN_SHAPES,
                    join_shapes=RESNET_JOIN_SHAPES, epi_shapes=EPI_SHAPES,
                    bn_cases=EPI_BN_CASES, xent_shapes=XENT_SHAPES,
                    xent_bwd_cases=XENT_BWD_BF16_CASES):
    """The bf16 instances of the BN apply forward and backward, add+act
    and the xent head (rows 5b, 6b, 9b, 10b, 11b) against the float32
    kernels on the widened inputs and their plain versions on ``device``:
    the BN apply at ResNet-50's BatchNorm shapes (identity, as its step
    runs it) and add+relu at its join shapes, then every act type at the
    epilogue check shapes and the BN apply's odd-inner cases; the xent
    forward on bf16 logits at ``xent_shapes`` (every instance), labels
    out of range included; its backward writing bf16 on
    ``xent_bwd_cases``, g per row and a scalar. Each result is bitwise
    the float32 kernel's on the widened inputs (rounded once where it is
    bf16) and within :data:`BF16_ULPS` bf16 ULPs of the plain version
    beyond the float32 tier (0 for the exact acts, ULP of the max abs for
    the transcendental ones, TOL of the max abs for dlogits; nll and logp
    within TOL). Returns {kernel name: worst max abs error against the
    plain version}."""
    bf = torch.bfloat16
    gen = torch.Generator(device='cpu').manual_seed(8)
    worst = dict.fromkeys(BF16_ROWS, 0.0)

    def randn(*shape, scale=3.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device, bf)

    def hold(name, got, f32, plain, act, where):
        bitwise = torch.equal(got, f32.to(got.dtype))
        tier = 0.0 if act in EPI_EXACT_ACTS else \
            ULP * plain.float().abs().max().item()
        ulps = bf16_ulps(torch, got, plain, tier)
        if not bitwise or not ulps <= BF16_ULPS:
            raise AssertionError('%s at %s: bitwise the float32 kernel %s, '
                                 '%.3g bf16 ULPs beyond the tier from its '
                                 'plain version' % (name, where, bitwise,
                                                    ulps))
        worst[name] = max(worst[name],
                          (got.float() - plain.float()).abs().max().item())
        return ulps

    def bn_pair(x, g, coeffs, axis, act, where):
        slope = 0.25 if act == 'leaky' else 0.0
        scale, mean, beta = coeffs
        out = kernels.bn_act_forward(x, scale, mean, beta, axis, act, slope)
        u1 = hold('bn_act_fwd.bf16', out,
                  kernels.bn_act_forward(x.float(), scale, mean, beta, axis,
                                         act, slope),
                  kernels.bn_act_forward_reference(x, scale, mean, beta,
                                                   axis, act, slope),
                  act, where)
        dx = kernels.bn_act_backward(g, out, scale, axis, act, slope)
        u2 = hold('bn_act_bwd.bf16', dx,
                  kernels.bn_act_backward(g.float(), out.float(), scale,
                                          axis, act, slope),
                  kernels.bn_act_backward_reference(g, out, scale, axis,
                                                    act, slope),
                  act, where)
        return u1, u2

    def join(x, y, act, where):
        slope = 0.25 if act == 'leaky' else 0.0
        return hold('add_act_fwd.bf16', kernels.add_act_forward(x, y, act,
                                                                slope),
                    kernels.add_act_forward(x.float(), y.float(), act, slope),
                    kernels.add_act_forward_reference(x, y, act, slope), act,
                    where)

    def coeffs(c):
        c32 = _bn_coeffs(torch, c, torch.Generator(device='cpu').manual_seed(c),
                         'cpu')
        return [t.to(device) for t in c32]

    for shape in bn_shapes:
        x, g = randn(*shape), randn(*shape)
        u = bn_pair(x, g, coeffs(shape[1]), 1, 'identity', shape)
        log('check bf16 bn apply %s identity: fwd / bwd bitwise the float32 '
            'kernel, %.3g / %.3g bf16 ULPs from the plain version'
            % ((shape,) + u))
        del x, g
    for shape in join_shapes:
        x, y = randn(*shape), randn(*shape)
        log('check bf16 add+relu %s: bitwise the float32 kernel, %.3g bf16 '
            'ULPs from the plain version' % (shape, join(x, y, 'relu',
                                                        shape)))
        del x, y
    for shape in epi_shapes:
        x, y, g = randn(*shape), randn(*shape), randn(*shape)
        for act in EPI_EXACT_ACTS + EPI_ULP_ACTS:
            where = '%s %s' % (shape, act)
            u = bn_pair(x, g, coeffs(shape[1]), 1, act, where) + (
                join(x, y, act, where),)
            log('check bf16 epilogue %s act=%s: bn fwd / bn bwd / add+act '
                'bitwise the float32 kernel, %s bf16 ULPs beyond the tier'
                % (shape, act, ['%.3g' % v for v in u]))
        del x, y, g
    for shape, axis in bn_cases:
        x, g = randn(*shape), randn(*shape)
        for act in EPI_EXACT_ACTS + EPI_ULP_ACTS:
            bn_pair(x, g, coeffs(shape[axis]), axis, act,
                    '%s axis %d %s' % (shape, axis, act))
        log('check bf16 bn apply %s axis=%d: every act bitwise the float32 '
            'kernel, within the ULP bound' % (shape, axis))
    for rows, v in xent_shapes:
        x = randn(rows, v)
        lab = torch.randint(0, v, (rows,), generator=gen, dtype=torch.int32)
        lab[0] = -1
        if rows > 1:
            lab[1] = v
        lab = lab.to(device)
        nll, logp = kernels.softmax_xent_forward(x, lab)
        n32, l32 = kernels.softmax_xent_forward(x.float(), lab)
        nr, lr = kernels.softmax_xent_forward_reference(x, lab)
        bitwise = torch.equal(nll, n32) and torch.equal(logp, l32)
        err = max(_errs(nll, nr)[0], _errs(logp, lr)[0])
        geom = kernels.xent_geometry(rows, v, 2)
        log('check bf16 softmax_xent_fwd rows=%d V=%d (%s, %d CTAs a row): '
            'nll, logp float32, bitwise the float32 kernel on the widened '
            'logits %s, max_abs_err %.3g'
            % (rows, v, geom.instance, geom.cluster, bitwise, err))
        if nll.dtype != torch.float32 or logp.dtype != torch.float32 \
                or not bitwise or not err <= TOL:
            raise AssertionError('softmax_xent_fwd.bf16 at rows %d V %d: '
                                 'bitwise %s, max_abs_err %.3g'
                                 % (rows, v, bitwise, err))
        worst['softmax_xent_fwd.bf16'] = max(worst['softmax_xent_fwd.bf16'],
                                             err)
        del x, nll, logp, n32, l32, nr, lr
    for rows, v in xent_bwd_cases:
        logp, lab = xent_bwd_inputs(torch, kernels, rows, v, gen, device)
        for kind, g in (('row', torch.rand(rows, generator=gen).to(device)),
                        ('scalar', XENT_BWD_G)):
            dx = kernels.softmax_xent_backward(logp, lab, g, bf)
            want = kernels.softmax_xent_backward_reference(logp, lab, g, bf)
            f32 = kernels.softmax_xent_backward(logp, lab, g)
            bitwise = torch.equal(dx, f32.to(bf))
            ulps = bf16_ulps(torch, dx, want,
                             TOL * want.float().abs().max().item())
            geom = kernels.epilogue_geometry(rows * v, 2)
            log('check bf16 softmax_xent_bwd rows=%d V=%d n=%d (%d tiles, '
                'rest %d, tail %d) g %s: bitwise the float32 kernel rounded '
                '%s, %.3g bf16 ULPs beyond the tier'
                % (rows, v, rows * v, geom.tiles, geom.rest, geom.tail, kind,
                   bitwise, ulps))
            if dx.dtype != bf or not bitwise or not ulps <= BF16_ULPS:
                raise AssertionError('softmax_xent_bwd.bf16 at rows %d V %d '
                                     'g %s' % (rows, v, kind))
            worst['softmax_xent_bwd.bf16'] = max(
                worst['softmax_xent_bwd.bf16'],
                (dx.float() - want.float()).abs().max().item())
        del logp
    return worst


def xent_cluster_turns(torch, x, lab):
    """Device ms of the xent forward's cluster instance at each cluster
    size that fits (1, 2, 4, 8) on bf16 logits ``x`` and on them widened,
    each dtype's sizes in turns (``probe_xent_clusters.times_by_size``:
    the C entry point at each size, launches not counted)."""
    from mxnet_tpu_torch.tools.probe_xent_clusters import times_by_size
    return {'bf16': times_by_size(torch, x, lab),
            'f32': times_by_size(torch, x.float(), lab)}


def time_bf16_rows(torch, kernels, batch=RESNET['batch'],
                   classes=RESNET['classes'], mlm=(1920, TRAIN['vocab'])):
    """Times of rows 5b, 6b, 9b, 10b and 11b at the shapes of the ResNet
    path on bf16, each beside its float32 instance on the same inputs
    widened (``f32_device_ms``), its plain version and the library call
    on bf16: the BN apply and its backward at the stem (batch x 64 x 112
    x 112, identity) against ``batch_norm(training=False)`` and
    ``torch.mul`` (g by a bf16 copy of scale), add+relu at the first join
    (batch x 256 x 56 x 56; no library call), the xent head at ResNet's
    (batch x 1000) against ``cross_entropy`` / ``log_softmax`` and the
    backward alone of ``cross_entropy``, both also at the MLM head (1920
    x 30522, ``at_mlm``). Bounds at bf16 bytes (coefficients, logp, nll
    and g float32) at 3.35 TB/s."""
    F = torch.nn.functional
    dev = torch.device('cuda')
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(9)
    rows = {}
    stem, join_shape = (batch, 64, 112, 112), (batch, 256, 56, 56)
    x, g = (torch.randn(stem, generator=gen, device=dev).to(bf)
            for _ in range(2))
    c, eps = stem[1], 1e-5
    gamma = torch.rand(c, generator=gen, device=dev) + 0.5
    var = torch.rand(c, generator=gen, device=dev) + 0.5
    mean, beta = (torch.randn(c, generator=gen, device=dev)
                  for _ in range(2))
    scale = torch.rsqrt(var + eps) * gamma
    n = x.numel()
    b_ms, b_by = bound(4 * n + 12 * c, 3 * n)
    rows['bn_act_fwd.bf16'] = timings(
        torch, (x, scale, mean, beta), kernels.bn_act_forward,
        kernels.bn_act_forward_reference,
        lambda x, mean, var, gamma, beta: F.batch_norm(
            x, mean, var, gamma, beta, training=False, eps=eps),
        library_inputs=(x, mean, var, gamma, beta),
        bound_ms=b_ms, bound_by=b_by,
        f32_device_ms=device_ms(torch, kernels.bn_act_forward,
                                (x.float(), scale, mean, beta)),
        shape='%s identity bf16, coefficients float32; library: '
        'batch_norm(training=False) on bf16' % (stem,))
    b_ms, b_by = bound(4 * n + 4 * c, n)
    rows['bn_act_bwd.bf16'] = timings(
        torch, (g, x, scale), kernels.bn_act_backward,
        kernels.bn_act_backward_reference,
        lambda g, s: torch.mul(g, s.view(1, -1, 1, 1)),
        library_inputs=(g, scale.to(bf)), bound_ms=b_ms, bound_by=b_by,
        f32_device_ms=device_ms(torch, kernels.bn_act_backward,
                                (g.float(), x.float(), scale)),
        shape='%s identity bf16; library: torch.mul(g, scale[c]) in bf16'
        % (stem,))
    del x, g
    xj, yj = (torch.randn(join_shape, generator=gen, device=dev).to(bf)
              for _ in range(2))
    nj = xj.numel()
    b_ms, b_by = bound(6 * nj, 2 * nj)
    rows['add_act_fwd.bf16'] = timings(
        torch, (xj, yj), lambda x, y: kernels.add_act_forward(x, y, 'relu'),
        lambda x, y: kernels.add_act_forward_reference(x, y, 'relu'),
        bound_ms=b_ms, bound_by=b_by,
        f32_device_ms=device_ms(torch, lambda x, y: kernels.add_act_forward(
            x, y, 'relu'), (xj.float(), yj.float())),
        shape='%s relu bf16; library: none (aten._add_relu has no CUDA '
        'kernel)' % (join_shape,))
    del xj, yj
    for r, v, key in ((batch, classes, None), (mlm[0], mlm[1], 'at_mlm')):
        x = (torch.randn(r, v, generator=gen, device=dev) * 3).to(bf)
        lab = torch.randint(0, v, (r,), generator=gen, device=dev,
                            dtype=torch.int32)
        lab64 = lab.long()
        _, logp = kernels.softmax_xent_forward(x, lab)
        gr = torch.full((r,), 1.0 / r, device=dev)
        m = x.numel()
        fwd = timings(
            torch, (x, lab), kernels.softmax_xent_forward,
            kernels.softmax_xent_forward_reference,
            lambda x, lab: F.cross_entropy(x, lab, reduction='none'),
            library_inputs=(x, lab64),
            bound_ms=bound(2 * m + 4 * m + 3 * r * 4, 5 * m)[0],
            bound_by=bound(2 * m + 4 * m + 3 * r * 4, 5 * m)[1],
            f32_device_ms=device_ms(torch, kernels.softmax_xent_forward,
                                    (x.float(), lab)),
            log_softmax_device_ms=device_ms(
                torch, lambda x: F.log_softmax(x, dim=-1), (x,)),
            shape='rows %d V %d bf16 logits, nll and logp float32, %s; '
            'library: cross_entropy(reduction=none) on bf16 (its logp '
            'bf16)' % (r, v, kernels.xent_geometry(r, v).instance))
        xs = x.detach().clone().requires_grad_(True)
        ce = F.cross_entropy(xs, lab64, reduction='sum') / r

        def ce_bwd(ce=ce, xs=xs):
            return torch.autograd.grad(ce, xs, retain_graph=True)

        bwd = timings(
            torch, (logp, lab, gr),
            lambda lp, lab, g: kernels.softmax_xent_backward(lp, lab, g, bf),
            lambda lp, lab, g: kernels.softmax_xent_backward_reference(
                lp, lab, g, bf), ce_bwd, library_inputs=(),
            bound_ms=bound(4 * m + 2 * m + 2 * r * 4, 3 * m)[0],
            bound_by=bound(4 * m + 2 * m + 2 * r * 4, 3 * m)[1],
            f32_device_ms=device_ms(torch, kernels.softmax_xent_backward,
                                    (logp, lab, gr)),
            shape='rows %d V %d, logp float32, dx bf16; library: backward '
            'alone of cross_entropy(reduction=sum) on bf16 logits' % (r, v))
        if key is None:
            rows['softmax_xent_fwd.bf16'], rows['softmax_xent_bwd.bf16'] = \
                fwd, bwd
        else:
            for name, row in (('softmax_xent_fwd.bf16', fwd),
                              ('softmax_xent_bwd.bf16', bwd)):
                rows[name][key] = {k: row[k] for k in (
                    'shape', 'device_ms', 'f32_device_ms', 'bound_ms',
                    'library_device_ms')}
            # the cluster instance at each size, in turns (1, 2, 4, 8, 8,
            # 4, 2, 1), bf16 logits and the float32 instance on them widened
            rows['softmax_xent_fwd.bf16'][key]['by_cluster'] = \
                xent_cluster_turns(torch, x, lab)
        del x, xs, ce, logp
        torch.cuda.empty_cache()
    return rows


# -- phase 2: the whole-model optimizer update (row 17) ----------------------

# odd lengths: below a vector, a vector and one more, whole chunks of
# 8192 and one more, a tail; tensor 3 a view 4 bytes off 16 (no vector
# loads), tensor 2 never given a gradient (it reads zeros)
ODD_LENGTHS = (1, 7, 9, 8, 4097, 8192, 8193, 20001)
# each rule with clip, rescale, an lr and a wd multiplier; AdamW at the
# bench's lr and wd. fused_grads draws 0.01 x N(0, 1) gradients, so the
# rescaled ones have a standard deviation near 3.7e-3 and the clip at
# 3e-3 clamps about 40 % of the elements in every rule and form
FUSED_CLIP = 3e-3
FUSED_HYPER = {
    'sgd': dict(learning_rate=0.1, wd=1e-4, clip_gradient=FUSED_CLIP,
                rescale_grad=0.37),
    'sgd_mom': dict(learning_rate=0.1, momentum=0.9, wd=1e-4,
                    clip_gradient=FUSED_CLIP, rescale_grad=0.37),
    'adamw': dict(learning_rate=1e-4, wd=0.01, clip_gradient=FUSED_CLIP,
                  rescale_grad=0.37)}
# the least share of gradient elements the check must see clamped
FUSED_CLAMPED = 0.2
FUSED_STEPS = 3
# (list, rule, form) timed: the pairs the trainer phases run, BERT-base
# with AdamW in float32 (4b, 4c), .bf16 (4d) and .mp (4d-mp), ResNet-50
# with SGD + momentum in float32 (5b, 5d; 5e's BatchNorm parameters) and
# .bf16 (5e)
FUSED_TIMED = (('bert', 'adamw', 'float32'), ('bert', 'adamw', 'low'),
               ('bert', 'adamw', 'master'), ('resnet', 'sgd_mom', 'float32'),
               ('resnet', 'sgd_mom', 'low'))


def param_lists(torch, bert, resnet):
    """The shapes of the tensors the trainer updates in BERT-base (206
    tensors, 131.37 M elements) and ResNet-50 v1 (193, 25.58 M): the nets
    allocated on the CPU, never filled."""
    cpu = torch.device('cpu')
    nets = {'bert': bert.bert_12_768_12(vocab_size=TRAIN['vocab'],
                                        max_length=512, dropout=0.1,
                                        device=cpu),
            'resnet': resnet.get_resnet(1, RESNET['depth'], device=cpu)}
    return {name: [tuple(p.shape) for p in net.collect_params().values()
                   if p.requires_grad] for name, net in nets.items()}


def fused_setup(torch, optimizer, rule, form, shapes, device, seed=0,
                odd=False):
    """(parameter pairs, optimizer, states) of one instance: weights of
    ``shapes`` from a seed on ``device`` (bf16 for the bf16 forms), the
    rule's optimizer (``multi_precision`` for 'master') with an lr and a
    wd multiplier, its states; with ``odd`` tensor 3 a view 4 bytes off
    16. The same arguments give the same values."""
    import warnings
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = torch.float32 if form == 'float32' else torch.bfloat16
    pairs = []
    for i, shape in enumerate(shapes):
        n = math.prod(shape)
        base = torch.randn(n + 1, generator=gen, device=device).to(dt)
        w = base[1:] if odd and i == 3 else base[:n].clone()
        pairs.append((i, torch.nn.Parameter(w.view(shape))))
    hyper = dict(FUSED_HYPER[rule], multi_precision=form == 'master')
    opt = optimizer.create('sgd' if rule.startswith('sgd') else rule,
                           **hyper)
    opt.idx2name = {i: 'p%d_weight' % i for i, _ in pairs}
    opt.set_lr_mult({0: 0.5})
    opt.set_wd_mult({'p1_weight': 0.0})
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')    # bf16 weights without a master
        states = [opt.create_state_multi_precision(i, p.detach())
                  for i, p in pairs]
    return pairs, opt, states


def fused_grads(torch, pairs, step, skip=2):
    """Gradients of one step, from a seed, in each weight's dtype; the
    parameter at ``skip`` gets none."""
    gen = torch.Generator(device=pairs[0][1].device).manual_seed(100 + step)
    for i, p in pairs:
        p.grad = None if i == skip else (torch.randn(
            p.shape, generator=gen, device=p.device) * 0.01).to(p.dtype)


def clamped_share(pairs, opt):
    """The share of the step's gradient elements that ``opt``'s clip
    clamps, |g * rescale| > clip in float32 (the bf16 AdamW's rounding
    of the rescaled gradient and the clip aside)."""
    hit = total = 0
    for _, p in pairs:
        if p.grad is not None:
            g = p.grad.float() * opt.rescale_grad
            hit += int((g.abs() > opt.clip_gradient).sum())
            total += g.numel()
    return hit / total


def _state_tensors(states):
    out = []
    for st in states:
        if isinstance(st, (tuple, list)):
            out += _state_tensors(st)
        elif st is not None:
            out.append(st)
    return out


def plain_update(torch, pairs, opt, states):
    """The whole-model update's plain version: ``update_multi_precision``
    parameter by parameter, a missing gradient as zeros."""
    with torch.no_grad():
        for (i, p), st in zip(pairs, states):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            opt.update_multi_precision(i, p.data, g, st)


def check_fused_update(torch, kernels, optimizer, device, lists,
                       steps=FUSED_STEPS):
    """Every instance (rule x form) of ``multi_tensor_update`` through the
    trainer's ``FusedUpdate`` against its plain version on the card, over
    ``steps`` consecutive steps from the same weights and states, at each
    list of ``lists`` (name -> shapes): weights, states, masters, update
    counts bitwise equal, one launch of the instance a step and nothing
    else; the clip clamps at least ``FUSED_CLAMPED`` of each step's
    gradient elements. Returns {instance name: worst max abs error
    (0.0)}."""
    from mxnet_tpu_torch.ops.kernels import multi_tensor as mt
    from mxnet_tpu_torch.optimizer import fused
    errs = {}
    for lname, shapes in lists.items():
        shares = []
        for rule in mt.RULES:
            for form in mt.FORMS:
                name = mt.instance_name(form)
                odd = lname == 'odd'
                mine = fused_setup(torch, optimizer, rule, form, shapes,
                                   device, odd=odd)
                want = fused_setup(torch, optimizer, rule, form, shapes,
                                   device, odd=odd)
                update = fused.FusedUpdate(mine[1], mine[0], mine[2], device)
                if set(update.groups) != {form}:
                    raise AssertionError('fused update: groups %r for %s'
                                         % (update.groups, form))
                for step in range(steps):
                    fused_grads(torch, mine[0], step)
                    fused_grads(torch, want[0], step)
                    shares.append(clamped_share(mine[0], mine[1]))
                    if shares[-1] < FUSED_CLAMPED:
                        raise AssertionError(
                            'fused update %s %s at %s, step %d: the clip '
                            'clamps %.3f of the gradient, under %g'
                            % (rule, form, lname, step, shares[-1],
                               FUSED_CLAMPED))
                    kernels.reset_launch_counts()
                    update()
                    counts = {k: c for k, c in kernels.launch_counts().items()
                              if c}
                    if device.type == 'cuda' and counts != {name: 1}:
                        raise AssertionError('fused update %s %s: launches '
                                             '%r, expected one %s'
                                             % (rule, form, counts, name))
                    plain_update(torch, *want)
                    got = [p for _, p in mine[0]] + _state_tensors(mine[2])
                    ref = [p for _, p in want[0]] + _state_tensors(want[2])
                    for a, b in zip(got, ref):
                        if a.dtype != b.dtype or not torch.equal(a, b):
                            diff = (a.float() - b.float()).abs()
                            raise AssertionError(
                                'fused update %s %s at %s, step %d: not '
                                'bitwise its plain version (%d elements '
                                'differ, max abs %g)'
                                % (rule, form, lname, step,
                                   int((diff > 0).sum()),
                                   diff.max().item()))
                    if mine[1]._index_update_count != \
                            want[1]._index_update_count:
                        raise AssertionError('fused update: update counts '
                                             'differ')
                errs[name] = 0.0
                del mine, want, update
                torch.cuda.empty_cache()
        log('phase 2 fused update at %s (%d tensors, %d elements): every '
            'rule and form bitwise its plain version over %d steps, the '
            'clip clamping %.3f-%.3f of the gradient elements'
            % (lname, len(shapes), sum(math.prod(s) for s in shapes),
               steps, min(shares), max(shares)))
    return errs


def fused_bytes(rule, form, n):
    """Bytes one update of ``n`` elements must move: each input read
    once, each output written once (a master form reads the master, not
    the bf16 weight, and writes both)."""
    w = 4 if form == 'float32' else 2
    s = 2 if form == 'low' else 4
    states = {'sgd': 0, 'sgd_mom': 1, 'adamw': 2}[rule]
    reads = w + (4 if form == 'master' else w) + states * s
    writes = (4 + w if form == 'master' else w) + states * s
    return (reads + writes) * n


FUSED_FLOPS = {'sgd': 5, 'sgd_mom': 7, 'adamw': 16}


def foreach_chain(torch, rule, form, pairs, states, lrs, wds, opt):
    """The update's expressions as a chain of ``torch._foreach_*`` calls
    over the lists (the library yardstick: no one PyTorch call computes
    the function), on the stored dtypes; the master form widens the
    gradients into float32 buffers first and rounds the masters into the
    weights last. Returns the callable."""
    f = torch
    weights = [p.data for _, p in pairs]
    grads = [p.grad for _, p in pairs]
    master = form == 'master'
    if master:
        ws = [s[0] for s in states]
        sts = [s[1] for s in states]
        g32 = [torch.empty_like(w) for w in ws]
    else:
        ws, sts = weights, states
    clip = opt.clip_gradient

    def call():
        if master:
            f._foreach_copy_(g32, grads)
        g = f._foreach_mul(g32 if master else grads, opt.rescale_grad)
        if clip is not None and clip > 0:
            f._foreach_clamp_min_(g, -clip)
            f._foreach_clamp_max_(g, clip)
        if rule == 'adamw':
            m, v = [s[0] for s in sts], [s[1] for s in sts]
            f._foreach_mul_(m, opt.beta1)
            f._foreach_add_(m, f._foreach_mul(g, 1 - opt.beta1))
            f._foreach_mul_(v, opt.beta2)
            f._foreach_add_(v, f._foreach_mul(f._foreach_mul(g, g),
                                              1 - opt.beta2))
            den = f._foreach_sqrt(v)
            f._foreach_add_(den, opt.epsilon)
            step = f._foreach_div(m, den)
            f._foreach_add_(step, f._foreach_mul(ws, wds))
            f._foreach_mul_(step, lrs)
            f._foreach_sub_(ws, step)
        else:
            f._foreach_add_(g, f._foreach_mul(ws, wds))
            if rule == 'sgd_mom':
                f._foreach_mul_(sts, opt.momentum)
                f._foreach_sub_(sts, f._foreach_mul(g, lrs))
                f._foreach_add_(ws, sts)
            else:
                f._foreach_sub_(ws, f._foreach_mul(g, lrs))
        if master:
            f._foreach_copy_(weights, ws)
    return call


def time_fused_update(torch, kernels, optimizer, device, lists):
    """Row 17 at the pairs the trainer phases run (``FUSED_TIMED``): the
    trainer's ``FusedUpdate`` (one launch) timed one event pair a call
    (``ms``) and by the probe's slope (``device_ms``; the host's cost a
    call apart, ``host_ms``), beside its bound (bytes at 3.35 TB/s), the
    plain loop of ``update_multi_precision`` and the ``_foreach_`` chain
    of the same expressions (``chain_ms``; its device time the busy time
    of one call's kernels in a ``torch.profiler`` trace: the slope
    timer's host ran behind the card on it). No one PyTorch call
    computes the update: ``library_ms`` is None. The row of a form is
    BERT-base with AdamW; each timed pair of the form is under
    ``by_list``."""
    from mxnet_tpu_torch.ops.kernels import multi_tensor as mt
    from mxnet_tpu_torch.optimizer import fused
    from mxnet_tpu_torch.tools.probe_matmul_pipeline import slope_ms
    by_form = {}
    for lname, rule, form in FUSED_TIMED:
        name = mt.instance_name(form)
        shapes = lists[lname]
        n = sum(math.prod(s) for s in shapes)
        pairs, opt, states = fused_setup(torch, optimizer, rule, form,
                                         shapes, device)
        fused_grads(torch, pairs, 0, skip=-1)
        update = fused.FusedUpdate(opt, pairs, states, device)
        update()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            update()
        host = (time.perf_counter() - t0) / 5 * 1e3
        lrs, wds, _ = update._hypers()
        chain = foreach_chain(torch, rule, form, pairs, states, lrs, wds,
                              opt)
        t_bytes, by = bound(fused_bytes(rule, form, n),
                            FUSED_FLOPS[rule] * n)
        row = dict(list=lname, rule=rule, tensors=len(shapes),
                   elements=n, host_ms=host,
                   ms=time_ms(torch, update),
                   device_ms=slope_ms(torch, lambda i: update()),
                   plain_ms=time_ms(torch, lambda: plain_update(
                       torch, pairs, opt, states), iters=3, warmup=1),
                   library_ms=None, library_device_ms=None,
                   chain_ms=time_ms(torch, chain, iters=5, warmup=2),
                   chain_device_ms=profile_step(torch, chain,
                                                ())['busy_ms'],
                   bound_ms=t_bytes, bound_by=by,
                   shape='%s list, %s' % (lname, rule))
        by_form.setdefault(name, []).append(row)
        log('time %s [%s] at %s (%d tensors, %d elements), %s: kernel '
            '%.4f ms (device %.4f ms, host %.4f ms a call), plain loop '
            '%.4f ms, _foreach_ chain %.4f ms (device %.4f ms), bound '
            '%.4f ms (%s)'
            % (name, form, lname, len(shapes), n, rule, row['ms'],
               row['device_ms'], host, row['plain_ms'],
               row['chain_ms'], row['chain_device_ms'], t_bytes, by))
        del pairs, opt, states, update, chain
        torch.cuda.empty_cache()
    return {name: dict(rows[0], by_list=rows)
            for name, rows in by_form.items()}


# -- phase 2: the sampler's noise (row 18) ------------------------------------

# (rows, V): the step's 8 slots and the verify's 8 x 4 rows at BERT's vocab,
# a prefill's one row, and odd widths (one element, below a block, one past
# a block, a block and a tail)
NOISE_CASES = ((SLOTS, 30522), (SLOTS * (SPEC_K + 1), 30522), (1, 30522),
               (3, 1), (5, 255), (2, 257), (4, 1000))
NOISE_ULP = 1              # the gumbel values against the plain version
# operations an element: 2 key xors, 2 counter adds, 20 rounds of an add, a
# rotate (two shifts and an or) and an xor, 5 key injections of 3 adds, the
# words' xor, the uniform (shift, or, subtraction, addition, max) and the
# gumbel (2 logarithms, one operation each, and 2 negations); counted at
# the float32 CUDA-core rate, the table's one rate for such work
THREEFRY_OPS = 2 + 2 + 20 * 5 + 5 * 3 + 1 + 5 + 4


# the SM's rates a clock at compute capability 9.0 (the CUDA C++
# Programming Guide's table of arithmetic instruction throughput): 128
# float32 adds, multiplies and FMAs; 64 32-bit integer adds,
# multiply-adds, shifts, compares, selects and logical operations; 16
# special-function (MUFU) operations; and one warp instruction a clock
# from each of the 4 schedulers, 128 thread instructions
H100_SMS = 132
H100_CLOCK_HZ = 1.98e9     # the boost clock the 67 TFLOP/s peak assumes
SASS_RATES = {'fp32': 128, 'int': 64, 'mufu': 16, 'issue': 128}
SASS_CLASSES = {
    'fp32': ('FADD', 'FMUL', 'FFMA', 'FMNMX', 'FSETP', 'FSEL', 'FCHK'),
    'int': ('IADD3', 'IADD', 'IMAD', 'LOP3', 'SHF', 'SHL', 'SHR', 'LEA',
            'ISETP', 'SEL', 'IMNMX', 'PRMT', 'IABS', 'FLO', 'POPC', 'BMSK',
            'ISCADD'),
    'mufu': ('MUFU',)}


def sass_mix(build, source, kernel_key):
    """The instruction mix of the kernel whose name holds ``kernel_key``
    in ``source``'s library (:func:`sass_text`): {class: count} over
    'fp32', 'int', 'mufu' and 'other', NOPs left out. A static count: a
    branch not taken (``logf``'s special cases) counts too."""
    mix, inside = dict.fromkeys(list(SASS_CLASSES) + ['other'], 0), False
    for line in sass_text(build, source).splitlines():
        head = re.search(r'Function : (\S+)', line)
        if head:
            inside = kernel_key in head.group(1)
            continue
        m = re.match(r'\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?'
                     r'([A-Z][A-Z0-9]*)', line)
        if not inside or not m or m.group(1) == 'NOP':
            continue
        cls = next((c for c, ops in SASS_CLASSES.items()
                    if m.group(1) in ops), 'other')
        mix[cls] += 1
    if not sum(mix.values()):
        raise AssertionError('no SASS found for %s in %s' % (kernel_key,
                                                             source))
    return mix


def sass_bound(mix, elements, nbytes):
    """(the least ms, the limit that sets it): each class's instructions
    for ``elements`` threads at its rate, every instruction at the issue
    rate, and ``nbytes`` at 3.35 TB/s."""
    per_s = H100_SMS * H100_CLOCK_HZ
    ms = {c: mix[c] * elements / (SASS_RATES[c] * per_s) * 1e3
          for c in SASS_CLASSES}
    ms['issue'] = sum(mix.values()) * elements / (SASS_RATES['issue']
                                                  * per_s) * 1e3
    ms['bytes'] = nbytes / PEAK_BYTES_S * 1e3
    limit = max(ms, key=ms.get)
    return ms[limit], limit, ms


def noise_keys(torch, rows, device, seed):
    """``rows`` random raw keys as (rows, 2) int32 bits on ``device``."""
    import numpy as np
    keys = np.random.RandomState(seed).randint(
        0, 2 ** 32, size=(rows, 2), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(keys.view(np.int32).copy()).to(device)


def noise_ulps(got, want, u):
    """The largest |got - want| in the gumbel's float32 ULPs, ulp(g) +
    ulp(t) / t with t = -log(u): the output's own ULP plus an ULP of the
    inner logarithm carried through the outer one (near g = 0 two
    logarithms of a t near 1 part by many ULPs of g;
    ``tests/test_torch_sampling.py``)."""
    import numpy as np
    g, w = got.cpu().numpy(), want.cpu().numpy()
    t = (-np.log(u.cpu().numpy().astype(np.float64))).astype(np.float32)
    ulp = np.spacing(np.abs(w)) + np.spacing(t) / t
    return float((np.abs(g - w) / ulp).max())


def check_noise_kernel(torch, noise, device, cases=NOISE_CASES):
    """``threefry_gumbel`` against its plain version on the card: the
    uniforms (its bits, through the uniform) bitwise, the gumbel values
    within ``NOISE_ULP``. Returns the worst absolute gumbel difference."""
    worst = 0.0
    for i, (rows, v) in enumerate(cases):
        keys = noise_keys(torch, rows, device, 18 + i)
        u = noise.threefry_gumbel(keys, v, uniform=True)
        g = noise.threefry_gumbel(keys, v)
        u_ref = noise.threefry_gumbel_reference(keys, v, uniform=True)
        g_ref = noise.threefry_gumbel_reference(keys, v)
        torch.cuda.synchronize()
        if not torch.equal(u, u_ref):
            raise AssertionError('threefry_gumbel (%d, %d): %d uniforms '
                                 'differ from the plain version\'s'
                                 % (rows, v, int((u != u_ref).sum())))
        ulps = noise_ulps(g, g_ref, u)
        err = float((g - g_ref).abs().max())
        if not ulps <= NOISE_ULP:
            raise AssertionError('threefry_gumbel (%d, %d): gumbel %.3g ULPs '
                                 'from the plain version (limit %d)'
                                 % (rows, v, ulps, NOISE_ULP))
        log('threefry_gumbel (%d, %d): uniforms bitwise the plain version\'s, '
            'gumbel within %.3g ULPs (max abs %.3g)' % (rows, v, ulps, err))
        worst = max(worst, err)
    return worst


def time_noise_kernel(torch, noise, device, build, rows=SLOTS, v=30522):
    """The noise kernel at the decode step's (slots, V) and the verify's
    rows: one event pair a call, the slope timer's device time (the keys
    are 64 bytes: nothing to rotate), the plain version; no library call
    computes JAX's threefry gumbel. Its bound counts its SASS (a thread an
    element) at each pipe's rate (:func:`sass_bound`); the float32-rate
    bound of ``THREEFRY_OPS`` an element rides beside it."""
    keys = noise_keys(torch, rows, device, 1)
    nbytes = keys.numel() * 4 + rows * v * 4
    f32_ms, _by = bound(nbytes, rows * v * THREEFRY_OPS)
    mix = sass_mix(build, 'sampling', 'threefry_gumbel_kernel')
    b_ms, limit, by_pipe = sass_bound(mix, rows * v, nbytes)
    b_by = 'bytes' if limit == 'bytes' else 'operations'
    verify = noise_keys(torch, rows * (SPEC_K + 1), device, 2)
    return {'threefry_gumbel': dict(
        ms=time_ms(torch, lambda: noise.threefry_gumbel(keys, v)),
        device_ms=device_ms(torch, lambda: noise.threefry_gumbel(keys, v),
                            ()),
        plain_ms=time_ms(torch,
                         lambda: noise.threefry_gumbel_reference(keys, v)),
        library_ms=None, library_device_ms=None, bound_ms=b_ms,
        bound_by=b_by, bound_pipe=limit, bound_by_pipe_ms=by_pipe,
        sass_mix=mix, bound_f32_rate_ms=f32_ms,
        shape='keys (%d, 2) V %d' % (rows, v),
        by_shape={'verify (%d, %d)' % (verify.shape[0], v): device_ms(
            torch, lambda: noise.threefry_gumbel(verify, v), ())})}


# -- phase 3: the serving slice ----------------------------------------------


def percentile(vals, p):
    vals = sorted(vals)
    i = min(len(vals) - 1, max(0, int(round(p / 100.0 * (len(vals) - 1)))))
    return vals[i]


def check_programs(phase, prog, want, capture):
    """A decode program after the engine's ``warmup()``: its
    ``compile_seconds`` keys are the reference's set ``want`` and, when
    ``capture``, each is a CUDA graph. Returns the capture seconds."""
    got = dict(prog.compile_seconds)
    if sorted(got) != sorted(want) or prog.compile_count != len(want):
        raise AssertionError('%s: warmup built %r (%d programs), expected '
                             'the reference\'s set %r' % (
                                 phase, sorted(got), prog.compile_count,
                                 sorted(want)))
    if capture and prog.device.type == 'cuda' and not all(
            b.prog.graph is not None for b in prog._compiled.values()):
        raise AssertionError('%s: a program is not a CUDA graph' % phase)
    return got


def program_set(buckets, paged=False, spec_k=0):
    """The reference's warm-up set: the ladder and the step, for a paged
    program the page copy and, under speculation, the verify."""
    return (['prefill:%d' % b for b in buckets] + ['step']
            + (['copy'] if paged else [])
            + (['verify:%d' % (spec_k + 1)] if spec_k else []))


# the captured decode step's profile groups
DECODE_GROUPS = (('decode kernel', ('flash_decode', 'flash_paged'), ()),
                 ('sampling noise kernel', ('threefry',), ()),
                 ('sampling sort and scan', ('radix', 'sort', 'scan'), ()),
                 ('GEMMs', ('gemm', 'gemv', 'xmma', 'cutlass', 'nvjet'), ()),
                 ('copies', ('memcpy', 'memset'), ()))


def time_step(torch, prog, cache, args, iters=20):
    """``prog.run_step`` on ``args`` (after 3 untimed calls): the mean
    of ``iters`` CUDA-event pairs (host work, the copy in and the copy
    back included), and a profiled call (:func:`profile_step`)."""
    for _ in range(3):
        prog.run_step(cache, *args)
    ms = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        prog.run_step(cache, *args)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return statistics.mean(ms), profile_step(
        torch, lambda: prog.run_step(cache, *args), DECODE_GROUPS)


def assert_healthy(phase, sess, streams=()):
    """A healthy serving run degraded nothing: the session reads ``ok``
    with its breaker closed, no token came from the CPU fallback (a
    one-shot session: no fallback batch) and no stream is marked
    degraded. Returns the status record."""
    st = sess.status()
    fallback = st['decode']['counts']['fallback_tokens'] \
        if st['mode'] == 'decode' else st['batches']['fallback']
    degraded = [i for i, s in enumerate(streams) if s.degraded]
    if st['status'] != 'ok' or st['breaker'] != 'closed' or fallback \
            or degraded:
        raise AssertionError('%s: a healthy run degraded: status %s, breaker '
                             '%s, %d fallback, degraded streams %s, error %s'
                             % (phase, st['status'], st['breaker'], fallback,
                                degraded, st['error']))
    return st


def serve(torch, serving, kernels, device, cfg=SLICE, slots=SLOTS,
          buckets=BUCKETS, requests=REQUESTS, new_tokens=NEW_TOKENS,
          prompt_range=(8, 256), recheck=2, seed=0, paged=False,
          capture=True):
    """Drive the slice through its entry points and check it: over the
    slot cache (``paged=False``, phase 3) or over the default,
    ``freeze_decode``'s paged cache at page size 16 (phase 3p). The
    session's engine builds the reference's program set as it starts
    (CUDA graphs; ``capture=False``: the same bodies uncaptured, the
    eager reference), and no request may build another. Returns a dict
    of results (tokens and launch counts of the run, the programs'
    capture seconds, and for a captured run the step's time and
    profile)."""
    import numpy as np
    phase = 'phase 3p' if paged else 'phase 3'
    t0 = time.perf_counter()
    model, params = serving.init_transformer_lm(seed=seed, **cfg)
    if paged:
        prog = serving.freeze_decode(model, params, slots=slots,
                                     prefill_buckets=buckets, device=device)
        if not (isinstance(prog, serving.PagedDecodeProgram)
                and prog.page_size == PAGE_SIZE):
            raise AssertionError('freeze_decode did not page the model: %r'
                                 % (prog,))
    else:
        prog = serving.freeze_decode(model, params, slots=slots,
                                     prefill_buckets=buckets, paged=False,
                                     device=device)
    prog.capture = capture
    del params
    setup_s = time.perf_counter() - t0
    rs = np.random.RandomState(seed)
    lens = rs.randint(prompt_range[0], prompt_range[1] + 1, size=requests)
    prompts = [rs.randint(0, cfg['vocab'], size=n).tolist() for n in lens]
    t0 = time.perf_counter()
    with serving.InferenceSession(prog, timeout_s=600,
                                  max_new_tokens=new_tokens) as sess:
        warm_s = time.perf_counter() - t0
        seconds = check_programs(phase, prog, program_set(buckets, paged),
                                 capture)
        # warm-up request (library handles, allocator) before the run
        sess.generate(prompts[0][:8], max_new_tokens=2).result(600)
        before = sess.stats()['counts']
        if device.type == 'cuda':
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t1 = time.perf_counter()
        streams = [sess.generate(p) for p in prompts]
        outs = [s.result(600) for s in streams]
        wall = time.perf_counter() - t1
        launches = kernels.launch_counts()
        stats = sess.stats()
        after = stats['counts']
        assert_healthy(phase, sess, streams)
    if prog.compile_count != len(seconds):
        raise AssertionError('%s: a request built a program (%d after the '
                             'run, %d after warmup)' % (
                                 phase, prog.compile_count, len(seconds)))
    prefills = after['prefills'] - before['prefills']
    steps = after['steps'] - before['steps']
    step_s = after['step_seconds'] - before['step_seconds']
    if prefills != requests:
        raise AssertionError('%d prefills for %d requests'
                             % (prefills, requests))
    for out, s in zip(outs, streams):
        if len(out) != new_tokens or s.finish_reason != 'length':
            raise AssertionError('a request ended early: %d tokens, %s'
                                 % (len(out), s.finish_reason))
        if not all(0 <= t < cfg['vocab'] for t in out):
            raise AssertionError('token outside the vocabulary')
    if device.type == 'cuda':
        want = dict.fromkeys(launches, 0)
        want['flash_attention_fwd'] = cfg['layers'] * prefills
        want['flash_paged_decode_fwd' if paged
             else 'flash_decode_fwd'] = cfg['layers'] * steps
        # the knob's default programs sample: one noise launch a call
        want['threefry_gumbel'] = prefills + steps
        if launches != want:
            raise AssertionError('kernel launches %r, expected %r '
                                 '(layers x prefills, layers x steps, a '
                                 'noise launch a call)' % (launches, want))
    # cached tokens against the uncached forward after every token
    # (teacher-forced on the served stream, so a tie at one position
    # does not void the positions after it)
    equal, ties = 0, []
    with torch.inference_mode():
        for r in range(recheck):
            prompt, out = prompts[r], outs[r]
            for t in range(len(out)):
                toks = torch.tensor([prompt + out[:t]], device=device)
                logits = model.full_forward(prog.params, toks)[0, -1]
                if not bool(torch.isfinite(logits).all()):
                    raise AssertionError('non-finite logits')
                top2 = torch.topk(logits, 2)
                best = int(top2.indices[0])
                if best == out[t]:
                    equal += 1
                    continue
                gap = abs(float(logits[best]) - float(logits[out[t]]))
                if not gap < TIE:
                    raise AssertionError(
                        'request %d token %d: cached %d, full_forward %d, '
                        'logit gap %.3g is no tie' % (r, t, out[t], best, gap))
                ties.append((r, t, gap))
    ttft = [s.ttft_s for s in streams]
    step_ms = step_prof = None
    if device.type == 'cuda':
        # one step at phase 2's positions, the slots' pages in order
        cache = prog.new_cache()
        args = [np.zeros(slots, 'int32'),
                np.asarray(DECODE_POSITIONS[:slots], 'int32')]
        if paged:
            args.append(1 + np.arange(slots * prog.max_pages, dtype='int32')
                        .reshape(slots, prog.max_pages))
        step_ms, step_prof = time_step(torch, prog, cache, args)
    return {
        'setup_s': setup_s, 'wall_s': wall, 'prefills': prefills,
        'warmup_s': warm_s, 'compile_seconds': seconds,
        'replay_step_ms': step_ms, 'step_profile': step_prof,
        'steps': steps, 'launches': launches,
        'tokens': sum(len(o) for o in outs),
        'tokens_per_s': sum(len(o) for o in outs) / wall,
        'ttft_p50_ms': percentile(ttft, 50) * 1e3,
        'ttft_p99_ms': percentile(ttft, 99) * 1e3,
        'decode_step_ms': step_s / steps * 1e3 if steps else None,
        'recheck_equal': equal, 'recheck_ties': ties,
        'peak_mem_bytes': (torch.cuda.max_memory_allocated()
                           if device.type == 'cuda' else None),
        'cache_bytes': prog.cache_bytes(),
        'prompt_lens': [int(n) for n in lens], 'outs': outs,
        'cache_accounting': stats['cache'], 'pages': stats.get('pages'),
        'counts': {k: after[k] - before[k] for k in (
            'prefix_hits', 'cow_copies', 'page_evictions')},
    }


def teacher_forced(torch, model, params, prompts, outs, device):
    """Each served token against ``full_forward`` over the prompt and
    the served tokens before it (one forward a request; causal, so
    position i sees tokens <= i only): the token must be the forward's
    argmax, or tie with it within ``TIE``. Returns (tokens equal, ties
    [(request, token, gap)])."""
    equal, ties = 0, []
    with torch.inference_mode():
        for r, (prompt, out) in enumerate(zip(prompts, outs)):
            toks = torch.tensor([list(prompt) + out[:-1]], device=device)
            logits = model.full_forward(params, toks)[0, len(prompt) - 1:]
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError('non-finite logits')
            best = logits.argmax(dim=-1).tolist()
            for t, (b, o) in enumerate(zip(best, out)):
                if b == o:
                    equal += 1
                    continue
                gap = abs(float(logits[t, b]) - float(logits[t, o]))
                if not gap < TIE:
                    raise AssertionError(
                        'request %d token %d: served %d, full_forward %d, '
                        'logit gap %.3g is no tie' % (r, t, o, b, gap))
                ties.append((r, t, gap))
    return equal, ties


def shared_prompts(cfg, requests=REQUESTS, slots=SLOTS, seed=0,
                   prefix_tokens=PREFIX_TOKENS, suffix_range=SUFFIX_RANGE):
    """Phase 3s's prefix-sharing prompts: ``requests`` prompts of one
    ``prefix_tokens``-token prefix and a suffix each, the prefix alone
    twice after the first ``slots`` of them; and the generator, drawn
    that far (3s's warm-up prompt comes from it)."""
    import numpy as np
    rs = np.random.RandomState(seed + 1)
    prefix = rs.randint(0, cfg['vocab'], prefix_tokens).tolist()
    shared = [prefix + rs.randint(0, cfg['vocab'], n).tolist()
              for n in rs.randint(suffix_range[0], suffix_range[1] + 1,
                                  requests)]
    return shared[:slots] + [prefix, prefix] + shared[slots:], rs


def serve_shared(torch, serving, kernels, device, cfg=SLICE, slots=SLOTS,
                 buckets=BUCKETS, requests=REQUESTS, new_tokens=NEW_TOKENS,
                 seed=0, spec_k=SPEC_K, prefix_tokens=PREFIX_TOKENS,
                 suffix_range=SUFFIX_RANGE, prompt_range=(8, 256),
                 capture=True, recheck=True):
    """Phase 3s at the slice's width, through ``freeze_decode``'s paged
    default. Prefix sharing: ``requests`` prompts of one
    ``prefix_tokens``-token prefix and a distinct suffix of
    ``suffix_range`` tokens each, and the prefix alone sent twice amid
    them (its last prompt token is re-fed into the prefix's last page
    while the other sharers hold it: a copy on write); every request
    after the first must hit. Speculative decoding: phase 3's prompts with
    ``spec_k`` proposals a tick from a self-draft (the same weights frozen
    ``paged=False``); acceptance >= ``SPEC_ACCEPTANCE`` and fewer ticks
    than tokens. Launch counts exact in both runs; every token
    teacher-forced against ``full_forward`` (:func:`teacher_forced`), since
    a suffix streamed through decode steps and the verify pass run other
    GEMM shapes than the prefill and step they replace. The programs of
    the target and the draft are built as the session starts (CUDA
    graphs; ``capture=False``: uncaptured, the eager reference) and no
    request builds another; ``recheck=False`` skips the teacher
    forcing."""
    import numpy as np
    layers = cfg['layers']
    model, params = serving.init_transformer_lm(seed=seed, **cfg)
    shared, rs = shared_prompts(cfg, requests, slots, seed, prefix_tokens,
                                suffix_range)
    phase3 = np.random.RandomState(seed)     # phase 3's prompts
    lens = phase3.randint(prompt_range[0], prompt_range[1] + 1,
                          size=requests)
    plain = [phase3.randint(0, cfg['vocab'], size=n).tolist() for n in lens]
    out = {}
    for run, prompts in (('prefix', shared), ('spec', plain)):
        prog = serving.freeze_decode(
            model, params, slots=slots, prefill_buckets=buckets,
            spec_k=spec_k if run == 'spec' else None, device=device)
        prog.capture = capture
        draft = None
        if run == 'spec':
            draft = serving.freeze_decode(model, params, slots=slots,
                                          prefill_buckets=buckets,
                                          paged=False, device=device)
            draft.capture = capture
        with serving.InferenceSession(prog, timeout_s=600, draft=draft,
                                      max_new_tokens=new_tokens) as sess:
            seconds = check_programs(
                'phase 3s %s' % run, prog, program_set(
                    buckets, True, spec_k if run == 'spec' else 0), capture)
            if draft is not None:
                seconds.update({'draft ' + k: v for k, v in check_programs(
                    'phase 3s draft', draft, program_set(buckets),
                    capture).items()})
            sess.generate(rs.randint(0, cfg['vocab'], 8).tolist(),
                          max_new_tokens=2).result(600)
            before = sess.stats()['counts']
            kernels.reset_launch_counts()
            t1 = time.perf_counter()
            streams = [sess.generate(p) for p in prompts]
            outs = [s.result(600) for s in streams]
            wall = time.perf_counter() - t1
            launches = kernels.launch_counts()
            stats = sess.stats()
            assert_healthy('phase 3s %s' % run, sess, streams)
        if prog.compile_count + (draft.compile_count if draft else 0) \
                != len(seconds):
            raise AssertionError('phase 3s %s: a request built a program'
                                 % run)
        c = {k: v - before[k] for k, v in stats['counts'].items()
             if k != 'retired'}
        if any(len(o) != new_tokens for o in outs):
            raise AssertionError('phase 3s %s: a request ended early' % run)
        want = dict.fromkeys(launches, 0)
        plain_steps = c['steps'] - c['spec_rounds']
        # the draft prefills every admission, a prefix hit included
        want['flash_attention_fwd'] = layers * (
            c['prefills'] + (c['prefills'] + c['prefix_hits'] if draft
                             else 0))
        want['flash_paged_decode_fwd'] = layers * plain_steps
        want['flash_decode_fwd'] = layers * (
            plain_steps + (spec_k + 1) * c['spec_rounds'] if draft else 0)
        # one noise launch a call of the target's and the draft's programs
        want['threefry_gumbel'] = c['prefills'] + c['steps'] + (
            c['prefills'] + c['prefix_hits'] + plain_steps
            + (spec_k + 1) * c['spec_rounds'] if draft else 0)
        if device.type == 'cuda' and launches != want:
            raise AssertionError('phase 3s %s: kernel launches %r, expected '
                                 '%r' % (run, launches, want))
        if run == 'prefix' and not (c['prefix_hits'] >= requests - 1
                                    and c['cow_copies'] >= 1
                                    and c['prefills'] == 1):
            raise AssertionError('phase 3s prefix: %d hits, %d copies on '
                                 'write, %d prefills' % (
                                     c['prefix_hits'], c['cow_copies'],
                                     c['prefills']))
        acceptance = (c['spec_accepted'] / c['spec_proposed']
                      if c['spec_proposed'] else None)
        tokens = sum(len(o) for o in outs)
        if run == 'spec' and not (acceptance is not None
                                  and acceptance >= SPEC_ACCEPTANCE
                                  and c['steps'] < tokens):
            raise AssertionError('phase 3s spec: acceptance %r, %d ticks for '
                                 '%d tokens' % (acceptance, c['steps'],
                                                tokens))
        equal, ties = teacher_forced(torch, model, prog.params, prompts,
                                     outs, device) if recheck else (0, [])
        ttft = [s.ttft_s for s in streams]
        out[run] = dict(
            outs=outs, compile_seconds=seconds,
            counts=c, launches=launches, tokens=tokens, wall_s=wall,
            tokens_per_s=tokens / wall, acceptance=acceptance,
            ttft_p50_ms=percentile(ttft, 50) * 1e3,
            ttft_p99_ms=percentile(ttft, 99) * 1e3,
            step_ms=c['step_seconds'] / c['steps'] * 1e3,
            recheck_equal=equal, recheck_ties=ties,
            cache_accounting=stats['cache'], pages=stats['pages'])
        del prog, draft
    return out


# -- phase 3a: sampled decoding and adapters ---------------------------------

ADAPTER_RANK = 8
ADAPTER_SLOTS = 8          # 7 rows beside the base: 8 adapters evict
ADAPTERS = 8
# the delta's scale (init_adapter's is 1.0): at BERT-base width and 1.0 a
# rank-8 adapter of 0.05-std A and B left one greedy 32-token stream equal
# to its base twin; at 50 (tests/test_adapters.py's, for a tiny model) the
# adapted model is so ill-conditioned that the verify pass's logits part
# from the step's by 3e-4, where they part by 7e-6 on the base and 9.5e-6
# at 10 (measured on an H100)
ADAPTER_SCALE = 10.0
SAMPLE_TEMP = 0.8
SAMPLE_TOP_P = 0.9
EXTRA_PROMPTS = 8
# request i is of kind KINDS[i % 4], (adapter, sampled): greedy base,
# greedy adapter, sampled base, sampled adapter
KINDS = ((False, False), (True, False), (False, True), (True, True))
SAMPLED_ACCEPTANCE = 0.9   # the self-draft's, on sampled base traffic


def adapter_requests(cfg, requests=REQUESTS, extra=EXTRA_PROMPTS,
                     prompt_range=(8, 256), seed=0):
    """Phase 3p's prompts (drawn as :func:`serve` draws them) and ``extra``
    more from the same range, request i of kind ``KINDS[i % 4]``: dicts of
    prompt, adapter id (the adapter requests take ``ad0``, ``ad1``, ... in
    turn) or None, temperature, top_p and seed i."""
    import numpy as np
    rs = np.random.RandomState(seed)
    lens = rs.randint(prompt_range[0], prompt_range[1] + 1, size=requests)
    prompts = [rs.randint(0, cfg['vocab'], size=n).tolist() for n in lens]
    more = np.random.RandomState(seed + 3)
    prompts += [more.randint(0, cfg['vocab'], size=n).tolist()
                for n in more.randint(prompt_range[0], prompt_range[1] + 1,
                                      size=extra)]
    out, n_ad = [], 0
    for i, prompt in enumerate(prompts):
        adapted, sampled = KINDS[i % len(KINDS)]
        aid = None
        if adapted:
            aid, n_ad = 'ad%d' % (n_ad % ADAPTERS), n_ad + 1
        out.append(dict(prompt=prompt, adapter=aid,
                        temperature=SAMPLE_TEMP if sampled else 0.0,
                        top_p=SAMPLE_TOP_P if sampled else 1.0, seed=i))
    return out


def phase3a_adapters(adapters_mod, model):
    """3a's ``ADAPTERS`` adapters of rank ``ADAPTER_RANK``, ids ``ad0``,
    ``ad1``, ..., from seeds 0, 1, ..."""
    return {'ad%d' % i: adapters_mod.init_adapter(model, ADAPTER_RANK, seed=i,
                                                  scale=ADAPTER_SCALE)
            for i in range(ADAPTERS)}


def adapter_registry(adapters_mod, prog, ads):
    """A registry of the adapters ``ads`` over a pool of ``prog``'s
    geometry (the engine binds the pool to the program's)."""
    reg = adapters_mod.AdapterRegistry(
        adapters_mod.AdapterPool(prog.adapter_spec))
    for name, ad in ads.items():
        reg.register(name, ad)
    return reg


def generate_all(sess, reqs, new_tokens):
    """Every request of ``reqs`` through ``sess`` at once; their tokens.
    A healthy run: no stream may come back degraded."""
    streams = [sess.generate(r['prompt'], max_new_tokens=new_tokens,
                             adapter=r['adapter'],
                             temperature=r['temperature'], top_p=r['top_p'],
                             seed=r['seed']) for r in reqs]
    outs = [s.result(600) for s in streams]
    assert_healthy('phase 3a', sess, streams)
    return outs


def perturbed_margin(torch, model, params, registry, req, out, t, device):
    """The gap between the two top perturbed scores at token ``t`` of the
    sampled stream ``out`` of ``req``: ``full_forward`` over the prompt and
    ``out[:t]`` (the request's adapter applied), then the sampler's scores
    under the key of that position."""
    import numpy as np
    from mxnet_tpu_torch.serving.decode.sampling import (key_for,
                                                         perturbed_scores)
    ad = None
    if req['adapter'] is not None:
        ad = {k: (torch.from_numpy(a).to(device), torch.from_numpy(b)
                  .to(device))
              for k, (a, b) in registry.host_tree(req['adapter']).items()}
    with torch.inference_mode():
        toks = torch.tensor([req['prompt'] + out[:t]], device=device)
        logits = model.full_forward(params, toks, ad)[0, -1:]
        key = key_for(req['seed'], len(req['prompt']) - 1 + t)
        scores = perturbed_scores(
            logits, torch.tensor([req['temperature']], device=device),
            torch.tensor([req['top_p']], device=device),
            torch.from_numpy(key.view(np.int32)[None].copy()).to(device))
        top2 = torch.topk(scores[0], 2).values
    return float(top2[0] - top2[1])


def step_turns(torch, progs, slots=SLOTS, turns=2):
    """Each program's replayed ``run_step`` (:func:`time_step`) at phase
    2's positions, in turns (first to last, then back): {name: (mean ms
    over the turns, the profile of its first turn)}."""
    import numpy as np
    got = {name: ([], None) for name in progs}
    order = list(progs) + list(progs)[::-1]
    for name in order * (turns // 2):
        prog = progs[name]
        args = [np.zeros(slots, 'int32'),
                np.asarray(DECODE_POSITIONS[:slots], 'int32'),
                1 + np.arange(slots * prog.max_pages, dtype='int32')
                .reshape(slots, prog.max_pages)]
        ms, prof = time_step(torch, prog, prog.new_cache(), args)
        times, first = got[name]
        got[name] = (times + [ms], first or prof)
    return {name: (statistics.mean(t), prof) for name, (t, prof) in
            got.items()}


def serve_adapters(torch, serving, kernels, device, base_outs, cfg=SLICE,
                   slots=SLOTS, buckets=BUCKETS, new_tokens=NEW_TOKENS,
                   seed=0, spec_k=SPEC_K):
    """Phase 3a at the slice's width through ``freeze_decode``'s paged
    default with sampling and an adapter pool of ``ADAPTER_SLOTS`` rows of
    rank ``ADAPTER_RANK``: :func:`adapter_requests` (24 requests of four
    kinds over 8 adapters) through the captured programs, then checked:
    the program set built at start and no other; the greedy base streams
    on phase 3p's prompts equal to ``base_outs``; the same requests
    through the same bodies uncaptured, token for token; every adapter
    stream unlike its base twin (the same request on the base); exact
    launches; an eviction. Then the sampled requests through a
    speculative session (``spec_k`` proposals from a self-draft, sampled
    base traffic first, then sampled adapter traffic), equal to the plain
    streams but at near-ties; a program with the logit mask; and the
    replayed step without extras, with sampling and with sampling and
    adapters, in turns."""
    from mxnet_tpu_torch.serving import adapters as adapters_mod
    layers = cfg['layers']
    model, params = serving.init_transformer_lm(seed=seed, **cfg)
    reqs = adapter_requests(cfg)
    ads = phase3a_adapters(adapters_mod, model)

    def build(capture=True, spec=0, rank=ADAPTER_RANK, **kw):
        prog = serving.freeze_decode(
            model, params, slots=slots, prefill_buckets=buckets,
            spec_k=spec, adapter_rank=rank, adapter_slots=ADAPTER_SLOTS,
            device=device, **kw)
        prog.capture = capture
        return prog

    def registry(prog):
        return adapter_registry(adapters_mod, prog, ads)

    runs = {}
    for capture in (True, False):
        prog = build(capture, sample_args=True)
        reg = registry(prog)
        with serving.InferenceSession(prog, timeout_s=600, adapters=reg,
                                      max_new_tokens=new_tokens) as sess:
            seconds = check_programs('phase 3a', prog,
                                     program_set(buckets, True), capture)
            sess.generate(reqs[0]['prompt'][:8], max_new_tokens=2).result(600)
            before = sess.stats()['counts']
            kernels.reset_launch_counts()
            t1 = time.perf_counter()
            outs = generate_all(sess, reqs, new_tokens)
            wall = time.perf_counter() - t1
            launches = kernels.launch_counts()
            after = sess.stats()['counts']
            twins = generate_all(sess, [dict(r, adapter=None) for r in reqs
                                        if r['adapter']], new_tokens) \
                if capture else None
        if prog.compile_count != len(seconds):
            raise AssertionError('phase 3a: a request built a program (%d '
                                 'after the mix, %d after warmup)'
                                 % (prog.compile_count, len(seconds)))
        c = {k: v - before[k] for k, v in after.items() if k != 'retired'}
        runs[capture] = dict(outs=outs, launches=launches, counts=c,
                             wall_s=wall, compile_seconds=seconds,
                             pool=reg.pool.stats(), twins=twins)
        del prog, reg
        torch.cuda.empty_cache()
    got, eager = runs[True], runs[False]
    c = got['counts']
    if got['outs'] != eager['outs'] or got['launches'] != eager['launches']:
        raise AssertionError('phase 3a: the captured programs served other '
                             'tokens (requests %s) or launches than the '
                             'eager bodies' % [
                                 i for i, (a, b) in enumerate(zip(
                                     got['outs'], eager['outs'])) if a != b])
    want = dict.fromkeys(got['launches'], 0)
    want['flash_attention_fwd'] = layers * c['prefills']
    want['flash_paged_decode_fwd'] = layers * c['steps']
    want['threefry_gumbel'] = c['prefills'] + c['steps']
    if device.type == 'cuda' and got['launches'] != want:
        raise AssertionError('phase 3a: kernel launches %r, expected %r'
                             % (got['launches'], want))
    sampled = [i for i, r in enumerate(reqs) if r['temperature'] > 0]
    if c['adapter_rejects'] or c['sampled_tokens'] != \
            len(sampled) * new_tokens:
        raise AssertionError('phase 3a: %d adapter rejects, %d sampled '
                             'tokens' % (c['adapter_rejects'],
                                         c['sampled_tokens']))
    if any(len(o) != new_tokens for o in got['outs']):
        raise AssertionError('phase 3a: a request ended early')
    greedy_base = [i for i, r in enumerate(reqs)
                   if i < len(base_outs) and r['adapter'] is None
                   and r['temperature'] == 0]
    if any(got['outs'][i] != base_outs[i] for i in greedy_base):
        raise AssertionError('phase 3a: greedy base streams differ from '
                             'phase 3p\'s on its prompts %s' % greedy_base)
    adapted = [i for i, r in enumerate(reqs) if r['adapter']]
    same = [i for i, twin in zip(adapted, got['twins'])
            if got['outs'][i] == twin]
    if same:
        raise AssertionError('phase 3a: adapter streams equal to their base '
                             'twins: requests %s' % same)
    if got['pool']['evictions'] < 1:
        raise AssertionError('phase 3a: no adapter was evicted: %r'
                             % got['pool'])

    # sampled speculation: sampled base traffic, then sampled adapters
    prog = build(spec=spec_k, sample_args=True)
    draft = serving.freeze_decode(model, params, slots=slots,
                                  prefill_buckets=buckets, paged=False,
                                  device=device)
    reg = registry(prog)
    spec, acceptance = {}, {}
    with serving.InferenceSession(prog, timeout_s=600, adapters=reg,
                                  draft=draft,
                                  max_new_tokens=new_tokens) as sess:
        built = check_programs('phase 3a spec', prog,
                               program_set(buckets, True, spec_k), True)
        check_programs('phase 3a draft', draft, program_set(buckets), True)
        for kind in ('base', 'adapter'):
            idx = [i for i in sampled
                   if (reqs[i]['adapter'] is None) == (kind == 'base')]
            before = sess.stats()['counts']
            outs = generate_all(sess, [reqs[i] for i in idx], new_tokens)
            after = sess.stats()['counts']
            spec.update(zip(idx, outs))
            proposed = after['spec_proposed'] - before['spec_proposed']
            acceptance[kind] = ((after['spec_accepted']
                                 - before['spec_accepted']) / proposed
                                if proposed else None)
    if prog.compile_count != len(built) or draft.compile_count != \
            len(buckets) + 1:
        raise AssertionError('phase 3a spec: a request built a program')
    if not (acceptance['base'] or 0) >= SAMPLED_ACCEPTANCE:
        raise AssertionError('phase 3a spec: sampled acceptance %r with the '
                             'self-draft' % acceptance)
    ties, differ = [], []
    for i in sampled:
        plain_out, spec_out = got['outs'][i], spec[i]
        t = next((t for t, (a, b) in enumerate(zip(plain_out, spec_out))
                  if a != b), None)
        if t is None:
            continue
        gap = perturbed_margin(torch, model, prog.params, reg, reqs[i],
                               plain_out, t, device)
        if not gap < TIE:
            differ.append((i, t, gap))
        ties.append((i, t, gap))
    if differ:
        raise AssertionError('phase 3a spec: sampled speculation parts from '
                             'plain sampling where the perturbed scores are '
                             'no tie: %s' % differ)
    del prog, draft, reg
    torch.cuda.empty_cache()

    # the logit mask, through the program: the odd token ids forbidden
    import numpy as np
    prog = build(rank=0, logit_mask=True).warmup()
    n = prog.compile_count
    V = cfg['vocab']
    odd = np.where(np.arange(V) % 2 == 1, -np.inf, 0.0).astype('float32')
    masks = np.stack([odd] * slots)
    cache = prog.new_cache()
    tables = 1 + np.arange(slots * prog.max_pages, dtype='int32') \
        .reshape(slots, prog.max_pages)
    temps = np.where(np.arange(slots) % 2, SAMPLE_TEMP, 0.0) \
        .astype('float32')
    from mxnet_tpu_torch.serving.decode.sampling import key_for
    toks, pos = np.zeros(slots, 'int32'), np.zeros(slots, 'int32')
    masked = []
    for s in range(slots):
        prompt = reqs[s]['prompt']
        npages = -(-len(prompt) // prog.page_size)
        _, toks[s], _ = prog.run_prefill(
            cache, prompt, list(tables[s, :npages]), temps=temps[s:s + 1],
            top_ps=[SAMPLE_TOP_P], keys=key_for(s, len(prompt) - 1)[None],
            masks=odd[None])
        pos[s] = len(prompt)
    masked.append(toks.copy())
    for _ in range(8):
        keys = np.stack([key_for(s, pos[s]) for s in range(slots)])
        _, out, _ = prog.run_step(cache, toks, pos, tables, temps=temps,
                                  top_ps=np.full(slots, SAMPLE_TOP_P,
                                                 'float32'),
                                  keys=keys, masks=masks)
        toks, pos = np.asarray(out, 'int32'), pos + 1
        masked.append(toks.copy())
    masked = np.stack(masked)
    if (masked % 2).any() or prog.compile_count != n:
        raise AssertionError('phase 3a mask: forbidden tokens %s, programs '
                             '%d -> %d' % (masked[masked % 2 == 1].tolist(),
                                           n, prog.compile_count))
    del prog
    torch.cuda.empty_cache()

    # the replayed step without extras, with sampling, with sampling and
    # adapters, in turns
    step = step_turns(torch, {'no extras': build(rank=0, sample_args=False),
                              'sampling': build(rank=0, sample_args=True),
                              'sampling + adapters': build(
                                  sample_args=True)})
    torch.cuda.empty_cache()
    tokens = sum(len(o) for o in got['outs'])
    return dict(
        outs=got['outs'], launches=got['launches'], counts=c,
        compile_seconds=got['compile_seconds'], pool=got['pool'],
        eager_pool=eager['pool'], tokens=tokens,
        tokens_per_s=tokens / got['wall_s'], wall_s=got['wall_s'],
        eager_tokens_per_s=tokens / eager['wall_s'],
        kinds={k: sum(1 for r in reqs if (r['adapter'] is not None,
                                          r['temperature'] > 0) == k)
               for k in KINDS},
        greedy_base=greedy_base, acceptance=acceptance, spec_ties=ties,
        masked_tokens=int(masked.size), step=step)


# -- phase 3f: the degraded path ----------------------------------------------

DEGRADED_REQUESTS = 8
DEGRADED_TOKENS = 16
DEGRADED_TOP_P = 0.95
# the device op the mid-stream faults fire at: after the 8 prefills and at
# least 2 steps however the engine interleaves them (at worst one prefill
# and one step a tick: the last prefill is op 14), before any stream ends
# (a stream needs 15 steps)
TRIP_OP = 2 * DEGRADED_REQUESTS + 1
BREAKER_RESET_S = 2.0


def degraded_requests(cfg, seed=0):
    """Phase 3p's first 8 prompts (:func:`serve`'s draws), request i
    greedy when i is even, else sampled at ``SAMPLE_TEMP`` / top-p
    ``DEGRADED_TOP_P``; seed i."""
    import numpy as np
    rs = np.random.RandomState(seed)
    lens = rs.randint(8, 257, size=REQUESTS)
    prompts = [rs.randint(0, cfg['vocab'], size=n).tolist() for n in lens]
    return [dict(prompt=p, adapter=None, seed=i,
                 temperature=SAMPLE_TEMP if i % 2 else 0.0,
                 top_p=DEGRADED_TOP_P if i % 2 else 1.0)
            for i, p in enumerate(prompts[:DEGRADED_REQUESTS])]


def submit(sess, reqs):
    return [sess.generate(r['prompt'], max_new_tokens=DEGRADED_TOKENS,
                          temperature=r['temperature'], top_p=r['top_p'],
                          seed=r['seed']) for r in reqs]


def near_ties(torch, model, params, reqs, outs, want, device, sub,
              phase='phase 3f'):
    """Each stream of ``outs`` against its healthy tokens ``want``: at
    the first token that differs, the teacher-forced margin over the
    prompt and the healthy tokens before it (the top-2 logit gap of a
    greedy stream, the top-2 perturbed scores of a sampled one,
    :func:`perturbed_margin`) must lie below ``TIE``. Returns the near
    ties [(request, token, gap)]."""
    ties = []
    for i, (req, got, ref) in enumerate(zip(reqs, outs, want)):
        if len(got) != len(ref):
            raise AssertionError('%s %s: request %d has %d tokens, '
                                 'healthy %d' % (phase, sub, i, len(got),
                                                 len(ref)))
        t = next((t for t, (a, b) in enumerate(zip(got, ref)) if a != b),
                 None)
        if t is None:
            continue
        if req['temperature'] > 0:
            gap = perturbed_margin(torch, model, params, None, req, ref, t,
                                   device)
        else:
            with torch.inference_mode():
                toks = torch.tensor([req['prompt'] + ref[:t]], device=device)
                top2 = torch.topk(model.full_forward(params, toks)[0, -1],
                                  2).values
            gap = float(top2[0] - top2[1])
        if not gap < TIE:
            raise AssertionError('%s %s: request %d token %d is %d '
                                 'degraded, %d healthy, and the margin %.3g '
                                 'is no tie' % (phase, sub, i, t, got[t],
                                                ref[t], gap))
        ties.append((i, t, gap))
    return ties


def wait_until(cond, what, budget=120.0):
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > budget:
            raise AssertionError('phase 3f: %s not within %.0f s'
                                 % (what, budget))
        time.sleep(0.005)


def serve_degraded(torch, serving, kernels, device, cfg=SLICE, slots=SLOTS,
                   buckets=BUCKETS):
    """Phase 3f (a)-(d): the degraded path of the decode engine on the
    card (see the module). Each sub-check runs in a fresh session over the
    one program (the op numbering starts at 0) with ``MXNET_TPU_FAULT``
    set, and unset in a ``finally`` that lets a failure through. Returns
    a dict of results: per sub-check the degraded streams and tokens, the
    near ties, the CPU seconds, the breaker's states; the card-side
    launches; the CPU ms of a degraded token."""
    import tempfile
    from mxnet_tpu_torch.resilience import (CircuitBreaker, WorkerCrashError,
                                            stall_record)
    t_phase = time.perf_counter()
    model, params = serving.init_transformer_lm(seed=0, **cfg)
    prog = serving.freeze_decode(model, params, slots=slots,
                                 prefill_buckets=buckets, sample_args=True,
                                 device=device)
    if not (prog.paged and prog.page_size == PAGE_SIZE and prog.capture):
        raise AssertionError('phase 3f: not the captured paged default')
    del params
    reqs = degraded_requests(cfg)
    res = {'subchecks': {}}
    cards = []       # (counts before, counts after) of every session
    # (row, outputs, sub-check): their near ties are looked for on the
    # card after its launches are read, since a teacher-forced margin
    # launches the attention kernel
    tie_checks = []

    def session(**kw):
        return serving.InferenceSession(prog, timeout_s=600,
                                        max_new_tokens=DEGRADED_TOKENS, **kw)

    def counted(sess, before):
        cards.append((before, sess.stats()['counts']))

    kernels.reset_launch_counts()
    with session() as sess:
        built = check_programs('phase 3f', prog, program_set(buckets, True),
                               True)
        before = sess.stats()['counts']
        streams = submit(sess, reqs)
        healthy = [s.result(600) for s in streams]
        assert_healthy('phase 3f healthy', sess, streams)
        counted(sess, before)

    def clean(sess, sub, i=0):
        """A clean request after the fault: on the card, its healthy
        tokens, not degraded."""
        s = submit(sess, reqs[i:i + 1])[0]
        if s.result(600) != healthy[i] or s.degraded:
            raise AssertionError('phase 3f %s: the clean request after the '
                                 'fault is not the healthy one on the card'
                                 % sub)
        return s

    def degraded_run(sub, spec, **kw):
        os.environ['MXNET_TPU_FAULT'] = spec
        try:
            with session(**kw) as sess:
                before = sess.stats()['counts']
                t0 = time.perf_counter()
                streams = submit(sess, reqs)
                outs = [s.result(600) for s in streams]
                wall = time.perf_counter() - t0
                st = sess.stats()
                os.environ.pop('MXNET_TPU_FAULT')
                if st['free_slots'] != slots or st['pages']['pages_used']:
                    raise AssertionError('phase 3f %s: the pool is not all '
                                         'free after the trip: %r'
                                         % (sub, st['pages']))
                clean(sess, sub)
                counted(sess, before)
                after = sess.status()
        finally:
            os.environ.pop('MXNET_TPU_FAULT', None)
        if not all(s.degraded for s in streams):
            raise AssertionError('phase 3f %s: streams %s not degraded'
                                 % (sub, [i for i, s in enumerate(streams)
                                          if not s.degraded]))
        c = st['counts']
        row = dict(spec=spec, fallback_tokens=c['fallback_tokens'],
                   retired=c['retired'], wall_s=wall,
                   breaker_after_trip=st['breaker'],
                   status_after_clean=after['status'],
                   breaker_after_clean=after['breaker'])
        if not c['fallback_tokens'] > 0 or after['status'] != 'ok' \
                or after['breaker'] != 'closed':
            raise AssertionError('phase 3f %s: %r' % (sub, row))
        tie_checks.append((row, outs, sub))
        return row, st

    # (a) a lost step: every in-flight stream completes on the CPU
    spec = 'device_loss@serving.decode.%d:1' % TRIP_OP
    row, st = degraded_run('(a)', spec)
    if row['retired'].get('degraded') != DEGRADED_REQUESTS:
        raise AssertionError('phase 3f (a): retired %r, expected %d degraded'
                             % (row['retired'], DEGRADED_REQUESTS))
    res['subchecks']['a'] = row

    # (b) the breaker opens: refused calls complete on the CPU; the
    # half-open probe runs on the card and closes it
    breaker = CircuitBreaker(3, BREAKER_RESET_S)
    states = [breaker.state]
    os.environ['MXNET_TPU_FAULT'] = 'device_unavailable@serving.decode:3'
    try:
        with session(breaker=breaker) as sess:
            before = sess.stats()['counts']
            t_trip = time.perf_counter()
            streams = submit(sess, reqs)
            wait_until(lambda: breaker.state == 'open', 'the breaker open')
            states.append(breaker.state)
            wait_until(lambda: breaker.state == 'half-open',
                       'the breaker half-open')
            states.append(breaker.state)
            t_rec = time.perf_counter()
            probe = submit(sess, reqs[1:2])[0]
            probe_out = probe.result(600)
            first_card_s = t_rec + probe.ttft_s - t_trip
            states.append(breaker.state)
            outs = [s.result(600) for s in streams]
            wall = time.perf_counter() - t_trip
            st = sess.stats()
            counted(sess, before)
    finally:
        os.environ.pop('MXNET_TPU_FAULT', None)
    c = st['counts']
    if states != ['closed', 'open', 'half-open', 'closed'] \
            or probe.degraded or probe_out != healthy[1] \
            or not all(s.degraded for s in streams) \
            or c['fallback_tokens'] != sum(len(o) for o in outs):
        raise AssertionError('phase 3f (b): breaker states %s, probe degraded '
                             '%s, probe healthy %s, degraded %s, fallback '
                             'tokens %d' % (states, probe.degraded,
                                            probe_out == healthy[1],
                                            [s.degraded for s in streams],
                                            c['fallback_tokens']))
    res['subchecks']['b'] = dict(
        spec='device_unavailable@serving.decode:3', states=states,
        fallback_tokens=c['fallback_tokens'], retired=c['retired'],
        wall_s=wall, trip_to_card_token_s=first_card_s)
    tie_checks.append((res['subchecks']['b'], outs, '(b)'))

    # (c) a worker crash: the streams fail typed, their slots free
    spec = 'worker_crash@serving.decode.%d:1' % TRIP_OP
    os.environ['MXNET_TPU_FAULT'] = spec
    try:
        with session() as sess:
            before = sess.stats()['counts']
            streams = submit(sess, reqs)
            errors = []
            for s in streams:
                try:
                    s.result(600)
                    errors.append(None)
                except WorkerCrashError as exc:
                    errors.append(type(exc).__name__)
            os.environ.pop('MXNET_TPU_FAULT')
            wait_until(lambda: sess.stats()['free_slots'] == slots,
                       'the slots free after the crash')
            st = sess.stats()
            clean(sess, '(c)', 1)
            counted(sess, before)
    finally:
        os.environ.pop('MXNET_TPU_FAULT', None)
    c = st['counts']
    if errors != ['WorkerCrashError'] * DEGRADED_REQUESTS \
            or any(s.degraded for s in streams) or c['fallback_tokens'] \
            or c['retired'].get('aborted') != DEGRADED_REQUESTS:
        raise AssertionError('phase 3f (c): errors %s, retired %r, fallback '
                             'tokens %d' % (errors, c['retired'],
                                            c['fallback_tokens']))
    res['subchecks']['c'] = dict(spec=spec, retired=c['retired'],
                                 errors=errors, tokens_before=[
                                     len(s.tokens) for s in streams])

    # (d) a stall: the watchdog's artifact, the streams degraded
    tmp = tempfile.mkdtemp(prefix='chip_smoke_stall_')
    artifact = os.path.join(tmp, 'STALL.json')
    try:
        spec = 'hang@serving.decode.%d:1' % TRIP_OP
        row, st = degraded_run('(d)', spec, stall_artifact=artifact)
        with open(artifact) as f:
            art = json.load(f)
    finally:
        for name in os.listdir(tmp):
            os.unlink(os.path.join(tmp, name))
        os.rmdir(tmp)
    if row['retired'].get('degraded') != DEGRADED_REQUESTS:
        raise AssertionError('phase 3f (d): retired %r, expected %d degraded'
                             % (row['retired'], DEGRADED_REQUESTS))
    keys = sorted(stall_record('decode', 0, 0.0, 0.0))
    if art['schema'] != 'mxnet_tpu.stall.v1' or art['phase'] != 'decode' \
            or sorted(art) != keys or art['step'] != TRIP_OP:
        raise AssertionError('phase 3f (d): the stall artifact %r'
                             % {k: art.get(k) for k in keys
                                if k != 'thread_stacks'})
    row['artifact'] = {k: art[k] for k in ('schema', 'phase', 'step',
                                           'waited_s', 'budget_s')}
    res['subchecks']['d'] = row

    # nothing degraded is launched: the card-side launches of 3f are those
    # of the card's prefills and steps, exactly
    launches = kernels.launch_counts()
    prefills = sum(a['prefills'] - b['prefills'] for b, a in cards)
    steps = sum(a['steps'] - b['steps'] for b, a in cards)
    want = dict.fromkeys(launches, 0)
    want['flash_attention_fwd'] = cfg['layers'] * prefills
    want['flash_paged_decode_fwd'] = cfg['layers'] * steps
    want['threefry_gumbel'] = prefills + steps
    if device.type == 'cuda' and launches != want:
        raise AssertionError('phase 3f: card launches %r, expected %r'
                             % (launches, want))
    if prog.compile_count != len(built):
        raise AssertionError('phase 3f: a trip or a recovery built a '
                             'program (%d, %d after warmup)'
                             % (prog.compile_count, len(built)))
    for row, outs, sub in tie_checks:
        row['ties'] = near_ties(torch, model, prog.params, reqs, outs,
                                healthy, device, sub)
    # the CPU fallback alone: a prefill, then the tokens after it
    t0 = time.perf_counter()
    one = prog.fallback_generate(reqs[0]['prompt'], 1)
    t1 = time.perf_counter()
    full = prog.fallback_generate(reqs[0]['prompt'], DEGRADED_TOKENS)
    t2 = time.perf_counter()
    if full[:1] != one:
        raise AssertionError('phase 3f: the CPU fallback alone differs from '
                             'itself')
    near_ties(torch, model, prog.params, reqs[:1], [full], healthy[:1],
              device, 'fallback alone')
    res.update(launches=launches, prefills=prefills, steps=steps,
               programs=len(built), healthy_tokens=sum(map(len, healthy)),
               cpu_prefill_ms=(t1 - t0) * 1e3,
               cpu_token_ms=((t2 - t1) - (t1 - t0)) * 1e3
               / (DEGRADED_TOKENS - 1),
               prompt_len=len(reqs[0]['prompt']),
               seconds=time.perf_counter() - t_phase)
    del prog
    torch.cuda.empty_cache()
    return res


def degraded_oneshot(torch, serving, kernels, frozen, images, device):
    """Phase 3f (e): 6b's frozen SSD-300 serves one batch of 2 images
    under ``device_loss@serving:1``: the batch is re-served by
    ``run_fallback`` on the CPU; ``status()`` reads degraded, then ok
    after a clean batch equal to ``frozen.run``. The fallback is held to
    the card in steps that each decide: what it served is its host
    block's output on these images, byte for byte (the CPU runs it
    deterministically); the host block's heads are the card's within
    SSD_HEAD_REL of each head's max abs, as in 6a; the host block's
    detection, given the card's heads, keeps the card's rows (6a's
    matching); and the served rows match the card's. Every kept row must
    match: no decision slack excuses a difference. The smallest slack of
    each detection comparison, over 4x its probability difference as in
    6a, is reported: at full width, with random weights and thousands of
    near-uniform rows, it can lie under 1, where 6a would call the
    comparison undecided and this one still requires the match."""
    import numpy as np
    from mxnet_tpu_torch.ops import nn as ops
    kernels.reset_launch_counts()
    os.environ['MXNET_TPU_FAULT'] = 'device_loss@serving:1'
    try:
        with serving.InferenceSession(frozen, max_batch=len(images),
                                      timeout_s=600) as sess:
            t0 = time.perf_counter()
            fell = sess.infer_batch([images])[0]
            cpu_s = time.perf_counter() - t0
            degraded = sess.status()
            os.environ.pop('MXNET_TPU_FAULT')
            card = sess.infer_batch([images])[0]
            ok = sess.status()
    finally:
        os.environ.pop('MXNET_TPU_FAULT', None)
    launches = kernels.launch_counts()
    if degraded['status'] != 'degraded' or ok['status'] != 'ok' or \
            degraded['batches'] != {'accel': 0, 'fallback': 1} or \
            ok['batches'] != {'accel': 1, 'fallback': 1}:
        raise AssertionError('phase 3f (e): status %r then %r'
                             % ({k: degraded[k] for k in ('status', 'batches',
                                                          'error')},
                                {k: ok[k] for k in ('status', 'batches')}))
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(nms=1, bn_act_fwd=SSD_BATCH_NORMS)
    if device.type == 'cuda' and launches != want:
        raise AssertionError('phase 3f (e): launches %r, expected %r (the '
                             'clean batch only)' % (launches, want))
    if not np.array_equal(card, frozen.run([images])[0]):
        raise AssertionError('phase 3f (e): the clean batch is not the '
                             'card\'s run')
    host = frozen._host_block
    with torch.inference_mode():
        x = torch.from_numpy(images)
        heads_t = frozen.block.net(x.to(device))
        card_dets = frozen.block.det(*heads_t).cpu().numpy()
        heads = [h.cpu().numpy() for h in heads_t]
        cpu_heads = [h.numpy() for h in host.net(x)]
        own = host.det(*map(torch.from_numpy, cpu_heads)).numpy()
        via = host.det(*map(torch.from_numpy, heads)).numpy()
        cls, cpu_cls = torch.from_numpy(heads[1]), torch.from_numpy(
            cpu_heads[1])
        d = {'card heads': (ops.softmax(cls.to(device)).cpu()
                            - ops.softmax(cls)).abs().max().item(),
             'served': (ops.softmax(cls) - ops.softmax(cpu_cls)).abs()
             .max().item()}
    if not np.array_equal(fell, own):
        raise AssertionError('phase 3f (e): the served batch is not the '
                             'host block\'s output on its images')
    head_err = max(np.abs(a - b).max() / np.abs(b).max()
                   for a, b in zip(heads, cpu_heads))
    if not head_err <= SSD_HEAD_REL:
        raise AssertionError('phase 3f (e): the host block\'s heads are '
                             '%.3g of their max abs from the card\'s (> %g)'
                             % (head_err, SSD_HEAD_REL))
    cand = _decode64(*heads)
    slack = {what: min(detection_margin(p, b, max(4 * diff, 1e-9))
                       for p, b in cand) for what, diff in d.items()}
    kept = {}
    for what, got, ref in (('card heads', via, card_dets),
                           ('served', fell, card)):
        try:
            kept[what] = [match_detections(a, b) for a, b in zip(got, ref)]
        except AssertionError as exc:
            raise AssertionError(
                'phase 3f (e): %s: %s; the smallest decision slack is %.3g '
                'of 4x the probability difference %.3g, and no slack '
                'excuses a difference' % (what, exc, slack[what], d[what])) \
                from None
    return dict(kept=kept, slack=slack, prob_diff=d, head_err=head_err,
                cpu_s=cpu_s, error=degraded['error'], launches=launches)


# -- phase 3h: the artifacts in a fresh process, behind the HTTP endpoint ----

HTTP_CLIENTS = 8           # requests in flight at once over HTTP
HTTP_BUDGET_S = 300        # any one HTTP call
CHILD_READY_S = 300        # a child's start to its READY line
CHILD_DONE_S = 120         # a child's stop to its exit
# the long request (3a's 17th prompt, greedy, served alone first): it runs
# to the cache's end, where the speculative tick gives way to plain paged
# steps, the only ones a self-drafted engine takes on prompts that share
# no prefix
LONG_REQUEST = 16
# the fault child: one transient device loss after the prefills and a few
# speculative ticks (a tick is spec_k + 1 draft steps and one verify), the
# breaker opening at that one failure
FAULT_SPEC = 'device_loss@serving.decode.9:1'

# the child: loads the artifacts on the card, captures, serves them behind
# one ServingHTTPServer; prints READY <json> (its port and its phase
# times, on the wall clock). The fault child prints DONE <json> (its
# launch counts from READY on, the programs, the sessions' stats) when its
# stdin closes. The main child arms the endpoint's preemption hook and
# blocks in serve_until_drained: a STATS line on its stdin prints STATS
# <json> (DONE's fields), and SIGTERM drains it: it prints DRAINED <json>
# (the same fields and the drain's result) and exits with the resumable
# code. The fleet child (phase 3g) serves the LM alone, answers STATS
# lines until its stdin closes, and is killed by SIGKILL
CHILD_3H = r'''
import json, sys, threading, time
t_start = time.time()
root, mode, lm_path, ssd_path = sys.argv[1:5]
sys.path.insert(0, root)
import torch
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.ops import kernels
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t_import = time.time()
lm = serving.load_frozen(lm_path)
ssd = serving.load_frozen(ssd_path) if mode == 'main' else None
torch.cuda.synchronize()
t_load = time.time()
lm.warmup()
if ssd is not None:
    ssd.warmup()
sess = serving.InferenceSession(lm, timeout_s=600)
osess = serving.InferenceSession(ssd, max_batch=ssd.policy.max_batch,
                                 deadline_ms=5.0, timeout_s=600) \
    if ssd is not None else None
torch.cuda.synchronize()
t_capture = time.time()
srv = serving.ServingHTTPServer(osess if osess is not None else sess, 0,
                                decode_session=sess if osess is not None
                                else None).start()
if mode == 'main':
    srv.install_preempt_hook(poll_s=0.005)
seconds = {'lm': dict(lm.load_seconds), 'draft': dict(sess.draft.load_seconds)}
if ssd is not None:
    seconds['ssd'] = dict(ssd.load_seconds)
compiled = {'lm': dict(lm.compile_seconds),
            'draft': dict(sess.draft.compile_seconds)}


def snapshot():
    stats = sess.stats()
    doc = {'launches': kernels.launch_counts(), 'counts': stats['counts'],
           'spec': stats.get('spec'), 'compiled': lm.compile_count,
           'draft_compiled': sess.draft.compile_count,
           'status': sess.status()['status']}
    if osess is not None:
        ost = osess.stats()
        doc.update(ssd_compiled=ssd.compile_count,
                   by_bucket={str(k): v for k, v in
                              ost['batches_by_bucket'].items()},
                   oneshot_status=osess.status()['status'])
    return doc


kernels.reset_launch_counts()
print('READY ' + json.dumps({
    'port': srv.port, 'start': t_start, 'imported': t_import,
    'loaded': t_load, 'captured': t_capture, 'load_seconds': seconds,
    'compile_seconds': compiled,
    'ssd_compiled': ssd.compile_count if ssd is not None else None,
    'draft': {'paged': sess.draft.paged, 'slots': sess.draft.slots},
    'spec_k': lm.spec_k, 'modules': sorted(
        m for m in sys.modules if m.split('.')[0] in ('jax', 'mxnet_tpu'))}),
    flush=True)
if mode == 'main':
    def stats_lines():
        for line in sys.stdin:
            if line.strip() == 'STATS':
                print('STATS ' + json.dumps(snapshot()), flush=True)
    threading.Thread(target=stats_lines, daemon=True).start()
    try:
        srv.serve_until_drained(timeout=1200)
    finally:
        doc = snapshot()
        doc['drain'] = srv.drain_result
        print('DRAINED ' + json.dumps(doc), flush=True)
        srv.stop()
        if osess is not None:
            osess.close()
elif mode == 'fleet':
    for line in sys.stdin:
        if line.strip() == 'STATS':
            print('STATS ' + json.dumps(snapshot()), flush=True)
sys.stdin.read()
doc = snapshot()
srv.stop()
sess.close()
if osess is not None:
    osess.close()
print('DONE ' + json.dumps(doc), flush=True)
'''


def save_artifacts(torch, serving, frozen, device, root, cfg=SLICE,
                   slots=SLOTS, buckets=BUCKETS, seed=0):
    """Phase 3h (a): phase 3p's program with 3s's speculation (the paged
    default at page size 16, sampling, ``spec_k`` 3), its self-draft (the
    same weights frozen ``paged=False``, phase 3's program) and 6b's
    frozen SSD-300, saved under ``root``. The loaded manifest's ``spec_k``
    is what a reload serves with, as in the reference, so the target is
    saved with it. Returns {name: path, seconds, bytes (params.npz and
    all), manifest keys}."""
    model, params = serving.init_transformer_lm(seed=seed, **cfg)
    progs = {'lm': serving.freeze_decode(model, params, slots=slots,
                                         prefill_buckets=buckets,
                                         spec_k=SPEC_K, device=device),
             'draft': serving.freeze_decode(model, params, slots=slots,
                                            prefill_buckets=buckets,
                                            paged=False, device=device),
             'ssd': frozen}
    del params
    out = {}
    for name, prog in progs.items():
        path = os.path.join(root, name)
        t0 = time.perf_counter()
        prog.save(path)
        seconds = time.perf_counter() - t0
        with open(os.path.join(path, 'MANIFEST.json')) as f:
            keys = sorted(json.load(f))
        out[name] = dict(path=path, seconds=seconds, keys=keys,
                         npz_bytes=os.path.getsize(os.path.join(
                             path, 'params.npz')),
                         bytes=sum(os.path.getsize(os.path.join(path, f))
                                   for f in os.listdir(path)))
    del progs
    torch.cuda.synchronize()
    return out


class _Child:
    """A fresh ``sys.executable`` running :data:`CHILD_3H`: its stdout read
    on a thread (lines into a queue), its stderr into a file; stopped by
    closing its stdin, killed if it outlives its budget."""

    def __init__(self, mode, arts, env, log_path):
        import queue
        import threading
        self.lines = queue.Queue()
        self.log_path = log_path
        self._err = open(log_path, 'w')
        self.spawned = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, '-c', CHILD_3H, HERE, mode, arts['lm']['path'],
             arts['ssd']['path']], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self._err, env=env, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.put(line.rstrip('\n'))
        self.lines.put(None)

    def expect(self, tag, budget):
        """The JSON after ``tag`` on the child's next tagged line."""
        import queue
        deadline = time.time() + budget
        while True:
            try:
                line = self.lines.get(timeout=max(0.1, deadline - time.time()))
            except queue.Empty:
                line = None
            if line is None or time.time() > deadline:
                raise AssertionError('phase 3h: the %s child printed no %s '
                                     '(rc %s); its stderr ends %s'
                                     % (self.proc.args[4], tag,
                                        self.proc.poll(), self.stderr_tail()))
            if line.startswith(tag + ' '):
                return json.loads(line[len(tag) + 1:])

    def stats(self):
        """The main child's STATS JSON (DONE's fields), asked for on its
        stdin."""
        self.proc.stdin.write('STATS\n')
        self.proc.stdin.flush()
        return self.expect('STATS', CHILD_DONE_S)

    def stop(self):
        """Close its stdin (it then prints DONE and exits); returns DONE's
        JSON."""
        self.proc.stdin.close()
        doc = self.expect('DONE', CHILD_DONE_S)
        rc = self.proc.wait(CHILD_DONE_S)
        if rc != 0:
            raise AssertionError('phase 3h: the child exited %d: %s'
                                 % (rc, self.stderr_tail()))
        return doc

    def stderr_tail(self, n=3000):
        self._err.flush()
        with open(self.log_path) as f:
            return f.read()[-n:]

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)
        self._err.close()


def _http_stream(port, body, path='/generate'):
    """One NDJSON ``/generate`` (or ``path``) over its own connection:
    (the token lines, the done line, seconds to the first token line, the
    wall time of its arrival)."""
    import http.client
    conn = http.client.HTTPConnection('127.0.0.1', port,
                                      timeout=HTTP_BUDGET_S)
    try:
        t0 = time.perf_counter()
        conn.request('POST', path, body=json.dumps(body).encode(),
                     headers={'Content-Type': 'application/json'})
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError('phase 3h: %s answered %d: %s'
                                 % (path, resp.status, resp.read()[:500]))
        lines, ttft, first_at = [], None, None
        for raw in resp:
            line = json.loads(raw)
            if ttft is None and 'token' in line:
                ttft, first_at = time.perf_counter() - t0, time.time()
            lines.append(line)
        return lines[:-1], lines[-1], ttft, first_at
    finally:
        conn.close()


def _http_json(port, method, path, body=None, raw=None):
    """(status, parsed body) of one request over its own connection."""
    import http.client
    conn = http.client.HTTPConnection('127.0.0.1', port,
                                      timeout=HTTP_BUDGET_S)
    try:
        data = raw if raw is not None else (
            None if body is None else json.dumps(body).encode())
        conn.request(method, path, body=data,
                     headers={'Content-Type': 'application/json'})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _stream_ok(what, toks, done, want):
    if [ln['index'] for ln in toks] != list(range(len(toks))) or \
            [ln['token'] for ln in toks] != done.get('tokens') or \
            'error' in done or done.get('degraded') is not False:
        raise AssertionError('phase 3h: %s: a malformed, failed or degraded '
                             'stream: %s' % (what, done))
    if want is not None and done['tokens'] != want:
        raise AssertionError('phase 3h: %s: %s over HTTP, %s in process'
                             % (what, done['tokens'], want))


def http_launches(c, launches, layers, batches, k=SPEC_K):
    """The child's launches its engine's counts ``c`` call for (3s's
    arithmetic: the draft prefills every admission and steps with every
    tick, one noise launch a call of either program) and its ``batches``
    SSD batches (one nms and ``SSD_BATCH_NORMS`` BN applies each)."""
    plain_steps = c['steps'] - c['spec_rounds']
    want = dict.fromkeys(launches, 0)
    want['flash_attention_fwd'] = layers * (2 * c['prefills']
                                            + c['prefix_hits'])
    want['flash_paged_decode_fwd'] = layers * plain_steps
    want['flash_decode_fwd'] = layers * (plain_steps + (k + 1)
                                         * c['spec_rounds'])
    want['threefry_gumbel'] = 2 * c['prefills'] + c['prefix_hits'] \
        + c['steps'] + plain_steps + (k + 1) * c['spec_rounds']
    want['bn_act_fwd'] = SSD_BATCH_NORMS * batches
    want['nms'] = batches
    return want


def serve_http(torch, serving, kernels, arts, greedy, sampled, long_req,
               images, refused, cfg=SLICE, new_tokens=NEW_TOKENS,
               buckets=BUCKETS):
    """Phase 3h (b)-(c): a fresh process loads the LM and SSD-300
    artifacts, its draft through ``MXNET_TPU_SERVE_SPEC_DRAFT`` (with
    ``MXNET_TPU_SERVE_SPEC_K`` 3; no other ``MXNET_TPU_*`` variable of
    this process reaches it), and serves them behind one HTTP endpoint.
    Driven over HTTP: the long request alone (the cold start's first
    token), phase 3p's 16 greedy requests as NDJSON streams,
    ``HTTP_CLIENTS`` at a time (tokens/s, TTFT), 3a's sampled base
    requests as plain bodies, 6b's one-by-one images to ``/predict``
    (latency), and the endpoint's own answers. ``greedy`` and ``sampled``
    are (request, in-process tokens) pairs, ``long_req`` one, ``images``
    6b's (images, responses, buckets). Then phase 3m (c)-(d) with the same
    child (:func:`drain_http`; ``refused`` is an adapter-pinned payload of
    3m (a)). Returns a dict of results."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    env = {k: v for k, v in os.environ.items()
           if not k.startswith('MXNET_TPU_')}
    env.update(MXNET_TPU_SERVE_SPEC_K=str(SPEC_K),
               MXNET_TPU_SERVE_SPEC_DRAFT=arts['draft']['path'])
    child = _Child('main', arts, env, os.path.join(
        os.path.dirname(arts['lm']['path']), 'child.log'))
    try:
        ready = child.expect('READY', CHILD_READY_S)
        port = ready['port']
        if ready['modules']:
            raise AssertionError('phase 3h: the child imported %s'
                                 % ready['modules'])
        want_set = program_set(buckets, True, SPEC_K)
        got_sets = {k: sorted(v) for k, v in ready['compile_seconds'].items()}
        if got_sets != {'lm': sorted(want_set),
                        'draft': sorted(program_set(buckets))} or \
                ready['draft'] != {'paged': False, 'slots': SLOTS} or \
                ready['spec_k'] != SPEC_K:
            raise AssertionError('phase 3h: the reloaded programs %s, draft '
                                 '%s, spec_k %s' % (got_sets, ready['draft'],
                                                    ready['spec_k']))
        # the long request alone: the first token the child ever serves
        req, want = long_req
        toks, done, long_ttft, first_at = _http_stream(port, {
            'tokens': req['prompt'], 'max_new_tokens': cfg['max_len'],
            'stream': True})
        _stream_ok('the long request', toks, done, None)
        if done['tokens'][:new_tokens] != want or \
                len(req['prompt']) + len(done['tokens']) != cfg['max_len']:
            raise AssertionError('phase 3h: the long request served %d '
                                 'tokens, the first %d %s against %s'
                                 % (len(done['tokens']), new_tokens,
                                    done['tokens'][:new_tokens], want))
        first_token_s = first_at - child.spawned
        long_tokens = len(done['tokens'])
        with ThreadPoolExecutor(HTTP_CLIENTS) as pool:
            t0 = time.perf_counter()
            runs = list(pool.map(lambda r: _http_stream(port, {
                'tokens': r[0], 'max_new_tokens': new_tokens}), greedy))
            wall = time.perf_counter() - t0
            for i, ((toks, done, _t, _a), (_p, want)) in enumerate(
                    zip(runs, greedy)):
                _stream_ok('greedy request %d' % i, toks, done, want)
            plain = list(pool.map(lambda r: _http_json(
                port, 'POST', '/generate', {
                    'tokens': r[0]['prompt'], 'max_new_tokens': new_tokens,
                    'temperature': r[0]['temperature'],
                    'top_p': r[0]['top_p'], 'seed': r[0]['seed'],
                    'stream': False}), sampled))
        for (code, body), (r, want) in zip(plain, sampled):
            if code != 200 or body.get('degraded') is not False or \
                    body.get('tokens') != want:
                raise AssertionError('phase 3h: sampled request (seed %d) '
                                     'answered %d %s, in process %s'
                                     % (r['seed'], code, body, want))
        x, outs, buckets_6b = images
        if set(buckets_6b) != {1}:
            raise AssertionError('phase 3h: 6b ran its one-by-one images at '
                                 'buckets %s' % buckets_6b)
        lat = []
        for i, (img, want) in enumerate(zip(x, outs)):
            t = time.perf_counter()
            code, body = _http_json(port, 'POST', '/predict',
                                    {'data': img.tolist()})
            lat.append(time.perf_counter() - t)
            got = np.asarray(body['outputs'][0], 'float32') \
                if code == 200 else None
            if got is None or not np.array_equal(got, want):
                raise AssertionError('phase 3h: /predict image %d answered %d,'
                                     ' not bitwise 6b\'s response' % (i, code))
        checks = {
            'healthz': _http_json(port, 'GET', '/healthz'),
            'malformed': _http_json(port, 'POST', '/generate',
                                    raw=b'{"tokens": [1, 2'),
            'request_id': _http_json(port, 'POST', '/generate', {
                'tokens': greedy[0][0], 'max_new_tokens': 2, 'stream': False,
                'request_id': 'r1'}),
            'status': _http_json(port, 'GET', '/status')}
        if checks['healthz'] != (200, {'ok': True, 'status': 'ok'}) or \
                checks['malformed'][0] != 400 or \
                checks['request_id'] != (200, {
                    'tokens': greedy[0][1][:2], 'finish_reason': 'length',
                    'degraded': False, 'request_id': 'r1'}) or \
                checks['status'][1]['status'] != 'ok':
            raise AssertionError('phase 3h: the endpoint answered %s'
                                 % {k: v for k, v in checks.items()
                                    if k != 'status'})
        done_doc = child.stats()
        drain = drain_http(torch, serving, kernels, child, port, greedy,
                           refused, cfg=cfg, new_tokens=new_tokens,
                           buckets=buckets)
    finally:
        child.close()
    c = done_doc['counts']
    if done_doc['compiled'] != len(want_set) or \
            done_doc['draft_compiled'] != len(program_set(buckets)) or \
            done_doc['ssd_compiled'] != ready['ssd_compiled'] or \
            done_doc['by_bucket'] != {'1': len(x)} or \
            done_doc['status'] != 'ok' or done_doc['oneshot_status'] != 'ok':
        raise AssertionError('phase 3h: after the requests: %s'
                             % {k: v for k, v in done_doc.items()
                                if k != 'launches'})
    acceptance = done_doc['spec']['acceptance_rate']
    if acceptance is None or acceptance < SPEC_ACCEPTANCE or \
            c['fallback_tokens']:
        raise AssertionError('phase 3h: acceptance %r with the loaded draft, '
                             '%d fallback tokens' % (acceptance,
                                                     c['fallback_tokens']))
    plain_steps = c['steps'] - c['spec_rounds']
    launches = done_doc['launches']
    want = http_launches(c, launches, cfg['layers'], len(x))
    if launches != want or not plain_steps:
        raise AssertionError('phase 3h: the child launched %r, expected %r '
                             '(%d plain steps)' % (launches, want,
                                                   plain_steps))
    # the drained child's launches, the 3m streams' among them, as exact;
    # the path's: those streams' in the child and B''s continuations
    dd = drain['drained']
    want = http_launches(dd['counts'], dd['launches'], cfg['layers'], len(x))
    if dd['launches'] != want:
        raise AssertionError('phase 3m (c): the drained child launched %r, '
                             'expected %r' % (dd['launches'], want))
    drain['launches'] = {k: v + dd['launches'][k] - launches[k]
                         for k, v in drain['launches'].items()}
    ttft = [r[2] for r in runs]
    tokens = sum(len(r[1]['tokens']) for r in runs)
    return {
        'ready': ready, 'first_token_s': first_token_s,
        'long_ttft_s': long_ttft, 'long_tokens': long_tokens,
        'tokens_per_s': tokens / wall, 'wall_s': wall, 'tokens': tokens,
        'ttft_p50_ms': percentile(ttft, 50) * 1e3,
        'ttft_p99_ms': percentile(ttft, 99) * 1e3,
        'predict_p50_ms': percentile(lat, 50) * 1e3,
        'predict_p99_ms': percentile(lat, 99) * 1e3,
        'acceptance': acceptance, 'counts': c, 'launches': launches,
        'spawned': child.spawned, 'plain_steps': plain_steps,
        'sampled': len(sampled), 'images': len(x), 'drain': drain,
    }


def serve_http_fault(torch, serving, arts, req, want):
    """Phase 3h (d): a second, short child serves the LM artifact alone
    under ``FAULT_SPEC`` with a breaker of one failure: the one stream
    completes on the CPU, its done line ``degraded: true`` with the
    healthy tokens (where one differs, at a near tie of the
    teacher-forced margin, counted), and ``/healthz`` answers 503 while
    the breaker is open. Returns a dict of results."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith('MXNET_TPU_')}
    env.update(MXNET_TPU_SERVE_SPEC_K=str(SPEC_K),
               MXNET_TPU_SERVE_SPEC_DRAFT=arts['draft']['path'],
               MXNET_TPU_FAULT=FAULT_SPEC, MXNET_TPU_SERVE_BREAKER='1')
    child = _Child('fault', arts, env, os.path.join(
        os.path.dirname(arts['lm']['path']), 'fault_child.log'))
    try:
        ready = child.expect('READY', CHILD_READY_S)
        port = ready['port']
        t0 = time.perf_counter()
        toks, done, _ttft, _at = _http_stream(port, {
            'tokens': req['prompt'], 'max_new_tokens': NEW_TOKENS})
        wall = time.perf_counter() - t0
        healthz = _http_json(port, 'GET', '/healthz')
        status = _http_json(port, 'GET', '/status')[1]
        done_doc = child.stop()
    finally:
        child.close()
    if done.get('degraded') is not True or 'error' in done or \
            [t['token'] for t in toks] != done['tokens']:
        raise AssertionError('phase 3h (d): the done line %s' % done)
    if healthz != (503, {'ok': False, 'status': 'degraded'}) or \
            status['breaker'] != 'open':
        raise AssertionError('phase 3h (d): /healthz %s, breaker %s while '
                             'it is open' % (healthz, status['breaker']))
    ties = []
    if done['tokens'] != want:
        model, np_params = serving.init_transformer_lm(seed=0, **SLICE)
        cuda = torch.device('cuda')
        ties = near_ties(torch, model, serving.params_from_jax(np_params,
                                                               cuda),
                         [req], [done['tokens']], [want], cuda, '(d)',
                         phase='phase 3h')
    c = done_doc['counts']
    if not c['fallback_tokens'] or done_doc['status'] != 'degraded':
        raise AssertionError('phase 3h (d): %d fallback tokens, status %s'
                             % (c['fallback_tokens'], done_doc['status']))
    return {'wall_s': wall, 'fallback_tokens': c['fallback_tokens'],
            'ties': ties, 'launches': done_doc['launches'],
            'retired': c['retired'], 'healthz': healthz}


def log_http(h, hf, arts, rp, det, card):
    """Phase 3h's lines: the artifacts, the cold start split, the HTTP
    metrics beside 3p's in-process ones, the fault child."""
    for name, a in arts.items():
        log('phase 3h (a) [%s]: saved %s in %.3f s: %d B (params.npz %d B); '
            'manifest keys %s' % (card, name, a['seconds'], a['bytes'],
                                  a['npz_bytes'], a['keys']))
    r = h['ready']
    ls = r['load_seconds']
    read = sum(v['read'] for v in ls.values())
    h2d = sum(v['to_device'] for v in ls.values())
    draft = sum(ls['draft'].values())
    log('phase 3h (b) [%s]: a fresh process, spawn to its first served token '
        '%.3f s: interpreter and imports %.3f s, load %.3f s (the three '
        'artifacts read %.3f s, to the card %.3f s; the draft\'s %.3f s of '
        'it through MXNET_TPU_SERVE_SPEC_DRAFT), capture %.3f s (LM %s, '
        'draft %s programs; the SSD\'s %d buckets run), first token %.3f s '
        'after the capture; imports of jax / mxnet_tpu: none'
        % (card, h['first_token_s'], r['imported'] - h['spawned'],
           r['loaded'] - r['imported'] + draft, read, h2d, draft,
           r['captured'] - r['loaded'] - draft, len(r['compile_seconds']['lm']),
           len(r['compile_seconds']['draft']), r['ssd_compiled'],
           h['first_token_s'] - (r['captured'] - h['spawned'])))
    log('phase 3h (c) [%s]: over HTTP, %d greedy NDJSON streams %d at a time '
        'token for token 3p\'s, %d sampled plain bodies equal to 3a\'s in '
        'process, %d /predict images bitwise 6b\'s; tokens/s %.2f (3p in '
        'process %.2f), TTFT p50 %.2f ms (%.2f), p99 %.2f ms (%.2f), wall '
        '%.3f s; /predict latency p50 %.2f ms p99 %.2f ms (6b one by one in '
        'process p50 %.2f ms p99 %.2f ms); the long request %d tokens to '
        'the cache\'s end; speculation acceptance %.4f with the loaded '
        'draft, %d plain paged steps; no program built by a request; '
        'launches %s'
        % (card, len(rp['outs']), HTTP_CLIENTS, h['sampled'], h['images'],
           h['tokens_per_s'], rp['tokens_per_s'], h['ttft_p50_ms'],
           rp['ttft_p50_ms'], h['ttft_p99_ms'], rp['ttft_p99_ms'], h['wall_s'],
           h['predict_p50_ms'], h['predict_p99_ms'], det['seq_p50_ms'],
           det['seq_p99_ms'], h['long_tokens'], h['acceptance'],
           h['plain_steps'], {k: v for k, v in h['launches'].items() if v}))
    log('phase 3h (d) [%s]: %s in a second child: the stream done with '
        'degraded true, %d fallback tokens, %d near ties %s, in %.3f s; '
        '/healthz %s while the breaker is open; retired %s; launches %s'
        % (card, FAULT_SPEC, hf['fallback_tokens'], len(hf['ties']),
           hf['ties'], hf['wall_s'], hf['healthz'], hf['retired'],
           {k: v for k, v in hf['launches'].items() if v}))


# -- phase 3m: live migration, prefill_only and the drain ---------------------

MIGRATE_PAGE = 128         # the destination's page size (the source's: 16)
MIGRATE_AFTER = 8          # tokens each live stream has when export_all runs
DRAIN_STREAMS = 8          # 3p's requests streamed to 3h's child, drained
DRAIN_AFTER = 4            # tokens each has streamed when SIGTERM is sent
# their budget: 4 tokens in, the drain lands mid-stream with room to spare;
# the first NEW_TOKENS of each spliced stream are held to 3p's
DRAIN_TOKENS = 128
DRAIN_BUDGET_S = 30.0      # MXNET_TPU_SERVE_DRAIN_TIMEOUT_S's default


def payload_bytes(payload):
    """(the rows' raw bytes, the document's JSON bytes) of a payload."""
    import numpy as np
    raw = sum(int(np.prod(e['shape'])) * np.dtype(e['dtype']).itemsize
              for e in payload['entries'].values())
    return raw, len(json.dumps(payload))


def import_when_free(serving, eng, payload, budget=600.0):
    """``eng.import_sequence(payload)``, retried while the engine has no
    free slot (``BackpressureError``). Returns (the stream, the seconds of
    the call that landed it)."""
    deadline = time.monotonic() + budget
    while True:
        t0 = time.perf_counter()
        try:
            stream = eng.import_sequence(payload, timeout=budget)
            return stream, time.perf_counter() - t0
        except serving.BackpressureError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.002)


def _count_delta(after, before):
    return {k: v - before[k] for k, v in after.items() if k != 'retired'}


def _first_difference(got, want):
    return next((t for t, (a, b) in enumerate(zip(got, want)) if a != b),
                min(len(got), len(want)))


def serve_migration(torch, serving, kernels, device, want_3a, want_3s,
                    cfg=SLICE, slots=SLOTS, buckets=BUCKETS,
                    new_tokens=NEW_TOKENS, seed=0):
    """Phase 3m (a)-(b) at the slice's width. Source A is 3a's program
    (page size 16, sampling, an adapter pool of ``ADAPTER_SLOTS`` rows over
    3a's 8 adapters), destination B the same weights frozen again at page
    size ``MIGRATE_PAGE`` with its own registry of the same adapters.
    (a): A serves 3a's 24 requests; once ``slots`` streams have
    ``MIGRATE_AFTER`` tokens each, ``export_all`` gives 8 ``paged`` and 16
    ``cold`` payloads, which B imports (the live ones first): every
    spliced stream equal to 3a's (``want_3a``), sampled ones but at a near
    tie of the plain stream's perturbed scores; B's prefills the cold
    payloads (ordinary admissions), 8 in (the live imports), the handoff
    pages every live payload's. (b): A serves
    3s's 16 shared-prefix prompts ``prefill_only`` (the later ones export
    the extending state of a prefix hit, before any token), B imports
    them: equal to 3s's greedy streams (``want_3s``), no prefill on B.
    The launches of (a) and (b) exact; neither pool's storage replaced.
    Then, on B with an empty trie, each live payload of (a) alone: the
    TTFT of a fresh ``generate(prompt + emitted)``, then the import, its
    first continuation token (from the import call, and from the rows'
    landing) and the continuation exported again, alone (its gather and
    build with nothing else running). Returns a dict of results."""
    from mxnet_tpu_torch.serving import adapters as adapters_mod
    from mxnet_tpu_torch.serving.decode.paged import pages_for
    layers = cfg['layers']
    model, params = serving.init_transformer_lm(seed=seed, **cfg)
    reqs = adapter_requests(cfg)
    ads = phase3a_adapters(adapters_mod, model)

    def build(page_size):
        return serving.freeze_decode(
            model, params, slots=slots, prefill_buckets=buckets,
            page_size=page_size, adapter_rank=ADAPTER_RANK,
            adapter_slots=ADAPTER_SLOTS, sample_args=True, device=device)

    def session(prog):
        return serving.InferenceSession(
            prog, timeout_s=600, max_new_tokens=new_tokens,
            adapters=adapter_registry(adapters_mod, prog, ads))

    def storage(prog):
        return {k: t.data_ptr() for k, t in prog._cache.items()}

    src, dst = build(PAGE_SIZE), build(MIGRATE_PAGE)
    del params
    sess_a, sess_b = session(src), session(dst)
    eng_a, eng_b = sess_a._engine, sess_b._engine
    held = (storage(src), storage(dst))
    try:
        before_a = eng_a.stats()['counts']
        before_b = eng_b.stats()['counts']
        kernels.reset_launch_counts()
        # (a) mid-stream, across page sizes
        streams = [sess_a.generate(
            r['prompt'], max_new_tokens=new_tokens, adapter=r['adapter'],
            temperature=r['temperature'], top_p=r['top_p'], seed=r['seed'],
            request_id='m%d' % i) for i, r in enumerate(reqs)]
        wait_until(lambda: sum(len(s.tokens) >= MIGRATE_AFTER
                               for s in streams) >= slots,
                   'phase 3m (a): %d streams of %d tokens'
                   % (slots, MIGRATE_AFTER))
        t0 = time.perf_counter()
        payloads = eng_a.export_all(timeout=600)
        export_all_s = time.perf_counter() - t0
        live = [p for p in payloads if p['kind'] == 'paged']
        cold = [p for p in payloads if p['kind'] == 'cold']
        if len(live) != slots or len(cold) != len(reqs) - slots or \
                any(s.finish_reason != 'migrated' for s in streams):
            raise AssertionError('phase 3m (a): export_all gave %s, streams '
                                 'finished %s' % (
                                     [p['kind'] for p in payloads],
                                     [s.finish_reason for s in streams]))
        exports = []
        for p in live:
            i = int(p['request_id'][1:])
            if p['emitted'] != streams[i].tokens or \
                    p['pos'] != len(reqs[i]['prompt']) + len(p['emitted']) - 1:
                raise AssertionError('phase 3m (a): request %d exported %d '
                                     'tokens at pos %d, streamed %d'
                                     % (i, len(p['emitted']), p['pos'],
                                        len(streams[i].tokens)))
            raw, js = payload_bytes(p)
            sec = streams[i].export_seconds
            exports.append(dict(request=i, pos=p['pos'],
                                emitted=len(p['emitted']),
                                gather_ms=sec['gather_s'] * 1e3,
                                build_ms=sec['build_s'] * 1e3,
                                raw_bytes=raw, json_bytes=js))
        conts, import_ms = {}, {}
        for p in live + cold:
            stream, secs = import_when_free(serving, eng_b, p)
            conts[int(p['request_id'][1:])] = stream
            import_ms[int(p['request_id'][1:])] = secs * 1e3
        outs = [conts[i].result(600) for i in range(len(reqs))]
        ties, differ = [], []
        for i, (r, got, want) in enumerate(zip(reqs, outs, want_3a)):
            if got == want:
                continue
            t = _first_difference(got, want)
            gap = perturbed_margin(torch, model, dst.params,
                                   eng_b._adapters, r, want, t, device) \
                if r['temperature'] > 0 and len(got) == len(want) else None
            (ties if gap is not None and gap < TIE else differ).append(
                (i, t, gap))
        if differ:
            raise AssertionError('phase 3m (a): spliced streams differ from '
                                 '3a\'s where no near tie excuses it '
                                 '(request, token, perturbed margin): %s'
                                 % differ)
        mid_a = eng_a.stats()['counts']
        mid_b = eng_b.stats()['counts']
        da, db = _count_delta(mid_a, before_a), _count_delta(mid_b, before_b)
        want_pages = (sum(pages_for(p['pos'], PAGE_SIZE) for p in live),
                      sum(pages_for(p['pos'], MIGRATE_PAGE) for p in live))
        if db['prefills'] != len(cold) or db['migrated_in'] != len(live) or \
                da['migrated_out'] != len(reqs) or \
                (da['handoff_pages'], db['handoff_pages']) != want_pages:
            raise AssertionError('phase 3m (a): A %s, B %s, handoff pages '
                                 'expected %s' % (da, db, want_pages))

        # (b) prefill_only, the extending export of a prefix hit
        shared, _rs = shared_prompts(cfg, slots=slots, seed=seed)
        picks = [i for i in range(len(shared)) if i not in (slots, slots + 1)]
        po = [sess_a.generate(shared[i], max_new_tokens=new_tokens,
                              prefill_only=True, request_id='p%d' % i)
              for i in picks]
        for s in po:
            s.result(600)
        if any(s.finish_reason != 'migrated' or s.seqstate is None
               for s in po):
            raise AssertionError('phase 3m (b): prefill_only streams finished '
                                 '%s' % [s.finish_reason for s in po])
        staged = [s.seqstate for s in po]
        extending = sum(1 for p in staged if not p['emitted'])
        conts_b = [import_when_free(serving, eng_b, p)[0] for p in staged]
        outs_b = [c.result(600) for c in conts_b]
        wrong = [i for i, got in zip(picks, outs_b) if got != want_3s[i]]
        end_a = eng_a.stats()['counts']
        end_b = eng_b.stats()['counts']
        pa, pb = _count_delta(end_a, mid_a), _count_delta(end_b, mid_b)
        if wrong or pa['prefill_exports'] != len(picks) or pb['prefills'] or \
                extending != len(picks) - 1 or \
                pa['prefix_hits'] != len(picks) - 1:
            raise AssertionError('phase 3m (b): streams %s differ from 3s\'s; '
                                 'A %s, B %s, %d extending exports'
                                 % (wrong, pa, pb, extending))
        launches = kernels.launch_counts()
        ta, tb = _count_delta(end_a, before_a), _count_delta(end_b, before_b)
        prefills = ta['prefills'] + tb['prefills']
        steps = ta['steps'] + tb['steps']
        want = dict.fromkeys(launches, 0)
        want['flash_attention_fwd'] = layers * prefills
        want['flash_paged_decode_fwd'] = layers * steps
        want['threefry_gumbel'] = prefills + steps
        if device.type == 'cuda' and launches != want:
            raise AssertionError('phase 3m: kernel launches %r, expected %r'
                                 % (launches, want))
        refused = next(p for p in live if p.get('adapter_id'))
    finally:
        sess_a.close()
        sess_b.close()
    if (storage(src), storage(dst)) != held:
        raise AssertionError('phase 3m: an export or import replaced a pool '
                             'tensor the captured programs hold')
    del src, sess_a, eng_a
    # each live payload alone on B, its trie empty: a fresh generate of the
    # same context first (so that it hits nothing the import registered),
    # then the import
    sess_c = session(dst)
    solo = []
    try:
        eng_c = sess_c._engine
        for p in live:
            i = int(p['request_id'][1:])
            r = reqs[i]
            context = p['prompt'] + p['emitted']
            if len(context) > dst.max_prompt_len():
                solo.append(dict(request=i, context=len(context)))
                continue
            fresh = sess_c.generate(context, max_new_tokens=1,
                                    adapter=r['adapter'],
                                    temperature=r['temperature'],
                                    top_p=r['top_p'], seed=r['seed'])
            fresh_tok = fresh.result(600)
            t0 = time.perf_counter()
            stream = eng_c.import_sequence(p, timeout=600)
            imp_ms = (time.perf_counter() - t0) * 1e3
            first = next(iter(stream))
            first_ms = (time.perf_counter() - t0) * 1e3
            again = eng_c.export_sequence(stream, timeout=600)
            sec = stream.export_seconds
            raw, js = payload_bytes(again)
            solo.append(dict(request=i, context=len(context),
                             import_ms=imp_ms, first_token_ms=first_ms,
                             landed_ms=stream.ttft_s * 1e3,
                             fresh_ttft_ms=fresh.ttft_s * 1e3,
                             same_token=fresh_tok == [first],
                             export_pos=again['pos'],
                             gather_ms=sec['gather_s'] * 1e3,
                             build_ms=sec['build_s'] * 1e3,
                             raw_bytes=raw, json_bytes=js))
        if eng_c.stats()['counts']['prefix_hits']:
            raise AssertionError('phase 3m: the solo generates hit the trie')
    finally:
        sess_c.close()
    return dict(exports=exports, import_ms=import_ms, ties=ties,
                export_all_s=export_all_s, live=len(live), cold=len(cold),
                handoff_pages=want_pages, a=da, b=db, prefill_only=pa,
                extending=extending, launches=launches, solo=solo,
                refused=refused)


def drain_http(torch, serving, kernels, child, port, greedy, refused,
               cfg=SLICE, slots=SLOTS, buckets=BUCKETS,
               new_tokens=NEW_TOKENS, seed=0, device=None):
    """Phase 3m (c)-(d) with 3h's main child (the reloaded 3p program,
    ``spec_k`` 3 and its draft), whose endpoint's preemption hook is
    armed. In process, destination B' (the same weights at page size
    ``MIGRATE_PAGE``, no draft: a speculative source into a plain
    destination) behind an endpoint. (d): ``/import`` of ``refused`` (an
    adapter-pinned payload of 3m (a)) with one base64 character of an
    entry changed answers 400 (torn), and unchanged also 400 (B' serves
    no adapters). (c): ``DRAIN_STREAMS`` of 3p's greedy requests stream
    from the child with request ids; once each has ``DRAIN_AFTER`` tokens
    the child gets SIGTERM: every done line ``migrated`` with its request
    id, ``/healthz`` 503 ``draining``, a ``/generate`` and an ``/import``
    shed 503 ``Draining``, ``GET /drain?request_id=`` serves each payload,
    ``POST /import`` into B' with ``start_index`` continues each (no
    prefill, indices 0..n-1 unbroken, the first ``NEW_TOKENS`` 3p's, every
    token teacher-forced), and the child exits 75 within the drain budget
    after printing ``handed_off`` 8. Returns a dict of results."""
    import signal
    import threading
    device = device or torch.device('cuda')
    layers = cfg['layers']
    model, params = serving.init_transformer_lm(seed=seed, **cfg)
    prog = serving.freeze_decode(model, params, slots=slots,
                                 prefill_buckets=buckets,
                                 page_size=MIGRATE_PAGE, device=device)
    del params
    sess = serving.InferenceSession(prog, timeout_s=600,
                                    max_new_tokens=new_tokens)
    srv = serving.ServingHTTPServer(sess, 0).start()
    try:
        # (d) typed refusals
        torn = json.loads(json.dumps(refused))
        blk = torn['entries'][sorted(torn['entries'])[0]]
        mid = len(blk['data']) // 2
        blk['data'] = blk['data'][:mid] + (
            'B' if blk['data'][mid] != 'B' else 'C') + blk['data'][mid + 1:]
        refusals = {'torn': _http_json(srv.port, 'POST', '/import',
                                       {'seqstate': torn}),
                    'adapter': _http_json(srv.port, 'POST', '/import',
                                          {'seqstate': refused})}
        if refusals['torn'][0] != 400 or \
                'torn' not in refusals['torn'][1]['error'] or \
                refusals['adapter'][0] != 400 or \
                'adapter' not in refusals['adapter'][1]['error']:
            raise AssertionError('phase 3m (d): /import answered %s'
                                 % refusals)
        del torn

        # (c) the drain of a real process over HTTP
        reqs = greedy[:DRAIN_STREAMS]
        lines = [[] for _ in reqs]
        done = [None] * len(reqs)
        cv = threading.Condition()

        def run(i):
            import http.client
            conn = http.client.HTTPConnection('127.0.0.1', port,
                                              timeout=HTTP_BUDGET_S)
            try:
                conn.request('POST', '/generate', body=json.dumps({
                    'tokens': reqs[i][0], 'max_new_tokens': DRAIN_TOKENS,
                    'request_id': 'drain-%d' % i}).encode(),
                    headers={'Content-Type': 'application/json'})
                resp = conn.getresponse()
                for raw in resp:
                    line = json.loads(raw)
                    with cv:
                        if 'token' in line:
                            lines[i].append(line)
                        else:
                            done[i] = line
                        cv.notify_all()
            finally:
                conn.close()
                with cv:
                    if done[i] is None:
                        done[i] = {'error': 'no done line'}
                    cv.notify_all()

        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        with cv:
            ready = cv.wait_for(lambda: all(
                len(ln) >= DRAIN_AFTER for ln in lines)
                or any(d is not None for d in done), HTTP_BUDGET_S)
        if not ready or any(d is not None for d in done):
            raise AssertionError('phase 3m (c): the streams before SIGTERM: '
                                 '%s tokens, done %s' % (
                                     [len(ln) for ln in lines], done))
        exited = {}

        def wait_exit():
            rc = child.proc.wait(HTTP_BUDGET_S)
            exited.update(rc=rc, s=time.perf_counter() - t_term)

        t_term = time.perf_counter()
        child.proc.send_signal(signal.SIGTERM)
        waiter = threading.Thread(target=wait_exit, daemon=True)
        waiter.start()
        for t in threads:
            t.join(HTTP_BUDGET_S)
        bad = [(i, d) for i, d in enumerate(done)
               if d is None or 'error' in d
               or d.get('finish_reason') != 'migrated'
               or d.get('request_id') != 'drain-%d' % i
               or d.get('tokens') != [ln['token'] for ln in lines[i]]
               or [ln['index'] for ln in lines[i]] != list(range(len(
                   lines[i])))]
        if bad:
            raise AssertionError('phase 3m (c): done lines %s' % bad)
        shed = {'healthz': _http_json(port, 'GET', '/healthz'),
                'generate': _http_json(port, 'POST', '/generate', {
                    'tokens': reqs[0][0]}),
                'import': _http_json(port, 'POST', '/import', {
                    'seqstate': {}})}
        if shed['healthz'] != (503, {'ok': False, 'status': 'draining'}) or \
                any(shed[k][0] != 503 or shed[k][1].get('error_class')
                    != 'Draining' for k in ('generate', 'import')):
            raise AssertionError('phase 3m (c): while draining %s' % shed)
        payloads, drain_ms = [], []
        for i in range(len(reqs)):
            deadline = time.monotonic() + HTTP_BUDGET_S
            while True:
                t0 = time.perf_counter()
                code, snap = _http_json(port, 'GET',
                                        '/drain?request_id=drain-%d' % i)
                ms = (time.perf_counter() - t0) * 1e3
                if code != 200 or snap['schema'] != 'mxnet_tpu.drain.v1':
                    raise AssertionError('phase 3m (c): /drain answered %d '
                                         '%s' % (code, snap))
                if snap['sequences']:
                    break
                if time.monotonic() > deadline:
                    raise AssertionError('phase 3m (c): no payload for '
                                         'drain-%d' % i)
                time.sleep(0.01)
            p = snap['sequences'][0]
            if p['request_id'] != 'drain-%d' % i or \
                    p['emitted'] != done[i]['tokens']:
                raise AssertionError('phase 3m (c): /drain served %s for '
                                     'drain-%d' % (p['request_id'], i))
            payloads.append(p)
            drain_ms.append(ms)
        before = sess.stats()['counts']
        kernels.reset_launch_counts()

        def land(p):
            t0 = time.perf_counter()
            got = _http_stream(srv.port, {'seqstate': p,
                                          'start_index': len(p['emitted'])},
                               path='/import')
            return got, (time.perf_counter() - t0) * 1e3

        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(len(payloads)) as pool:
            landed = list(pool.map(land, payloads))
        spliced, import_ms = [], []
        for i, ((toks, dl, _ttft, _at), ms) in enumerate(landed):
            import_ms.append(ms)
            idx = [ln['index'] for ln in lines[i]] + [t['index']
                                                       for t in toks]
            got = [ln['token'] for ln in lines[i]] + [t['token'] for t in toks]
            if idx != list(range(DRAIN_TOKENS)) or got != dl.get('tokens') \
                    or dl.get('request_id') != 'drain-%d' % i \
                    or dl.get('finish_reason') != 'length' \
                    or got[:new_tokens] != reqs[i][1]:
                raise AssertionError('phase 3m (c): drain-%d spliced %d '
                                     'tokens, indices %s, done %s' % (
                                         i, len(got), idx[:8] + ['...'],
                                         {k: v for k, v in dl.items()
                                          if k != 'tokens'}))
            spliced.append(got)
        launches = kernels.launch_counts()
        c = _count_delta(sess.stats()['counts'], before)
        want = dict.fromkeys(launches, 0)
        want['flash_paged_decode_fwd'] = layers * c['steps']
        want['threefry_gumbel'] = c['steps']
        if c['prefills'] or c['migrated_in'] != len(reqs) or \
                (device.type == 'cuda' and launches != want):
            raise AssertionError('phase 3m (c): B\' %s, launches %r, '
                                 'expected %r' % (c, launches, want))
        drained = child.expect('DRAINED', CHILD_DONE_S)
        waiter.join(CHILD_DONE_S)
        rc, exit_s = exited.get('rc'), exited.get('s', float('inf'))
        res = drained['drain'] or {}
        if rc != 75 or res.get('rc') != 75 or \
                res.get('sequences') != len(reqs) or \
                res.get('handed_off') != len(reqs) or \
                not exit_s < DRAIN_BUDGET_S:
            raise AssertionError('phase 3m (c): the child exited %s after '
                                 '%.3f s, drain %s' % (rc, exit_s, res))
        equal, ties = teacher_forced(torch, model, prog.params,
                                     [r[0] for r in reqs], spliced, device)
    finally:
        srv.stop()
        sess.close()
    return dict(refusals={k: v[0] for k, v in refusals.items()},
                drain_ms=drain_ms, import_ms=import_ms, exit_s=exit_s,
                drained=drained, result=res, launches=launches,
                streamed=[len(ln) for ln in lines], counts=c,
                recheck_equal=equal, recheck_ties=ties)



def log_migration(rm, card):
    """Phase 3m (a)-(b)'s lines: each live sequence's export (the gather
    and the copy on the worker, the document's build apart, its bytes),
    the imports, the solo continuation against a fresh prefill."""
    for e in rm['exports']:
        log('phase 3m (a) export [%s]: request %d at pos %d (%d tokens '
            'emitted): gather + D2H %.3f ms, payload build %.3f ms, rows %d '
            'B raw, %d B of JSON; import %.3f ms'
            % (card, e['request'], e['pos'], e['emitted'], e['gather_ms'],
               e['build_ms'], e['raw_bytes'], e['json_bytes'],
               rm['import_ms'][e['request']]))
    cold_ms = [ms for i, ms in rm['import_ms'].items()
               if i not in {e['request'] for e in rm['exports']}]
    log('phase 3m (a) [%s]: export_all of %d live and %d cold sequences in '
        '%.3f s; the %d spliced streams equal to 3a\'s but at %d near ties '
        '%s; A %s; B %s (cold imports %.3f ms mean); handoff pages (16, 128) '
        '%s' % (card, rm['live'], rm['cold'], rm['export_all_s'],
                rm['live'] + rm['cold'], len(rm['ties']), rm['ties'],
                {k: rm['a'][k] for k in ('migrated_out', 'handoff_pages',
                                         'prefills', 'steps')},
                {k: rm['b'][k] for k in ('migrated_in', 'handoff_pages',
                                         'prefills', 'steps')},
                statistics.mean(cold_ms), rm['handoff_pages']))
    log('phase 3m (b) [%s]: %d prefill_only requests of 3s\'s prefix, %d of '
        'them exported extending (a prefix hit, no token); B\'s streams '
        'token for token 3s\'s with no prefill; A %s; launches of (a) and (b) '
        '%s' % (card, rm['prefill_only']['prefill_exports'], rm['extending'],
                {k: rm['prefill_only'][k] for k in (
                    'prefill_exports', 'prefix_hits', 'prefills')},
                {k: v for k, v in rm['launches'].items() if v}))
    for s in rm['solo']:
        if 'import_ms' not in s:
            log('phase 3m solo [%s]: request %d: context %d past the top '
                'bucket, no fresh prefill to compare' % (card, s['request'],
                                                         s['context']))
            continue
        log('phase 3m solo [%s]: request %d, context %d: import %.3f ms, '
            'first continuation token %.3f ms after the import call (%.3f '
            'ms after the rows landed); a fresh generate(prompt + emitted) '
            'TTFT %.3f ms; same token %s; exported again alone at pos %d: '
            'gather + D2H %.3f ms, payload build %.3f ms, %d B raw, %d B of '
            'JSON' % (card, s['request'], s['context'], s['import_ms'],
                      s['first_token_ms'], s['landed_ms'],
                      s['fresh_ttft_ms'], s['same_token'], s['export_pos'],
                      s['gather_ms'], s['build_ms'], s['raw_bytes'],
                      s['json_bytes']))
    log('phase 3m (a)-(b): %.1f s in all' % rm['seconds'])


def log_drain(d, card):
    """Phase 3m (c)-(d)'s lines."""
    log('phase 3m (d) [%s]: /import of a payload with one base64 character '
        'changed %d, of an adapter-pinned payload into an engine without '
        'adapters %d' % (card, d['refusals']['torn'],
                         d['refusals']['adapter']))
    log('phase 3m (c) [%s]: %d streams of 3p\'s prompts, SIGTERM after %d '
        'tokens each (streamed %s at the drain); every done line migrated '
        'with its request id; /healthz 503 draining, /generate and /import '
        '503 Draining; GET /drain?request_id= %s ms; POST /import into B\' '
        '(page %d, no draft), the 8 at once, %s ms a stream (its whole '
        'continuation); '
        'indices unbroken, the first %d tokens 3p\'s, %d tokens '
        'teacher-forced equal, %d ties %s; B\' %s; drain %s; SIGTERM to '
        'exit %.3f s, rc 75'
        % (card, len(d['drain_ms']), DRAIN_AFTER, d['streamed'],
           [round(x, 3) for x in d['drain_ms']], MIGRATE_PAGE,
           [round(x, 3) for x in d['import_ms']], NEW_TOKENS,
           d['recheck_equal'], len(d['recheck_ties']), d['recheck_ties'],
           {k: d['counts'][k] for k in ('migrated_in', 'prefills', 'steps')},
           d['result'], d['exit_s']))


# -- phase 3g: the serving gateway over a fleet of the port's replicas -------

FLEET_HEALTH_S = 0.25      # the gateway's probe period
FLEET_BUDGET_S = 120.0     # any one part's waits
FLEET_KILL_AFTER = 4       # tokens each child stream has before SIGKILL
# (a)'s in-process replica also prefills at 384: a moved stream re-admits
# prompt + emitted, which passes 256 for 3p's longer prompts
FLEET_LADDER = BUCKETS + (384,)
FLEET_TENANT = dict(tenant_rps=2.0, tenant_burst=2.0, tenant_max_inflight=8)
TENANT_BURST = 16          # requests the bursting tenant sends at once
TENANT_STEADY = 3          # the steady tenant's, one every 0.5 s
TENANT_TOKENS = 8
SMALL_POOL = 4             # pages of (c)'s refusing decode replica: 48 tokens
SOLO_PROMPTS = (64, 128, 250)   # (c)'s fresh prompts, one at a time
STATUS_CALLS = 20          # GET /status calls timed on a decode replica


class _FleetReplica:
    """An in-process replica of phase 3g: a decode session over ``prog``
    behind its own ``ServingHTTPServer`` (at ``port``, 0 for a free one).
    Each prefill call is timed (start, seconds, its tokens), and each payload
    its engine imports recorded (call time, request id, emitted tokens,
    the payload)."""

    def __init__(self, serving, prog, name, port=0):
        self.name, self.prog = name, prog
        self.sess = serving.InferenceSession(prog, timeout_s=600,
                                             max_new_tokens=NEW_TOKENS)
        self.eng = self.sess._engine
        self.prefills, self.imports = [], []
        run_prefill, import_sequence = prog.run_prefill, \
            self.eng.import_sequence

        def timed(pool, tokens, page_ids, **extras):
            t0 = time.perf_counter()
            out = run_prefill(pool, tokens, page_ids, **extras)
            self.prefills.append((t0, time.perf_counter() - t0, tokens))
            return out

        def recorded(payload, timeout=30.0, **kw):
            t0 = time.perf_counter()
            stream = import_sequence(payload, timeout, **kw)
            self.imports.append(dict(t=t0, rid=payload.get('request_id'),
                                     emitted=len(payload.get('emitted')
                                                 or ()), payload=payload))
            return stream

        prog.run_prefill = timed
        self.eng.import_sequence = recorded
        self.srv = serving.ServingHTTPServer(self.sess, port).start()
        self.port = self.srv.port
        self.url = 'http://127.0.0.1:%d' % self.port

    def counts(self):
        return self.eng.stats()['counts']

    def restart(self, serving):
        """A new endpoint over the same session, on the same port."""
        self.srv = serving.ServingHTTPServer(self.sess, self.port).start()

    def close(self):
        self.srv.stop()
        self.sess.close()


def _fleet_rec():
    return {'status': None, 'tokens': [], 'indices': [], 'times': [],
            'done': None, 'error': None, 'finished': False, 'body': None,
            'headers': {}}


def _fleet_stream(port, body, rec, cv, headers=None):
    """One ``/generate`` through ``port`` (a gateway or a replica),
    recorded into ``rec`` under ``cv`` line by line: the status, token
    values, indices and arrival times, the done line, a refusal's body and
    headers, or the error that cut it."""
    import http.client
    conn = http.client.HTTPConnection('127.0.0.1', port,
                                      timeout=HTTP_BUDGET_S)
    try:
        hdrs = {'Content-Type': 'application/json'}
        hdrs.update(headers or {})
        rec['t0'] = time.perf_counter()
        conn.request('POST', '/generate', body=json.dumps(body).encode(),
                     headers=hdrs)
        resp = conn.getresponse()
        rec['status'], rec['headers'] = resp.status, dict(resp.headers)
        if resp.status != 200:
            rec['body'] = json.loads(resp.read() or b'{}')
            return rec
        for raw in resp:
            line = json.loads(raw)
            with cv:
                if 'token' in line:
                    rec['tokens'].append(line['token'])
                    rec['indices'].append(line['index'])
                    rec['times'].append(time.perf_counter())
                elif line.get('done'):
                    rec['done'] = line
                cv.notify_all()
    except Exception as exc:  # noqa: BLE001 - recorded, then checked
        rec['error'] = '%s: %s' % (type(exc).__name__, exc)
    finally:
        conn.close()
        with cv:
            rec['finished'] = True
            cv.notify_all()
    return rec


def _fleet_start(port, bodies, cv, headers=None):
    """Every body through ``port`` at once, a thread each."""
    import threading
    recs = [_fleet_rec() for _ in bodies]
    threads = [threading.Thread(target=_fleet_stream,
                                args=(port, b, r, cv, headers), daemon=True)
               for b, r in zip(bodies, recs)]
    for t in threads:
        t.start()
    return recs, threads


def _fleet_map(port, bodies, cv, clients=HTTP_CLIENTS):
    """Every body through ``port``, ``clients`` at a time."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(clients) as pool:
        return list(pool.map(lambda b: _fleet_stream(port, b, _fleet_rec(),
                                                      cv), bodies))


def _fleet_join(part, threads, budget=FLEET_BUDGET_S):
    deadline = time.monotonic() + budget
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            raise AssertionError('phase 3g %s: a stream outlived %.0f s'
                                 % (part, budget))


def _fleet_wait(part, cv, cond, budget=FLEET_BUDGET_S):
    with cv:
        if not cv.wait_for(cond, budget):
            raise AssertionError('phase 3g %s: not within %.0f s'
                                 % (part, budget))


def _fleet_ok(part, i, rec, n, want=None):
    """A whole stream: 200, ``n`` tokens, indices 0..n-1, a done line
    with no error whose tokens are the streamed ones (and ``want``, when
    given)."""
    d = rec['done']
    if rec['error'] or rec['status'] != 200 or d is None or 'error' in d \
            or rec['indices'] != list(range(n)) \
            or d.get('tokens') != rec['tokens'] \
            or (want is not None and rec['tokens'] != want):
        raise AssertionError(
            'phase 3g %s: stream %d: status %s, error %s, %d tokens, '
            'indices %s, done %s%s' % (
                part, i, rec['status'], rec['error'], len(rec['tokens']),
                rec['indices'][:8] + ['...'],
                d if d is None else {k: v for k, v in d.items()
                                     if k not in ('tokens', 'seqstate')},
                '' if want is None or rec['tokens'] == want
                else '; tokens %s, wanted %s' % (rec['tokens'], want)))


def _ttft(recs):
    return [r['times'][0] - r['t0'] for r in recs]


def _tenant_rejected(port, tenant):
    """The ``mxnet_tpu_gateway_tenant_rejected_total`` samples of
    ``tenant`` on the gateway's ``GET /metrics``, summed over reasons."""
    import urllib.request
    from mxnet_tpu_torch import observability
    text = urllib.request.urlopen('http://127.0.0.1:%d/metrics' % port,
                                  timeout=HTTP_BUDGET_S).read().decode()
    _types, samples = observability.parse_prometheus(text)
    return sum(v for name, labels, v in samples
               if name == 'mxnet_tpu_gateway_tenant_rejected_total'
               and labels.get('tenant') == tenant)


def serve_fleet(torch, serving, kernels, arts, want_3p, sampled, card,
                cfg=SLICE, slots=SLOTS, buckets=BUCKETS,
                new_tokens=NEW_TOKENS, seed=0, device=None):
    """Phase 3g: 3p's program behind the port's ``ServingGateway``
    (health period 0.25 s, resume and affinity on), at full width.
    ``want_3p`` are 3p's 16 greedy streams, ``sampled`` (request, stream)
    pairs of 3a's sampled base requests, ``arts`` 3h's artifacts. The
    replicas: a child process loading 3h's LM artifact (as 3h spawns its
    main child: its draft through ``MXNET_TPU_SERVE_SPEC_DRAFT``), and in
    process ``relay``, ``pre``, ``first`` (the ladder to 384) and
    ``second`` (page 16), ``b128`` (page 128) and ``small`` (page 16,
    ``SMALL_POOL`` pages).
    Parts, each with its own waits: the relay's cost (3p's 16 requests 8
    at a time straight to ``relay`` with its trie cold, then through a
    gateway and straight again, both warm); (a) failover by a process
    death; (d) tenant admission; (c) disaggregated prefill / decode with (e) a traced request and a
    typed refusal; (b) the drain of ``first`` through the gateway into
    ``b128``. Then the in-process launches against the engines'
    arithmetic, the programs, the near ties. Returns a dict of results.
    """
    import threading
    import numpy as np
    from mxnet_tpu_torch import observability
    from mxnet_tpu_torch.observability import trace
    device = device or torch.device('cuda')
    layers = cfg['layers']
    rs = np.random.RandomState(seed)
    lens = rs.randint(8, 257, size=REQUESTS)
    prompts = [rs.randint(0, cfg['vocab'], size=n).tolist() for n in lens]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith('MXNET_TPU_')}
    env.update(MXNET_TPU_SERVE_SPEC_K=str(SPEC_K),
               MXNET_TPU_SERVE_SPEC_DRAFT=arts['draft']['path'])
    child = _Child('fleet', arts, env, os.path.join(
        os.path.dirname(arts['lm']['path']), 'fleet.log'))
    reps, gws = [], []
    observability.set_enabled(True)
    cv = threading.Condition()
    res = {}
    try:
        # the in-process replicas while the child loads and captures
        t0 = time.perf_counter()
        model, params = serving.init_transformer_lm(seed=seed, **cfg)

        def replica(name, ladder=buckets, **kw):
            prog = serving.freeze_decode(model, params, slots=slots,
                                         prefill_buckets=ladder,
                                         device=device, **kw)
            rep = _FleetReplica(serving, prog, name)
            check_programs('phase 3g %s' % name, prog,
                           program_set(ladder, True), True)
            reps.append(rep)
            return rep

        relay = replica('relay')
        pre = replica('pre')
        first = replica('first', FLEET_LADDER)
        second = replica('second')
        b128 = replica('b128', page_size=MIGRATE_PAGE)
        small = replica('small', pages=SMALL_POOL)
        del params
        for rep in (relay, first, second):
            # library handles and the allocator before anything is timed
            rep.sess.generate(prompts[0][:8], max_new_tokens=2).result(600)
        res['build_s'] = time.perf_counter() - t0
        ready = child.expect('READY', CHILD_READY_S)
        if ready['modules']:
            raise AssertionError('phase 3g: the child imported %s'
                                 % ready['modules'])
        child_url = 'http://127.0.0.1:%d' % ready['port']
        res['child_ready_s'] = ready['captured'] - child.spawned
        programs = {r.name: r.prog.compile_count for r in reps}
        before = {r.name: r.counts() for r in reps}
        kernels.reset_launch_counts()
        t_traffic = time.perf_counter()

        def gateway(replicas, **kw):
            gw = serving.ServingGateway(
                replicas, port=0, health_period_s=FLEET_HEALTH_S,
                timeout_s=HTTP_BUDGET_S, resume=True, affinity=True,
                **kw).start()
            gws.append(gw)
            return gw

        greedy = [{'tokens': p, 'max_new_tokens': new_tokens}
                  for p in prompts]

        # the relay's cost, on a replica of its own (the others keep empty
        # tries): straight to it cold, then through a gateway and straight
        # to it again, both over its warm trie
        gw = gateway([relay.url])
        runs = {}
        for part, port in (('cold', relay.port), ('gateway', gw.port),
                           ('direct', relay.port)):
            t0 = time.perf_counter()
            recs = _fleet_map(port, greedy, cv)
            wall = time.perf_counter() - t0
            for i, (rec, want) in enumerate(zip(recs, want_3p)):
                _fleet_ok('relay ' + part, i, rec, new_tokens, want)
            runs[part] = dict(ttft_p50_ms=percentile(_ttft(recs), 50) * 1e3,
                              ttft_p99_ms=percentile(_ttft(recs), 99) * 1e3,
                              tokens_per_s=len(recs) * new_tokens / wall,
                              wall_s=wall)
        res['relay'] = runs
        gw.stop()

        # (a) failover by a process death
        gw = gateway([child_url, first.url])
        on_child = [gw.affinity_target(p) == child_url for p in prompts]
        recs, threads = _fleet_start(gw.port, greedy, cv)
        _fleet_wait('(a)', cv, lambda: all(
            len(r['tokens']) >= FLEET_KILL_AFTER or r['finished']
            for r, c in zip(recs, on_child) if c))
        child_doc = child.stats()   # its launches just before the kill
        t_kill = time.perf_counter()
        child.proc.kill()
        child.proc.wait(CHILD_DONE_S)
        exit_ms = (time.perf_counter() - t_kill) * 1e3
        _fleet_join('(a)', threads)
        moved = [i for i, r in enumerate(recs)
                 if r['done'] is not None and r['done'].get('resumed')]
        for i, rec in enumerate(recs):
            _fleet_ok('(a)', i, rec, new_tokens,
                      None if i in moved else want_3p[i])
        health = _http_json(gw.port, 'GET', '/healthz')
        st = gw.stats()
        if not moved or any(not on_child[i] or recs[i]['done']['resumed'] != 1
                            for i in moved) \
                or st['resumes'] != len(moved) or st['resume_failures'] \
                or health[0] != 200 or health[1]['status'] != 'degraded' \
                or health[1]['healthy'] != 1:
            raise AssertionError('phase 3g (a): moved %s (on the child %s), '
                                 'gateway %s, /healthz %s'
                                 % (moved, [i for i, c in enumerate(on_child)
                                            if c], st, health))
        gaps = {i: max(b - a for a, b in zip(recs[i]['times'],
                                              recs[i]['times'][1:])) * 1e3
                for i in moved}

        def readmits(tokens):
            # a moved prompt and the tokens emitted before the kill
            return any(len(tokens) > len(prompts[i])
                       and list(tokens[:len(prompts[i])]) == prompts[i]
                       for i in moved)
        res['a'] = dict(
            on_child=sum(on_child), moved=moved, exit_ms=exit_ms,
            moved_tokens=[recs[i]['tokens'] for i in moved],
            emitted_at_kill=[sum(t <= t_kill for t in recs[i]['times'])
                             for i in moved],
            gap_ms=gaps, readmit_ms=[(round(s * 1e3, 3), len(toks))
                                     for t, s, toks in first.prefills
                                     if t >= t_kill and readmits(toks)],
            child_counts=child_doc['counts'],
            child_launches=child_doc['launches'], health=health[1],
            stats={k: st[k] for k in ('resumes', 'failovers',
                                      'resume_failures')})
        gw.stop()

        # (d) tenant admission
        gw = gateway([first.url], **FLEET_TENANT)
        rejected0 = _tenant_rejected(gw.port, 'burst')
        short = [{'tokens': p, 'max_new_tokens': TENANT_TOKENS}
                 for p in prompts]
        burst, threads = _fleet_start(gw.port, short[:TENANT_BURST], cv,
                                      headers={'X-Tenant': 'burst'})
        steady = []
        for i in range(TENANT_STEADY):
            got, more = _fleet_start(gw.port, [short[i]], cv,
                                     headers={'X-Tenant': 'steady'})
            steady += got
            threads += more
            time.sleep(0.5)
        _fleet_join('(d)', threads)
        for i, rec in enumerate(steady):
            _fleet_ok('(d) steady', i, rec, TENANT_TOKENS,
                      want_3p[i][:TENANT_TOKENS])
        shed = [r for r in burst if r['status'] == 429]
        for i, rec in enumerate(burst):
            if rec['status'] == 200:
                _fleet_ok('(d) burst', i, rec, TENANT_TOKENS,
                          want_3p[i][:TENANT_TOKENS])
        hint_max = 1.0 / FLEET_TENANT['tenant_rps']
        bad = [r for r in shed if r['body'].get('tenant') != 'burst'
               or 'rate_limit' not in r['body'].get('error', '')
               or not 0 < r['body'].get('retry_after_s', 0) <= hint_max
               or r['headers'].get('Retry-After') != '1']
        rejected = _tenant_rejected(gw.port, 'burst') - rejected0
        st = gw.stats()
        if bad or not shed or len(shed) + sum(
                r['status'] == 200 for r in burst) != TENANT_BURST \
                or rejected != len(shed) or st['tenant_shed'] != len(shed) \
                or st['tenants']['steady']['shed']:
            raise AssertionError('phase 3g (d): %d 429s (%d malformed: %s), '
                                 '%s on /metrics, gateway %s'
                                 % (len(shed), len(bad),
                                    [r['body'] for r in bad[:2]], rejected,
                                    st))
        res['d'] = dict(shed=len(shed), admitted=TENANT_BURST - len(shed),
                        steady=len(steady), metrics=rejected,
                        retry_after_s=[r['body']['retry_after_s']
                                       for r in shed],
                        tenants=st['tenants'])
        gw.stop()

        # (c) disaggregated prefill / decode, pre (an empty trie) the
        # prefill class
        gw = gateway([(pre.url, 'prefill'), (b128.url, 'decode'),
                      (second.url, 'decode')])
        c0 = {r.name: r.counts() for r in (pre, b128, second)}
        bodies = [dict(g, request_id='c%d' % i) for i, g in enumerate(greedy)]
        bodies += [{'tokens': r['prompt'], 'max_new_tokens': new_tokens,
                    'temperature': r['temperature'], 'top_p': r['top_p'],
                    'seed': r['seed'], 'request_id': 'c%d' % (len(greedy) + i)}
                   for i, (r, _out) in enumerate(sampled)]
        # then one at a time, prompts no trie holds: the handoff alone,
        # beside the same prompts' monolithic TTFT on relay
        fresh = np.random.RandomState(seed + 5)
        solo = [fresh.randint(0, cfg['vocab'], size=n).tolist()
                for n in SOLO_PROMPTS]
        mono = [_fleet_stream(relay.port, {'tokens': p, 'max_new_tokens':
                                           new_tokens}, _fleet_rec(), cv)
                for p in solo]
        n_imp = {r.name: len(r.imports) for r in (b128, second)}
        recs = _fleet_map(gw.port, bodies, cv)
        recs += [_fleet_stream(gw.port, {'tokens': p, 'max_new_tokens':
                                         new_tokens, 'request_id': 's%d' % i},
                               _fleet_rec(), cv) for i, p in enumerate(solo)]
        for i, rec in enumerate(recs):
            _fleet_ok('(c)', i, rec, new_tokens,
                      want_3p[i] if i < len(greedy) else None)
        for i, (rec, m) in enumerate(zip(recs[len(bodies):], mono)):
            _fleet_ok('(c) monolithic', i, m, new_tokens, rec['tokens'])
        st = gw.stats()
        c1 = {r.name: r.counts() for r in (pre, b128, second)}
        dc = {n: _count_delta(c1[n], c0[n]) for n in c1}
        landed = {n: dc[n]['migrated_in'] for n in ('b128', 'second')}
        if st['handoff']['spliced'] != len(recs) \
                or st['handoff']['fallbacks'] \
                or dc['b128']['prefills'] or dc['second']['prefills'] \
                or dc['pre']['prefill_exports'] != len(recs) \
                or dc['pre']['migrated_out'] != sum(landed.values()) \
                or sum(landed.values()) != len(recs) \
                or not all(landed.values()):
            raise AssertionError('phase 3g (c): gateway %s; prefill %s; '
                                 'decode %s' % (st['handoff'], dc['pre'],
                                                {n: dc[n] for n in landed}))
        imports = {imp['rid']: imp for r in (b128, second)
                   for imp in r.imports[n_imp[r.name]:]}
        rids = ['c%d' % i for i in range(len(bodies))] + [
            's%d' % i for i in range(len(solo))]
        rows = []
        for rid, rec in zip(rids, recs):
            imp = imports[rid]
            # a payload with a token: the prefill's; the gap to the next
            # one is the handoff (the done line, its parse, the pick, the
            # POST, the import, a first step); an extending payload (a
            # prefix hit) carries none, and the first token is the decode
            # replica's
            rows.append(dict(
                rid=rid, emitted=imp['emitted'],
                ttft_ms=(rec['times'][0] - rec['t0']) * 1e3,
                handoff_ms=(rec['times'][1] - rec['times'][0]) * 1e3
                if imp['emitted'] else None,
                json_bytes=payload_bytes(imp['payload'])[1]))
        for imp in imports.values():
            imp.pop('payload')
        res['c'] = dict(
            handoff=st['handoff'], landed=landed, prefill=dc['pre'],
            pool=st['classes']['decode']['pool'], rows=rows,
            mono_ttft_ms=[(m['times'][0] - m['t0']) * 1e3 for m in mono],
            sampled_tokens=[r['tokens']
                            for r in recs[len(greedy):len(bodies)]],
            solo=solo, solo_tokens=[r['tokens'] for r in recs[len(bodies):]])
        # the least-loaded pick's cost: one decode replica's GET /status
        status_ms = []
        for _ in range(STATUS_CALLS):
            t0 = time.perf_counter()
            _http_json(second.port, 'GET', '/status')
            status_ms.append((time.perf_counter() - t0) * 1e3)
        res['c']['status_ms'] = status_ms

        # (e) a traced request through (c)'s path
        # each replica's handler notes the trace header it was sent
        seen = []
        handlers = {r.name: r.srv._httpd.RequestHandlerClass
                    for r in (pre, b128, second)}
        posts = {n: h.do_POST for n, h in handlers.items()}
        for name, h in handlers.items():
            def do_post(self, _orig=posts[name], _name=name):
                seen.append((_name, self.path,
                             self.headers.get(trace.TRACE_HEADER)))
                return _orig(self)
            h.do_POST = do_post
        trace.set_enabled(True)
        try:
            ctx = trace.TraceContext.new()
            rec = _fleet_stream(gw.port, {'tokens': prompts[1],
                                          'max_new_tokens': TENANT_TOKENS},
                                _fleet_rec(), cv,
                                headers={trace.TRACE_HEADER: ctx.to_header()})
            _fleet_ok('(e)', 0, rec, TENANT_TOKENS,
                      want_3p[1][:TENANT_TOKENS])
            want_names = {'gw.request', 'gw.route', 'gw.relay', 'gw.handoff',
                          'gw.splice'}
            import urllib.request
            deadline = time.monotonic() + FLEET_BUDGET_S
            while True:
                spans = [r for r in trace.read_ndjson(urllib.request.urlopen(
                    gw.base_url + '/trace', timeout=HTTP_BUDGET_S).read())
                    if r['trace'] == ctx.trace_id]
                if want_names <= {r['name'] for r in spans} \
                        or time.monotonic() > deadline:
                    break
                time.sleep(0.02)
        finally:
            trace.set_enabled(None)
            for name, h in handlers.items():
                h.do_POST = posts[name]
        tree = trace.stitch(spans).get(ctx.trace_id)
        hops = [(name, path, trace.parse_header(hdr).trace_id
                 if hdr else None) for name, path, hdr in seen]
        if not want_names <= {r['name'] for r in spans} or tree is None \
                or trace.tree_verdict(tree) is not True \
                or sorted(p for _n, p, t in hops if t == ctx.trace_id) \
                != ['/generate', '/import'] \
                or any(t not in (None, ctx.trace_id) for _n, _p, t in hops):
            raise AssertionError('phase 3g (e): spans %s, replica hops %s'
                                 % (sorted(r['name'] for r in spans), hops))
        res['e'] = dict(spans=sorted(r['name'] for r in spans), hops=hops,
                        verdict=True, waterfall=trace.waterfall(tree))
        gw.stop()

        # (c) a decode replica whose pool is too small: its typed refusal
        # moves the payload on
        gw = gateway([(pre.url, 'prefill'), (small.url, 'decode'),
                      (second.url, 'decode')])
        longest = max(range(len(prompts)), key=lambda i: len(prompts[i]))
        hog = second.sess.generate([1, 2, 3, 4, 5, 6, 7, 8],
                                   max_new_tokens=cfg['max_len'] - 16)
        next(iter(hog))         # live: second's pool is not empty
        pre = {r.name: r.counts() for r in (small, second)}
        rec = _fleet_stream(gw.port, greedy[longest], _fleet_rec(), cv)
        hog.cancel()
        _fleet_ok('(c) refusal', longest, rec, new_tokens, want_3p[longest])
        st = gw.stats()
        dr = {r.name: _count_delta(r.counts(), pre[r.name])
              for r in (small, second)}
        if st['handoff']['retries'] < 1 or st['handoff']['spliced'] != 1 \
                or st['handoff']['fallbacks'] \
                or dr['small']['pool_exhausted'] < 1 \
                or dr['small']['migrated_in'] or dr['second']['migrated_in'] \
                != 1:
            raise AssertionError('phase 3g (c) refusal: gateway %s, small %s,'
                                 ' second %s' % (st['handoff'], dr['small'],
                                                 dr['second']))
        res['c']['refusal'] = dict(handoff=st['handoff'],
                                   pool=st['classes']['decode']['pool'],
                                   prompt=len(prompts[longest]))
        gw.stop()

        # (b) the drain of first through the gateway into b128
        b128.srv.stop()         # down: every stream lands on first
        gw = gateway([first.url, b128.url])
        if gw.replicas[1].healthy:
            raise AssertionError('phase 3g (b): b128 read healthy while down')
        pre = b128.counts()
        n_imp = len(b128.imports)
        drain_bodies = [{'tokens': p, 'max_new_tokens': DRAIN_TOKENS,
                         'request_id': 'drain-%d' % i}
                        for i, p in enumerate(prompts[:DRAIN_STREAMS])]
        recs, threads = _fleet_start(gw.port, drain_bodies, cv)
        _fleet_wait('(b)', cv, lambda: all(
            len(r['tokens']) >= DRAIN_AFTER or r['finished'] for r in recs))
        b128.restart(serving)
        if gw.probe_once() != 2:
            raise AssertionError('phase 3g (b): b128 did not come back')
        t_drain = time.perf_counter()
        first.srv.begin_drain(reason='phase 3g')
        _fleet_join('(b)', threads)
        for i, rec in enumerate(recs):
            _fleet_ok('(b)', i, rec, DRAIN_TOKENS)
            if rec['done'].get('migrated') != 1 or rec['done'].get('resumed') \
                    or rec['tokens'][:new_tokens] != want_3p[i]:
                raise AssertionError('phase 3g (b): stream %d: done %s, the '
                                     'first %d tokens %s, 3p\'s %s' % (
                                         i, {k: v for k, v in
                                             rec['done'].items()
                                             if k != 'tokens'}, new_tokens,
                                         rec['tokens'][:new_tokens],
                                         want_3p[i]))
        st = gw.stats()
        db = _count_delta(b128.counts(), pre)
        if not first.srv.wait_drained(FLEET_BUDGET_S):
            raise AssertionError('phase 3g (b): the drain did not complete')
        drained = first.srv.drain_result
        if st['migrations']['spliced'] != len(recs) \
                or st['migrations']['failures'] or db['prefills'] \
                or db['migrated_in'] != len(recs) \
                or drained['handed_off'] != len(recs):
            raise AssertionError('phase 3g (b): gateway %s, b128 %s, drain %s'
                                 % (st['migrations'], db, drained))
        at = {imp['rid']: imp['emitted'] for imp in b128.imports[n_imp:]}
        first_token = {}
        for i, rec in enumerate(recs):
            k = at['drain-%d' % i]
            first_token[i] = (rec['times'][k] - t_drain) * 1e3
        for imp in b128.imports[n_imp:]:
            imp.pop('payload')
        res['b'] = dict(first_token_ms=first_token, drain=drained,
                        emitted=[at['drain-%d' % i] for i in range(len(recs))],
                        b128=db, migrations=st['migrations'],
                        spliced=[r['tokens'] for r in recs])
        gw.stop()
        res['traffic_s'] = time.perf_counter() - t_traffic

        # the launches of the in-process replicas against their engines'
        # counts; no request built a program
        launches = kernels.launch_counts()
        after = {r.name: r.counts() for r in reps}
        eng = {n: _count_delta(after[n], before[n]) for n in after}
        prefills = sum(e['prefills'] for e in eng.values())
        steps = sum(e['steps'] for e in eng.values())
        want = dict.fromkeys(launches, 0)
        want['flash_attention_fwd'] = layers * prefills
        want['flash_paged_decode_fwd'] = layers * steps
        want['threefry_gumbel'] = prefills + steps
        if device.type == 'cuda' and launches != want:
            raise AssertionError('phase 3g: kernel launches %r, expected %r'
                                 % (launches, want))
        built = {r.name: r.prog.compile_count for r in reps}
        if built != programs:
            raise AssertionError('phase 3g: a request built a program: %s, '
                                 'after warmup %s' % (built, programs))
        for r in reps:
            if r is not first:
                assert_healthy('phase 3g %s' % r.name, r.sess)
        res.update(launches=launches, engines=eng, child_url=child_url)
        # the moved streams of (a) and the sampled ones of (c): 3p's and
        # 3a's but at near ties; every token of (b) teacher-forced
        res['a']['ties'] = near_ties(
            torch, model, first.prog.params,
            [{'prompt': prompts[i], 'temperature': 0.0} for i in moved],
            res['a']['moved_tokens'], [want_3p[i] for i in moved], device,
            '(a)', phase='phase 3g')
        res['c']['ties'] = near_ties(
            torch, model, first.prog.params, [r for r, _o in sampled],
            res['c']['sampled_tokens'], [o for _r, o in sampled], device,
            '(c)', phase='phase 3g')
        res['b']['recheck'] = teacher_forced(
            torch, model, b128.prog.params, prompts[:DRAIN_STREAMS],
            res['b']['spliced'], device)
    finally:
        observability.set_enabled(None)
        for gw in gws:
            gw.stop()
        child.close()
        for r in reps:
            r.close()
    return res


def log_fleet(fl, card):
    """Phase 3g's lines, each number with the card's name and power
    limit."""
    rel = fl['relay']
    log('phase 3g relay [%s]: 3p\'s 16 greedy requests 8 at a time to one '
        'replica: straight to it, its trie cold: TTFT p50 %.2f ms p99 %.2f '
        'ms, %.2f tokens/s; over its warm trie through the gateway: TTFT '
        'p50 %.2f ms p99 %.2f ms, %.2f tokens/s; straight to it again: TTFT '
        'p50 %.2f ms p99 %.2f ms, %.2f tokens/s; build of six replicas '
        '%.1f s, the child captured %.1f s after its spawn'
        % (card, rel['cold']['ttft_p50_ms'], rel['cold']['ttft_p99_ms'],
           rel['cold']['tokens_per_s'], rel['gateway']['ttft_p50_ms'],
           rel['gateway']['ttft_p99_ms'], rel['gateway']['tokens_per_s'],
           rel['direct']['ttft_p50_ms'], rel['direct']['ttft_p99_ms'],
           rel['direct']['tokens_per_s'], fl['build_s'],
           fl['child_ready_s']))
    a = fl['a']
    log('phase 3g (a) [%s]: %d of 16 streams on the child, SIGKILL once each '
        'had %d tokens; %d moved %s (%s tokens relayed at the kill), '
        'resumed 1 each, no error line, indices unbroken; the rest 3p\'s '
        'exactly; the moved ones 3p\'s but at %d near ties %s; SIGKILL to '
        'the child\'s exit %.3f ms; longest '
        'inter-token gap of a moved stream %s ms; re-admission prefills on '
        'the survivor (ms, tokens) %s; /healthz %s; gateway %s; the child\'s '
        'counts at the kill %s'
        % (card, a['on_child'], FLEET_KILL_AFTER, len(a['moved']), a['moved'],
           a['emitted_at_kill'], len(a['ties']), a['ties'], a['exit_ms'],
           {i: round(v, 3) for i, v in a['gap_ms'].items()}, a['readmit_ms'],
           a['health'], a['stats'],
           {k: a['child_counts'][k] for k in ('prefills', 'steps',
                                              'spec_rounds', 'requests')}))
    d = fl['d']
    log('phase 3g (d) [%s]: tenant_rps %g, burst %g, max_inflight %d: the '
        'bursting tenant sent %d at once: %d admitted, %d typed 429s naming '
        'it (Retry-After 1, retry_after_s %s), %s on /metrics; the steady '
        'tenant %d of %d 200s; tenants %s'
        % (card, FLEET_TENANT['tenant_rps'], FLEET_TENANT['tenant_burst'],
           FLEET_TENANT['tenant_max_inflight'], TENANT_BURST, d['admitted'],
           d['shed'], d['retry_after_s'], d['metrics'], d['steady'],
           TENANT_STEADY, json.dumps(d['tenants'])))
    c = fl['c']
    rows = c['rows']
    n = len(rows) - len(c['solo'])
    log('phase 3g (c) [%s]: 16 greedy (3p\'s exactly) and %d sampled (3a\'s '
        'but at %d near ties %s) requests, 8 at a time, prefill_only on the '
        'prefill replica, each payload on a decode replica: handoff %s, '
        'landed %s, no prefill on the decode side; prefill %s; pool loads '
        '%s; (request, tokens in the payload, TTFT ms, the prefill\'s token '
        'to the first decode token ms, payload JSON B through the gateway) '
        '%s; GET /status of a decode replica %s ms'
        % (card, len(c['sampled_tokens']), len(c['ties']), c['ties'],
           c['handoff'], c['landed'],
           {k: c['prefill'][k] for k in ('prefill_exports', 'migrated_out',
                                         'prefills', 'prefix_hits')},
           c['pool'], [(r['rid'], r['emitted'], round(r['ttft_ms'], 3),
                        None if r['handoff_ms'] is None
                        else round(r['handoff_ms'], 3), r['json_bytes'])
                       for r in rows[:n]],
           [round(x, 3) for x in c['status_ms']]))
    log('phase 3g (c) solo [%s]: fresh prompts of %s tokens one at a time: '
        'disaggregated TTFT %s ms, the prefill\'s token to the first decode '
        'token %s ms, payload JSON %s B; the same prompts monolithic on one '
        'replica: TTFT %s ms, the same tokens'
        % (card, [len(p) for p in c['solo']],
           [round(r['ttft_ms'], 3) for r in rows[n:]],
           [round(r['handoff_ms'], 3) for r in rows[n:]],
           [r['json_bytes'] for r in rows[n:]],
           [round(x, 3) for x in c['mono_ttft_ms']]))
    log('phase 3g (c) refusal [%s]: a %d-token prompt, the decode replica of '
        '%d pages refused its payload (429, pool exhausted), the next took '
        'it: handoff %s; pool loads %s'
        % (card, c['refusal']['prompt'], SMALL_POOL, c['refusal']['handoff'],
           c['refusal']['pool']))
    e = fl['e']
    log('phase 3g (e) [%s]: one traced request through (c)\'s path: the '
        'gateway\'s spans %s under the client\'s trace id, one tree '
        '(tree_verdict True); replica hops (replica, path, trace id) %s; '
        'waterfall %s' % (card, e['spans'], e['hops'],
                          json.dumps(e['waterfall'])))
    b = fl['b']
    log('phase 3g (b) [%s]: 8 of 3p\'s requests (%d tokens) through the '
        'gateway, begin_drain on the serving replica after %d tokens each '
        '(%s at the export): every stream spliced into the page-%d replica '
        'with no prefill (%s), migrations %s, the first %d tokens 3p\'s, %d '
        'tokens teacher-forced equal, %d ties %s; begin_drain to each first '
        'imported token %s ms; drain %s'
        % (card, DRAIN_TOKENS, DRAIN_AFTER, b['emitted'], MIGRATE_PAGE,
           {k: b['b128'][k] for k in ('prefills', 'migrated_in', 'steps')},
           b['migrations'], NEW_TOKENS, b['recheck'][0], len(b['recheck'][1]),
           b['recheck'][1], {i: round(v, 3)
                             for i, v in b['first_token_ms'].items()},
           b['drain']))
    log('phase 3g [%s]: in-process launches %s (the engines\' arithmetic: '
        '%s); the child\'s before the kill %s; traffic %.1f s, 3g %.1f s in '
        'all' % (card, {k: v for k, v in fl['launches'].items() if v},
                 {n: {k: e[k] for k in ('prefills', 'steps')}
                  for n, e in fl['engines'].items()},
                 {k: v for k, v in fl['a']['child_launches'].items() if v},
                 fl['traffic_s'], fl['seconds']))


# -- phase 3l: the load and chaos harness over the port's replicas -----------

# 3p's program behind every rig of 3l: BERT-base widths, page size 16, 257
# pages, 8 slots, 3's prefill ladder (the programs sample by default)
LOADGEN_RIG = dict(lm={k: SLICE[k] for k in ('vocab', 'units', 'hidden',
                                            'layers', 'heads')},
                   decode_max_len=SLICE['max_len'], decode_page_size=PAGE_SIZE,
                   decode_pages=SLOTS * SLICE['max_len'] // PAGE_SIZE + 1,
                   slots=SLOTS, decode_prefill_buckets=BUCKETS)
LOADGEN_WINDOW_S = 1.0     # a capacity probe's window
LOADGEN_BISECT = 2
LOADGEN_FACTOR = 2.5       # overload: offered rate / measured capacity
LOADGEN_ADAPTERS = dict(adapter_fleet=ADAPTERS, adapter_rank=ADAPTER_RANK,
                        adapter_slots=ADAPTER_SLOTS)
# per mode, the verdicts printed and not enforced: latency budgets, and
# what this configuration cannot reach (a 257-page pool holds 8 sequences
# of 512 tokens, so the squeeze cannot exhaust it; 7 adapter rows hold 7
# of the 8 adapters at once); every other verdict fails the phase
LOADGEN_PRINTED = {
    'capacity': ('capacity_found',),
    'overload': ('admitted_p99_within_slo', 'sheds_are_fast_429s'),
    'chaos': ('availability_above_floor', 'all_faults_recovered',
              'pool_exhaustion_typed'),
    'prefix': ('prefix_ttft_within_budget',),
    'adapters': ('adapter_ttft_within_budget', 'fleet_resident'),
    'gateway-failover': (),
    'drain': (),
    'disagg': ('mixed_ttft_within_budget',),
    'tenants': ('steady_ttft_within_budget', 'steady_tpot_within_budget'),
}


def _rig_counts(rig):
    """(prefills, steps, one-shot batches on the card) of a rig so far,
    over every replica of a gateway rig, a killed one among them: the
    engines' and sessions' own counters."""
    prefills = steps = batches = 0
    for rep in getattr(rig, 'replicas', None) or [rig]:
        if rep.decode_session is not None:
            eng = rep.decode_session._engine
            with eng._lock:
                prefills += eng._counts['prefills']
                steps += eng._counts['steps']
        if rep.predict_session is not None:
            batches += rep.predict_session._accel_batches
    return prefills, steps, batches


def _trace_trees(rig, trace):
    """Every stitched tree of the rig's span buffers (the gateway's and
    each replica's), by trace id."""
    recs = list(rig.gateway._trace_buf.read())
    for rep in rig.replicas:
        recs.extend(rep.server._trace_buf.read())
    return trace.stitch(recs)


def _eng_in_every_tree(mode, rig, trace):
    """Each drill tree holds the replicas' ``eng.*`` spans; returns the
    number of trees."""
    trees = [t for t in _trace_trees(rig, trace).values()
             if any(s['name'] == 'gw.request' for s in t['spans'].values())]
    bad = [tid for t in trees for tid in [next(iter(t['spans'].values()))
                                           ['trace']]
           if not {'srv.generate', 'eng.first_token'} <= {
               s['name'] for s in t['spans'].values()}]
    if not trees or bad:
        raise AssertionError('phase 3l %s: %d traced trees, %d without the '
                             'replicas\' srv.* / eng.* spans'
                             % (mode, len(trees), len(bad)))
    return len(trees)


def traced_request(rig, trace, tokens, new_tokens):
    """One request through the gateway of ``rig`` under a client-minted
    root: its stitched tree (the gateway's and the replica's spans),
    checked whole, and ``decompose_ttft`` of it."""
    import urllib.request
    trace.set_enabled(True)
    try:
        ctx = trace.TraceContext.new()
        req = urllib.request.Request(
            'http://127.0.0.1:%d/generate' % rig.port,
            data=json.dumps({'tokens': tokens,
                             'max_new_tokens': new_tokens}).encode(),
            headers={'Content-Type': 'application/json',
                     trace.TRACE_HEADER: ctx.to_header()})
        with urllib.request.urlopen(req, timeout=HTTP_BUDGET_S) as resp:
            lines = [json.loads(x) for x in resp.read().splitlines() if x]
        want = {'gw.request', 'gw.route', 'gw.relay', 'srv.generate',
                'eng.queue_wait', 'eng.prefill', 'eng.first_token',
                'eng.steps'}
        deadline = time.monotonic() + FLEET_BUDGET_S
        while True:
            tree = _trace_trees(rig, trace).get(ctx.trace_id)
            names = set() if tree is None else {
                s['name'] for s in tree['spans'].values()}
            if (want <= names and trace.tree_verdict(tree)) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.02)
    finally:
        trace.set_enabled(None)
    if not lines or not lines[-1].get('done') or 'error' in lines[-1] \
            or len(lines) != new_tokens + 1 or not want <= names \
            or trace.tree_verdict(tree) is not True or tree['orphans']:
        raise AssertionError('phase 3l traced request: %d lines, last %s; '
                             'spans %s' % (len(lines), lines[-1:],
                                           sorted(names)))
    trace.normalize_skew(tree)
    ttft, parts = trace.decompose_ttft(tree)
    return dict(spans=sorted(names), sites=sorted(
        {s['site'] for s in tree['spans'].values()}),
        ttft_ms=round(ttft * 1e3, 3),
        parts_ms={k: round(v * 1e3, 3) for k, v in parts.items()},
        waterfall=trace.waterfall(tree))


def serve_loadgen(torch, kernels, loadgen, device, rig_kw=None,
                  capacity_kw=None, durations=None):
    """Phase 3l: the port's ``loadgen`` modes over its replicas on the
    card, every rig 3p's program (``LOADGEN_RIG``; ``rig_kw`` replaces
    it for a rehearsal). One replica (``ServingRig``: the loadgen MLP
    behind ``/predict``, the LM behind ``/generate``; its relu, row 7,
    first held bitwise to its plain version at every bucket): capacity,
    overload at ``LOADGEN_FACTOR`` x the measured capacity (the overload
    ceiling knob raised to it), the full chaos script, the shared-prefix
    workload; then a replica of 3a's geometry (8 rank-8 adapters, 7 pool
    rows) for the adapter workload. Then gateway rigs: two replicas for
    the failover (traced), the drain and the tenants (a traced request
    first: its tree and ``decompose_ttft``), four (two of each class) for
    the disaggregated drill (traced). Each rig's launches are read with
    the counts zeroed after it is built; they must be its engines' and
    sessions' arithmetic exactly. Every verdict but ``LOADGEN_PRINTED``'s
    must hold. Returns the artifacts, counts and seconds."""
    import gc
    from mxnet_tpu_torch.gluon.nn import Dense
    harness = loadgen.harness
    from mxnet_tpu_torch.observability import trace
    rig_kw = dict(LOADGEN_RIG if rig_kw is None else rig_kw, device=device)
    dur = dict(dict(overload=3.0, chaos=12.0, prefix=4.0, adapters=4.0,
                    tenants=4.0), **(durations or {}))
    layers = rig_kw['lm']['layers']
    res = {'modes': {}, 'seconds': {}, 'counts': {}, 'launches': None}

    def timed(mode, fn):
        t0 = time.perf_counter()
        doc = fn()
        res['seconds'][mode] = time.perf_counter() - t0
        res['modes'][mode] = doc
        failed = sorted(k for k, ok in doc.get('verdicts', {}).items()
                        if not ok and k not in LOADGEN_PRINTED[mode])
        if failed:
            raise AssertionError('phase 3l %s: verdicts %s failed: %s'
                                 % (mode, failed, json.dumps(
                                     doc.get('metrics'), default=str)[:4000]))
        return doc

    def run(label, build, drive):
        t0 = time.perf_counter()
        rig = build()
        try:
            res['seconds'][label + ' build'] = time.perf_counter() - t0
            before = _rig_counts(rig)
            kernels.reset_launch_counts()
            drive(rig)
            launches = kernels.launch_counts()
            prefills, steps, batches = (
                a - b for a, b in zip(_rig_counts(rig), before))
        finally:
            rig.close()
            del rig
            gc.collect()
            torch.cuda.empty_cache()
        want = dict.fromkeys(launches, 0)
        want['flash_attention_fwd'] = layers * prefills
        want['flash_paged_decode_fwd'] = layers * steps
        want['threefry_gumbel'] = prefills + steps
        want['act_fwd'] = batches
        if device.type == 'cuda' and launches != want:
            raise AssertionError('phase 3l %s: kernel launches %r, the '
                                 'arithmetic %r' % (label, launches, want))
        res['launches'] = launches if res['launches'] is None else {
            k: v + launches[k] for k, v in res['launches'].items()}
        res['counts'][label] = dict(prefills=prefills, steps=steps,
                                    batches=batches)

    def one_replica():
        rig = harness.ServingRig(**rig_kw)
        # the relu of the /predict MLP (row 7) on the card at every
        # bucket, on the first Dense's outputs of the harness's examples
        block = rig.predict_session.frozen.block
        first = next(m for m in block.modules() if isinstance(m, Dense))
        worst = 0.0
        with torch.inference_mode():
            for b in rig.predict_session.frozen.policy.buckets:
                h = first(torch.tensor(
                    [harness.Dispatcher._predict_payload(r)
                     for r in range(b)], device=device))
                got = kernels.act_forward(h, 'relu')
                ref = kernels.act_forward_reference(h, 'relu')
                if not torch.equal(got, ref):
                    raise AssertionError('phase 3l: act_fwd at %s is not '
                                         'its plain version'
                                         % (tuple(h.shape),))
                worst = max(worst, float((got - ref).abs().max()))
        res['act_fwd_err'] = worst
        return rig

    def overload(rig):
        qps = res['modes']['capacity']['metrics']['max_qps'] or 16.0
        # the overload ceiling knob up to 2.5 x capacity, the mode's
        # point: the endpoint here fronts a fast card
        knob = os.environ.get('MXNET_TPU_LOADGEN_MAX_QPS')
        os.environ['MXNET_TPU_LOADGEN_MAX_QPS'] = repr(
            max(100.0, qps * LOADGEN_FACTOR))
        try:
            return harness.run_overload(rig, factor=LOADGEN_FACTOR,
                                        duration_s=dur['overload'], seed=0,
                                        capacity_qps=qps)
        finally:
            if knob is None:
                os.environ.pop('MXNET_TPU_LOADGEN_MAX_QPS', None)
            else:
                os.environ['MXNET_TPU_LOADGEN_MAX_QPS'] = knob

    def one_replica_modes(rig):
        timed('capacity', lambda: harness.run_capacity(rig, seed=0, **dict(
            dict(start_qps=16.0, window_s=LOADGEN_WINDOW_S,
                 bisect_iters=LOADGEN_BISECT), **(capacity_kw or {}))))
        over = timed('overload', lambda: overload(rig))
        if over['server']['generate']['leaked_slots']:
            raise AssertionError('phase 3l overload: %s' % over['server'])
        chaos = timed('chaos', lambda: harness.run_chaos(
            rig, duration_s=dur['chaos'], seed=0))
        sq = chaos['metrics'].get('pool_squeeze')
        if sq is None or sq['unresolved'] or sq['untyped_failures'] \
                or not all(f['consumed'] for f in chaos['faults']):
            raise AssertionError('phase 3l chaos: faults %s, squeeze %s'
                                 % (chaos['faults'], sq))
        timed('prefix', lambda: harness.run_prefix(
            rig, duration_s=dur['prefix'], seed=0))

    run('one replica', one_replica, one_replica_modes)
    run('adapters', lambda: harness.ServingRig(
        predict=False, decode_max_queue=16,
        **dict(rig_kw, **LOADGEN_ADAPTERS)),
        lambda rig: timed('adapters', lambda: harness.run_adapters(
            rig, duration_s=dur['adapters'], seed=0)))
    gw_kw = dict(rig_kw, replicas=2, health_period_s=0.25, predict=False,
                 decode_max_queue=16)

    def failover(rig):
        timed('gateway-failover', lambda: harness.run_gateway_failover(
            rig, streams=8, seed=0))
        res['failover_trees'] = _eng_in_every_tree('gateway-failover', rig,
                                                   trace)

    run('gateway-failover', lambda: harness.GatewayRig(
        **dict(gw_kw, max_new_tokens=48)), failover)
    run('drain', lambda: harness.GatewayRig(**dict(gw_kw, max_new_tokens=48)),
        lambda rig: timed('drain', lambda: harness.run_drain(
            rig, streams=8, seed=0)))

    def disagg(rig):
        timed('disagg', lambda: harness.run_disagg(rig, streams=8, seed=0))
        res['disagg_trees'] = _eng_in_every_tree('disagg', rig, trace)

    run('disagg', lambda: harness.GatewayRig(**dict(
        gw_kw, replicas=4, classes=('prefill', 'prefill', 'decode',
                                    'decode'), max_new_tokens=24,
        gateway_kwargs=dict(handoff_timeout_s=10.0, handoff_retries=2))),
        disagg)

    def tenants(rig):
        res['traced'] = traced_request(rig, trace, [2, 7, 1, 8, 2, 8], 8)
        timed('tenants', lambda: harness.run_tenants(
            rig, duration_s=dur['tenants'], seed=0))

    run('tenants', lambda: harness.GatewayRig(**dict(
        gw_kw, gateway_kwargs=dict(tenant_rps=8.0, tenant_burst=8.0,
                                   tenant_max_inflight=32))), tenants)
    return res


def log_loadgen(lg, card):
    """Phase 3l's lines: each mode's numbers and verdicts (the printed
    ones marked), the traced request's TTFT split, the launches."""
    m = lg['modes']
    cap = m['capacity']
    log('phase 3l capacity [%s]: max QPS at admitted p99 < %.0f ms and '
        'goodput >= %s: %s; probes (qps, good, p99 ms, goodput) %s'
        % (card, cap['config']['slo_p99_ms'], cap['config']['goodput_floor'],
           cap['metrics']['max_qps'],
           [(round(p['qps'], 2), p['good'], p['p99_ms'],
             None if p['goodput'] is None else round(p['goodput'], 3))
            for p in cap['metrics']['probes']]))
    for mode in ('overload', 'chaos', 'prefix', 'adapters', 'tenants'):
        doc = m[mode]
        mt = doc['metrics']
        if mode == 'tenants':
            parts = {t: mt[t] for t in ('steady', 'burst')}
        else:
            parts = {'': mt}
        for name, x in parts.items():
            lat = x['admitted_latency']
            gen = x.get('generate') or {}
            log('phase 3l %s%s [%s]: offered %d, admitted %d, served ok %d, '
                'shed %d, degraded %d, unresolved %d, goodput %s, '
                'availability %s; admitted p50 %s ms p99 %s ms; TTFT p50 %s '
                'ms p99 %s ms, TPOT p99 %s ms; errors %s'
                % (mode, ' ' + name if name else '', card, x['offered'],
                   x['admitted'], x['served_ok'], x['shed'], x['degraded'],
                   x['unresolved'], x['goodput'], x['availability'],
                   lat['p50_ms'], lat['p99_ms'],
                   (gen.get('ttft') or {}).get('p50_ms'),
                   (gen.get('ttft') or {}).get('p99_ms'),
                   (gen.get('tpot') or {}).get('p99_ms'), x['errors']))
    over = m['overload']
    log('phase 3l overload: offered %.2f QPS (%.1f x capacity %s), shed '
        'p99 %s ms, 429 share of failures %s, Retry-After on %d'
        % (over['config']['offered_qps'], LOADGEN_FACTOR,
           over['config']['capacity_qps'],
           over['metrics']['shed_latency']['p99_ms'],
           over['metrics']['shed_429_frac'],
           over['metrics']['retry_after']['n']))
    chaos = m['chaos']
    for f in chaos['faults']:
        log('phase 3l chaos fault %s [%s]: injected at %.3f s, cleared at '
            '%.3f s, consumed %s, recovery %s s (ceiling %s s)'
            % (f['kind'], card, f['injected_at_s'], f['cleared_at_s'],
               f['consumed'], f['recovery_s'],
               chaos['config']['recovery_ceiling_s']))
    log('phase 3l chaos: aborted typed %d; pool squeeze %s; server %s'
        % (chaos['metrics']['aborted_typed'], chaos['metrics']['pool_squeeze'],
           json.dumps(chaos['server'])))
    ad = m['adapters']
    log('phase 3l adapters: pool %s, sampled tokens %s, programs built '
        'after warm-up %s' % (ad['server']['generate'].get('adapters'),
                              ad['server']['generate'].get('sampled_tokens'),
                              ad['metrics']['retraced_programs'] or 'none'))
    for mode in ('gateway-failover', 'drain', 'disagg'):
        mt = m[mode]['metrics']
        tr = mt.get('trace') or {}
        log('phase 3l %s [%s]: %d streams, served ok %d, error lines %d, '
            'unresolved %d%s%s%s%s'
            % (mode, card, mt['offered'], mt['served_ok'], mt['error_lines'],
               mt['unresolved'],
               ', resumed %d' % mt['resumed_streams']
               if 'resumed_streams' in mt else '',
               ', migrated %d, survivor prefills %d, imports %d, drain %s'
               % (mt['migrated_streams'], mt['dest_prefill_delta'],
                  mt['dest_imports'], mt['drain_result'])
               if mode == 'drain' else '',
               ', handoff %s, decode-side prefills %d, imports %d, TTFT p99 '
               '%s ms' % (mt['handoff'], mt['dest_prefill_delta'],
                          mt['dest_imports'], mt['ttft_p99_ms'])
               if mode == 'disagg' else '',
               '; trace: %d of %d trees complete, %d orphans, %d spans, '
               'classes %s, critical path %s' % (
                   tr['stitched_complete'], tr['requests'], tr['orphan_spans'],
                   tr['spans'], tr['classes_seen'],
                   json.dumps(tr['critical_path'])) if tr else ''))
    t = lg['traced']
    log('phase 3l traced request [%s]: spans %s over sites %s; '
        'decompose_ttft: TTFT %.3f ms = %s ms; waterfall %s'
        % (card, t['spans'], t['sites'], t['ttft_ms'], t['parts_ms'],
           json.dumps(t['waterfall'])))
    for mode, doc in m.items():
        v = doc.get('verdicts', {})
        log('phase 3l %s verdicts: %s' % (mode, ', '.join(
            '%s %s%s' % (k, 'OK' if ok else 'FAIL',
                         ' (printed, not enforced)'
                         if k in LOADGEN_PRINTED[mode] else '')
            for k, ok in sorted(v.items()))))
    log('phase 3l [%s]: seconds %s, %.1f s in all; engine and session '
        'counts by rig %s; launches %s (exact); act_fwd at the MLP\'s '
        'buckets bitwise its plain version'
        % (card, {k: round(v, 3) for k, v in lg['seconds'].items()},
           lg['seconds_all'], lg['counts'],
           {k: v for k, v in lg['launches'].items() if v}))

# -- phase 4: the training slice ---------------------------------------------


def pretrain_batch(torch, device, vocab, batch, seq, preds, lengths=None,
                   seed=0):
    """The bench's synthetic MLM + NSP batch (ids, token types, valid
    lengths, masked positions; MLM and NSP labels), float32 as the bench
    feeds it, on ``device``."""
    import numpy as np
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (batch, seq))
    tt = (rs.rand(batch, seq) > 0.5)
    vl = np.full((batch,), seq) if lengths is None else np.asarray(lengths)
    mp = rs.randint(0, seq, (batch, preds))
    mlm_y = rs.randint(0, vocab, (batch, preds))
    nsp_y = rs.randint(0, 2, (batch,))

    def put(a):
        return torch.tensor(a.astype('float32'), device=device)
    return [put(ids), put(tt), put(vl), put(mp)], [put(mlm_y), put(nsp_y)]


def pretrain_loss_fn(gloss, vocab):
    """MLM + NSP loss over BERTModel's outputs, as the bench composes
    it."""
    L = gloss.SoftmaxCrossEntropyLoss()

    def fn(outs, labels):
        _, _, mlm, nsp = outs
        my, ny = labels
        return L(mlm.reshape(-1, vocab), my.reshape(-1)).mean() \
            + L(nsp, ny).mean()
    return fn


def train_against_cpu(torch, bert, gloss, parallel, device, cfg=SMALL_BERT,
                      shape=SMALL_BATCH, steps=3, seed=0, amp=None,
                      route=None):
    """Phase 4a: one forward + backward, then ``steps`` trainer steps,
    on ``device`` and on the CPU from the same weights; with ``amp``
    ('bf16', phase 4a-amp) the forward runs under the policy's scope and
    the trainer takes ``amp``; with ``route`` 'cast' or 'cast_mp' (phase
    4a-cast) the net is cast to bf16 first and AdamW runs without or with
    ``multi_precision``. Both held to :data:`AMP_LOSS_RTOL` and
    :data:`AMP_GRAD_REL`. Returns (loss relative error, worst gradient
    relative error, step losses relative error)."""
    import warnings
    from mxnet_tpu_torch import amp as amp_mod
    vocab = cfg['vocab_size']
    loss_fn = pretrain_loss_fn(gloss, vocab)
    phase = 'phase 4a' + ('-amp (%s)' % amp if amp else '') \
        + ('-cast (%s)' % route if route else '')
    hyper = dict(TRAIN_HYPER, multi_precision=route == 'cast_mp')
    runs = {}
    for dev in (device, torch.device('cpu')):
        net = bert.init_params(bert.get_bert(device=dev, **cfg), seed)
        if route:
            net.cast('bfloat16')
        xs, ys = pretrain_batch(torch, dev, vocab, shape['batch'],
                                shape['seq'], shape['preds'],
                                shape['lengths'], seed)
        with amp_mod.scope(amp_mod.resolve(amp) if amp else None):
            loss = loss_fn(net(*xs), ys)
        loss.backward()
        grads = {n: None if p.grad is None else p.grad.detach().float().cpu()
                 for n, p in net.collect_params().items()}
        # the graph goes before the trainer's steps: alive, it would hold
        # the parameters' gradient accumulators on the default stream,
        # which a captured step cannot wait on
        loss = loss.float().item()
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')     # bf16 weights, no master
            pt = parallel.ParallelTrainer(net, loss_fn, 'adamw', hyper,
                                          seed=seed,
                                          amp=amp if amp else False)
            losses = [pt.step(xs, ys).float().item() for _ in range(steps)]
        runs[dev.type] = (loss, grads, losses)
    (l_dev, g_dev, s_dev), (l_cpu, g_cpu, s_cpu) = runs[device.type], \
        runs['cpu']
    loss_err = abs(l_dev - l_cpu) / abs(l_cpu)
    grad_err = 0.0
    for name, want in g_cpu.items():
        got = g_dev[name]
        if (got is None) != (want is None):
            raise AssertionError('%s: %s has a gradient on one device '
                                 'only' % (phase, name))
        if want is not None:
            grad_err = max(grad_err, _errs(got, want)[1])
    step_err = max(abs(a - b) / abs(b) for a, b in zip(s_dev, s_cpu))
    log('%s %s vs cpu: loss %.7g vs %.7g, rel_err %.3g; worst '
        'gradient rel_err %.3g over %d parameters; %d steps %s vs %s, '
        'rel_err %.3g' % (phase, device.type, l_dev, l_cpu, loss_err,
                          grad_err, len(g_cpu), steps, s_dev, s_cpu,
                          step_err))
    loss_tol, grad_tol = ((AMP_LOSS_RTOL, AMP_GRAD_REL) if amp or route
                          else (TOL, GRAD_REL))
    if not loss_err <= loss_tol or not grad_err <= grad_tol \
            or not step_err <= loss_tol:
        raise AssertionError('%s: the card disagrees with the CPU' % phase)
    return loss_err, grad_err, step_err


def train_launches(kernels, layers):
    """Kernel launches of one training step: the flash forward, dq and
    dkv once per layer; the xent head once for MLM and once for NSP; the
    act kernels once each for the pooler's tanh; the whole-model AdamW
    update once."""
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update({'flash_attention_fwd': layers, 'flash_attention_dq': layers,
                 'flash_attention_dkv': layers, 'softmax_xent_fwd': 2,
                 'softmax_xent_bwd': 2, 'act_fwd': 1, 'act_bwd': 1,
                 'multi_tensor_update': 1})
    return want


def amp_train_launches(kernels, layers):
    """Kernel launches of one training step under ``amp='bf16'``: the
    bf16 flash forward, dq and dkv once per layer, the bf16 act kernels
    once each for the pooler's tanh, the float32 xent head (its logits
    widened by the keep-fp32 class) once for MLM and once for NSP, the
    float32 whole-model update of the masters once; no float32 attention
    or act launch."""
    bf = kernels.BF16
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update({'flash_attention_fwd' + bf: layers,
                 'flash_attention_dq' + bf: layers,
                 'flash_attention_dkv' + bf: layers, 'softmax_xent_fwd': 2,
                 'softmax_xent_bwd': 2, 'act_fwd' + bf: 1,
                 'act_bwd' + bf: 1, 'multi_tensor_update': 1})
    return want


def cast_train_launches(kernels, layers, mp=False):
    """Kernel launches of one training step after ``cast('bfloat16')``
    (no AMP): the bf16 flash forward, dq and dkv once per layer, the bf16
    act kernels once each for the pooler's tanh, the bf16 xent head once
    for MLM (its cluster instance) and once for NSP (its warp instance),
    each way, and one whole-model update of the bf16 weights (``.bf16``)
    or of their float32 masters (``.mp``); nothing else."""
    bf = kernels.BF16
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update({'flash_attention_fwd' + bf: layers,
                 'flash_attention_dq' + bf: layers,
                 'flash_attention_dkv' + bf: layers,
                 'softmax_xent_fwd' + bf: 2, 'softmax_xent_bwd' + bf: 2,
                 'act_fwd' + bf: 1, 'act_bwd' + bf: 1,
                 'multi_tensor_update' + ('.mp' if mp else bf): 1})
    return want


def train_full(torch, bert, gloss, parallel, kernels, device, cfg=None,
               shape=TRAIN, warmup=TRAIN_WARMUP, iters=TRAIN_ITERS, seed=0,
               amp=None, route=None):
    """Phase 4b (``amp`` None: float32), 4c (``amp='bf16'``) or 4d
    (``route`` 'cast': after ``cast('bfloat16')``, AdamW on bf16 weights
    and state, as ``bench_bert`` trains on the accelerator; 'cast_mp',
    4d-mp: with ``multi_precision``): BERT pretraining steps through
    ``ParallelTrainer.step``, captured from the second step on (one
    program). The launch counts are zeroed after the warm-up and read
    after the timed steps. Returns a dict of results."""
    import warnings
    phase = {None: 'phase 4c' if amp else 'phase 4b', 'cast': 'phase 4d',
             'cast_mp': 'phase 4d-mp'}[route]
    t0 = time.perf_counter()
    if cfg is None:
        net = bert.bert_12_768_12(vocab_size=shape['vocab'], max_length=512,
                                  dropout=0.1, device=device)
    else:
        net = bert.get_bert(device=device, **cfg)
    bert.init_params(net, seed)
    if route:
        net.cast('bfloat16')
    vocab = net.word_embed.weight.shape[0]
    layers = len(net.encoder.cells)
    xs, ys = pretrain_batch(torch, device, vocab, shape['batch'],
                            shape['seq'], shape['preds'], seed=seed)
    pt = parallel.ParallelTrainer(
        net, pretrain_loss_fn(gloss, vocab), 'adamw',
        dict(TRAIN_HYPER, multi_precision=route == 'cast_mp'), seed=seed,
        amp=amp if amp else False)
    setup_s = time.perf_counter() - t0
    cuda = device.type == 'cuda'
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter('always')
        # the first step builds the states: it warns for bf16 weights
        losses = [pt.step(xs, ys) for _ in range(warmup)]
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    events = []
    t1 = time.perf_counter()
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        losses.append(pt.step(xs, ys))
        if cuda:
            end.record()
            events.append((start, end))
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = kernels.launch_counts()
    losses = [float(l) for l in losses]
    if cuda and pt.compile_count != 1:
        raise AssertionError('%s: %d step programs captured, expected 1'
                             % (phase, pt.compile_count))
    if route:
        per_step = cast_train_launches(kernels, layers, route == 'cast_mp')
    else:
        per_step = (amp_train_launches if amp else train_launches)(kernels,
                                                                   layers)
    if cuda and counts != {n: c * iters for n, c in per_step.items()}:
        raise AssertionError('%s: kernel launches %r in %d steps, '
                             'expected %r per step' % (phase, counts, iters,
                                                       per_step))
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError('%s: a loss is not finite: %r' % (phase,
                                                               losses))
    expect = math.log(vocab) + math.log(2)
    if not abs(losses[0] - expect) <= 1.5:
        raise AssertionError('%s: first loss %.4f is not within 1.5 '
                             'of ln(V) + ln(2) = %.4f' % (phase, losses[0],
                                                          expect))
    if not statistics.mean(losses[-3:]) < losses[0]:
        raise AssertionError('%s: the loss did not fall: %r' % (phase,
                                                                losses))
    if route and not max(losses[-3:]) < losses[0]:
        raise AssertionError('%s: one of the last three losses is not below '
                             'the first: %r' % (phase, losses))
    # masters and optimizer state stay float32 under AMP; after the cast
    # the weights are bf16, their AdamW state bf16 without masters
    masters = sorted({str(p.dtype) for p in net.parameters()})
    states = sorted({str(t.dtype) for t in _state_tensors(pt._states)})
    want = {None: (['torch.float32'], ['torch.float32']),
            'cast': (['torch.bfloat16'], ['torch.bfloat16']),
            'cast_mp': (['torch.bfloat16'], ['torch.float32'])}[route]
    if (masters, states) != want:
        raise AssertionError('%s: parameters %s, AdamW state %s; expected '
                             '%s' % (phase, masters, states, want))
    step_ms = [s.elapsed_time(e) for s, e in events]
    return {
        'setup_s': setup_s, 'losses': losses, 'launches': counts,
        'per_step': per_step, 'wall_s': wall, 'amp': pt.amp,
        'master_dtypes': masters, 'state_dtypes': states,
        'warnings': sum('Accumulating with bfloat16' in str(w.message)
                        for w in warned),
        'profile': (profile_step(torch, lambda: pt.step(xs, ys),
                                 AMP_GROUPS if amp else BERT_GROUPS)
                    if cuda else None),
        'compile_seconds': dict(pt.compile_seconds),
        'samples_per_s': shape['batch'] * iters / wall,
        'step_ms': statistics.mean(step_ms) if step_ms else None,
        'step_ms_each': step_ms,
        'peak_mem_bytes': (torch.cuda.max_memory_allocated() if cuda
                           else None),
    }


class deterministic:
    """Deterministic algorithms for a bitwise comparison of two runs:
    ``torch.use_deterministic_algorithms`` (``warn_only``: the cuBLAS
    workspace setting is the process's) and cuDNN's deterministic
    algorithms. By default the gather of BERT's masked positions
    scatter-adds its gradient with atomics, and cuDNN may pick algorithms
    that sum in another order, so two eager runs differ too."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        import warnings
        t = self.torch
        self._prev = (t.are_deterministic_algorithms_enabled(),
                      t.is_deterministic_algorithms_warn_only_enabled(),
                      t.backends.cudnn.deterministic)
        self._warn = warnings.catch_warnings()
        self._warn.__enter__()
        warnings.simplefilter('ignore')
        t.use_deterministic_algorithms(True, warn_only=True)
        t.backends.cudnn.deterministic = True
        return self

    def __exit__(self, *exc):
        t = self.torch
        t.use_deterministic_algorithms(self._prev[0],
                                       warn_only=self._prev[1])
        t.backends.cudnn.deterministic = self._prev[2]
        self._warn.__exit__(*exc)
        return False


def twin_steps(torch, phase, build, steps=TRAIN_WARMUP + TRAIN_ITERS):
    """``build()`` -> (net, trainer, step args): ``steps`` steps of the
    trainer captured (from its second step) and of its eager twin
    (``capture=False``) from the same weights, seed and batch, both under
    :class:`deterministic`; losses and parameters (moving statistics
    among them) must agree bit for bit. Returns (captured, eager) mean
    step ms past the first two (CUDA events)."""
    runs = []
    with deterministic(torch):
        for capture in (True, False):
            net, pt, args = build()
            pt.capture = capture
            losses, ms = [], []
            for _ in range(steps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                losses.append(pt.step(*args))
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
            runs.append((torch.stack(losses),
                         [p.detach().clone() for p in net.parameters()],
                         statistics.mean(ms[2:]), pt.compile_count))
            del net, pt, args
            torch.cuda.empty_cache()
    (lc, pc, mc, nc), (le, pe, me, ne) = runs
    if (nc, ne) != (1, 0) or not torch.equal(lc, le) or not all(
            torch.equal(a, b) for a, b in zip(pc, pe)):
        raise AssertionError('%s: %d captured steps (%d programs) differ '
                             'from the eager body\'s: losses %s vs %s' % (
                                 phase, steps, nc, lc.tolist(), le.tolist()))
    return mc, me


def bert_twins(torch, bert, gloss, parallel, device, route=None,
               shape=TRAIN, seed=0):
    """:func:`twin_steps` at 4b's configuration (``route`` 'cast': 4d's,
    after ``cast('bfloat16')``)."""
    import warnings

    def build():
        net = bert.init_params(bert.bert_12_768_12(
            vocab_size=shape['vocab'], max_length=512, dropout=0.1,
            device=device), seed)
        if route:
            net.cast('bfloat16')
        xs, ys = pretrain_batch(torch, device, shape['vocab'],
                                shape['batch'], shape['seq'],
                                shape['preds'], seed=seed)
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')     # bf16 weights, no master
            pt = parallel.ParallelTrainer(
                net, pretrain_loss_fn(gloss, shape['vocab']), 'adamw',
                dict(TRAIN_HYPER), seed=seed)
        return net, pt, (xs, ys)
    return twin_steps(torch, 'phase 4 twins (%s)' % (route or 'float32'),
                      build)


def resnet_twins(torch, resnet, gloss, parallel, optimizer, device,
                 shape=RESNET, seed=0):
    """:func:`twin_steps` for ResNet-50 v1 at 5b's configuration."""
    def build():
        net = resnet.init_params(resnet.get_resnet(1, shape['depth'],
                                                   device=device), seed)
        x, y = images(torch, device, (shape['batch'], 3, shape['image'],
                                      shape['image']), shape['classes'],
                      seed)
        pt = parallel.ParallelTrainer(net, gloss.SoftmaxCrossEntropyLoss(),
                                      optimizer.create('sgd',
                                                       **RESNET_HYPER))
        return net, pt, (x, y)
    return twin_steps(torch, 'phase 5 twins (resnet%d_v1)' % shape['depth'],
                      build)


def check_train_programs(torch, bert, gloss, parallel, capture, ops, device,
                         cfg=SMALL_BERT, steps=TRAIN_WARMUP + TRAIN_ITERS,
                         seed=0):
    """Phase 4e, the trainer's other entry points on the card at the
    small BERT (batch 8 x 128, 8 predictions, AdamW): ``step_n`` over
    ``steps`` copies of the batch bitwise ``steps`` calls of ``step``
    (dropout 0.1 from the trainer's generator; both under
    :class:`deterministic`); ``build``, ``snapshot``,
    one full-batch step, ``restore``, then ``step_accum(x, y, 2)``
    (dropout 0) within 1e-5 of that step (loss absolute; parameters
    rtol 1e-5, atol 1e-6: ``tests/test_elastic.py:295-305``) with
    ``num_update`` 1, three times from the snapshot (the first eager, then
    its capture, then a replay); and the dropout masks a captured draw
    replays: replay k equal to eager draw k + 1 of a generator seeded
    alike (the first draw is the warm-up step). Returns a dict."""
    vocab = cfg['vocab_size']
    xs, ys = pretrain_batch(torch, device, vocab, 8, 128, 8, None, seed)

    def trainer(dropout):
        net = bert.init_params(bert.get_bert(
            device=device, **dict(cfg, dropout=dropout)), seed)
        return net, parallel.ParallelTrainer(
            net, pretrain_loss_fn(gloss, vocab), 'adamw', dict(TRAIN_HYPER),
            seed=3)
    out = {}
    with deterministic(torch):
        net_a, pt_a = trainer(0.1)
        one = torch.stack([pt_a.step(xs, ys) for _ in range(steps)])
        net_b, pt_b = trainer(0.1)
        window = pt_b.step_n([torch.stack([a] * steps) for a in xs],
                             [torch.stack([a] * steps) for a in ys])
    if not torch.equal(one, window) or not all(
            torch.equal(a, b) for a, b in zip(net_a.parameters(),
                                              net_b.parameters())) \
            or pt_b.num_update != steps:
        raise AssertionError('phase 4e: step_n(%d) differs from %d steps: '
                             '%s vs %s' % (steps, steps, window.tolist(),
                                           one.tolist()))
    out['step_n'] = window.tolist()
    del net_a, pt_a, net_b, pt_b
    net, pt = trainer(0.0)
    pt.build(xs, ys)
    if pt.compile_count != int(device.type == 'cuda') or pt.num_update != 0:
        raise AssertionError('phase 4e: build left %d programs, num_update '
                             '%d' % (pt.compile_count, pt.num_update))
    snap = pt.snapshot()
    full = pt.step(xs, ys).item()
    want = [p.detach().clone() for p in net.parameters()]
    worst = []
    for _ in range(3):
        pt.restore(snap)
        acc = pt.step_accum(xs, ys, 2).item()
        ratio = max(float(((a.detach() - b).abs()
                           / (1e-6 + 1e-5 * b.abs())).max())
                    for a, b in zip(net.parameters(), want))
        if not (abs(acc - full) < 1e-5 and ratio <= 1
                and pt.num_update == 1):
            raise AssertionError('phase 4e: step_accum(2) loss %.9g vs the '
                                 'full batch\'s %.9g, parameters at %.3g '
                                 'of the tolerance, num_update %d' % (
                                     acc, full, ratio, pt.num_update))
        worst.append((abs(acc - full), ratio))
    out.update(accum=worst, compile_seconds=dict(pt.compile_seconds),
               programs=pt.compile_count)
    del net, pt
    g_eager = torch.Generator(device=device).manual_seed(5)
    g_graph = torch.Generator(device=device).manual_seed(5)
    x = torch.ones(1 << 20, device=device)
    eager = [ops.dropout(x, 0.1, g_eager) for _ in range(steps)]
    drawn = torch.zeros_like(x)
    ops.dropout(x, 0.1, g_graph)
    prog = capture.Program('dropout', lambda: drawn.copy_(
        ops.dropout(x, 0.1, g_graph)), device, generators=(g_graph,))
    for k in range(1, steps):
        prog.run()
        if not torch.equal(drawn, eager[k]):
            raise AssertionError('phase 4e: the dropout mask of replay %d '
                                 'differs from eager draw %d' % (k, k + 1))
    out['masks'] = steps - 1
    return out


# profile groups: (group, kernel-name keys, launching-range keys). A
# device kernel joins the first group whose name key is in its name or
# whose range key names a CPU range (an op, an autograd node, an
# annotation) that encloses the CUDA runtime call which launched it
BERT_GROUPS = (('attention kernels', ('flash_attention',), ()),
               ('xent kernels', ('softmax_xent',), ()),
               ('GEMMs', ('gemm', 'xmma', 'cutlass', 'nvjet'), ()),
               ('optimizer update', ('multi_tensor_update',), ()),
               ('copies', ('memcpy', 'memset'), ()))
# 4c: 4b's groups and the AMP casts apart (the copies that make the bf16
# compute copies of the masters and activations, and widen gradients)
AMP_GROUPS = BERT_GROUPS[:4] + (
    ('casts', (), ('aten::_to_copy', 'ToCopyBackward')),) + BERT_GROUPS[4:]
RESNET_GROUPS = (('epilogue kernels', ('epilogue_',), ()),
                 ('xent kernels', ('softmax_xent',), ()),
                 ('SGD (optimizer update)', ('multi_tensor_update',), ()),
                 ('convs', (), ('aten::convolution', 'ConvolutionBackward')),
                 ('BN statistics/backward', (), ('BatchNormTrainFunction',)),
                 ('max pool', (), ('MaxPoolFunction',)),
                 ('copies', ('memcpy', 'memset'), ()))
# 5d / 5e: 5b's groups and the casts apart (the bf16 copies of the
# masters and the activations under AMP, the gradients widened)
RESNET_AMP_GROUPS = RESNET_GROUPS[:5] + (
    ('casts', (), ('aten::_to_copy', 'ToCopyBackward')),) + RESNET_GROUPS[5:]


def _enclosing(ranges, launch):
    """Names of the CPU ranges on the launching thread that contain the
    runtime call ``launch``."""
    t = launch.time_range.start
    return [name for s0, e0, thread, name in ranges
            if thread == launch.thread and s0 <= t <= e0]


def profile_step(torch, step, groups):
    """One more step under ``torch.profiler``: device time by group and
    the device's busy share of the step's span (the union of kernel
    intervals over first start to last end). A kernel is tied to the CUDA
    runtime call that launched it by their shared correlation id, and
    that call to the CPU ranges enclosing it; kernels with no runtime
    call in the trace join a group by name only (``unlinked``). Returns
    None when the trace holds no device event."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = list(prof.events())
    cpu_type = torch.autograd.DeviceType.CPU
    keys = {r for _, _, ranges in groups for r in ranges}
    launches = {e.id: e for e in events
                if e.device_type == cpu_type and e.name.startswith('cu')}
    ranges = [(e.time_range.start, e.time_range.end, e.thread, e.name)
              for e in events if e.device_type == cpu_type
              and any(k in e.name for k in keys)]
    spans, by_name, unlinked = [], {}, 0
    groups_ms = dict.fromkeys([g for g, _, _ in groups] + ['other'], 0.0)
    for e in events:
        # a record_function range also shows on the device timeline (a
        # user annotation spanning the kernels it launched): not a kernel
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(e, 'is_user_annotation', False):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        launch = launches.get(e.id)
        unlinked += launch is None
        around = [] if launch is None or not ranges \
            else _enclosing(ranges, launch)
        low = e.name.lower()
        group = next((g for g, names, rkeys in groups
                      if any(k in low for k in names)
                      or any(r in n for r in rkeys for n in around)),
                     'other')
        groups_ms[group] += ms
    if not spans:
        return None
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s = s0
        cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {'kernels': len(spans), 'unlinked': unlinked,
            'busy_ms': busy / 1e3, 'span_ms': span / 1e3,
            'busy_share': busy / span if span else 0,
            'groups_ms': groups_ms, 'top': [(n[:90], ms) for n, ms in top]}


def log_profile(phase, card, prof):
    if prof is None:
        log('%s profile: the trace holds no device event (not measured)'
            % phase)
        return
    log('%s profile [%s], one more step: %d device events (%d not tied to '
        'a runtime launch), busy %.3f ms of a %.3f ms span (busy share %.3f); '
        'by group (ms) %s; top kernels (ms) %s'
        % (phase, card, prof['kernels'], prof['unlinked'], prof['busy_ms'],
           prof['span_ms'], prof['busy_share'],
           {g: round(ms, 3) for g, ms in prof['groups_ms'].items()},
           [(n, round(ms, 3)) for n, ms in prof['top']]))


# -- phase 5: the ResNet slice -----------------------------------------------


def images(torch, device, shape, classes, seed=0):
    """Images uniform in (-1, 1) and labels, from a numpy seed, float32
    as the bench feeds them, on ``device``."""
    import numpy as np
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, shape).astype('float32')
    y = rs.randint(0, classes, (shape[0],)).astype('float32')
    return (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))


def _narrow_resnet(resnet, device, seed):
    net = resnet.ResNetV1(resnet.BottleneckV1, NARROW['layers'],
                          NARROW['channels'], classes=NARROW['classes'],
                          device=device)
    return resnet.init_params(net, seed)


def resnet_against_cpu(torch, resnet, gloss, gnn, parallel, kernels,
                       device, shape=NARROW_BATCH, steps=3, seed=0):
    """Phase 5a: the narrow ResNet's forward + backward and ``steps`` SGD
    steps on ``device`` and on the CPU from the same weights, then a
    frozen BatchNorm (``use_global_stats``) layer under autograd, which
    must launch the BN apply forward and backward kernels once each."""
    L = gloss.SoftmaxCrossEntropyLoss()
    runs = {}
    for dev in (device, torch.device('cpu')):
        net = _narrow_resnet(resnet, dev, seed)
        x, y = images(torch, dev, shape, NARROW['classes'], seed)
        net.train(True)
        loss = L(net(x), y).mean()
        loss.backward()
        net.train(False)
        params = net.collect_params()
        grads = {n: p.grad.detach().cpu() for n, p in params.items()
                 if p.requires_grad}
        loss = loss.item()      # the graph goes (see train_against_cpu)
        pt = parallel.ParallelTrainer(net, L, 'sgd', dict(NARROW_HYPER))
        losses = [pt.step(x, y).item() for _ in range(steps)]
        after = {n: p.detach().cpu() for n, p in params.items()}
        runs[dev.type] = (loss, grads, losses, after)
    (l_dev, g_dev, s_dev, a_dev), (l_cpu, g_cpu, s_cpu, a_cpu) = \
        runs[device.type], runs['cpu']
    loss_err = abs(l_dev - l_cpu) / abs(l_cpu)
    largest = max(g.abs().max().item() for g in g_cpu.values())
    grad_err, noise = 0.0, 0.0
    for name, want in g_cpu.items():
        got = g_dev[name]
        if 'conv' in name and name.endswith('_bias'):
            noise = max(noise, got.abs().max().item() / largest,
                        want.abs().max().item() / largest)
            continue
        grad_err = max(grad_err, _errs(got, want)[1])
    step_err = max(abs(a - b) / abs(b) for a, b in zip(s_dev, s_cpu))
    param_err = max((a_dev[n] - a_cpu[n]).abs().max().item() for n in a_cpu)
    log('phase 5a %s vs cpu: narrow ResNet %s; loss %.7g vs %.7g, rel_err '
        '%.3g; worst gradient rel_err %.3g over %d parameters (conv biases '
        'feeding a BatchNorm: %.3g of the largest gradient); %d SGD steps %s '
        'vs %s, rel_err %.3g; parameters and running statistics after them '
        'max_abs_err %.3g'
        % (device.type, shape, l_dev, l_cpu, loss_err, grad_err, len(g_cpu),
           noise, steps, s_dev, s_cpu, step_err, param_err))
    if not loss_err <= TOL or not grad_err <= NARROW_GRAD_REL \
            or not noise <= NARROW_NOISE_REL or not step_err <= TOL \
            or not param_err <= NARROW_PARAM_TOL:
        raise AssertionError('phase 5a: the card disagrees with the CPU')

    # frozen-BN fine-tuning: the BN apply forward and backward kernels
    outs = {}
    launches = None
    for dev in (device, torch.device('cpu')):
        gen = torch.Generator(device='cpu').manual_seed(seed + 1)
        bn = gnn.BatchNorm(use_global_stats=True, in_channels=16,
                           device=dev)
        with torch.no_grad():
            for p in (bn.gamma, bn.beta, bn.running_mean):
                p.copy_(torch.randn(16, generator=gen))
            bn.running_var.copy_(torch.rand(16, generator=gen) + 0.5)
        xb = (torch.randn(8, 16, 9, 9, generator=gen) * 2).to(dev)
        gb = torch.randn(8, 16, 9, 9, generator=gen).to(dev)
        xb.requires_grad_(True)
        bn.train(True)
        kernels.reset_launch_counts()
        out = bn(xb)
        out.backward(gb)
        if dev.type == device.type:
            launches = kernels.launch_counts()
        outs[dev.type] = [t.detach().cpu() for t in
                          (out, xb.grad, bn.gamma.grad, bn.beta.grad,
                           bn.running_mean)]
    errs = [_errs(a, b)[1] for a, b in zip(outs[device.type], outs['cpu'])]
    log('phase 5a frozen BatchNorm(use_global_stats=True) %s vs cpu: out / '
        'dx / dgamma / dbeta rel_err %s, running mean unchanged; launches '
        '%s' % (device.type, ['%.3g' % e for e in errs[:4]],
                {k: v for k, v in launches.items() if v}))
    if device.type == 'cuda' and (launches['bn_act_fwd'] != 1
                                  or launches['bn_act_bwd'] != 1):
        raise AssertionError('phase 5a: the frozen BatchNorm did not run the '
                             'BN apply kernels once each: %r' % launches)
    if not max(errs[:2]) <= ULP or not max(errs[2:4]) <= 1e-5 \
            or errs[4] != 0.0:
        raise AssertionError('phase 5a: the frozen BatchNorm disagrees')


def resnet_bf16_against_cpu(torch, resnet, gloss, parallel, device, route,
                            shape=NARROW_BATCH, steps=3, seed=0):
    """Phase 5a-amp: the narrow ResNet under ``route`` ('amp':
    ``amp='bf16'``; 'cast': ``cast('bfloat16')`` on bf16 images) on
    ``device`` and on the CPU from the same weights: one forward and
    backward, then ``steps`` SGD steps. The loss is held to
    :data:`AMP_LOSS_RTOL`, each step-0 gradient to :data:`AMP_GRAD_REL`
    of its max abs (phase 4a-amp's tiers; the conv biases feeding a
    BatchNorm, whose exact gradient is 0, to that of the net's largest
    gradient) and the step losses to :data:`AMP_FIRST_LOSS_RTOL`. Returns
    (loss relative error, worst gradient relative error, step losses
    relative error)."""
    from mxnet_tpu_torch import amp as amp_mod
    L = gloss.SoftmaxCrossEntropyLoss()
    phase = 'phase 5a-amp (%s)' % route
    import warnings
    runs = {}
    for dev in (device, torch.device('cpu')):
        net = _narrow_resnet(resnet, dev, seed)
        x, y = images(torch, dev, shape, NARROW['classes'], seed)
        if route == 'cast':
            net.cast('bfloat16')
            x = x.to(torch.bfloat16)
        net.train(True)
        with amp_mod.scope(amp_mod.bf16() if route == 'amp' else None):
            loss = L(net(x), y)
        loss = loss.float().mean()
        loss.backward()
        net.train(False)
        grads = {n: p.grad.detach().float().cpu()
                 for n, p in net.collect_params().items() if p.requires_grad}
        loss = loss.item()      # the graph goes (see train_against_cpu)
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')     # bf16 weights, no master
            pt = parallel.ParallelTrainer(net, L, 'sgd', dict(NARROW_HYPER),
                                          amp='bf16' if route == 'amp'
                                          else None)
            losses = [pt.step(x, y).float().item() for _ in range(steps)]
        runs[dev.type] = (loss, grads, losses)
    (l_dev, g_dev, s_dev), (l_cpu, g_cpu, s_cpu) = runs[device.type], \
        runs['cpu']
    loss_err = abs(l_dev - l_cpu) / abs(l_cpu)
    largest = max(g.abs().max().item() for g in g_cpu.values())
    grad_err, noise_err = 0.0, 0.0
    for name, want in g_cpu.items():
        got = g_dev[name]
        if 'conv' in name and name.endswith('_bias'):
            noise_err = max(noise_err,
                            (got - want).abs().max().item() / largest)
            continue
        grad_err = max(grad_err, _errs(got, want)[1])
    step_err = max(abs(u - v) / abs(v) for u, v in zip(s_dev, s_cpu))
    log('%s %s vs cpu: narrow ResNet %s; loss %.7g vs %.7g, rel_err %.3g; '
        'worst gradient rel_err %.3g over %d parameters (conv biases '
        'feeding a BatchNorm: %.3g of the largest gradient); %d SGD steps '
        '%s vs %s, rel_err %.3g'
        % (phase, device.type, shape, l_dev, l_cpu, loss_err, grad_err,
           len(g_cpu), noise_err, steps, s_dev, s_cpu, step_err))
    if not loss_err <= AMP_LOSS_RTOL or not grad_err <= AMP_GRAD_REL \
            or not noise_err <= AMP_GRAD_REL \
            or not step_err <= AMP_FIRST_LOSS_RTOL:
        raise AssertionError('%s: the card disagrees with the CPU' % phase)
    return loss_err, grad_err, step_err


def resnet_launches(kernels, net, gnn, resnet, backward=True,
                    frozen=False, route=None):
    """Kernel launches of one ResNet step (``backward``) or inference
    forward: one BN apply per BatchNorm, one act per relu, one add+act
    per cell; backward: one act_bwd per relu and per cell (the add+act's
    backward is the act_bwd kernel), the xent head once each way, and
    with the BatchNorm statistics ``frozen`` one BN apply backward per
    BatchNorm. ``route`` 'amp' (``amp='bf16'``) or 'cast'
    (``cast('bfloat16')``): the act, add+act and BN apply backward
    kernels run their bf16 instances, the BN apply too where it reads
    the moving statistics (inference, frozen); training's BN apply runs
    the float32 instance on the widened data; the xent head is float32
    under 'amp' (the keep-fp32 class widens the logits), bf16 under
    'cast'. A step updates every parameter in one launch a form: float32
    (the masters under 'amp'), and under 'cast' also the bf16 weights
    (``.bf16``; BatchNorm's stay float32)."""
    mods = list(net.modules())
    bns = sum(isinstance(m, gnn.BatchNorm) for m in mods)
    acts = sum(isinstance(m, gnn.Activation) for m in mods)
    cells = sum(isinstance(m, resnet.BottleneckV1) or
                isinstance(m, resnet.BasicBlockV1) for m in mods)
    bf = kernels.BF16 if route else ''
    xent = kernels.BF16 if route == 'cast' else ''
    apply = 'bn_act_fwd' + (bf if frozen or not backward else '')
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update({apply: bns, 'act_fwd' + bf: acts, 'add_act_fwd' + bf: cells})
    if backward:
        want.update({'act_bwd' + bf: acts + cells,
                     'softmax_xent_fwd' + xent: 1,
                     'softmax_xent_bwd' + xent: 1,
                     'bn_act_bwd' + bf: bns if frozen else 0,
                     'multi_tensor_update': 1})
        if route == 'cast':
            want['multi_tensor_update' + kernels.BF16] = 1
    return want


def train_resnet(torch, resnet, gloss, gnn, parallel, optimizer, kernels,
                 device, net=None, shape=RESNET, warmup=RESNET_WARMUP,
                 iters=RESNET_ITERS, seed=0, route=None):
    """Phase 5b (``route`` None: float32), 5d (``route`` 'amp': the
    float32 net under ``amp='bf16'``) or 5e (``route`` 'cast': the net
    after ``cast('bfloat16')`` on bf16 images, SGD without
    ``multi_precision``, as ``bench_resnet`` trains): ResNet v1 training
    steps through ``ParallelTrainer.step`` with SGD; launch counts zeroed
    after the warm-up and read after the timed steps; a profiled step;
    then one inference forward (under the policy's scope for 'amp').
    Returns a dict of results."""
    import warnings
    from mxnet_tpu_torch import amp as amp_mod
    phase = {None: 'phase 5b', 'amp': 'phase 5d', 'cast': 'phase 5e'}[route]
    t0 = time.perf_counter()
    if net is None:
        net = resnet.get_resnet(1, shape['depth'], device=device)
    resnet.init_params(net, seed)
    x, y = images(torch, device, (shape['batch'], 3, shape['image'],
                                  shape['image']), shape['classes'], seed)
    if route == 'cast':
        net.cast('bfloat16')
        x = x.to(torch.bfloat16)
    opt = optimizer.create('sgd', **RESNET_HYPER)
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter('always')
        pt = parallel.ParallelTrainer(net, gloss.SoftmaxCrossEntropyLoss(),
                                      opt, amp='bf16' if route == 'amp'
                                      else None)
        # the first step builds the states: it warns for bf16 weights
        first = pt.step(x, y)
    setup_s = time.perf_counter() - t0
    cuda = device.type == 'cuda'
    losses = [first] + [pt.step(x, y) for _ in range(warmup - 1)]
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    events = []
    t1 = time.perf_counter()
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        losses.append(pt.step(x, y))
        if cuda:
            end.record()
            events.append((start, end))
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() if cuda else None
    losses = [float(l) for l in losses]
    per_step = resnet_launches(kernels, net, gnn, resnet, route=route)
    if cuda and counts != {n: c * iters for n, c in per_step.items()}:
        raise AssertionError('%s: kernel launches %r in %d steps, '
                             'expected %r per step' % (phase, counts, iters,
                                                       per_step))
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError('%s: a loss is not finite: %r' % (phase,
                                                               losses))
    expect = math.log(shape['classes'])
    if not abs(losses[0] - expect) <= 1.5:
        raise AssertionError('%s: first loss %.4f is not within 1.5 '
                             'of ln(classes) = %.4f' % (phase, losses[0],
                                                        expect))
    # at the bench's lr 0.1 and momentum 0.9 on one fixed batch the loss
    # falls for the first steps and then overshoots, in the JAX package
    # too (tests/test_torch_resnet_sgd.py); it must fall for two steps
    # and by 1 in all (5e, bf16 weights without a float32 master, need
    # only stay finite)
    falls = losses[0] > losses[1] > losses[2] \
        and min(losses) < losses[0] - 1.0
    if route != 'cast' and not falls:
        raise AssertionError('%s: the loss did not fall: %r' % (phase,
                                                                losses))
    prof = None
    if cuda:
        prof = profile_step(torch, lambda: pt.step(x, y),
                            RESNET_AMP_GROUPS if route else RESNET_GROUPS)
    # inference: the BN apply with the moving statistics, no backward
    kernels.reset_launch_counts()
    with torch.no_grad(), amp_mod.scope(amp_mod.bf16() if route == 'amp'
                                        else None):
        logits = net(x)
    infer = kernels.launch_counts()
    want = resnet_launches(kernels, net, gnn, resnet, backward=False,
                           route=route)
    if tuple(logits.shape) != (shape['batch'], shape['classes']) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError('%s: inference logits %r are not finite '
                             'or not (batch, classes)' % (phase,
                                                          logits.shape))
    if cuda and infer != want:
        raise AssertionError('%s: inference launches %r, expected %r'
                             % (phase, infer, want))
    step_ms = [s.elapsed_time(e) for s, e in events]
    params = net.collect_params().values()
    states = [t for st in pt._states
              for t in (st if isinstance(st, (tuple, list)) else (st,))
              if t is not None]
    return {
        'setup_s': setup_s, 'losses': losses, 'launches': counts,
        'per_step': per_step, 'wall_s': wall, 'profile': prof,
        'infer_launches': infer, 'falls': falls, 'amp': pt.amp,
        'param_dtypes': sorted({str(p.dtype) for p in params}),
        'state_dtypes': sorted({str(t.dtype) for t in states}),
        'warnings': len(warned),
        'img_per_s': shape['batch'] * iters / wall,
        'step_ms': statistics.mean(step_ms) if step_ms else None,
        'step_ms_each': step_ms, 'peak_mem_bytes': peak,
        'net': net, 'batch': (x, y),
        'compile_seconds': dict(pt.compile_seconds),
    }


def finetune_frozen(torch, resnet, gloss, gnn, parallel, optimizer, kernels,
                    net, x, y, steps=FROZEN_STEPS, route=None):
    """Phase 5c: frozen-BN fine-tuning of the trained net of 5b, the
    path of the BN apply backward kernel: the moving statistics
    recomputed for the trained weights, every BatchNorm set to
    ``use_global_stats``, then ``steps`` SGD steps (``FROZEN_HYPER``) on
    the same batch, launch counts zeroed just before them and read just
    after. The moving statistics must not move and the losses must be
    finite. With ``route`` 'amp' (phase 5d's net) the forwards run under
    ``amp='bf16'``, so the BN apply and its backward take their bf16
    instances. Returns a dict of results."""
    from mxnet_tpu_torch import amp as amp_mod
    policy = amp_mod.bf16() if route == 'amp' else None
    phase = 'phase 5d frozen' if route else 'phase 5c'
    # 5b's moving statistics lag its weights (a quarter of them is still
    # the initial 0 / 1 after 13 steps at keep 0.9), and normalizing with
    # them overflows the logits; fine-tuning starts from converged ones,
    # so recompute them for the trained weights first: training-mode
    # forwards without gradients, which leave 0.9 ** 44 < 1 % of the old
    loss_fn = gloss.SoftmaxCrossEntropyLoss()
    net.train(True)
    with torch.no_grad(), amp_mod.scope(policy):
        for _ in range(FROZEN_CALIBRATE):
            batch_loss = float(loss_fn(net(x), y).float().mean())
    net.train(False)
    bns = [m for m in net.modules() if isinstance(m, gnn.BatchNorm)]
    for m in bns:
        m.use_global_stats = True
    stats = [(m.running_mean.detach().clone(), m.running_var.detach().clone())
             for m in bns]
    opt = optimizer.create('sgd', **FROZEN_HYPER)
    pt = parallel.ParallelTrainer(net, loss_fn, opt, amp=policy)
    cuda = x.device.type == 'cuda'
    if cuda:
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [float(pt.step(x, y)) for _ in range(steps)]
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    per_step = resnet_launches(kernels, net, gnn, resnet, frozen=True,
                               route=route)
    if cuda and counts != {n: c * steps for n, c in per_step.items()}:
        raise AssertionError('%s: kernel launches %r in %d steps, '
                             'expected %r per step' % (phase, counts, steps,
                                                       per_step))
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError('%s: a loss is not finite: %r' % (phase,
                                                               losses))
    if not all(torch.equal(m.running_mean, a) and torch.equal(m.running_var, b)
               for m, (a, b) in zip(bns, stats)):
        raise AssertionError('%s: a frozen moving statistic moved' % phase)
    return {'losses': losses, 'launches': counts, 'per_step': per_step,
            'wall_s': wall, 'batch_norms': len(bns),
            'batch_stat_loss': batch_loss}


# -- phase 6: the SSD detection serving slice --------------------------------

SSD_CLASSES = 20
SSD_IMAGE = 300
SSD_ANCHORS = 7378
SSD_BATCH_NORMS = 14
SSD_BUCKETS = (1, 2, 4, 8, 16)
SSD_CLIENTS, SSD_PER_CLIENT, SSD_SEQUENTIAL = 8, 8, 8
SSD_TINY = dict(num_classes=3, sizes=[(0.2, 0.3), (0.5, 0.6)],
                ratios=[(1.0, 2.0, 0.5)] * 2, base_channels=(8, 16),
                scale_channels=(16,))
SSD_TINY_BATCH = (4, 3, 32, 32)
SSD_HEAD_REL = 1e-5        # 6a: heads, relative to each head's max abs
DET_TOL = 1e-5             # 6a: matched detections' scores and coordinates
IOU_MARGIN = 1e-5          # 6a: a deciding IoU's distance from 0.45
NMS_THRESH = 0.45
NMS_TOPK = 400
# flops of one IoU and its test: 4 max / min, 3 subtractions, 2 clamps,
# 2 multiplications, 2 additions, a division and 2 compares
NMS_IOU_FLOPS = 16


def nms_cases(n=SSD_ANCHORS, seed=6):
    """(label, boxes (B, N, 4), valid (B, N), class ids or None, topk)
    numpy cases of the nms kernel check: the served shape class-aware at
    topk 400 and 16 images, every box suppressing (topk -1, 7378 steps),
    N of 1, 100 and 129, all invalid, duplicates and zero areas, NaN
    coordinates; N of 300, 1500 and 3000 with and without class ids; at
    the 64-box word and row-block edges N of 63, 64 and 65 and topk of
    63, 64 and 65 at N 129; and N of 8192 (``MAX_BOXES``, 128 words: the
    scan's every thread), class-aware at topk 400 and class-agnostic at
    topk -1."""
    import numpy as np
    rs = np.random.RandomState(seed)

    def boxes(b, m):
        xy = rs.rand(b, m, 2)
        wh = rs.rand(b, m, 2) * 0.3
        return np.concatenate([xy, xy + wh], -1).astype('float32')

    def valid(b, m):
        return rs.rand(b, m) < 0.9

    def ids(b, m, k=SSD_CLASSES):
        return rs.randint(0, k, (b, m)).astype('float32')

    cases = [('class-aware B16 N%d topk %d' % (n, NMS_TOPK), boxes(16, n),
              valid(16, n), ids(16, n), NMS_TOPK),
             ('class-agnostic B2 N%d topk -1' % n, boxes(2, n), valid(2, n),
              None, -1)]
    for m in (1, 100, 129):
        cases.append(('B3 N%d' % m, boxes(3, m), valid(3, m), ids(3, m, 3),
                      -1))
    cases.append(('all invalid', boxes(2, 600), np.zeros((2, 600), bool),
                  ids(2, 600), NMS_TOPK))
    dup = boxes(2, 1000)
    dup[:, 1::3] = dup[:, 0:999:3]
    dup[:, 2::5, 2] = dup[:, 2::5, 0]
    cases.append(('duplicates and zero areas', dup, valid(2, 1000), None,
                  300))
    nan = boxes(2, 700)
    nan[0, 5, 1] = np.nan
    nan[1, 0, 2] = np.nan
    cases.append(('NaN coordinates', nan, valid(2, 700), ids(2, 700, 3), -1))
    for m in (300, 1500, 3000, 63, 64, 65, 8192):
        cases.append(('class-agnostic B2 N%d topk -1' % m, boxes(2, m),
                      valid(2, m), None, -1))
        cases.append(('class-aware B2 N%d topk %d' % (m, NMS_TOPK),
                      boxes(2, m), valid(2, m), ids(2, m), NMS_TOPK))
    for m in (63, 64, 65):
        cases.append(('class-aware B2 N%d topk -1' % m, boxes(2, m),
                      valid(2, m), ids(2, m, 3), -1))
        cases.append(('class-agnostic B2 N%d topk %d' % (m, NMS_TOPK),
                      boxes(2, m), valid(2, m), None, NMS_TOPK))
    for k in (63, 64, 65):
        cases.append(('class-agnostic B2 N129 topk %d' % k, boxes(2, 129),
                      valid(2, 129), None, k))
    return cases


def check_nms_kernel(torch, kernels, device, cases=None):
    """Phase 6: the nms kernel against its plain version on ``device``,
    keep masks bitwise equal in every case. Returns {'nms': 0.0}, the max
    abs error of equal masks."""
    for label, b, v, c, topk in cases or nms_cases():
        boxes, valid = (torch.from_numpy(a).to(device) for a in (b, v))
        cls = None if c is None else torch.from_numpy(c).to(device)
        got = kernels.greedy_nms_keep(boxes, valid, NMS_THRESH, topk,
                                      cls_id=cls)
        want = kernels.greedy_nms_keep_reference(boxes, valid, NMS_THRESH,
                                                 topk, cls_id=cls)
        if not torch.equal(got, want):
            raise AssertionError('nms [%s]: the kernel keeps %d boxes, its '
                                 'plain version %d' % (label, int(got.sum()),
                                                       int(want.sum())))
        log('check nms [%s]: %d of %d valid boxes kept, bitwise equal'
            % (label, int(got.sum()), int(v.sum())))
    return {'nms': 0.0}


def nms_work(torch, kernels, boxes, valid, keep, topk, cls_id):
    """(bytes, flops) the kernel's call needs on these inputs: each input
    read once and the mask written once; an IoU for every step the kernel
    does not skip (i < n_iter still kept) against every later valid box of
    its class."""
    b, n = valid.shape
    n_iter = kernels.nms_iterations(n, topk)
    nbytes = boxes.numel() * 4 + valid.numel() + keep.numel() + (
        0 if cls_id is None else cls_id.numel() * 4)
    idx = torch.arange(n, device=boxes.device)
    pairs = 0
    for img in range(b):
        steps = torch.nonzero(keep[img, :n_iter]).flatten()
        later = (idx[None, :] > steps[:, None]) & valid[img][None, :]
        if cls_id is not None:
            later &= cls_id[img][None, :] == cls_id[img][steps][:, None]
        pairs += int(later.sum())
    return nbytes, pairs * NMS_IOU_FLOPS


NMS_STAGES = ('mask', 'scan', 'finish')


def nms_stage_ms(torch, call, reps=20, rounds=5):
    """Device ms of each of the nms kernel's three launches (``mask``,
    ``scan``: the ordered walk, ``finish``; ``<stage>_device_ms``): the
    mean duration of each kernel, found by its name
    (``nms_keep_<stage>``), over its launches in ``torch.profiler`` traces
    of ``reps`` calls of ``call()`` each. A trace may drop launches (one
    of 20 mask kernels in one run on the H100, 14 of 20 in another), so
    traces are taken, up to ``rounds`` of them, until every kernel holds
    ``reps`` traced launches in all. It raises when one does not, or when
    a trace holds more launches of a kernel than calls. Kernel durations,
    inputs warm in the L2: not the slope timer of ``device_ms``."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    ms, seen = dict.fromkeys(NMS_STAGES, 0.0), dict.fromkeys(NMS_STAGES, 0)
    traces = []
    for _ in range(rounds):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        got = dict.fromkeys(NMS_STAGES, 0)
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            for stage in NMS_STAGES:
                if 'nms_keep_%s' % stage in e.name:
                    ms[stage] += (e.time_range.end - e.time_range.start) / 1e3
                    got[stage] += 1
        traces.append(got)
        if any(n > reps for n in got.values()):
            raise AssertionError('nms profile: kernels traced %s of %d calls'
                                 % (got, reps))
        for stage, n in got.items():
            seen[stage] += n
        if min(seen.values()) >= reps:
            break
    else:
        raise AssertionError('nms profile: kernels traced %s in %d traces of '
                             '%d calls' % (traces, rounds, reps))
    if len(traces) > 1:
        log('time nms: the profiler dropped launches; kernels traced %s in '
            'traces of %d calls' % (traces, reps))
    return {'%s_device_ms' % k: v / seen[k] for k, v in ms.items()}


def time_nms(torch, kernels, args):
    """Times of the nms kernel and its plain version on the served batch's
    inputs at the top bucket (``args``: boxes (16, N, 4), valid, thresh,
    topk, class ids, as box_nms hands them over), and on its first image;
    the bound from these inputs; the kernel on the first 512 boxes of
    each image with the same topk (``floor_ms``: the scan's row blocks
    with a fourteenth of the IoUs); and its mask, scan and finish kernels
    apart (:func:`nms_stage_ms`). The kernel's mask must equal its plain
    version's on both. PyTorch has no NMS op and torchvision is not
    installed: no library call."""
    boxes, valid, thresh, topk, cls_id = args
    rows = {}
    for b in (boxes.shape[0], 1):
        bx, vd, cl = boxes[:b], valid[:b], cls_id[:b]

        def kernel(bx, vd, cl):
            return kernels.greedy_nms_keep(bx, vd, thresh, topk, cls_id=cl)

        def plain(bx, vd, cl):
            return kernels.greedy_nms_keep_reference(bx, vd, thresh, topk,
                                                     cls_id=cl)

        keep = kernel(bx, vd, cl)
        if not torch.equal(keep, plain(bx, vd, cl)):
            raise AssertionError('nms disagrees with its plain version on '
                                 'the served batch\'s first %d images' % b)
        log('check nms [the served batch\'s decoded boxes, B%d N%d]: %d '
            'kept, bitwise equal; the mask kernel writes %d bytes of words'
            % (b, bx.shape[1], int(keep.sum()), 8 * b * -(-bx.shape[1] // 64)
               * kernels.nms_iterations(bx.shape[1], topk)))
        nbytes, flops = nms_work(torch, kernels, bx, vd, keep, topk, cl)
        b_ms, b_by = bound(nbytes, flops)
        head = (bx[:, :512].contiguous(), vd[:, :512].contiguous(),
                cl[:, :512].contiguous())
        rows[b] = timings(
            torch, (bx, vd, cl), kernel, plain, plain_iters=3,
            plain_warmup=1, bound_ms=b_ms, bound_by=b_by,
            floor_ms=time_ms(torch, lambda: kernel(*head)),
            **nms_stage_ms(torch, lambda: kernel(bx, vd, cl)),
            shape='B%d N%d class-aware topk %d thresh %g, the served batch '
            'at bucket %d; %d of the %d steps kept; library: none (no NMS '
            'op in PyTorch, no torchvision)'
            % (b, bx.shape[1], topk, thresh, boxes.shape[0],
               int(keep[:, :kernels.nms_iterations(bx.shape[1], topk)].sum()),
               b * kernels.nms_iterations(bx.shape[1], topk)))
    top = rows[boxes.shape[0]]
    top['at_batch_1'] = rows[1]
    return {'nms': top}


def _seed_moving_stats(torch, net, seed):
    import numpy as np
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in sorted(net.collect_params().items()):
            if name.endswith('running_mean'):
                p.copy_(torch.from_numpy(
                    0.1 * rs.randn(*p.shape).astype('float32')))
            elif name.endswith('running_var'):
                p.copy_(torch.from_numpy(
                    (0.5 + rs.rand(*p.shape)).astype('float32')))


def _decode64(anchors, cls_preds, box_preds, var=(0.1, 0.1, 0.2, 0.2)):
    """multibox_detection's candidates in float64, per image: the
    foreground probabilities (N, C) and the clipped corner boxes (N, 4)."""
    import numpy as np
    a = anchors[0].astype(np.float64)
    aw, ah = a[:, 2] - a[:, 0], a[:, 3] - a[:, 1]
    acx, acy = (a[:, 0] + a[:, 2]) / 2, (a[:, 1] + a[:, 3]) / 2
    out = []
    for c, loc in zip(cls_preds.astype(np.float64),
                      box_preds.astype(np.float64)):
        e = np.exp(c - c.max(axis=1, keepdims=True))
        prob = (e / e.sum(axis=1, keepdims=True))[:, 1:]
        loc = loc.reshape(-1, 4)
        cx, cy = loc[:, 0] * var[0] * aw + acx, loc[:, 1] * var[1] * ah + acy
        w, h = np.exp(loc[:, 2] * var[2]) * aw, np.exp(loc[:, 3] * var[3]) * ah
        boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 1)
        out.append((prob, np.clip(boxes, 0, 1)))
    return out


def _iou64(a, b):
    """(n, 4) x (m, 4) corner boxes -> (n, m) IoU in float64, in the
    kernel's formula."""
    import numpy as np
    a, b = a[:, None].astype(np.float64), b[None].astype(np.float64)
    iw = np.maximum(np.minimum(a[..., 2], b[..., 2])
                    - np.maximum(a[..., 0], b[..., 0]), 0)
    ih = np.maximum(np.minimum(a[..., 3], b[..., 3])
                    - np.maximum(a[..., 1], b[..., 1]), 0)
    inter = iw * ih
    area = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]) \
        + (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area - inter + 1e-12)


def detection_margin(prob, boxes, margin, thresh=0.01):
    """The smallest slack of the decisions MultiBoxDetection takes on
    these candidates, each over its own margin (> 1 when every decision
    holds with room): scores against ``thresh``, a valid row's top class
    over its second, the 400th score over the 401st, the scores of a
    same-class pair that overlaps above 0.45 (``margin`` each); a deciding
    IoU against 0.45 (IOU_MARGIN)."""
    import numpy as np
    top2 = np.sort(prob, axis=1)[:, -2:]
    score, cid = top2[:, 1], prob.argmax(axis=1)
    valid = score > thresh
    slack = [np.abs(score - thresh).min() / margin,
             (top2[valid, 1] - top2[valid, 0]).min() / margin]
    order = np.argsort(-score, kind='stable')
    if valid.sum() > NMS_TOPK:
        slack.append((score[order[NMS_TOPK - 1]] - score[order[NMS_TOPK]])
                     / margin)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    for c in np.unique(cid[valid]):
        idx = np.flatnonzero(valid & (cid == c))
        iou = _iou64(boxes[idx], boxes[idx])
        decides = (rank[idx][:, None] < rank[idx][None, :]) \
            & (rank[idx][:, None] < NMS_TOPK)
        if decides.any():
            slack.append(np.abs(iou - NMS_THRESH)[decides].min() / IOU_MARGIN)
        close = np.abs(score[idx][:, None] - score[idx][None, :])
        over = decides & (iou > NMS_THRESH)
        if over.any():
            slack.append(close[over].min() / margin)
    return min(slack)


def match_detections(got, want, tol=DET_TOL):
    """Kept rows of two (N, 6) detection arrays matched one to one: equal
    ids, scores and coordinates within ``tol``. Returns the kept count."""
    import numpy as np
    got, want = got[got[:, 0] >= 0], want[want[:, 0] >= 0]
    same = (got[:, None, 0] == want[None, :, 0]) & (np.abs(
        got[:, None, 1:] - want[None, :, 1:]).max(axis=-1) <= tol)
    if len(got) != len(want) or not (same.sum(axis=0) == 1).all() \
            or not (same.sum(axis=1) == 1).all():
        raise AssertionError('detections differ: %d and %d kept rows, %d '
                             'matched' % (len(got), len(want),
                                          int((same.sum(axis=1) == 1).sum())))
    return len(got)


def ssd_against_cpu(torch, ssd, ops, kernels, gnn, device,
                    shape=SSD_TINY_BATCH, seed=0):
    """Phase 6a: the tiny SSD (``tests/test_image_ssd.py``) from
    ``init_params(seed)`` and seeded moving statistics, on ``device`` and
    on the CPU: heads within SSD_HEAD_REL of their max abs; then the
    card's heads, copied to the CPU, give detections that match the
    card's, given the margins (every decision further from its edge than
    four times the two devices' probability difference, and IoUs 1e-5)."""
    import numpy as np
    x = np.random.RandomState(seed).uniform(-1, 1, shape).astype('float32')
    det = ssd.MultiBoxDetection()
    runs = {}
    for dev in (device, torch.device('cpu')):
        net = ssd.init_params(ssd.SSD(device=dev, **SSD_TINY), seed)
        _seed_moving_stats(torch, net, seed + 1)
        kernels.reset_launch_counts()
        with torch.inference_mode():
            heads = net(torch.from_numpy(x).to(dev))
            dets = det(*heads)
        runs[dev.type] = ([h.cpu().numpy() for h in heads],
                          dets.cpu().numpy(), kernels.launch_counts())
    (heads, dets, launches), (cpu_heads, _, _) = runs[device.type], runs['cpu']
    head_err = max(np.abs(a - b).max() / np.abs(b).max()
                   for a, b in zip(heads, cpu_heads))
    with torch.inference_mode():
        cls = torch.from_numpy(heads[1])
        d = (ops.softmax(cls.to(device)).cpu() - ops.softmax(cls)).abs() \
            .max().item()
        cpu_dets = det(*[torch.from_numpy(h) for h in heads]).numpy()
    slack = min(detection_margin(p, b, max(4 * d, 1e-9))
                for p, b in _decode64(*heads))
    if slack <= 1:
        raise AssertionError('phase 6a: a detection decision lies within its '
                             'margin (slack %.3g): the comparison cannot '
                             'decide' % slack)
    kept = [match_detections(a, b) for a, b in zip(dets, cpu_dets)]
    bns = sum(isinstance(m, gnn.BatchNorm) for m in net.modules())
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(bn_act_fwd=bns, nms=1)
    log('phase 6a %s vs cpu: tiny SSD %s, heads rel_err %.3g; the card\'s '
        'heads through the CPU\'s detection: kept rows %s matched (ids '
        'equal, scores and boxes within %g), probability difference %.3g, '
        'smallest decision slack %.3g margins; launches %s'
        % (device.type, shape, head_err, kept, DET_TOL, d, slack,
           {k: v for k, v in launches.items() if v}))
    if not head_err <= SSD_HEAD_REL:
        raise AssertionError('phase 6a: the heads disagree')
    if device.type == 'cuda' and launches != want:
        raise AssertionError('phase 6a: launches %r, expected %r'
                             % (launches, want))


def serve_ssd(torch, serving, ssd, gnn, kernels, contrib, device,
              image=SSD_IMAGE, buckets=SSD_BUCKETS, clients=SSD_CLIENTS,
              per_client=SSD_PER_CLIENT, sequential=SSD_SEQUENTIAL, seed=0):
    """Phase 6b: ``ssd_300(20)`` from ``init_params(seed)`` behind
    MultiBoxDetection, frozen with the bucket ladder (all warmed) and
    served through ``InferenceSession(max_batch=16, deadline_ms=5)``:
    ``clients`` threads each sending ``per_client`` single-image requests
    back to back, then ``sequential`` requests one by one. Launch counts
    are zeroed just before and read just after; each response must equal
    ``frozen.run`` of its image, at its row of a zero batch of the bucket
    its batch ran in. Returns a dict of results."""
    import threading
    import numpy as np
    cuda = device.type == 'cuda'
    t0 = time.perf_counter()
    net = ssd.init_params(ssd.ssd_300(SSD_CLASSES, device=device), seed)
    frozen = serving.freeze(ssd.ssd_detector(net),
                            data_shapes=[('data', (3, image, image))],
                            buckets=buckets)
    frozen.warmup()
    setup_s = time.perf_counter() - t0
    total = clients * per_client + sequential
    x = np.random.RandomState(seed).uniform(
        -1, 1, (total, 3, image, image)).astype('float32')
    # which rows ran together, at which bucket
    seen = []
    run = frozen.run

    def recording(arrays, n=None):
        seen.append((arrays[0].copy(), frozen.policy.bucket_for(n)))
        return run(arrays, n)

    frozen.run = recording
    outs, lat, errors = [None] * total, [0.0] * total, []
    with serving.InferenceSession(frozen, max_batch=buckets[-1],
                                  deadline_ms=5.0, timeout_s=600) as sess:
        def client(c):
            try:
                for k in range(per_client):
                    i = c * per_client + k
                    t = time.perf_counter()
                    outs[i] = sess.infer(x[i], timeout=600)[0]
                    lat[i] = time.perf_counter() - t
            except Exception as exc:  # noqa: BLE001 - re-raised below
                errors.append(exc)

        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t1 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t1
        t2 = time.perf_counter()
        for i in range(clients * per_client, total):
            t = time.perf_counter()
            outs[i] = sess.infer(x[i], timeout=600)[0]
            lat[i] = time.perf_counter() - t
        wall_seq = time.perf_counter() - t2
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() if cuda else None
        stats = sess.stats()
        assert_healthy('phase 6b', sess)
    del frozen.run
    if errors:
        raise errors[0]
    batches = stats['queue']['batches']
    if len(seen) != batches or \
            sum(stats['batches_by_bucket'].values()) != batches:
        raise AssertionError('phase 6b: %d batches, %d runs recorded, by '
                             'bucket %r' % (batches, len(seen),
                                            stats['batches_by_bucket']))
    bns = sum(isinstance(m, gnn.BatchNorm) for m in net.modules())
    if bns != SSD_BATCH_NORMS:
        raise AssertionError('ssd_300 has %d BatchNorms' % bns)
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(nms=batches, bn_act_fwd=bns * batches)
    if cuda and launches != want:
        raise AssertionError('phase 6b: launches %r in %d batches, expected '
                             '%r' % (launches, batches, want))
    kept, bucket_of = [], []
    for i, out in enumerate(outs):
        if out.shape != (SSD_ANCHORS, 6) or not np.isfinite(out).all() \
                or not (out[:, 0] >= 0).any():
            raise AssertionError('phase 6b: response %d is %r, not finite or '
                                 'keeps nothing' % (i, out.shape))
        rows, bucket = next((rows, b) for rows, b in seen
                            if any(np.array_equal(r, x[i]) for r in rows))
        r = next(k for k, row in enumerate(rows) if np.array_equal(row,
                                                                   x[i]))
        batch = np.zeros((bucket,) + x.shape[1:], 'float32')
        batch[r] = x[i]
        if not np.array_equal(out, frozen.run([batch], n=bucket)[0][r]):
            raise AssertionError('phase 6b: response %d differs from its '
                                 'image run at bucket %d' % (i, bucket))
        kept.append(int((out[:, 0] >= 0).sum()))
        bucket_of.append(bucket)
    # the kernels' inputs of one batch at the top bucket, taken after the
    # served run so that holding them leaves its peak memory alone: nms
    # for phase 6's timing, the BN apply for its check at this path's
    # shapes
    captured, bn_captured = [], []
    keep_fn, bn_fn = contrib.greedy_nms_keep, kernels.epilogue.bn_act_forward

    def capture(*args, **kw):
        captured.append(args[:4] + (kw.get('cls_id'),))
        return keep_fn(*args, **kw)

    def capture_bn(*args, **kw):
        bn_captured.append((args, kw))
        return bn_fn(*args, **kw)

    contrib.greedy_nms_keep = capture
    kernels.epilogue.bn_act_forward = capture_bn
    try:
        frozen.run([x[:buckets[-1]]])
    finally:
        contrib.greedy_nms_keep = keep_fn
        kernels.epilogue.bn_act_forward = bn_fn
    prof = profile_step(torch, lambda: frozen.run([x[:buckets[-1]]]),
                        SSD_GROUPS) if cuda else None
    first = lat[:clients * per_client]
    return {
        'setup_s': setup_s, 'launches': launches, 'batches': batches,
        'by_bucket': stats['batches_by_bucket'], 'wall_s': wall,
        'wall_seq_s': wall_seq, 'img_per_s': clients * per_client / wall,
        'p50_ms': percentile(first, 50) * 1e3,
        'p99_ms': percentile(first, 99) * 1e3,
        'seq_p50_ms': percentile(lat[clients * per_client:], 50) * 1e3,
        'seq_p99_ms': percentile(lat[clients * per_client:], 99) * 1e3,
        'kept_min': min(kept), 'kept_max': max(kept), 'requests': total,
        'peak_mem_bytes': peak, 'profile': prof, 'compiled':
        stats['compiled'], 'nms_inputs': captured[0],
        'bn_inputs': bn_captured, 'frozen': frozen, 'images': x[:2],
        # the one-by-one requests: images, responses, the buckets they ran
        # at (phase 3h sends the same images over HTTP)
        'one_by_one': (x[clients * per_client:], outs[clients * per_client:],
                       bucket_of[clients * per_client:]),
    }


def check_ssd_bn_apply(torch, kernels, calls):
    """Phase 6b: the BN apply kernel against its plain version on the
    inputs that the served batch at the top bucket gave its 14 inference
    BatchNorms (``calls``: (args, kwargs) of each ``bn_act_forward``),
    bitwise. Returns {'bn_act_fwd': 0.0}."""
    if len(calls) != SSD_BATCH_NORMS:
        raise AssertionError('phase 6b: %d BN apply calls captured, expected '
                             '%d' % (len(calls), SSD_BATCH_NORMS))
    shapes = []
    with torch.inference_mode():
        for args, kw in calls:
            got = kernels.bn_act_forward(*args, **kw)
            want = kernels.bn_act_forward_reference(*args, **kw)
            if not torch.equal(got, want):
                err, _ = _errs(got, want)
                raise AssertionError('bn_act_fwd disagrees with its plain '
                                     'version at %s: max abs err %.3g'
                                     % (tuple(args[0].shape), err))
            shapes.append(tuple(args[0].shape))
    log('check bn_act_fwd [the served batch\'s %d BatchNorms, %s]: bitwise '
        'equal' % (len(shapes), shapes))
    return {'bn_act_fwd': 0.0}


# profile groups of one served batch (see BERT_GROUPS); 'other' holds the
# softmax, decode, sorts and gathers around the kernel, and the max pools
SSD_GROUPS = (('BN apply (epilogue kernel)', ('epilogue_',), ()),
              ('NMS kernel', ('nms_keep',), ()),
              ('convolutions', (), ('aten::convolution',)),
              ('copies', ('memcpy', 'memset'), ()))


# -- phase 7: the matmul probe slice -----------------------------------------

# odd shapes of the matmul kernels' check: M of 1 and past a tile (6272 +
# 77), N of 8, 40 and 64 (the 128 x 64 tile), K of 8, 72 and 2048, N past
# a 128 tile (136, 520); then for the instances (matmul_geometry): one
# 64-deep K slice with M a multiple of 128 (BN 128), K 200 over four
# slices, the last one partly past K (BN 128 at N 96), N 256 with M past a
# tile, M of 1 at N 1024 (four BN 256 tiles for the one-block-a-tile
# variants; N 2048 reaches ep's BN 256), and more tiles than ep has blocks
# at BN 64 and 128, so that each block walks several tiles through its
# ring and its staging buffers; last, for cur and noacc's (m, n) walk and
# masked stores: M past a tile with N past BN 256 (cur's 64 x 256 tiles in
# three columns, noacc's 128 x 128 in five, the last 8 wide), M of 77 at K
# 1024 and N 40 (one 128 x 64 tile masked at both edges), and one 64-deep
# slice with M and N past the tile
MATMUL_ODD = ((1, 64, 256), (6272 + 77, 512, 2048), (300, 72, 64),
              (6272 + 77, 72, 136), (129, 1024, 64), (257, 2048, 520),
              (1000, 256, 8), (77, 8, 40), (1024, 64, 128), (515, 200, 96),
              (131, 256, 256), (1, 512, 1024), (40000 + 77, 128, 64),
              (20000 + 3, 200, 128), (6272 + 77, 72, 520), (77, 1024, 40),
              (4096 + 13, 64, 264))
# instructions counted in each kernel's SASS (cuobjdump -sass): the wgmma,
# the TMA load and the TMA store. Every kernel must hold the first two;
# noacc, whose Y leaves from registers, must hold no TMA store.
SM90_SASS = ('HGMMA', 'UTMALDG', 'UTMASTG')
SM90_KERNELS = ('matmul_ws_kernel', 'matmul_ep_kernel', 'matmul_cur_kernel',
                'matmul_noacc_kernel')


def check_matmul_kernels(torch, kernels, probe, device, shapes=MATMUL_ODD):
    """The four matmul kernels against the float64 product at each (M, K,
    N), into NaN-filled outputs: each within the float64 bound and within
    twice it of the plain version (two sums that both hold the bound);
    cuBLAS and the plain version held to the bound too. Returns {kernel
    name: worst max abs difference from the plain version}."""
    gen = torch.Generator(device=device).manual_seed(7)
    worst = {'matmul_' + v: 0.0 for v in kernels.MATMUL_VARIANTS}
    for m, k, n in shapes:
        a = torch.randn(m, k, generator=gen, device=device).bfloat16()
        b = torch.randn(k, n, generator=gen, device=device).bfloat16()
        y64, allowed = probe.float64_bound(a, b)
        plain = kernels.matmul_reference(a, b)
        ratios = {'cublas': probe.bound_ratio(torch.matmul(a, b), y64,
                                              allowed),
                  'plain': probe.bound_ratio(plain, y64, allowed)}
        for v in kernels.MATMUL_VARIANTS:
            out = torch.full((m, n), float('nan'), dtype=torch.bfloat16,
                             device=device)
            kernels.matmul(a, b, v, out=out)
            ratios[v] = probe.bound_ratio(out, y64, allowed)
            vs_plain = probe.bound_ratio(out, plain.double(), 2 * allowed)
            if not (ratios[v] <= 1 and vs_plain <= 1):
                raise AssertionError(
                    'matmul %s at M=%d K=%d N=%d: |y - y64| / bound %.3g, '
                    'against the plain version %.3g' % (v, m, k, n,
                                                        ratios[v], vs_plain))
            err = (out.float() - plain.float()).abs().max().item()
            worst['matmul_' + v] = max(worst['matmul_' + v], err)
        if not max(ratios['cublas'], ratios['plain']) <= 1:
            raise AssertionError('cuBLAS or the plain version leaves the '
                                 'float64 bound at M=%d K=%d N=%d: %r'
                                 % (m, k, n, ratios))
        log('check matmul M=%d K=%d N=%d: |y - y64| / float64 bound %s'
            % (m, k, n, {name: round(r, 3) for name, r in ratios.items()}))
    return worst


def _spills(ptxas):
    """The ptxas lines that report a spill."""
    return [ln for ln in ptxas if any(int(n) for n in re.findall(
        r'(\d+) bytes spill (?:stores|loads)', ln))]


def ptxas_entries(ptxas):
    """{entry name: (registers, spill bytes)} from ptxas's lines for one
    source (``Compiling entry`` starts an entry; its spill and register
    lines follow)."""
    entries, fn = {}, None
    for ln in ptxas:
        head = re.search(r"Compiling entry function '(\S+)'", ln)
        if head:
            fn = head.group(1)
            entries[fn] = [0, 0]
        elif fn:
            spill = re.findall(r'(\d+) bytes spill (?:stores|loads)', ln)
            entries[fn][1] += sum(int(n) for n in spill)
            regs = re.search(r'Used (\d+) registers', ln)
            if regs:
                entries[fn][0] = int(regs.group(1))
    return {f: tuple(v) for f, v in entries.items()}


def sass_text(build, source):
    """``cuobjdump -sass`` (nvcc's toolkit) of ``source``'s library."""
    tool = os.path.join(build._cuda_home(), 'bin', 'cuobjdump')
    return subprocess.run([tool, '-sass', build.library_path(source)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout


def sass_counts(build, source, kernel_keys, ops):
    """{kernel: {instruction: count}} of the kernels of ``source`` whose
    names hold one of ``kernel_keys``, from its SASS."""
    counts, fn = {}, None
    for line in sass_text(build, source).splitlines():
        head = re.search(r'Function : (\S+)', line)
        if head:
            fn = head.group(1)
            fn = fn if any(k in fn for k in kernel_keys) else None
            if fn:
                counts[fn] = dict.fromkeys(ops, 0)
        elif fn:
            for op in ops:
                counts[fn][op] += len(re.findall(r'\b%s\b' % op, line))
    return counts


def check_sm90_build(build, ptxas):
    """The four variants' kernels of ``csrc/matmul_sm90.cu`` as built: the
    spills in ptxas's lines for that source (``ptxas``; empty when the
    library was current and not rebuilt), and the count of each of
    :data:`SM90_SASS` in each kernel's SASS. Raises when a kernel spills,
    lacks HGMMA or UTMALDG, or, in noacc, holds a UTMASTG. Returns
    {kernel: {instruction: count}}."""
    spills = _spills(ptxas)
    if spills:
        raise AssertionError('matmul_sm90 spills registers: %s' % spills)
    counts = sass_counts(build, 'matmul_sm90', SM90_KERNELS, SM90_SASS)
    missing = [k for k in SM90_KERNELS if not any(k in f for f in counts)]
    short = {f: c for f, c in counts.items()
             if not (c['HGMMA'] and c['UTMALDG'])
             or ('matmul_noacc_kernel' in f and c['UTMASTG'])}
    if missing or short:
        raise AssertionError('matmul_sm90 SASS: kernels missing %s, without '
                             'HGMMA or UTMALDG or (noacc) with UTMASTG %s'
                             % (missing, short))
    return counts


def check_epilogue_build(ptxas):
    """Registers and spill bytes of every instance of the stream kernels
    of ``csrc/epilogue.cu`` (``epilogue_act_fwd_kernel<A, EVICT>``,
    ``epilogue_act_bwd_kernel<A, EVICT>``, ``epilogue_bn_act_fwd_kernel<A,
    EVICT>``, ``epilogue_bn_act_bwd_kernel<A, EVICT>``)
    from ptxas's lines for that source (``ptxas``; empty when the library
    was current and not rebuilt). Raises when one spills, or when ptxas
    ran and reported not all four kernels. Returns {kernel: {'st' or
    'cs': most registers over the acts}} (``cs``: the evict-first
    stores). The bf16 instances count as ``act_fwd_bf16``,
    ``act_bwd_bf16``, ``bn_act_fwd_bf16``, ``bn_act_bwd_bf16`` and
    ``add_act_fwd_bf16`` (add+act's bf16 instance is a stream; its float32
    one, a grid-stride loop, is not reported)."""
    regs, spills = {}, {}
    for fn, (n, spill) in ptxas_entries(ptxas).items():
        m = re.search(r'epilogue_((?:bn_|add_)?act_(?:fwd|bwd)(?:_bf16)?)'
                      r'_kernelILi\d+ELb([01])E', fn)
        if not m:
            continue
        if spill:
            spills[fn] = spill
        by = regs.setdefault(m.group(1), {})
        key = 'cs' if m.group(2) == '1' else 'st'
        by[key] = max(by.get(key, 0), n)
    if spills:
        raise AssertionError('epilogue stream kernels spill: %s' % spills)
    want = {'act_fwd', 'act_bwd', 'bn_act_fwd', 'bn_act_bwd', 'act_fwd_bf16',
            'act_bwd_bf16', 'bn_act_fwd_bf16', 'bn_act_bwd_bf16',
            'add_act_fwd_bf16'}
    if ptxas and set(regs) != want:
        raise AssertionError('ptxas reported no %s kernel of epilogue.cu: '
                             '%s' % (' / '.join(sorted(want - set(regs))),
                                     sorted(regs)))
    return regs


def _instance(fn):
    """'bf16' or 'f32': the element type of a mangled kernel instance."""
    return 'bf16' if '__nv_bfloat16' in fn else 'f32'


def _check_mma_build(build, ptxas, kernel, source='flash_attention_bwd',
                     instances=('f32', 'bf16'), spill_limit=0):
    """``kernel``'s ``instances`` (float32, bf16) in ``csrc/<source>.cu``
    as built: their registers and spills from ptxas (``ptxas``: that
    source's lines; empty when the library was current) and their
    tensor-core instructions (HMMA) in the SASS. Raises when one spills
    more than ``spill_limit`` bytes or holds no HMMA, or an instance is
    missing. Returns {'f32' / 'bf16': (registers or None, {instruction:
    count, 'spill bytes': n})}."""
    regs, spills = {}, {}
    for fn, (n, spill) in ptxas_entries(ptxas).items():
        if kernel + '_kernel' in fn:
            if spill > spill_limit:
                raise AssertionError('%s (%s) spills %d bytes (limit %d)'
                                     % (kernel, _instance(fn), spill,
                                        spill_limit))
            regs[_instance(fn)] = n
            spills[_instance(fn)] = spill
    counts = {_instance(fn): c for fn, c in sass_counts(
        build, source, (kernel + '_kernel',), ('HMMA', 'LDS')).items()}
    if set(counts) != set(instances) or not all(
            c['HMMA'] for c in counts.values()):
        raise AssertionError('%s SASS: an instance missing or without HMMA: '
                             '%s' % (kernel, counts))
    return {k: (regs.get(k), dict(c, **{'spill bytes': spills.get(k)}))
            for k, c in counts.items()}


# the xent kernels, each built for float32 and bf16 logits / dlogits
XENT_KERNEL_KEYS = ('softmax_xent_fwd_warp_kernelI', 'softmax_xent_fwd_cluster'
                    '_kernelI', 'softmax_xent_fwd_two_pass_kernelI',
                    'softmax_xent_bwd_kernelI')


def check_no_spills(ptxas, source, kernel_keys):
    """{entry: registers} of the entries of ``source`` whose names hold
    one of ``kernel_keys``, from ptxas's lines (``ptxas``; empty when the
    library was current and not rebuilt). Raises when one spills, or when
    ptxas ran and reported none of a key."""
    regs, spills = {}, {}
    for fn, (n, spill) in ptxas_entries(ptxas).items():
        if any(k in fn for k in kernel_keys):
            regs[fn] = n
            if spill:
                spills[fn] = spill
    if spills:
        raise AssertionError('%s kernels spill: %s' % (source, spills))
    missing = [k for k in kernel_keys if not any(k in f for f in regs)]
    if ptxas and missing:
        raise AssertionError('ptxas reported no %s kernel of %s'
                             % (' / '.join(missing), source))
    return regs


def check_dq_build(build, ptxas):
    """The float32 dq kernel: :func:`_check_mma_build`."""
    return _check_mma_build(build, ptxas, 'flash_attention_dq',
                            instances=('f32',))


def check_dkv_build(build, ptxas):
    """The float32 dk/dv kernel: :func:`_check_mma_build`."""
    return _check_mma_build(build, ptxas, 'flash_attention_dkv',
                            instances=('f32',))


# the bf16 tensor-core flash kernels run two blocks an SM, 128 registers a
# thread, where ptxas spills a little (72 + 64 and 24 + 24 bytes of spill
# stores + loads at their first build); one block an SM spills nothing but
# ran slower (mxnet_tpu_torch/tools/probe_flash_bf16_variants.py)
TC_SPILL_LIMIT = 256
TC_SOURCES = ('flash_attention_fwd_bf16', 'flash_attention_dq_bf16',
              'flash_attention_dkv_bf16')


def check_bf16_tc_builds(build, reports):
    """The bf16 tensor-core flash forward, dq and dk/dv, each in its own
    source: :func:`_check_mma_build` (HMMA in the SASS, at most
    :data:`TC_SPILL_LIMIT` bytes of spill). ``reports``: ptxas's lines by
    source."""
    return {name: _check_mma_build(build, reports.get(name, ()), name, name,
                                   ('bf16',), TC_SPILL_LIMIT)
            for name in TC_SOURCES}


def matmul_rows(kernels, shapes):
    """Rows 13-16 of the kernels table from the probe's run (``shapes``,
    :func:`probe_matmul_pipeline.run`): each kernel's, the plain
    version's and cuBLAS's device times and the bound at the probe's
    first shape (401408 x 64 x 256, the most bytes), as ms / device_ms,
    plain_ms and library_ms / library_device_ms (these rows have no
    earlier per-call time to stay comparable with), and all eight shapes
    under ``by_shape``."""
    first = shapes[0]
    rows = {}
    for v in kernels.MATMUL_VARIANTS:
        ms, lib_ms = first['rows'][v]['ms'], first['rows']['cublas']['ms']
        rows['matmul_' + v] = dict(
            ms=ms, device_ms=ms, plain_ms=first['rows']['plain']['ms'],
            library_ms=lib_ms, library_device_ms=lib_ms,
            bound_ms=first['bound_ms'], bound_by=first['bound_by'],
            shape='M%d K%d N%d bf16 (probe shape 1), device times; library: '
            'torch.matmul (cuBLAS, float32 sums)'
            % (first['M'], first['K'], first['N']),
            by_shape=[dict(M=s['M'], K=s['K'], N=s['N'],
                           device_ms=s['rows'][v]['ms'],
                           share=s['rows'][v]['share'],
                           library_device_ms=s['rows']['cublas']['ms'],
                           plain_device_ms=s['rows']['plain']['ms'],
                           bound_ms=s['bound_ms'], bound_by=s['bound_by'])
                      for s in shapes])
    return rows


# -- entry -------------------------------------------------------------------

KERNELS = {
    'flash_attention_fwd': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/flash_attention_fwd.cu',
        replaces='mxnet_tpu/ops/pallas/attention.py:111'),
    'flash_attention_fwd.bf16': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/flash_attention_fwd_bf16.cu',
        replaces='mxnet_tpu/ops/pallas/attention.py:111'),
    'flash_attention_dq': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/flash_attention_bwd.cu',
        replaces='mxnet_tpu/ops/pallas/attention.py:208'),
    'flash_attention_dq.bf16': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/flash_attention_dq_bf16.cu',
        replaces='mxnet_tpu/ops/pallas/attention.py:208'),
    'flash_attention_dkv': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/flash_attention_bwd.cu',
        replaces='mxnet_tpu/ops/pallas/attention.py:243'),
    'flash_attention_dkv.bf16': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/flash_attention_dkv_bf16.cu',
        replaces='mxnet_tpu/ops/pallas/attention.py:243'),
    'flash_decode_fwd': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/flash_decode_fwd.cu',
        replaces='mxnet_tpu/ops/pallas/attention.py:423'),
    'flash_paged_decode_fwd': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/flash_decode_fwd.cu',
        replaces='mxnet_tpu/ops/pallas/attention.py:508'),
    'softmax_xent_fwd': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/softmax_xent.cu',
        replaces='mxnet_tpu/ops/pallas/xent.py:37'),
    'softmax_xent_fwd.bf16': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/softmax_xent.cu',
        replaces='mxnet_tpu/ops/pallas/xent.py:37'),
    'softmax_xent_bwd': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/softmax_xent.cu',
        replaces='mxnet_tpu/ops/pallas/xent.py:49'),
    'softmax_xent_bwd.bf16': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/softmax_xent.cu',
        replaces='mxnet_tpu/ops/pallas/xent.py:49'),
    'bn_act_fwd': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/epilogue.cu',
        replaces='mxnet_tpu/ops/pallas/epilogue.py:124'),
    'bn_act_fwd.bf16': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/epilogue.cu',
        replaces='mxnet_tpu/ops/pallas/epilogue.py:124'),
    'bn_act_bwd': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/epilogue.cu',
        replaces='mxnet_tpu/ops/pallas/epilogue.py:136'),
    'bn_act_bwd.bf16': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/epilogue.cu',
        replaces='mxnet_tpu/ops/pallas/epilogue.py:136'),
    'act_fwd': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/epilogue.cu',
        replaces='mxnet_tpu/ops/pallas/epilogue.py:234'),
    'act_fwd.bf16': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/epilogue.cu',
        replaces='mxnet_tpu/ops/pallas/epilogue.py:234'),
    'act_bwd': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/epilogue.cu',
        replaces='mxnet_tpu/ops/pallas/epilogue.py:239'),
    'act_bwd.bf16': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/epilogue.cu',
        replaces='mxnet_tpu/ops/pallas/epilogue.py:239'),
    'add_act_fwd': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/epilogue.cu',
        replaces='mxnet_tpu/ops/pallas/epilogue.py:297'),
    'add_act_fwd.bf16': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/epilogue.cu',
        replaces='mxnet_tpu/ops/pallas/epilogue.py:297'),
    'nms': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/nms.cu',
        replaces='mxnet_tpu/ops/pallas/nms.py:29'),
    'matmul_cur': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/matmul_sm90.cu',
        replaces='tools/probe_matmul_pipeline.py:41'),
    'matmul_noacc': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/matmul_sm90.cu',
        replaces='tools/probe_matmul_pipeline.py:65'),
    'matmul_ws': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/matmul_sm90.cu',
        replaces='tools/probe_matmul_pipeline.py:88'),
    'matmul_ep': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/matmul_sm90.cu',
        replaces='tools/probe_matmul_pipeline.py:112'),
    # no Pallas kernel: the XLA fusion of the traced update
    'multi_tensor_update': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/multi_tensor_update.cu',
        replaces='mxnet_tpu/optimizer/fused.py:119'),
    'multi_tensor_update.bf16': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/multi_tensor_update.cu',
        replaces='mxnet_tpu/optimizer/fused.py:119'),
    'multi_tensor_update.mp': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/multi_tensor_update.cu',
        replaces='mxnet_tpu/optimizer/fused.py:119'),
    # no Pallas kernel: the XLA fusion of the reference's gumbel noise
    'threefry_gumbel': dict(
        source='mxnet_tpu_torch/ops/kernels/csrc/sampling.cu',
        replaces='mxnet_tpu/serving/decode/sampling.py:121'),
}
TIMING_KEYS = ('ms', 'device_ms', 'plain_ms', 'bound_ms', 'bound_by',
               'library_ms', 'library_device_ms')


def log_degraded(rf, card):
    """Phase 3f (a)-(d)'s lines: each sub-check's degraded tokens, near
    ties, seconds and the breaker's states; the CPU fallback's own
    times; the card-side launches."""
    sub = rf['subchecks']
    for name in ('a', 'd'):
        r = sub[name]
        log('phase 3f (%s) [%s]: %s: %d streams degraded, %d fallback tokens '
            '(%d from the card before the trip), retired %s, %d near ties %s;'
            ' %.3f s to complete them, %.1f CPU ms a fallback token; breaker '
            '%s after the trip, %s after a clean request on the card (status '
            '%s)%s'
            % (name, card, r['spec'], DEGRADED_REQUESTS, r['fallback_tokens'],
               rf['healthy_tokens'] - r['fallback_tokens'], r['retired'],
               len(r['ties']), r['ties'], r['wall_s'],
               r['wall_s'] * 1e3 / r['fallback_tokens'],
               r['breaker_after_trip'], r['breaker_after_clean'],
               r['status_after_clean'],
               '; artifact %s' % json.dumps(r['artifact'])
               if 'artifact' in r else ''))
    b = sub['b']
    log('phase 3f (b) [%s]: %s under CircuitBreaker(3, %.1f): breaker %s; '
        '%d fallback tokens, %d near ties %s, %.3f s for the degraded '
        'streams; %.3f s from the trip to the first card token after the '
        'half-open probe'
        % (card, b['spec'], BREAKER_RESET_S, ' -> '.join(b['states']),
           b['fallback_tokens'], len(b['ties']), b['ties'], b['wall_s'],
           b['trip_to_card_token_s']))
    c = sub['c']
    log('phase 3f (c) [%s]: %s: every stream raised %s after %s tokens, '
        'retired %s, slots free, the next request clean on the card'
        % (card, c['spec'], c['errors'][0], c['tokens_before'],
           c['retired']))
    log('phase 3f [%s]: the CPU fallback alone at full width: prefill of %d '
        'tokens %.1f ms, %.1f ms a token after it; card side %d prefills, %d '
        'steps, launches %s, %d programs, none built by a trip; %.1f s for '
        '(a)-(d)'
        % (card, rf['prompt_len'], rf['cpu_prefill_ms'], rf['cpu_token_ms'],
           rf['prefills'], rf['steps'],
           {k: v for k, v in rf['launches'].items() if v}, rf['programs'],
           rf['seconds']))


def log_times(times):
    for name, row in times.items():
        lib = row['library_ms']
        log('time %s [%s]: kernel %.4f ms (device %.4f ms), plain %.4f ms, '
            'library %s, bound %.4f ms (%s)'
            % (name, row['shape'], row['ms'], row['device_ms'],
               row['plain_ms'], 'none' if lib is None else
               '%.4f ms (device %.4f ms)' % (lib, row['library_device_ms']),
               row['bound_ms'], row['bound_by']))
        if 'bound_cuda_core_ms' in row:
            log('time %s: float32 CUDA-core bound %.4f ms (operations)'
                % (name, row['bound_cuda_core_ms']))
        if 'f32_device_ms' in row:
            log('time %s: the float32 instance on the same inputs widened, '
                'device %.4f ms' % (name, row['f32_device_ms']))
        if 'at_stem' in row:
            at = row['at_stem']
            log('time %s at %s: device %.4f ms, library %.4f ms, bound %.4f '
                'ms (bytes)' % (name, at['shape'], at['device_ms'],
                                at['library_device_ms'], at['bound_ms']))
        if 'bound_share' in row:
            log('time %s: share of the bound %.3f (device)'
                % (name, row['bound_share']))
        if 'log_softmax_ms' in row:
            log('time %s: log_softmax %.4f ms (device %.4f ms)'
                % (name, row['log_softmax_ms'], row['log_softmax_device_ms']))
        if 'group' in row:
            gr = row['group']
            log('time flash forward + dq + dk/dv (bf16) against SDPA forward + '
                'backward on bf16: device %.4f ms against %.4f ms, bound %.4f '
                'ms' % (gr['kernels_device_ms'], gr['sdpa_device_ms'],
                        gr['bound_ms']))
        if 'pair_turns_device_ms' in row:
            log('time %s: dq + dkv against SDPA backward, device ms in '
                'turns: %s' % (name, row['pair_turns_device_ms']))
        if 'group_turns_device_ms' in row:
            log('time %s: forward + dq + dkv against SDPA forward + '
                'backward, device ms in turns: %s'
                % (name, row['group_turns_device_ms']))
        if 'device_ms_at_pos' in row:
            log('time %s: device ms at one position for every slot %s'
                % (name, row['device_ms_at_pos']))
        if 'slot_device_ms' in row:
            log('time %s: device ms of the slot kernel over the same K/V '
                '%.4f, of the page-table gather + the slot kernel %.4f'
                % (name, row['slot_device_ms'], row['gather_slot_device_ms']))
            for at in row['at_phase3']:
                log('time %s at phase 3\'s positions %s: device ms paged '
                    '%.4f, slot %.4f, gather + slot %.4f, SDPA over the '
                    'gathered view %.4f; bound %.4f ms'
                    % (name, at['positions'], at['device_ms'],
                       at['slot_device_ms'], at['gather_slot_device_ms'],
                       at['library_device_ms'], at['bound_ms']))
        if 'mask_device_ms' in row:
            log('time %s: device ms (profiler) of the mask kernel %.4f, the '
                'walk %.4f, the finish %.4f'
                % (name, row['mask_device_ms'],
                   row['scan_device_ms'], row['finish_device_ms']))


def kernel_rows(errs, times, train_times, launches_by_path):
    """The ``kernels`` JSON rows: each kernel's launches on the main
    paths, its worst error against its plain version and its times. The
    flash forward runs on both paths: its row times the serving shape
    and carries the training shape's times under ``at_training_shape``.
    ``train_times`` holds the BERT and the ResNet training kernels."""
    rows = []
    for name, meta in KERNELS.items():
        t = times.get(name) or train_times[name]
        by_path = {path: counts[name]
                   for path, counts in launches_by_path.items()
                   if counts[name]}
        row = {'name': name, 'route': 'cuda', 'source': meta['source'],
               'replaces': meta['replaces'],
               'launches': sum(by_path.values()),
               'launches_by_path': by_path, 'max_abs_err': errs[name]}
        row.update({k: t[k] for k in TIMING_KEYS})
        row.update({k: t[k] for k in ('floor_ms', 'at_batch_1', 'by_shape',
                                      'bound_share',
                                      'bound_cuda_core_ms', 'f32_device_ms',
                                      'at_stem', 'at_mlm', 'log_softmax_ms',
                                      'log_softmax_device_ms',
                                      'pair_turns_device_ms',
                                      'group_turns_device_ms', 'group',
                                      'device_ms_at_pos', 'slot_device_ms',
                                      'gather_slot_device_ms', 'at_phase3',
                                      'mask_device_ms', 'sass_mix',
                                      'bound_pipe', 'bound_by_pipe_ms',
                                      'bound_f32_rate_ms',
                                      'scan_device_ms', 'finish_device_ms',
                                      'host_ms', 'chain_ms',
                                      'chain_device_ms', 'by_list')
                    if k in t})
        row['shape'] = t['shape']
        if name in times and name in train_times:
            tt = train_times[name]
            row['at_training_shape'] = dict(
                {k: tt[k] for k in TIMING_KEYS}, shape=tt['shape'])
        rows.append(row)
    return rows


def log_programs(phase, card, got, eager):
    """The captured serving run against its eager twin: the same tokens,
    the same launches; the capture seconds, the step's time and
    profile."""
    if got['outs'] != eager['outs']:
        raise AssertionError('%s: the captured programs served other tokens '
                             'than the eager bodies: requests %s' % (
                                 phase, [i for i, (a, b) in enumerate(
                                     zip(got['outs'], eager['outs']))
                                     if a != b]))
    if got['launches'] != eager['launches'] or \
            (got['prefills'], got['steps']) != (eager['prefills'],
                                                eager['steps']):
        raise AssertionError('%s: replays launched %r, the eager bodies %r'
                             % (phase, got['launches'], eager['launches']))
    log('%s programs: the reference\'s set built as the session started '
        '(%.3f s), none after; capture seconds %s; %d streams token for '
        'token the eager bodies\', launches equal'
        % (phase, got['warmup_s'], json.dumps(
            {k: round(v, 4) for k, v in got['compile_seconds'].items()}),
           len(got['outs'])))
    log('%s decode step [%s]: captured %.4f ms a run_step (CUDA events, the '
        'copy in and back included; engine mean %.3f ms), eager %.4f ms '
        '(engine %.3f ms); tokens/s %.2f (eager %.2f)'
        % (phase, card, got['replay_step_ms'], got['decode_step_ms'],
           eager['replay_step_ms'], eager['decode_step_ms'],
           got['tokens_per_s'], eager['tokens_per_s']))
    log_profile('%s captured decode step' % phase, card, got['step_profile'])
    log_profile('%s eager decode step' % phase, card, eager['step_profile'])


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'False)', file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, 'mxnet_tpu_torch')):
        print('chip_smoke: the mxnet_tpu_torch package is not beside this '
              'script', file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    # scripted faults belong to phase 3f alone
    if os.environ.pop('MXNET_TPU_FAULT', None) is not None:
        log('MXNET_TPU_FAULT was set; unset: only phase 3f scripts faults')
    from mxnet_tpu_torch import capture as capture_mod
    from mxnet_tpu_torch import optimizer, parallel, serving
    from mxnet_tpu_torch import loadgen
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.gluon.model_zoo import bert, resnet, ssd
    from mxnet_tpu_torch.ops import contrib, kernels
    from mxnet_tpu_torch.ops import nn as ops
    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.ops.kernels import sampling as noise
    from mxnet_tpu_torch.tools import probe_matmul_pipeline as probe

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products (phase 7's cuBLAS yardstick) sum in float32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log('tf32 off: torch.backends.cuda.matmul.allow_tf32=False, '
        'torch.backends.cudnn.allow_tf32=False; bf16 reduced-precision '
        'reductions off')
    log('python %s torch %s cuda %s' % (sys.version.split()[0],
                                        torch.__version__,
                                        torch.version.cuda))
    cuda = torch.device('cuda')
    started = time.perf_counter()
    # phase 1: device and build
    card = probe.card()
    log(card)
    t0 = time.perf_counter()
    reports = _build.build_all()
    log('phase 1 build: %d kernel sources in %.1f s'
        % (len(_build.SOURCES), time.perf_counter() - t0))
    for name, lines in reports.items():
        log('ptxas %s: %s' % (name, ' | '.join(lines)))
    spills = _spills(reports.get('flash_attention_fwd', ()))
    if spills:
        raise AssertionError('flash_attention_fwd spills registers: %s'
                             % spills)
    for fn, counts in check_sm90_build(
            _build, reports.get('matmul_sm90', ())).items():
        log('sass matmul_sm90 %s: %s' % (fn, counts))
    for name, check in (('flash_attention_dq', check_dq_build),
                        ('flash_attention_dkv', check_dkv_build)):
        for inst, (regs, counts) in sorted(check(
                _build, reports.get('flash_attention_bwd', ())).items()):
            log('%s (%s): %s registers, no spills; SASS %s'
                % (name, inst, regs, counts))
    for name, built in check_bf16_tc_builds(_build, reports).items():
        regs, counts = built['bf16']
        log('%s: %s registers; SASS and spills %s' % (name, regs, counts))
    log('flash_attention_fwd instances: registers %s, no spills' % {
        '%s bq %s' % (_instance(fn), re.search(r'ILi(\d+)E', fn).group(1)): n
        for fn, (n, _) in ptxas_entries(
            reports.get('flash_attention_fwd', ())).items()})
    # the decode kernel's two instances: the slot cache and the page pool
    for source, keys in (('flash_decode_fwd', ('SlotRows', 'PagedRows')),
                         ('nms', ('nms_keep_mask_kernel',
                                  'nms_keep_scan_kernel',
                                  'nms_keep_finish_kernel'))):
        regs = check_no_spills(reports.get(source, ()), source, keys)
        log('%s kernels: registers %s, no spills'
            % (source, regs or 'not reported: the library was current'))
    regs = check_epilogue_build(reports.get('epilogue', ()))
    log('epilogue stream kernels: registers by store kind (most over the '
        'acts) %s, no spills' % (regs or 'not reported: the library was '
                                 'current'))
    regs = check_no_spills(reports.get('multi_tensor_update', ()),
                           'multi_tensor_update',
                           ('multi_tensor_update_kernel',))
    log('multi_tensor_update kernels: registers %s, no spills'
        % (regs or 'not reported: the library was current'))
    regs = check_no_spills(reports.get('sampling', ()), 'sampling',
                           ('threefry_gumbel_kernel',))
    log('threefry_gumbel kernel: registers %s, no spills'
        % (regs or 'not reported: the library was current'))
    regs = check_no_spills(reports.get('softmax_xent', ()), 'softmax_xent',
                           XENT_KERNEL_KEYS)
    log('softmax_xent kernels: registers %s, no spills' % ({
        '%s %s' % (k, _instance(fn)): n for fn, n in regs.items()
        for k in XENT_KERNEL_KEYS if k in fn} or 'not reported: the library '
        'was current'))

    # phase 2: kernels against their plain versions, then times
    errs = check_kernels(torch, kernels, cuda)
    errs['flash_paged_decode_fwd'] = check_paged_kernel(torch, kernels, cuda)
    for name, err in check_training_kernels(torch, kernels, cuda).items():
        errs[name] = max(errs.get(name, 0.0), err)
    torch.cuda.empty_cache()
    errs.update(check_bf16_kernels(torch, kernels, cuda))
    torch.cuda.empty_cache()
    errs['softmax_xent_bwd'] = max(errs['softmax_xent_bwd'],
                                   check_xent_backward_chunks(torch, kernels,
                                                              cuda))
    errs.update(check_epilogue_kernels(torch, kernels, cuda))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    errs.update(check_bf16_rows(torch, kernels, cuda))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    lists = dict(odd=[(n,) for n in ODD_LENGTHS],
                 **param_lists(torch, bert, resnet))
    errs.update(check_fused_update(torch, kernels, optimizer, cuda, lists))
    torch.cuda.empty_cache()
    errs['threefry_gumbel'] = check_noise_kernel(torch, noise, cuda)
    times = time_kernels(torch, kernels)
    times.update(time_paged_decode(torch, kernels))
    times.update(time_noise_kernel(torch, noise, cuda, _build))
    log_times(times)
    train_times = time_training_kernels(torch, kernels)
    log_times(train_times)
    torch.cuda.empty_cache()
    bf16_times = time_bf16_kernels(torch, kernels)
    log_times(bf16_times)
    train_times.update(bf16_times)
    torch.cuda.empty_cache()
    epi_times = time_epilogue_kernels(torch, kernels)
    log_times(epi_times)
    train_times.update(epi_times)
    del epi_times
    torch.cuda.empty_cache()
    row_times = time_bf16_rows(torch, kernels)
    log_times(row_times)
    for name, row in list(bf16_times.items()) + list(row_times.items()):
        log('time %s [%s]: device %.4f ms, float32 instance on the widened '
            'inputs %.4f ms, bound %.4f ms, library %s ms%s'
            % (name, card, row['device_ms'], row['f32_device_ms'],
               row['bound_ms'], row['library_device_ms'],
               '; at_mlm %s' % json.dumps(row['at_mlm'])
               if 'at_mlm' in row else ''))
    train_times.update(row_times)
    del bf16_times, row_times
    torch.cuda.empty_cache()
    fused_times = time_fused_update(torch, kernels, optimizer, cuda, lists)
    log_times(fused_times)
    train_times.update(fused_times)
    del fused_times
    torch.cuda.empty_cache()

    # phase 3: the serving slice, through the captured programs, then
    # the same requests through the same bodies uncaptured
    res = serve(torch, serving, kernels, cuda)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    res_eager = serve(torch, serving, kernels, cuda, recheck=0,
                      capture=False)
    log_programs('phase 3', card, res, res_eager)
    log('phase 3 slice: %d requests, prompts %s, %d new tokens each'
        % (REQUESTS, res['prompt_lens'], NEW_TOKENS))
    log('phase 3 slice: %d prefills, %d steps, launches %s'
        % (res['prefills'], res['steps'], res['launches']))
    log('phase 3 recheck: %d tokens equal to full_forward, %d ties %s'
        % (res['recheck_equal'], len(res['recheck_ties']),
           res['recheck_ties']))
    log('phase 3 metrics [%s]: tokens/s %.2f, TTFT p50 %.2f ms, p99 %.2f '
        'ms, mean decode step %.3f ms, wall %.3f s, peak memory %d B, '
        'cache %d B, setup %.1f s'
        % (card, res['tokens_per_s'], res['ttft_p50_ms'],
           res['ttft_p99_ms'], res['decode_step_ms'], res['wall_s'],
           res['peak_mem_bytes'], res['cache_bytes'], res['setup_s']))
    torch.cuda.empty_cache()

    # phase 3p: the same requests through freeze_decode's default, the
    # paged cache at page size 16
    rp = serve(torch, serving, kernels, cuda, paged=True, recheck=0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log_programs('phase 3p', card, rp, serve(
        torch, serving, kernels, cuda, paged=True, recheck=0,
        capture=False))
    if rp['outs'] != res['outs']:
        raise AssertionError('phase 3p: paged tokens differ from phase 3\'s '
                             'slot-cache tokens: %s' % [
                                 i for i, (a, b) in enumerate(
                                     zip(rp['outs'], res['outs'])) if a != b])
    log('phase 3p slice: paged cache, page size %d; %d prefills, %d steps, '
        'launches %s; the 16 streams token for token phase 3\'s; prefix hits '
        '%d, copies on write %d, page evictions %d'
        % (PAGE_SIZE, rp['prefills'], rp['steps'], rp['launches'],
           rp['counts']['prefix_hits'], rp['counts']['cow_copies'],
           rp['counts']['page_evictions']))
    log('phase 3p metrics [%s]: tokens/s %.2f (phase 3 %.2f), TTFT p50 %.2f '
        'ms (%.2f), p99 %.2f ms (%.2f), mean decode step %.3f ms (%.3f), '
        'wall %.3f s, peak memory %d B, pool %d B (slot cache %d B)'
        % (card, rp['tokens_per_s'], res['tokens_per_s'], rp['ttft_p50_ms'],
           res['ttft_p50_ms'], rp['ttft_p99_ms'], res['ttft_p99_ms'],
           rp['decode_step_ms'], res['decode_step_ms'], rp['wall_s'],
           rp['peak_mem_bytes'], rp['cache_bytes'], res['cache_bytes']))
    log('phase 3p cache_accounting (idle, after the run): %s; pool %s'
        % (json.dumps(rp['cache_accounting']), rp['pages']))
    torch.cuda.empty_cache()

    # phase 3s: prefix sharing, then speculative decoding, at full width
    sh = serve_shared(torch, serving, kernels, cuda)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sh_eager = serve_shared(torch, serving, kernels, cuda, capture=False,
                            recheck=False)
    for run in ('prefix', 'spec'):
        if sh[run]['outs'] != sh_eager[run]['outs']:
            raise AssertionError('phase 3s %s: the captured programs served '
                                 'other tokens than the eager bodies' % run)
        log('phase 3s %s programs: %d streams token for token the eager '
            'bodies\'; capture seconds %s; mean tick %.3f ms (eager %.3f)'
            % (run, len(sh[run]['outs']), json.dumps(
                {k: round(v, 4) for k, v in
                 sh[run]['compile_seconds'].items()}),
               sh[run]['step_ms'], sh_eager[run]['step_ms']))
    for run, r in sh.items():
        c = r['counts']
        log('phase 3s %s: %d prefills, %d ticks (%d speculative), prefix hits '
            '%d (%d tokens), copies on write %d, proposed %d, accepted %d '
            '(acceptance %s); launches %s; teacher-forced: %d tokens equal to '
            'full_forward, %d ties %s'
            % (run, c['prefills'], c['steps'], c['spec_rounds'],
               c['prefix_hits'], c['prefix_tokens_saved'], c['cow_copies'],
               c['spec_proposed'], c['spec_accepted'], r['acceptance'],
               r['launches'], r['recheck_equal'], len(r['recheck_ties']),
               r['recheck_ties']))
        log('phase 3s %s metrics [%s]: %d tokens, tokens/s %.2f, TTFT p50 '
            '%.2f ms, p99 %.2f ms, mean tick %.3f ms, wall %.3f s; '
            'cache_accounting %s'
            % (run, card, r['tokens'], r['tokens_per_s'], r['ttft_p50_ms'],
               r['ttft_p99_ms'], r['step_ms'], r['wall_s'],
               json.dumps(r['cache_accounting'])))
    torch.cuda.empty_cache()

    # phase 3a: sampled decoding and adapters in the captured programs
    ra = serve_adapters(torch, serving, kernels, cuda, rp['outs'])
    log('phase 3a slice: %d requests (%s by (adapter, sampled)), %d new '
        'tokens each, temperature %g, top_p %g, seeds 0-%d, %d adapters of '
        'rank %d on a pool of %d rows; %d prefills, %d steps, launches %s; '
        'the reference\'s program set built at start (capture seconds %s), '
        'none after; the %d streams token for token the eager bodies\'; '
        'greedy base requests %s token for token phase 3p\'s; every '
        'adapter stream unlike its base twin'
        % (len(ra['outs']), ra['kinds'], NEW_TOKENS, SAMPLE_TEMP,
           SAMPLE_TOP_P, len(ra['outs']) - 1, ADAPTERS, ADAPTER_RANK,
           ADAPTER_SLOTS, ra['counts']['prefills'], ra['counts']['steps'],
           ra['launches'], json.dumps({k: round(v, 4) for k, v in
                                       ra['compile_seconds'].items()}),
           len(ra['outs']), ra['greedy_base']))
    log('phase 3a metrics [%s]: tokens/s %.2f (eager %.2f), wall %.3f s, '
        '%d sampled tokens; adapter pool %d B, %s (eager run %s)'
        % (card, ra['tokens_per_s'], ra['eager_tokens_per_s'], ra['wall_s'],
           ra['counts']['sampled_tokens'], ra['pool']['pool_bytes'],
           json.dumps(ra['pool']), json.dumps(ra['eager_pool'])))
    log('phase 3a speculation: sampled acceptance with the self-draft %s; '
        'streams equal to the plain sampled ones but at %d near-tie '
        'positions %s' % (json.dumps(ra['acceptance']), len(ra['spec_ties']),
                          ra['spec_ties']))
    log('phase 3a mask: %d tokens under a mask forbidding the odd ids, none '
        'odd, no program built' % ra['masked_tokens'])
    for name, (ms, prof) in ra['step'].items():
        log('phase 3a replayed step, %s [%s]: %.4f ms a run_step (CUDA events, '
            'the copy in and back included, mean of 2 turns)'
            % (name, card, ms))
        log_profile('phase 3a step, %s' % name, card, prof)
    nrow = times['threefry_gumbel']
    log('phase 3a noise kernel [%s]: threefry_gumbel device %.4f ms (slope '
        'timer) at %s, bound %.5f ms (%s: %s; SASS mix %s a thread, the '
        'pipes\' ms %s; at the float32 rate of %d operations an element '
        '%.5f ms)'
        % (card, nrow['device_ms'], nrow['shape'], nrow['bound_ms'],
           nrow['bound_by'], nrow['bound_pipe'], nrow['sass_mix'],
           {k: round(v, 6) for k, v in nrow['bound_by_pipe_ms'].items()},
           THREEFRY_OPS, nrow['bound_f32_rate_ms']))
    torch.cuda.empty_cache()

    # phase 3m (a)-(b): live migration across page sizes, prefill_only
    t0 = time.perf_counter()
    rm = serve_migration(torch, serving, kernels, cuda, ra['outs'],
                         sh['prefix']['outs'])
    rm['seconds'] = time.perf_counter() - t0
    log_migration(rm, card)
    torch.cuda.empty_cache()

    # phase 3f (a)-(d): the degraded path of the decode engine on the card
    rf = serve_degraded(torch, serving, kernels, cuda)
    log_degraded(rf, card)
    torch.cuda.empty_cache()

    # phase 4: the training slice
    train_against_cpu(torch, bert, gloss, parallel, cuda)
    torch.cuda.empty_cache()
    tr = train_full(torch, bert, gloss, parallel, kernels, cuda)
    log('phase 4b slice: BERT-base, batch %d, S %d, %d predictions, %d '
        'warm-up + %d timed steps; launches in the timed steps %s (per '
        'step %s)' % (TRAIN['batch'], TRAIN['seq'], TRAIN['preds'],
                      TRAIN_WARMUP, TRAIN_ITERS, tr['launches'],
                      tr['per_step']))
    log('phase 4b losses: %s' % tr['losses'])
    log('phase 4b metrics [%s]: samples/s %.2f, mean step %.3f ms (CUDA '
        'events; each %s), wall %.3f s for %d steps, peak memory %d B, '
        'setup %.1f s'
        % (card, tr['samples_per_s'], tr['step_ms'],
           ['%.3f' % t for t in tr['step_ms_each']], tr['wall_s'],
           TRAIN_ITERS, tr['peak_mem_bytes'], tr['setup_s']))

    log_profile('phase 4b', card, tr['profile'])
    torch.cuda.empty_cache()
    cap_ms, eager_ms = bert_twins(torch, bert, gloss, parallel, cuda)
    log('phase 4b program: captured at the second step in %s s; twins at '
        '4b\'s configuration under deterministic algorithms: %d steps (2 + '
        '10) captured bit for bit the eager body\'s, losses and every '
        'parameter; mean step %.3f ms captured, %.3f ms eager (CUDA events, '
        'deterministic algorithms) [%s]'
        % (json.dumps({k: round(v, 4) for k, v in
                       tr['compile_seconds'].items()}),
           TRAIN_WARMUP + TRAIN_ITERS, cap_ms, eager_ms, card))
    torch.cuda.empty_cache()

    # phase 4c: the same under amp='bf16' (bf16 compute over float32
    # masters), first its small BERT on the card against the CPU
    train_against_cpu(torch, bert, gloss, parallel, cuda, amp='bf16')
    torch.cuda.empty_cache()
    tc = train_full(torch, bert, gloss, parallel, kernels, cuda, amp='bf16')
    first_rel = abs(tc['losses'][0] - tr['losses'][0]) / abs(tr['losses'][0])
    log('phase 4c slice: BERT-base under amp=%r, batch %d, S %d, %d '
        'predictions, %d warm-up + %d timed steps; launches in the timed '
        'steps %s (per step %s); masters %s, AdamW state %s'
        % (tc['amp'], TRAIN['batch'], TRAIN['seq'], TRAIN['preds'],
           TRAIN_WARMUP, TRAIN_ITERS, tc['launches'], tc['per_step'],
           tc['master_dtypes'], tc['state_dtypes']))
    log('phase 4c losses: %s; first loss %.6f against 4b\'s %.6f, rel %.4g '
        '(limit %g)' % (tc['losses'], tc['losses'][0], tr['losses'][0],
                        first_rel, AMP_FIRST_LOSS_RTOL))
    if not first_rel <= AMP_FIRST_LOSS_RTOL:
        raise AssertionError('phase 4c: first loss %.6f is not within %g of '
                             '4b\'s %.6f' % (tc['losses'][0],
                                              AMP_FIRST_LOSS_RTOL,
                                              tr['losses'][0]))
    log('phase 4c metrics [%s]: samples/s %.2f (4b %.2f), mean step %.3f ms '
        '(4b %.3f; CUDA events; each %s), wall %.3f s for %d steps, peak '
        'memory %d B (4b %d B), setup %.1f s'
        % (card, tc['samples_per_s'], tr['samples_per_s'], tc['step_ms'],
           tr['step_ms'], ['%.3f' % t for t in tc['step_ms_each']],
           tc['wall_s'], TRAIN_ITERS, tc['peak_mem_bytes'],
           tr['peak_mem_bytes'], tc['setup_s']))
    log_profile('phase 4c (casts: aten::_to_copy and ToCopyBackward)', card,
                tc['profile'])
    log('phase 4c capture seconds %s' % json.dumps(
        {k: round(v, 4) for k, v in tc['compile_seconds'].items()}))
    torch.cuda.empty_cache()

    # phase 4a-cast, 4d, 4d-mp: bench_bert's accelerator configuration,
    # after cast('bfloat16') with AdamW on bf16 weights, without and with
    # float32 masters; first the small BERT on the card against the CPU
    for route in ('cast', 'cast_mp'):
        train_against_cpu(torch, bert, gloss, parallel, cuda, route=route)
    torch.cuda.empty_cache()
    cast_runs = {}
    for route, phase in (('cast', 'phase 4d'), ('cast_mp', 'phase 4d-mp')):
        td = train_full(torch, bert, gloss, parallel, kernels, cuda,
                        route=route)
        first_rel = abs(td['losses'][0] - tr['losses'][0]) / abs(
            tr['losses'][0])
        log('%s slice: BERT-base after cast(\'bfloat16\'), AdamW %s, batch '
            '%d, S %d, %d predictions, %d warm-up + %d timed steps; launches '
            'in the timed steps %s (per step %s); parameters %s, AdamW state '
            '%s, %d optimizer warnings'
            % (phase, 'with multi_precision' if route == 'cast_mp'
               else 'on bf16 weights and state', TRAIN['batch'],
               TRAIN['seq'], TRAIN['preds'], TRAIN_WARMUP, TRAIN_ITERS,
               td['launches'], td['per_step'], td['master_dtypes'],
               td['state_dtypes'], td['warnings']))
        log('%s losses: %s; first loss %.6f against 4b\'s %.6f, rel %.4g '
            '(limit %g)' % (phase, td['losses'], td['losses'][0],
                            tr['losses'][0], first_rel,
                            AMP_FIRST_LOSS_RTOL))
        if not first_rel <= AMP_FIRST_LOSS_RTOL:
            raise AssertionError('%s: first loss %.6f is not within %g of '
                                 '4b\'s %.6f' % (phase, td['losses'][0],
                                                  AMP_FIRST_LOSS_RTOL,
                                                  tr['losses'][0]))
        log('%s metrics [%s]: samples/s %.2f (4b %.2f, 4c %.2f), mean step '
            '%.3f ms (4b %.3f, 4c %.3f; CUDA events; each %s), wall %.3f s '
            'for %d steps, peak memory %d B (4b %d B, 4c %d B), setup %.1f s'
            % (phase, card, td['samples_per_s'], tr['samples_per_s'],
               tc['samples_per_s'], td['step_ms'], tr['step_ms'],
               tc['step_ms'], ['%.3f' % t for t in td['step_ms_each']],
               td['wall_s'], TRAIN_ITERS, td['peak_mem_bytes'],
               tr['peak_mem_bytes'], tc['peak_mem_bytes'], td['setup_s']))
        log_profile(phase, card, td['profile'])
        torch.cuda.empty_cache()
        if route == 'cast':
            cap_ms, eager_ms = bert_twins(torch, bert, gloss, parallel, cuda,
                                          route=route)
            log('%s program: twins at its configuration under deterministic '
                'algorithms: %d steps captured bit for bit the eager '
                'body\'s; mean step %.3f ms captured, %.3f ms eager [%s]'
                % (phase, TRAIN_WARMUP + TRAIN_ITERS, cap_ms, eager_ms,
                   card))
        log('%s capture seconds %s' % (phase, json.dumps(
            {k: round(v, 4) for k, v in td['compile_seconds'].items()})))
        cast_runs[route] = td
        torch.cuda.empty_cache()

    # phase 4e: step_n, build / snapshot / restore, step_accum and the
    # dropout masks of replays
    te = check_train_programs(torch, bert, gloss, parallel, capture_mod,
                              ops, cuda)
    log('phase 4e: step_n(%d) bit for bit %d steps, losses %s; step_accum(2) '
        'against the full-batch step, three times from a snapshot (eager, '
        'captured, replayed): |loss diff| and parameter error / tolerance '
        '%s, num_update 1; %d programs, capture seconds %s; %d replayed '
        'dropout masks equal to the eager draws'
        % (TRAIN_WARMUP + TRAIN_ITERS, TRAIN_WARMUP + TRAIN_ITERS,
           te['step_n'], te['accum'], te['programs'],
           json.dumps({k: round(v, 4) for k, v in
                       te['compile_seconds'].items()}), te['masks']))
    torch.cuda.empty_cache()

    # phase 5: the ResNet slice
    resnet_against_cpu(torch, resnet, gloss, gnn, parallel, kernels, cuda)
    torch.cuda.empty_cache()
    rn = train_resnet(torch, resnet, gloss, gnn, parallel, optimizer,
                      kernels, cuda)
    log('phase 5b slice: resnet%d_v1, batch %d x 3 x %d x %d, %d classes, '
        'SGD %s, %d warm-up + %d timed steps; launches in the timed steps '
        '%s (per step %s); inference forward launches %s'
        % (RESNET['depth'], RESNET['batch'], RESNET['image'],
           RESNET['image'], RESNET['classes'], RESNET_HYPER, RESNET_WARMUP,
           RESNET_ITERS, rn['launches'], rn['per_step'],
           rn['infer_launches']))
    log('phase 5b losses: %s' % rn['losses'])
    log('phase 5b metrics [%s]: img/s %.2f, mean step %.3f ms (CUDA events; '
        'each %s), wall %.3f s for %d steps, peak memory %d B, setup %.1f s'
        % (card, rn['img_per_s'], rn['step_ms'],
           ['%.3f' % t for t in rn['step_ms_each']], rn['wall_s'],
           RESNET_ITERS, rn['peak_mem_bytes'], rn['setup_s']))
    log_profile('phase 5b', card, rn['profile'])
    log('phase 5b capture seconds %s' % json.dumps(
        {k: round(v, 4) for k, v in rn['compile_seconds'].items()}))
    fz = finetune_frozen(torch, resnet, gloss, gnn, parallel, optimizer,
                         kernels, rn.pop('net'), *rn.pop('batch'))
    log('phase 5c frozen-BN fine-tuning: the trained resnet%d_v1 (loss '
        '%.4f with batch statistics after %d recomputing forwards), %d '
        'BatchNorms with use_global_stats, SGD %s, %d steps on the 5b '
        'batch in %.3f s; launches %s (per step %s); losses %s; moving '
        'statistics unchanged'
        % (RESNET['depth'], fz['batch_stat_loss'], FROZEN_CALIBRATE,
           fz['batch_norms'], FROZEN_HYPER, FROZEN_STEPS, fz['wall_s'],
           fz['launches'], fz['per_step'], fz['losses']))
    torch.cuda.empty_cache()

    # phase 5a-amp, 5d, 5e: ResNet in bf16 by the reference's two routes
    for route in ('amp', 'cast'):
        resnet_bf16_against_cpu(torch, resnet, gloss, parallel, cuda, route)
    torch.cuda.empty_cache()
    bf16_runs = {}
    for route, phase in (('amp', 'phase 5d'), ('cast', 'phase 5e')):
        rb = train_resnet(torch, resnet, gloss, gnn, parallel, optimizer,
                          kernels, cuda, route=route)
        first_rel = abs(rb['losses'][0] - rn['losses'][0]) / abs(
            rn['losses'][0])
        log('%s slice: resnet%d_v1 %s, batch %d x 3 x %d x %d, SGD %s, %d '
            'warm-up + %d timed steps; launches in the timed steps %s (per '
            'step %s); inference forward launches %s; parameters %s, SGD '
            'state %s, %d optimizer warnings'
            % (phase, RESNET['depth'], "under amp='bf16'" if route == 'amp'
               else "after cast('bfloat16') on bf16 images",
               RESNET['batch'], RESNET['image'], RESNET['image'],
               RESNET_HYPER, RESNET_WARMUP, RESNET_ITERS, rb['launches'],
               rb['per_step'], rb['infer_launches'], rb['param_dtypes'],
               rb['state_dtypes'], rb['warnings']))
        log('%s losses: %s (falling: %s); first loss %.6f against 5b\'s '
            '%.6f, rel %.4g (limit %g)'
            % (phase, rb['losses'], rb['falls'], rb['losses'][0],
               rn['losses'][0], first_rel, AMP_FIRST_LOSS_RTOL))
        if not first_rel <= AMP_FIRST_LOSS_RTOL:
            raise AssertionError('%s: first loss %.6f is not within %g of '
                                 '5b\'s %.6f' % (phase, rb['losses'][0],
                                                  AMP_FIRST_LOSS_RTOL,
                                                  rn['losses'][0]))
        log('%s metrics [%s]: img/s %.2f (5b %.2f), mean step %.3f ms (5b '
            '%.3f; CUDA events; each %s), wall %.3f s for %d steps, peak '
            'memory %d B (5b %d B), setup %.1f s'
            % (phase, card, rb['img_per_s'], rn['img_per_s'], rb['step_ms'],
               rn['step_ms'], ['%.3f' % t for t in rb['step_ms_each']],
               rb['wall_s'], RESNET_ITERS, rb['peak_mem_bytes'],
               rn['peak_mem_bytes'], rb['setup_s']))
        log_profile('%s (casts: aten::_to_copy and ToCopyBackward)' % phase,
                    card, rb['profile'])
        if route == 'amp':
            fb = finetune_frozen(torch, resnet, gloss, gnn, parallel,
                                 optimizer, kernels, rb.pop('net'),
                                 *rb.pop('batch'), route='amp')
            log('phase 5d frozen-BN fine-tuning under amp=\'bf16\': loss '
                '%.4f with batch statistics after %d recomputing forwards, %d '
                'BatchNorms with use_global_stats, SGD %s, %d steps in %.3f '
                's; launches %s (per step %s); losses %s; moving statistics '
                'unchanged'
                % (fb['batch_stat_loss'], FROZEN_CALIBRATE,
                   fb['batch_norms'], FROZEN_HYPER, FROZEN_STEPS,
                   fb['wall_s'], fb['launches'], fb['per_step'],
                   fb['losses']))
        rb.pop('net', None)
        rb.pop('batch', None)
        log('%s capture seconds %s' % (phase, json.dumps(
            {k: round(v, 4) for k, v in rb['compile_seconds'].items()})))
        bf16_runs[route] = rb
        torch.cuda.empty_cache()

    # phase 5f: 5b's configuration captured against its eager body
    cap_ms, eager_ms = resnet_twins(torch, resnet, gloss, parallel,
                                    optimizer, cuda)
    log('phase 5f: resnet%d_v1 at 5b\'s configuration (full depth), both '
        'runs under deterministic algorithms (cuDNN\'s default ones may sum '
        'in another order from run to run): %d steps captured from the '
        'second on, bit for bit the eager body\'s, losses and every '
        'parameter and moving statistic; mean step %.3f ms captured, %.3f '
        'ms eager [%s]'
        % (RESNET['depth'], TRAIN_WARMUP + TRAIN_ITERS, cap_ms, eager_ms,
           card))
    torch.cuda.empty_cache()

    # phase 6: the SSD detection serving slice
    errs.update(check_nms_kernel(torch, kernels, cuda))
    ssd_against_cpu(torch, ssd, ops, kernels, gnn, cuda)
    det = serve_ssd(torch, serving, ssd, gnn, kernels, contrib, cuda)
    for name, err in check_ssd_bn_apply(torch, kernels,
                                        det.pop('bn_inputs')).items():
        errs[name] = max(errs[name], err)
    log('phase 6b slice: ssd_300(%d) at %d x %d px, %d anchors, buckets %s '
        'warmed in %.1f s; %d requests (%d clients x %d back to back, then %d '
        'one by one) in %d batches, by bucket %s; launches %s (per batch: 1 '
        'nms, %d bn_act_fwd); every response (%d-%d kept rows) equal to its '
        'image run at its bucket'
        % (SSD_CLASSES, SSD_IMAGE, SSD_IMAGE, SSD_ANCHORS, list(SSD_BUCKETS),
           det['setup_s'], det['requests'], SSD_CLIENTS, SSD_PER_CLIENT,
           SSD_SEQUENTIAL, det['batches'], det['by_bucket'], det['launches'],
           SSD_BATCH_NORMS, det['kept_min'], det['kept_max']))
    log('phase 6b metrics [%s]: img/s %.2f (%d requests in %.3f s), latency '
        'p50 %.2f ms p99 %.2f ms; one by one p50 %.2f ms p99 %.2f ms (%.3f s '
        'for %d); peak memory %d B'
        % (card, det['img_per_s'], SSD_CLIENTS * SSD_PER_CLIENT,
           det['wall_s'], det['p50_ms'], det['p99_ms'], det['seq_p50_ms'],
           det['seq_p99_ms'], det['wall_seq_s'], SSD_SEQUENTIAL,
           det['peak_mem_bytes']))
    log_profile('phase 6b (a batch at bucket %d; "other" is softmax, decode, '
                'sorts, gathers and max pools)' % SSD_BUCKETS[-1], card,
                det['profile'])
    nms_times = time_nms(torch, kernels, det.pop('nms_inputs'))
    log_times(nms_times)
    for b, row in ((SSD_BUCKETS[-1], nms_times['nms']),
                   (1, nms_times['nms']['at_batch_1'])):
        log('time nms at B%d [%s]: kernel %.4f ms (device %.4f: mask %.4f, '
            'walk %.4f, finish %.4f), plain %.4f ms, bound %.4f ms (%s), '
            '%.4f ms over the first 512 boxes'
            % (b, card, row['ms'], row['device_ms'], row['mask_device_ms'],
               row['scan_device_ms'], row['finish_device_ms'],
               row['plain_ms'], row['bound_ms'], row['bound_by'],
               row['floor_ms']))
    train_times.update(nms_times)
    torch.cuda.empty_cache()

    # phase 3f (e): 6b's frozen SSD-300 degraded to its CPU fallback
    t0 = time.perf_counter()
    frozen = det.pop('frozen')
    re_ = degraded_oneshot(torch, serving, kernels, frozen,
                           det.pop('images'), cuda)
    e_s = time.perf_counter() - t0
    log('phase 3f (e) [%s]: device_loss@serving:1, a batch of 2 images '
        're-served by run_fallback on the CPU in %.3f s (%s), byte for byte '
        'its host block\'s output; heads rel_err %.3g against the card\'s; '
        'kept rows matched to the card\'s (ids equal, scores and boxes '
        'within %g): the card\'s heads through the host detection %s '
        '(smallest decision slack %.3g of 4x the probability difference '
        '%.3g), the served rows %s (slack %.3g of 4x %.3g); status degraded, '
        'then ok after a clean batch on the card; launches %s; %.1f s in all'
        % (card, re_['cpu_s'], re_['error'], re_['head_err'], DET_TOL,
           re_['kept']['card heads'], re_['slack']['card heads'],
           re_['prob_diff']['card heads'], re_['kept']['served'],
           re_['slack']['served'], re_['prob_diff']['served'],
           {k: v for k, v in re_['launches'].items() if v}, e_s))
    rf['launches'] = {k: v + re_['launches'][k]
                      for k, v in rf['launches'].items()}
    torch.cuda.empty_cache()

    # phase 3h: 3p's program (with 3s's speculation), its self-draft and
    # 6b's SSD-300 saved, then reloaded by a fresh process and served over
    # HTTP; the card's cached blocks freed before each child starts
    root = tempfile.mkdtemp(prefix='chip_smoke_3h_')
    try:
        arts = save_artifacts(torch, serving, frozen, cuda, root)
        del frozen
        torch.cuda.empty_cache()
        reqs = adapter_requests(SLICE)
        hs = serve_http(
            torch, serving, kernels, arts,
            [(r['prompt'], out) for r, out in zip(reqs, rp['outs'])],
            [(r, ra['outs'][i]) for i, r in enumerate(reqs)
             if r['adapter'] is None and r['temperature'] > 0],
            (reqs[LONG_REQUEST], ra['outs'][LONG_REQUEST]),
            det.pop('one_by_one'), rm.pop('refused'))
        torch.cuda.empty_cache()
        hf = serve_http_fault(torch, serving, arts, reqs[0], rp['outs'][0])
        torch.cuda.empty_cache()
        # phase 3g: the serving gateway over a fleet of replicas, a child
        # process on 3h's LM artifact among them
        t0 = time.perf_counter()
        fl = serve_fleet(torch, serving, kernels, arts, rp['outs'],
                         [(r, ra['outs'][i]) for i, r in enumerate(reqs)
                          if r['adapter'] is None and r['temperature'] > 0],
                         card)
        fl['seconds'] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log_http(hs, hf, arts, rp, det, card)
    log_drain(hs['drain'], card)
    log_fleet(fl, card)
    torch.cuda.empty_cache()

    # phase 3l: the load and chaos harness over the port's replicas and
    # gateway, every rig 3p's program
    t0 = time.perf_counter()
    lg = serve_loadgen(torch, kernels, loadgen, cuda)
    lg['seconds_all'] = time.perf_counter() - t0
    log_loadgen(lg, card)
    errs['act_fwd'] = max(errs['act_fwd'], lg['act_fwd_err'])
    torch.cuda.empty_cache()

    # phase 7: the matmul probe slice
    for m, k, n in probe.SHAPES:
        log('geometry M=%d K=%d N=%d: %s' % (m, k, n, {
            v: tuple(kernels.matmul_geometry(v, m, k, n))
            for v in kernels.MATMUL_VARIANTS}))
    errs.update(check_matmul_kernels(torch, kernels, probe, cuda))
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    shapes = probe.run(torch, log=log)['shapes']
    probe_s = time.perf_counter() - t0
    probe_launches = kernels.launch_counts()
    idle = [v for v in kernels.MATMUL_VARIANTS
            if not probe_launches['matmul_' + v]]
    if idle or any(c for name, c in probe_launches.items()
                   if not name.startswith('matmul_')):
        raise AssertionError('phase 7: the probe launched %r' % probe_launches)
    for s in shapes:
        for v in kernels.MATMUL_VARIANTS:
            errs['matmul_' + v] = max(errs['matmul_' + v],
                                      s['rows'][v]['max_abs_err'])
    log('phase 7 slice: the matmul probe at %d shapes in %.1f s [%s]; '
        'launches %s' % (len(shapes), probe_s, card, probe_launches))
    mm_times = matmul_rows(kernels, shapes)
    log_times(mm_times)
    train_times.update(mm_times)
    del shapes
    torch.cuda.empty_cache()

    log('chip_smoke: all phases passed in %.1f s' % (time.perf_counter()
                                                     - started))
    rows = kernel_rows(errs, times, train_times,
                       {'serving': res['launches'],
                        'paged serving': rp['launches'],
                        'prefix sharing': sh['prefix']['launches'],
                        'speculative decoding': sh['spec']['launches'],
                        'sampled adapter serving': ra['launches'],
                        'live migration': rm['launches'],
                        'drain and import over http':
                            hs['drain']['launches'],
                        'degraded serving': rf['launches'],
                        'training': tr['launches'],
                        'bert amp training': tc['launches'],
                        'bert bf16 training': cast_runs['cast']['launches'],
                        'bert bf16 training with masters':
                            cast_runs['cast_mp']['launches'],
                        'resnet training': rn['launches'],
                        'resnet inference': rn['infer_launches'],
                        'resnet frozen-BN fine-tuning': fz['launches'],
                        'resnet amp training': bf16_runs['amp']['launches'],
                        'resnet amp inference':
                            bf16_runs['amp']['infer_launches'],
                        'resnet amp frozen-BN fine-tuning': fb['launches'],
                        'resnet bf16 training':
                            bf16_runs['cast']['launches'],
                        'resnet bf16 inference':
                            bf16_runs['cast']['infer_launches'],
                        'ssd serving': det['launches'],
                        'http serving (fresh process)': hs['launches'],
                        'http degraded serving (fresh process)':
                            hf['launches'],
                        'serving gateway fleet': {
                            k: v + fl['a']['child_launches'][k]
                            for k, v in fl['launches'].items()},
                        'loadgen modes': lg['launches'],
                        'matmul probe': probe_launches})
    log(json.dumps({'kernels': rows}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
