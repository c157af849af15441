#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on a failed check:

1. Build: the CUDA kernels compile from ``src/repro_torch/kernels/csrc``
   into ``build/`` (one nvcc per source, all started together).
2. Kernels: at every DarkNet-19 conv geometry at 416x416, batch 8, the
   trunk-conv kernel, which reads the NHWC input itself, is held against
   its plain PyTorch version (``trunk_patch_dot_plain`` on the patch
   matrix P) on the same card inputs: the unscaled trunk with
   ``torch.equal``; the fused ReBranch conv within 1e-5 of its absmax
   against the plain trunk plus the JAX package's branch formula on P
   (the kernel route compresses x once per pixel and sums in another
   order).  The fused conv and the trunk conv run with ``patch_matrix``
   made to raise and ``im2col`` refusing the C_in-channel input: no patch
   matrix on the card.  Times come from CUDA events over warmed launches;
   each site prints its bound both ways, from the NHWC input's bytes and
   from P's (what the kernel read before it gathered from NHWC), and the
   branch's time.
3. Serving, the main path: a registry entry ``darknet19-416`` (all-ROM
   plan from ``plan.solve``, engine ``pallas_fused``), seeded parameters
   with non-zero ReBranch cores, ``CNNServer`` with 8 slots, three
   requests of 8, 8 and 5 images.  The launch count must rise by exactly
   20 per served chunk (one per conv site), the outputs must be finite,
   and the 5-image request's rows must equal, bit for bit, the same images
   served in a full chunk.  Then a sustained window: two runs of one
   request of 32 full chunks each (256 images), images/s as all images
   over the whole request, with the spread across the runs.
4. CPU reference: one image through the served model on the card, every
   conv layer's call recorded; each layer is run again on the CPU (the
   plain versions) on the same input and held within 1e-5 of its output's
   absmax (the trunk is bit-exact given the same input; the float branch
   GEMMs and convs sum in another order on the two devices); in an ADC
   mode each site's unscaled trunk from the NHWC kernel is bitwise equal
   to the CPU's plain version.  The whole
   forward is compared with the CPU too, but only printed: the quantised
   network is chaotic at the ulp level (an ulp moved before a later
   layer's per-row quantiser moves an int8 code), so the script also
   prints how far the card's own output moves under a 1e-7 relative
   input perturbation.
5. LM kernels: at Gemma-2B's four (K, N) linear geometries, at M = 1, 8,
   16, 32 and 128 rows, the fused ReBranch matmul kernel's unscaled trunk
   is ``torch.equal`` to its plain version and its sketch t1 within 1e-5
   of its absmax; the CiM matmul kernel is ``torch.equal`` to its plain
   version; row 0 of the M = 1 launch equals row 0 of the M = 8, 16, 32
   and 128 launches, bit for bit (other tile heights and splits; M = 32
   is a verify round of 8 rows x k = 4 and a prefill chunk).  Each line
   prints the plans the wrappers handed the kernels, read back from the
   launch structs: the trunk's tile height and split (the tuning table's
   or ``tiling.split_k``'s) and, for kernel 3, the sketch's
   (``tiling.split_sketch``'s).  ``ms`` is the time per launch of launches
   from Python that cycle through weight copies larger than the L2 cache
   (a decode step reads each layer's weights once), host cost included,
   from CUDA events: what a serving step pays, and the measure of earlier
   versions of this script.  ``device_ms`` is the same launches captured
   in one CUDA graph and replayed: the device's share.  Beside them the
   bound, the plain version's time and, for the CiM matmul at M = 128,
   ``torch._int_mm`` timed both ways (a time yardstick: it sums all of K
   in int32, so it is no bit oracle), per geometry and per 126-launch
   pass; and what one call of each wrapper costs the host at 2048 x 2048
   and 8 rows, with the pieces of that cost.
6. LM serving, the slice's main path: a registry entry ``gemma-2b`` (the
   full Gemma-2B config, all-ROM plan, engine ``pallas_fused``), seeded
   parameters drawn on the card with non-zero ReBranch cores,
   ``serve.load(..., n_slots=8, max_len=256)`` (the default paged pool,
   prompts admitted in 32-token chunks, the default ``prefill_chunk``).
   Five requests of mixed prompt lengths, 32 new tokens each: the fused
   kernel launches 126 times per prefill chunk and per decode step, tokens
   lie in the vocabulary; two requests are run solo on the card too (a
   whole-prompt prefill) and
   must give the same tokens and the same first-decode-step logits, bit
   for bit (the batch-variant GEMMs and reductions run on 16-row slices,
   ``repro_torch/core/rows.py``); so must three requests of a 24-row
   pool, whose slots lie in both slices.  Then a sustained window: two runs of 16
   requests x 32 new tokens, tokens/s with the spread, and one decode step
   split into the kernel, its epilogue, the readout and the rest
   (attention, norms, embedding).
7. The ``pallas`` engine: the same parameters through ``gemma-2b-pallas``
   (the CiM matmul kernel behind every ROM linear), four requests x 16
   tokens; 126 launches per prefill chunk and per decode step; the decode
   step
   time; then kernel 4's 126 calls of one decode step with 8 requests,
   recorded and run again in the served order (the served measure of
   kernel 4, as phase 6's ``fused kernel`` is of kernel 3).
8. CPU replay: the seven linears and the attention of layer 0 in one
   decode step of phase 6 are recorded on the card and run again on the
   CPU plain versions with the same inputs.  The unscaled trunk is
   ``torch.equal``; each bf16 output is within one bf16 ulp at its absmax
   (2**(e-7) for an absmax in [2**e, 2**(e+1)), i.e. 2**-8 to 2**-7 of the
   absmax): the float epilogue sums in another order on the two devices
   and may move one rounding of the cast to bf16.

9. ADC kernels: at every DarkNet-19 geometry (416x416, batch 8) the NHWC
   trunk kernel in ``per_subarray`` mode is ``torch.equal`` to its plain
   version; in ``bitserial`` mode it runs on all of x and its first 4096
   rows are held bitwise against the plain version on those rows of P
   (rows are independent, so this is exact, and shows it); both bounds
   as in phase 2.  At Gemma-2B's four
   geometries at M = 8, kernel 3's trunk and kernel 4's output (int8
   inputs with -128) are ``torch.equal`` to their plain versions in both
   modes, and the rows of an M = 1 launch equal those of the M = 8 launch;
   in ``bitserial`` also at M = 1, 16 and 128, each under the split plan
   it prints (``tiling.split_plan``), with row 0 equal to M = 1's.
   ``ops.cim_conv`` (im2col + kernel 4, default config ``per_subarray``)
   at one DarkNet-19 geometry equals ``cim_matmul_plain`` on the patch
   matrix.  Times from CUDA events, warmed (kernel 1 the mean of 3
   launches, kernels 3 and 4 as phase 5's ``ms`` and ``device_ms``),
   beside the bound and the plain version's time (the plain bitserial
   kernel 1: one timed call).
10. DarkNet-19 served at ADC fidelity: ``darknet19-416-adc`` (phase 3's
   plan with ``per_subarray`` at every site, ``pallas_fused``, phase 3's
   parameters) through ``CNNServer``: requests of 8, 8 and 5 images, 20
   trunk launches per chunk, pad rows bitwise invisible, a sustained
   window of 3 runs x 16 chunks; then ``darknet19-416-bitserial``, one
   request of 8 images.  For both, the device forward of one chunk
   beside the ideal model's, and ``examples/yolo_cim_conv.py``'s measure
   (mean |head - ideal head| over the ideal head's std) on the same
   images and parameters; then phase 4's CPU replay for
   ``per_subarray``, with every ADC trunk bitwise equal.
11. Gemma-2B at ADC fidelity: ``gemma-2b-adc`` is Gemma-2B at full width
   with its depth cut to 2 layers (every linear geometry of the model,
   14 launches per pass; the cut keeps the phase short), ``per_subarray``
   at every ROM site, ``pallas_fused``: 4 requests x 16 tokens, 14
   kernel-3 launches per prefill and per decode step, one request bitwise
   equal to its solo run; the same under ``pallas`` (kernel 4); then
   ``bitserial`` under both engines, 4 requests x 6 tokens, one request
   bitwise equal to its solo run.
12. Tape-out: dense DarkNet-19 weights at 416, drawn from a seed, go
   through ``models.cnn.freeze_to_rom`` once on the card and once on the
   CPU; every ``w_q`` and ``w_scale`` is ``torch.equal`` between the two,
   and ``core.rom.rom_fingerprint`` of the card tree equals its CPU
   copy's and the CPU tape-out's.  Prints ``rom_bytes``/``sram_bytes``
   and the 28 nm cost model's ratios (``core.energy``) for the four
   paper models from the port's own counts (``repro_torch.netstats``):
   model outputs, not measurements.
13. CNN hot-swap at full width, on phase 3's ``darknet19-416`` cell and
   parameters: scenarios A, B and C (cores, BN and head drawn from seeds)
   written with ``checkpoint.manager.save_branch`` under ``build/``,
   registered from ``ckpt_dir=`` in a ``ScenarioStore`` of capacity 2,
   swapped A, B, C, A through ``CNNServer.swap_scenario`` (the last swap
   reloads the evicted A from its checkpoint), one 8-image chunk served
   after each: 20 kernel-1 launches per chunk, the chunk ``np.array_equal``
   to a freshly built ``CNNServer`` on ``combine(branch, trunk)``, every
   trunk tensor the same object at the same ``data_ptr``.  Prints each
   swap's host-clock time and ``torch.cuda.memory_allocated`` around it,
   then two swaps served from the store's cache.
14. LM hot-swap mid-stream at full width: Gemma-2B (``gemma-2b``, phase
   6's server: ``pallas_fused``, 8 paged slots) with scenarios A and B in
   the id's ``registry.scenario_store``, loaded with
   ``serve.load(..., scenario="A")``: 4 requests under A,
   ``swap_scenario("B")``, 4 requests under B, drained together.  Kernel
   3 launches 126 times per prefill and per decode step, ``swap_count``
   is 1, B's requests are admitted only after A's retired, the trunk
   tensors stay the same objects, and every request's tokens equal its
   solo decode under its own scenario, bit for bit.
15. Training kernels at the train geometries: kernel 4 at Gemma-2B's four
   linear geometries at M = B*S = 512 through ``ops.trunk_matmul_pallas``
   under autograd: the forward ``torch.equal`` to the plain version, one
   launch and none in the straight-through backward, dx ``torch.equal``
   to ``g @ (w_q*s).T`` on the card; ``ms``, ``device_ms``, the bound and
   ``torch._int_mm`` as in phase 5.  Kernel 1 at ResNet-18's 20 conv
   geometries (32x32, batch 128) ``torch.equal`` to its plain version,
   with its time and bound.
16. Gemma-2B branch training at full width (``configs/gemma_2b.py::FULL``
   with its depth cut to 3 layers, which keeps the whole run inside its
   time limit: the ROM fingerprints dominate this phase; all-ROM,
   ``pallas``: kernel 4 behind all 21 linears), drawn on the
   card: ``launch/train.py``'s loop (``make_train_step``, cosine schedule
   with a warm-up of 5, ``markov_batch`` at the CLI's batch 8 x seq 64,
   lr 3e-3) for 30 steps.  Every loss finite and the last below the
   first; 7 kernel-4 launches per layer a step, none in the backward; the
   ROM fingerprint unchanged and every trunk tensor the same object at the
   same ``data_ptr``; a checkpoint saved at step 15 (async) restored into
   fresh templates, whose step 16 equals the uninterrupted one (bitwise,
   at worst 1e-6 relative).  Prints the step time (CUDA events and the
   host clock), trained tokens/s, the step split by part, the step with
   the row slices on and off, the peak memory and the checkpoint's times.
   Then one step at the 2-layer cut of full width, batch 4 x seq 32, on
   the card and on the CPU from the same parameters: the loss within 1e-3
   relative and every leaf of AdamW's ``m`` within 5e-2 of its absmax;
   and ``launch/train.py``'s CLI (``--smoke``, its default engine) on the
   card with checkpoints and ``--resume``.
17. The paper's ResNet-18 ReBranch fine-tune (32x32, 100 classes): a
   dense init, ``models.cnn.freeze_to_rom``, ``pallas`` (kernel 1 behind
   every ROM conv), ``transfer_harness._train``'s loop with the port's
   modules (AdamW without decay, lr 2e-3, CE of ``log_softmax``) on
   ``image_batch`` at batch 128 for 50 steps: the loss falls, 20 kernel-1
   launches a step, the ROM untouched, the first step's loss within 5e-2
   of the CPU's, and each conv's STE dx on the card within 1e-5 of its
   absmax of the CPU's for the same g.  Prints trained images/s.
18. Chunked prefill at full width: phase 6's cell and parameters with
   ``prefill_chunk=32``, six requests with prompts of 40-200 tokens x 32
   new tokens.  126 kernel-3 launches per chunk and per decode step; every
   request's row as adopted (after its last chunk) ``torch.equal`` to a
   whole-prompt solo prefill's cache (k, v, length); tokens and the first
   decode step's logits equal to the solo decode, bit for bit; every
   request in flight gains a token on every tick in which a chunk runs.
   Prints the time to first token of the 200-token prompt and the decode
   step (and the whole tick) on chunk ticks against plain ticks.
19. Speculative decode at full width: the same cell at ``spec_k=4``, 8
   requests x 16 new tokens, under the branch drafter (the SRAM branch
   with every ROM trunk skipped) and under two oracle ``draft_source``s
   that propose the plain greedy continuation with probability 0.6 and
   0.95 per position, with spec off beside.  Every request's tokens equal
   its plain greedy solo decode, bit for bit; each verify round and each
   prefill chunk launches kernel 3 126 times and nothing else, each draft
   prefill and draft step launches no kernel at all; no block is granted
   or reserved after a run.  Tokens/s over one timed run,
   acceptance rate, verify rounds against plain decode steps, a round
   split into its draft steps and its verify, and what the draft step
   reads (C and U in f32).  Then one mid-stream ``swap_scenario`` under
   spec (the branch drafter; scenarios A and B of phase 14): every
   request equals its solo decode under its own scenario.

20. New kernel geometries: kernels 3 and 4 at every distinct ROM-linear
   (K, N) of the FULL ``hymba_1_5b``, ``granite_moe_3b``,
   ``falcon_mamba_7b`` and ``qwen2_moe_a2_7b`` configs (Cd = K // 4; K =
   100, N = 132, Cd = 25, N = 32001 and 151936 among them; 20 in all), at
   M = 1, 8, 16, 100 and 128 (and 32 for the MoE configs, which chunk
   their prefill) in ``ideal``, ``per_subarray`` and ``bitserial``: the
   decode rows take the 16-row tiles, a whole prompt's prefill (up to 128
   rows in phases 21 and 23) the taller ones.  x is f32 as the configs
   serve it, and bf16 too at M <= 16 (the kernel reads bf16 there).  The
   unscaled trunk and kernel 4's output ``torch.equal`` to their plain
   versions, t1 within 1e-5 of its absmax, row 0 of M = 1 equal to row 0
   of every larger M.  The plain versions run once per mode at the
   tallest M and each M is held to their first M rows (a plain row sums
   exact integers over its own row; checked at M = 8).  ``ms``, ``device_ms``, the plain version's time
   and the bound per geometry at M = 8.
21. Hymba-1.5B at full width, its depth cut to 8 of 32 layers (the
   script's time limit; layer 0 keeps global attention, the rest a
   sliding window): ``hymba-1.5b`` (all-ROM, ``pallas_fused``), seeded
   parameters drawn on the card with non-zero cores, ``serve.load(...,
   n_slots=8, max_len=256)`` (the dense ``SlotPool``: SWA rings and SSM
   state do not page; whole-prompt prefill).  Five requests x 32 tokens:
   kernel 3 launches 89 times (11 ROM linears x 8 layers + the readout)
   per prefill and per decode
   step, tokens lie in the vocabulary, two requests equal their solo runs
   (tokens and first decode step logits, bit for bit).  A sustained window
   of two runs x 16 requests x 32 tokens; one decode step split into
   kernel 3, its epilogue, the SSM recurrence, the attention and the rest;
   layer 0's 11 linears, SSM decode step and attention replayed on the
   CPU (trunks ``torch.equal``, outputs within one bf16 ulp of their
   absmax).  Then ``hymba-1.5b-pallas``: two requests x 8 tokens, 177
   kernel-4 launches per prefill and per decode step.
22. Granite-MoE-3B at full width, its depth cut to 8 of 32 layers (the
   script's time limit; 16 until phase 32 came): paged pool, 32-token
   chunks, 8 rows: five requests x 32 tokens, kernel 3 launches 32 times
   (4 attention linears x 8 layers; the stacked experts are plain
   PyTorch and the
   readout is the tied table) per chunk and per decode step; the dropped
   (token, expert) choices per tick; layer 0's MoE block at one decode
   step replayed on the CPU with the same input (the assignments equal
   except at near-ties of the k-th and (k+1)-th router probabilities, 1e-5,
   whose count is printed; the output within one bf16 ulp of its absmax);
   one decode step split as phase 21's, with the MoE blocks as a part;
   a sustained window of two runs x 16 requests x 32 tokens, as phase
   21's.  Batched == solo is not a gate: the rows of a step compete for
   expert capacity in the reference's dispatch.
23. Falcon-Mamba-7B at full width: 4 dense slots, 4 requests x 16 tokens,
   257 kernel-3 launches per prefill and per decode step, one request
   equal to its solo run bit for bit; the peak memory and the decode step
   split as phase 21's.
24. The vlm and audio geometries: phase 20's checks at the six new ROM
   linear (K, N) of the FULL ``qwen2_vl_2b`` (1536 -> 1536, 256, 8960;
   8960 -> 1536) and ``musicgen_large`` (2048 -> 8192; 8192 -> 2048)
   configs (Gemma-2B's, phase 5, left out), at M = 1, 8, 16, 32 and 128.
25. Qwen2-VL-2B at full width, its depth cut to 7 of 28 layers (the
   script's time limit, as phases 21-22): ``qwen2-vl-2b``
   (all-ROM, ``pallas_fused``; M-RoPE, q/k/v biases, the tied 151936-row
   readout a plain bf16 GEMM), seeded parameters with non-zero cores,
   ``serve.load(..., n_slots=8, max_len=256)`` (paged, 32-token chunks).
   Five requests x 32 tokens: 49 kernel-3 launches (7 x 7 layers) per
   chunk and per decode step; three requests equal their whole-prompt solo
   runs (two of them admitted in chunks), tokens and first decode step
   logits bit for bit; a sustained window of two runs x 16 requests x
   32 tokens; one decode step split as phase 21's; layer 0's 7 linears and
   attention replayed on the CPU (trunks ``torch.equal``, outputs within
   one bf16 ulp).  ``spec_k=4`` (the branch drafter): four requests equal
   plain greedy solo decode, 98 launches per chunk and per verify round,
   none in a draft.  A model-level prefill of frontend embeddings [1, 24,
   1536] with a 2x3x4 grid's three position streams: 98 launches, other
   logits than text positions, and at a 2-layer cut card vs CPU within
   5e-2 of the absmax.  Then ``qwen2-vl-2b-pallas``: two requests, 98
   kernel-4 launches per chunk and per decode step, and kernel 4's calls of
   one decode step rerun in the served order.
26. MusicGen-large at full width (4 codebooks): ``launch/steps.py``'s
   ``make_prefill_step`` / ``make_serve_step`` under ``pallas_fused`` (the
   reference's ``LMServer`` cannot serve [B, 1, Q] tokens; the port's
   refuses the config): 8 rows of 32-token prompts, 32 greedy steps, 289
   kernel-3 launches (6 x 48 layers + the codebook head) per prefill and
   per step; rows 0 and 5 equal their solo runs (prefill and first step
   logits, all tokens) bit for bit; the 289 kernel-3 calls of a batched
   prefill (M = 256; the head at M = 8) held to the plain version (trunk
   ``torch.equal``, sketch within 1e-5 of its absmax); layer 0's 6
   linears, its attention and the codebook head replayed on the CPU; the
   step time and tokens/s, and kernel 3's calls of one step rerun in the
   served order.
27. Training over the new families: Granite-MoE-3B, Hymba-1.5B,
   Falcon-Mamba-7B, Qwen2-VL-2B and MusicGen-large at full width, depth
   cut to 2 layers, 10 steps each under ``pallas`` at the CLI's batch 8 x
   seq 64: the loss finite and falling; kernel 4 once per ROM linear of
   the blocks a step, plus the readout head once per loss chunk in the
   forward and again in its recompute (a forward alone shows it: none in
   the STE backward); every kernel-4 call of step 0 (M = 512 in the
   blocks) ``torch.equal`` to the plain version; step 1's kernel-4 calls
   rerun in order (``ms``, ``device_ms``, the plain version, the bound
   and ``torch._int_mm``, as phases 21-26 time a served step); the ROM
   fingerprint and trunk ``data_ptr``s unchanged.  Granite's stacked expert trunk (plain, not kernel 4) under
   autograd on the card against the CPU: the forward ``torch.equal``, the
   STE dx within 1e-5.  Hymba's trained branch saved with
   ``save_branch``, registered from the checkpoint and hot-swapped
   mid-stream into an ``LMServer``: the tokens after the swap equal a
   fresh cell's, those before it the untrained cell's, the trunk unmoved.
28. Launch-plan tuning: ``tune.autotune.check_table`` passes on the
   checked-in ``repro_torch/tune/hopper_table.json`` (generated on an H100
   by ``python -m repro_torch.tune``); the autotuner runs over Tiny-YOLO's
   conv sites at 32x32, batches 1 and 8, in all three modes for all three
   kernels: every legal plan (tile heights x splits, the sketch's too) is
   run, read back from the launch struct, held ``torch.equal`` to the
   shape rule's plan's output (0 dropped, or the phase fails) and timed
   (replayed CUDA graph, best of 2); per geometry the candidates, the
   rule's and the best time.  Then DarkNet-19/416 at batch 8 and at batch
   1 (where the table moves plans) with the table on (phase 3's cell)
   against ``compile_model(..., tune=False)`` on the same parameters:
   ``torch.equal``, 20 launches a forward, the forward and kernel 1's 20
   launches timed both ways (eager; the launches also as a replayed CUDA
   graph).
29. Tiny-YOLO at 416x416 (``tiny-yolo-416``) and VGG-8 at 32x32
   (``vgg8-32-tuned``), registered with ``tune=True`` (``pallas_fused``),
   seeded parameters with non-zero cores, served through ``CNNServer``
   with 8 slots: a full chunk, then two of its images alone, whose rows
   equal the chunk's bit for bit; one trunk launch per site per chunk;
   every conv layer of one image replayed on the CPU within 1e-5 of its
   absmax (phase 4's replay); images/s over three runs of 64 images.
30. DarkNet-19 served H-sharded (``repro_torch/kernels/halo_conv.py``, the
   ``pallas_sharded`` engine): four ranks spawned in one gloo world on the
   one card (NCCL refuses two ranks on one device), each building meshes
   4x1 and 2x2 (the ``data`` axis, which ``cnn_h`` shards H over, of size
   4 and 2) with ``launch.mesh.make_mesh``.  Every rank draws
   ``darknet19`` at 416x416 (``fuse_bn_act``, live cores) from one seed;
   the ROM fingerprints, all-gathered, must be equal.  Each rank records
   the unsharded ``pallas`` model's 21 conv layers on batch 8.  Per mesh:
   ``compile_model(..., engine="pallas_sharded", mesh=)``'s forward with
   the counts at 0, then ``CNNServer`` requests of 8 and 5 images: one
   kernel-1 launch per site at which the rank holds rows (20 at 416), no
   layer gathered (0 fallbacks), the 8-image request equal to the forward
   and both requests equal on every rank (SHA-256 of the arrays,
   all-gathered); kernel 1 at every slab geometry of the sharded forward
   (VALID) ``torch.equal`` to its plain version; at every site the
   sharded trunk on the rank's slab of the unsharded layer's input
   ``torch.equal`` to the same rows of the unsharded trunk (``ideal`` on
   the batch, ``per_subarray`` and ``bitserial`` on image 0), each layer
   within 1e-5 of its absmax.  Prints the whole forward against the
   unsharded one beside the unsharded model's move under a 1e-7 input
   perturbation (not gated), the bytes the halo exchange, the pool
   re-layouts and the head gather sent beside ``halo_bytes``' sum and an
   all-gather of the same conv inputs, and each rank's forward host time
   (four ranks time-share one card: no scaling figure).
31. Branch training over a mesh (``launch/steps.py::BranchStep``, the
   sharded trunk's STE backward and ``move_rows``' adjoint), 4 gloo
   ranks on the one card.  (a) DarkNet-19 at 416x416, batch 8,
   ``pallas_sharded`` on (pod 2, data 2, model 1): the images ride
   ``pod``, H rides ``data``; three branch steps of a seeded regression
   loss on the 13x13x125 head, each with the counts at 0: one kernel-1
   launch per ROM conv per rank (none in the backward), 0 gathered, the
   reduced gradients bitwise equal on every rank (SHA-256, all-gathered)
   and, on rank 0, within 1e-5 of each leaf's absmax of the unsharded
   'pallas' step on the whole batch; kernel 1 at every training slab
   geometry ``torch.equal`` to its plain version; each ROM site's sharded
   STE dx (two images, one a pod block) within 1e-5 of the unsharded dx;
   the ROM fingerprint unmoved.  (c) That state saved from the 2x2 mesh
   (rank 0 writes) and restored onto 4x1 with ``shardings=``, bitwise.
   (b) Gemma-2B at full width cut to 3 layers, 8 x 64 tokens over (4,
   1), 2 rows a rank.  With f32 activations, one step plain and one
   through the int8 error-feedback all-reduce: kernel-4 launches per rank
   a step as the single-rank step's, every call at M = 128
   ``torch.equal`` to its plain version, the gradients within 1e-5 of
   rank 0's whole-batch step and the int8 mean within 0.05 of the plain
   one.  Then with the configuration's bf16 activations, one plain step:
   on rank 0 a witness with no mesh (the ranks' 2-row blocks run in turn
   in one process and averaged) gives bf16's own gap to the whole-batch
   step; the mesh's gradients within 1e-5 of the witness and within
   twice that gap of the whole-batch step.  Wire bytes a step, per-rank
   step and all-reduce host ms, and kernel 1's and kernel 4's launches of
   one step timed on rank 0 with the other ranks idle.

32. Dense LMs served tensor-parallel over 4 gloo ranks spawned on the
   card (``compile_model(cfg, mesh=)``, ``shard_params``,
   ``make_prefill_step``, ``make_serve_step``).  (a) Kernels 3 and 4 at
   every per-rank geometry of the phase (column sites' N columns,
   row-parallel sites' whole k-blocks, 17 geometries) ``torch.equal`` to
   their plain versions in all three modes at decode M (f32 and bf16 x)
   and prefill M.  (b) Full-width Gemma-2B (9 of 18 layers, bf16) on
   (data 1, model 4), (2, 2) and (pod 2, data 2, model 1: a batch over
   pod x data) under ``pallas_fused``, and under ``pallas`` on (1, 4);
   Yi-34B at its published widths cut to 2 layers on (1, 4): 8 prompts
   of 64, ``max_len`` 256, a prefill and 16 serve steps (4 for
   ``pallas``, Yi and pod x data), each fed the unsharded steps' token.  The
   unsharded steps run first in this process; each rank then builds the
   whole tree in turn, keeps its blocks and layer 0's whole ROM leaves.
   Held: one launch per linear whose block a rank holds, per step and
   prefill; every rank's logits and tokens bitwise equal; layer 0's
   row-parallel reduced trunks bitwise the rank-order sums of the plain
   version over ``k_layout``'s ranges and its column trunks bitwise the
   unsharded columns; a row decoded at batch 8 bitwise the same row at
   batch 1 (2 on two data ranks, 4 over pod x data); on (2, 2, 1) each
   rank's rows of two decode steps from the unsharded prefill's cache
   bitwise the unsharded 8-row steps' logits, the tokens gathered over
   pod x data bitwise their argmax, and every rank's bytes a decode step
   equal to the dry run's on a fake (2, 2, 1) world; every kernel call of
   a served step ``torch.equal`` to its plain version.  Full Gemma-2B
   with random weights is chaotic at the ulp level, so the whole model is
   held to a one-process witness, the unsharded steps with every trunk
   nudged by ~1 f32 ulp (``nudged_kernels``): logits within max(5e-2, 2
   x the witness's distance) of the absmax, and tokens in >= 99% of the
   (row, step) pairs whose top two unsharded logits lie over twice the
   measured logit distance apart, the overall agreement printed beside
   the witness's.  Printed: bytes sent per rank by kind, per-rank
   prefill and step host ms, rank 0's kernel calls of a step timed with
   the other ranks idle, the peak device memory per rank.
34. Dense layouts of uneven heads over 3 gloo ranks on the one card
   (56, 40 and 8 heads all divide 4).  (a) Kernels 3 and 4 at every
   per-rank geometry of (b) that 32(a) did not hold (q's whole heads, o's
   k-blocks, the sites the size rule keeps whole, Qwen's vocab-parallel
   readout), held as 32(a) holds them.  (b) On (data 1, model 3), under
   ``pallas_fused``: Gemma-2B at phase 32's 9 layers (heads 3, 3, 2; its
   one kv head read by every rank; 256 % 3: a whole cache on every rank),
   and under ``pallas`` too; Yi-34B and Qwen1.5-32B (qkv bias) at 2
   layers (heads 19, 19, 18 and 14, 14, 12; Yi's GQA groups of 7 split
   between ranks), each held as phase 32 holds its runs, to the same
   unsharded steps (Qwen's run here first); every rank's bytes a decode
   step equal to the dry run's on a fake (1, 3) world.
33. The step cost counter (``launch/cost.py``) and the dry run
   (``launch/dryrun.py``), run after phase 8 on the models phases 3 and 6
   built.  DarkNet-19/416's forward at batch 8 (``pallas_fused``) and a
   Gemma-2B decode step at 8 rows under ``pallas_fused`` and ``pallas``,
   each under ``cost.count()`` on the card: 20 kernel-1, 126 kernel-3 or
   126 kernel-4 launches; trunk FLOPs exactly 2 x rows x the ROM sites'
   MACs (``plan.site_tree``); FLOPs and HBM bytes equal, op by op, to the
   same step on ``meta`` (``bridge.abstract`` of the same arguments); the
   meta record's peak within 10% of ``max_memory_allocated`` over the
   step (beyond the memory held before it that is not the step's); the
   kernel's bound from the counted work equal to ``PERF.md``'s (kernel 1
   0.267, kernel 3 2.180, kernel 4 0.600 ms).  Gemma-2B at 18 layers on a
   fake (data 1, model 4) world on ``meta``: every rank sends phase 32's
   bytes of a decode step exactly.  ``python -m repro_torch.launch.dryrun
   --shape fig12 --fast`` and ``--arch deepseek_67b --shape decode_32k
   --single-pod --fast`` in subprocesses (started first, run beside the
   rest), each exiting 0, their records printed.  Printed: each step's
   FLOPs, bytes, CUDA-event time and the rates they imply.
37. The moe family trained over a mesh (``models/moe.py``'s adjoints,
   ``launch/steps.py::make_train_step(global_batch=)``): Granite-MoE-3B
   at full width cut to 3 of 32 layers, f32, remat on, ``pallas``, over
   4 gloo ranks on the one card on (data 1, model 4) and (2, 2), whole
   experts a rank, 3 steps each on 8 x 96 tokens (3 routing groups of
   256; over data 2 group 1 spans both data ranks).  (a) Kernel 4 at the
   attention's per-rank geometries at the train step's M, held as 32(a)
   holds them.  (b) Held: layer 0's moe block alone (8 x 32 tokens, one
   routing group across the data ranks) within 1e-5 of its absmax from
   one process running its expert linears on slices of a rank's experts
   (the rank's GEMM shapes); the step being chaotic at full width, every
   gradient block within 2 x the distance of a one-process witness whose
   trunks are nudged by ~1 f32 ulp and the first loss within 1e-3 of one
   process's; the same step with the block's partial leaves left
   unmarked (a wrong adjoint) outside the gradient bar, and with the
   ranks' expert partials unsummed (a wrong forward) outside the loss
   bar, on every rank; the losses and
   every leaf held whole (gradient and update) bitwise equal on every
   rank; the loss falling; the ROM's tensors unmoved and its
   fingerprint; one kernel-4 launch per attention linear a rank holds in
   the forward and one in the recompute, none in the backward; every
   call ``torch.equal`` to its plain version; each rank's bytes a step,
   kind by kind, equal to the dry run's on a fake world of the mesh.

Each phase that drives a serving path sets every kernel's launch count to
0 just before it and reads the counts just after.  It needs one card,
exits non-zero without one, and prints as its last line
``{"ok": true, "device": {...}}``; the line before it is the kernel table
as JSON, one row per (kernel, mode) (``trunk_conv[bitserial]`` ...):
kernel 1 per DarkNet-19 forward (``bound_ms`` from the NHWC input's bytes,
``bound_p_ms`` from P's), kernels 3 and 4 per full-depth Gemma-2B
decode step at 8 rows (``ms`` from Python, host included; ``device_ms``,
where measured, from a replayed CUDA graph), ``launches`` from the
serving phases; ``cim_matmul`` also carries ``ms_m128`` and
``library_ms`` (``torch._int_mm``), both per 126-launch pass at M = 128
and timed as ``ms`` is; ``trunk_conv`` and ``rebranch_matmul`` carry
``swap_launches``, their launches in phases 13 and 14; ``trunk_conv`` and
``cim_matmul`` carry ``train_launches`` (phases 16-17) and ``train_*ms``,
per pass at the train geometry (phase 15); ``rebranch_matmul`` carries
``chunk_launches`` and ``spec_launches``, its launches in phases 18 and
19, and ``verify_ms``, ``verify_device_ms``, ``verify_plain_ms`` and
``verify_bound_ms``, per 126-launch verify round at M = 32 (phase 5);
``rebranch_matmul`` and ``cim_matmul`` carry ``family_launches``, their
launches in phases 21-23, and ``family_step``, per served model the
kernel's calls of one decode step (8 rows; Falcon-Mamba 4) recorded as
the server made them and run again in that order (``ms``, ``device_ms``,
``plain_ms``, ``bound_ms``), with phases 25-26's models among them;
``cim_matmul`` carries ``family_train_launches``, its launches over
phase 27's steps per model and per step; ``trunk_conv`` carries
``sharded_launches``, per mesh of phase 30 each rank's launches over its
sharded forward and two requests; ``trunk_conv`` and ``cim_matmul`` carry
``dist_train_launches``, each rank's launches in phase 31, and
``dist_train``, rank 0's launches of one step timed with the other
ranks idle (``ms``, ``plain_ms``, ``bound_ms``; kernel 4 also
``library_ms``); ``rebranch_matmul`` and ``cim_matmul`` carry
``tp_serve``, per phase-32 and phase-34 run each rank's launches and
bytes sent per step and rank 0's calls of one decode step timed with
the other ranks idle (``ms``, ``device_ms``, ``plain_ms``,
``bound_ms``; kernel 4 also ``library_ms``); ``cim_matmul`` carries
``tp_train``, per phase-35 and phase-37 run each rank's launches per step
and rank 0's calls of one step timed with the other ranks idle.  Phases
18-27 run after the training phases, 28-32 and 34-37 last; phase 33 runs
after phase 8.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense: int8 tensor-core rate, HBM3 rate,
# float32 rate outside the tensor cores
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
PEAK_F32_OPS = 67e12

SIZE, BATCH, SLOTS = 416, 8, 8
REQUESTS = (8, 8, 5)
SUSTAINED_CHUNKS, SUSTAINED_RUNS = 32, 2   # 2 runs: the script's time limit
FUSED_RTOL = 1e-5        # phase 2, of the fused output's absmax
LAYER_RTOL = 1e-5        # phase 4, of each layer output's absmax

# Gemma-2B linears per layer as (K, N): q and o, k and v, gate and up, down
LM_GEOMS = {(2048, 2048): 2, (2048, 256): 2, (2048, 16384): 2,
            (16384, 2048): 1}
LM_ROWS = (1, 8, 16, 32, 128)   # 32: a verify round (8 rows x k = 4), a chunk
LM_VERIFY_ROWS = 32
LM_LAYERS = 18
SKETCH_RTOL = 1e-5       # phase 5, of t1's absmax
L2_BYTES = 50 << 20      # H100 L2; timed weights cycle through 2.5x this
LM_SLOTS, LM_MAX_LEN = 8, 256
LM_WIDE_SLOTS, LM_WIDE_NEW = 24, 4   # phase 6's pool past the row bucket
LM_PROMPTS, LM_NEW = (12, 40, 7, 100, 25), 32
SUSTAINED_REQS, SUSTAINED_NEW = 16, 32   # 32 new: the script's time limit
SUSTAINED_PROMPTS = (16, 128)     # prompt lengths drawn uniformly in range
PALLAS_PROMPTS, PALLAS_NEW = (10, 30, 60, 90), 16


def check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches after one warm-up,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def trunk_bound_ms(m: int, r: int, n: int,
                   x_elems: int | None = None) -> tuple[float, str]:
    """Least time for the unscaled trunk [m, n] of an input of ``x_elems``
    f32 values (the NHWC x the kernel reads; None: the patch matrix P [m,
    r], which the patch-matrix kernel read) and W int8 [r, n]: int8 operations
    over the tensor-core peak, or each input read once and the output
    written once over the HBM rate, whichever is larger."""
    x_elems = m * r if x_elems is None else x_elems
    ops_ms = 2.0 * m * r * n / PEAK_INT8_OPS * 1e3
    bytes_ms = (4.0 * x_elems + r * n + 4.0 * m * n) / PEAK_BYTES * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def reset_launches():
    """Every kernel wrapper's launch count to 0."""
    from repro_torch.kernels import cim_matmul as cm
    from repro_torch.kernels import rebranch_conv as rc
    from repro_torch.kernels import rebranch_matmul as rm
    rc.launches = cm.launches = rm.launches = 0


def read_launches() -> dict:
    from repro_torch.kernels import cim_matmul as cm
    from repro_torch.kernels import rebranch_conv as rc
    from repro_torch.kernels import rebranch_matmul as rm
    return {"trunk_conv": rc.launches, "cim_matmul": cm.launches,
            "rebranch_matmul": rm.launches}


def time_cycled_ms(fn, args: list, reps: int) -> float:
    """Mean device time of ``fn(*a)`` over ``reps`` launches that cycle
    through ``args`` (copies whose bytes exceed the L2 cache), after one
    warm-up pass over all of them."""
    for a in args:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*args[i % len(args)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def with_cores(tree, gen: torch.Generator):
    """Replace every (zero-initialised) ReBranch core by seeded N(0, 0.05)
    values, so every branch contributes to the output."""
    if isinstance(tree, dict):
        out = {k: with_cores(v, gen) for k, v in tree.items()}
        sram = out.get("sram")
        if isinstance(sram, dict) and "core" in sram:
            core = sram["core"]
            sram["core"] = (torch.randn(core.shape, generator=gen) * 0.05
                            ).to(core.device)
        return out
    if isinstance(tree, list):
        return [with_cores(v, gen) for v in tree]
    return tree


def kernel_name(mangled: str) -> str:
    """``_ZN12_GLOBAL__N_114cim_matmul_mmaILi0ELi16EEEv...`` ->
    ``cim_matmul_mma<0,16>``: a kernel's name (its last name component)
    and template arguments (integers, booleans, and float or bf16 element
    types)."""
    import re
    at = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while (m := re.match(r"\d+", mangled[at:])):
        start = at + m.end()
        at = start + int(m.group())
        name = mangled[start:at]
    types = {"f": "float", "t": "bf16", "Lb0E": "false", "Lb1E": "true"}
    args = re.match(r"I((?:Li-?\d+E|Lb[01]E|[ft])+)E", mangled[at:])
    if args:
        name += "<" + ",".join(
            types.get(a, a.strip("LiE"))
            for a in re.findall(r"Li-?\d+E|Lb[01]E|[ft]",
                                args.group(1))) + ">"
    return name


def phase_build():
    """Build every library; print, per kernel instantiation, what ptxas
    reports (registers, static shared memory, spills), and the dynamic
    shared memory of the tensor-core tiles."""
    import ctypes
    import re
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    reports = _build.build()
    secs = time.perf_counter() - t0
    for name in _build.SOURCES:
        print(f"built {_build.target(name).relative_to(ROOT)} from "
              f"{(_build.CSRC / (name + '.cu')).relative_to(ROOT)}")
        for line in reports.get(name, "").splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                print(f"  kernel {kernel_name(entry.group(1))}")
            elif "registers" in line or "spill" in line:
                print(f"    ptxas: {line.strip()}")
    for name in ("cim_matmul", "rebranch_matmul"):
        fn = getattr(_build.library(name), f"{name}_smem")
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        for mode, code, tall in (("ideal", 0, 64), ("bitserial", 2, 32)):
            print(f"{name}: dynamic shared memory per block in {mode}, "
                  f"tile height 16: {fn(16, code)} bytes, {tall}: "
                  f"{fn(tall, code)} bytes")
    print(f"build_s {secs:.2f}")


def plain_trunk(x, w_q, cfg=None, stride=1, padding="SAME"):
    """The plain version of the trunk kernel: the patch matrix P of x, then
    ``trunk_patch_dot_plain`` (built here as the reference; the kernel
    route never builds P)."""
    from repro_torch.kernels import rebranch_conv as rc
    kh, kw, _, c_out = w_q.shape
    p, _ = rc.patch_matrix(x, kh, kw, stride, padding)
    return rc.trunk_patch_dot_plain(p, w_q.reshape(-1, c_out),
                                    cfg or rc.IDEAL)


def fused_plain(x, w_q, w_scale, c, core, u):
    """``rebranch_conv`` from the plain trunk and the JAX package's branch
    formula on P (stride 1, SAME): ``structured_compress``, the per-tap
    compress of the patch matrix, then ``@ core @ U``.  The reference the
    kernel route (NHWC trunk, compress once per pixel) is held against."""
    from repro_torch.kernels import rebranch_conv as rc
    kh, kw, c_in, c_out = w_q.shape
    c_c, c_u = core.shape[2], core.shape[3]
    p, (n, oh, ow) = rc.patch_matrix(x, kh, kw, 1, "SAME")
    trunk = rc.trunk_patch_dot_plain(p, w_q.reshape(-1, c_out))
    t1 = (p.reshape(-1, c_in) @ c.reshape(c_in, c_c)).reshape(p.shape[0], -1)
    branch = (t1 @ core.reshape(kh * kw * c_c, c_u)) @ u.reshape(c_u, c_out)
    return (trunk * w_scale.reshape(1, -1) + branch).reshape(n, oh, ow, c_out)


def no_patch_matrix(fn, c_in: int):
    """Run ``fn`` on the card with ``rebranch_conv.patch_matrix`` made to
    raise and ``im2col`` refusing an input of C_in channels (the branch may
    gather only the compressed C_c ones); returns (fn's result, the peak of
    the bytes allocated during the call)."""
    from repro_torch.core import cim
    from repro_torch.kernels import rebranch_conv as rc
    im2col, patch_matrix = cim.im2col, rc.patch_matrix

    def refuse(*args, **kwargs):
        raise AssertionError("the card path built the patch matrix")

    def compressed_only(x, *args, **kwargs):
        check(x.shape[-1] < c_in, f"im2col of the {c_in}-channel input")
        return im2col(x, *args, **kwargs)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rc.patch_matrix, cim.im2col = refuse, compressed_only
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        rc.patch_matrix, cim.im2col = patch_matrix, im2col
    return out, torch.cuda.max_memory_allocated() - base


def phase_kernels(dev, cfg) -> dict:
    """The NHWC trunk kernel vs its plain version at every conv geometry of
    ``cfg``."""
    from repro_torch.kernels import rebranch_conv as rc
    from repro_torch.models import cnn
    gen = torch.Generator(device=dev).manual_seed(1)
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_p_ms": 0.0,
           "ops_ms": 0.0, "bytes_ms": 0.0, "conv_ms": 0.0, "branch_ms": 0.0,
           "max_abs_err": 0.0}
    print("site k c_in c_out M R N trunk_equal fused_rel_err ms plain_ms "
          "bound_ms bound_by bound_p_ms library_ms fused_conv_ms branch_ms "
          "peak_alloc_mb p_mb")
    for site, k, c_in, c_out, hw, stride in cnn.conv_site_shapes(cfg):
        check(stride == 1, f"{site}: DarkNet-19 convs are stride 1")
        x = torch.randn((BATCH, hw, hw, c_in), generator=gen, device=dev)
        w_q = torch.randint(-127, 128, (k, k, c_in, c_out), generator=gen,
                            device=dev, dtype=torch.int8)
        w_scale = torch.rand((1, 1, 1, c_out), generator=gen, device=dev
                             ) * 1e-2 + 1e-3
        c_c, c_u = max(1, c_in // 4), max(1, c_out // 4)
        c = torch.randn((1, 1, c_in, c_c), generator=gen, device=dev) / c_in ** .5
        core = torch.randn((k, k, c_c, c_u), generator=gen, device=dev) * 0.05
        u = torch.randn((1, 1, c_u, c_out), generator=gen, device=dev) / c_u ** .5
        m, r = BATCH * hw * hw, k * k * c_in

        got = rc.trunk_conv_dot(x, w_q)
        want = plain_trunk(x, w_q)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        err = (got - want).abs().max().item()
        check(equal, f"{site}: kernel trunk != plain trunk (max {err})")
        del got, want
        # the fused conv on the card builds no patch matrix
        y, peak = no_patch_matrix(
            lambda: rc.rebranch_conv(x, w_q, w_scale, c, core, u), c_in)
        y_plain = fused_plain(x, w_q, w_scale, c, core, u)
        scale = y_plain.abs().max().item()
        ferr = (y - y_plain).abs().max().item() / scale
        check(ferr <= FUSED_RTOL and torch.isfinite(y).all().item(),
              f"{site}: fused conv off by {ferr} of its absmax")
        no_patch_matrix(lambda: rc.trunk_conv(x, w_q, w_scale), c_in)
        del y, y_plain
        torch.cuda.empty_cache()

        ms = time_ms(lambda: rc.trunk_conv_dot(x, w_q), 5)
        plain_ms = time_ms(lambda: plain_trunk(x, w_q), 3)
        # the whole fused conv around the kernel, and its branch alone
        conv_ms = time_ms(lambda: rc.rebranch_conv(x, w_q, w_scale, c, core,
                                                   u), 3)
        branch_ms = time_ms(lambda: rc.branch_conv(x, c, core, u), 3)
        bound, by = trunk_bound_ms(m, r, c_out, x.numel())
        bound_p, _ = trunk_bound_ms(m, r, c_out)
        ops_ms = 2.0 * m * r * c_out / PEAK_INT8_OPS * 1e3
        print(f"{site} {k} {c_in} {c_out} {m} {r} {c_out} {equal} {ferr:.3e} "
              f"{ms:.4f} {plain_ms:.4f} {bound:.4f} {by} {bound_p:.4f} none "
              f"{conv_ms:.4f} {branch_ms:.4f} {peak / 2**20:.1f} "
              f"{4 * m * r / 2**20:.1f}", flush=True)
        tot["conv_ms"] += conv_ms
        tot["branch_ms"] += branch_ms
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["bound_ms"] += bound
        tot["bound_p_ms"] += bound_p
        tot["ops_ms"] += ops_ms
        tot["bytes_ms"] += bound if by == "bytes" else 0.0
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        del x
        torch.cuda.empty_cache()
    print(f"per forward (20 launches): kernel {tot['ms']:.3f} ms, plain "
          f"{tot['plain_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms (NHWC "
          f"bytes; with P's bytes {tot['bound_p_ms']:.3f} ms; int8 operations "
          f"alone {tot['ops_ms']:.3f} ms); the 20 fused convs "
          f"{tot['conv_ms']:.3f} ms, of which the branch "
          f"{tot['branch_ms']:.3f} ms; no patch matrix built")
    return tot


def phase_serve(cfg):
    """The main path: registry -> compile_entry -> load -> CNNServer."""
    from repro_torch.kernels import rebranch_conv as rc
    from repro_torch.models import cnn
    from repro_torch.serve import registry, server

    registry.register(registry.ModelEntry(
        model_id="darknet19-416", config=lambda: cfg, engine="pallas_fused"))
    model, _plan = registry.compile_entry("darknet19-416")
    sites = [s[0] for s in cnn.conv_site_shapes(model.cfg)]
    for site in sites:
        spec = model.layer_spec(site)
        check(spec.enabled and spec.branch_enabled
              and spec.trunk_impl == "pallas_fused",
              f"{site}: the solved plan is not all-ROM pallas_fused ({spec})")
    params = model.init(seed=0)
    params = with_cores(params, torch.Generator().manual_seed(2))
    srv = server.load("darknet19-416", params=params, n_slots=SLOTS)
    rng = np.random.default_rng(3)
    images = rng.standard_normal((sum(REQUESTS), SIZE, SIZE, 3),
                                 dtype=np.float32)

    srv.submit(images[:SLOTS])                     # warm-up, not counted
    torch.cuda.synchronize()
    reset_launches()
    outs, lo, t_all = [], 0, time.perf_counter()
    for i, b in enumerate(REQUESTS):
        t0 = time.perf_counter()
        out = srv.submit(images[lo:lo + b])        # returns host numpy
        dt = time.perf_counter() - t0
        print(f"request {i}: {b} images, latency {dt * 1e3:.2f} ms, "
              f"{b / dt:.2f} images/s")
        outs.append(out)
        lo += b
    wall = time.perf_counter() - t_all
    counts = read_launches()
    launches = counts["trunk_conv"]
    check(counts["cim_matmul"] == counts["rebranch_matmul"] == 0,
          f"the CNN path launched an LM kernel: {counts}")
    chunks = sum(-(-b // SLOTS) for b in REQUESTS)
    n_sites = len(sites)
    print(f"served {sum(REQUESTS)} images in {wall * 1e3:.2f} ms "
          f"({sum(REQUESTS) / wall:.2f} images/s); trunk kernel launches "
          f"{launches} over {chunks} chunks")
    check(launches == n_sites * chunks,
          f"expected {n_sites} launches per chunk, got {launches} for "
          f"{chunks} chunks")
    for b, out in zip(REQUESTS, outs):
        check(out.shape == (b, SIZE // 32, SIZE // 32, 5, 25),
              f"output shape {out.shape}")
        check(bool(np.isfinite(out).all()), "non-finite output")

    # pad-row invisibility: the short request's rows, served in a full chunk
    short_lo = sum(REQUESTS[:-1])
    short = images[short_lo:]
    before = rc.launches
    full = srv.submit(np.concatenate([short, images[:SLOTS - len(short)]]))
    check(rc.launches - before == n_sites, "full chunk launch count")
    check(np.array_equal(full[:len(short)], outs[-1]),
          "pad rows changed a real row: short request != full chunk rows "
          f"(max diff {np.abs(full[:len(short)] - outs[-1]).max()})")
    print(f"pad rows invisible: {len(short)}-image request bitwise equal to "
          f"the same rows of a full chunk")

    # sustained window: requests of many full chunks, back to back
    n_img = SUSTAINED_CHUNKS * SLOTS
    batch = rng.standard_normal((n_img, SIZE, SIZE, 3), dtype=np.float32)
    rates = []
    for run in range(SUSTAINED_RUNS):
        before = rc.launches
        t0 = time.perf_counter()
        out = srv.submit(batch)
        dt = time.perf_counter() - t0
        check(rc.launches - before == n_sites * SUSTAINED_CHUNKS,
              "sustained window launch count")
        check(out.shape[0] == n_img and bool(np.isfinite(out).all()),
              "sustained window output")
        rates.append(n_img / dt)
        print(f"sustained run {run}: {n_img} images in {SUSTAINED_CHUNKS} "
              f"chunks, {dt * 1e3:.2f} ms, {n_img / dt:.2f} images/s")
    spread = (max(rates) - min(rates)) / min(rates)
    print(f"sustained images/s: mean {sum(rates) / len(rates):.2f}, min "
          f"{min(rates):.2f}, max {max(rates):.2f}, spread {spread:.2%}")
    del batch, out

    # where a chunk's time goes: the device forward vs the host copy
    chunk = torch.from_numpy(images[:SLOTS])
    x = chunk.to(srv.device)
    with torch.no_grad():
        fwd_ms = time_ms(lambda: model.forward(params, x), 5)
    copy_ms = time_ms(lambda: chunk.to(srv.device), 5)
    print(f"per {SLOTS}-image chunk: device forward {fwd_ms:.3f} ms, "
          f"host-to-device copy {copy_ms:.3f} ms")
    return model, params, images[:SLOTS], launches


def cpu_layers(model, params, image):
    """Every conv call of one image's forward on the card, replayed on the
    CPU on the same input: (card output, calls, worst max abs diff of a
    layer's absmax, ADC-mode trunks held bitwise, seconds).  In an ADC mode
    each ROM site's unscaled trunk must be bitwise equal to the CPU's."""
    from repro_torch import bridge
    from repro_torch.kernels import rebranch_conv as rc
    from repro_torch.models import cnn

    calls = []
    apply_conv = cnn.apply_conv

    def recording(p, x, spec, stride=1, epilogue=None):
        y = apply_conv(p, x, spec, stride, epilogue)
        calls.append((p, x, spec, stride, epilogue, y))
        return y

    x = torch.from_numpy(image)
    cnn.apply_conv = recording
    try:
        with torch.no_grad():
            card = model.forward(params, x.cuda())
    finally:
        cnn.apply_conv = apply_conv
    worst, trunks = 0.0, 0
    t0 = time.perf_counter()
    for p, xin, spec, stride, ep, y in calls:
        if ep is not None:
            ep = dataclasses.replace(ep, scale=ep.scale.cpu(),
                                     bias=ep.bias.cpu())
        with torch.no_grad():
            ref = apply_conv(bridge.to_torch(bridge.to_numpy(p), "cpu"),
                             xin.cpu(), spec, stride, ep)
        rel = ((ref - y.cpu()).abs().max() / ref.abs().max()).item()
        worst = max(worst, rel)
        if spec.enabled and spec.cim.mode != "ideal":
            w_q = p["rom"]["w_q"]
            xf = xin.float().contiguous()
            trunk = rc.trunk_conv_dot(xf, w_q, stride, "SAME", spec.cim)
            ref_trunk = plain_trunk(xf.cpu(), w_q.cpu(), spec.cim, stride)
            check(torch.equal(trunk.cpu(), ref_trunk),
                  f"{spec.cim.mode} trunk on the card != CPU trunk")
            trunks += 1
    return card, len(calls), worst, trunks, time.perf_counter() - t0


def phase_cpu(model, params, image):
    """Every conv call of one image's forward on the card, replayed on the
    CPU on the same input; in an ADC mode each ROM site's unscaled trunk
    too, which must be bitwise equal."""
    from repro_torch import bridge

    x = torch.from_numpy(image)
    card, n_calls, worst, trunks, secs = cpu_layers(model, params, image)
    check(n_calls == 21, f"expected 21 conv calls, recorded {n_calls}")
    print(f"cpu reference, layer by layer (21 convs, plain versions, "
          f"{secs:.1f} s): worst max abs diff {worst:.3e} of the layer "
          f"output's absmax (tolerance {LAYER_RTOL}); {trunks} ADC-mode "
          f"trunks bitwise equal")
    check(worst <= LAYER_RTOL, "a layer on the card disagrees with the CPU")

    cpu_params = bridge.to_torch(bridge.to_numpy(params), "cpu")
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        ref = model.forward(cpu_params, x)
        moved = model.forward(params, (x * (1 + 1e-7 * noise)).cuda())
    amax = ref.abs().max().item()
    whole = (ref - card.cpu()).abs().max().item() / amax
    self_moved = (moved - card).abs().max().item() / amax
    check(bool(torch.isfinite(card).all()), "non-finite card output")
    print(f"whole forward, card vs cpu: max abs diff {whole:.3e} of the "
          f"absmax; card vs card on a 1e-7 perturbed input: "
          f"{self_moved:.3e}")


def lm_bound_ms(m: int, k: int, n: int, cdim: int = 0,
                x_bytes: float | None = None) -> tuple[float, str]:
    """Least time for the fused matmul (cdim > 0: x [m, k] of ``x_bytes``
    a value, f32 by default, W int8 [k, n], C f32 [k, cdim] -> trunk f32
    [m, n], t1 f32 [m, cdim]) or the CiM matmul (cdim = 0: X int8 [m, k],
    W int8 [k, n] -> f32 [m, n]): each input read once and each output
    written once over the HBM rate, or the int8 and f32 operations over
    their peak rates, whichever is larger.  x counts in the dtype the
    wrapper is handed (``launch/cost.py``'s count): a bf16 decode x is
    read as it is."""
    if x_bytes is None:
        x_bytes = 4.0 if cdim else 1.0
    x_bytes *= m * k
    nbytes = x_bytes + k * n + 4.0 * m * n + 4.0 * (k * cdim + m * cdim)
    ops_ms = (2.0 * m * k * n / PEAK_INT8_OPS
              + 2.0 * m * k * cdim / PEAK_F32_OPS) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def time_graph_ms(fn, args: list, reps: int) -> float:
    """Mean device time of ``fn(*a)`` over ``reps`` calls that cycle
    through ``args``, captured in one CUDA graph and replayed: the host's
    per-call cost (Python, ctypes, allocations) is left out, the device's
    launch gaps are not.  Warmed by one eager pass over ``args``."""
    for a in args:
        fn(*a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*args[i % len(args)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int = 500) -> float:
    """Host time per call of ``fn`` over ``reps`` calls issued back to
    back, on the host clock, with no synchronisation between them (the
    device runs behind; the shapes timed here take less device time than
    host time, so the queue never fills)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def lm_host_costs(dev):
    """What one call of each LM kernel wrapper costs the host at a decode
    step's shape (2048 x 2048, 8 rows), and the pieces of that cost."""
    from repro_torch.kernels import cim_matmul as cm
    from repro_torch.kernels import rebranch_matmul as rm
    m, k, n = LM_SLOTS, 2048, 2048
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                       dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    c = torch.randn((k, k // 4), generator=gen, device=dev)
    launch, ft, fs = rm._launch(m, k, n, k // 4, rm.IDEAL, True)
    out = torch.empty(m * n + m * k // 4 + ft + fs, device=dev)
    at = out.data_ptr()
    entry = rm._kernel()
    costs = {
        "rebranch_trunk_sketch": lambda: rm.rebranch_trunk_sketch(x, w, c),
        "cim_matmul": lambda: cm.cim_matmul(xq, w),
        "kernel 3's C entry alone (2 launches)": lambda: entry(
            x.data_ptr(), w.data_ptr(), c.data_ptr(), at, at + 4 * m * n,
            at + 4 * (m * n + m * k // 4),
            at + 4 * (m * n + m * k // 4 + ft), 0, launch,
            torch._C._cuda_getCurrentRawStream(dev.index or 0)),
        "torch.empty": lambda: torch.empty(m * n, device=dev),
        "x.float() of a bf16 x (kernel 3 reads bf16 at M <= 16)":
            lambda: x.float(),
        "torch.cuda.current_stream (the wrappers read the raw handle)":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "kernel 4's plan and launch struct (cim_matmul._launch, cached)":
            lambda: cm._launch(m, k, n, cm.IDEAL),
        "kernel 3's (rebranch_matmul._launch, cached)":
            lambda: rm._launch(m, k, n, k // 4, rm.IDEAL, True),
    }
    print(f"host us per call at M = {m}, {k}x{n} (host clock, calls back "
          f"to back): " + "; ".join(f"{name} {host_us(fn):.2f}"
                                     for name, fn in costs.items()))


def phase_lm_kernels(dev) -> dict:
    """Both LM kernels vs their plain versions at Gemma-2B's geometries.

    ``ms`` is the time per launch of cycled launches from Python, host
    cost included (time_cycled_ms), which is what a serving step pays and
    what earlier versions of this script reported; ``device_ms`` the same
    launches captured in a CUDA graph and replayed (time_graph_ms), the
    device's share.  ``torch._int_mm`` is timed both ways too."""
    from repro_torch.kernels import cim_matmul as cm
    from repro_torch.kernels import rebranch_matmul as rm
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {name: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                  "bound_ms": 0.0, "bytes_ms": 0.0, "max_abs_err": 0.0,
                  "library_ms": None}
           for name in ("rebranch_matmul", "cim_matmul")}
    out["cim_matmul"].update(library_ms=0.0, ms_m128=0.0,
                             library_device_ms=0.0, device_ms_m128=0.0)
    out["rebranch_matmul"].update(verify_ms=0.0, verify_device_ms=0.0,
                                  verify_plain_ms=0.0, verify_bound_ms=0.0)
    print("kernel K N M equal err ms device_ms plain_ms bound_ms bound_by "
          "library_ms library_device_ms trunk_tile_m trunk_splits "
          "(kernel 3: sketch_tile_m sketch_splits)")
    m128 = {}
    for (k, n), per_layer in LM_GEOMS.items():
        cdim = k // 4
        m_max = max(LM_ROWS)
        x = torch.randn((m_max, k), generator=gen, device=dev
                        ).to(torch.bfloat16)
        xq = torch.randint(-127, 128, (m_max, k), generator=gen, device=dev,
                           dtype=torch.int8)
        copies3 = max(1, math.ceil(2.5 * L2_BYTES / (k * n + 4 * k * cdim)))
        copies4 = max(1, math.ceil(2.5 * L2_BYTES / (k * n)))
        ws = [torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                            dtype=torch.int8)
              for _ in range(max(copies3, copies4))]
        cs = [torch.randn((k, cdim), generator=gen, device=dev) / k ** .5
              for _ in range(copies3)]
        w, c = ws[0], cs[0]
        rows = {}
        count = per_layer * LM_LAYERS
        for m in LM_ROWS:
            xm, xqm = x[:m].contiguous(), xq[:m].contiguous()
            trunk, t1 = rm.rebranch_trunk_sketch(xm, w, c)
            want_trunk, want_t1 = rm.rebranch_matmul_plain(xm, w, c)
            got4 = cm.cim_matmul(xqm, w)
            want4 = cm.cim_matmul_plain(xqm, w)
            torch.cuda.synchronize()
            eq3 = torch.equal(trunk, want_trunk)
            err3 = (t1 - want_t1).abs().max().item()
            rel3 = err3 / want_t1.abs().max().item()
            check(eq3, f"rebranch kernel trunk != plain ({k}x{n}, M={m})")
            check(rel3 <= SKETCH_RTOL,
                  f"rebranch sketch off by {rel3} of its absmax")
            eq4 = torch.equal(got4, want4)
            check(eq4, f"cim_matmul kernel != plain ({k}x{n}, M={m})")
            rows[m] = (trunk[:1], t1[:1], got4[:1])
            out["rebranch_matmul"]["max_abs_err"] = max(
                out["rebranch_matmul"]["max_abs_err"], err3)

            args3 = [(xm, wi, ci) for wi, ci in zip(ws, cs)]
            args4 = [(xqm, wi) for wi in ws[:copies4]]
            ms3 = time_cycled_ms(rm.rebranch_trunk_sketch, args3, 3 * copies3)
            ms4 = time_cycled_ms(cm.cim_matmul, args4, 3 * copies4)
            dev3 = time_graph_ms(rm.rebranch_trunk_sketch, args3, 3 * copies3)
            dev4 = time_graph_ms(cm.cim_matmul, args4, 3 * copies4)
            plain3 = time_cycled_ms(rm.rebranch_matmul_plain, args3, copies3)
            plain4 = time_cycled_ms(cm.cim_matmul_plain, args4, copies4)
            lib4 = lib4_dev = None
            if m > 16:               # torch._int_mm refuses M <= 16
                lib_args = [(a, b.t().contiguous().t()) for a, b in args4]
                lib4 = time_cycled_ms(torch._int_mm, lib_args, 3 * copies4)
                lib4_dev = time_graph_ms(torch._int_mm, lib_args,
                                         3 * copies4)
                del lib_args
            b3, by3 = lm_bound_ms(m, k, n, cdim, xm.element_size())
            b4, by4 = lm_bound_ms(m, k, n)
            # the plans the wrappers handed the kernels, read back
            st, ss, s4 = (rm.last_launch.trunk, rm.last_launch.sketch,
                          cm.last_launch.plan)
            lib_txt = "none none" if lib4 is None else \
                f"{lib4:.4f} {lib4_dev:.4f}"
            print(f"rebranch_matmul {k} {n} {m} {eq3} {rel3:.2e} {ms3:.4f} "
                  f"{dev3:.4f} {plain3:.4f} {b3:.4f} {by3} none none "
                  f"{st.tile_m} {st.n_splits} {ss.tile_m} {ss.n_splits}")
            print(f"cim_matmul {k} {n} {m} {eq4} 0 {ms4:.4f} {dev4:.4f} "
                  f"{plain4:.4f} {b4:.4f} {by4} {lib_txt} {s4.tile_m} "
                  f"{s4.n_splits}", flush=True)
            if m == LM_VERIFY_ROWS:  # a verify round's shapes: per round
                row = out["rebranch_matmul"]
                row["verify_ms"] += ms3 * count
                row["verify_device_ms"] += dev3 * count
                row["verify_plain_ms"] += plain3 * count
                row["verify_bound_ms"] += b3 * count
            if m == LM_SLOTS:        # the decode step's shapes: per step
                for name, t, d, p, b, by in (
                        ("rebranch_matmul", ms3, dev3, plain3, b3, by3),
                        ("cim_matmul", ms4, dev4, plain4, b4, by4)):
                    out[name]["ms"] += t * count
                    out[name]["device_ms"] += d * count
                    out[name]["plain_ms"] += p * count
                    out[name]["bound_ms"] += b * count
                    out[name]["bytes_ms"] += b * count if by == "bytes" \
                        else 0.0
            if m == max(LM_ROWS) and lib4 is not None:
                m128[(k, n)] = (ms4, lib4, dev4, lib4_dev)
                row = out["cim_matmul"]
                row["ms_m128"] += ms4 * count
                row["library_ms"] += lib4 * count
                row["device_ms_m128"] += dev4 * count
                row["library_device_ms"] += lib4_dev * count
        # row 0 has the same bits at every M, tile height and split
        for m in LM_ROWS[1:]:
            for a, b in zip(rows[1], rows[m]):
                check(torch.equal(a, b), f"row 0 differs between M = 1 and "
                      f"M = {m} launches ({k}x{n})")
        del ws, cs, rows
        torch.cuda.empty_cache()
    for name, row in out.items():
        print(f"{name} per decode step at M = {LM_SLOTS} "
              f"({7 * LM_LAYERS} launches): "
              f"kernel {row['ms']:.3f} ms (device, graph replay: "
              f"{row['device_ms']:.3f} ms), plain {row['plain_ms']:.3f} ms, "
              f"bound {row['bound_ms']:.3f} ms")
    for (k, n), (ms4, lib4, dev4, lib4_dev) in m128.items():
        print(f"cim_matmul vs torch._int_mm at M = 128, {k}x{n}: kernel "
              f"{ms4:.4f} ms, _int_mm {lib4:.4f} ms (device, graph replay: "
              f"{dev4:.4f} ms and {lib4_dev:.4f} ms)")
    row = out["rebranch_matmul"]
    print(f"rebranch_matmul per verify round at M = {LM_VERIFY_ROWS} "
          f"({LM_SLOTS} rows x k = {LM_VERIFY_ROWS // LM_SLOTS}, "
          f"{7 * LM_LAYERS} launches): kernel {row['verify_ms']:.3f} ms "
          f"(device, graph replay: {row['verify_device_ms']:.3f} ms), plain "
          f"{row['verify_plain_ms']:.3f} ms, bound "
          f"{row['verify_bound_ms']:.3f} ms")
    lm_host_costs(dev)
    row = out["cim_matmul"]
    print(f"cim_matmul per pass at M = 128 ({7 * LM_LAYERS} launches): "
          f"kernel {row['ms_m128']:.3f} ms, torch._int_mm "
          f"{row['library_ms']:.3f} ms (device, graph replay: "
          f"{row['device_ms_m128']:.3f} ms and "
          f"{row['library_device_ms']:.3f} ms)")
    return out


def lm_config():
    from repro_torch import configs
    return configs.get("gemma_2b")


def _solo_run(model, params, prompt, n_new, max_len):
    """Batch-1 prefill + greedy decode on the card: (tokens, logits of the
    first decode step)."""
    dev = params["ln_f"]["sram"]["scale"].device
    cache = model.init_cache(1, max_len, dtype=torch.float32, device=dev)
    with torch.no_grad():
        logits, cache = model.prefill(
            params, {"tokens": torch.as_tensor(prompt[None], device=dev)},
            cache)
        check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
        toks = [int(logits[0, -1].argmax())]
        first = None
        for _ in range(n_new - 1):
            logits, cache = model.decode_step(
                params, torch.tensor([[toks[-1]]], device=dev), cache)
            check(bool(torch.isfinite(logits).all()),
                  "non-finite decode logits")
            if first is None:
                first = logits[0, -1].float().cpu()
            toks.append(int(logits[0, -1].argmax()))
    return toks, first


def phase_lm_serve():
    """The main path: registry -> compile_entry -> load -> LMServer."""
    from repro_torch.serve import registry, server
    from repro_torch.serve.pool import PagedPool

    cfg = lm_config()
    registry.register(registry.ModelEntry(
        model_id="gemma-2b", config=lm_config, engine="pallas_fused"))
    model, plan = registry.compile_entry("gemma-2b")
    for site in ("blocks.attn", "blocks.mlp"):
        spec = model.layer_spec(site)
        check(spec.enabled and spec.branch_enabled
              and spec.trunk_impl == "pallas_fused",
              f"{site}: the solved plan is not all-ROM pallas_fused ({spec})")
    check([s for s, _ in plan.entries] == [], "plan flips sites to SRAM")
    t0 = time.perf_counter()
    params = model.init(seed=0)
    params = with_cores(params, torch.Generator().manual_seed(2))
    torch.cuda.synchronize()
    print(f"gemma-2b params drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    srv = server.load("gemma-2b", params=params, n_slots=LM_SLOTS,
                      max_len=LM_MAX_LEN)
    check(isinstance(srv.pool, PagedPool), "load did not build a paged pool")
    rng = np.random.default_rng(7)
    vocab = cfg.vocab_size
    warm = srv.submit(rng.integers(0, vocab, size=9), 3)    # not counted
    srv.drain()
    check(len(warm.tokens) == 3, "warm-up request")

    # record the first decode step's logits of every request in the batch
    first_logits = {}
    decode = model.decode_step

    def recording(p, tok, cache):
        logits, cache = decode(p, tok, cache)
        for slot, req in srv.batcher._active.items():
            if len(req.tokens) == 1:
                first_logits[req.rid] = logits[slot, -1].float().cpu()
        return logits, cache

    prompts = [rng.integers(0, vocab, size=n) for n in LM_PROMPTS]
    torch.cuda.synchronize()
    reset_launches()
    model.decode_step = recording
    t0 = time.perf_counter()
    reqs = [srv.submit(p, LM_NEW) for p in prompts]
    steps = srv.drain()
    wall = time.perf_counter() - t0
    del model.decode_step
    counts = read_launches()
    launches = counts["rebranch_matmul"]
    n_tok = sum(len(r.tokens) for r in reqs)
    print(f"served {len(reqs)} requests (prompts {LM_PROMPTS}), {n_tok} "
          f"tokens in {wall * 1e3:.1f} ms ({n_tok / wall:.2f} tokens/s), "
          f"{steps} decode steps; launches {counts}")
    per_pass = 7 * cfg.num_layers              # 126 at full depth
    chunks = prefill_calls(prompts, srv.batcher.prefill_chunk)
    check(launches == per_pass * (chunks + steps),
          f"expected {per_pass} fused-kernel launches per prefill chunk and "
          f"per decode step, got {launches} for {chunks} chunks + {steps} "
          f"steps")
    check(counts["cim_matmul"] == counts["trunk_conv"] == 0,
          f"pallas_fused serving launched another kernel: {counts}")
    for r in reqs:
        check(len(r.tokens) == LM_NEW and all(0 <= t < vocab
                                              for t in r.tokens),
              f"request {r.rid}: tokens {r.tokens}")
    check(srv.pool.blocks_in_use == 0, "blocks leaked after drain")

    # two requests against a solo run on the card
    for r, p in list(zip(reqs, prompts))[:2]:
        toks, first = _solo_run(model, params, p, LM_NEW, LM_MAX_LEN)
        agree = sum(a == b for a, b in zip(toks, r.tokens))
        diff = (first - first_logits[r.rid]).abs().max().item()
        print(f"request {r.rid} (prompt {len(p)}): batched vs solo on the "
              f"card, {agree}/{LM_NEW} tokens agree, first decode step "
              f"logits max abs diff {diff:.3e} (absmax "
              f"{first.abs().max().item():.3e})")
        check(agree == LM_NEW and diff == 0.0,
              f"request {r.rid}: batched decode != solo decode on the card")

    wide_pool_check(model, params, LM_WIDE_SLOTS)

    # sustained window
    rates, steps_ms, lat = [], [], []
    for run in range(SUSTAINED_RUNS):
        batch = [rng.integers(SUSTAINED_PROMPTS[0], SUSTAINED_PROMPTS[1] + 1)
                 for _ in range(SUSTAINED_REQS)]
        t0 = time.perf_counter()
        rs = [srv.submit(rng.integers(0, vocab, size=n), SUSTAINED_NEW)
              for n in batch]
        n_steps = srv.drain()
        dt = time.perf_counter() - t0
        toks = sum(len(r.tokens) for r in rs)
        check(toks == SUSTAINED_REQS * SUSTAINED_NEW, "sustained tokens")
        rates.append(toks / dt)
        lat += [r.latency_s for r in rs]
        steps_ms.append(dt / n_steps * 1e3)
        print(f"sustained run {run}: {SUSTAINED_REQS} requests, {toks} tokens "
              f"in {dt * 1e3:.1f} ms, {n_steps} decode steps, "
              f"{toks / dt:.2f} tokens/s")
    spread = (max(rates) - min(rates)) / min(rates)
    lat.sort()
    print(f"sustained tokens/s: mean {sum(rates) / len(rates):.2f}, min "
          f"{min(rates):.2f}, max {max(rates):.2f}, spread {spread:.2%}; "
          f"wall per decode step (prefills included) "
          f"{sum(steps_ms) / len(steps_ms):.2f} ms; request latency p50 "
          f"{lat[len(lat) // 2]:.3f} s, max {lat[-1]:.3f} s")
    step_split(model, params, srv)
    return model, params, srv, launches


def wide_pool_check(model, params, n_slots: int):
    """A pool of more rows than ``rows.ROW_BUCKET`` (16): ``n_slots``
    requests decoded together, so every batch-variant op of a step runs
    on 16-row slices (``core/rows.py``); requests 0, 16 and the last (the
    pool hands out its slots from the top, so they sit in both slices)
    give the tokens and first decode step's logits of their solo runs on
    the card, bit for bit."""
    from repro_torch.serve import server
    srv = server.load("gemma-2b", params=params, n_slots=n_slots,
                      max_len=LM_MAX_LEN)
    rng = np.random.default_rng(9)
    vocab = model.cfg.vocab_size
    prompts = [rng.integers(0, vocab, size=int(n))
               for n in rng.integers(8, 40, size=n_slots)]
    first_logits, step_rows = {}, set()
    decode = model.decode_step

    def recording(p, tok, cache):
        logits, cache = decode(p, tok, cache)
        step_rows.add(tok.shape[0])
        for slot, req in srv.batcher._active.items():
            if len(req.tokens) == 1:
                first_logits[req.rid] = logits[slot, -1].float().cpu()
        return logits, cache

    model.decode_step = recording
    try:
        reqs = [srv.submit(p, LM_WIDE_NEW) for p in prompts]
        srv.drain()
    finally:
        del model.decode_step
    check(step_rows == {n_slots}, f"decode steps of {step_rows} rows")
    for i in (0, 16, n_slots - 1):
        toks, first = _solo_run(model, params, prompts[i], LM_WIDE_NEW,
                                LM_MAX_LEN)
        r = reqs[i]
        diff = (first - first_logits[r.rid]).abs().max().item()
        check(toks == r.tokens and diff == 0.0,
              f"{n_slots}-row pool, request {i}: batched != solo on the "
              f"card (tokens {r.tokens} vs {toks}, logits diff {diff})")
    print(f"{n_slots}-row pool ({n_slots} requests x {LM_WIDE_NEW} tokens, "
          f"decode steps of {n_slots} rows): requests 0, 16 and "
          f"{n_slots - 1} equal their solo runs on the card (tokens and "
          f"first decode step logits, bit for bit)")
    check(srv.pool.blocks_in_use == 0, "wide pool: blocks leaked")
    del srv
    torch.cuda.empty_cache()


def step_split(model, params, srv):
    """One decode step at 8 rows, split by part: the fused kernel, its
    epilogue, the readout, and the rest (attention, norms, embedding)."""
    from repro_torch.core import rebranch as rebranch_lib
    from repro_torch.core import rows as rows_lib
    from repro_torch.kernels import rebranch_matmul as rm
    from repro_torch.models import layers, transformer

    rng = np.random.default_rng(8)
    rs = [srv.submit(rng.integers(0, model.cfg.vocab_size, size=20), 8)
          for _ in range(LM_SLOTS)]
    srv.step()                                # admit all 8, one decode
    cache = srv.pool.cache
    tok = torch.as_tensor(srv.batcher._tok, device=srv.batcher.device)
    calls, heads, attends = [], [], []
    apply_linear, apply_head = rebranch_lib.apply_linear, \
        transformer.apply_head
    write_decode, decode_attention = layers._write_decode, \
        layers._decode_attention

    def rec_linear(p, x, spec):
        calls.append((p, x.reshape(-1, x.shape[-1]).contiguous()))
        return apply_linear(p, x, spec)

    def rec_head(p, x, cfg):
        heads.append(x)
        return apply_head(p, x, cfg)

    def rec_write(cache_l, k, v, length, rows):
        attends.append([cache_l, k, v, length, rows])
        return write_decode(cache_l, k, v, length, rows)

    def rec_attend(q, k_view, v_view, valid):
        attends[-1].append((q, valid))
        return decode_attention(q, k_view, v_view, valid)

    snapshot = {k: v.clone() for k, v in cache["layers"].items()}
    rebranch_lib.apply_linear, transformer.apply_head = rec_linear, rec_head
    layers._write_decode, layers._decode_attention = rec_write, rec_attend
    try:
        with torch.no_grad():
            model.decode_step(params, tok, cache)
    finally:
        rebranch_lib.apply_linear, transformer.apply_head = apply_linear, \
            apply_head
        layers._write_decode, layers._decode_attention = write_decode, \
            decode_attention
    per_pass = 7 * model.cfg.num_layers
    check(len(calls) == per_pass,
          f"recorded {len(calls)} linears, not {per_pass}")
    parts = []
    with torch.no_grad():
        for p, x in calls:
            parts.append(rm.rebranch_trunk_sketch(x, p["rom"]["w_q"],
                                                  p["rom"]["C"]))

        def kernels():
            for p, x in calls:
                rm.rebranch_trunk_sketch(x, p["rom"]["w_q"], p["rom"]["C"])

        def epilogues():
            for (p, x), (trunk, t1) in zip(calls, parts):
                rm.epilogue(x.dtype, trunk, t1, p["rom"]["w_scale"],
                            p["sram"]["core"], p["rom"]["U"])

        def readout():
            apply_head(params, heads[0], model.cfg)

        def attention():      # cache writes, paged gather, softmax
            for cache_l, k, v, length, rows, (q, valid) in attends:
                kv, vv = write_decode(cache_l, k, v, length, rows)
                decode_attention(q, kv, vv, valid)

        def step():
            for k, v in snapshot.items():
                cache["layers"][k].copy_(v)
            model.decode_step(params, tok, cache)

        copy_ms = time_ms(lambda: [cache["layers"][k].copy_(v)
                                   for k, v in snapshot.items()], 5)
        step_ms = time_ms(step, 5) - copy_ms
        # what the batch-invariant row slices cost: the same step with
        # each op on all rows at once, in turns
        sliced, by_bucket = rows_lib.rowwise, {}
        try:
            for on in (True, False, False, True):
                rows_lib.rowwise = sliced if on else (
                    lambda fn, *args: fn(*args))
                by_bucket.setdefault(on, []).append(time_ms(step, 5)
                                                    - copy_ms)
        finally:
            rows_lib.rowwise = sliced
        k_ms, e_ms, r_ms, a_ms = (time_ms(kernels, 5),
                                  time_ms(epilogues, 5), time_ms(readout, 5),
                                  time_ms(attention, 5))
        for k, v in snapshot.items():          # back to the batcher's state
            cache["layers"][k].copy_(v)
        # which parts give row 0 the same bits alone as in a batch of 8
        p, x = calls[-1]                      # the last layer's down
        trunk, t1 = parts[-1]
        one = rm.rebranch_trunk_sketch(x[:1].contiguous(), p["rom"]["w_q"],
                                       p["rom"]["C"])
        eargs = (p["rom"]["w_scale"], p["sram"]["core"], p["rom"]["U"])
        e8 = rm.epilogue(x.dtype, trunk, t1, *eargs)
        e1 = rm.epilogue(x.dtype, one[0], one[1], *eargs)
        r8 = apply_head(params, heads[0], model.cfg)
        r1 = apply_head(params, heads[0][:1], model.cfg)
        ln = params["ln_f"]
        n8 = layers.apply_rmsnorm(ln, heads[0], model.cfg.norm_eps)
        n1 = layers.apply_rmsnorm(ln, heads[0][:1], model.cfg.norm_eps)
        cache_l, k, v, length, rows, (q, valid) = attends[0]
        kv, vv = write_decode(cache_l, k, v, length, rows)
        a8 = decode_attention(q, kv, vv, valid)
        a1 = decode_attention(q[:1], kv[:1], vv[:1], valid[:1])
        for k_, v_ in snapshot.items():
            cache["layers"][k_].copy_(v_)
    same = {"kernel trunk": torch.equal(one[0], trunk[:1]),
            "kernel sketch": torch.equal(one[1], t1[:1]),
            "epilogue (cuBLAS f32)": torch.equal(e1, e8[:1]),
            "readout (cuBLAS bf16)": torch.equal(r1, r8[:1]),
            "rmsnorm": torch.equal(n1, n8[:1]),
            "decode attention": torch.equal(a1, a8[:1])}
    print("row 0 alone vs in a batch of 8, bitwise: " + ", ".join(
        f"{k} {v}" for k, v in same.items()) + f"; epilogue max diff "
        f"{(e1.float() - e8[:1].float()).abs().max().item():.3e}, readout "
        f"max diff {(r1.float() - r8[:1].float()).abs().max().item():.3e}")
    print(f"decode step with the batch-variant ops on "
          f"{rows_lib.ROW_BUCKET}-row slices: {sum(by_bucket[True]) / 2:.3f} "
          f"ms, on all rows at once (batch-variant bits): "
          f"{sum(by_bucket[False]) / 2:.3f} ms (in turns, CUDA events)")
    rest = step_ms - k_ms - e_ms - r_ms - a_ms
    print(f"one decode step at {LM_SLOTS} rows (CUDA events): whole "
          f"{step_ms:.3f} ms = fused kernel {k_ms:.3f} ms ({per_pass} "
          f"launches) + epilogue {e_ms:.3f} ms + readout {r_ms:.3f} ms + "
          f"attention {a_ms:.3f} ms (cache writes, paged gather, softmax) "
          f"+ rest (RoPE, norms, embedding, host gaps) {rest:.3f} ms")
    srv.drain()
    check(all(len(r.tokens) == 8 for r in rs), "split-step requests")


def phase_lm_pallas(params):
    """The 'pallas' engine: the CiM matmul kernel behind every linear."""
    from repro_torch import plan as plan_lib
    from repro_torch.serve import registry, server

    registry.register(registry.ModelEntry(
        model_id="gemma-2b-pallas", config=lm_config,
        plan=lambda cfg: plan_lib.solve(cfg, engine="pallas")))
    model, _ = registry.compile_entry("gemma-2b-pallas")
    check(model.layer_spec("blocks.mlp").trunk_impl == "pallas",
          "gemma-2b-pallas does not run the pallas engine")
    srv = server.load("gemma-2b-pallas", params=params, n_slots=LM_SLOTS,
                      max_len=LM_MAX_LEN)
    rng = np.random.default_rng(9)
    torch.cuda.synchronize()
    reset_launches()
    reqs = [srv.submit(rng.integers(0, model.cfg.vocab_size, size=n),
                       PALLAS_NEW) for n in PALLAS_PROMPTS]
    srv.step()                       # admits the first, one decode step
    torch.cuda.synchronize()
    first = srv.batcher.step_count
    t0 = time.perf_counter()
    srv.drain()
    dt = time.perf_counter() - t0
    steps = srv.batcher.step_count - first
    counts = read_launches()
    launches = counts["cim_matmul"]
    per_pass = 7 * model.cfg.num_layers
    chunks = prefill_calls([r.prompt for r in reqs],
                           srv.batcher.prefill_chunk)
    check(launches == per_pass * (chunks + 1 + steps),
          f"expected {per_pass} CiM-matmul launches per prefill chunk and "
          f"decode step, got {launches}")
    check(counts["rebranch_matmul"] == counts["trunk_conv"] == 0,
          f"pallas serving launched another kernel: {counts}")
    check(all(len(r.tokens) == PALLAS_NEW for r in reqs), "pallas tokens")
    print(f"pallas engine: {len(reqs)} requests x {PALLAS_NEW} tokens, "
          f"launches {counts}; decode step (host clock, {steps} steps) "
          f"{dt / steps * 1e3:.2f} ms")
    k_ms, rows = served_kernel_ms(srv, model, per_pass)
    print(f"pallas engine: kernel 4 in one decode step, its {per_pass} "
          f"calls (M = {rows}) in the served order (CUDA events, host "
          f"included): {k_ms:.3f} ms")
    return launches


def served_kernel_ms(srv, model, per_pass: int):
    """Kernel 4's calls of one decode step with 8 requests, recorded as
    the server makes them and run again in that order: (ms, the calls'
    row counts), the served measure of the kernel, host cost included
    (phase 6's ``fused kernel`` for kernel 3).  Runs after the phase's
    launch count was read."""
    from repro_torch.kernels import cim_matmul as cm
    rng = np.random.default_rng(10)
    reqs = [srv.submit(rng.integers(0, model.cfg.vocab_size, size=20), 4)
            for _ in range(LM_SLOTS)]
    srv.step()                       # admit all 8, one decode step
    calls, real = [], cm.cim_matmul

    def recording(x_q, w_q, cfg=cm.IDEAL):
        calls.append((x_q, w_q, cfg))
        return real(x_q, w_q, cfg)

    cm.cim_matmul = recording
    try:
        srv.step()
    finally:
        cm.cim_matmul = real
    srv.drain()
    check(len(calls) == per_pass and all(r.done for r in reqs),
          f"recorded {len(calls)} kernel-4 calls, not {per_pass}")
    with torch.no_grad():
        return time_ms(lambda: [real(*a) for a in calls], 5), sorted(
            {x.shape[0] for x, _, _ in calls})


def phase_lm_cpu(model, params, srv):
    """Layer 0 of one decode step on the card, replayed on the CPU."""
    from repro_torch import bridge
    from repro_torch.core import rebranch as rebranch_lib
    from repro_torch.kernels import rebranch_matmul as rm
    from repro_torch.models import layers

    rng = np.random.default_rng(10)
    rs = [srv.submit(rng.integers(0, model.cfg.vocab_size, size=n), 4)
          for n in (5, 17, 33)]
    srv.step()                                   # admit; one decode step
    while srv.batcher.prefilling:                # the 33-token prompt's
        srv.step()                               # second chunk
    linears, attn = [], []
    apply_linear, apply_attention = rebranch_lib.apply_linear, \
        layers.apply_attention

    def rec_linear(p, x, spec):
        y = apply_linear(p, x, spec)
        if len(linears) < 7:
            linears.append((p, x, spec, y))
        return y

    def rec_attention(p, x, cfg, layer_idx, positions=None, cache=None,
                      decode=False):
        before = {k: v.clone() for k, v in cache.items()}
        y, nc = apply_attention(p, x, cfg, layer_idx, positions, cache,
                                decode)
        if not attn:
            attn.append((p, x, cfg, before, y))
        return y, nc

    live = sorted(srv.batcher._active)           # rows with a request
    rebranch_lib.apply_linear = rec_linear
    layers.apply_attention = rec_attention
    try:
        srv.step()
    finally:
        rebranch_lib.apply_linear = apply_linear
        layers.apply_attention = apply_attention
    srv.drain()
    check(len(linears) == 7 and len(attn) == 1, "layer-0 recording")
    check(len(live) == len(rs), f"replay rows {live}")

    def cpu(tree):
        return bridge.tree_map(tree, lambda t: t.detach().cpu())

    worst = 0.0
    names = ("q", "k", "v", "o", "gate", "up", "down")
    for name, (p, x, spec, y) in zip(names, linears):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        with torch.no_grad():
            trunk, _ = rm.rebranch_trunk_sketch(x2, p["rom"]["w_q"],
                                                p["rom"]["C"])
            ref_trunk, _ = rm.rebranch_matmul_plain(
                x2.cpu(), p["rom"]["w_q"].cpu(), p["rom"]["C"].cpu())
            ref = apply_linear(cpu(p), x.cpu(), spec)
        check(torch.equal(trunk.cpu(), ref_trunk),
              f"layer 0 {name}: card trunk != CPU trunk")
        amax = ref.abs().max().item()
        diff = (ref.float() - y.cpu().float()).abs().max().item()
        worst = max(worst, diff / bf16_ulp(amax))
        print(f"layer 0 {name}: trunk equal, output max abs diff "
              f"{diff:.3e} = {diff / bf16_ulp(amax):.2f} bf16 ulp at the "
              f"absmax {amax:.3e}")
        check(diff <= bf16_ulp(amax), f"layer 0 {name} off by more than one "
              f"bf16 ulp at its absmax")
    # attention: the live rows only.  Free rows all write their (never
    # read) K/V into the one trash block, and which duplicate write lands
    # differs between the card's scatter and the CPU's, so their own
    # garbage outputs differ too.
    p, x, cfg, before, y = attn[0]
    with torch.no_grad():
        ref, _ = apply_attention(cpu(p), x.cpu(), cfg, 0, cache=cpu(before),
                                 decode=True)
    ref, y = ref[live], y[live]
    amax = ref.abs().max().item()
    diff = (ref.float() - y.cpu().float()).abs().max().item()
    print(f"layer 0 attention, live rows {live}: output max abs diff "
          f"{diff:.3e} = "
          f"{diff / bf16_ulp(amax):.2f} bf16 ulp at the absmax {amax:.3e}")
    check(diff <= bf16_ulp(amax),
          "layer 0 attention off by more than one bf16 ulp at its absmax")
    check(all(len(r.tokens) == 4 for r in rs), "replay requests")


ADC_MODES = ("per_subarray", "bitserial")
ADC_ROWS = 4096          # bitserial: rows of each P held against the plain
# f32 operations of one ADC evaluation that no design avoids: per_subarray
# the division, + bias, rint, the two clamps, * lsb and the add; bitserial
# the accumulate's multiply (code * (lsb * coef)) and add, its code and lsb
# coming from a table
ADC_F32_OPS = {"per_subarray": 7, "bitserial": 2}
# binary (.b1 .and.popc) multiply-accumulates per second of mma.sync on an
# NVIDIA H100 80GB HBM3 at 700 W, measured by scripts/bitcount_ab.py; above
# the int8 tensor cores' 989.5e12 (1979e12 operations)
B1_MACS = 1.5905e15
ADC_SUSTAINED_CHUNKS = 16
LM_ADC_LAYERS = 2        # phase 11's Gemma-2B depth cut
LM_ADC_PROMPTS, LM_ADC_NEW = (10, 30, 60, 90), 16
LM_BITSERIAL_NEW = 6


def adc_bound_ms(m: int, k: int, n: int, mode: str, x_bytes: float = 4.0,
                 cdim: int = 0, x_elems: int | None = None
                 ) -> tuple[float, str]:
    """(bound, what bounds it) of one trunk launch in an ADC mode: x [m, k]
    (``x_bytes`` per element; or ``x_elems`` elements, a conv's NHWC
    input), W int8 [k, n] -> f32 [m, n] (and, with ``cdim``, the f32 sketch
    x @ C [k, cdim]).  Bytes: each input read once, each output written
    once.  Operations, the least work of the mode: per_subarray, the int8
    multiply-adds at the int8 tensor-core rate and ADC_F32_OPS f32
    operations per ADC evaluation (one per row, column and subarray);
    bitserial, 112 binary multiply-adds per int8 one (4 sign pairs x 4
    activation groups x 7 weight planes, each counted once, though a 2-bit
    group takes two one-bit passes) at the higher of the int8 rate and the
    measured binary rate (B1_MACS), and the accumulate's f32 multiply and
    add per ADC evaluation (112 per row, column and subarray); the sketch's
    f32 multiply-adds.  A lower bound for the binary-MMA, table-ADC kernel
    as for the earlier popcount and division one."""
    subarrays = -(-k // 128)
    if mode == "bitserial":
        macs_ms = 112.0 * m * k * n / max(PEAK_INT8_OPS / 2, B1_MACS)
        evals = 112 * m * n * subarrays
    else:
        macs_ms = 2.0 * m * k * n / PEAK_INT8_OPS
        evals = m * n * subarrays
    ops_ms = (macs_ms + (ADC_F32_OPS[mode] * evals + 2.0 * m * k * cdim)
              / PEAK_F32_OPS) * 1e3
    x_total = x_bytes * (m * k if x_elems is None else x_elems)
    nbytes = x_total + k * n + 4.0 * m * n + 4.0 * (k * cdim + m * cdim)
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def new_tot():
    return {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
            "max_abs_err": 0.0, "library_ms": None}


def add_tot(tot, ms, plain_ms, bound, by, count=1, bound_p=None):
    """Add ``count`` launches to a kernel's totals (``bytes_ms`` sums the
    bounds of the bytes-bound ones, as phases 2 and 5 do; ``bound_p`` the
    trunk conv's bound with P's bytes)."""
    tot["ms"] += ms * count
    tot["plain_ms"] += plain_ms * count
    tot["bound_ms"] += bound * count
    tot["bytes_ms"] += bound * count if by == "bytes" else 0.0
    if bound_p is not None:
        tot["bound_p_ms"] = tot.get("bound_p_ms", 0.0) + bound_p * count


def time_once_ms(fn) -> float:
    """Device time of one call of ``fn`` (already warmed by the caller),
    from CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def phase_adc_kernels(dev, cfg) -> dict:
    """Kernels 1, 3 and 4 in the ADC modes vs their plain versions."""
    from repro_torch.core import cim
    from repro_torch.kernels import cim_matmul as cm
    from repro_torch.kernels import ops
    from repro_torch.kernels import rebranch_conv as rc
    from repro_torch.kernels import rebranch_matmul as rm
    from repro_torch.models import cnn
    out = {(name, mode): new_tot() for name in ("trunk_conv",
                                                "rebranch_matmul",
                                                "cim_matmul")
           for mode in ADC_MODES}
    ps = cim.CiMConfig(mode="per_subarray")
    bs = cim.CiMConfig(mode="bitserial")

    # kernel 1 at every DarkNet-19 geometry, on phase 2's inputs
    gen = torch.Generator(device=dev).manual_seed(1)
    print("site M R N mode equal ms plain_ms bound_ms bound_by bound_p_ms "
          "(bitserial: rows_checked)")
    for site, k, c_in, c_out, hw, _ in cnn.conv_site_shapes(cfg):
        x = torch.randn((BATCH, hw, hw, c_in), generator=gen, device=dev)
        w_q = torch.randint(-127, 128, (k, k, c_in, c_out), generator=gen,
                            device=dev, dtype=torch.int8)
        m, r = BATCH * hw * hw, k * k * c_in

        got = rc.trunk_conv_dot(x, w_q, cfg=ps)
        want = plain_trunk(x, w_q, ps)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"{site}: per_subarray kernel trunk != plain trunk (max "
              f"{(got - want).abs().max().item()})")
        del got, want
        ms = time_ms(lambda: rc.trunk_conv_dot(x, w_q, cfg=ps), 3)
        plain_ms = time_ms(lambda: plain_trunk(x, w_q, ps), 2)
        bound, by = adc_bound_ms(m, r, c_out, "per_subarray",
                                 x_elems=x.numel())
        bound_p, _ = adc_bound_ms(m, r, c_out, "per_subarray")
        add_tot(out["trunk_conv", "per_subarray"], ms, plain_ms, bound, by,
                bound_p=bound_p)
        print(f"{site} {m} {r} {c_out} per_subarray True {ms:.4f} "
              f"{plain_ms:.4f} {bound:.4f} {by} {bound_p:.4f}", flush=True)

        # bitserial: the kernel on all of x, its first rows vs the plain
        # version on those rows of P (rows are independent)
        got = rc.trunk_conv_dot(x, w_q, cfg=bs)
        rows = min(m, ADC_ROWS)
        p, _ = rc.patch_matrix(x, k, k, 1, "SAME")
        p_rows = p[:rows].contiguous()
        w2d = w_q.reshape(-1, c_out)
        want = rc.trunk_patch_dot_plain(p_rows, w2d, bs)
        torch.cuda.synchronize()
        check(torch.equal(got[:rows], want),
              f"{site}: bitserial kernel trunk != plain trunk on its first "
              f"{rows} rows (max {(got[:rows] - want).abs().max().item()})")
        check(bool(torch.isfinite(got).all()), f"{site}: bitserial non-finite")
        del got, want, p_rows
        ms = time_ms(lambda: rc.trunk_conv_dot(x, w_q, cfg=bs), 3)
        plain_ms = time_once_ms(lambda: rc.trunk_patch_dot_plain(p, w2d, bs))
        bound, by = adc_bound_ms(m, r, c_out, "bitserial", x_elems=x.numel())
        bound_p, _ = adc_bound_ms(m, r, c_out, "bitserial")
        add_tot(out["trunk_conv", "bitserial"], ms, plain_ms, bound, by,
                bound_p=bound_p)
        print(f"{site} {m} {r} {c_out} bitserial True {ms:.4f} "
              f"{plain_ms:.4f} {bound:.4f} {by} {bound_p:.4f} {rows}",
              flush=True)
        del p, x
        torch.cuda.empty_cache()
    for mode in ADC_MODES:
        t = out["trunk_conv", mode]
        print(f"trunk_conv[{mode}] per forward (20 launches): kernel "
              f"{t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, bound "
              f"{t['bound_ms']:.3f} ms (NHWC; with P's bytes "
              f"{t['bound_p_ms']:.3f} ms)")

    # ops.cim_conv (im2col + kernel 4) at one DarkNet-19 geometry, in its
    # default config (per_subarray), int8 activations with -128
    site, k, c_in, c_out, hw, _ = cnn.conv_site_shapes(cfg)[8]
    xq = torch.randint(-128, 128, (BATCH, hw, hw, c_in), generator=gen,
                       device=dev, dtype=torch.int8)
    xq[0, 0, 0] = -128
    w_q = torch.randint(-127, 128, (k, k, c_in, c_out), generator=gen,
                        device=dev, dtype=torch.int8)
    before = cm.launches
    got = ops.cim_conv(xq, w_q)
    check(cm.launches == before + 1, "cim_conv did not launch kernel 4")
    p, _ = rc.patch_matrix(xq, k, k, 1, "SAME")
    want = cm.cim_matmul_plain(p, w_q.reshape(-1, c_out), ps)
    check(torch.equal(got.reshape(want.shape), want),
          f"{site}: cim_conv != cim_matmul_plain on the patch matrix")
    print(f"cim_conv at {site} ({BATCH}x{hw}x{hw}x{c_in} -> {c_out}, "
          f"default per_subarray): equal to cim_matmul_plain on the patch "
          f"matrix")
    del xq, p, got, want

    # kernels 3 and 4 at Gemma-2B's geometries: both modes at M = 8 (and
    # M = 1 rows); bitserial also at M = 1, 16 and 128, under its plan
    gen = torch.Generator(device=dev).manual_seed(5)
    print("kernel mode K N M equal ms plain_ms bound_ms bound_by "
          "[device_ms]")
    for (k, n), per_layer in LM_GEOMS.items():
        cdim = k // 4
        x_all = torch.randn((max(LM_ROWS), k), generator=gen, device=dev
                            ).to(torch.bfloat16)
        xq_all = torch.randint(-128, 128, (max(LM_ROWS), k), generator=gen,
                               device=dev, dtype=torch.int8)
        xq_all[0, ::7] = -128                   # -128 activations
        x, xq = x_all[:LM_SLOTS], xq_all[:LM_SLOTS]
        copies = max(1, math.ceil(2.5 * L2_BYTES / (k * n + 4 * k * cdim)))
        ws = [torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(copies)]
        cs = [torch.randn((k, cdim), generator=gen, device=dev) / k ** .5
              for _ in range(copies)]
        w, c = ws[0], cs[0]
        count = per_layer * LM_LAYERS             # per full-depth step
        for mode, cfg_m in (("per_subarray", ps), ("bitserial", bs)):
            trunk, t1 = rm.rebranch_trunk_sketch(x, w, c, cfg_m)
            want_trunk, want_t1 = rm.rebranch_matmul_plain(x, w, c, cfg_m)
            got4 = cm.cim_matmul(xq, w, cfg_m)
            want4 = cm.cim_matmul_plain(xq, w, cfg_m)
            torch.cuda.synchronize()
            check(torch.equal(trunk, want_trunk),
                  f"{mode} rebranch kernel trunk != plain ({k}x{n})")
            rel = ((t1 - want_t1).abs().max() / want_t1.abs().max()).item()
            check(rel <= SKETCH_RTOL, f"{mode} sketch off by {rel}")
            check(torch.equal(got4, want4),
                  f"{mode} cim_matmul kernel != plain ({k}x{n})")
            one3 = rm.rebranch_trunk_sketch(x[:1].contiguous(), w, c, cfg_m)
            one4 = cm.cim_matmul(xq[:1].contiguous(), w, cfg_m)
            check(torch.equal(one3[0], trunk[:1])
                  and torch.equal(one3[1], t1[:1])
                  and torch.equal(one4, got4[:1]),
                  f"{mode}: row 0 differs between M = 1 and M = 8 ({k}x{n})")
            if mode == "bitserial":
                lm_bitserial_rows(x_all, xq_all, w, c, bs, one3, one4)
            args3 = [(x, wi, ci, cfg_m) for wi, ci in zip(ws, cs)]
            args4 = [(xq, wi, cfg_m) for wi in ws]
            # eager, host included, as phase 5's ms; and device time
            # (graph replay), as phase 5's device_ms
            ms3 = time_cycled_ms(rm.rebranch_trunk_sketch, args3, copies)
            ms4 = time_cycled_ms(cm.cim_matmul, args4, copies)
            dev3 = time_graph_ms(rm.rebranch_trunk_sketch, args3, copies)
            dev4 = time_graph_ms(cm.cim_matmul, args4, copies)
            for name, d in (("rebranch_matmul", dev3), ("cim_matmul", dev4)):
                t = out[name, mode]
                t["device_ms"] = t.get("device_ms", 0.0) + d * count
            plain3 = time_once_ms(
                lambda: rm.rebranch_matmul_plain(x, w, c, cfg_m))
            plain4 = time_once_ms(lambda: cm.cim_matmul_plain(xq, w, cfg_m))
            b3, by3 = adc_bound_ms(LM_SLOTS, k, n, mode, 4.0, cdim)
            b4, by4 = adc_bound_ms(LM_SLOTS, k, n, mode, 1.0)
            add_tot(out["rebranch_matmul", mode], ms3, plain3, b3, by3, count)
            add_tot(out["cim_matmul", mode], ms4, plain4, b4, by4, count)
            out["rebranch_matmul", mode]["max_abs_err"] = max(
                out["rebranch_matmul", mode]["max_abs_err"],
                (t1 - want_t1).abs().max().item())
            print(f"rebranch_matmul {mode} {k} {n} {LM_SLOTS} True "
                  f"{ms3:.4f} {plain3:.4f} {b3:.4f} {by3} {dev3:.4f}")
            print(f"cim_matmul {mode} {k} {n} {LM_SLOTS} True {ms4:.4f} "
                  f"{plain4:.4f} {b4:.4f} {by4} {dev4:.4f}", flush=True)
            del trunk, t1, want_trunk, want_t1, got4, want4
        del ws, cs
        torch.cuda.empty_cache()
    for (name, mode), t in out.items():
        if name != "trunk_conv":
            dev_txt = (f" (device, graph replay: {t['device_ms']:.3f} ms)"
                       if "device_ms" in t else "")
            print(f"{name}[{mode}] per Gemma-2B decode step at M = "
                  f"{LM_SLOTS} ({7 * LM_LAYERS} launches): kernel "
                  f"{t['ms']:.3f} ms{dev_txt}, plain {t['plain_ms']:.3f} "
                  f"ms, bound {t['bound_ms']:.3f} ms")
    return out


def lm_bitserial_rows(x_all, xq_all, w, c, bs, one3, one4):
    """Kernels 3 and 4 in bitserial at one Gemma-2B geometry and M = 1,
    16 and 128 (M = 8 is phase 9's main check): torch.equal to the plain
    versions under the plan ``tiling.split_plan`` hands them (printed),
    and row 0 equal to the M = 1 launch's (``one3``, ``one4``)."""
    from repro_torch.kernels import cim_matmul as cm
    from repro_torch.kernels import rebranch_matmul as rm
    from repro_torch.kernels import tiling
    k, n = w.shape
    for m in (1, 16, 128):
        x, xq = x_all[:m].contiguous(), xq_all[:m].contiguous()
        trunk, t1 = rm.rebranch_trunk_sketch(x, w, c, bs)
        got4 = cm.cim_matmul(xq, w, bs)
        want_trunk, want_t1 = rm.rebranch_matmul_plain(x, w, c, bs)
        want4 = cm.cim_matmul_plain(xq, w, bs)
        torch.cuda.synchronize()
        check(torch.equal(trunk, want_trunk) and torch.equal(got4, want4),
              f"bitserial kernels != plain at M = {m} ({k}x{n})")
        rel = ((t1 - want_t1).abs().max() / want_t1.abs().max()).item()
        check(rel <= SKETCH_RTOL, f"bitserial sketch off by {rel} at M = {m}")
        check(torch.equal(trunk[:1], one3[0]) and torch.equal(t1[:1], one3[1])
              and torch.equal(got4[:1], one4),
              f"bitserial: row 0 differs between M = 1 and M = {m} "
              f"({k}x{n})")
        sp = tiling.split_plan(m, n, k, "bitserial")
        print(f"bitserial {k} {n} M = {m}: kernels 3 and 4 equal to plain, "
              f"row 0 equal to M = 1's; plan: tile height {sp.tile_m}, "
              f"{sp.tiles} tiles x {sp.n_splits} splits of "
              f"{sp.kb_per_split} k-block(s)", flush=True)


def adc_plan(cfg, mode: str, engine: str = "pallas_fused"):
    """The solved all-ROM plan with every ROM site in CiM ``mode``: one
    override on each top-level address of the site tree, which the
    longest-prefix resolution hands down to every site below it."""
    from repro_torch import plan as plan_lib
    base = plan_lib.solve(cfg, engine=engine)
    tops = sorted({a.split(".")[0]
                   for a in plan_lib.valid_addresses(plan_lib.site_tree(cfg))})
    overrides = dict(base.entries)
    overrides.update({a: {"cim": mode} for a in tops})
    return plan_lib.PlacementPlan.build(cfg, overrides, default=base.default)


def head_drift(head, ideal) -> float:
    """examples/yolo_cim_conv.py's measure: mean |head - ideal head| as a
    share of the ideal head's std."""
    return float(np.abs(head - ideal).mean() / (ideal.std() + 1e-9))


def phase_adc_serve(cfg, ideal_model, params, images) -> dict:
    """DarkNet-19 served at the paper's ADC fidelity: per_subarray at every
    site (the requests, pad rows, a sustained window, the CPU replay),
    then bitserial (one request)."""
    from repro_torch.kernels import rebranch_conv as rc
    from repro_torch.models import cnn
    from repro_torch.serve import registry, server

    with torch.no_grad():
        ideal = ideal_model.forward(params, torch.from_numpy(images).cuda()
                                    ).cpu().numpy()
    rng = np.random.default_rng(11)
    launches = {}
    for mode, model_id in (("per_subarray", "darknet19-416-adc"),
                           ("bitserial", "darknet19-416-bitserial")):
        registry.register(registry.ModelEntry(
            model_id=model_id, config=lambda: cfg,
            plan=lambda c, mode=mode: adc_plan(c, mode)))
        model, _ = registry.compile_entry(model_id)
        sites = [s[0] for s in cnn.conv_site_shapes(model.cfg)]
        for site in sites:
            spec = model.layer_spec(site)
            check(spec.enabled and spec.branch_enabled
                  and spec.trunk_impl == "pallas_fused"
                  and spec.cim.mode == mode,
                  f"{model_id} {site}: not a ROM pallas_fused {mode} site")
        srv = server.load(model_id, params=params, n_slots=SLOTS)
        n_sites = len(sites)
        if mode == "per_subarray":
            srv.submit(images)                           # warm-up
            torch.cuda.synchronize()
            reset_launches()
            lo, outs = 0, []
            extra = rng.standard_normal((sum(REQUESTS), SIZE, SIZE, 3),
                                        dtype=np.float32)
            for b in REQUESTS:
                t0 = time.perf_counter()
                outs.append(srv.submit(extra[lo:lo + b]))
                dt = time.perf_counter() - t0
                print(f"{model_id}: request of {b} images, latency "
                      f"{dt * 1e3:.2f} ms")
                lo += b
            counts = read_launches()
            chunks = sum(-(-b // SLOTS) for b in REQUESTS)
            check(counts["trunk_conv"] == n_sites * chunks
                  and counts["cim_matmul"] == counts["rebranch_matmul"] == 0,
                  f"{model_id}: expected {n_sites} trunk launches per chunk, "
                  f"got {counts} for {chunks} chunks")
            launches["trunk_conv", mode] = counts["trunk_conv"]
            for b, out in zip(REQUESTS, outs):
                check(out.shape == (b, SIZE // 32, SIZE // 32, 5, 25)
                      and bool(np.isfinite(out).all()),
                      f"{model_id}: output {out.shape} or non-finite")
            short = extra[sum(REQUESTS[:-1]):]
            full = srv.submit(np.concatenate([short,
                                              extra[:SLOTS - len(short)]]))
            check(np.array_equal(full[:len(short)], outs[-1]),
                  f"{model_id}: pad rows changed a real row")
            print(f"{model_id}: {n_sites} launches per chunk; pad rows "
                  f"invisible ({len(short)}-image request bitwise equal to "
                  f"the same rows of a full chunk)")
            n_img = ADC_SUSTAINED_CHUNKS * SLOTS
            batch = rng.standard_normal((n_img, SIZE, SIZE, 3),
                                        dtype=np.float32)
            rates = []
            for run in range(SUSTAINED_RUNS):
                before = rc.launches
                t0 = time.perf_counter()
                out = srv.submit(batch)
                dt = time.perf_counter() - t0
                check(rc.launches - before == n_sites * ADC_SUSTAINED_CHUNKS
                      and bool(np.isfinite(out).all()),
                      f"{model_id}: sustained window")
                rates.append(n_img / dt)
                print(f"{model_id} sustained run {run}: {n_img} images in "
                      f"{dt * 1e3:.2f} ms, {n_img / dt:.2f} images/s")
            spread = (max(rates) - min(rates)) / min(rates)
            print(f"{model_id} sustained images/s: mean "
                  f"{sum(rates) / len(rates):.2f}, min {min(rates):.2f}, "
                  f"max {max(rates):.2f}, spread {spread:.2%}")
        else:
            srv.submit(images[:1])                      # warm-up
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            out = srv.submit(images)
            dt = time.perf_counter() - t0
            counts = read_launches()
            check(counts["trunk_conv"] == n_sites
                  and counts["cim_matmul"] == counts["rebranch_matmul"] == 0,
                  f"{model_id}: expected {n_sites} trunk launches, got "
                  f"{counts}")
            check(bool(np.isfinite(out).all()), f"{model_id}: non-finite")
            launches["trunk_conv", mode] = counts["trunk_conv"]
            print(f"{model_id}: one request of {len(images)} images in "
                  f"{dt * 1e3:.2f} ms ({len(images) / dt:.2f} images/s), "
                  f"{n_sites} launches")
        x = torch.from_numpy(images).cuda()
        reps = 5 if mode == "per_subarray" else 1
        with torch.no_grad():
            fwd_ms = time_ms(lambda: model.forward(params, x), reps)
            ideal_ms = time_ms(lambda: ideal_model.forward(params, x), reps)
        print(f"{model_id}: device forward of a {len(images)}-image chunk "
              f"{fwd_ms:.3f} ms, ideal {ideal_ms:.3f} ms (CUDA events)")
        del x
        head = srv.submit(images)
        print(f"{model_id}: mean |head - ideal head| = "
              f"{head_drift(head, ideal):.4f} of the ideal head's std "
              f"(the same {len(images)} images and parameters)")
        if mode == "per_subarray":
            phase_cpu(model, params, images[:1])
        del srv
        torch.cuda.empty_cache()
    return launches


def lm_adc_config():
    """Gemma-2B at full width, its depth cut to LM_ADC_LAYERS layers."""
    return dataclasses.replace(lm_config(), num_layers=LM_ADC_LAYERS)


def lm_serve_check(model_id, params, kernel, prompts, n_new, solo) -> int:
    """Serve ``prompts`` through ``model_id``; check the launches of
    ``kernel`` per prefill and per decode step, the tokens, and ``solo``
    requests against a solo run on the card (tokens and first decode
    step's logits, bit for bit).  Returns the launch count."""
    from repro_torch.serve import registry, server

    model, _ = registry.compile_entry(model_id)
    srv = server.load(model_id, params=params, n_slots=LM_SLOTS,
                      max_len=LM_MAX_LEN)
    rng = np.random.default_rng(12)
    vocab = model.cfg.vocab_size
    srv.submit(rng.integers(0, vocab, size=9), 2)          # warm-up
    srv.drain()
    first_logits = {}
    decode = model.decode_step

    def recording(p, tok, cache):
        logits, cache = decode(p, tok, cache)
        for slot, req in srv.batcher._active.items():
            if len(req.tokens) == 1:
                first_logits[req.rid] = logits[slot, -1].float().cpu()
        return logits, cache

    toks_in = [rng.integers(0, vocab, size=n) for n in prompts]
    torch.cuda.synchronize()
    reset_launches()
    model.decode_step = recording
    t0 = time.perf_counter()
    reqs = [srv.submit(p, n_new) for p in toks_in]
    steps = srv.drain()
    wall = time.perf_counter() - t0
    del model.decode_step
    counts = read_launches()
    per_pass = 7 * model.cfg.num_layers
    chunks = prefill_calls(toks_in, srv.batcher.prefill_chunk)
    check(counts[kernel] == per_pass * (chunks + steps)
          and sum(counts.values()) == counts[kernel],
          f"{model_id}: expected {per_pass} {kernel} launches per prefill "
          f"chunk and decode step, got {counts} for {chunks} chunks + "
          f"{steps} steps")
    for r in reqs:
        check(len(r.tokens) == n_new and all(0 <= t < vocab
                                             for t in r.tokens),
              f"{model_id} request {r.rid}: tokens {r.tokens}")
    print(f"{model_id}: {len(reqs)} requests x {n_new} tokens in "
          f"{wall * 1e3:.1f} ms, {steps} decode steps "
          f"({wall / max(steps, 1) * 1e3:.2f} ms per step, prefills "
          f"included); {per_pass} {kernel} launches per pass ({counts})")
    for r, p in list(zip(reqs, toks_in))[:solo]:
        toks, first = _solo_run(model, params, p, n_new, LM_MAX_LEN)
        diff = (first - first_logits[r.rid]).abs().max().item()
        check(toks == r.tokens and diff == 0.0,
              f"{model_id} request {r.rid}: batched != solo on the card "
              f"(logits diff {diff})")
        print(f"{model_id} request {r.rid}: batched == solo on the card "
              f"({n_new}/{n_new} tokens, first decode step logits equal)")
    check(srv.pool.blocks_in_use == 0, f"{model_id}: blocks leaked")
    return counts[kernel]


def phase_lm_adc() -> dict:
    """Gemma-2B through LMServer at ADC fidelity.  The depth is cut to
    LM_ADC_LAYERS (2) layers at full width, so that the phase stays short:
    kernels 3 and 4 see every linear geometry of the full model, and 14
    launches per prefill and per decode step.  per_subarray at every ROM
    site under pallas_fused (kernel 3) and pallas (kernel 4), four
    requests x 16 tokens, one request against its solo run; then
    bitserial under both engines, four requests x 6 tokens, one request
    against its solo run."""
    from repro_torch.serve import registry

    for mode, fused_id, pallas_id in (
            ("per_subarray", "gemma-2b-adc", "gemma-2b-adc-pallas"),
            ("bitserial", "gemma-2b-bitserial", "gemma-2b-bitserial-pallas")):
        registry.register(registry.ModelEntry(
            model_id=fused_id, config=lm_adc_config,
            plan=lambda c, mode=mode: adc_plan(c, mode)))
        registry.register(registry.ModelEntry(
            model_id=pallas_id, config=lm_adc_config,
            plan=lambda c, mode=mode: adc_plan(c, mode, "pallas")))
    model, _ = registry.compile_entry("gemma-2b-adc")
    for site in ("blocks.attn", "blocks.mlp"):
        spec = model.layer_spec(site)
        check(spec.enabled and spec.trunk_impl == "pallas_fused"
              and spec.cim.mode == "per_subarray",
              f"gemma-2b-adc {site}: {spec}")
    params = with_cores(model.init(seed=0), torch.Generator().manual_seed(2))
    launches = {}
    launches["rebranch_matmul", "per_subarray"] = lm_serve_check(
        "gemma-2b-adc", params, "rebranch_matmul", LM_ADC_PROMPTS,
        LM_ADC_NEW, solo=1)
    launches["cim_matmul", "per_subarray"] = lm_serve_check(
        "gemma-2b-adc-pallas", params, "cim_matmul", LM_ADC_PROMPTS,
        LM_ADC_NEW, solo=1)
    launches["rebranch_matmul", "bitserial"] = lm_serve_check(
        "gemma-2b-bitserial", params, "rebranch_matmul", LM_ADC_PROMPTS,
        LM_BITSERIAL_NEW, solo=1)
    launches["cim_matmul", "bitserial"] = lm_serve_check(
        "gemma-2b-bitserial-pallas", params, "cim_matmul",
        LM_ADC_PROMPTS, LM_BITSERIAL_NEW, solo=1)
    return launches


# ---------------------------------------------------------------------------
# phases 12-14: tape-out, the cost model, scenario hot-swap
# ---------------------------------------------------------------------------

SWAP_ORDER = ("A", "B", "C", "A")   # phase 13; store capacity 2
SWAP_SEEDS = {"A": 21, "B": 22, "C": 23}
LM_SWAP_PROMPTS = {"A": (12, 40, 7, 100), "B": (25, 60, 9, 33)}
LM_SWAP_NEW = 16


def scenario_branch(base, seed: int):
    """A scenario's branch drawn from ``seed`` over the shape of ``base``
    (a branch tree): ReBranch cores N(0, 0.05), BN variances raised by
    0.1 |N(0, 1)|, every other leaf (BN scale, bias and mean, the heads,
    norm scales) moved by 0.02 N(0, 1).  On the CPU."""
    from repro_torch import bridge
    gen = torch.Generator().manual_seed(seed)

    def leaf(name, t):
        noise = torch.randn(t.shape, generator=gen)
        if name.endswith("['core']"):
            return (noise * 0.05).to(t.dtype)
        if name.endswith("['var']"):
            return t.cpu() + 0.1 * noise.abs()
        return (t.cpu().float() + 0.02 * noise).to(t.dtype)

    return bridge.map_named(base, leaf)


def trunk_objects(params) -> dict:
    """The ROM side of a params tree: keystr name -> tensor."""
    from repro_torch import bridge
    from repro_torch.core import rebranch
    return bridge.flatten(rebranch.partition(params)[1])


def same_trunk(params, trunk: dict, ptrs: dict) -> bool:
    """Every trunk tensor of ``params`` is the very object in ``trunk``,
    at the same device address."""
    now = trunk_objects(params)
    return now.keys() == trunk.keys() and all(
        now[k] is t and t.data_ptr() == ptrs[k] for k, t in trunk.items())


def gib() -> float:
    return torch.cuda.memory_allocated() / 2**30


def phase_tapeout(cfg, dev, smi: str):
    """Tape-out of dense DarkNet-19 weights at 416 on the card and on the
    CPU: every w_q / w_scale equal, the ROM fingerprint of the card tree
    equal to its CPU copy's and to the CPU tape-out's; then the 28 nm cost
    model's ratios for the four paper models from the port's counts."""
    from repro_torch import bridge, netstats
    from repro_torch.core import energy, rom
    from repro_torch.core.rebranch import ReBranchSpec
    from repro_torch.models import cnn

    dense_cfg = dataclasses.replace(
        cfg, rebranch=dataclasses.replace(cfg.rebranch, enabled=False))
    init_fn, _ = cnn.MODEL_REGISTRY[cfg.name]
    dense = init_fn(torch.Generator().manual_seed(11), dense_cfg)
    spec = ReBranchSpec()
    dense_dev = bridge.tree_map(dense, lambda t: t.to(dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = cnn.freeze_to_rom(dense_dev, torch.Generator().manual_seed(12),
                             spec)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = cnn.freeze_to_rom(dense, torch.Generator().manual_seed(12), spec)
    t_host = time.perf_counter() - t0
    got, want = bridge.flatten(card), bridge.flatten(host)
    check(got.keys() == want.keys(), "tape-out trees differ in structure")
    n_conv = 0
    for name, t in got.items():
        if name.endswith(("['w_q']", "['w_scale']")):
            check(t.device.type == dev.type, f"{name} left the card")
            check(torch.equal(t.cpu(), want[name]),
                  f"tape-out {name}: card != CPU")
            n_conv += name.endswith("['w_q']")
    t0 = time.perf_counter()
    fp_card = rom.rom_fingerprint(card)
    t_fp = time.perf_counter() - t0
    fp_copy = rom.rom_fingerprint(bridge.tree_map(card, lambda t: t.cpu()))
    fp_host = rom.rom_fingerprint(host)
    check(fp_card == fp_copy == fp_host,
          f"ROM fingerprints differ: card {fp_card[:16]}, its CPU copy "
          f"{fp_copy[:16]}, CPU tape-out {fp_host[:16]}")
    print(f"tape-out of dense darknet19-416: {n_conv} convs frozen, every "
          f"w_q and w_scale equal on the card and the CPU; card "
          f"{t_card * 1e3:.1f} ms, CPU {t_host * 1e3:.1f} ms, fingerprint "
          f"{t_fp * 1e3:.1f} ms [{smi}]")
    print(f"ROM fingerprint {fp_card} (card == its CPU copy == CPU "
          f"tape-out); rom_bytes {rom.rom_bytes(card)}, sram_bytes "
          f"{rom.sram_bytes(card)}")
    del dense_dev, card
    stats = netstats.paper_net_stats()
    print("28 nm cost model outputs (a model of the paper's chip, not a "
          "measurement of any device), from the port's own counts:")
    for name, ns in stats.items():
        lat = energy.yoloc_latency(ns)
        print(f"  {name}: params {ns.params}, MACs {ns.macs}, activation "
              f"bits {ns.act_bits_moved}; energy efficiency vs iso-area "
              f"SRAM-CiM {energy.efficiency_ratio(ns):.3f}x, area ratio vs "
              f"all-SRAM {energy.area_ratio(ns):.3f}x, YOLoC latency "
              f"{lat['total']:.4f} ms (branch overhead "
              f"{lat['overhead_frac']:.1%})")
    ratio = energy.efficiency_ratio(stats["darknet19"])
    check(abs(ratio - 14.8) / 14.8 < 0.15,
          f"darknet19 efficiency ratio {ratio} is not the paper's 14.8x")


def phase_cnn_swap(model, params, images, smi: str) -> int:
    """Scenario hot-swap at full width on the phase-3 model: three
    scenarios written with save_branch, registered from ckpt_dir= in a
    ScenarioStore of capacity 2, swapped A, B, C, A with one 8-image chunk
    served after each swap.  Returns kernel 1's launches over the chunks."""
    import tempfile

    from repro_torch import bridge, deploy, scenario
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.core import rebranch, rom
    from repro_torch.models import cnn
    from repro_torch.serve import registry, server

    _, plan = registry.compile_entry("darknet19-416")
    trunk = trunk_objects(params)
    ptrs = {k: t.data_ptr() for k, t in trunk.items()}
    base = scenario.split_params(params)[0]
    branches = {n: scenario_branch(base, s) for n, s in SWAP_SEEDS.items()}
    n_sites = len(cnn.conv_site_shapes(model.cfg))
    chunk = images[:SLOTS]
    launches = 0
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        t0 = time.perf_counter()
        for name, br in branches.items():
            ckpt.save_branch(tmp, name, br, model_name=model.cfg.name,
                             plan=plan)
        print(f"save_branch x3: {(time.perf_counter() - t0) * 1e3:.1f} ms; "
              f"branch {rom.sram_bytes(params)} bytes, trunk "
              f"{rom.rom_bytes(params)} bytes")
        srv = server.CNNServer(model, params, n_slots=SLOTS)
        store = scenario.ScenarioStore(model, plan, capacity=2,
                                       device=srv.device)
        srv.store = store
        for name in branches:
            store.register(name, ckpt_dir=tmp)
        for i, name in enumerate(SWAP_ORDER):
            misses = store.misses
            torch.cuda.synchronize()
            mem0 = gib()
            t0 = time.perf_counter()
            srv.swap_scenario(name)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            mem1 = gib()
            check(srv.scenario == name and srv.model is model,
                  f"swap {i} to {name}")
            check(same_trunk(srv.params, trunk, ptrs),
                  f"swap {i} to {name}: a trunk tensor was copied or replaced")
            reset_launches()
            out = srv.submit(chunk)
            counts = read_launches()
            check(counts["trunk_conv"] == n_sites
                  and sum(counts.values()) == n_sites,
                  f"swap {i}: expected {n_sites} trunk launches for one "
                  f"chunk, got {counts}")
            launches += counts["trunk_conv"]
            fresh = server.CNNServer(
                deploy.compile_model(model.cfg, plan=plan),
                rebranch.combine(bridge.tree_map(branches[name],
                                                 lambda t: t.to(srv.device)),
                                 scenario.split_params(params)[1]),
                n_slots=SLOTS)
            want = fresh.submit(chunk)
            check(np.array_equal(out, want),
                  f"swap {i} to {name}: served chunk != a fresh cell on "
                  f"combine(branch, trunk) (max diff "
                  f"{np.abs(out - want).max()})")
            check(np.isfinite(out).all(), f"swap {i}: non-finite output")
            src = "checkpoint (miss)" if store.misses > misses else "cache hit"
            print(f"swap {i} to {name} from {src}: {dt * 1e3:.3f} ms host "
                  f"clock, memory_allocated {mem0:.3f} -> {mem1:.3f} GiB; "
                  f"chunk bitwise equal to a fresh cell, trunk tensors the "
                  f"same objects, {counts['trunk_conv']} kernel-1 launches "
                  f"[{smi}]")
            del fresh
        check(store.evicted == ["A", "B"] and store.misses == 4,
              f"LRU: evicted {store.evicted}, misses {store.misses}; the "
              f"last swap should reload A from its checkpoint")
        for name in ("C", "A"):                       # both cached now
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.swap_scenario(name)
            torch.cuda.synchronize()
            print(f"swap to {name} from the cache: "
                  f"{(time.perf_counter() - t0) * 1e3:.3f} ms host clock "
                  f"[{smi}]")
        check(store.hits == 2 and same_trunk(srv.params, trunk, ptrs),
              "cache-hit swaps")
    print(f"store after the swaps: cached {store.cached()}, evicted "
          f"{store.evicted}, hits {store.hits}, misses {store.misses}")
    return launches


def phase_lm_swap(smi: str) -> int:
    """A mid-stream swap on full-width Gemma-2B under pallas_fused, the
    phase-6 server: four requests under A, swap_scenario("B"), four under
    B, drained together; every request's tokens equal to its solo decode
    under its own scenario, bit for bit.  Returns kernel 3's launches."""
    from repro_torch import bridge, scenario
    from repro_torch.core import rebranch, rom
    from repro_torch.serve import registry, server

    model, params = lm_cell()
    trunk = trunk_objects(params)
    ptrs = {k: t.data_ptr() for k, t in trunk.items()}
    base = scenario.split_params(params)[0]
    branches = {"A": bridge.tree_map(base, lambda t: t.cpu()),
                "B": scenario_branch(base, 31)}
    del base
    dev = next(iter(trunk.values())).device
    store = registry.scenario_store("gemma-2b", device=dev)
    t0 = time.perf_counter()
    for name, br in branches.items():
        store.register(name, branch=br)
    print(f"gemma-2b scenarios registered in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms; branch "
          f"{rom.sram_bytes(params)} bytes, trunk {rom.rom_bytes(params)} "
          f"bytes")
    srv = server.load("gemma-2b", params=params, n_slots=LM_SLOTS,
                      max_len=LM_MAX_LEN, scenario="A")
    del params
    check(same_trunk(srv.params, trunk, ptrs), "load(scenario=) moved a trunk tensor")
    applied = []
    apply_swap = srv.batcher._apply_swap

    def timed_apply(sw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        apply_swap(sw)
        torch.cuda.synchronize()
        applied.append((time.perf_counter() - t, srv.batcher.step_count))

    srv.batcher._apply_swap = timed_apply
    rng = np.random.default_rng(17)
    vocab = model.cfg.vocab_size
    prompts = {n: [rng.integers(0, vocab, size=k) for k in ks]
               for n, ks in LM_SWAP_PROMPTS.items()}
    torch.cuda.synchronize()
    reset_launches()
    t_all = time.perf_counter()
    reqs = [srv.submit(p, LM_SWAP_NEW, scenario="A") for p in prompts["A"]]
    mem0 = gib()
    t0 = time.perf_counter()
    srv.swap_scenario("B")
    torch.cuda.synchronize()
    t_queue = time.perf_counter() - t0
    mem1 = gib()
    reqs += [srv.submit(p, LM_SWAP_NEW, scenario="B") for p in prompts["B"]]
    steps = srv.drain()
    wall = time.perf_counter() - t_all
    counts = read_launches()
    del srv.batcher._apply_swap
    per_pass = 7 * model.cfg.num_layers
    chunks = prefill_calls(prompts["A"] + prompts["B"],
                           srv.batcher.prefill_chunk)
    check(counts["rebranch_matmul"] == per_pass * (chunks + steps)
          and sum(counts.values()) == counts["rebranch_matmul"],
          f"expected {per_pass} fused-kernel launches per prefill chunk and "
          f"per decode step, got {counts} for {chunks} chunks + {steps} "
          f"steps")
    check(srv.batcher.swap_count == 1 and srv.scenario == "B"
          and len(applied) == 1, f"swap count {srv.batcher.swap_count}")
    check(same_trunk(srv.params, trunk, ptrs),
          "the swap copied or replaced a trunk tensor")
    a_done = max(r.finish_step for r in reqs[:4])
    check(min(r.admit_step for r in reqs[4:]) >= a_done
          and applied[0][1] >= a_done,
          "B's requests were admitted before A's retired")
    check(srv.pool.blocks_in_use == 0, "blocks leaked after drain")
    n_tok = sum(len(r.tokens) for r in reqs)
    print(f"gemma-2b mid-stream swap: {len(reqs)} requests ({n_tok} tokens) "
          f"in {wall * 1e3:.1f} ms, {steps} decode steps; "
          f"swap_scenario('B') {t_queue * 1e3:.3f} ms (store miss: B's "
          f"branch to the card), memory_allocated {mem0:.3f} -> "
          f"{mem1:.3f} GiB; the barrier applied at step {applied[0][1]} in "
          f"{applied[0][0] * 1e3:.3f} ms; {per_pass} kernel-3 launches per "
          f"pass ({counts}) [{smi}]")
    for name, rs in (("A", reqs[:4]), ("B", reqs[4:])):
        full = rebranch.combine(
            bridge.tree_map(branches[name], lambda t: t.to(dev)),
            scenario.split_params(srv.params)[1])
        for r, p in zip(rs, prompts[name]):
            check(r.scenario == name, f"request {r.rid} ran under "
                  f"{r.scenario}")
            toks, _ = _solo_run(model, full, p, LM_SWAP_NEW, LM_MAX_LEN)
            check(toks == r.tokens,
                  f"request {r.rid} (scenario {name}): batched != solo")
        del full
    print("every request's tokens equal its solo decode under its own "
          "scenario, bit for bit")
    return counts["rebranch_matmul"]


# ---------------------------------------------------------------------------
# phases 15-17: branch training
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 64, 3e-3     # launch/train.py's CLI
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_SAVE_AT = 30, 5, 15
TRAIN_LAYERS = 3           # phase 16's depth cut (the ROM is hashed 4 times;
                           # the script's time limit)
TRAIN_CHUNKS = 4
TRAIN_CUT = 2, 4, 32       # card-vs-CPU step: layers, batch, sequence
M_REL = 5e-2               # AdamW's m after a step, of each leaf's absmax
CNN_TRAIN = dict(batch=128, steps=50, lr=2e-3, seed=200)
CNN_LOSS_REL = 5e-2        # the whole first-step loss, card vs CPU
DX_RTOL = 1e-5             # each conv's STE dx, card vs CPU, of its absmax


def resnet18_cfg():
    from repro_torch.configs import paper_models
    return paper_models.RESNET18


def timed_step(fn):
    """(result, CUDA-event ms, host-clock ms) of one call of ``fn``, the
    host clock around the call and a synchronise."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def phase_train_kernels(dev, smi: str) -> dict:
    """Kernel 4 at Gemma-2B's four linear geometries at M = B*S = 512
    through ``ops.trunk_matmul_pallas`` under autograd: the forward
    ``torch.equal`` to the plain version, one launch, none in the
    backward, the STE dx ``torch.equal`` to ``g @ (w_q*s).T``; times as
    phase 5's.  Kernel 1 at ResNet-18's conv geometries (32x32, batch
    128): ``torch.equal`` to the plain version, times as phase 2's."""
    from repro_torch.core import quant
    from repro_torch.kernels import cim_matmul as cm
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import rebranch_conv as rc
    from repro_torch.models import cnn
    t_phase = time.perf_counter()
    m = TRAIN_BATCH * TRAIN_SEQ
    gen = torch.Generator(device=dev).manual_seed(15)
    out = {"cim_matmul": dict(ms=0.0, device_ms=0.0, plain_ms=0.0,
                              bound_ms=0.0, library_ms=0.0,
                              library_device_ms=0.0, dx_ms=0.0,
                              max_abs_err=0.0),
           "trunk_conv": dict(ms=0.0, plain_ms=0.0, bound_ms=0.0,
                              launches=0, max_abs_err=0.0)}
    row = out["cim_matmul"]
    print(f"kernel 4 at the train geometry M = {m} (batch {TRAIN_BATCH} x "
          f"seq {TRAIN_SEQ}) [{smi}]")
    print("kernel K N M fwd_equal dx_equal ms device_ms plain_ms bound_ms "
          "bound_by library_ms library_device_ms dx_ms")
    for (k, n), per_layer in LM_GEOMS.items():
        copies = max(1, math.ceil(2.5 * L2_BYTES / (k * n)))
        ws = [torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(copies)]
        w_q = ws[0]
        w_scale = torch.rand((n,), generator=gen, device=dev) * 1e-2 + 1e-3
        x = torch.randn((m, k), generator=gen, device=dev).to(
            torch.bfloat16).requires_grad_(True)
        before = cm.launches
        y = kops.trunk_matmul_pallas(cm.IDEAL, x, w_q, w_scale)
        check(cm.launches == before + 1, "trunk_matmul_pallas did not "
              "launch kernel 4 once")
        x_q, sx = quant.quantize_activations(x.detach())
        want = (cm.cim_matmul_plain(x_q, w_q) * sx).to(x.dtype) \
            * w_scale.to(x.dtype)
        fwd_eq = torch.equal(y.detach(), want)
        check(fwd_eq, f"kernel 4 forward != plain at {k}x{n}, M = {m}")
        g = torch.randn(y.shape, generator=gen, device=dev).to(y.dtype)
        (dx,) = torch.autograd.grad(y, x, g)
        check(cm.launches == before + 1, "the STE backward launched a kernel")
        ste_dx = lambda: g @ (w_q.to(g.dtype) * w_scale.to(g.dtype)).T
        dx_eq = torch.equal(dx, ste_dx())
        check(dx_eq, f"STE dx != g @ (w_q*s).T at {k}x{n}")
        args = [(x_q, wi) for wi in ws]
        ms = time_cycled_ms(cm.cim_matmul, args, 3 * copies)
        dms = time_graph_ms(cm.cim_matmul, args, 3 * copies)
        plain = time_cycled_ms(cm.cim_matmul_plain, args[:1], 2)
        lib_args = [(a, b.t().contiguous().t()) for a, b in args]
        lib = time_cycled_ms(torch._int_mm, lib_args, 3 * copies)
        lib_dev = time_graph_ms(torch._int_mm, lib_args, 3 * copies)
        dx_ms = time_ms(ste_dx, 3)
        bound, by = lm_bound_ms(m, k, n)
        print(f"cim_matmul {k} {n} {m} {fwd_eq} {dx_eq} {ms:.4f} {dms:.4f} "
              f"{plain:.4f} {bound:.4f} {by} {lib:.4f} {lib_dev:.4f} "
              f"{dx_ms:.4f}", flush=True)
        count = per_layer * LM_LAYERS
        for key, v in (("ms", ms), ("device_ms", dms), ("plain_ms", plain),
                       ("bound_ms", bound), ("library_ms", lib),
                       ("library_device_ms", lib_dev), ("dx_ms", dx_ms)):
            row[key] += v * count
        del ws, lib_args, args, x, y, dx
        torch.cuda.empty_cache()
    print(f"kernel 4 per Gemma-2B train forward at M = {m} "
          f"({7 * LM_LAYERS} launches): {row['ms']:.3f} ms (device, graph "
          f"replay: {row['device_ms']:.3f} ms), plain {row['plain_ms']:.3f} "
          f"ms, bound {row['bound_ms']:.3f} ms, torch._int_mm "
          f"{row['library_ms']:.3f} ms (device {row['library_device_ms']:.3f}"
          f" ms); the STE dx GEMMs with their dequantised W "
          f"{row['dx_ms']:.3f} ms [{smi}]")

    cfg = resnet18_cfg()
    n_img = CNN_TRAIN["batch"]
    conv = out["trunk_conv"]
    print(f"kernel 1 at ResNet-18's conv geometries, {cfg.input_size}x"
          f"{cfg.input_size}, batch {n_img} [{smi}]")
    print("site k c_in c_out stride M R equal ms plain_ms bound_ms bound_by")
    for site, k, c_in, c_out, hw, stride in cnn.conv_site_shapes(cfg):
        x = torch.randn((n_img, hw * stride, hw * stride, c_in),
                        generator=gen, device=dev)
        w_q = torch.randint(-127, 128, (k, k, c_in, c_out), generator=gen,
                            device=dev, dtype=torch.int8)
        before = rc.launches
        got = rc.trunk_conv_dot(x, w_q, stride)
        conv["launches"] += rc.launches - before
        want = plain_trunk(x, w_q, stride=stride)
        equal = torch.equal(got, want)
        check(equal, f"{site}: kernel 1 != plain at stride {stride}")
        ms = time_ms(lambda: rc.trunk_conv_dot(x, w_q, stride), 5)
        plain = time_ms(lambda: plain_trunk(x, w_q, stride=stride), 2)
        mm, r = n_img * hw * hw, k * k * c_in
        bound, by = trunk_bound_ms(mm, r, c_out, x.numel())
        print(f"{site} {k} {c_in} {c_out} {stride} {mm} {r} {equal} "
              f"{ms:.4f} {plain:.4f} {bound:.4f} {by}", flush=True)
        conv["ms"] += ms
        conv["plain_ms"] += plain
        conv["bound_ms"] += bound
        del x, got, want
        torch.cuda.empty_cache()
    print(f"kernel 1 per ResNet-18 forward at batch {n_img} "
          f"({conv['launches']} launches): {conv['ms']:.3f} ms, plain "
          f"{conv['plain_ms']:.3f} ms, bound {conv['bound_ms']:.3f} ms "
          f"[{smi}]")
    print(f"phase 15 wall {time.perf_counter() - t_phase:.1f} s")
    return out


def lm_train_setup(cfg, seed: int = 0):
    """The slice's training cell: ``cfg`` all-ROM under 'pallas' (kernel
    4 behind every linear), parameters drawn on the card, and
    ``launch/train.py``'s step at the CLI's defaults."""
    from repro_torch import deploy, optim
    from repro_torch.launch import steps
    from repro_torch.optim import schedule
    model = deploy.compile_model(cfg, engine="pallas")
    check(model.layer_spec("blocks.mlp").trunk_impl == "pallas",
          "the train cell does not run the pallas engine")
    lr_fn = lambda s: schedule.cosine_with_warmup(
        s, peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
        total_steps=TRAIN_STEPS)
    step_fn = steps.make_train_step(cfg, optim.AdamWConfig(lr=TRAIN_LR),
                                    lr_fn=lr_fn, loss_chunks=TRAIN_CHUNKS,
                                    model=model)
    return model, step_fn


def leaf_rel(got, want) -> float:
    """max |got - want| over want's absmax (want on the CPU)."""
    return ((got.float().cpu() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def worst_m(got, want) -> tuple[float, str]:
    """The AdamW ``m`` leaf of ``got`` farthest from ``want``'s (CPU), as
    (max |diff| over the leaf's absmax, name)."""
    from repro_torch import bridge
    ref = bridge.flatten(want["m"])
    return max((leaf_rel(a, ref[k]), k)
               for k, a in bridge.flatten(got["m"]).items())


def lm_train_cpu_check(smi: str):
    """One step at the 2-layer cut of full width (every linear geometry),
    batch 4 x seq 32, on the card and on the CPU (plain versions) from the
    same parameters, drawn on the card with non-zero cores.

    In the cell's bf16 activations the loss is held to 1e-3 relative;
    AdamW's ``m`` is printed beside the CPU's own move under a 2**-8
    relative change of layer 0's ln1 scale (one bf16 rounding): the
    quantised network is chaotic at the bf16 level, and an int8 code that
    moves with one rounding moves ``m`` by ~0.1 of its absmax.  With f32
    activations (the same kernels and geometries; card and CPU differ by
    f32 roundings) ``m`` is held to 5e-2 of each leaf's absmax too."""
    import dataclasses as dc

    from repro_torch import bridge, configs, optim
    from repro_torch.core import rebranch
    from repro_torch.data import synthetic
    layers_, batch, seq = TRAIN_CUT
    cpu = torch.device("cpu")
    for dtype in ("bfloat16", "float32"):
        # remat off: the phase's launch counts are the forward's alone
        cfg = dc.replace(configs.get("gemma_2b"), num_layers=layers_,
                         dtype=dtype, remat=False)
        model, step_fn = lm_train_setup(cfg)
        params = with_cores(model.init(seed=3),
                            torch.Generator().manual_seed(4))
        dcfg = synthetic.DataConfig(seed=1, vocab_size=cfg.vocab_size,
                                    seq_len=seq, global_batch=batch)
        host = bridge.tree_map(params, lambda t: t.to(cpu))
        ln1 = "['layers']['ln1']['sram']['scale']"
        runs = {"card": params, "cpu": host}
        if dtype == "bfloat16":
            runs["cpu, ln1 x (1 + 2**-8)"] = bridge.map_named(
                host, lambda k, t: t * (1 + 2.0 ** -8) if k == ln1 else t)
        outs, secs = {}, {}
        for where, p in runs.items():
            t, f = rebranch.partition(p)
            dev = t["ln_f"]["sram"]["scale"].device
            t0 = time.perf_counter()
            outs[where] = step_fn(t, f, optim.init(t),
                                  synthetic.markov_batch(dcfg, 0,
                                                         device=dev))
            torch.cuda.synchronize()
            secs[where] = time.perf_counter() - t0
        del params, host, runs
        (_, o_card, m_card), (_, o_cpu, m_cpu) = outs["card"], outs["cpu"]
        loss_rel = abs(float(m_card["loss"]) - float(m_cpu["loss"])) \
            / abs(float(m_cpu["loss"]))
        check(loss_rel <= 1e-3, f"card-vs-CPU train step ({dtype}): loss "
              f"off by {loss_rel:.2e} relative")
        worst = worst_m(o_card, o_cpu)
        if dtype == "float32":
            check(worst[0] <= M_REL, f"card-vs-CPU train step (f32): m "
                  f"leaf {worst[1]} off by {worst[0]:.2e} of its absmax")
            note = f"(<= {M_REL})"
        else:
            moved = worst_m(outs["cpu, ln1 x (1 + 2**-8)"][1], o_cpu)
            note = (f"(printed: the CPU's own m moves by {moved[0]:.2e} "
                    f"at {moved[1]} under a 2**-8 change of layer 0's ln1 "
                    f"scale)")
        print(f"card vs CPU, one step of gemma_2b cut to {layers_} layers "
              f"at full width, {dtype} activations, batch {batch} x seq "
              f"{seq}: loss {float(m_card['loss']):.6f} / "
              f"{float(m_cpu['loss']):.6f} (rel {loss_rel:.2e} <= 1e-3); "
              f"worst m leaf {worst[1]} at {worst[0]:.2e} of its absmax "
              f"{note}; card {secs['card']:.2f} s, CPU {secs['cpu']:.2f} s "
              f"(host clock, first call) [{smi}]")
        del outs
        torch.cuda.empty_cache()


def train_split(model, step_fn, trainable, frozen, opt, batch):
    """One train step split by part (CUDA events, each part timed alone
    on the step's own inputs): the blocks' forward, the readout's forward,
    the readout's recompute + backward, AdamW, the whole value_and_grad;
    and the step with the row slices on and off."""
    from repro_torch import optim
    from repro_torch.core import rebranch
    from repro_torch.core import rows as rows_lib
    from repro_torch.launch import steps
    cfg = model.cfg

    def loss_fn(t):
        p = rebranch.combine(t, frozen)
        return steps.chunked_readout_loss(p, model.features(p, batch),
                                          batch["labels"], cfg, TRAIN_CHUNKS,
                                          model=model)

    params = rebranch.combine(trainable, frozen)
    with torch.no_grad():
        feats = model.features(params, batch)
    blocks_fwd = time_ms(lambda: model.features(params, batch), 2)
    with torch.no_grad():
        readout_fwd = time_ms(lambda: steps.chunked_readout_loss(
            params, feats, batch["labels"], cfg, TRAIN_CHUNKS, model=model), 2)

    def readout_all():
        f = feats.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = steps.chunked_readout_loss(params, f, batch["labels"],
                                              cfg, TRAIN_CHUNKS, model=model)
            return torch.autograd.grad(loss, f)

    readout_bwd = time_ms(readout_all, 2) - readout_fwd
    vg = time_ms(lambda: steps.value_and_grad(loss_fn, trainable), 2)
    _, grads = steps.value_and_grad(loss_fn, trainable)
    opt_ms = time_ms(lambda: optim.update(grads, opt, trainable,
                                          optim.AdamWConfig(lr=TRAIN_LR),
                                          lr=TRAIN_LR), 3)
    del grads
    sliced, by = rows_lib.rowwise, {}
    try:
        for on in (True, False, False, True):
            rows_lib.rowwise = sliced if on else (lambda fn, *a: fn(*a))
            by.setdefault(on, []).append(time_ms(
                lambda: step_fn(trainable, frozen, opt, batch), 1))
    finally:
        rows_lib.rowwise = sliced
    return {"blocks_fwd": blocks_fwd, "readout_fwd": readout_fwd,
            "readout_bwd": readout_bwd, "optimizer": opt_ms,
            "value_and_grad": vg,
            "rows_on": sum(by[True]) / 2, "rows_off": sum(by[False]) / 2}


def phase_lm_train(smi: str, kernel_pass_ms: float) -> int:
    """Gemma-2B branch training at full width, cut to ``TRAIN_LAYERS``
    layers, under 'pallas': 30 steps of
    ``launch/train.py``'s loop on ``markov_batch`` at the CLI's defaults
    (batch 8, seq 64, lr 3e-3, warm-up 5); the loss finite and falling,
    7 kernel-4 launches per layer and step and none in the backward, the
    ROM untouched, and a checkpoint saved at step 15 (async) whose restored
    run's step 16 equals the uninterrupted one.  The ROM fingerprint
    before training (~6 GB through SHA-256) is taken on a thread while
    the card-vs-CPU step runs; the CLI last.  Returns kernel 4's launches
    over the 30 steps."""
    import tempfile
    import threading

    from repro_torch import bridge, configs, optim
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.core import rebranch, rom
    from repro_torch.data import synthetic
    from repro_torch.launch import train as train_cli
    t_phase = time.perf_counter()
    # remat off: 7 launches a layer and step, the forward's alone (phase
    # 35 trains with it on)
    cfg = dataclasses.replace(configs.get("gemma_2b"),
                              num_layers=TRAIN_LAYERS, remat=False)
    model, step_fn = lm_train_setup(cfg)
    params = model.init(seed=0)
    trainable, frozen = rebranch.partition(params)
    opt = optim.init(trainable)
    trunk = trunk_objects(params)
    ptrs = {k: t.data_ptr() for k, t in trunk.items()}
    before = {}

    def fingerprint():
        t0 = time.perf_counter()
        before["fp"] = rom.rom_fingerprint(params)
        before["s"] = time.perf_counter() - t0

    hasher = threading.Thread(target=fingerprint)
    hasher.start()
    lm_train_cpu_check(smi)
    hasher.join()
    check("fp" in before, "the ROM fingerprint before training failed")
    print(f"gemma_2b train cell: ROM {rebranch.frozen_count(params)} params "
          f"({rom.rom_bytes(params)} bytes), SRAM "
          f"{rebranch.trainable_count(params)} trainable "
          f"({rom.sram_bytes(params)} bytes); rom_fingerprint "
          f"{before['s'] * 1e3:.1f} ms (on a thread beside the card-vs-CPU "
          f"step) [{smi}]")
    dcfg = synthetic.DataConfig(seed=0, vocab_size=cfg.vocab_size,
                                seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    per_pass = 7 * cfg.num_layers
    losses, ev_ms, host_ms, launches = [], [], [], 0
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        saver = saved = None
        for s in range(TRAIN_STEPS):
            batch = synthetic.markov_batch(dcfg, s)
            reset_launches()
            (trainable, opt, m), ev, host = timed_step(
                lambda: step_fn(trainable, frozen, opt, batch))
            counts = read_launches()
            check(counts["cim_matmul"] == per_pass
                  and sum(counts.values()) == per_pass,
                  f"step {s}: expected {per_pass} kernel-4 launches, got "
                  f"{counts}")
            launches += counts["cim_matmul"]
            losses.append(float(m["loss"]))
            check(math.isfinite(losses[-1]), f"step {s}: loss {losses[-1]}")
            ev_ms.append(ev)
            host_ms.append(host)
            if s + 1 == TRAIN_SAVE_AT:
                t0 = time.perf_counter()
                saver = ckpt.save(tmp, s + 1, trainable, opt, params,
                                  async_=True)
                save_call = time.perf_counter() - t0
            if s + 1 == TRAIN_SAVE_AT + 1:
                saved = (losses[-1], bridge.tree_map(trainable,
                                                     lambda t: t.clone()))
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        saver.join()
        save_wait = time.perf_counter() - t0
        check(losses[-1] < losses[0], f"loss did not fall: {losses[0]:.4f} "
              f"-> {losses[-1]:.4f}")
        check(same_trunk(rebranch.combine(trainable, frozen), trunk, ptrs),
              "training copied, replaced or moved a trunk tensor")
        with open(os.path.join(tmp, f"step_{TRAIN_SAVE_AT:08d}",
                               "meta.json")) as f:
            check(json.load(f)["rom_fingerprint"] == before["fp"],
                  "the ROM fingerprint moved between step 0 and the save")
        # restore the saved step into fresh templates (restore refuses a
        # ROM whose fingerprint, taken now after the last step, differs
        # from the save's) and take the next step again
        meta = lambda tree: bridge.tree_map(
            tree, lambda t: torch.empty(t.shape, dtype=t.dtype,
                                        device="meta"))
        t0 = time.perf_counter()
        step, rt, ro, _ = ckpt.restore(tmp, meta(trainable), meta(opt),
                                       params)
        restore_s = time.perf_counter() - t0
        check(step == TRAIN_SAVE_AT and int(ro["step"]) == TRAIN_SAVE_AT,
              f"restored step {step}")
        rt, ro, rmet = step_fn(rt, frozen, ro,
                               synthetic.markov_batch(dcfg, TRAIN_SAVE_AT))
        loss16, t16 = saved
        t16 = bridge.flatten(t16)
        bitwise = float(rmet["loss"]) == loss16 and all(
            torch.equal(a, t16[k]) for k, a in bridge.flatten(rt).items())
        if not bitwise:
            worst = max(leaf_rel(a, t16[k].cpu())
                        for k, a in bridge.flatten(rt).items())
            check(abs(float(rmet["loss"]) - loss16) <= 1e-6 * abs(loss16)
                  and worst <= 1e-6, f"resumed step {TRAIN_SAVE_AT + 1}: "
                  f"loss {float(rmet['loss'])} vs {loss16}, leaves off by "
                  f"{worst:.2e}")
        del rt, ro, saved, t16
        split = train_split(model, step_fn, trainable, frozen, opt,
                            synthetic.markov_batch(dcfg, 0))
    steady = ev_ms[2:TRAIN_SAVE_AT]        # before the checkpoint's thread
    step_ms = sum(steady) / len(steady)
    host_step = sum(host_ms[2:TRAIN_SAVE_AT]) / len(steady)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    parts = sum(split[k] for k in ("blocks_fwd", "readout_fwd",
                                   "readout_bwd", "optimizer"))
    print(f"gemma_2b branch training at {cfg.num_layers} layers, "
          f"{TRAIN_STEPS} steps, batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, 'pallas': loss {losses[0]:.4f} "
          f"-> {losses[-1]:.4f} (entropy floor "
          f"{synthetic.entropy_floor(dcfg):.4f}); {per_pass} kernel-4 "
          f"launches per step (remat off), none in the backward; ROM "
          f"fingerprint and trunk data_ptrs unchanged [{smi}]")
    print(f"losses: {' '.join(f'{v:.4f}' for v in losses)}")
    print(f"train step (steps 3-{TRAIN_SAVE_AT}): {step_ms:.3f} ms CUDA "
          f"events (min {min(steady):.3f}, max {max(steady):.3f}), "
          f"{host_step:.3f} ms host clock; first step {ev_ms[0]:.3f} ms; "
          f"steps {TRAIN_SAVE_AT + 1}-{TRAIN_STEPS} beside the checkpoint's "
          f"thread {sum(ev_ms[TRAIN_SAVE_AT:]) / len(ev_ms[TRAIN_SAVE_AT:]):.3f}"
          f" ms; {tokens / step_ms * 1e3:.1f} trained tokens/s; "
          f"max_memory_allocated {peak / 2**30:.3f} GiB [{smi}]")
    print(f"train step split (CUDA events, parts timed alone): blocks "
          f"forward {split['blocks_fwd']:.3f} ms (kernel 4's {per_pass} "
          f"launches at M = {tokens}: derived "
          f"{kernel_pass_ms * cfg.num_layers / LM_LAYERS:.3f} ms, phase "
          f"15's measured {kernel_pass_ms:.3f} ms for all {LM_LAYERS} "
          f"layers scaled by {cfg.num_layers}/{LM_LAYERS}), "
          f"readout forward {split['readout_fwd']:.3f} ms, readout "
          f"recompute + backward {split['readout_bwd']:.3f} ms, AdamW "
          f"{split['optimizer']:.3f} ms, so the blocks' backward is the "
          f"step's remainder {step_ms - parts:.3f} ms; value_and_grad "
          f"alone {split['value_and_grad']:.3f} ms [{smi}]")
    print(f"train step with the batch-variant ops on 16-row slices "
          f"{split['rows_on']:.3f} ms, on all rows at once "
          f"{split['rows_off']:.3f} ms (in turns, CUDA events) [{smi}]")
    print(f"checkpoint at step {TRAIN_SAVE_AT}: save() returned in "
          f"{save_call * 1e3:.1f} ms (the host snapshot; the ROM "
          f"fingerprint and the write on its thread, still running "
          f"{save_wait * 1e3:.1f} ms after step {TRAIN_STEPS}), restore "
          f"{restore_s * 1e3:.1f} ms (its fingerprint included); the "
          f"restored run's step {TRAIN_SAVE_AT + 1} equals the "
          f"uninterrupted one {'bit for bit' if bitwise else 'within 1e-6'}"
          f" [{smi}]")
    del trainable, frozen, opt, params, split
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        cli = ["--arch", "gemma_2b", "--smoke", "--steps", "6", "--batch",
               "8", "--seq", "64", "--warmup", "2", "--ckpt-dir", tmp,
               "--ckpt-every", "3", "--log-every", "3"]
        first = train_cli.main(cli)
        more = train_cli.main(cli[:4] + ["8"] + cli[5:] + ["--resume"])
        check(len(first) == 6 and len(more) == 2
              and all(map(math.isfinite, first + more))
              and ckpt.latest_steps(tmp) == [3, 6, 8],
              f"the CLI: losses {first} then {more}, checkpoints "
              f"{ckpt.latest_steps(tmp)}")
    print(f"phase 16 wall {time.perf_counter() - t_phase:.1f} s")
    return launches


def cnn_ce(logits, y):
    """transfer_harness's CE: -mean log_softmax at the label."""
    import torch.nn.functional as F
    return -F.log_softmax(logits, dim=-1).gather(
        -1, y.long()[:, None]).mean()


def phase_cnn_train(dev, smi: str) -> int:
    """The paper's ReBranch fine-tune of ResNet-18 (32x32, 100 classes):
    dense init, ``freeze_to_rom``, 'pallas' (kernel 1 behind every ROM
    conv), ``transfer_harness._train``'s loop with the port's modules on
    ``image_batch`` at batch 128; the loss falls, the ROM is untouched,
    kernel 1 launches once per ROM conv per step; each conv's STE dx on
    the card within 1e-5 of its absmax of the CPU's for the same g, the
    first step's loss within 5e-2 of the CPU's.  Returns kernel 1's
    launches over the fine-tune."""
    import dataclasses as dc

    from repro_torch import bridge, deploy, optim
    from repro_torch.core import rebranch, rom
    from repro_torch.core.rebranch import ReBranchSpec, trunk_conv_ste_bwd
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import steps
    from repro_torch.models import cnn
    t_phase = time.perf_counter()
    cfg = resnet18_cfg()
    dense_cfg = dc.replace(cfg, rebranch=dc.replace(cfg.rebranch,
                                                    enabled=False))
    dense = cnn.MODEL_REGISTRY[cfg.name][0](torch.Generator().manual_seed(13),
                                            dense_cfg)
    params = cnn.freeze_to_rom(bridge.tree_map(dense, lambda t: t.to(dev)),
                               torch.Generator().manual_seed(14),
                               ReBranchSpec())
    model = deploy.compile_model(cfg, engine="pallas")
    sites = cnn.conv_site_shapes(cfg)
    trainable, frozen = rebranch.partition(params)
    trunk = trunk_objects(params)
    ptrs = {k: t.data_ptr() for k, t in trunk.items()}
    fp0 = rom.rom_fingerprint(params)
    opt = optim.init(trainable)
    ocfg = optim.AdamWConfig(lr=CNN_TRAIN["lr"], weight_decay=0.0)
    batch = CNN_TRAIN["batch"]

    def step(t, o, x, y):
        loss, g = steps.value_and_grad(
            lambda tt: cnn_ce(model.forward(rebranch.combine(tt, frozen), x),
                              y), t)
        t, o, _ = optim.update(g, o, t, ocfg)
        return t, o, loss

    x0, y0 = synthetic.image_batch(CNN_TRAIN["seed"], 0, batch,
                                   cfg.input_size, cfg.num_classes)
    # the first step's loss on the CPU, from the same parameters
    cpu_params = bridge.tree_map(params, lambda t: t.cpu())
    with torch.no_grad():
        cpu_loss = float(cnn_ce(model.forward(cpu_params, x0.cpu()),
                                y0.cpu()))
    del cpu_params
    losses, ev_ms, launches = [], [], 0
    t_loop = time.perf_counter()
    for s in range(CNN_TRAIN["steps"]):
        x, y = (x0, y0) if s == 0 else synthetic.image_batch(
            CNN_TRAIN["seed"], s, batch, cfg.input_size, cfg.num_classes)
        reset_launches()
        (trainable, opt, loss), ev, _ = timed_step(
            lambda: step(trainable, opt, x, y))
        counts = read_launches()
        check(counts["trunk_conv"] == len(sites)
              and sum(counts.values()) == len(sites),
              f"step {s}: expected {len(sites)} kernel-1 launches (one per "
              f"ROM conv), got {counts}")
        launches += counts["trunk_conv"]
        losses.append(float(loss))
        ev_ms.append(ev)
    wall = time.perf_counter() - t_loop
    rel = abs(losses[0] - cpu_loss) / abs(cpu_loss)
    check(rel <= CNN_LOSS_REL, f"first-step loss card {losses[0]} vs CPU "
          f"{cpu_loss}: rel {rel:.2e}")
    head, tail = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    check(all(map(math.isfinite, losses)) and tail < min(head, losses[0]),
          f"the fine-tune's loss did not fall: {losses[0]:.4f}, first 5 "
          f"mean {head:.4f} -> last 5 mean {tail:.4f}")
    check(rom.rom_fingerprint(params) == fp0, "the ROM fingerprint moved")
    check(same_trunk(rebranch.combine(trainable, frozen), trunk, ptrs),
          "the fine-tune copied, replaced or moved a trunk tensor")
    # each conv's STE dx: card vs CPU on the same g
    gen = torch.Generator(device=dev).manual_seed(17)
    worst = 0.0
    for (site, k, c_in, c_out, hw, stride) in sites:
        node = params
        for p in site.split("."):
            node = node[int(p)] if p.isdigit() else node[p]
        w_q, w_scale = node["rom"]["w_q"], node["rom"]["w_scale"]
        x = torch.randn((batch, hw * stride, hw * stride, c_in),
                        generator=gen, device=dev).requires_grad_(True)
        y = kops.trunk_conv(model.layer_spec(site).cim, stride, "SAME", x,
                            w_q, w_scale)
        g = torch.randn(y.shape, generator=gen, device=dev)
        (dx,) = torch.autograd.grad(y, x, g)
        want = trunk_conv_ste_bwd(stride, "SAME", tuple(x.shape), w_q.cpu(),
                                  w_scale.cpu(), g.cpu())
        err = leaf_rel(dx, want)
        check(err <= DX_RTOL, f"{site}: STE dx card vs CPU off by {err:.2e}"
              f" of its absmax")
        worst = max(worst, err)
    steady = ev_ms[2:]
    step_ms = sum(steady) / len(steady)
    print(f"resnet18 ReBranch fine-tune ({cfg.input_size}x{cfg.input_size}, "
          f"{cfg.num_classes} classes, batch {batch}, {CNN_TRAIN['steps']} "
          f"steps, 'pallas'): loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(first 5 mean {head:.4f}, last 5 {tail:.4f}); first-step loss "
          f"vs CPU rel {rel:.2e}; {len(sites)} kernel-1 launches per step; "
          f"ROM untouched; every conv's STE dx within {worst:.2e} of the "
          f"CPU's [{smi}]")
    print(f"losses: {' '.join(f'{v:.4f}' for v in losses)}")
    print(f"resnet18 train step (steps 3-{CNN_TRAIN['steps']}): "
          f"{step_ms:.3f} ms CUDA events, {batch / step_ms * 1e3:.1f} "
          f"images/s trained; {batch * CNN_TRAIN['steps'] / wall:.1f} "
          f"images/s over the whole loop on the host clock (data made on "
          f"the host included) [{smi}]")
    print(f"phase 17 wall {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phases 18-19: chunked prefill and speculative decode
# ---------------------------------------------------------------------------

CHUNK = 32                 # phase 18's prefill_chunk (the default)
CHUNK_PROMPTS = (40, 97, 200, 63, 150, 121)   # six prompts of 40-200 tokens
CHUNK_NEW = 32
STAGGER = 3                # phase 18's A/B: a request arrives every 3 ticks
SPEC_K = 4
SPEC_PROMPTS = (12, 40, 7, 100, 25, 60, 9, 33)   # 8 requests
SPEC_NEW = 16               # the script's time limit
SPEC_ALPHAS = (0.6, 0.95)  # the oracle drafter's per-position hit rate
SPEC_RUNS = 1              # timed runs per drafter (the script's time limit)
SPEC_SWAP_NEW = 16


def prefill_calls(prompts, chunk: int) -> int:
    """Prefill passes of ``prompts`` admitted with ``prefill_chunk`` =
    ``chunk``: one per chunk (a prompt no longer than the chunk is one)."""
    return sum(-(-len(p) // chunk) if chunk else 1 for p in prompts)


def lm_cell():
    """The ``gemma-2b`` cell (phase 6's registry entry) and phase 6's
    parameters, drawn again on the card (the same seeds)."""
    from repro_torch.serve import registry
    model, _ = registry.compile_entry("gemma-2b")
    params = with_cores(model.init(seed=0), torch.Generator().manual_seed(2))
    torch.cuda.synchronize()
    return model, params


def solo_prefill_cache(model, params, prompt):
    """A whole-prompt solo prefill's cache (no kernel count is read)."""
    dev = params["ln_f"]["sram"]["scale"].device
    cache = model.init_cache(1, LM_MAX_LEN, dtype=torch.float32, device=dev)
    with torch.no_grad():
        model.prefill(params, {"tokens": torch.as_tensor(prompt[None],
                                                         device=dev)}, cache)
    return cache


def staggered(srv, prompts, n_new: int):
    """Serve ``prompts`` arriving one every ``STAGGER`` ticks: (requests,
    wall s, each request's time to first token in ms, the longest tick
    that had rows in flight in ms), host clock, synchronised."""
    b = srv.batcher
    activate, first = b._activate, {}

    def rec(req, slot, solo, logits):
        first[req.rid] = time.perf_counter()
        activate(req, slot, solo, logits)

    b._activate = rec
    reqs, longest, tick = [], 0.0, 0
    try:
        t0 = time.perf_counter()
        while len(reqs) < len(prompts) or not b.idle:
            if len(reqs) < len(prompts) and tick % STAGGER == 0:
                reqs.append(srv.submit(prompts[len(reqs)], n_new))
            busy = b.active > 0
            t = time.perf_counter()
            b.step()
            torch.cuda.synchronize()
            if busy:
                longest = max(longest, (time.perf_counter() - t) * 1e3)
            tick += 1
        wall = time.perf_counter() - t0
    finally:
        del b._activate
    return reqs, wall, [(first[r.rid] - r.submit_s) * 1e3 for r in reqs], \
        longest


def phase_chunked_prefill(smi: str) -> int:
    """Phase 18: full-width Gemma-2B admitted in 32-token chunks.  Returns
    kernel 3's launches over the served run."""
    from repro_torch.serve import server
    t_phase = time.perf_counter()
    model, params = lm_cell()
    srv = server.load("gemma-2b", params=params, n_slots=LM_SLOTS,
                      max_len=LM_MAX_LEN, prefill_chunk=CHUNK)
    b = srv.batcher
    check(b.prefill_chunk == CHUNK and srv.pool.block_size,
          f"prefill_chunk {b.prefill_chunk}")
    rng = np.random.default_rng(18)
    vocab = model.cfg.vocab_size
    srv.submit(rng.integers(0, vocab, size=45), 2)      # warm-up, 2 chunks
    srv.drain()
    prompts = [rng.integers(0, vocab, size=n) for n in CHUNK_PROMPTS]

    adopted, first_logits, activated = {}, {}, {}
    ticks = []     # per tick: (chunks run, decode ms, tick ms, all grew, n)
    decode, prefill, activate = model.decode_step, model.prefill, b._activate
    tick = {}

    def rec_activate(req, slot, solo, logits):
        activated[req.rid] = time.perf_counter()
        adopted[req.rid] = {k: v.clone() for k, v in solo["layers"].items()}
        activate(req, slot, solo, logits)

    def rec_prefill(p, batch, cache):
        tick["chunks"] += 1
        return prefill(p, batch, cache)

    def rec_decode(p, tok, cache):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = decode(p, tok, cache)
        torch.cuda.synchronize()
        tick["decode"] = (time.perf_counter() - t) * 1e3
        for slot, req in b._active.items():
            if len(req.tokens) == 1:
                first_logits[req.rid] = logits[slot, -1].float().cpu()
        return logits, cache

    b._activate = rec_activate
    model.prefill, model.decode_step = rec_prefill, rec_decode
    torch.cuda.synchronize()
    reset_launches()
    try:
        t0 = time.perf_counter()
        reqs = [srv.submit(p, CHUNK_NEW) for p in prompts]
        while not b.idle:
            before = {r.rid: len(r.tokens) for r in b._active.values()}
            tick.update(chunks=0, decode=None)
            t = time.perf_counter()
            b.step()
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t) * 1e3
            grew = all(len(r.tokens) > before[r.rid] for r in reqs
                       if r.rid in before)
            ticks.append((tick["chunks"], tick["decode"], dt, grew,
                          len(before)))
        wall = time.perf_counter() - t0
    finally:
        del b._activate, model.prefill, model.decode_step
    counts = read_launches()
    steps = sum(1 for t in ticks if t[1] is not None)
    chunks = sum(t[0] for t in ticks)
    per_pass = 7 * model.cfg.num_layers
    check(chunks == prefill_calls(prompts, CHUNK),
          f"{chunks} prefill chunks, expected "
          f"{prefill_calls(prompts, CHUNK)}")
    check(counts["rebranch_matmul"] == per_pass * (chunks + steps)
          and sum(counts.values()) == counts["rebranch_matmul"],
          f"expected {per_pass} kernel-3 launches per chunk and per decode "
          f"step, got {counts} for {chunks} chunks + {steps} steps")
    chunk_ticks = [t for t in ticks if t[0] and t[4]]
    check(chunk_ticks and all(t[3] and t[1] is not None
                              for t in chunk_ticks),
          "an in-flight request gained no token on a tick a chunk ran")
    check(srv.pool.blocks_in_use == 0 == srv.pool.blocks_reserved,
          "blocks left after drain")
    n_tok = sum(len(r.tokens) for r in reqs)
    print(f"phase 18: {len(reqs)} requests (prompts {CHUNK_PROMPTS}) x "
          f"{CHUNK_NEW} tokens in {wall * 1e3:.1f} ms "
          f"({n_tok / wall:.2f} tokens/s), {chunks} prefill chunks of "
          f"<= {CHUNK} + {steps} decode steps; {per_pass} kernel-3 launches "
          f"per chunk and per step ({counts}); {len(chunk_ticks)} ticks ran "
          f"a chunk beside in-flight rows, each of them gained a token "
          f"[{smi}]")
    # every adopted row against the whole-prompt solo prefill, and every
    # request against its solo decode
    for r, p in zip(reqs, prompts):
        want = solo_prefill_cache(model, params, p)["layers"]
        row = adopted[r.rid]
        for key in ("k", "v", "length"):
            check(torch.equal(row[key], want[key]),
                  f"request {r.rid} (prompt {len(p)}): chunked row {key} "
                  f"!= the whole-prompt prefill's")
        toks, first = _solo_run(model, params, p, CHUNK_NEW, LM_MAX_LEN)
        check(toks == r.tokens
              and torch.equal(first, first_logits[r.rid]),
              f"request {r.rid}: chunked-admitted decode != solo")
    print("phase 18: every chunked row equals its whole-prompt solo prefill "
          "(k, v, length), and every request's tokens and first decode step "
          "logits equal its solo decode, bit for bit")
    longest = max(range(len(reqs)), key=lambda i: len(prompts[i]))
    ttft = activated[reqs[longest].rid] - reqs[longest].submit_s
    on = [t[1] for t in ticks if t[0] and t[1] is not None]
    off = [t[1] for t in ticks if not t[0] and t[1] is not None]
    on_tick = [t[2] for t in ticks if t[0] and t[1] is not None]
    off_tick = [t[2] for t in ticks if not t[0] and t[1] is not None]
    print(f"phase 18: time to first token of the {len(prompts[longest])}-"
          f"token prompt {ttft * 1e3:.1f} ms (host clock, from submit, "
          f"{-(-len(prompts[longest]) // CHUNK)} chunks); decode step of the "
          f"in-flight rows on chunk ticks {np.mean(on):.3f} ms, on plain "
          f"ticks {np.mean(off):.3f} ms; the whole tick "
          f"{np.mean(on_tick):.3f} ms with a chunk, {np.mean(off_tick):.3f} "
          f"ms without (host clock, synchronised; {len(on)} and {len(off)} "
          f"ticks)")
    # what chunking trades, in this call: the same requests arriving one
    # every STAGGER ticks, admitted in chunks and whole (prefill_chunk=0)
    runs = {}
    for chunk in (CHUNK, 0):
        s = server.load("gemma-2b", params=params, n_slots=LM_SLOTS,
                        max_len=LM_MAX_LEN, prefill_chunk=chunk)
        runs[chunk] = staggered(s, prompts, CHUNK_NEW)
        check([r.tokens for r in runs[chunk][0]] == [r.tokens for r in reqs],
              f"prefill_chunk={chunk}: other tokens than the first run")
        del s
    (_, c_wall, c_ttft, c_tick), (_, w_wall, w_ttft, w_tick) = \
        runs[CHUNK], runs[0]
    print(f"phase 18, requests arriving one every {STAGGER} ticks, chunks "
          f"of {CHUNK} against whole prompts: {n_tok / c_wall:.2f} against "
          f"{n_tok / w_wall:.2f} tokens/s; time to first token of the "
          f"{len(prompts[longest])}-token prompt {c_ttft[longest]:.1f} "
          f"against {w_ttft[longest]:.1f} ms (mean over the six "
          f"{np.mean(c_ttft):.1f} against {np.mean(w_ttft):.1f}); the "
          f"longest tick of in-flight rows {c_tick:.3f} against "
          f"{w_tick:.3f} ms (host clock, synchronised)")
    print(f"phase 18 wall {time.perf_counter() - t_phase:.1f} s")
    del srv, params
    torch.cuda.empty_cache()
    return counts["rebranch_matmul"]


def oracle_drafter(refs: list, vocab: int, alpha: float, seed: int = 0):
    """``benchmarks/spec_decode.py``'s oracle ``draft_source``: the known
    greedy continuation with probability ``alpha`` per position (a coin
    seeded per request and position), else a wrong token."""
    coins = [np.random.default_rng((seed, i)).random(len(ref))
             for i, ref in enumerate(refs)]

    def draft(active, last_tok, k):
        drafts = np.zeros((last_tok.shape[0], k), np.int32)
        for slot, req in active.items():
            i = req.rid % len(refs)
            pos = len(req.tokens)
            for j in range(k):
                t = refs[i][pos + j]
                drafts[slot, j] = t if coins[i][pos + j] < alpha \
                    else (t + 1) % vocab
        return drafts

    return draft


class LaunchAudit:
    """Wraps the model's prefill, verify and draft entry points: each
    prefill chunk and each verify must launch kernel 3 ``per_pass`` times
    and nothing else, each draft prefill and draft step no kernel at all.
    With ``timed``, the verifies and draft steps are timed (synchronised,
    host clock).  ``n`` counts the calls."""

    NAMES = ("prefill", "verify_step", "draft_prefill", "draft_decode_step")

    def __init__(self, model, per_pass: int, timed: bool = False):
        self.model, self.per_pass, self.timed = model, per_pass, timed
        self.n = dict.fromkeys(self.NAMES, 0)
        self.ms = {"verify_step": [], "draft_decode_step": []}

    def __enter__(self):
        for name in self.NAMES:
            setattr(self.model, name,
                    self._wrap(name, getattr(self.model, name)))
        return self

    def __exit__(self, *exc):
        for name in self.NAMES:
            delattr(self.model, name)

    def _wrap(self, name, real):
        want = 0 if name.startswith("draft") else self.per_pass
        timed = self.timed and name in self.ms

        def call(*args):
            before = read_launches()
            if timed:
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = real(*args)
            if timed:
                torch.cuda.synchronize()
                self.ms[name].append((time.perf_counter() - t) * 1e3)
            after = read_launches()
            got = {k: after[k] - before[k] for k in after}
            check(got["rebranch_matmul"] == sum(got.values()) == want,
                  f"{name} launched {got}, expected {want} of kernel 3")
            self.n[name] += 1
            return out

        return call


def spec_run(srv, prompts, n_new, refs, what: str):
    """Serve ``prompts`` and hold every request to ``refs`` (plain greedy
    solo decode) and the pool to zero blocks after the run."""
    t0 = time.perf_counter()
    reqs = [srv.submit(p, n_new) for p in prompts]
    srv.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r, ref in zip(reqs, refs):
        check(r.tokens == ref, f"{what}: request {r.rid} != plain greedy "
              f"solo decode")
    pool = srv.pool
    check(pool.blocks_in_use + pool.blocks_reserved == 0,
          f"{what}: {pool.blocks_in_use} blocks in use + "
          f"{pool.blocks_reserved} reserved after the run")
    return reqs, wall


def phase_spec_decode(smi: str) -> int:
    """Phase 19: full-width Gemma-2B, speculative decode at k = 4 under
    the branch drafter and two oracle drafters, spec off beside.  Returns
    kernel 3's launches over the checked runs."""
    from repro_torch import bridge, scenario
    from repro_torch.core import rebranch
    from repro_torch.serve import registry, server
    t_phase = time.perf_counter()
    model, params = lm_cell()
    per_pass = 7 * model.cfg.num_layers
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, vocab, size=n) for n in SPEC_PROMPTS]
    refs = [_solo_run(model, params, p, SPEC_NEW, LM_MAX_LEN)[0]
            for p in prompts]
    drafters = {"off": None, "branch": None}
    for alpha in SPEC_ALPHAS:
        drafters[f"oracle {alpha}"] = oracle_drafter(refs, vocab, alpha)
    rows, launches = {}, 0
    for name, source in drafters.items():
        srv = server.load("gemma-2b", params=params, n_slots=LM_SLOTS,
                          max_len=LM_MAX_LEN,
                          spec_k=0 if name == "off" else SPEC_K,
                          draft_source=source)
        b = srv.batcher
        torch.cuda.synchronize()
        reset_launches()
        with LaunchAudit(model, per_pass, timed=True) as audit:
            _, wall = spec_run(srv, prompts, SPEC_NEW, refs, name)
        counts = read_launches()
        passes = audit.n["prefill"] + audit.n["verify_step"] + (
            b.step_count if name == "off" else 0)
        check(counts["rebranch_matmul"] == per_pass * passes
              and sum(counts.values()) == counts["rebranch_matmul"],
              f"{name}: {counts} launches for {passes} passes")
        check(name != "branch" or audit.n["draft_decode_step"] > 0,
              "the branch drafter never ran")
        launches += counts["rebranch_matmul"]
        rates = []
        for _ in range(SPEC_RUNS):                # timed, no audit
            b.spec_rounds = b.drafted_total = b.matched_total = 0
            start = b.step_count
            reqs, wall = spec_run(srv, prompts, SPEC_NEW, refs, name)
            rates.append(sum(len(r.tokens) for r in reqs) / wall)
        rows[name] = dict(
            rate=np.mean(rates), spread=(max(rates) - min(rates))
            / min(rates), ticks=b.step_count - start,
            accept=b.acceptance_rate, draft_ms=audit.ms["draft_decode_step"],
            verify_ms=audit.ms["verify_step"])
        runs = " ".join(f"{r:.2f}" for r in rates)
        print(f"phase 19 {name}: tokens/s {runs} (mean {rows[name]['rate']:.2f}, spread "
              f"{rows[name]['spread']:.2%}); {rows[name]['ticks']} "
              f"{'decode steps' if name == 'off' else 'verify rounds'} for "
              f"{len(prompts)} x {SPEC_NEW} tokens; acceptance "
              f"{b.acceptance_rate:.3f}; kernel-3 launches {counts} "
              f"(checked: {per_pass} per prefill chunk and verify round, "
              f"none in {audit.n['draft_prefill']} draft prefills and "
              f"{audit.n['draft_decode_step']} draft steps) [{smi}]",
              flush=True)
        del srv, b
    off = rows["off"]
    for name, row in rows.items():
        if name == "off":
            continue
        draft = (f"{SPEC_K} draft steps x {np.mean(row['draft_ms']):.3f} ms"
                 if row["draft_ms"] else "the oracle (host)")
        print(f"phase 19 {name} vs off: {row['rate']:.2f} against "
              f"{off['rate']:.2f} tokens/s ({row['rate'] / off['rate']:.3f}x)"
              f"; {row['ticks']} verify rounds against {off['ticks']} plain "
              f"decode steps; one round = {draft} + verify "
              f"{np.mean(row['verify_ms']):.3f} ms (M = {LM_SLOTS} rows x k "
              f"<= {SPEC_K}, {per_pass} kernel-3 launches) + the host's "
              f"bookkeeping (synchronised, host clock)")
    # what the branch-only draft reads: C and U (f32) of every ROM linear,
    # cast to bf16 per call, against the trunk's int8 W
    flat = bridge.flatten(params)
    cu = sum(t.numel() * t.element_size() for k, t in flat.items()
             if k.endswith(("['rom']['C']", "['rom']['U']")))
    wq = sum(t.numel() * t.element_size() for k, t in flat.items()
             if k.endswith("['rom']['w_q']"))
    print(f"phase 19 draft step: {np.mean(rows['branch']['draft_ms']):.3f} "
          f"ms at {LM_SLOTS} rows; it reads C and U, {cu / 1e9:.3f} GB in "
          f"f32 ({cu / PEAK_BYTES * 1e3:.3f} ms at the HBM rate, before the "
          f"bf16 copies it writes and reads again), where the trunk reads "
          f"{wq / 1e9:.3f} GB of int8 W")
    check(rows["oracle 0.95"]["accept"] > rows["oracle 0.6"]["accept"],
          "the oracle's acceptance does not follow alpha")

    # one mid-stream swap under spec (branch drafter): A, swap B, B
    dev = params["ln_f"]["sram"]["scale"].device
    store = registry.scenario_store("gemma-2b", device=dev)
    base = scenario.split_params(params)[0]
    if "A" not in store:
        store.register("A", branch=bridge.tree_map(base, lambda t: t.cpu()))
    if "B" not in store:
        store.register("B", branch=scenario_branch(base, 31))
    del base
    srv = server.load("gemma-2b", params=params, n_slots=LM_SLOTS,
                      max_len=LM_MAX_LEN, scenario="A", spec_k=SPEC_K)
    del params
    prompts = {n: [rng.integers(0, vocab, size=k) for k in ks]
               for n, ks in LM_SWAP_PROMPTS.items()}
    torch.cuda.synchronize()
    reset_launches()
    with LaunchAudit(model, per_pass) as audit:
        reqs = [srv.submit(p, SPEC_SWAP_NEW, scenario="A")
                for p in prompts["A"]]
        srv.swap_scenario("B")
        reqs += [srv.submit(p, SPEC_SWAP_NEW, scenario="B")
                 for p in prompts["B"]]
        srv.drain()
    counts = read_launches()
    check(counts["rebranch_matmul"] == per_pass * (audit.n["prefill"]
                                                   + audit.n["verify_step"])
          and sum(counts.values()) == counts["rebranch_matmul"],
          f"swap under spec: {counts}")
    launches += counts["rebranch_matmul"]
    check(srv.batcher.swap_count == 1 and srv.scenario == "B",
          "swap under spec: not applied once")
    check(min(r.admit_step for r in reqs[4:])
          >= max(r.finish_step for r in reqs[:4]),
          "swap under spec: B admitted before A retired")
    check(srv.pool.blocks_in_use + srv.pool.blocks_reserved == 0,
          "swap under spec: blocks left")
    trunk = scenario.split_params(srv.params)[1]
    for name, rs in (("A", reqs[:4]), ("B", reqs[4:])):
        full = rebranch.combine(store.get(name), trunk)
        for r, p in zip(rs, prompts[name]):
            toks, _ = _solo_run(model, full, p, SPEC_SWAP_NEW, LM_MAX_LEN)
            check(toks == r.tokens, f"swap under spec: request {r.rid} "
                  f"(scenario {name}) != its solo decode")
        del full
    print(f"phase 19 swap under spec (branch drafter, k = {SPEC_K}): 4 "
          f"requests under A, swap, 4 under B, x {SPEC_SWAP_NEW} tokens; "
          f"{audit.n['verify_step']} verify rounds, acceptance "
          f"{srv.batcher.acceptance_rate:.3f}; every request equals its "
          f"solo decode under its own scenario, bit for bit; {counts}")
    print(f"phase 19 wall {time.perf_counter() - t_phase:.1f} s")
    del srv, trunk
    torch.cuda.empty_cache()
    return launches


FAMILY_ARCHS = ("hymba_1_5b", "granite_moe_3b", "falcon_mamba_7b",
                "qwen2_moe_a2_7b")
# phase 20: a solo row, the pools' decode rows, a ragged prompt near the
# longest served whole (100, phase 21) and a whole 128-row prompt
FAMILY_ROWS = (1, 8, 16, 100, 128)
BF16_ROWS = 16                 # phase 20: bf16 x is read as it is up to here
MOE_CHUNK_ROWS = 32            # phase 20: the MoE configs' prefill chunks
FAMILY_MAX_LEN = 256
HYMBA_SLOTS = 8
HYMBA_LAYERS = 8         # phase 21's depth cut (of 32), for the time limit
HYMBA_PROMPTS, HYMBA_NEW = (12, 40, 7, 100, 25), 32
HYMBA_SUSTAINED_REQS, HYMBA_SUSTAINED_NEW = 16, 32
HYMBA_PALLAS_PROMPTS, HYMBA_PALLAS_NEW = (10, 30), 8
GRANITE_SLOTS = 8
GRANITE_LAYERS = 8       # phase 22's depth cut (of 32), for the time limit
GRANITE_PROMPTS, GRANITE_NEW = (12, 40, 7, 100, 25), 32
FALCON_SLOTS = 4
FALCON_PROMPTS, FALCON_NEW = (12, 40, 7, 30), 16
NEAR_TIE = 1e-5          # phase 22: router probabilities closer than this


def family_kernel_sites(cfg) -> dict:
    """{(K, N): kernel launches per decode step} of ``cfg``'s ROM linears:
    every matmul site member but the stacked experts (plain PyTorch,
    ``models.moe``); a tied readout is no ROM linear."""
    from repro_torch import plan as plan_lib
    geoms = {}
    for site in plan_lib.site_tree(cfg):
        for label, (k, n) in site.members:
            if not label.startswith("experts."):
                geoms[(k, n)] = geoms.get((k, n), 0) + site.count
    return geoms


def phase_family_kernels(dev, phase: int = 20, archs=FAMILY_ARCHS,
                         family_rows=FAMILY_ROWS, skip=()):
    """Phase 20 (and 24): kernels 3 and 4 against their plain versions at
    every distinct ROM-linear geometry of the ``archs``' FULL configs but
    those in ``skip``, at every M of ``family_rows`` (and 32 for the MoE
    configs) in all three CiM modes, with f32 x (as served) and, at M <=
    BF16_ROWS, bf16 x; each M held to the first M rows of one plain call
    per mode at the tallest M; timed per geometry at M = 8."""
    from repro_torch import configs
    from repro_torch.core import cim as cim_lib
    from repro_torch.kernels import cim_matmul as cm
    from repro_torch.kernels import rebranch_matmul as rm
    t_phase = time.perf_counter()
    owners = {}
    for arch in archs:
        for kn in family_kernel_sites(configs.get(arch)):
            if kn not in skip:
                owners.setdefault(kn, []).append(arch)
    gen = torch.Generator(device=dev).manual_seed(phase)
    print(f"phase {phase}: kernel K N Cd M mode equal err ms device_ms "
          f"plain_ms bound_ms bound_by configs")
    for (k, n), archs in sorted(owners.items()):
        cdim = k // 4
        moe = any(a in configs.MOE_ARCHS for a in archs)
        rows = sorted(set(family_rows)
                      | ({MOE_CHUNK_ROWS} if moe else set()))
        x = torch.randn((max(rows), k), generator=gen, device=dev)
        xq = torch.randint(-127, 128, (max(rows), k), generator=gen,
                           device=dev, dtype=torch.int8)
        copies = max(1, math.ceil(2.5 * L2_BYTES / (k * n + 4 * k * cdim)))
        ws = [torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(copies)]
        cs = [torch.randn((k, cdim), generator=gen, device=dev) / k ** .5
              for _ in range(copies)]
        w, c = ws[0], cs[0]
        for mode in ("ideal",) + ADC_MODES:
            cfg = cim_lib.CiMConfig(mode=mode)
            # the plain versions once per mode at the tallest M: a plain
            # row is exact integer sums over that row alone (checked at M
            # = 8), so every shorter M is held to their first M rows
            tops = {torch.float32: x,
                    torch.bfloat16: x[:BF16_ROWS].bfloat16()}
            plain3 = {dt: rm.rebranch_matmul_plain(xt, w, c, cfg)
                      for dt, xt in tops.items()}
            plain4 = cm.cim_matmul_plain(xq, w, cfg)
            m8 = LM_SLOTS
            check(torch.equal(cm.cim_matmul_plain(xq[:m8], w, cfg),
                              plain4[:m8])
                  and all(torch.equal(
                      rm.rebranch_matmul_plain(xt[:m8], w, c, cfg)[0],
                      plain3[dt][0][:m8]) for dt, xt in tops.items()),
                  f"plain rows depend on M ({k}x{n}, {mode})")
            first = {}
            for m in rows:
                xqm = xq[:m].contiguous()
                got4 = cm.cim_matmul(xqm, w, cfg)
                xs = [x[:m].contiguous()]
                if m <= BF16_ROWS:
                    xs.append(xs[0].bfloat16())
                rels = []
                for xm in xs:
                    trunk, t1 = rm.rebranch_trunk_sketch(xm, w, c, cfg)
                    want_trunk, want_t1 = (p[:m] for p in plain3[xm.dtype])
                    torch.cuda.synchronize()
                    what = (f"({k}x{n}, Cd={cdim}, M={m}, {mode}, "
                            f"x {xm.dtype})")
                    check(torch.equal(trunk, want_trunk),
                          f"kernel 3 trunk != plain {what}")
                    err = (t1 - want_t1).abs().max().item()
                    rels.append(err / want_t1.abs().max().item())
                    check(rels[-1] <= SKETCH_RTOL, f"kernel 3 sketch off by "
                          f"{rels[-1]} of its absmax {what}")
                    row0 = (trunk[:1], t1[:1], got4[:1])
                    first.setdefault(xm.dtype, row0)
                    check(all(torch.equal(a, b) for a, b in
                              zip(first[xm.dtype], row0)),
                          f"row 0 differs between M = 1 and M = {m} {what}")
                check(torch.equal(got4, plain4[:m]),
                      f"kernel 4 != plain ({k}x{n}, M={m}, {mode})")
                rel = max(rels)
                if m != LM_SLOTS or mode != "ideal":
                    print(f"kernel3+4 {k} {n} {cdim} {m} {mode} True "
                          f"{rel:.2e}", flush=True)
                    continue
                xm = xs[0]
                args3 = [(xm, wi, ci) for wi, ci in zip(ws, cs)]
                args4 = [(xqm, wi) for wi in ws]
                reps = 3 * copies
                t3 = (time_cycled_ms(rm.rebranch_trunk_sketch, args3, reps),
                      time_graph_ms(rm.rebranch_trunk_sketch, args3, reps),
                      time_cycled_ms(rm.rebranch_matmul_plain, args3, copies),
                      *lm_bound_ms(m, k, n, cdim))
                t4 = (time_cycled_ms(cm.cim_matmul, args4, reps),
                      time_graph_ms(cm.cim_matmul, args4, reps),
                      time_cycled_ms(cm.cim_matmul_plain, args4, copies),
                      *lm_bound_ms(m, k, n))
                for name, t in (("rebranch_matmul", t3), ("cim_matmul", t4)):
                    print(f"{name} {k} {n} {cdim if name[0] == 'r' else 0} "
                          f"{m} {mode} True {rel:.2e} {t[0]:.4f} {t[1]:.4f} "
                          f"{t[2]:.4f} {t[3]:.4f} {t[4]} {','.join(archs)}",
                          flush=True)
        del ws, cs, plain3, plain4
        torch.cuda.empty_cache()
    print(f"phase {phase}: {len(owners)} geometries in "
          f"{time.perf_counter() - t_phase:.1f} s")


def family_cell(model_id: str, arch: str, engine: str = "pallas_fused",
                layers: int | None = None):
    """Register ``model_id`` as ``arch``'s FULL config (its depth cut to
    ``layers`` if given) under the all-ROM plan on ``engine``, compile it,
    and check the plan."""
    from repro_torch import configs
    from repro_torch import plan as plan_lib
    from repro_torch.serve import registry

    def config():
        cfg = configs.get(arch)
        return dataclasses.replace(cfg, num_layers=layers or cfg.num_layers)

    registry.register(registry.ModelEntry(
        model_id=model_id, config=config,
        plan=lambda cfg: plan_lib.solve(cfg, engine=engine)))
    model, plan = registry.compile_entry(model_id)
    for site in plan_lib.site_tree(model.cfg):
        spec = model.layer_spec(site.name)
        check(spec.enabled and spec.branch_enabled
              and spec.trunk_impl == engine,
              f"{model_id} {site.name}: not all-ROM {engine} ({spec})")
    return model


def family_params(model):
    """Seeded parameters drawn on the card, with non-zero cores."""
    t0 = time.perf_counter()
    params = with_cores(model.init(seed=0), torch.Generator().manual_seed(2))
    torch.cuda.synchronize()
    print(f"{model.cfg.name} params drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return params


def served_run(srv, model, prompts, n_new: int):
    """Serve ``prompts`` with every launch count set to 0 just before:
    (requests, each request's first decode step logits, decode steps,
    launch counts, wall s)."""
    first = {}
    decode = model.decode_step

    def recording(p, tok, cache):
        logits, cache = decode(p, tok, cache)
        for slot, req in srv.batcher._active.items():
            if len(req.tokens) == 1:
                first[req.rid] = logits[slot, -1].float().cpu()
        return logits, cache

    torch.cuda.synchronize()
    reset_launches()
    model.decode_step = recording
    try:
        t0 = time.perf_counter()
        reqs = [srv.submit(p, n_new) for p in prompts]
        steps = srv.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del model.decode_step
    counts = read_launches()
    vocab = model.cfg.vocab_size
    for r in reqs:
        check(len(r.tokens) == n_new and all(0 <= t < vocab
                                             for t in r.tokens),
              f"{model.cfg.name} request {r.rid}: tokens {r.tokens}")
    n_tok = sum(len(r.tokens) for r in reqs)
    print(f"{model.cfg.name}: served {len(reqs)} requests (prompts "
          f"{tuple(len(p) for p in prompts)}), {n_tok} tokens in "
          f"{wall * 1e3:.1f} ms, {steps} decode steps; launches {counts}")
    return reqs, first, steps, counts, wall


def check_solo(model, params, reqs, prompts, first, n_new: int, which):
    """Requests ``which`` against their solo runs on the card: the same
    tokens and first decode step logits, bit for bit."""
    for i in which:
        toks, solo_first = _solo_run(model, params, prompts[i], n_new,
                                     FAMILY_MAX_LEN)
        r = reqs[i]
        diff = (solo_first - first[r.rid]).abs().max().item()
        check(toks == r.tokens and diff == 0.0,
              f"{model.cfg.name} request {i}: batched != solo on the card "
              f"(tokens {r.tokens} vs {toks}, logits diff {diff})")
    print(f"{model.cfg.name}: requests {tuple(which)} equal their solo runs "
          f"on the card (tokens and first decode step logits, bit for bit)")


def sustained_window(srv, vocab: int, n_req: int, n_new: int, seed: int):
    """``SUSTAINED_RUNS`` runs of ``n_req`` requests x ``n_new`` tokens
    (prompts drawn in SUSTAINED_PROMPTS): tokens/s per run and the
    spread."""
    rng = np.random.default_rng(seed)
    rates = []
    for run in range(SUSTAINED_RUNS):
        sizes = rng.integers(SUSTAINED_PROMPTS[0], SUSTAINED_PROMPTS[1] + 1,
                             size=n_req)
        t0 = time.perf_counter()
        rs = [srv.submit(rng.integers(0, vocab, size=int(s)), n_new)
              for s in sizes]
        steps = srv.drain()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        toks = sum(len(r.tokens) for r in rs)
        check(toks == n_req * n_new, "sustained tokens")
        rates.append(toks / dt)
        print(f"sustained run {run}: {n_req} requests, {toks} tokens in "
              f"{dt * 1e3:.1f} ms, {steps} decode steps, {toks / dt:.2f} "
              f"tokens/s")
    spread = (max(rates) - min(rates)) / min(rates)
    print(f"sustained tokens/s: mean {sum(rates) / len(rates):.2f}, min "
          f"{min(rates):.2f}, max {max(rates):.2f}, spread {spread:.2%}")
    return sum(rates) / len(rates)


class Recorder:
    """Replaces ``name`` on ``module`` with a wrapper that records each
    call's arguments (and result) in ``calls`` while the block runs; the
    keyword argument ``clone_kw`` (a cache the call updates in place) is
    recorded as it was before the call."""

    def __init__(self, module, name: str, keep=None, clone_kw=None):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.keep = keep                     # record at most this many
        self.clone_kw = clone_kw
        self.calls = []

    def __enter__(self):
        from repro_torch import bridge

        def call(*args, **kw):
            if self.keep is not None and len(self.calls) >= self.keep:
                return self.real(*args, **kw)
            saved = dict(kw)
            if self.clone_kw is not None:
                saved[self.clone_kw] = bridge.tree_map(
                    kw[self.clone_kw], lambda t: t.clone())
            out = self.real(*args, **kw)
            self.calls.append((args, saved, out))
            return out
        setattr(self.module, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


class PlainCheck(Recorder):
    """:class:`Recorder` that keeps no call: each launch's result is held
    to ``plain`` on the same arguments as the call returns (the plain
    version launches no kernel): ``torch.equal``, but for kernel 3's
    sketch (``sketch``: the second output) within SKETCH_RTOL of its
    absmax, as in phases 5 and 24.  ``shapes`` counts the calls per (M,
    K, N); ``sketch_err`` is the worst sketch error."""

    def __init__(self, module, name: str, plain, what: str,
                 sketch: bool = False):
        super().__init__(module, name)
        self.plain, self.what, self.sketch = plain, what, sketch
        self.shapes, self.sketch_err = {}, 0.0

    def __enter__(self):
        def call(*args, **kw):
            out = self.real(*args, **kw)
            with torch.no_grad():
                want = self.plain(*args, **kw)
            mkn = (*args[0].shape, args[1].shape[1])
            where = f"{self.what}: {self.name} at (M, K, N) = {mkn}"
            if self.sketch:
                check(torch.equal(out[0], want[0]),
                      f"{where}: trunk != its plain version")
                rel = ((out[1] - want[1]).abs().max()
                       / want[1].abs().max()).item()
                check(rel <= SKETCH_RTOL, f"{where}: sketch off by {rel} "
                      f"of its absmax")
                self.sketch_err = max(self.sketch_err, rel)
            else:
                check(torch.equal(out, want), f"{where}: != its plain "
                      f"version")
            self.shapes[mkn] = self.shapes.get(mkn, 0) + 1
            return out
        setattr(self.module, self.name, call)
        return self

    def summary(self) -> str:
        return ", ".join(f"{m}x{k}->{n} ({c})"
                         for (m, k, n), c in sorted(self.shapes.items()))


def pass_times(kernel, plain, calls, sketch: bool) -> dict:
    """One served decode step's calls of a kernel (``calls``: argument
    tuples in the order the server made them) run again in that order:
    ``ms`` eager (host cost included), ``device_ms`` as a replayed CUDA
    graph, ``plain_ms`` the plain version over the same calls, the bound
    summed over them and, for kernel 4 (``sketch`` false),
    ``torch._int_mm`` over the same calls timed both ways (``library_ms``,
    ``library_device_ms``).  A step's weights lie far past the L2 cache,
    so each is read from HBM as when served."""
    def run(fn):
        return lambda: [fn(*a) for a in calls]

    bounds = [lm_bound_ms(a[0].shape[0], *a[1].shape,
                          a[2].shape[1] if sketch else 0,
                          a[0].element_size()) for a in calls]
    with torch.no_grad():
        out = {"rows": calls[0][0].shape[0], "launches": len(calls),
               "ms": time_ms(run(kernel), 5),
               "device_ms": time_graph_ms(run(kernel), [()], 3),
               "plain_ms": time_ms(run(plain), 1),
               "bound_ms": sum(b for b, _ in bounds),
               "bound_by": max(bounds)[1]}
        if not sketch:
            # kernel 4's yardstick: torch._int_mm over the same calls, each
            # zero-padded to what it takes (M > 16, K and N multiples of
            # 8); it sums all of K in int32 (no k-blocks, no ADC)
            lib = [int_mm_operands(a[0], a[1]) for a in calls]
            out["library_ms"] = time_ms(
                lambda: [torch._int_mm(*a) for a in lib], 5)
            out["library_device_ms"] = time_graph_ms(
                lambda: [torch._int_mm(*a) for a in lib], [()], 3)
        return out


def int_mm_operands(x, w):
    """int8 x [M, K] and w [K, N] zero-padded to what ``torch._int_mm``
    takes: M to max(32, a multiple of 8), K and N to multiples of 8; w laid
    out column-major, as phases 5 and 15 hand it (cuBLASLt's int8 GEMM
    takes its fast path for a row-major x and a column-major w)."""
    (m, k), n = x.shape, w.shape[1]
    mp, kp, np_ = max(32, -(-m // 8) * 8), -(-k // 8) * 8, -(-n // 8) * 8
    return (torch.nn.functional.pad(x, [0, kp - k, 0, mp - m]).contiguous(),
            torch.nn.functional.pad(w, [0, np_ - n, 0, kp - k]).t()
            .contiguous().t())


def print_pass(what: str, name: str, t: dict, smi: str):
    lib = ("" if "library_ms" not in t else
           f", torch._int_mm {t['library_ms']:.3f} ms (device "
           f"{t['library_device_ms']:.3f} ms)")
    print(f"{what} {name} per decode step at {t['rows']} rows, served order "
          f"({t['launches']} launches): {t['ms']:.3f} ms (device, graph "
          f"replay: {t['device_ms']:.3f} ms), plain {t['plain_ms']:.3f} ms, "
          f"bound {t['bound_ms']:.3f} ms ({t['bound_by']}){lib} [{smi}]")


def decode_split(model, params, srv, n_rows: int, smi: str) -> dict:
    """One decode step of ``n_rows`` rows split into kernel 3, its
    epilogue, the SSM recurrence (the depthwise conv's taps, the state
    update and readout), the attention (cache writes, softmax), the MoE
    blocks (routing, dispatch, the plain stacked experts, combine) and the
    rest (norms, fusion, embedding, readout, host gaps), CUDA events.  The
    parts a family lacks read 0; ``kernel`` holds kernel 3's
    :func:`pass_times` over the step's calls."""
    from repro_torch import bridge
    from repro_torch.core import rebranch as rebranch_lib
    from repro_torch.kernels import rebranch_matmul as rm
    from repro_torch.models import layers, moe, ssm
    rng = np.random.default_rng(211)
    rs = [srv.submit(rng.integers(0, model.cfg.vocab_size, size=20), 8)
          for _ in range(n_rows)]
    srv.step()                            # admit all, one decode step
    cache = srv.pool.cache
    tok = torch.as_tensor(srv.batcher._tok, device=srv.batcher.device)
    snapshot = bridge.tree_map(cache, lambda t: t.clone())
    recs = {"linear": Recorder(rebranch_lib, "apply_linear"),
            "taps": Recorder(ssm, "_conv_taps"),
            "recurrence": Recorder(ssm, "_recurrence"),
            "write": Recorder(layers, "_write_decode"),
            "attend": Recorder(layers, "_decode_attention"),
            "moe": Recorder(moe, "apply_moe_block")}
    for r in recs.values():
        r.__enter__()
    try:
        with torch.no_grad():
            model.decode_step(params, tok, cache)
    finally:
        for r in recs.values():
            r.__exit__()
    per_pass = sum(family_kernel_sites(model.cfg).values())
    check(len(recs["linear"].calls) == per_pass,
          f"recorded {len(recs['linear'].calls)} linears, not {per_pass}")

    def restore():
        bridge.tree_map2(cache, snapshot, lambda d, s: d.copy_(s))

    def replay(*names):
        def run():
            for name in names:
                fn = recs[name].real
                for a, kw, _ in recs[name].calls:
                    fn(*a, **kw)
        return run

    calls = [(a[0], a[1].reshape(-1, a[1].shape[-1]).contiguous())
             for a, _, _ in recs["linear"].calls]
    kernel = pass_times(rm.rebranch_trunk_sketch, rm.rebranch_matmul_plain,
                        [(x, p["rom"]["w_q"], p["rom"]["C"])
                         for p, x in calls], sketch=True)
    print_pass(model.cfg.name, "kernel 3", kernel, smi)
    with torch.no_grad():
        parts = [rm.rebranch_trunk_sketch(x, p["rom"]["w_q"], p["rom"]["C"])
                 for p, x in calls]

        def epilogues():
            for (p, x), (trunk, t1) in zip(calls, parts):
                rm.epilogue(x.dtype, trunk, t1, p["rom"]["w_scale"],
                            p["sram"]["core"], p["rom"]["U"])

        def step():
            restore()
            model.decode_step(params, tok, cache)

        copy_ms = time_ms(restore, 5)
        out = {"step_ms": time_ms(step, 5) - copy_ms,
               "kernel_ms": kernel["ms"],
               "epilogue_ms": time_ms(epilogues, 5),
               "ssm_ms": time_ms(replay("taps", "recurrence"), 5),
               "attention_ms": time_ms(replay("write", "attend"), 5),
               "moe_ms": time_ms(replay("moe"), 5)}
        restore()
    out["rest_ms"] = out["step_ms"] - sum(
        v for k, v in out.items() if k != "step_ms")
    out["kernel"] = kernel
    print(f"{model.cfg.name} decode step at {n_rows} rows (CUDA events): "
          f"whole {out['step_ms']:.3f} ms = kernel 3 {out['kernel_ms']:.3f} "
          f"ms ({per_pass} launches) + epilogue {out['epilogue_ms']:.3f} ms "
          f"+ SSM recurrence {out['ssm_ms']:.3f} ms (conv taps, state "
          f"update, readout) + attention {out['attention_ms']:.3f} ms "
          f"(cache writes, softmax) + MoE blocks {out['moe_ms']:.3f} ms "
          f"(routing, dispatch, plain stacked experts, combine) + rest "
          f"(norms, fusion, embedding, readout, host gaps) "
          f"{out['rest_ms']:.3f} ms")
    srv.drain()
    check(all(len(r.tokens) == 8 for r in rs), "split-step requests")
    return out


def cpu_tree(tree):
    from repro_torch import bridge
    return bridge.tree_map(tree, lambda t: t.detach().cpu())


def within_ulp(name: str, ref, got) -> float:
    """Check ``got`` within one bf16 ulp of ``ref``'s absmax; returns the
    difference in those ulps."""
    amax = ref.abs().max().item()
    diff = (ref.float() - got.cpu().float()).abs().max().item()
    print(f"{name}: max abs diff {diff:.3e} = {diff / bf16_ulp(amax):.2f} "
          f"bf16 ulp at the absmax {amax:.3e}")
    check(diff <= bf16_ulp(amax),
          f"{name} off by more than one bf16 ulp at its absmax")
    return diff / bf16_ulp(amax)


def hymba_cpu_replay(model, params, srv):
    """Layer 0 of one decode step recorded on the card and run again on
    the CPU plain versions: its 11 linears (trunk ``torch.equal``, output
    within one bf16 ulp at its absmax), its SSM decode step and its
    attention (live rows, one bf16 ulp)."""
    from repro_torch.core import rebranch as rebranch_lib
    from repro_torch.models import layers, ssm
    rng = np.random.default_rng(212)
    rs = [srv.submit(rng.integers(0, model.cfg.vocab_size, size=n), 4)
          for n in (5, 17, 33)]
    srv.step()
    live = sorted(srv.batcher._active)
    with Recorder(rebranch_lib, "apply_linear", keep=11) as lin, \
            Recorder(ssm, "apply_ssm_block", keep=1,
                     clone_kw="cache") as blk, \
            Recorder(layers, "apply_attention", keep=1,
                     clone_kw="cache") as att:
        srv.step()
    srv.drain()
    check(len(lin.calls) == 11 and len(blk.calls) == len(att.calls) == 1
          and len(live) == len(rs), "layer-0 recording")
    replay_linears("hymba layer 0", ("q", "k", "v", "o", "in_proj", "x_proj",
                                     "dt_proj", "out_proj", "gate", "up",
                                     "down"), lin.calls)
    (p, x, cfg), kw, (y, _) = blk.calls[0]
    with torch.no_grad():
        ref, _ = ssm.apply_ssm_block(cpu_tree(p), x.cpu(), cfg,
                                     cache=cpu_tree(kw["cache"]),
                                     decode=True, prefix=kw["prefix"])
    within_ulp(f"hymba layer 0 SSM decode step, live rows {live}",
               ref[live], y[live])
    replay_attention("hymba layer 0", att.calls[0], live)
    check(all(len(r.tokens) == 4 for r in rs), "replay requests")


def pallas_pass(model_id: str, arch: str, params, prompt_lens, n_new: int,
                n_slots: int, per_pass: int, rng, smi: str,
                layers: int | None = None):
    """``params`` served under the 'pallas' engine (kernel 4 behind every
    ROM linear): one request per prompt length, ``per_pass`` kernel-4
    launches per prefill chunk and per decode step and no other kernel;
    then the kernel's calls of one decode step of ``n_slots`` rows rerun in
    the served order (:func:`pass_times`).  Returns (launches, times)."""
    from repro_torch.kernels import cim_matmul as cm
    from repro_torch.serve import server
    model = family_cell(model_id, arch, engine="pallas", layers=layers)
    srv = server.load(model_id, params=params, n_slots=n_slots,
                      max_len=FAMILY_MAX_LEN)
    vocab = model.cfg.vocab_size
    prompts = [rng.integers(0, vocab, size=n) for n in prompt_lens]
    _, _, steps, counts, wall = served_run(srv, model, prompts, n_new)
    launches = counts["cim_matmul"]
    chunks = prefill_calls(prompts, srv.batcher.prefill_chunk)
    check(launches == per_pass * (chunks + steps)
          and counts["rebranch_matmul"] == counts["trunk_conv"] == 0,
          f"{model_id}: expected {per_pass} kernel-4 launches per prefill "
          f"chunk and per decode step, got {counts} for {chunks} chunks + "
          f"{steps} steps")
    print(f"{model_id}: {per_pass} kernel-4 launches per pass ({launches} "
          f"over {chunks} prefill chunks + {steps} steps); wall per tick "
          f"{wall / steps * 1e3:.2f} ms (host clock, prefills included)")
    rs = [srv.submit(rng.integers(0, vocab, size=20), 4)
          for _ in range(n_slots)]
    while srv.batcher.active < len(rs):
        srv.step()
    with Recorder(cm, "cim_matmul") as rec:
        srv.step()
    srv.drain()
    check(len(rec.calls) == per_pass and all(r.done for r in rs),
          f"recorded {len(rec.calls)} kernel-4 calls, not {per_pass}")
    times = pass_times(cm.cim_matmul, cm.cim_matmul_plain,
                       [a for a, _, _ in rec.calls], sketch=False)
    print_pass(model_id, "kernel 4", times, smi)
    return launches, times


def phase_hymba(smi: str) -> dict:
    """Phase 21: full-width Hymba-1.5B, cut to HYMBA_LAYERS layers,
    through ``LMServer`` under ``pallas_fused`` (kernel 3 behind its 11
    ROM linears a layer and the readout), then under ``pallas`` (kernel
    4).  Returns the launch counts and the step split."""
    from repro_torch.serve import server
    from repro_torch.serve.pool import SlotPool
    t_phase = time.perf_counter()
    print(f"phase 21 on {smi}")
    model = family_cell("hymba-1.5b", "hymba_1_5b", layers=HYMBA_LAYERS)
    cfg = model.cfg
    per_pass = sum(family_kernel_sites(cfg).values())
    check(per_pass == 11 * cfg.num_layers + 1,
          f"hymba ROM linears per pass {per_pass}")
    params = family_params(model)
    srv = server.load("hymba-1.5b", params=params, n_slots=HYMBA_SLOTS,
                      max_len=FAMILY_MAX_LEN)
    check(isinstance(srv.pool, SlotPool) and srv.batcher.prefill_chunk == 0,
          "hymba: not a dense pool with whole-prompt prefill")
    rng = np.random.default_rng(21)
    vocab = cfg.vocab_size
    warm = srv.submit(rng.integers(0, vocab, size=9), 3)    # not counted
    srv.drain()
    check(len(warm.tokens) == 3, "warm-up request")
    prompts = [rng.integers(0, vocab, size=n) for n in HYMBA_PROMPTS]
    reqs, first, steps, counts, wall = served_run(srv, model, prompts,
                                                  HYMBA_NEW)
    launches = counts["rebranch_matmul"]
    check(launches == per_pass * (len(prompts) + steps),
          f"expected {per_pass} kernel-3 launches per prefill and per "
          f"decode step, got {launches} for {len(prompts)} prefills + "
          f"{steps} steps")
    check(counts["cim_matmul"] == counts["trunk_conv"] == 0,
          f"hymba under pallas_fused launched another kernel: {counts}")
    check_solo(model, params, reqs, prompts, first, HYMBA_NEW, (0, 1))
    rate = sustained_window(srv, vocab, HYMBA_SUSTAINED_REQS,
                            HYMBA_SUSTAINED_NEW, 210)
    split = decode_split(model, params, srv, HYMBA_SLOTS, smi)
    hymba_cpu_replay(model, params, srv)
    del srv
    torch.cuda.empty_cache()

    # the same parameters under the 'pallas' engine: kernel 4
    plaunches, pkernel = pallas_pass("hymba-1.5b-pallas", "hymba_1_5b",
                                     params, HYMBA_PALLAS_PROMPTS,
                                     HYMBA_PALLAS_NEW, HYMBA_SLOTS, per_pass,
                                     rng, smi, layers=HYMBA_LAYERS)
    del params
    torch.cuda.empty_cache()
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "pallas_launches": plaunches,
            "tokens_per_s": rate, "split": split, "pallas_kernel": pkernel}


def granite_replay(model, params, srv):
    """Layer 0's MoE block at one decode step, recorded on the card and run
    again on the CPU with the same input: the (token, expert, slot)
    assignments equal but where a token's k-th and (k+1)-th router
    probabilities lie within NEAR_TIE, and the output within one bf16 ulp
    of its absmax."""
    from repro_torch.models import moe
    rng = np.random.default_rng(221)
    rs = [srv.submit(rng.integers(0, model.cfg.vocab_size, size=n), 8)
          for n in (5, 17, 33, 9)]
    while srv.batcher.active < len(rs):
        srv.step()
    with Recorder(moe, "apply_moe_block", keep=1) as blk:
        srv.step()
    srv.drain()
    (p, x, cfg), _, y = blk.calls[0]
    cp, cx = cpu_tree(p), x.cpu()
    xg = x.reshape(1, -1, x.shape[-1])
    with torch.no_grad():
        got = moe.route(p, xg, cfg)
        want = moe.route(cp, cx.reshape(1, -1, x.shape[-1]), cfg)
        probs = torch.softmax(cx.reshape(-1, x.shape[-1]).float()
                              @ cp["router"]["sram"]["w"], dim=-1)
        ranked = probs.sort(dim=-1, descending=True).values
        k = cfg.num_experts_per_tok
        near = (ranked[:, k - 1] - ranked[:, k]).abs() < NEAR_TIE
        ref = moe.apply_moe_block(cp, cx, cfg)
    same = [torch.equal(a.cpu()[0, ~near], b[0, ~near])
            for a, b in zip(got[:1] + got[2:], want[:1] + want[2:])]
    print(f"granite layer 0 routing replay: {int(near.sum())} near-ties "
          f"(k-th and (k+1)-th probabilities within {NEAR_TIE}) of "
          f"{near.numel()} tokens; assignments equal elsewhere: {all(same)}")
    check(all(same), "granite layer 0: card routing != CPU routing")
    within_ulp("granite layer 0 MoE block output", ref, y)
    check(all(len(r.tokens) == 8 for r in rs), "replay requests")


def phase_granite(smi: str) -> dict:
    """Phase 22: full-width Granite-MoE-3B, cut to GRANITE_LAYERS layers,
    through ``LMServer`` (paged pool, 32-token prefill chunks): kernel 3
    behind the 4 attention linears of each layer, the stacked experts in
    plain PyTorch."""
    from repro_torch.models import moe
    from repro_torch.serve import server
    from repro_torch.serve.pool import PagedPool
    t_phase = time.perf_counter()
    print(f"phase 22 on {smi}")
    model = family_cell("granite-moe-3b", "granite_moe_3b",
                        layers=GRANITE_LAYERS)
    cfg = model.cfg
    per_pass = sum(family_kernel_sites(cfg).values())
    check(per_pass == 4 * cfg.num_layers, f"granite per pass {per_pass}")
    params = family_params(model)
    srv = server.load("granite-moe-3b", params=params, n_slots=GRANITE_SLOTS,
                      max_len=FAMILY_MAX_LEN)
    check(isinstance(srv.pool, PagedPool) and srv.batcher.prefill_chunk
          == CHUNK, "granite: not a paged pool with 32-token chunks")
    rng = np.random.default_rng(22)
    vocab = cfg.vocab_size
    srv.submit(rng.integers(0, vocab, size=9), 3)            # warm-up
    srv.drain()
    prompts = [rng.integers(0, vocab, size=n) for n in GRANITE_PROMPTS]
    in_decode = []
    decode = model.decode_step

    def flagged(*args):
        in_decode.append(True)
        try:
            return decode(*args)
        finally:
            in_decode.pop()

    reqs, _, steps, counts, wall = served_run(srv, model, prompts,
                                              GRANITE_NEW)
    launches = counts["rebranch_matmul"]
    chunks = prefill_calls(prompts, CHUNK)
    check(launches == per_pass * (chunks + steps),
          f"expected {per_pass} kernel-3 launches per prefill chunk and per "
          f"decode step, got {launches} for {chunks} chunks + {steps} steps")
    check(counts["cim_matmul"] == counts["trunk_conv"] == 0,
          f"granite launched another kernel: {counts}")
    check(srv.pool.blocks_in_use == 0, "granite: blocks leaked")
    # dropped (token, expert) choices per decode step, all layers
    real_route = moe.route
    per_step = []

    def counting(*args):
        out = real_route(*args)
        if in_decode:
            per_step[-1] += int((~out[3]).sum())
        return out

    moe.route = counting
    model.decode_step = flagged
    try:
        rs = [srv.submit(rng.integers(0, vocab, size=n), 8)
              for n in (12, 40, 7, 100)]
        while not srv.batcher.idle:
            per_step.append(0)
            srv.step()
    finally:
        moe.route = real_route
        del model.decode_step
    check(all(len(r.tokens) == 8 for r in rs), "granite drop-count run")
    print(f"granite: dropped (token, expert) choices per tick over "
          f"{cfg.num_layers} layers: {per_step}")
    granite_replay(model, params, srv)
    split = decode_split(model, params, srv, GRANITE_SLOTS, smi)
    rate = sustained_window(srv, vocab, HYMBA_SUSTAINED_REQS,
                            HYMBA_SUSTAINED_NEW, 220)
    del srv, params
    torch.cuda.empty_cache()
    print(f"phase 22: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "tokens_per_s": rate, "split": split}


def phase_falcon(smi: str) -> dict:
    """Phase 23: full-width Falcon-Mamba-7B through ``LMServer`` (4 dense
    slots): kernel 3 behind its 257 ROM linears; one request equals its
    solo run bit for bit; peak memory and the decode step."""
    from repro_torch.serve import server
    t_phase = time.perf_counter()
    print(f"phase 23 on {smi}")
    torch.cuda.reset_peak_memory_stats()
    model = family_cell("falcon-mamba-7b", "falcon_mamba_7b")
    cfg = model.cfg
    per_pass = sum(family_kernel_sites(cfg).values())
    check(per_pass == 4 * cfg.num_layers + 1, f"falcon per pass {per_pass}")
    params = family_params(model)
    srv = server.load("falcon-mamba-7b", params=params, n_slots=FALCON_SLOTS,
                      max_len=FAMILY_MAX_LEN)
    rng = np.random.default_rng(23)
    vocab = cfg.vocab_size
    prompts = [rng.integers(0, vocab, size=n) for n in FALCON_PROMPTS]
    reqs, first, steps, counts, wall = served_run(srv, model, prompts,
                                                  FALCON_NEW)
    launches = counts["rebranch_matmul"]
    check(launches == per_pass * (len(prompts) + steps),
          f"expected {per_pass} kernel-3 launches per prefill and per "
          f"decode step, got {launches}")
    check(counts["cim_matmul"] == counts["trunk_conv"] == 0,
          f"falcon launched another kernel: {counts}")
    check_solo(model, params, reqs, prompts, first, FALCON_NEW, (1,))
    split = decode_split(model, params, srv, FALCON_SLOTS, smi)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"falcon-mamba-7b: peak memory {peak:.2f} GiB")
    del srv, params
    torch.cuda.empty_cache()
    print(f"phase 23: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "split": split, "peak_gib": peak}


# ---------------------------------------------------------------------------
# phases 24-27: the vlm and audio families; training and swaps over the
# new families
# ---------------------------------------------------------------------------

VLM_ARCH, AUDIO_ARCH = "qwen2_vl_2b", "musicgen_large"
VLM_AUDIO_ROWS = (1, 8, 16, 32, 128)      # phase 24
QWEN_SLOTS = 8
QWEN_LAYERS = 7          # phase 25's depth cut (of 28), for the time limit
QWEN_PROMPTS, QWEN_NEW = (12, 40, 7, 100, 25), 32
QWEN_SPEC_PROMPTS, QWEN_SPEC_NEW = (12, 40, 7, 33), 16
QWEN_PALLAS_PROMPTS, QWEN_PALLAS_NEW = (10, 30), 8
QWEN_GRID = (2, 3, 4)        # phase 25's embeds prefill: t x h x w (S = 24)
EMBEDS_CUT = 2               # phase 25: the card-vs-CPU embeds prefill's depth
LOGITS_RTOL = 5e-2           # whole LM forwards, card vs CPU, of the absmax
MUSICGEN_ROWS, MUSICGEN_PROMPT, MUSICGEN_NEW = 8, 32, 32   # the time limit
MUSICGEN_MAX_LEN = 128
FAMILY_TRAIN_ARCHS = ("granite_moe_3b", "hymba_1_5b", "falcon_mamba_7b",
                      VLM_ARCH, AUDIO_ARCH)
FAMILY_TRAIN_LAYERS = 2      # phase 27's depth cut (full width)
FAMILY_TRAIN_STEPS = 10
SWAP_SLOTS, SWAP_NEW = 4, 8  # phase 27's Hymba hot-swap


def replay_linears(what: str, names, calls):
    """Recorded ``apply_linear`` calls run again on the CPU: the unscaled
    trunk ``torch.equal`` (kernel 3 on the card against the plain version
    on the CPU) and the output within one bf16 ulp of its absmax."""
    from repro_torch.core import rebranch as rebranch_lib
    from repro_torch.kernels import rebranch_matmul as rm
    for name, (a, _, y) in zip(names, calls):
        p, x, spec = a
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        with torch.no_grad():
            trunk, _ = rm.rebranch_trunk_sketch(x2, p["rom"]["w_q"],
                                                p["rom"]["C"])
            ref_trunk, _ = rm.rebranch_matmul_plain(
                x2.cpu(), p["rom"]["w_q"].cpu(), p["rom"]["C"].cpu())
            ref = rebranch_lib.apply_linear(cpu_tree(p), x.cpu(), spec)
        check(torch.equal(trunk.cpu(), ref_trunk),
              f"{what} {name}: card trunk != CPU trunk")
        within_ulp(f"{what} {name}", ref, y)


def replay_attention(what: str, rec, live):
    """A recorded decode-step ``apply_attention`` (its cache as it was)
    run again on the CPU: the live rows within one bf16 ulp."""
    from repro_torch.models import layers
    (p, x, cfg, idx), kw, (y, _) = rec
    with torch.no_grad():
        ref, _ = layers.apply_attention(cpu_tree(p), x.cpu(), cfg, idx,
                                        cache=cpu_tree(kw["cache"]),
                                        decode=True)
    within_ulp(f"{what} attention, live rows {live}", ref[live], y[live])


def qwen_cpu_replay(model, params, srv):
    """Layer 0 of one decode step (3 live rows of the paged pool) recorded
    on the card and run again on the CPU plain versions: its 7 linears
    (q, k, v with their biases, o, gate, up, down) and its attention."""
    from repro_torch.core import rebranch as rebranch_lib
    from repro_torch.models import layers
    rng = np.random.default_rng(252)
    rs = [srv.submit(rng.integers(0, model.cfg.vocab_size, size=n), 4)
          for n in (5, 17, 33)]
    while srv.batcher.active < len(rs):
        srv.step()
    live = sorted(srv.batcher._active)
    with Recorder(rebranch_lib, "apply_linear", keep=7) as lin, \
            Recorder(layers, "apply_attention", keep=1,
                     clone_kw="cache") as att:
        srv.step()
    srv.drain()
    check(len(lin.calls) == 7 and len(att.calls) == 1, "layer-0 recording")
    check("b" in lin.calls[0][0][0]["sram"], "qwen2-vl q has no bias")
    replay_linears("qwen2-vl layer 0", ("q", "k", "v", "o", "gate", "up",
                                        "down"), lin.calls)
    replay_attention("qwen2-vl layer 0", att.calls[0], live)
    check(all(len(r.tokens) == 4 for r in rs), "replay requests")


def qwen_embeds_prefill(model, params, per_pass: int, smi: str):
    """A model-level prefill of frontend embeddings [1, S, d] with three
    distinct position streams (an image grid's t, h, w): on the card at
    full depth (one kernel-3 launch per ROM linear; other logits than
    text positions give); then at the EMBEDS_CUT-layer cut, card against
    the CPU plain path within LOGITS_RTOL of the absmax."""
    from repro_torch import bridge, deploy
    from repro_torch import plan as plan_lib
    cfg = model.cfg
    dev = params["ln_f"]["sram"]["scale"].device
    t, h, w = QWEN_GRID
    s = t * h * w
    gen = torch.Generator().manual_seed(253)
    embeds = torch.randn((1, s, cfg.d_model), generator=gen)
    grid = torch.stack(torch.meshgrid(torch.arange(t), torch.arange(h),
                                      torch.arange(w), indexing="ij"),
                       -1).reshape(1, s, 3)
    batch = {"embeds": embeds.to(dev), "positions": grid.to(dev)}

    def prefill(m, p, b, where):
        cache = m.init_cache(1, 64, dtype=torch.float32, device=where)
        with torch.no_grad():
            return m.prefill(p, b, cache)[0]

    reset_launches()
    logits = prefill(model, params, batch, dev)
    counts = read_launches()
    check(counts["rebranch_matmul"] == per_pass
          and sum(counts.values()) == per_pass,
          f"embeds prefill: expected {per_pass} kernel-3 launches, got "
          f"{counts}")
    check(tuple(logits.shape) == (1, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "embeds prefill logits")
    text = prefill(model, params, {"embeds": batch["embeds"]}, dev)
    moved = (logits.float() - text.float()).abs().max().item()
    check(moved > 0, "three position streams gave text positions' logits")
    cut_cfg = dataclasses.replace(cfg, num_layers=EMBEDS_CUT)
    cut = deploy.compile_model(cut_cfg, plan=plan_lib.solve(
        cut_cfg, engine="pallas_fused"))
    cut_params = dict(params, layers=bridge.tree_map(
        params["layers"], lambda x: x[:EMBEDS_CUT]))
    card = prefill(cut, cut_params, batch, dev).float().cpu()
    cpu = prefill(cut, cpu_tree(cut_params),
                  {k: v.cpu() for k, v in batch.items()}, "cpu").float()
    rel = (card - cpu).abs().max().item() / cpu.abs().max().item()
    print(f"qwen2-vl embeds prefill [1, {s}, {cfg.d_model}], positions a "
          f"{t}x{h}x{w} grid: {per_pass} kernel-3 launches, logits moved "
          f"{moved:.3e} from text positions; at {EMBEDS_CUT} layers card "
          f"vs CPU {rel:.3e} of the absmax, argmax {int(card.argmax())} / "
          f"{int(cpu.argmax())} [{smi}]")
    check(rel <= LOGITS_RTOL, f"embeds prefill card vs CPU off by {rel}")


def phase_qwen(smi: str) -> dict:
    """Phase 25, the slice's main path: full-width Qwen2-VL-2B cut to
    QWEN_LAYERS layers through ``LMServer`` under ``pallas_fused`` (kernel
    3 behind its 49 ROM linears; the tied readout a bf16 GEMM), then under
    ``pallas`` (kernel 4)."""
    from repro_torch.serve import server
    from repro_torch.serve.pool import PagedPool
    t_phase = time.perf_counter()
    print(f"phase 25 on {smi}")
    model = family_cell("qwen2-vl-2b", VLM_ARCH, layers=QWEN_LAYERS)
    cfg = model.cfg
    per_pass = sum(family_kernel_sites(cfg).values())
    check(per_pass == 7 * cfg.num_layers, f"qwen2-vl per pass {per_pass}")
    params = family_params(model)
    srv = server.load("qwen2-vl-2b", params=params, n_slots=QWEN_SLOTS,
                      max_len=FAMILY_MAX_LEN)
    check(isinstance(srv.pool, PagedPool) and srv.batcher.prefill_chunk
          == CHUNK, "qwen2-vl: not a paged pool with 32-token chunks")
    rng = np.random.default_rng(25)
    vocab = cfg.vocab_size
    warm = srv.submit(rng.integers(0, vocab, size=9), 3)     # not counted
    srv.drain()
    check(len(warm.tokens) == 3, "warm-up request")
    prompts = [rng.integers(0, vocab, size=n) for n in QWEN_PROMPTS]
    reqs, first, steps, counts, wall = served_run(srv, model, prompts,
                                                  QWEN_NEW)
    launches = counts["rebranch_matmul"]
    chunks = prefill_calls(prompts, CHUNK)
    check(launches == per_pass * (chunks + steps),
          f"expected {per_pass} kernel-3 launches per prefill chunk and per "
          f"decode step, got {launches} for {chunks} chunks + {steps} steps")
    check(counts["cim_matmul"] == counts["trunk_conv"] == 0,
          f"qwen2-vl under pallas_fused launched another kernel: {counts}")
    check(srv.pool.blocks_in_use == 0, "qwen2-vl: blocks leaked")
    # 0 and 2 fit one chunk; 1 (40) and 3 (100) are admitted in chunks:
    # all against whole-prompt solo runs
    check_solo(model, params, reqs, prompts, first, QWEN_NEW, (0, 1, 3))
    rate = sustained_window(srv, vocab, HYMBA_SUSTAINED_REQS,
                            HYMBA_SUSTAINED_NEW, 250)
    split = decode_split(model, params, srv, QWEN_SLOTS, smi)
    qwen_cpu_replay(model, params, srv)
    del srv
    torch.cuda.empty_cache()

    # speculative decode (the branch drafter): tokens == plain greedy
    ssrv = server.load("qwen2-vl-2b", params=params, n_slots=QWEN_SLOTS,
                       max_len=FAMILY_MAX_LEN, spec_k=SPEC_K)
    prompts = [rng.integers(0, vocab, size=n) for n in QWEN_SPEC_PROMPTS]
    torch.cuda.synchronize()
    reset_launches()
    sreqs = [ssrv.submit(p, QWEN_SPEC_NEW) for p in prompts]
    ssrv.drain()
    counts = read_launches()
    rounds = ssrv.batcher.spec_rounds
    schunks = prefill_calls(prompts, CHUNK)
    check(counts["rebranch_matmul"] == per_pass * (schunks + rounds)
          and sum(counts.values()) == counts["rebranch_matmul"],
          f"spec: expected {per_pass} kernel-3 launches per prefill chunk "
          f"and per verify round (none in a draft), got {counts} for "
          f"{schunks} chunks + {rounds} rounds")
    for i, (r, p) in enumerate(zip(sreqs, prompts)):
        toks, _ = _solo_run(model, params, p, QWEN_SPEC_NEW, FAMILY_MAX_LEN)
        check(toks == r.tokens, f"qwen2-vl spec request {i}: tokens "
              f"{r.tokens} != plain greedy {toks}")
    check(ssrv.pool.blocks_in_use == 0 == ssrv.pool.blocks_reserved,
          "spec: blocks left")
    print(f"qwen2-vl spec_k={SPEC_K}: {len(sreqs)} requests x "
          f"{QWEN_SPEC_NEW} tokens equal plain greedy solo decode bit for "
          f"bit; {rounds} verify rounds, {counts['rebranch_matmul']} "
          f"kernel-3 launches ({per_pass} per chunk and per round)")
    spec_launches = counts["rebranch_matmul"]
    del ssrv
    qwen_embeds_prefill(model, params, per_pass, smi)
    torch.cuda.empty_cache()

    # the same parameters under the 'pallas' engine: kernel 4
    plaunches, pkernel = pallas_pass("qwen2-vl-2b-pallas", VLM_ARCH, params,
                                     QWEN_PALLAS_PROMPTS, QWEN_PALLAS_NEW,
                                     QWEN_SLOTS, per_pass, rng, smi,
                                     layers=QWEN_LAYERS)
    del params
    torch.cuda.empty_cache()
    print(f"phase 25: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "spec_launches": spec_launches,
            "pallas_launches": plaunches, "tokens_per_s": rate,
            "split": split, "pallas_kernel": pkernel}


def musicgen_generate(model, params, tokens, new: int):
    """``launch/steps.py``'s model-level path: ``make_prefill_step`` on
    [B, S, Q] tokens, then ``new - 1`` greedy ``make_serve_step`` calls.
    Returns (tokens [B, new, Q], prefill logits, first decode step
    logits, CUDA-event ms per decode step)."""
    from repro_torch.launch import steps
    cfg = model.cfg
    dev = tokens.device
    firsts = []
    decode = model.decode_step

    def recording(p, tok, cache):
        logits, cache = decode(p, tok, cache)
        if not firsts:
            firsts.append(logits.float().cpu())
        return logits, cache

    model.decode_step = recording
    try:
        logits, cache = steps.make_prefill_step(
            cfg, tokens.shape[0], MUSICGEN_MAX_LEN, model, device=dev)(
                params, {"tokens": tokens})
        check(bool(torch.isfinite(logits).all()),
              "musicgen: non-finite prefill logits")
        serve = steps.make_serve_step(cfg, model)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)     # [B, 1, Q]
        out, ms = [tok], []
        for _ in range(new - 1):
            (tok, cache), ev, _ = timed_step(
                lambda: serve(params, {"tokens": tok}, cache))
            out.append(tok)
            ms.append(ev)
    finally:
        del model.decode_step
    return torch.cat(out, 1).cpu(), logits.float().cpu(), firsts[0], ms


def phase_musicgen(smi: str) -> dict:
    """Phase 26: full-width MusicGen-large (4 codebooks) served at model
    level through ``make_prefill_step`` / ``make_serve_step`` under
    ``pallas_fused``: kernel 3 behind its 289 ROM linears (the codebook
    head among them); batched == solo; a batched prefill's kernel-3 calls
    held to the plain version; layer 0 and the head on the CPU."""
    from repro_torch.core import rebranch as rebranch_lib
    from repro_torch.kernels import rebranch_matmul as rm
    from repro_torch.models import layers
    t_phase = time.perf_counter()
    print(f"phase 26 on {smi}")
    model = family_cell("musicgen-large", AUDIO_ARCH)
    cfg = model.cfg
    per_pass = sum(family_kernel_sites(cfg).values())
    check(per_pass == 6 * cfg.num_layers + 1,
          f"musicgen per pass {per_pass}")
    params = family_params(model)
    dev = params["ln_f"]["sram"]["scale"].device
    q = cfg.num_codebooks
    gen = torch.Generator().manual_seed(26)
    prompt = torch.randint(0, cfg.vocab_size,
                           (MUSICGEN_ROWS, MUSICGEN_PROMPT, q),
                           generator=gen).to(dev)
    musicgen_generate(model, params, prompt[:, :8], 3)       # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    toks, pre, first, ms = musicgen_generate(model, params, prompt,
                                             MUSICGEN_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    launches = counts["rebranch_matmul"]
    check(launches == per_pass * MUSICGEN_NEW
          and sum(counts.values()) == launches,
          f"musicgen: expected {per_pass} kernel-3 launches per prefill and "
          f"per decode step, got {counts}")
    check(tuple(toks.shape) == (MUSICGEN_ROWS, MUSICGEN_NEW, q)
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
          f"musicgen tokens {tuple(toks.shape)}")
    step_ms = sum(ms[2:]) / len(ms[2:])
    rate = MUSICGEN_ROWS * 1e3 / step_ms
    print(f"musicgen-large: {MUSICGEN_ROWS} rows x {MUSICGEN_PROMPT}-token "
          f"prompts x {q} codebooks, {MUSICGEN_NEW} greedy steps in "
          f"{wall * 1e3:.1f} ms (host clock, prefill included); decode step "
          f"{step_ms:.3f} ms (CUDA events, mean of steps 3-{len(ms)}), "
          f"{rate:.2f} tokens/s ({q} codebook ids each); {per_pass} "
          f"kernel-3 launches per pass ({launches}) [{smi}]")
    for i in (0, MUSICGEN_ROWS - 3):
        stoks, spre, sfirst, _ = musicgen_generate(
            model, params, prompt[i:i + 1], MUSICGEN_NEW)
        check(torch.equal(stoks[0], toks[i]) and torch.equal(spre[0], pre[i])
              and torch.equal(sfirst[0], first[i]),
              f"musicgen row {i}: batched != solo on the card")
    print(f"musicgen-large: rows 0 and {MUSICGEN_ROWS - 3} equal their solo "
          f"runs (prefill and first decode step logits, {MUSICGEN_NEW} "
          f"steps of tokens, bit for bit)")

    # one decode step recorded: layer 0's 6 linears, its attention and the
    # codebook head replayed on the CPU; kernel 3's calls of the step
    # rerun in the served order
    from repro_torch.launch import steps
    with PlainCheck(rm, "rebranch_trunk_sketch", rm.rebranch_matmul_plain,
                    "musicgen batched prefill", sketch=True) as chk:
        logits, cache = steps.make_prefill_step(
            cfg, MUSICGEN_ROWS, MUSICGEN_MAX_LEN, model, device=dev)(
                params, {"tokens": prompt})
    by_m = {}
    for (m, _, _), c in chk.shapes.items():
        by_m[m] = by_m.get(m, 0) + c
    # the blocks at M = rows x prompt, the codebook head on the last
    # position of each row
    check(by_m == {MUSICGEN_ROWS * MUSICGEN_PROMPT: per_pass - 1,
                   MUSICGEN_ROWS: 1},
          f"musicgen batched prefill: kernel-3 calls {chk.shapes}")
    print(f"musicgen-large batched prefill: all {per_pass} kernel-3 calls "
          f"against rebranch_matmul_plain: trunk torch.equal, t1 within "
          f"{chk.sketch_err:.2e} of its absmax: {chk.summary()}")
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    with Recorder(rebranch_lib, "apply_linear") as lin, \
            Recorder(layers, "apply_attention", keep=1,
                     clone_kw="cache") as att, torch.no_grad():
        model.decode_step(params, tok, cache)
    check(len(lin.calls) == per_pass, f"recorded {len(lin.calls)} linears")
    replay_linears("musicgen layer 0", ("q", "k", "v", "o", "up", "down"),
                   lin.calls[:6])
    replay_linears("musicgen", ("codebook_head",), lin.calls[-1:])
    replay_attention("musicgen layer 0", att.calls[0],
                     list(range(MUSICGEN_ROWS)))
    calls = [(a[1].reshape(-1, a[1].shape[-1]).contiguous(),
              a[0]["rom"]["w_q"], a[0]["rom"]["C"]) for a, _, _ in lin.calls]
    kernel = pass_times(rm.rebranch_trunk_sketch, rm.rebranch_matmul_plain,
                        calls, sketch=True)
    print_pass("musicgen-large", "kernel 3", kernel, smi)
    del params, lin, cache, calls
    torch.cuda.empty_cache()
    print(f"phase 26: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "step_ms": step_ms, "tokens_per_s": rate,
            "kernel": kernel}


def stacked_ste_check(params, dev):
    """Granite's layer-0 gate expert stack through
    ``moe.stacked_trunk_matmul`` under autograd on the card and on the
    CPU, no kernel launched: the forward ``torch.equal`` in f32 and in the
    served bf16; the straight-through dx (a batched GEMM on each device)
    within DX_RTOL of its absmax in f32 and within one bf16 ulp of it in
    bf16."""
    from repro_torch.models import moe
    rom = params["layers"]["moe"]["experts"]["gate"]["rom"]
    w_q, w_s = rom["w_q"][0], rom["w_scale"][0]
    e, d_in, d_out = w_q.shape
    gen = torch.Generator().manual_seed(271)
    x = torch.randn((e, 64, d_in), generator=gen)
    g = torch.randn((e, 64, d_out), generator=gen)
    reset_launches()
    for dt in (torch.float32, torch.bfloat16):
        outs = []
        for where in (dev, "cpu"):
            xx = x.to(where, dt).requires_grad_(True)
            y = moe.stacked_trunk_matmul(xx, w_q.to(where), w_s.to(where))
            (dx,) = torch.autograd.grad(y, xx, g.to(where, dt))
            outs.append((y.detach().cpu(), dx.cpu()))
        what = (f"granite stacked expert trunk [{e}, 64, {d_in}] x [{e}, "
                f"{d_in}, {d_out}], {dt}")
        check(torch.equal(outs[0][0], outs[1][0]),
              f"{what}: card forward != CPU forward")
        if dt == torch.float32:
            rel = ((outs[0][1] - outs[1][1]).abs().max()
                   / outs[1][1].abs().max()).item()
            print(f"{what}: forward card == CPU, STE dx {rel:.2e} of the "
                  f"absmax")
            check(rel <= DX_RTOL, f"{what}: STE dx off by {rel}")
        else:
            within_ulp(f"{what}: forward card == CPU; STE dx",
                       outs[1][1], outs[0][1])
    check(sum(read_launches().values()) == 0,
          "the stacked expert trunk launched a kernel")


def hymba_swap_check(model, plan, params, trainable, smi: str) -> int:
    """The trained Hymba branch (``trainable``) saved with
    ``save_branch``, registered from its checkpoint in a
    ``ScenarioStore`` and hot-swapped mid-stream into an ``LMServer``
    serving the untrained ``params``: the trunk tensors stay
    the same objects, and the requests after the swap give the tokens of a
    fresh server on the restored branch's tree.  Returns kernel-4
    launches."""
    import tempfile

    from repro_torch import scenario
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.core import rebranch
    from repro_torch.serve import server
    dev = params["ln_f"]["sram"]["scale"].device
    trunk = trunk_objects(params)
    ptrs = {k: t.data_ptr() for k, t in trunk.items()}
    rng = np.random.default_rng(272)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=n)
               for n in (9, 30, 17, 5)]
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        ckpt.save_branch(tmp, "trained", trainable, model_name=model.cfg.name,
                         plan=plan)
        store = scenario.ScenarioStore(model, plan, capacity=2, device=dev)
        store.register("base", branch=scenario.split_params(params)[0])
        store.register("trained", ckpt_dir=tmp)
        restored = ckpt.restore_branch(
            tmp, "trained", scenario.branch_template(model), plan=plan,
            model_name=model.cfg.name, device=dev)
        srv = server.LMServer(model, params, n_slots=SWAP_SLOTS,
                              max_len=FAMILY_MAX_LEN, store=store,
                              scenario="base")
        reset_launches()
        reqs = [srv.submit(p, SWAP_NEW, scenario="base")
                for p in prompts[:2]]
        srv.step()
        srv.swap_scenario("trained")
        reqs += [srv.submit(p, SWAP_NEW, scenario="trained")
                 for p in prompts[2:]]
        steps = srv.drain()
        counts = read_launches()
    check(srv.batcher.swap_count == 1 and srv.scenario == "trained",
          "hymba: the swap did not apply")
    check(same_trunk(srv.params, trunk, ptrs),
          "hymba: the swap copied or moved a trunk tensor")
    fresh = server.LMServer(
        model, rebranch.combine(restored, rebranch.partition(params)[1]),
        n_slots=SWAP_SLOTS, max_len=FAMILY_MAX_LEN)
    want = [fresh.submit(p, SWAP_NEW) for p in prompts[2:]]
    fresh.drain()
    check([r.tokens for r in reqs[2:]] == [r.tokens for r in want],
          "hymba: swapped tokens != a fresh cell's")
    base = server.LMServer(model, params, n_slots=SWAP_SLOTS,
                           max_len=FAMILY_MAX_LEN)
    want = [base.submit(p, SWAP_NEW) for p in prompts[:2]]
    base.drain()
    check([r.tokens for r in reqs[:2]] == [r.tokens for r in want],
          "hymba: the requests before the swap != the untrained cell's")
    print(f"hymba trained branch: saved, registered from its checkpoint, "
          f"swapped mid-stream ({len(reqs)} requests, {steps} steps, "
          f"{counts['cim_matmul']} kernel-4 launches); the tokens after the "
          f"swap equal a fresh cell's, those before the untrained cell's; "
          f"trunk unmoved [{smi}]")
    return counts["cim_matmul"]


def phase_family_train(dev, smi: str) -> dict:
    """Phase 27: each new family at full width, its depth cut to
    FAMILY_TRAIN_LAYERS, trained FAMILY_TRAIN_STEPS steps under 'pallas'
    (``launch/train.py``'s step at the CLI's batch 8 x seq 64): the loss
    finite and falling, every kernel-4 call of step 0 ``torch.equal`` to
    ``cim_matmul_plain``, kernel 4 once per ROM linear of the blocks a step
    plus the readout head once per loss chunk in the forward and again in
    the backward's recompute of that chunk (none in the STE backward),
    the ROM fingerprint and the trunk ``data_ptr``s unchanged.  Granite's
    stacked expert trunk under autograd card vs CPU; Hymba's trained
    branch hot-swapped into an ``LMServer``.  Returns kernel-4 launches
    per model."""
    from repro_torch import configs, deploy, optim
    from repro_torch import plan as plan_lib
    from repro_torch.core import rebranch, rom
    from repro_torch.data import synthetic
    from repro_torch.kernels import cim_matmul as cm
    from repro_torch.launch import steps
    t_phase = time.perf_counter()
    print(f"phase 27 on {smi}")
    out = {}
    for arch in FAMILY_TRAIN_ARCHS:
        t_model = time.perf_counter()
        cfg = dataclasses.replace(configs.get(arch),
                                  num_layers=FAMILY_TRAIN_LAYERS,
                                  remat=False)
        plan = plan_lib.solve(cfg, engine="pallas")
        model = deploy.compile_model(cfg, plan=plan)
        params = with_cores(model.init(seed=0),
                            torch.Generator().manual_seed(27))
        init_params = params
        trainable, frozen = rebranch.partition(params)
        opt = optim.init(trainable)
        trunk = trunk_objects(params)
        ptrs = {k: t.data_ptr() for k, t in trunk.items()}
        fp0 = rom.rom_fingerprint(params)
        step_fn = steps.make_train_step(cfg, optim.AdamWConfig(lr=TRAIN_LR),
                                        loss_chunks=TRAIN_CHUNKS,
                                        model=model)
        heads = sum(s.count for s in plan_lib.site_tree(cfg)
                    if s.name in ("lm_head", "codebook_head"))
        blocks = sum(family_kernel_sites(cfg).values()) - heads
        expect = blocks + 2 * TRAIN_CHUNKS * heads
        dcfg = synthetic.DataConfig(seed=0, vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH,
                                    num_codebooks=cfg.num_codebooks)
        losses, ev_ms, launches = [], [], 0
        for s in range(FAMILY_TRAIN_STEPS):
            batch = synthetic.markov_batch(dcfg, s, device=dev)
            reset_launches()
            if s == 0:
                # step 0 (left out of the mean step time): every kernel-4
                # call against cim_matmul_plain on its inputs
                with PlainCheck(cm, "cim_matmul", cm.cim_matmul_plain,
                                f"{arch} train step") as chk:
                    (trainable, opt, m), ev, _ = timed_step(
                        lambda: step_fn(trainable, frozen, opt, batch))
                check(sum(chk.shapes.values()) == expect,
                      f"{arch}: plain-checked {chk.shapes}")
                print(f"{arch} train step 0: all {expect} kernel-4 calls "
                      f"torch.equal to cim_matmul_plain: {chk.summary()}")
            elif s == 1:
                # step 1's kernel-4 calls, rerun in order after the loop
                with Recorder(cm, "cim_matmul") as rec:
                    (trainable, opt, m), ev, _ = timed_step(
                        lambda: step_fn(trainable, frozen, opt, batch))
            else:
                (trainable, opt, m), ev, _ = timed_step(
                    lambda: step_fn(trainable, frozen, opt, batch))
            counts = read_launches()
            check(counts["cim_matmul"] == expect
                  and sum(counts.values()) == expect,
                  f"{arch} step {s}: expected {expect} kernel-4 launches, "
                  f"got {counts}")
            launches += expect
            losses.append(float(m["loss"]))
            check(math.isfinite(losses[-1]), f"{arch} step {s}: loss "
                  f"{losses[-1]}")
            ev_ms.append(ev)
        kernel = pass_times(cm.cim_matmul, cm.cim_matmul_plain,
                            [a for a, _, _ in rec.calls], sketch=False)
        del rec
        print(f"{arch} kernel 4 over one train step's {kernel['launches']} "
              f"calls, rerun in order: {kernel['ms']:.3f} ms (device "
              f"{kernel['device_ms']:.3f}), plain {kernel['plain_ms']:.3f}, "
              f"bound {kernel['bound_ms']:.3f} ({kernel['bound_by']}), "
              f"torch._int_mm {kernel['library_ms']:.3f} (device "
              f"{kernel['library_device_ms']:.3f})")
        reset_launches()
        with torch.no_grad():
            p = rebranch.combine(trainable, frozen)
            steps.chunked_readout_loss(p, model.features(p, batch),
                                       batch["labels"], cfg, TRAIN_CHUNKS,
                                       model=model)
        fwd = read_launches()["cim_matmul"]
        check(fwd == blocks + TRAIN_CHUNKS * heads,
              f"{arch}: a forward launched {fwd} kernel-4 calls")
        check(losses[-1] < losses[0], f"{arch}: loss did not fall "
              f"({losses[0]:.4f} -> {losses[-1]:.4f})")
        params = rebranch.combine(trainable, frozen)
        check(same_trunk(params, trunk, ptrs),
              f"{arch}: training copied, replaced or moved a trunk tensor")
        check(rom.rom_fingerprint(params) == fp0,
              f"{arch}: the ROM fingerprint moved")
        step_ms = sum(ev_ms[2:]) / len(ev_ms[2:])
        print(f"{arch} at {FAMILY_TRAIN_LAYERS} layers, full width: loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} "
              f"steps (remat off); {expect} kernel-4 launches a step "
              f"({blocks} block "
              f"linears + the head {heads} x {TRAIN_CHUNKS} chunks x 2), a "
              f"forward {fwd}, so none in the STE backward; step "
              f"{step_ms:.3f} ms (CUDA events, mean of steps 3-"
              f"{len(ev_ms)}), {TRAIN_BATCH * TRAIN_SEQ * 1e3 / step_ms:.0f} "
              f"trained tokens/s; ROM fingerprint and trunk unchanged "
              f"({time.perf_counter() - t_model:.1f} s) [{smi}]")
        entry = {"launches": launches, "per_step": expect,
                 "step_ms": step_ms, "loss": (losses[0], losses[-1]),
                 "kernel": kernel}
        if arch == "granite_moe_3b":
            stacked_ste_check(params, dev)
        if arch == "hymba_1_5b":
            entry["swap_launches"] = hymba_swap_check(
                model, plan, init_params, trainable, smi)
        out[arch] = entry
        del params, init_params, trainable, frozen, opt, trunk, batch, p
        torch.cuda.empty_cache()
    print(f"phase 27: {time.perf_counter() - t_phase:.1f} s")
    return out


TUNE_MODEL, TUNE_SIZE, TUNE_BATCHES = "tiny_yolo", 32, (1, 8)   # phase 28
TUNE_REPEAT = 2
TUNE_MODES = ("ideal", "per_subarray", "bitserial")
# phase 29: (registry id, family, input size), served with tune=True
TUNED_SERVED = (("tiny-yolo-416", "tiny_yolo", 416),
                ("vgg8-32-tuned", "vgg8", 32))
TUNED_RUNS, TUNED_CHUNKS = 3, 8


def phase_tune(dev, smi: str) -> dict:
    """28. The checked-in table's static check; the autotuner over
    Tiny-YOLO's sites (every legal plan bitwise equal to the rule's);
    DarkNet-19/416 at batch 8 with the table on against ``tune=False``."""
    from repro_torch import deploy
    from repro_torch.kernels import rebranch_conv as rc
    from repro_torch.kernels import tiling
    from repro_torch.models import cnn
    from repro_torch.serve import registry
    from repro_torch.tune import autotune, table
    t0 = time.perf_counter()
    check(autotune.check_table(), "hopper_table.json fails its check")
    meta = json.load(open(table._DEFAULT_PATH))["meta"]
    print(f"table generated on {meta['device']} (this card: {smi})")

    geoms = autotune.conv_geometries((TUNE_MODEL,), (TUNE_SIZE,), TUNE_MODES,
                                     tiling.TUNED_KERNELS, TUNE_BATCHES)
    print(f"autotuner over {TUNE_MODEL} at {TUNE_SIZE}x{TUNE_SIZE}, batches "
          f"{TUNE_BATCHES}, {len(geoms)} geometries (device ms per launch, "
          f"replayed CUDA graph, best of {TUNE_REPEAT}):")
    print("geometry candidates dropped rule_ms best_ms speedup best_plan")
    n_cands = n_dropped = n_changed = 0
    for g in geoms:
        res = autotune.tune_geometry(g, repeat=TUNE_REPEAT, device=dev)
        n_cands += res.n_candidates
        n_dropped += res.n_mismatched
        n_changed += res.changed
        print(f"{g.key} {res.n_candidates} {res.n_mismatched} "
              f"{res.default_ms:.4f} {res.best_ms:.4f} {res.speedup:.3f} "
              f"{autotune.describe(res.best) if res.changed else 'rule'}",
              flush=True)
    print(f"autotuner: {len(geoms)} geometries, {n_cands} candidates, "
          f"{n_dropped} dropped, {n_changed} won by another plan than the "
          f"rule's; {time.perf_counter() - t0:.1f} s")
    check(n_dropped == 0, f"{n_dropped} legal plans moved a bit")

    cfg = registry.resolve("darknet19-416").config()
    on, plan = registry.compile_entry("darknet19-416")
    off = deploy.compile_model(cfg, plan=plan, tune=False)
    sites = cnn.conv_site_shapes(on.cfg)
    entries = table.load_table()
    params = with_cores(on.init(seed=0), torch.Generator().manual_seed(2))
    images = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (BATCH, SIZE, SIZE, 3), dtype=np.float32)).to(dev)
    out = {}
    for batch in (BATCH, 1):
        x = images[:batch]
        tuned = sum(
            entries[table.key("trunk_conv", "ideal", "float32",
                              batch * hw * hw, k * k * c_in, c_out)]
            != tiling.rule_plan("trunk_conv", "ideal", batch * hw * hw,
                                k * k * c_in, c_out)
            for _, k, c_in, c_out, hw, _ in sites)
        with torch.no_grad():
            reset_launches()
            y_on = on.forward(params, x)
            y_off = off.forward(params, x)
            torch.cuda.synchronize()
            counts = read_launches()
            check(counts["trunk_conv"] == 2 * len(sites),
                  f"{counts} launches for two forwards of {len(sites)} "
                  f"sites")
            check(torch.equal(y_on, y_off), f"DarkNet-19 at batch {batch} "
                  f"with the table on != with tune=False")
            on_ms = time_ms(lambda: on.forward(params, x), 5)
            off_ms = time_ms(lambda: off.forward(params, x), 5)
            trunk = {}
            for name, model in (("on", on), ("off", off)):
                calls = []
                dot = rc.trunk_conv_dot

                def recording(*args, **kwargs):
                    calls.append((args, kwargs))
                    return dot(*args, **kwargs)

                rc.trunk_conv_dot = recording
                try:
                    model.forward(params, x)
                finally:
                    rc.trunk_conv_dot = dot
                scope = (table.disabled() if model.tune is False
                         else contextlib.nullcontext())

                def run(calls=calls):
                    return [dot(*a, **k) for a, k in calls]

                with scope:          # eager (host included), and the graph
                    trunk[name] = (time_ms(run, 5),
                                   time_graph_ms(run, [()], 3))
        print(f"DarkNet-19/416, batch {batch}: table on == tune=False bit "
              f"for bit ({tuned} of {len(sites)} sites take another plan "
              f"than the rule's); forward {on_ms:.3f} ms on, {off_ms:.3f} "
              f"ms off (CUDA events, eager); kernel 1's {len(sites)} "
              f"launches {trunk['on'][0]:.3f} ms on, {trunk['off'][0]:.3f} "
              f"ms off (eager), {trunk['on'][1]:.3f} and "
              f"{trunk['off'][1]:.3f} ms (device, graph replay)")
        out[batch] = {"forward_on_ms": on_ms, "forward_off_ms": off_ms,
                      "trunk_on_ms": trunk["on"],
                      "trunk_off_ms": trunk["off"], "tuned_sites": tuned}
    del params, images, x, y_on, y_off
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"phase 28 {secs:.1f} s")
    return {"darknet19": out, "changed": n_changed,
            "geometries": len(geoms), "s": secs}


def phase_tuned_serve(smi: str) -> dict:
    """29. Tiny-YOLO at 416x416 and VGG-8 at 32x32 from the registry with
    ``tune=True``, served through ``CNNServer``."""
    from repro_torch.models import cnn
    from repro_torch.serve import registry, server
    t0 = time.perf_counter()
    out = {}
    for model_id, name, size in TUNED_SERVED:
        registry.register(registry.ModelEntry(
            model_id=model_id, engine="pallas_fused", tune=True,
            config=lambda n=name, s=size: cnn.CNNConfig(name=n,
                                                        input_size=s)))
        model, _ = registry.compile_entry(model_id)
        check(model.tune is True, f"{model_id}: tune not forwarded")
        n_sites = len(cnn.conv_site_shapes(model.cfg))
        params = with_cores(model.init(seed=0),
                            torch.Generator().manual_seed(2))
        srv = server.load(model_id, params=params, n_slots=SLOTS)
        rng = np.random.default_rng(7)
        images = rng.standard_normal((SLOTS, size, size, 3),
                                     dtype=np.float32)
        srv.submit(images)                         # warm-up, not counted
        torch.cuda.synchronize()
        reset_launches()
        batched = srv.submit(images)
        solo = [srv.submit(images[i:i + 1]) for i in (0, SLOTS - 1)]
        counts = read_launches()
        check(counts == {"trunk_conv": 3 * n_sites, "cim_matmul": 0,
                         "rebranch_matmul": 0},
              f"{model_id}: {counts} for 3 chunks of {n_sites} sites")
        check(bool(np.isfinite(batched).all()), f"{model_id}: non-finite")
        for i, row in zip((0, SLOTS - 1), solo):
            check(np.array_equal(row[0], batched[i]),
                  f"{model_id}: image {i} solo != batched")
        n_img = TUNED_CHUNKS * SLOTS
        many = rng.standard_normal((n_img, size, size, 3), dtype=np.float32)
        rates = []
        for _ in range(TUNED_RUNS):
            t1 = time.perf_counter()
            srv.submit(many)
            rates.append(n_img / (time.perf_counter() - t1))
        _, n_calls, worst, _, cpu_s = cpu_layers(model, params, images[:1])
        check(worst <= LAYER_RTOL,
              f"{model_id}: a layer on the card disagrees with the CPU")
        spread = (max(rates) - min(rates)) / min(rates)
        print(f"{model_id} (tune=True, pallas_fused, {n_sites} sites): "
              f"batched == solo bit for bit; {n_sites} trunk launches per "
              f"chunk; {n_calls} conv layers within {worst:.3e} of the CPU's "
              f"absmax ({cpu_s:.1f} s); images/s over {TUNED_RUNS} runs of "
              f"{n_img}: " + ", ".join(f"{r:.2f}" for r in rates)
              + f" (spread {spread:.2%})", flush=True)
        out[model_id] = {"images_per_s": sum(rates) / len(rates),
                         "spread": spread, "worst_layer": worst}
        registry.evict(model_id)
        del srv, params, many
        torch.cuda.empty_cache()
    print(f"phase 29 {time.perf_counter() - t0:.1f} s")
    return out


SHARD_MESHES = ((4, 1), (2, 2))   # phase 30: (data, model); H over data
SHARD_RANKS = 4
SHARD_REQUESTS = (8, 5)
SHARD_TIMED = 3                   # timed forwards per rank and mesh
SHARD_DEADLINE_S = 300


def sharded_layer_checks(mesh, calls) -> tuple[int, float]:
    """Phase 30, one rank: every layer the unsharded forward recorded, run
    again under ``mesh`` on this rank's slab of its input.  At each ROM
    site the sharded trunk must be ``torch.equal`` to this rank's rows of
    the unsharded 'pallas' trunk: ``ideal`` on the whole batch, the ADC
    modes on image 0.  The whole layer (trunk, branch, epilogue) must be
    within LAYER_RTOL of its output's absmax.  Returns (sites, worst)."""
    from repro_torch import engine
    from repro_torch.core import cim
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import cnn
    n, r = mesh.shape["data"], mesh.coordinate("data")
    pallas, sharded = engine.get("pallas"), engine.get("pallas_sharded")
    sites, worst = 0, 0.0
    for i, (p, xin, spec, stride, ep, y) in enumerate(calls):
        a, b = shd.h_layout(y.shape[1], n)[r]
        if spec.enabled:
            spec = dataclasses.replace(spec, trunk_impl="pallas_sharded")
        with torch.no_grad(), shd.use_mesh(mesh):
            yl = cnn.apply_conv(p, shd.shard(xin, "cnn_batch", "cnn_h"),
                                spec, stride, ep)
        check(yl.shape[1] == b - a, f"layer {i}: {yl.shape[1]} rows, not "
              f"{b - a}")
        if b > a:
            worst = max(worst, ((yl - y[:, a:b]).abs().max()
                                / y.abs().max()).item())
        if not spec.enabled:
            continue
        sites += 1
        w_q, w_s = p["rom"]["w_q"], p["rom"]["w_scale"]
        for mode, xs in (("ideal", xin),
                         *((m, xin[:1]) for m in ADC_MODES)):
            c = cim.CiMConfig(mode=mode)
            with torch.no_grad(), shd.use_mesh(mesh):
                got = sharded.conv(c, shd.shard(xs, "cnn_batch", "cnn_h"),
                                   w_q, w_s, stride=stride)
                want = pallas.conv(c, xs, w_q, w_s, stride=stride)
            check(torch.equal(got, want[:, a:b]),
                  f"layer {i} ({mode}): the sharded trunk on rank "
                  f"{mesh.coordinate('data')} != the unsharded trunk's rows")
    check(worst <= LAYER_RTOL, f"a sharded layer is {worst} of its absmax "
          f"from the unsharded one")
    return sites, worst


def phase_sharded_rank(rank: int, world: int, size: int) -> dict:
    """Phase 30, one spawned rank: DarkNet-19 at ``size`` served H-sharded
    on each mesh of SHARD_MESHES, held to the unsharded 'pallas' model."""
    import hashlib

    import torch.distributed as dist
    from repro_torch import deploy
    from repro_torch import device as device_lib
    from repro_torch.core import rom
    from repro_torch.distributed import sharding as shd
    from repro_torch.engine import sharded as sharded_engine
    from repro_torch.kernels import _build
    from repro_torch.kernels import rebranch_conv as rc
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import cnn
    from repro_torch.serve import server
    check(_build.target("trunk_conv").exists(),
          "kernel 1 is not built: the parent builds it before the ranks")
    dev = device_lib.resolve()
    cfg = cnn.CNNConfig(name="darknet19", input_size=size, fuse_bn_act=True)
    plain = deploy.compile_model(cfg, engine="pallas")
    params = with_cores(plain.init(seed=0), torch.Generator().manual_seed(2))
    prints = [None] * world
    dist.all_gather_object(prints, rom.rom_fingerprint(params))
    check(len(set(prints)) == 1, "ROM fingerprints differ across ranks")
    images = np.random.default_rng(30).standard_normal(
        (BATCH, size, size, 3), dtype=np.float32)
    x = torch.from_numpy(images).to(dev)

    calls, apply_conv = [], cnn.apply_conv

    def recording(p, xx, spec, stride=1, epilogue=None):
        y = apply_conv(p, xx, spec, stride, epilogue)
        calls.append((p, xx, spec, stride, epilogue, y))
        return y

    cnn.apply_conv = recording
    try:
        with torch.no_grad():
            y_plain = plain.forward(params, x)
    finally:
        cnn.apply_conv = apply_conv
    check(len(calls) == 21, f"recorded {len(calls)} conv layers, not 21")
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        moved = plain.forward(params, x * (1 + 1e-7 * noise.to(dev)))
    amax = y_plain.abs().max().item()
    out = {"self_moved": (moved - y_plain).abs().max().item() / amax,
           "fingerprint": prints[0][:16]}
    plain_ms = []
    for _ in range(SHARD_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            plain.forward(params, x)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    out["plain_ms"] = plain_ms

    for shape in SHARD_MESHES:
        mesh = mesh_lib.make_mesh(shape, backend="gloo")
        model = deploy.compile_model(cfg, engine="pallas_sharded", mesh=mesh)
        res = out[f"{shape[0]}x{shape[1]}"] = {"repr": repr(model)}
        slabs, dot = [], rc.trunk_conv_dot

        def recording_dot(xx, w_q, stride=1, padding="SAME", cfg=rc.IDEAL,
                          plan=None):
            slabs.append((xx, w_q, stride, padding, cfg))
            return dot(xx, w_q, stride, padding, cfg, plan)

        # the main path: a forward, then CNNServer requests of 8 and 5
        dist.barrier()
        torch.cuda.synchronize()
        reset_launches()
        sharded_engine.fallbacks = 0
        shd.reset_traffic()
        rc.trunk_conv_dot = recording_dot
        try:
            with torch.no_grad():
                y = model.forward(params, x)
            torch.cuda.synchronize()
        finally:
            rc.trunk_conv_dot = dot
        res["forward_launches"] = read_launches()["trunk_conv"]
        res["traffic"] = (dict(shd.rows_sent), dict(shd.bytes_sent))
        srv = server.CNNServer(model, params, n_slots=SLOTS)
        served = [srv.submit(images[:b]) for b in SHARD_REQUESTS]
        counts = read_launches()
        res["launches"] = counts["trunk_conv"]
        res["fallbacks"] = sharded_engine.fallbacks
        # one launch per site at which this rank holds output rows (every
        # site at 416: each rank holds rows down to the 13x13 stage)
        n, r = mesh.shape["data"], mesh.coordinate("data")
        per_forward = sum(
            b > a for _, _, _, _, _, hw, _ in cnn._conv_sites(cfg)
            for a, b in [shd.h_layout(hw, n)[r]])
        check(res["forward_launches"] == per_forward,
              f"{res['forward_launches']} kernel-1 launches in a sharded "
              f"forward, not {per_forward}")
        check(counts == {"trunk_conv": per_forward
                         * (1 + len(SHARD_REQUESTS)),
                         "cim_matmul": 0, "rebranch_matmul": 0},
              f"{counts} over a forward and {len(SHARD_REQUESTS)} chunks")
        check(res["fallbacks"] == 0, f"{res['fallbacks']} gathered layers")
        check(y.shape == y_plain.shape and bool(torch.isfinite(y).all()),
              "sharded forward output")
        res["whole"] = (y - y_plain).abs().max().item() / amax
        check(np.array_equal(served[0], y.cpu().numpy()),
              "CNNServer's 8 images != the sharded forward")
        digests = [None] * world
        dist.all_gather_object(digests, [hashlib.sha256(o.tobytes())
                                         .hexdigest() for o in served])
        check(all(d == digests[0] for d in digests),
              "CNNServer returned other arrays on other ranks")
        short = SHARD_REQUESTS[1]
        res["served_rel"] = float(np.abs(
            served[1] - y_plain[:short].cpu().numpy()).max() / amax)

        # kernel 1 at every slab geometry of the sharded forward
        geoms = {}
        for xx, w_q, stride, padding, c in slabs:
            geoms.setdefault((tuple(xx.shape), tuple(w_q.shape), stride,
                              padding), (xx, w_q, stride, padding, c))
        for (xs, ws, stride, padding), (xx, w_q, _, _, c) in geoms.items():
            check(padding == "VALID", f"slab {xs} launched {padding}")
            got = dot(xx, w_q, stride, padding, c)
            want = plain_trunk(xx, w_q, c, stride, padding)
            check(torch.equal(got, want), f"kernel 1 at slab {xs} x {ws} "
                  f"!= its plain version")
        res["geometries"] = sorted(geoms)
        del geoms

        # kernel 1's launches of one sharded forward, timed on rank 0 with
        # the other ranks idle at a barrier, beside the unsharded forward's
        # 20 launches, the plain version and the bound
        dist.barrier()
        if rank == 0:
            def sharded_pass():
                for xx, w_q, stride, padding, c in slabs:
                    dot(xx, w_q, stride, padding, c)

            def unsharded_pass():
                for xx, w_q, stride in whole:
                    dot(xx, w_q, stride, "SAME")

            whole = [(xin.float().contiguous(), p["rom"]["w_q"], stride)
                     for p, xin, spec, stride, _, _ in calls if spec.enabled]
            bound = ops = 0.0
            for xx, w_q, stride, _, _ in slabs:
                k, _, c_in, c_out = w_q.shape
                m = xx.shape[0] * (xx.shape[1] - k + 1) * (xx.shape[2] - k
                                                           + 1)
                b, _ = trunk_bound_ms(m, k * k * c_in, c_out, xx.numel())
                bound += b
                ops += 2.0 * m * k * k * c_in * c_out / PEAK_INT8_OPS * 1e3
            res["kernel"] = {
                "ms": time_ms(sharded_pass, 5),
                "plain_ms": time_ms(lambda: [plain_trunk(xx, w_q, c, st, pd)
                                             for xx, w_q, st, pd, c in slabs],
                                    2),
                "bound_ms": bound, "bytes_ms": bound if bound > ops else 0.0,
                "unsharded_ms": time_ms(unsharded_pass, 5)}
        dist.barrier()
        del slabs

        res["sites"], res["worst_layer"] = sharded_layer_checks(mesh, calls)
        times = []
        for _ in range(SHARD_TIMED):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                model.forward(params, x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        res["forward_ms"] = times
        torch.cuda.empty_cache()
    return out


def phase_sharded(smi: str) -> dict:
    """30. DarkNet-19/416 served H-sharded over a 4-rank gloo mesh on the
    one card (4x1 and 2x2), held to the unsharded 'pallas' model."""
    from repro_torch.kernels import halo_conv
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import cnn
    t0 = time.perf_counter()
    print(f"phase 30 on {smi}: DarkNet-19/{SIZE} at batch {BATCH}, "
          f"pallas_sharded, {SHARD_RANKS} gloo ranks on one card; the "
          f"ranks time-share the card, so the host times are no scaling "
          f"figure")
    ranks = mesh_lib.spawn(phase_sharded_rank, SHARD_RANKS, backend="gloo",
                           args=(SIZE,), deadline_s=SHARD_DEADLINE_S)
    sites = cnn._conv_sites(cnn.CNNConfig(name="darknet19", input_size=SIZE))
    print(f"ROM fingerprint {ranks[0]['fingerprint']}... equal on "
          f"{SHARD_RANKS} ranks; unsharded forward host ms per rank: "
          + "; ".join(", ".join(f"{t:.2f}" for t in r["plain_ms"])
                      for r in ranks))
    launches, kernel = {}, {}
    for shape in SHARD_MESHES:
        key = f"{shape[0]}x{shape[1]}"
        res = [r[key] for r in ranks]
        n, groups = shape[0], SHARD_RANKS // shape[0]
        halo = gather = 0
        for _, k, c_in, _, hw, _, _ in sites:
            if k == 1:
                continue            # 1x1 convs exchange nothing
            for c in (c_in, max(1, c_in // 4)):   # the trunk, the core
                halo += halo_conv.halo_bytes((BATCH, hw, hw, c), k, 1,
                                             "SAME", n)
                gather += (n - 1) * BATCH * hw * hw * c * 4
        sent = {kind: sum(r["traffic"][1].get(kind, 0) for r in res)
                for kind in ("halo", "relayout", "gather")}
        relayout_rows = sum(r["traffic"][0].get("relayout", 0) for r in res)
        geoms = sorted({g for r in res for g in r["geometries"]})
        print(f"mesh {key} ({res[0]['repr']}): {res[0]['sites']} sites "
              f"torch.equal to the unsharded trunk (ideal, batch "
              f"{BATCH}; {', '.join(ADC_MODES)}, image 0), layers within "
              f"{max(r['worst_layer'] for r in res):.3e} of their absmax, "
              f"{len(geoms)} slab geometries of kernel 1 (all ranks) "
              f"torch.equal to the plain version; fallbacks "
              f"{[r['fallbacks'] for r in res]}; kernel-1 launches per "
              f"rank {[r['forward_launches'] for r in res]} a forward, "
              f"{[r['launches'] for r in res]} over the forward and "
              f"requests of {SHARD_REQUESTS}")
        print(f"  whole forward vs unsharded: {res[0]['whole']:.3e} of the "
              f"absmax (the unsharded model moves {ranks[0]['self_moved']:.3e}"
              f" under a 1e-7 input perturbation); CNNServer equal on "
              f"every rank, the {SHARD_REQUESTS[1]}-image request "
              f"{res[0]['served_rel']:.3e} from unsharded")
        print(f"  per forward over the world: halo_bytes sum "
              f"{halo * (n - 1) * groups} (per device pair {halo}), bytes "
              f"sent {sent['halo']} halo + {sent['relayout']} re-layout "
              f"({relayout_rows} rows) + {sent['gather']} head gather; an "
              f"all-gather of the same conv inputs {gather * groups}")
        print(f"  forward host ms per rank: " + "; ".join(
            ", ".join(f"{t:.2f}" for t in r["forward_ms"]) for r in res))
        print("  slab geometries (x x W, VALID, stride 1): "
              + " ".join(f"{xs}x{ws}" for xs, ws, _, _ in geoms))
        k = res[0]["kernel"]
        print(f"  kernel 1, rank 0's {res[0]['forward_launches']} slab "
              f"launches of a forward (the other ranks idle): "
              f"{k['ms']:.3f} ms, plain {k['plain_ms']:.3f} ms, bound "
              f"{k['bound_ms']:.3f} ms; the unsharded forward's 20 "
              f"launches {k['unsharded_ms']:.3f} ms (CUDA events)")
        launches[key] = [r["launches"] for r in res]
        kernel[key] = k
    print(f"phase 30 {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "kernel": kernel}


# ---------------------------------------------------------------------------
# phase 31: branch training over a mesh of ranks
# ---------------------------------------------------------------------------

DIST_RANKS = 4
DIST_MESH = (2, 2, 1), ("pod", "data", "model")   # batch over pod, H over data
DIST_LM_MESH = (4, 1)                             # (data, model)
DIST_RESTORE_MESH = (4, 1)
DIST_STEPS = 3
DIST_DX_IMAGES = 2            # one image a pod block
DIST_REDUCE_REPS = 3
GRAD_RTOL = 1e-5              # reduced gradients vs the unsharded step
# bf16: the mesh's step vs the whole-batch step, as a multiple of the gap
# between the whole-batch step and its rows run as the ranks' blocks in
# one process (bf16 rounding, no mesh)
BF16_GAP_FACTOR = 2.0
COMPRESS_RTOL = 5e-2          # the int8 mean vs the plain mean
DIST_DEADLINE_S = 300


def slab_times(slabs, dot) -> dict:
    """Kernel 1 over the recorded slab launches ``(x, w_q, stride,
    padding, cfg)`` of one forward: ms (CUDA events), plain_ms and the
    bound, from the slabs' own shapes."""
    bound = ops = 0.0
    for xx, w_q, stride, _, _ in slabs:
        k, _, c_in, c_out = w_q.shape
        m = xx.shape[0] * (xx.shape[1] - k + 1) * (xx.shape[2] - k + 1)
        b, _ = trunk_bound_ms(m, k * k * c_in, c_out, xx.numel())
        bound += b
        ops += 2.0 * m * k * k * c_in * c_out / PEAK_INT8_OPS * 1e3
    return {"ms": time_ms(lambda: [dot(xx, w_q, st, pd, c)
                                   for xx, w_q, st, pd, c in slabs], 5),
            "plain_ms": time_ms(lambda: [plain_trunk(xx, w_q, c, st, pd)
                                         for xx, w_q, st, pd, c in slabs],
                                2),
            "bound_ms": bound, "bytes_ms": bound if bound > ops else 0.0,
            "bound_by": "bytes" if bound > ops else "operations"}


def check_slabs(slabs, dot) -> list:
    """Kernel 1 at every distinct slab geometry ``torch.equal`` to its
    plain version; returns the geometries."""
    geoms = {}
    for xx, w_q, stride, padding, c in slabs:
        geoms.setdefault((tuple(xx.shape), tuple(w_q.shape), stride,
                          padding), (xx, w_q, stride, padding, c))
    for (xs, ws, stride, padding), (xx, w_q, _, _, c) in geoms.items():
        check(padding == "VALID", f"slab {xs} launched {padding}")
        check(torch.equal(dot(xx, w_q, stride, padding, c),
                          plain_trunk(xx, w_q, c, stride, padding)),
              f"kernel 1 at slab {xs} x {ws} != its plain version")
    return sorted(geoms)


def digests(tree) -> list:
    import hashlib

    from repro_torch import bridge
    return [hashlib.sha256(t.detach().float().cpu().numpy().tobytes())
            .hexdigest() for t in bridge.flatten(tree).values()]


def worst_leaf(got, want) -> tuple[float, str]:
    """The leaf of ``got`` farthest from ``want``'s, as (max |diff| over
    the leaf's absmax, name)."""
    from repro_torch import bridge
    ref = bridge.flatten(want)
    return max(((got_l.float() - ref[k].float()).abs().max().item()
                / max(ref[k].float().abs().max().item(), 1e-30), k)
               for k, got_l in bridge.flatten(got).items())


def agreed(what, value, world: int):
    """``value`` (picklable) all-gathered; checked equal on every rank."""
    import torch.distributed as dist
    seen = [None] * world
    dist.all_gather_object(seen, value)
    check(all(s == seen[0] for s in seen), f"{what} differs across ranks")


def timed_host_ms(fn, reps: int) -> list:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def dist_cnn_rank(rank: int, world: int, size: int, res: dict):
    """Phase 31(a) and (c) on one rank: DarkNet-19 branch steps on
    DIST_MESH, then elastic restore of their state onto
    DIST_RESTORE_MESH."""
    import shutil

    import torch.distributed as dist
    from repro_torch import bridge, deploy, engine, optim
    from repro_torch import device as device_lib
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.core import rebranch, rom
    from repro_torch.core.rebranch import trunk_conv_ste_bwd
    from repro_torch.distributed import sharding as shd
    from repro_torch.engine import sharded as sharded_engine
    from repro_torch.kernels import rebranch_conv as rc
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import cnn
    cfg = cnn.CNNConfig(name="darknet19", input_size=size)
    plain = deploy.compile_model(cfg, engine="pallas")
    params = with_cores(plain.init(seed=0), torch.Generator().manual_seed(2))
    fp0 = rom.rom_fingerprint(params)
    mesh = mesh_lib.make_mesh(*DIST_MESH, backend="gloo")
    model = deploy.compile_model(cfg, engine="pallas_sharded", mesh=mesh)
    dev = device_lib.resolve()
    gen = torch.Generator().manual_seed(31)
    x = torch.randn((BATCH, size, size, 3), generator=gen).to(dev)
    y = torch.randn((BATCH, size // 32, size // 32, cfg.head_anchors,
                     5 + cfg.head_classes), generator=gen).to(dev)
    batch = {"x": x, "y": y}
    loss_of = lambda m: (lambda p, b: ((m.forward(p, b["x"]) - b["y"]) ** 2)
                         .mean())
    opt_cfg = optim.AdamWConfig(lr=1e-3)
    step = steps.BranchStep(loss_of(model), opt_cfg)
    trainable, frozen = rebranch.partition(params)
    opt = optim.init(trainable)
    sites = sum(1 for s in cnn._conv_sites(cfg))
    n, r = mesh.shape["data"], mesh.coordinate("data")
    per_forward = sum(b > a for _, _, _, _, _, hw, _ in cnn._conv_sites(cfg)
                      for a, b in [shd.h_layout(hw, n)[r]])
    out = res["cnn"] = {"sites": sites, "per_forward": per_forward,
                        "step_ms": [], "launches": 0}
    dot, slabs = rc.trunk_conv_dot, []

    def recording_dot(xx, w_q, stride=1, padding="SAME", cfg=rc.IDEAL,
                      plan=None):
        slabs.append((xx, w_q, stride, padding, cfg))
        return dot(xx, w_q, stride, padding, cfg, plan)

    for s in range(DIST_STEPS):
        dist.barrier()
        torch.cuda.synchronize()
        reset_launches()
        sharded_engine.fallbacks = 0
        shd.reset_traffic()
        if s == 0:
            rc.trunk_conv_dot = recording_dot
        t0 = time.perf_counter()
        try:
            with shd.use_mesh(mesh):
                loss, grads = step.grads(trainable, frozen, batch)
        finally:
            rc.trunk_conv_dot = dot
        new_t, new_opt, _ = optim.update(grads, opt, trainable, opt_cfg)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        counts = read_launches()
        check(counts == {"trunk_conv": per_forward, "cim_matmul": 0,
                         "rebranch_matmul": 0},
              f"step {s}: {counts}, not {per_forward} kernel-1 launches "
              f"(one per ROM conv of the forward, none in the backward)")
        check(sharded_engine.fallbacks == 0,
              f"step {s}: {sharded_engine.fallbacks} gathered layers")
        check(bool(torch.isfinite(loss)), f"step {s}: loss {loss}")
        out["launches"] += counts["trunk_conv"]
        agreed(f"step {s}'s reduced gradients", digests(grads), world)
        if s == 0:
            out["traffic"] = dict(shd.bytes_sent)
            out["loss0"] = float(loss)
            first = (trainable, grads)
        trainable, opt = new_t, new_opt
        out.setdefault("loss", []).append(float(loss))
    agreed("the trainable and opt state after the steps",
           (digests(trainable), digests(opt)), world)
    out["geometries"] = check_slabs(slabs, dot)
    # all-reduce ms: the reduction of the reduced gradients again
    out["reduce_ms"] = timed_host_ms(
        lambda: steps.reduce_grads(loss, grads, mesh), DIST_REDUCE_REPS)
    out["grad_bytes"] = sum(4 * g.numel()
                            for g in bridge.flatten(grads).values())

    # the unsharded 'pallas' step on the whole batch, on rank 0
    dist.barrier()
    if rank == 0:
        reset_launches()
        w_loss, w_grads = steps.value_and_grad(
            lambda t: loss_of(plain)(rebranch.combine(t, frozen), batch),
            first[0])
        out["whole_loss"] = float(w_loss)
        out["whole_launches"] = read_launches()["trunk_conv"]
        out["grad_rel"] = worst_leaf(first[1], w_grads)
        check(out["grad_rel"][0] <= GRAD_RTOL,
              f"reduced gradient {out['grad_rel'][1]} is "
              f"{out['grad_rel'][0]:.3e} of its absmax from the unsharded "
              f"step's")
        out["kernel"] = slab_times(slabs[:per_forward], dot)
        del w_grads
    dist.barrier()
    del slabs

    # each site's sharded STE dx against the unsharded dx
    calls, apply_conv = [], cnn.apply_conv

    def recording(p, xx, spec, stride=1, epilogue=None):
        calls.append((p, xx, spec, stride))
        return apply_conv(p, xx, spec, stride, epilogue)

    cnn.apply_conv = recording
    try:
        with torch.no_grad():
            plain.forward(params, x[:DIST_DX_IMAGES])
    finally:
        cnn.apply_conv = apply_conv
    worst, sharded = 0.0, engine.get("pallas_sharded")
    for i, (p, xin, spec, stride) in enumerate(calls):
        if not spec.enabled:
            continue
        w_q, w_s = p["rom"]["w_q"], p["rom"]["w_scale"]
        with torch.no_grad():
            yshape = rc.trunk_conv(xin, w_q, w_s, stride=stride).shape
        g = torch.randn(yshape, generator=torch.Generator().manual_seed(
            i)).to(xin.device)
        want = trunk_conv_ste_bwd(stride, "SAME", xin.shape, w_q, w_s, g)
        with shd.use_mesh(mesh):
            xl = shd.shard(xin, "cnn_batch", "cnn_h").requires_grad_()
            yl = sharded.conv(spec.cim, xl, w_q, w_s, stride=stride)
            dx, = torch.autograd.grad(yl, xl, shd.shard(g, "cnn_batch",
                                                          "cnn_h"))
            dx = shd.gather_batch(shd.gather_h(dx))
        worst = max(worst, ((dx - want).abs().max()
                            / want.abs().max()).item())
    check(worst <= DX_RTOL, f"a sharded STE dx is {worst:.3e} of its absmax "
          f"from the unsharded dx")
    out["dx_worst"] = worst
    check(rom.rom_fingerprint(params) == fp0, "the ROM fingerprint moved")

    # (c) elastic restore: save from DIST_MESH (rank 0 writes), restore on
    # DIST_RESTORE_MESH with shardings=
    ck = os.path.join(ROOT, "build", "phase31_ckpt")
    if rank == 0:
        shutil.rmtree(ck, ignore_errors=True)
    dist.barrier()
    t0 = time.perf_counter()
    ckpt.save(ck, DIST_STEPS, trainable, opt, params)
    out["save_ms"] = (time.perf_counter() - t0) * 1e3
    mesh2 = mesh_lib.make_mesh(DIST_RESTORE_MESH, backend="gloo")
    t_sh, _, o_sh, _ = steps.model_state_shardings(cfg, mesh2, plain)
    t0 = time.perf_counter()
    at, rt, ro, _ = ckpt.restore(ck, trainable, opt, params,
                                 shardings=(t_sh, o_sh))
    out["restore_ms"] = (time.perf_counter() - t0) * 1e3
    check(at == DIST_STEPS and digests(rt) == digests(trainable)
          and digests(ro) == digests(opt),
          "the elastic restore is not bitwise the saved state")
    dist.barrier()
    if rank == 0:
        shutil.rmtree(ck, ignore_errors=True)


def dist_lm_rank(rank: int, world: int, res: dict):
    """Phase 31(b) on one rank: Gemma-2B at full width cut to
    TRAIN_LAYERS with f32 activations, data-parallel over DIST_LM_MESH,
    one step plain and one compressed."""
    import torch.distributed as dist
    from repro_torch import configs, optim
    from repro_torch import device as device_lib
    from repro_torch.core import rebranch
    from repro_torch.data import synthetic
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import cim_matmul as cm
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.optim import compress
    # f32 activations, held to 1e-5 of the whole-batch step; bf16, where a
    # rank's block and the whole batch round apart, is held to a
    # one-process witness in dist_lm_bf16_rank
    cfg = dataclasses.replace(configs.get("gemma_2b"),
                              num_layers=TRAIN_LAYERS, dtype="float32",
                              remat=False)
    model, _ = lm_train_setup(cfg)
    params = model.init(seed=0)
    trainable, frozen = rebranch.partition(params)
    opt = optim.init(trainable)
    mesh = mesh_lib.make_mesh(DIST_LM_MESH, backend="gloo")
    dcfg = synthetic.DataConfig(seed=0, vocab_size=cfg.vocab_size,
                                seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    whole = synthetic.markov_batch(dcfg, 0, device=device_lib.resolve())
    local = steps.local_batch(cfg, mesh, whole, TRAIN_BATCH)
    make = lambda **kw: steps.make_train_step(
        cfg, optim.AdamWConfig(lr=TRAIN_LR), loss_chunks=TRAIN_CHUNKS,
        model=model, global_batch=TRAIN_BATCH, **kw)
    out = res["lm"] = {"rows": int(local["tokens"].shape[0])}
    dist.barrier()
    if rank == 0:                    # the single-rank step, whole batch
        reset_launches()
        w_loss, w_grads = make().grads(trainable, frozen, whole)
        torch.cuda.synchronize()
        out["whole_launches"] = read_launches()["cim_matmul"]
        out["whole_loss"] = float(w_loss)
    dist.barrier()
    calls, kernel = [], cm.cim_matmul

    def recording(x_q, w_q, cfg=cm.IDEAL, plan=None):
        calls.append((x_q, w_q, cfg))
        return kernel(x_q, w_q, cfg, plan)

    reduced = {}
    for compressed in (False, True):
        step = make(compress=compressed)
        dist.barrier()
        torch.cuda.synchronize()
        reset_launches()
        compress.wire_bytes.clear()
        cm.cim_matmul = recording
        t0 = time.perf_counter()
        try:
            with shd.use_mesh(mesh):
                loss, grads = step.grads(trainable, frozen, local)
        finally:
            cm.cim_matmul = kernel
        new_t, new_opt, _ = optim.update(grads, opt, trainable,
                                         step.opt_cfg)
        torch.cuda.synchronize()
        key = "int8" if compressed else "plain"
        e = out[key] = {"step_ms": (time.perf_counter() - t0) * 1e3,
                        "launches": read_launches(),
                        "wire": dict(compress.wire_bytes),
                        "loss": float(loss)}
        agreed(f"the {key} step's gradients and state",
               (digests(grads), digests(new_t), digests(new_opt)), world)
        reduced[key] = grads
        if compressed:
            err = compress.init_error_state(grads)
            e["reduce_ms"] = timed_host_ms(
                lambda: compress.tree_all_reduce_int8(grads, err, mesh),
                DIST_REDUCE_REPS)
        else:
            e["reduce_ms"] = timed_host_ms(
                lambda: steps.reduce_grads(loss, grads, mesh),
                DIST_REDUCE_REPS)
    m_rows = {x_q.shape[0] for x_q, _, _ in calls}
    check(m_rows == {TRAIN_BATCH // DIST_LM_MESH[0] * TRAIN_SEQ},
          f"kernel 4 ran at M = {m_rows} on a rank")
    for x_q, w_q, c in calls:
        check(torch.equal(kernel(x_q, w_q, c), cm.cim_matmul_plain(x_q, w_q,
                                                                   c)),
              f"kernel 4 at M = {x_q.shape[0]}, {tuple(w_q.shape)} != its "
              f"plain version")
    dist.barrier()
    if rank == 0:                # timed with the other ranks idle
        out["m128"] = pass_times_m(calls, kernel, cm)
    dist.barrier()
    del calls
    rel, name = worst_leaf(reduced["int8"], reduced["plain"])
    out["int8_rel"] = (rel, name)
    check(rel <= COMPRESS_RTOL, f"the int8 mean of {name} is {rel:.3e} of "
          f"its absmax from the plain mean")
    if rank == 0:
        out["grad_rel"] = worst_leaf(reduced["plain"], w_grads)
        check(out["grad_rel"][0] <= GRAD_RTOL,
              f"reduced gradient {out['grad_rel'][1]} is "
              f"{out['grad_rel'][0]:.3e} of its absmax from the whole-batch "
              f"step's")
        check(abs(out["plain"]["loss"] - out["whole_loss"])
              <= GRAD_RTOL * abs(out["whole_loss"]),
              f"loss {out['plain']['loss']} vs whole {out['whole_loss']}")
    launches = [None] * world
    dist.all_gather_object(launches, out["plain"]["launches"])
    whole_n = [None] * world
    dist.all_gather_object(whole_n, out.get("whole_launches"))
    for c in launches + [out["int8"]["launches"]]:
        check(c == {"trunk_conv": 0, "cim_matmul": whole_n[0],
                    "rebranch_matmul": 0},
              f"a rank's step launched {c}, the single-rank step "
              f"{whole_n[0]} kernel-4")


def dist_lm_bf16_rank(rank: int, world: int, res: dict):
    """Phase 31(b) at the configuration's bf16 activations: one
    data-parallel step over DIST_LM_MESH, held on rank 0 to a witness
    computed in one process with no mesh (the ranks' row blocks of the
    whole batch run one after another and averaged in rank order, as the
    all-reduce sums them).  The witness's gap to the whole-batch step is
    bf16's rounding alone; the mesh's step must lie within GRAD_RTOL of
    the witness and within BF16_GAP_FACTOR times that gap of the
    whole-batch step."""
    import torch.distributed as dist
    from repro_torch import bridge, configs, optim
    from repro_torch import device as device_lib
    from repro_torch.core import rebranch
    from repro_torch.data import synthetic
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    cfg = dataclasses.replace(configs.get("gemma_2b"),
                              num_layers=TRAIN_LAYERS, remat=False)
    check(cfg.dtype == "bfloat16", f"Gemma-2B's dtype is {cfg.dtype}")
    model, _ = lm_train_setup(cfg)
    trainable, frozen = rebranch.partition(model.init(seed=0))
    mesh = mesh_lib.make_mesh(DIST_LM_MESH, backend="gloo")
    dcfg = synthetic.DataConfig(seed=0, vocab_size=cfg.vocab_size,
                                seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    whole = synthetic.markov_batch(dcfg, 0, device=device_lib.resolve())
    local = steps.local_batch(cfg, mesh, whole, TRAIN_BATCH)
    n, rows = DIST_LM_MESH[0], TRAIN_BATCH // DIST_LM_MESH[0]
    block = lambda r: {k: v[r * rows:(r + 1) * rows] for k, v in
                       whole.items()}
    check(all(torch.equal(v, block(rank)[k]) for k, v in local.items()),
          f"rank {rank}'s batch block is not rows {rank * rows}.."
          f"{(rank + 1) * rows - 1} of the whole batch")
    step = steps.make_train_step(cfg, optim.AdamWConfig(lr=TRAIN_LR),
                                 loss_chunks=TRAIN_CHUNKS, model=model,
                                 global_batch=TRAIN_BATCH)
    out = res["lm_bf16"] = {}
    dist.barrier()
    if rank == 0:
        reset_launches()
        w_loss, w_grads = step.grads(trainable, frozen, whole)
        torch.cuda.synchronize()
        out["whole_launches"] = read_launches()["cim_matmul"]
        parts = [bridge.flatten(step.grads(trainable, frozen, block(r))[1])
                 for r in range(n)]
        witness = {}
        for k, g in parts[0].items():
            acc = g.float()
            for p in parts[1:]:
                acc = acc + p[k].float()
            witness[k] = (acc / n).to(g.dtype)
        witness = bridge.map_named(w_grads, lambda k, _: witness[k])
        out["whole_loss"] = float(w_loss)
        out["witness_gap"] = worst_leaf(witness, w_grads)
        del parts
    dist.barrier()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with shd.use_mesh(mesh):
        loss, grads = step.grads(trainable, frozen, local)
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) * 1e3
    out["launches"] = read_launches()
    out["loss"] = float(loss)
    agreed("the bf16 step's reduced gradients", digests(grads), world)
    whole_n = [None] * world
    dist.all_gather_object(whole_n, out.get("whole_launches"))
    check(out["launches"] == {"trunk_conv": 0, "cim_matmul": whole_n[0],
                              "rebranch_matmul": 0},
          f"rank {rank}'s bf16 step launched {out['launches']}, the "
          f"single-rank step {whole_n[0]} kernel-4")
    if rank == 0:
        out["vs_witness"] = worst_leaf(grads, witness)
        out["vs_whole"] = worst_leaf(grads, w_grads)
        check(out["vs_witness"][0] <= GRAD_RTOL,
              f"bf16: reduced gradient {out['vs_witness'][1]} is "
              f"{out['vs_witness'][0]:.3e} of its absmax from the "
              f"one-process witness")
        limit = BF16_GAP_FACTOR * out["witness_gap"][0]
        check(out["vs_whole"][0] <= limit,
              f"bf16: reduced gradient {out['vs_whole'][1]} is "
              f"{out['vs_whole'][0]:.3e} of its absmax from the whole-batch "
              f"step's, over {limit:.3e} ({BF16_GAP_FACTOR} x the "
              f"witness's gap)")


def pass_times_m(calls, kernel, cm) -> dict:
    """Kernel 4 over one step's recorded calls (M = 128 a rank): ms, the
    plain version's, ``torch._int_mm``'s and the bound."""
    bound, by = 0.0, {"bytes": 0.0, "operations": 0.0}
    for x_q, w_q, _ in calls:
        b, kind = lm_bound_ms(x_q.shape[0], x_q.shape[1], w_q.shape[1])
        bound += b
        by[kind] += b
    mm = [int_mm_operands(x_q, w_q) for x_q, w_q, _ in calls]
    return {"ms": time_ms(lambda: [kernel(x, w, c) for x, w, c in calls], 5),
            "plain_ms": time_ms(lambda: [cm.cim_matmul_plain(x, w, c)
                                         for x, w, c in calls], 2),
            "library_ms": time_ms(lambda: [torch._int_mm(a, b)
                                           for a, b in mm], 5),
            "bound_ms": bound, "bound_by": max(by, key=by.get)}


def phase_dist_train_rank(rank: int, world: int, size: int) -> dict:
    """Phase 31, one spawned rank."""
    from repro_torch import device as device_lib
    from repro_torch.kernels import _build
    for name in ("trunk_conv", "cim_matmul"):
        check(_build.target(name).exists(),
              f"{name} is not built: the parent builds it before the ranks")
    device_lib.resolve()
    res = {}
    t0 = time.perf_counter()
    dist_cnn_rank(rank, world, size, res)
    res["cnn_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dist_lm_rank(rank, world, res)
    torch.cuda.empty_cache()
    dist_lm_bf16_rank(rank, world, res)
    res["lm_s"] = time.perf_counter() - t0
    return res


def phase_dist_train(smi: str) -> dict:
    """31. Branch training over a 4-rank gloo mesh on the one card."""
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    print(f"phase 31 on {smi}: {DIST_RANKS} gloo ranks on one card; (a) "
          f"DarkNet-19/{SIZE} batch {BATCH}, pallas_sharded, mesh "
          f"{DIST_MESH}, {DIST_STEPS} branch steps; (b) Gemma-2B at full "
          f"width cut to {TRAIN_LAYERS} layers, {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens over {DIST_LM_MESH}, f32 activations a step plain and one "
          f"int8, then bf16 a step plain; (c) "
          f"elastic restore onto {DIST_RESTORE_MESH}")
    ranks = mesh_lib.spawn(phase_dist_train_rank, DIST_RANKS,
                           backend="gloo", args=(SIZE,),
                           deadline_s=DIST_DEADLINE_S)
    c = [r["cnn"] for r in ranks]
    c0 = c[0]
    print(f"(a) {c0['sites']} ROM convs; kernel-1 launches per rank per "
          f"step {[x['per_forward'] for x in c]} (none in the backward), "
          f"{[x['launches'] for x in c]} over {DIST_STEPS} steps; 0 gathered; "
          f"{len(c0['geometries'])} slab geometries (rank 0) torch.equal "
          f"to the plain version; reduced gradients bitwise equal on every "
          f"rank, the worst leaf {c0['grad_rel'][0]:.3e} of its absmax "
          f"from the unsharded step on the whole batch ({c0['grad_rel'][1]});"
          f" loss {c0['loss0']:.6f} vs unsharded {c0['whole_loss']:.6f}; "
          f"losses {c0['loss']}; STE dx worst {max(x['dx_worst'] for x in c):.3e}"
          f" of its absmax; ROM fingerprint unmoved")
    print(f"  traffic of step 0 per rank (bytes by kind): "
          + "; ".join(str(x["traffic"]) for x in c))
    print(f"  step host ms per rank: " + "; ".join(
        ", ".join(f"{t:.2f}" for t in x["step_ms"]) for x in c)
          + f"; all-reduce of {c0['grad_bytes']} gradient bytes, ms per "
          f"rank: " + "; ".join(", ".join(f"{t:.2f}" for t in x["reduce_ms"])
                               for x in c) + f" [{smi}]")
    k = c0["kernel"]
    print(f"  kernel 1, rank 0's {c0['per_forward']} training slab launches "
          f"of a forward (the other ranks idle): {k['ms']:.3f} ms, plain "
          f"{k['plain_ms']:.3f} ms, bound {k['bound_ms']:.3f} ms [{smi}]")
    print("  slab geometries: " + " ".join(f"{xs}x{ws}" for xs, ws, _, _
                                            in c0["geometries"]))
    print(f"(c) elastic restore bitwise on every rank; save ms "
          f"{[round(x['save_ms'], 1) for x in c]}, restore ms "
          f"{[round(x['restore_ms'], 1) for x in c]}")
    lm = [r["lm"] for r in ranks]
    l0 = lm[0]
    print(f"(b) remat off; {l0['rows']} rows a rank; kernel-4 launches "
          f"per rank a step "
          f"{[x['plain']['launches']['cim_matmul'] for x in lm]} plain, "
          f"{[x['int8']['launches']['cim_matmul'] for x in lm]} int8, the "
          f"single-rank step {l0['whole_launches']}; every call at M = "
          f"{TRAIN_BATCH // DIST_LM_MESH[0] * TRAIN_SEQ} torch.equal to the "
          f"plain version; loss {l0['plain']['loss']:.6f} vs whole "
          f"{l0['whole_loss']:.6f}; worst gradient leaf "
          f"{l0['grad_rel'][0]:.3e} of its absmax ({l0['grad_rel'][1]}); "
          f"int8 mean {l0['int8_rel'][0]:.3e} of its absmax from the plain "
          f"({l0['int8_rel'][1]})")
    for key in ("plain", "int8"):
        print(f"  {key}: wire bytes per rank a step {l0[key]['wire']}; step "
              f"host ms per rank "
              f"{[round(x[key]['step_ms'], 2) for x in lm]}; all-reduce ms "
              f"per rank " + "; ".join(
                  ", ".join(f"{t:.2f}" for t in x[key]["reduce_ms"])
                  for x in lm) + f" [{smi}]")
    m = l0["m128"]
    print(f"  kernel 4, rank 0's {l0['plain']['launches']['cim_matmul']} "
          f"calls of a step at M = 128 (the other ranks idle): "
          f"{m['ms']:.3f} ms, plain {m['plain_ms']:.3f}, torch._int_mm "
          f"{m['library_ms']:.3f}, bound {m['bound_ms']:.3f} [{smi}]")
    b = [r["lm_bf16"] for r in ranks]
    b0 = b[0]
    print(f"(b) bf16 activations: kernel-4 launches per rank "
          f"{[x['launches']['cim_matmul'] for x in b]}, the single-rank step "
          f"{b0['whole_launches']}; loss {b0['loss']:.6f} vs whole "
          f"{b0['whole_loss']:.6f}; the one-process witness (the ranks' "
          f"blocks run in turn, averaged) {b0['witness_gap'][0]:.3e} of its "
          f"absmax from the whole batch ({b0['witness_gap'][1]}); the "
          f"mesh's reduced gradients {b0['vs_witness'][0]:.3e} from the "
          f"witness ({b0['vs_witness'][1]}), {b0['vs_whole'][0]:.3e} from "
          f"the whole batch ({b0['vs_whole'][1]}; limit "
          f"{BF16_GAP_FACTOR} x the witness's gap); step host ms per rank "
          f"{[round(x['step_ms'], 2) for x in b]} [{smi}]")
    print(f"phase 31 {time.perf_counter() - t0:.1f} s (rank 0: (a)+(c) "
          f"{ranks[0]['cnn_s']:.1f} s, (b) {ranks[0]['lm_s']:.1f} s)")
    return {"trunk_conv": {"launches": [x["launches"] for x in c],
                           "kernel": k},
            "cim_matmul": {"launches": [
                x["plain"]["launches"]["cim_matmul"]
                + x["int8"]["launches"]["cim_matmul"]
                + y["launches"]["cim_matmul"] for x, y in zip(lm, b)],
                "kernel": m}}


# ---------------------------------------------------------------------------
# phase 32: LM tensor-parallel serving over a (data, model) mesh
# ---------------------------------------------------------------------------

TP_RANKS = 4
TP_MESHES = ((1, 4), (2, 2))        # (data, model)
TP_POD_MESH = (2, 2, 1)             # (pod, data, model): a batch over
                                    # pod x data
TP_LAYERS = 9                       # Gemma-2B's depth cut (of 18), for the
                                    # script's time limit
TP_YI_LAYERS = 2                    # Yi-34B at its published widths, cut
TP_BATCH, TP_PROMPT, TP_MAX_LEN = 8, 64, 256
TP_NEW, TP_PALLAS_NEW, TP_YI_NEW, TP_POD_NEW = 16, 4, 4, 4
TP_CORE_SEED = 32
TP_LOGITS_RTOL = 5e-2               # whole models: of the unsharded absmax
TP_AGREE = 0.99                     # tokens: the reference's own threshold
# Gemma-2B at full width is chaotic at the ulp level, with f32
# activations too (an ulp before a per-row int8 quantiser moves a code,
# and the layers carry it), so whole models are held to a one-process
# witness: the unsharded steps with every trunk nudged by ~1 f32 ulp
TP_WITNESS_FACTOR = 2.0             # logits: within max(5e-2, 2 x witness)
TP_MARGIN = 2.0                     # tokens: >= 99% of the (row, step) pairs
                                    # whose top-2 gap exceeds this many times
                                    # the logits' measured distance
TP_ROW_STRIDE = 8                   # ADC modes at prefill M: every 8th row
TP_DEADLINE_S = 400
# the column-parallel (_WIDE_OUT) and row-parallel (_WIDE_IN) linears of
# a dense block, in the order a block runs them
TP_SITES = (("attn", "q", "col"), ("attn", "k", "col"), ("attn", "v", "col"),
            ("attn", "o", "row"), ("mlp", "gate", "col"),
            ("mlp", "up", "col"), ("mlp", "down", "row"))


def tp_config(arch: str):
    """The FULL config of ``arch`` at its tensor-parallel phase's depth
    (Gemma-2B's TP_LAYERS, Granite-MoE-3B's MOE_TP_LAYERS, the others'
    TP_YI_LAYERS)."""
    from repro_torch import configs
    layers = {"gemma_2b": TP_LAYERS, MOE_TP_ARCH: MOE_TP_LAYERS}
    return dataclasses.replace(configs.get(arch),
                               num_layers=layers.get(arch, TP_YI_LAYERS))


def tp_dims(cfg, site: str) -> tuple[int, int]:
    d, ff = cfg.d_model, cfg.d_ff
    hd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    return {"q": (d, hd), "k": (d, kvd), "v": (d, kvd), "o": (hd, d),
            "gate": (d, ff), "up": (d, ff), "down": (ff, d),
            "lm_head": (d, cfg.vocab_size)}[site]


def tp_site_layout(cfg, site: str, n: int, r: int):
    """``sharding.linear_tp`` of ``site`` as model rank ``r`` of ``n`` sees
    it (None: the size rule keeps the site whole), from the layouts alone
    (no process group)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as mesh_lib

    class At(mesh_lib.AbstractMesh):
        def coordinate(self, axis):
            return r if axis == "model" else 0

        def group(self, axis):
            return None
    with shd.use_mesh(At((1, n))):
        return shd.linear_tp(site, *tp_dims(cfg, site),
                             cfg.rebranch.cim.rows_per_subarray,
                             head_dim=cfg.head_dim)


def tp_block_sites(cfg) -> list:
    """The kernel linears of a block in the order it runs them: a dense
    block's seven, a moe block's attention four (its experts are plain
    PyTorch stacks; a config with shared experts is not served here)."""
    if cfg.family == "moe":
        check(not cfg.num_shared_experts, f"{cfg.name}: shared experts")
        return [s for b, s, _ in TP_SITES if b == "attn"]
    return [s for _, s, _ in TP_SITES]


def tp_sites(cfg) -> list:
    """The kernel linears of a block in the order it runs them, then an
    untied readout."""
    return tp_block_sites(cfg) + ([] if cfg.tie_embeddings else ["lm_head"])


def tp_rank_geometry(cfg, site: str, n: int, r: int):
    """(K, N) of model rank ``r``'s call of ``site`` over ``n`` ranks, None
    where it launches nothing (no columns, no k-block)."""
    k, nn = tp_dims(cfg, site)
    tp = tp_site_layout(cfg, site, n, r)
    if tp is None:
        return k, nn
    lo, hi = tp.cols if tp.role == "column" else tp.k_ranges[r]
    if hi == lo:
        return None
    return (k, hi - lo) if tp.role == "column" else (hi - lo, nn)


def tp_geometries(runs=None, skip=()) -> dict:
    """{(K, N): (decode M, prefill M or 0, owners)}: every per-rank
    geometry kernels 3 and 4 take on the path of ``runs`` ((arch, data x
    model meshes); phase 32's by default) but those of ``skip``: the
    columns of column-parallel sites (q on whole heads), the k-blocks of
    row-parallel ones, the whole of a site the size rule keeps whole; an
    untied lm_head runs at the last position only."""
    out = {}
    for arch, meshes in runs or (("gemma_2b", TP_MESHES),
                                 ("yi_34b", ((1, 4),))):
        cfg = tp_config(arch)
        for n_data, n in meshes:
            dec = TP_BATCH // n_data
            for site in tp_sites(cfg):
                pre = 0 if site == "lm_head" else dec * TP_PROMPT
                geoms = {tp_rank_geometry(cfg, site, n, r) for r in range(n)}
                for g in geoms - {None} - set(skip):
                    m0, p0, who = out.get(g, (dec, pre, []))
                    out[g] = (max(m0, dec), max(p0, pre),
                              who + [f"{arch}:{site}@{n_data}x{n}"])
    return out


def phase_tp_kernels(dev, geoms=None, phase: str = "32(a)") -> dict:
    """32(a): kernels 3 and 4 at every per-rank geometry of the phase
    (``geoms``: :func:`tp_geometries`'), in all three CiM modes, at decode
    M (f32 and bf16 x; kernel 3 reads bf16 as it is there) and prefill M
    (f32), ``torch.equal`` to their plain versions: every row in ideal
    mode, the decode rows and every TP_ROW_STRIDE-th prefill row in the
    ADC modes (a plain row is exact sums over that row alone).  x holds
    bfloat16 values, so one plain call serves both dtypes.  Returns the
    geometries held."""
    from repro_torch.core import cim as cim_lib
    from repro_torch.core import quant
    from repro_torch.kernels import cim_matmul as cm
    from repro_torch.kernels import rebranch_matmul as rm
    t0 = time.perf_counter()
    geoms = tp_geometries() if geoms is None else geoms
    gen = torch.Generator(device=dev).manual_seed(32)
    print(f"phase {phase}: kernels 3 and 4 at {len(geoms)} per-rank "
          f"geometries: K N Cd decode_M prefill_M owners")
    for (k, n), (dec, pre, who) in sorted(geoms.items()):
        cdim = k // 4
        w = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        c = torch.randn((k, cdim), generator=gen, device=dev) / k ** .5
        xs = {m: torch.randn((m, k), generator=gen, device=dev).bfloat16()
              .float() for m in (dec, pre) if m}
        for mode in ("ideal",) + ADC_MODES:
            cfg = cim_lib.CiMConfig(mode=mode)
            # every row in ideal mode; in the ADC modes the decode rows and
            # every TP_ROW_STRIDE-th prefill row, held to one plain call
            picks = {m: slice(None) if mode == "ideal" or m == dec
                     else slice(0, m, TP_ROW_STRIDE) for m in xs}
            rows = torch.cat([x[picks[m]] for m, x in xs.items()])
            p_trunk, p_t1 = rm.rebranch_matmul_plain(rows, w, c, cfg)
            p4 = cm.cim_matmul_plain(quant.quantize_activations(rows)[0], w,
                                     cfg)
            at = 0
            for m, x in xs.items():
                pick = picks[m]
                got_rows = x[pick].shape[0]
                want = slice(at, at + got_rows)
                at += got_rows
                for xx in ([x, x.bfloat16()] if m == dec else [x]):
                    trunk, t1 = rm.rebranch_trunk_sketch(xx, w, c, cfg)
                    what = f"({k}x{n}, M={m}, {mode}, x {xx.dtype})"
                    check(torch.equal(trunk[pick], p_trunk[want]),
                          f"kernel 3 trunk != plain {what}")
                    rel = ((t1[pick] - p_t1[want]).abs().max()
                           / p_t1[want].abs().max()).item()
                    check(rel <= SKETCH_RTOL, f"kernel 3 sketch off by "
                          f"{rel:.2e} of its absmax {what}")
                x_q = quant.quantize_activations(x)[0]
                check(torch.equal(cm.cim_matmul(x_q, w, cfg)[pick],
                                  p4[want]),
                      f"kernel 4 != plain ({k}x{n}, M={m}, {mode})")
        print(f"  {k} {n} {cdim} {dec} {pre} {','.join(who)}: equal in "
              f"{', '.join(('ideal',) + ADC_MODES)}", flush=True)
        del w, c, xs
    torch.cuda.empty_cache()
    print(f"phase {phase}: {len(geoms)} geometries in "
          f"{time.perf_counter() - t0:.1f} s")
    return geoms


def tp_expected_launches(cfg, mesh) -> int:
    """Kernel launches a rank makes per prefill or decode step: one per
    linear whose block it holds (a rank without a k-block of a
    row-parallel site, or without q heads, launches nothing there), the
    readout once."""
    n, r = mesh.shape["model"], mesh.coordinate("model")
    per_layer = sum(tp_rank_geometry(cfg, site, n, r) is not None
                    for site in tp_block_sites(cfg))
    return per_layer * cfg.num_layers + (0 if cfg.tie_embeddings else 1)


def tp_model(arch: str, engine: str, mesh=None):
    from repro_torch import deploy
    return deploy.compile_model(tp_config(arch), engine=engine, mesh=mesh)


def tp_params(model):
    """The seeded tree the parent's oracle and every rank build."""
    return with_cores(model.init(seed=0),
                      torch.Generator().manual_seed(TP_CORE_SEED))


def top2_margin(logits) -> torch.Tensor:
    """The gap between each row's two largest logits, [B, 1]."""
    top = torch.topk(logits.float(), 2, dim=-1).values
    return (top[..., 0] - top[..., 1]).cpu()


@contextlib.contextmanager
def nudged_kernels(dev):
    """Kernels 3 and 4 with every trunk they return moved by ~1 f32 ulp
    (a seeded relative 2**-23 N(0, 1)), before any scale or cast: what a
    reassociated f32 sum does to it."""
    from repro_torch.kernels import cim_matmul as cm
    from repro_torch.kernels import rebranch_matmul as rm
    gen = torch.Generator(device=dev)
    gen.manual_seed(33)
    k3, k4 = rm.rebranch_trunk_sketch, cm.cim_matmul

    def nudge(t):
        return t * (1 + 2 ** -23 * torch.randn(t.shape, generator=gen,
                                               device=t.device))

    def sketch(x, w_q, c, cfg=rm.IDEAL, plan=None):
        trunk, t1 = k3(x, w_q, c, cfg, plan)
        return nudge(trunk), t1

    rm.rebranch_trunk_sketch = sketch
    cm.cim_matmul = lambda x_q, w_q, cfg=cm.IDEAL, plan=None: nudge(
        k4(x_q, w_q, cfg, plan))
    try:
        yield
    finally:
        rm.rebranch_trunk_sketch, cm.cim_matmul = k3, k4


def tp_oracle_run(arch: str, engine: str, params, new: int,
                  feed=None) -> dict:
    """The port's unsharded prefill step and ``new`` greedy decode steps
    (``make_serve_step``'s argmax of ``decode_step``'s logits), on the
    card: the logits of the prefill and the first step, the tokens, and
    each (row, step)'s gap between its two largest logits."""
    from repro_torch.launch import steps
    cfg, model = tp_config(arch), tp_model(arch, engine)
    prompts = torch.from_numpy(np.random.default_rng(32).integers(
        0, cfg.vocab_size, (TP_BATCH, TP_PROMPT)).astype(np.int32))
    dev = params["ln_f"]["sram"]["scale"].device
    reset_launches()
    logits, cache = steps.make_prefill_step(
        cfg, TP_BATCH, TP_MAX_LEN, model=model)(params,
                                                {"tokens": prompts.to(dev)})
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    toks, margins, first = [tok], [top2_margin(logits)], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(new):
            if feed is not None:        # the given token, not the argmax
                tok = feed[:, i:i + 1].to(dev)
            step, cache = model.decode_step(params, tok, cache)
            first = step.float().cpu() if first is None else first
            tok = torch.argmax(step, dim=-1).to(torch.int32)
            toks.append(tok)
            margins.append(top2_margin(step))
    torch.cuda.synchronize()
    return {"prompts": prompts, "logits": logits.float().cpu(),
            "first": first, "launches": read_launches(),
            "tokens": torch.cat(toks, 1).cpu(),
            "margins": torch.cat(margins, 1),
            "step_ms": (time.perf_counter() - t0) * 1e3 / new}


def tp_layer0(tree, block: str, site: str) -> dict:
    """Layer 0's leaves of one linear of a stacked tree."""
    return {part: {k: v[0] for k, v in leaves.items()}
            for part, leaves in tree["layers"][block][site].items()}


def tp_build(model, rank: int, world: int, probes: bool = True,
             with_whole=None):
    """This rank's blocks of the seeded tree: the ranks build the whole
    tree on the card in turn, behind barriers, each keeping its blocks
    (and layer 0's whole ROM leaves of every linear, for the site
    checks); never two whole trees at once.  ``with_whole(tree)`` runs on
    the whole tree in the rank's turn."""
    import torch.distributed as dist
    local = probe = None
    for turn in range(world):
        if turn == rank:
            t0 = time.perf_counter()
            whole = tp_params(model)
            if with_whole is not None:
                with_whole(whole)
            if probes:            # what tp_site_checks reads
                probe = {site: {k: v.clone() for k, v in
                                tp_layer0(whole, block, site)["rom"].items()
                                if k in ("w_q", "C")}
                         for block, site, _ in TP_SITES}
            local = model.shard_params(whole)
            del whole
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            build_s = time.perf_counter() - t0
        dist.barrier()
    return local, probe, build_s


def tp_site_checks(model, cfg, local, probe, cache, tok, smi: str) -> dict:
    """One decode step (on a copy of the cache) with layer 0's calls
    recorded: each row-parallel site's reduced trunk bitwise the
    rank-order sum of the plain version over ``k_layout``'s ranges (on
    the whole input, gathered, and layer 0's whole W and C), each
    column-parallel site's kernel-3 trunk bitwise the kernel's on the
    whole W, on the rank's columns (a rank without columns of a site
    calls nothing there); sites the size rule keeps whole run as
    unsharded."""
    from repro_torch.core import rebranch
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import rebranch_matmul as rm
    mesh = model.mesh
    n, r = mesh.shape["model"], mesh.coordinate("model")
    layouts = {site: tp_site_layout(cfg, site, n, r)
               for _, site, _ in TP_SITES}
    rows, sketches = {}, []
    real_parts, real_sketch = rebranch.row_parallel_parts, \
        rm.rebranch_trunk_sketch

    # layer 0's row-parallel sites are the first to run (a rank without a
    # k-block of one runs it too); its column sites' kernels by their W
    row_sites = [site for _, site, _ in TP_SITES
                 if layouts[site] is not None and layouts[site].role == "row"]
    col_ptrs = {}
    for block, site, _ in TP_SITES:
        tp, w = layouts[site], tp_layer0(local, block, site)["rom"]["w_q"]
        if tp is not None and tp.role == "column" and w.numel():
            col_ptrs[w.data_ptr()] = site

    def parts(params, x, spec, tp):
        out = real_parts(params, x, spec, tp)
        if len(rows) < len(row_sites):
            rows[row_sites[len(rows)]] = (x, tp, out)
        return out

    def sketch(x, w, c, cfg_=rm.IDEAL, plan=None):
        out = real_sketch(x, w, c, cfg_, plan)
        if w.data_ptr() in col_ptrs:
            sketches.append((col_ptrs.pop(w.data_ptr()), x, w, c, out))
        return out

    rebranch.row_parallel_parts, rm.rebranch_trunk_sketch = parts, sketch
    try:
        model.decode_step(local, tok, copy.deepcopy(cache))
    finally:
        rebranch.row_parallel_parts = real_parts
        rm.rebranch_trunk_sketch = real_sketch
    check(list(rows) == row_sites and not col_ptrs,
          f"layer 0's calls recorded: row sites {list(rows)} of "
          f"{row_sites}, column sites not seen {col_ptrs}")
    moved = {}
    for site, (x, tp, got) in rows.items():
        with shd.use_mesh(mesh):
            reduced = shd.rank_sum(shd.gather_parts(got["trunk"], mesh,
                                                    "model", "check"))
            xw = shd.move_rows(x, list(tp.x_layout), [(0, tp.d_in)] * n,
                               mesh, "model", "check", dim=-1)
        x2 = xw.reshape(-1, tp.d_in)
        w, c = probe[site]["w_q"], probe[site]["C"]
        want = shd.rank_sum([
            rm.rebranch_matmul_plain(x2[:, k0:k1], w[k0:k1], c[k0:k1])[0]
            if k1 > k0 else torch.zeros_like(reduced)
            for k0, k1 in tp.k_ranges])
        check(torch.equal(reduced, want), f"{cfg.name} {site}: the reduced "
              f"trunk != the rank-order sum of its plain version over "
              f"k_layout {tp.k_ranges}")
        moved[site] = [hi - lo for lo, hi in tp.k_ranges]
    cols = 0
    for site, x, w, c, (trunk, _) in sketches:
        lo, hi = layouts[site].cols
        whole = rm.rebranch_trunk_sketch(x, probe[site]["w_q"], c)[0]
        check(torch.equal(trunk, whole[:, lo:hi]),
              f"{cfg.name} {site}: kernel-3 trunk columns {lo}:{hi} != the "
              f"unsharded site's")
        cols += 1
    return {"row_blocks": moved, "col_sites": cols}


def tp_batch_check(model, local, cache, tok) -> int:
    """Two decode steps from the batch-8 cache against the same steps of
    a small batch made of each data rank's first row (batch 1 on one data
    rank; 2 on two: rows 0 and 4; 4 over pod 2 x data 2: rows 0, 2, 4,
    6): that row's logits bitwise."""
    from repro_torch.distributed import sharding as shd
    n_data = math.prod(model.mesh.shape.get(a, 1) for a in ("pod", "data"))
    small = 1 if n_data == 1 else n_data
    first_rows = [shd.h_layout(TP_BATCH, n_data)[d][0]
                  for d in range(n_data)]
    big = copy.deepcopy(cache)
    sm = model.init_cache(small, TP_MAX_LEN)
    for leaf in ("k", "v"):
        sm["layers"][leaf].copy_(big["layers"][leaf][:, :1])
    sm["layers"]["length"].copy_(big["layers"]["length"][:, first_rows])
    lo, hi = shd.batch_block(TP_BATCH, model.mesh)
    for i in range(2):
        lb, big = model.decode_step(local, tok[lo:hi], big)
        ls, sm = model.decode_step(local, tok[lo:lo + 1], sm)
        check(torch.equal(lb[:1], ls), f"step {i}: a row decoded at batch "
              f"{TP_BATCH} != the same row at batch {small}")
    return small


def tp_pod_check(arch: str, engine: str, model, local, prompts) -> int:
    """On (pod 2, data 2, model 1), where a rank's blocks are the whole
    tree: two decode steps of this rank's rows of the unsharded 8-row
    prefill's cache, through the mesh's ``decode_step`` and serve step,
    against the unsharded 8-row steps: the rows' logits bitwise, the
    tokens gathered over pod x data bitwise their argmax."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    cfg, whole = tp_config(arch), tp_model(arch, engine)
    logits, cache8 = steps.make_prefill_step(
        cfg, TP_BATCH, TP_MAX_LEN, model=whole)(local, {"tokens": prompts})
    tok = torch.argmax(logits, -1).to(torch.int32)
    lo, hi = shd.batch_block(TP_BATCH, model.mesh)
    mine = model.init_cache(TP_BATCH, TP_MAX_LEN)
    for leaf in ("k", "v"):
        mine["layers"][leaf].copy_(cache8["layers"][leaf][:, lo:hi])
    mine["layers"]["length"].copy_(cache8["layers"]["length"])
    serve = steps.make_serve_step(cfg, model=model)
    for i in range(2):
        with torch.no_grad():
            want, cache8 = whole.decode_step(local, tok, cache8)
            got, _ = model.decode_step(local, tok[lo:hi],
                                       copy.deepcopy(mine))
            nxt, mine = serve(local, {"tokens": tok}, mine)
        check(torch.equal(got, want[lo:hi]), f"{arch} over pod x data, "
              f"step {i}: rows {lo}:{hi}' logits != the unsharded 8-row "
              f"step's")
        check(torch.equal(nxt, torch.argmax(want, -1).to(torch.int32)),
              f"{arch} over pod x data, step {i}: the gathered tokens != "
              f"the unsharded 8-row step's")
        tok = nxt
    return hi - lo


def tp_serve(arch: str, engine: str, mesh, local, probe, oracle: dict,
             new: int, rank: int, world: int, smi: str,
             sites: bool = True, after=None) -> dict:
    """The sharded prefill step and ``new`` serve steps (each fed the
    oracle's token, so every step's prediction is compared), checked
    against the oracle and across ranks, with the kernel calls of one
    decode step recorded (and timed on rank 0 with the others idle).
    ``after(model, local, cache, tok)``: a check run last, on the cache
    and the rank's rows of the next token (its result ``out["after"]``)."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import cim_matmul as cm
    from repro_torch.kernels import rebranch_matmul as rm
    from repro_torch.launch import steps
    cfg, model = tp_config(arch), tp_model(arch, engine, mesh)
    dev = local["ln_f"]["sram"]["scale"].device
    prompts = oracle["prompts"].to(dev)
    want_toks = oracle["tokens"].to(dev)
    out = {"engine": engine, "mesh": tuple(mesh.shape.values()),
           "model": arch.replace("_", "-")}
    out["key"] = f"{out['model']}-{engine}-" + "x".join(map(str, out["mesh"]))
    prefill = steps.make_prefill_step(cfg, TP_BATCH, TP_MAX_LEN, model=model)
    serve = steps.make_serve_step(cfg, model=model)
    dist.barrier()
    torch.cuda.synchronize()
    reset_launches()
    shd.reset_traffic()
    t0 = time.perf_counter()
    logits, cache = prefill(local, {"tokens": prompts})
    torch.cuda.synchronize()
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    out["prefill_launches"] = read_launches()
    out["prefill_bytes"] = dict(shd.bytes_sent)
    check(tuple(logits.shape) == (TP_BATCH, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"prefill logits {tuple(logits.shape)}, finite "
          f"{bool(torch.isfinite(logits).all())}")
    ref = oracle["logits"].to(dev)
    noise = (logits.float() - ref).abs().max().item()
    out["logits_rel"] = noise / ref.abs().max().item()
    wit = oracle["witness"]
    limit = max(TP_LOGITS_RTOL, TP_WITNESS_FACTOR * wit["logits_rel"])
    check(out["logits_rel"] <= limit, f"{arch} {engine} prefill logits "
          f"{out['logits_rel']:.3e} of the unsharded absmax (limit "
          f"{limit:.3e})")
    lo, hi = shd.batch_block(TP_BATCH, mesh)
    first, _ = model.decode_step(local, want_toks[lo:hi, :1],
                                 copy.deepcopy(cache))
    ref = oracle["first"].to(dev)[lo:hi]
    step_noise = (first.float() - ref).abs().max().item()
    out["first_rel"] = step_noise / ref.abs().max().item()
    limit = max(TP_LOGITS_RTOL, TP_WITNESS_FACTOR * wit["first_rel"])
    check(out["first_rel"] <= limit, f"{arch} {engine} first decode logits "
          f"{out['first_rel']:.3e} of the unsharded absmax (limit "
          f"{limit:.3e})")
    out["noise"] = max(noise, step_noise)
    got, step_ms, per_step = [torch.argmax(logits, -1).to(torch.int32)], \
        [], []
    calls = []
    kernel = rm.rebranch_trunk_sketch if engine == "pallas_fused" \
        else cm.cim_matmul
    shd.reset_traffic()
    def recording(*a, **kw):
        calls.append(a[:3] if engine == "pallas_fused" else a[:2])
        return kernel(*a, **kw)

    module = rm if engine == "pallas_fused" else cm
    name = kernel.__name__
    for i in range(new):
        tok = want_toks[:, i:i + 1]
        if i == 1:                      # record step 1's kernel calls
            setattr(module, name, recording)
        dist.barrier()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        try:
            nxt, cache = serve(local, {"tokens": tok}, cache)
            torch.cuda.synchronize()
        finally:
            setattr(module, name, kernel)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(read_launches())
        got.append(nxt)
    out["step_bytes"] = {k: v / new for k, v in shd.bytes_sent.items()}
    want = {"trunk_conv": 0, "cim_matmul": 0, "rebranch_matmul": 0,
            module.__name__.rsplit(".", 1)[-1]:
            tp_expected_launches(cfg, mesh)}
    check(all(p == want for p in per_step + [out["prefill_launches"]]),
          f"{arch} {engine}: launches per step {per_step}, prefill "
          f"{out['prefill_launches']}, want {want} each")
    check(logits.is_cuda == (dev.type == "cuda"), "logits left the card")
    got = torch.cat(got, 1)
    same = (got == want_toks[:, :new + 1]).cpu()
    out["agree"] = float(same.float().mean())
    # the (row, step) pairs whose top two unsharded logits lie further
    # apart than twice the logits' measured distance from the unsharded
    # step's: there, no rounding of that size moves the argmax
    clear = oracle["margins"][:, :new + 1] > TP_MARGIN * out["noise"]
    out["clear"] = (int(clear.sum()), int(clear.numel()))
    out["agree_clear"] = float(same[clear].float().mean())
    out["witness"] = wit
    check(out["agree_clear"] >= TP_AGREE,
          f"{arch} {engine} ({cfg.dtype}) tokens agree with the unsharded "
          f"steps in {out['agree']:.4f} of (row, step) pairs (the witness "
          f"{wit['agree']:.4f}), {out['agree_clear']:.4f} of the "
          f"{out['clear'][0]} whose top two logits lie over {TP_MARGIN} x "
          f"{out['noise']:.3e} apart")
    agreed(f"{arch} {engine} logits and tokens",
           (digests({"l": logits}), got.cpu().tolist()), world)
    out["step_ms"], out["launches"] = step_ms, per_step
    out["launches_per_step"] = {
        k: sorted({p[k] for p in per_step}) for k in per_step[0]}
    for c in calls:                      # every call of a served step
        if engine == "pallas_fused":
            trunk, t1 = kernel(*c)
            p_trunk, p_t1 = rm.rebranch_matmul_plain(*c)
            check(torch.equal(trunk, p_trunk), f"kernel 3 at "
                  f"{tuple(c[0].shape)} x {tuple(c[1].shape)} != plain")
        else:
            check(torch.equal(kernel(*c), cm.cim_matmul_plain(*c)),
                  f"kernel 4 at {tuple(c[0].shape)} x {tuple(c[1].shape)} "
                  f"!= plain")
    out["geoms"] = sorted({(tuple(c[0].shape), tuple(c[1].shape))
                           for c in calls})
    dist.barrier()
    if rank == 0:                        # timed with the other ranks idle
        out["pass"] = pass_times(kernel, rm.rebranch_matmul_plain
                                 if engine == "pallas_fused"
                                 else cm.cim_matmul_plain, calls,
                                 engine == "pallas_fused")
    dist.barrier()
    del calls
    if sites:
        if mesh.shape["model"] > 1:
            out["sites"] = tp_site_checks(model, cfg, local, probe, cache,
                                          want_toks[lo:hi, new:new + 1], smi)
        out["batch"] = tp_batch_check(model, local, cache,
                                      want_toks[:, new:new + 1])
    if after is not None:
        out["after"] = after(model, local, cache,
                             want_toks[lo:hi, new:new + 1])
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def tp_meshes(shapes) -> dict:
    """A mesh per shape: (data, model), or (pod, data, model)."""
    from repro_torch.launch import mesh as mesh_lib
    return {s: mesh_lib.make_mesh(s, ("pod", "data", "model")[-len(s):],
                                  backend="gloo") for s in shapes}


def phase_tp_rank(rank: int, world: int, path: str, smi: str) -> dict:
    """Phase 32, one spawned rank."""
    from repro_torch import device as device_lib
    from repro_torch.kernels import _build
    for name in ("cim_matmul", "rebranch_matmul"):
        check(_build.target(name).exists(),
              f"{name} is not built: the parent builds it before the ranks")
    device_lib.resolve()
    torch.cuda.reset_peak_memory_stats()
    oracle = torch.load(path)
    meshes = tp_meshes(TP_MESHES + (TP_POD_MESH,))
    res = {"runs": [], "build_s": []}
    t0 = time.perf_counter()
    for shape in TP_MESHES + (TP_POD_MESH,):
        mesh = meshes[shape]
        model = tp_model("gemma_2b", "pallas_fused", mesh)
        local, probe, build_s = tp_build(model, rank, world)
        res["build_s"].append(build_s)
        res["runs"].append(tp_serve(
            "gemma_2b", "pallas_fused", mesh, local, probe,
            oracle["gemma_2b"], TP_POD_NEW if shape == TP_POD_MESH
            else TP_NEW, rank, world, smi))
        if shape == (1, 4):             # kernel 4 on the same blocks
            res["runs"].append(tp_serve(
                "gemma_2b", "pallas", mesh, local, probe,
                oracle["gemma_2b_pallas"], TP_PALLAS_NEW, rank, world, smi,
                sites=False))
        if shape == TP_POD_MESH:
            res["runs"][-1]["pod_rows"] = tp_pod_check(
                "gemma_2b", "pallas_fused", model, local,
                oracle["gemma_2b"]["prompts"].to(device_lib.resolve()))
        del local, probe
        torch.cuda.empty_cache()
    res["gemma_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = meshes[(1, 4)]
    local, probe, build_s = tp_build(tp_model("yi_34b", "pallas_fused", mesh),
                                     rank, world)
    res["build_s"].append(build_s)
    res["runs"].append(tp_serve("yi_34b", "pallas_fused", mesh, local, probe,
                                oracle["yi_34b"], TP_YI_NEW, rank, world,
                                smi))
    del local, probe
    torch.cuda.empty_cache()
    res["yi_s"] = time.perf_counter() - t0
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return res


def tp_oracles(dev, todo, oracle: dict, params=None) -> dict:
    """The port's unsharded steps of each (arch, engine, new, key) of
    ``todo`` into ``oracle[key]``, run in this process on the card (on
    ``params``, the arch's whole tree, if given), each with its witness:
    the same steps, fed the same tokens, with every trunk nudged by ~1 f32
    ulp (the model's own sensitivity to a reassociated sum)."""
    built = None if params is None else todo[0][0]
    for arch, engine, new, key in todo:
        if arch != built:
            params = None
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            params, built = tp_params(tp_model(arch, engine)), arch
            print(f"  {arch}: the whole tree drawn on the card in "
                  f"{time.perf_counter() - t0:.1f} s, "
                  f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
        oracle[key] = tp_oracle_run(arch, engine, params, new)
        print(f"  unsharded {arch} {engine}: decode step "
              f"{oracle[key]['step_ms']:.2f} ms (host clock), launches "
              f"{oracle[key]['launches']}", flush=True)
        with nudged_kernels(dev):
            w = tp_oracle_run(arch, engine, params, new,
                              feed=oracle[key]["tokens"])
        ref = oracle[key]
        oracle[key]["witness"] = {
            "logits_rel": ((w["logits"] - ref["logits"]).abs().max()
                           / ref["logits"].abs().max()).item(),
            "first_rel": ((w["first"] - ref["first"]).abs().max()
                          / ref["first"].abs().max()).item(),
            "agree": float((w["tokens"] == ref["tokens"]).float().mean())}
        print(f"  witness {arch} {engine}: the unsharded steps with every "
              f"trunk nudged by ~1 f32 ulp: prefill and first-step logits "
              f"{ref['witness']['logits_rel']:.3e}, "
              f"{ref['witness']['first_rel']:.3e} of the absmax away, tokens "
              f"agree in {ref['witness']['agree']:.4f} of (row, step) pairs",
              flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return oracle


def tp_report(phase: str, ranks: list, smi: str) -> dict:
    """Every run of the ranks printed (checks held, host times, bytes sent
    by kind, rank 0's kernel calls of a step timed with the others idle);
    {run key: launches per step and the timed pass}."""
    tp = {}
    for i, run in enumerate(ranks[0]["runs"]):
        runs = [r["runs"][i] for r in ranks]
        key = run["key"]
        lp = [x["launches_per_step"] for x in runs]
        wit = run["witness"]
        print(f"({phase}) {key}: prefill logits {run['logits_rel']:.3e} and "
              f"first decode logits {run['first_rel']:.3e} of the unsharded "
              f"absmax (witness {wit['logits_rel']:.3e}, "
              f"{wit['first_rel']:.3e}); tokens agree in {run['agree']:.4f} "
              f"of (row, step) pairs (witness {wit['agree']:.4f}), "
              f"{run['agree_clear']:.4f} of the {run['clear'][0]} of "
              f"{run['clear'][1]} whose top two unsharded logits lie over "
              f"{TP_MARGIN} x {run['noise']:.3e} apart; logits and tokens "
              f"bitwise equal on every rank; kernel launches per rank per "
              f"step {lp}, prefill {[x['prefill_launches'] for x in runs]}",
              flush=True)
        print(f"  host ms per rank: prefill "
              f"{[round(x['prefill_ms'], 1) for x in runs]}; decode step "
              + "; ".join(f"{np.median(x['step_ms']):.1f}" for x in runs)
              + f" (median of {len(run['step_ms'])}) [{smi}]")
        print(f"  bytes sent per rank by kind: a prefill "
              f"{[x['prefill_bytes'] for x in runs]}, a decode step "
              f"{[x['step_bytes'] for x in runs]}")
        if "sites" in run:
            print(f"  layer 0: row-parallel reduced trunks bitwise the "
                  f"rank-order sums of the plain version over k_layout "
                  f"(blocks a rank: {run['sites']['row_blocks']}), "
                  f"{[x['sites']['col_sites'] for x in runs]} "
                  f"column-parallel trunks a rank bitwise the unsharded "
                  f"columns")
        if "batch" in run:
            print(f"  a row decoded at batch {TP_BATCH} bitwise the same "
                  f"at batch {run['batch']}")
        if "pod_rows" in run:
            print(f"  over pod x data: each rank's {run['pod_rows']} rows' "
                  f"logits of two decode steps bitwise the unsharded "
                  f"{TP_BATCH}-row steps', the gathered tokens bitwise "
                  f"their argmax")
        t = run["pass"]
        lib = (f", torch._int_mm {t['library_ms']:.3f}"
               if "library_ms" in t else "")
        print(f"  rank 0's {t['launches']} calls of a decode step (M = "
              f"{t['rows']}), the others idle: {t['ms']:.3f} ms (graph "
              f"{t['device_ms']:.3f}), plain {t['plain_ms']:.3f}, bound "
              f"{t['bound_ms']:.3f} ({t['bound_by']}){lib}; per-rank "
              f"geometries {run['geoms']} [{smi}]")
        tp[key] = {"launches_per_step": lp, "pass": t,
                   "step_bytes": [x["step_bytes"] for x in runs]}
    print(f"  builds in turn per rank (s): "
          f"{[[round(b, 1) for b in r['build_s']] for r in ranks]}; peak "
          f"device memory per rank {[round(r['peak_gib'], 2) for r in ranks]}"
          f" GiB (sum {sum(r['peak_gib'] for r in ranks):.2f})")
    return tp


def tp_dry_bytes(phase: str, shape, archs, tp: dict):
    """Each arch's serve step per rank on ``meta`` over a fake world of
    ``shape`` (``launch.dryrun``) against the bytes the gloo ranks sent a
    decode step, rank by rank and kind by kind."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    names = ("pod", "data", "model")[-len(shape):]
    with dryrun.dry_world(math.prod(shape)):
        mesh = mesh_lib.make_mesh(shape, names, backend=mesh_lib.FAKE)
        coords = [dict(zip(names, np.unravel_index(r, shape)))
                  for r in range(mesh.size)]
        for arch in archs:
            rec = dryrun.lower_cell(
                arch, "decode_32k", mesh, cfg=tp_config(arch), ranks=coords,
                engine="pallas_fused", seq=TP_MAX_LEN, gbatch=TP_BATCH)
            key = (f"{arch.replace('_', '-')}-pallas_fused-"
                   + "x".join(map(str, shape)))
            got = [r["bytes_sent"] for r in rec["ranks"]]
            check(got == tp[key]["step_bytes"], f"dry run {key}: bytes a "
                  f"rank {got} != the ranks' {tp[key]['step_bytes']}")
            print(f"({phase}) dry run of {key} on a fake {shape} world: "
                  f"every rank's bytes a decode step equal the gloo "
                  f"ranks' {got}", flush=True)
    print(f"  dry runs {time.perf_counter() - t0:.1f} s")


def phase_tp(dev, smi: str) -> tuple[dict, dict]:
    """32. Dense LMs served tensor-parallel over 4 gloo ranks on the one
    card: Gemma-2B at full width on (data 1, model 4), (2, 2) and (pod 2,
    data 2, model 1), Yi-34B at its widths cut to 2 layers on (1, 4), held
    to the port's unsharded steps run first in this process.  Returns the
    runs and the unsharded steps (phase 34 holds its runs to them too)."""
    t_phase = time.perf_counter()
    geoms = phase_tp_kernels(dev)
    print(f"phase 32 on {smi}: {TP_RANKS} gloo ranks on one card; "
          f"Gemma-2B ({TP_LAYERS} layers, full width, bf16) on meshes "
          f"{TP_MESHES + (TP_POD_MESH,)}, Yi-34B (widths published, "
          f"{TP_YI_LAYERS} layers) on (1, 4); {TP_BATCH} prompts of "
          f"{TP_PROMPT}, max_len {TP_MAX_LEN}; the ranks time-share the "
          f"card, so the host times are no scaling figure")
    oracle = tp_oracles(dev, (
        ("gemma_2b", "pallas_fused", TP_NEW, "gemma_2b"),
        ("gemma_2b", "pallas", TP_PALLAS_NEW, "gemma_2b_pallas"),
        ("yi_34b", "pallas_fused", TP_YI_NEW, "yi_34b")), {})
    ranks, spawn_s = tp_spawn(phase_tp_rank, TP_RANKS, oracle, "tp_oracle",
                              smi)
    tp = tp_report("32", ranks, smi)
    tp_dry_bytes("32", TP_POD_MESH, ("gemma_2b",), tp)
    print(f"phase 32 {time.perf_counter() - t_phase:.1f} s ({len(geoms)} "
          f"kernel geometries; ranks {spawn_s:.1f} s: Gemma "
          f"{ranks[0]['gemma_s']:.1f} s, Yi {ranks[0]['yi_s']:.1f} s)")
    return tp, {"oracle": oracle, "geoms": geoms}


def tp_spawn(fn, n: int, oracle: dict, name: str, smi: str):
    """``fn`` in ``n`` spawned gloo ranks on the card, the unsharded steps
    handed over through a file under ``build/``; (results, seconds)."""
    from repro_torch.launch import mesh as mesh_lib
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    path = os.path.join(ROOT, "build", f"{name}.pt")
    torch.save(oracle, path)
    t0 = time.perf_counter()
    ranks = mesh_lib.spawn(fn, n, backend="gloo", args=(path, smi),
                           deadline_s=TP_DEADLINE_S)
    return ranks, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phase 34: the dense layouts of uneven heads, over 3 ranks
# ---------------------------------------------------------------------------

TP3_RANKS = 3
TP3_MESH = (1, 3)               # (data, model): 56, 40 and 8 heads all
                                # divide 4, so no production dense model
                                # splits its heads unevenly over 4 ranks
# (arch, decode steps): Gemma-2B at phase 32's 9 layers (heads 3, 3, 2;
# its one kv head read by every rank; 256 % 3: a whole cache), Yi-34B and
# Qwen1.5-32B (with its qkv bias) at 2 layers (heads 19, 19, 18 and 14,
# 14, 12; Yi's kv heads 3, 3, 2 a rank read at rep 7, groups split)
TP3_ARCHS = (("gemma_2b", TP_NEW), ("yi_34b", TP_YI_NEW),
             ("qwen15_32b", TP_YI_NEW))


def phase_tp_uneven_rank(rank: int, world: int, path: str, smi: str) -> dict:
    """Phase 34, one spawned rank.  An arch phase 32 did not run gets its
    unsharded steps on rank 0, from the whole tree of its build turn (the
    parent would have to draw it too, and Qwen1.5-32B's is 29 GiB: its
    readout U alone 21.5), handed to the others."""
    import torch.distributed as dist
    from repro_torch import device as device_lib
    # before the rank's first CUDA allocation: Qwen1.5-32B's whole tree
    # (29 GiB) beside two ranks' blocks (14 GiB each) leaves no room for
    # the caching allocator's fragments
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    dev = device_lib.resolve()
    torch.cuda.reset_peak_memory_stats()
    oracle = torch.load(path)
    mesh = tp_meshes((TP3_MESH,))[TP3_MESH]
    res = {"runs": [], "build_s": [], "arch_s": {}, "held_gib": {}}
    for arch, new in TP3_ARCHS:
        t0 = time.perf_counter()
        # what the rank holds before it builds (nothing of the last arch)
        res["held_gib"][arch] = torch.cuda.memory_allocated() / 2 ** 30
        todo = () if arch in oracle else ((arch, "pallas_fused", new, arch),)
        local, probe, build_s = tp_build(
            tp_model(arch, "pallas_fused", mesh), rank, world,
            with_whole=lambda whole: rank == 0 and todo and tp_oracles(
                dev, todo, oracle, params=whole))
        if todo:
            box = [oracle.get(arch)]
            dist.broadcast_object_list(box, src=0)
            oracle[arch] = box[0]
        res["build_s"].append(build_s)
        res["runs"].append(tp_serve(arch, "pallas_fused", mesh, local, probe,
                                    oracle[arch], new, rank, world, smi))
        if arch == "gemma_2b":          # kernel 4 on the same blocks
            res["runs"].append(tp_serve(
                arch, "pallas", mesh, local, probe,
                oracle["gemma_2b_pallas"], TP_PALLAS_NEW, rank, world, smi,
                sites=False))
        del local, probe
        gc.collect()
        torch.cuda.empty_cache()
        res["arch_s"][arch] = time.perf_counter() - t0
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return res


def phase_tp_uneven(dev, smi: str, held: dict) -> dict:
    """34. Dense LMs whose heads split unevenly over the model axis (a
    rank holds ``h_layout(h, 3)``'s heads), GQA groups split between
    ranks, a whole cache on every rank: Gemma-2B, Yi-34B and Qwen1.5-32B
    at full width over 3 gloo ranks on the one card, on (data 1, model 3),
    held as phase 32 holds its runs (``held``: its unsharded steps and
    the kernel geometries 32(a) held)."""
    t_phase = time.perf_counter()
    runs = [(arch, (TP3_MESH,)) for arch, _ in TP3_ARCHS]
    # skipped: 32(a)'s geometries, and Gemma-2B's unsharded ones (phases 5
    # and 9 hold those in all three modes; a row's bits do not depend on M)
    geoms = phase_tp_kernels(dev, tp_geometries(
        runs, skip=set(held["geoms"]) | set(LM_GEOMS)), "34(a)")
    print(f"phase 34 on {smi}: {TP3_RANKS} gloo ranks on one card, mesh "
          f"{TP3_MESH}; Gemma-2B ({TP_LAYERS} layers), Yi-34B and "
          f"Qwen1.5-32B ({TP_YI_LAYERS} layers), full width, bf16; "
          f"{TP_BATCH} prompts of {TP_PROMPT}, max_len {TP_MAX_LEN}; "
          f"Qwen's unsharded steps on rank 0", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  this process: {torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB "
          f"reserved as the ranks start", flush=True)
    ranks, spawn_s = tp_spawn(phase_tp_uneven_rank, TP3_RANKS,
                              held["oracle"], "tp3_oracle", smi)
    tp = tp_report("34", ranks, smi)
    print(f"  GiB a rank holds before each build: "
          f"{[r['held_gib'] for r in ranks]}")
    tp_dry_bytes("34", TP3_MESH, [a for a, _ in TP3_ARCHS], tp)
    print(f"phase 34 {time.perf_counter() - t_phase:.1f} s ({len(geoms)} "
          f"new kernel geometries; ranks {spawn_s:.1f} s: "
          + ", ".join(f"{a} {t:.1f} s" for a, t in
                      ranks[0]["arch_s"].items()) + ")")
    return tp


# ---------------------------------------------------------------------------
# phase 36: the moe family served over a mesh
# ---------------------------------------------------------------------------

MOE_TP_ARCH = "granite_moe_3b"
MOE_TP_LAYERS = 4               # Granite-MoE-3B's depth cut (of 32), for the
                                # script's time limit
MOE_TP_MESHES = ((1, 4), (2, 2))  # (data, model): E 40 over model 4 and 2,
                                  # 10 and 20 experts a rank (the "expert"
                                  # layout); over (2, 2) a decode step's
                                  # group of 8 tokens spans both data ranks
MOE_TP_NEW = 8
# the per-rank kernel-3 geometries (K, N) of the attention linears: q on
# whole heads (6 and 12 a rank), k and v on their columns, o row-parallel
# on whole 512-wide k-blocks (sharding.k_layout: its 3 blocks go 1, 1, 1,
# 0 over model 4, so rank 3 launches no o; 2, 1 over model 2)
MOE_TP_GEOMS = {(1536, 384), (1536, 128), (512, 1536),
                (1536, 768), (1536, 256), (1024, 1536)}


def moe_trunk_check(probe: dict):
    """A check for :func:`tp_serve`: one decode step (on a copy of the
    cache) with layer 0's first stacked expert trunk call (gate)
    recorded: its rows, those of the rank's experts, bitwise the
    unsharded trunk's rows for them (layer 0's whole gate ``w_q`` and
    ``w_scale`` in ``probe``, the other experts' rows zero).  Returns the
    rank's experts."""
    def run(model, local, cache, tok):
        from repro_torch.distributed import sharding as shd
        from repro_torch.models import moe
        real, seen = moe.stacked_trunk_matmul, []

        def recording(x, w_q, w_scale):
            out = real(x, w_q, w_scale)
            if not seen:
                seen.append((x, out))
            return out
        moe.stacked_trunk_matmul = recording
        try:
            model.decode_step(local, tok, copy.deepcopy(cache))
        finally:
            moe.stacked_trunk_matmul = real
        x, out = seen[0]
        cfg, mesh = model.cfg, model.mesh
        check(shd.expert_layout(cfg.num_experts, cfg.moe_d_ff, mesh)
              == "expert", f"{cfg.name}: not the expert layout")
        lo, hi = shd.h_layout(cfg.num_experts, mesh.shape["model"])[
            mesh.coordinate("model")]
        whole = x.new_zeros((cfg.num_experts, *x.shape[1:]))
        whole[lo:hi] = x
        want = real(whole, probe["w_q"], probe["w_scale"])[lo:hi]
        check(out.shape[0] == hi - lo and torch.equal(out, want),
              f"{cfg.name}: a rank's stacked trunk rows of experts "
              f"{lo}-{hi} != the unsharded trunk's")
        return (lo, hi, tuple(out.shape))
    return run


def phase_moe_tp_rank(rank: int, world: int, path: str, smi: str) -> dict:
    """Phase 36, one spawned rank."""
    from repro_torch import device as device_lib
    from repro_torch.kernels import _build
    check(_build.target("rebranch_matmul").exists(),
          "rebranch_matmul is not built: the parent builds it before the "
          "ranks")
    device_lib.resolve()
    torch.cuda.reset_peak_memory_stats()
    oracle = torch.load(path)
    meshes = tp_meshes(MOE_TP_MESHES)
    res = {"runs": [], "build_s": []}
    for shape in MOE_TP_MESHES:
        mesh = meshes[shape]
        probe = {}

        def keep(whole):
            gate = whole["layers"]["moe"]["experts"]["gate"]["rom"]
            probe.update(w_q=gate["w_q"][0].clone(),
                         w_scale=gate["w_scale"][0].clone())
        local, _, build_s = tp_build(
            tp_model(MOE_TP_ARCH, "pallas_fused", mesh), rank, world,
            probes=False, with_whole=keep)
        res["build_s"].append(build_s)
        res["runs"].append(tp_serve(
            MOE_TP_ARCH, "pallas_fused", mesh, local, None,
            oracle[MOE_TP_ARCH], MOE_TP_NEW, rank, world, smi, sites=False,
            after=moe_trunk_check(probe)))
        del local, probe
        torch.cuda.empty_cache()
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return res


def phase_moe_tp(dev, smi: str) -> dict:
    """36. Granite-MoE-3B at full width (cut to MOE_TP_LAYERS layers, bf16,
    'pallas_fused') served over 4 gloo ranks on the one card, on (data 1,
    model 4) and (2, 2), whole experts a rank: kernel 3 at the attention's
    new per-rank geometries in all three modes; the steps held to the
    port's unsharded steps run first in this process (logits within
    max(5e-2, 2 x a nudged witness), tokens where the margin is clear),
    bitwise equal on every rank; each rank's stacked expert trunk rows
    bitwise the unsharded trunk's; kernel-3 launches per rank per step as
    counted; each rank's bytes a decode step equal to the dry run's."""
    t_phase = time.perf_counter()
    geoms = tp_geometries(((MOE_TP_ARCH, MOE_TP_MESHES),))
    check(set(geoms) == MOE_TP_GEOMS, f"phase 36 geometries {set(geoms)}")
    phase_tp_kernels(dev, geoms, "36(a)")
    print(f"phase 36 on {smi}: {TP_RANKS} gloo ranks on one card; "
          f"Granite-MoE-3B ({MOE_TP_LAYERS} layers, full width, bf16, 40 "
          f"experts top-8) on meshes {MOE_TP_MESHES}; {TP_BATCH} prompts of "
          f"{TP_PROMPT}, {MOE_TP_NEW} decode steps, max_len {TP_MAX_LEN}",
          flush=True)
    oracle = tp_oracles(dev, (
        (MOE_TP_ARCH, "pallas_fused", MOE_TP_NEW, MOE_TP_ARCH),), {})
    ranks, spawn_s = tp_spawn(phase_moe_tp_rank, TP_RANKS, oracle,
                              "moe_tp_oracle", smi)
    tp = tp_report("36", ranks, smi)
    for i, shape in enumerate(MOE_TP_MESHES):
        print(f"(36) {shape}: each rank's layer-0 stacked gate trunk "
              f"(experts, shape) bitwise the unsharded trunk's rows: "
              f"{[r['runs'][i]['after'] for r in ranks]}")
        tp_dry_bytes("36", shape, (MOE_TP_ARCH,), tp)
    print(f"phase 36 {time.perf_counter() - t_phase:.1f} s ({len(geoms)} "
          f"kernel geometries; ranks {spawn_s:.1f} s)")
    return tp


# ---------------------------------------------------------------------------
# phase 35: branch training over a model axis
# ---------------------------------------------------------------------------

TPT_MESHES = ((1, 4), (2, 2))       # (data, model)
# (activations, meshes): f32 held to one process on both meshes, bf16 to
# a witness on the widest model axis (phase 31 runs bf16 on one mesh too)
TPT_RUNS = (("float32", TPT_MESHES), ("bfloat16", ((1, 4),)))
TPT_STEPS = 3
TPT_DEADLINE_S = 400
# bf16: a rank's gradient blocks vs the one-process step on the whole
# batch, as a multiple of the gap of a one-process witness whose trunks
# are moved by ~1 f32 ulp (``nudged_kernels``), or GRAD_RTOL, whichever
# is larger
TPT_WITNESS_FACTOR = 2.0


def tpt_config(dtype: str):
    """Gemma-2B at full width cut to phase 31's TRAIN_LAYERS, remat on
    (the reference's training forward)."""
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get("gemma_2b"),
                              num_layers=TRAIN_LAYERS, dtype=dtype)
    check(cfg.remat, "Gemma-2B's config trains without remat")
    return cfg


def tpt_step(cfg, model):
    """The phase's step: ``make_train_step`` at the dry run's loss chunks
    (its bytes are held to the dry run's)."""
    from repro_torch import optim
    from repro_torch.launch import steps
    return steps.make_train_step(cfg, optim.AdamWConfig(lr=TRAIN_LR),
                                 model=model, global_batch=TRAIN_BATCH)


def tpt_expected_launches(cfg, n: int, r: int) -> int:
    """Kernel-4 launches model rank ``r`` of ``n`` makes a train step: one
    per ROM linear whose block it holds in the forward (a moe block's
    attention four: its experts are plain PyTorch stacks), one more in
    each block's remat recompute, none in the straight-through backward
    (the readout is the tied table: no kernel)."""
    per_layer = sum(tp_rank_geometry(cfg, site, n, r) is not None
                    for site in tp_block_sites(cfg))
    return 2 * per_layer * cfg.num_layers


def tpt_whole_rank(cfg, whole, batch, dev, witness: bool = False) -> dict:
    """Rank 0's one-process step on the whole batch: gradients (on the
    host), loss, grad_norm; in bf16 (or with ``witness``) also the nudged
    witness's worst gradient leaf and its loss's relative distance."""
    from repro_torch import bridge, deploy, optim
    from repro_torch.core import rebranch
    model = deploy.compile_model(cfg, engine="pallas")
    t, f = rebranch.partition(whole)
    step = tpt_step(cfg, model)
    loss, grads = step.grads(t, f, batch)
    _, _, m = step(t, f, optim.init(t), batch)
    out = {"loss": float(loss), "grad_norm": float(m["grad_norm"]),
           "grads": bridge.tree_map(grads, lambda g: g.float().cpu())}
    if cfg.dtype == "bfloat16" or witness:
        with nudged_kernels(dev):
            n_loss, nudged = step.grads(t, f, batch)
        out["witness"] = worst_leaf(nudged, grads)
        out["witness_loss"] = abs(float(n_loss) - float(loss)) / abs(
            float(loss))
    return out


def tpt_run(cfg, whole, mesh, batch, ref: dict, rank: int, world: int,
            fingerprint: bool) -> dict:
    """TPT_STEPS steps of ``cfg`` over ``mesh`` on the rank's blocks,
    held to the one-process step ``ref`` (rank 0's, broadcast); the ROM's
    objects and addresses unmoved, and with ``fingerprint`` its SHA-256
    (~1 GB a rank through the host)."""
    import torch.distributed as dist
    from repro_torch import bridge, deploy, optim
    from repro_torch.core import rebranch, rom
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import cim_matmul as cm
    from repro_torch.launch import steps
    from repro_torch.optim import compress
    n, r = mesh.shape["model"], mesh.coordinate("model")
    model = deploy.compile_model(cfg, engine="pallas", mesh=mesh)
    local = model.shard_params(whole)
    t, f = rebranch.partition(local)
    opt = optim.init(t)
    trunk = trunk_objects(local)
    ptrs = {k: v.data_ptr() for k, v in trunk.items()}
    fp0 = rom.rom_fingerprint(local) if fingerprint else None
    mine = steps.local_batch(cfg, mesh, batch, TRAIN_BATCH)
    step = tpt_step(cfg, model)
    split = step.split_leaves(mesh)
    calls, kernel = [], cm.cim_matmul

    def recording(x_q, w_q, c=cm.IDEAL, plan=None):
        calls.append((x_q, w_q, c))
        return kernel(x_q, w_q, c, plan)

    out = {"key": tpt_key(cfg, tuple(mesh.shape[a]
                                      for a in mesh.axis_names)),
        "rows": int(mine["tokens"].shape[0]), "step_ms": [], "loss": [],
        "launches": [], "bytes": [], "wire": []}

    def begin():
        dist.barrier()
        torch.cuda.synchronize()
        reset_launches()
        shd.reset_traffic()
        compress.wire_bytes.clear()
        return time.perf_counter()

    def end(t0, m):
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append(read_launches()["cim_matmul"])
        out["bytes"].append(dict(shd.bytes_sent))
        out["wire"].append(dict(compress.wire_bytes))
        out["loss"].append(float(m["loss"]))
    # step 1: its gradients kept (BranchStep.__call__ is grads + update)
    t0 = begin()
    cm.cim_matmul = recording
    try:
        loss, grads = step.grads(t, f, mine)
    finally:
        cm.cim_matmul = kernel
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    t, opt, m = step.update(t, opt, loss, grads)
    end(t0, m)
    # the first step's split: value_and_grad (forward, remat recompute,
    # backward) with the gradients' reductions, then AdamW
    out["split_ms"] = {"grads": (t1 - t0) * 1e3,
                       "update": out["step_ms"][0] - (t1 - t0) * 1e3}
    out["grad_norm"] = float(m["grad_norm"])
    # (a) every per-rank geometry of the step equal to the plain version
    geoms = {}
    for x_q, w_q, c in calls:
        geoms.setdefault((x_q.shape[0], *w_q.shape), (x_q, w_q, c))
    for (m, k, nn), (x_q, w_q, c) in geoms.items():
        check(torch.equal(kernel(x_q, w_q, c),
                          cm.cim_matmul_plain(x_q, w_q, c)),
              f"kernel 4 at M = {m}, {k}x{nn} != its plain version")
    out["geoms"] = sorted(geoms)
    out["calls"] = len(calls)
    # the loss and every leaf held whole bitwise equal on every rank
    agreed(f"{out['key']}: the loss and the whole leaves' gradients",
           (float(loss), digests({k: v for k, v in
                                  bridge.flatten(grads).items()
                                  if k not in split})), world)
    # every block within the bar of the one-process step's leaf
    out["grad_rel"] = tpt_worst_block(cfg, whole, mesh, grads, ref)
    out["loss0"] = float(loss)
    for _ in range(TPT_STEPS - 1):
        t0 = begin()
        t, opt, m = step(t, f, opt, mine)
        end(t0, m)
    check(out["bytes"][1:] == out["bytes"][:-1], f"{out['key']} rank "
          f"{rank}: the steps' bytes differ {out['bytes']}")
    expect = tpt_expected_launches(cfg, n, r)
    check(out["launches"] == [expect] * TPT_STEPS,
          f"{out['key']} rank {rank}: kernel-4 launches a step "
          f"{out['launches']}, expected {expect} (forward and recompute)")
    check(all(math.isfinite(v) for v in out["loss"]),
          f"{out['key']}: losses {out['loss']}")
    agreed(f"{out['key']}: the losses and the first norm",
           (out["loss"], out["grad_norm"]), world)
    agreed(f"{out['key']}: the leaves held whole after the last update",
           digests({k: v for k, v in bridge.flatten(t).items()
                    if k not in split}), world)
    check(same_trunk(rebranch.combine(t, f), trunk, ptrs),
          f"{out['key']}: training copied, replaced or moved a trunk tensor")
    check(fp0 is None or rom.rom_fingerprint(rebranch.combine(t, f)) == fp0,
          f"{out['key']}: the ROM fingerprint moved")
    out["fingerprint"] = fingerprint
    out["expect"] = expect
    dist.barrier()
    if rank == 0 and cfg.dtype == "float32":   # the other ranks idle
        out["kernel"] = pass_times_m(calls, kernel, cm)
    dist.barrier()
    return out


def tpt_worst_block(cfg, whole, mesh, grads, ref: dict):
    """(distance, leaf) of the rank's gradient block farthest from its
    block of the one-process step's ``ref``, over that leaf's absmax."""
    from repro_torch import bridge
    from repro_torch.distributed import sharding as shd
    sh = bridge.flatten(shd.param_shardings(whole, mesh))
    want = bridge.flatten(ref["grads"])
    worst = (0.0, "")
    experts = ((cfg.num_experts, cfg.moe_d_ff or cfg.d_ff)
               if cfg.family == "moe" else None)
    for k, g in bridge.flatten(grads).items():
        b = shd.param_bounds(k, tuple(want[k].shape), sh[k],
                             cfg.rebranch.cim.rows_per_subarray, cfg.head_dim,
                             experts)
        block = want[k][tuple(slice(lo, hi) for lo, hi in b)]
        rel = ((g.float().cpu() - block).abs().max().item()
               / max(want[k].abs().max().item(), 1e-30))
        worst = max(worst, (rel, k))
    return worst


def phase_tp_train_rank(rank: int, world: int) -> dict:
    """Phase 35, one spawned rank."""
    import torch.distributed as dist
    from repro_torch import deploy
    from repro_torch import device as device_lib
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    check(_build.target("cim_matmul").exists(),
          "cim_matmul is not built: the parent builds it before the ranks")
    dev = device_lib.resolve()
    meshes = tp_meshes(TPT_MESHES)
    res = {"runs": [], "parts_s": {}}
    t_rank = time.perf_counter()

    def part(name, t0):
        res["parts_s"][name] = time.perf_counter() - t0
        return time.perf_counter()
    for dtype, shapes in TPT_RUNS:
        t0 = time.perf_counter()
        cfg = tpt_config(dtype)
        whole = deploy.compile_model(cfg, engine="pallas").init(seed=0)
        dcfg = synthetic.DataConfig(seed=0, vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH)
        batch = synthetic.markov_batch(dcfg, 0, device=dev)
        t0 = part(f"{dtype} init", t0)
        box = [tpt_whole_rank(cfg, whole, batch, dev) if rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        ref = box[0]
        t0 = part(f"{dtype} one process", t0)
        for shape in shapes:
            run = tpt_run(cfg, whole, meshes[shape], batch, ref, rank,
                          world, not res["runs"])
            t0 = part(f"{run['key']}", t0)
            if dtype == "float32":
                check(run["grad_rel"][0] <= GRAD_RTOL,
                      f"{run['key']} rank {rank}: gradient block "
                      f"{run['grad_rel'][1]} is {run['grad_rel'][0]:.3e} of "
                      f"its absmax from the one-process step's")
            else:
                limit = max(GRAD_RTOL, TPT_WITNESS_FACTOR
                            * ref["witness"][0])
                check(run["grad_rel"][0] <= limit,
                      f"{run['key']} rank {rank}: bf16 gradient block "
                      f"{run['grad_rel'][1]} is {run['grad_rel'][0]:.3e} of "
                      f"its absmax from the one-process step's, over "
                      f"{limit:.3e} (the nudged witness's "
                      f"{ref['witness'][0]:.3e})")
            check(abs(run["loss0"] - ref["loss"]) <= GRAD_RTOL * abs(
                ref["loss"]), f"{run['key']}: loss {run['loss0']} vs one "
                  f"process {ref['loss']}")
            run["ref"] = {k: ref[k] for k in ("loss", "grad_norm")
                          if k in ref}
            run["witness"] = ref.get("witness")
            res["runs"].append(run)
            gc.collect()
            torch.cuda.empty_cache()
        del whole, ref, box
        gc.collect()
        torch.cuda.empty_cache()
    res["rank_s"] = time.perf_counter() - t_rank
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return res


def tpt_key(cfg, shape) -> str:
    """A training run's key: the arch, activations and mesh shape."""
    return (f"{cfg.name.replace('_', '-')}-{cfg.dtype}-"
            + "x".join(map(str, shape)))


def tpt_dry_runs() -> dict:
    """Each run's train step per rank on ``meta`` over a fake world of its
    mesh (``launch.dryrun``): {run key: record}."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    out = {}
    for dtype, shapes in TPT_RUNS:
        cfg = tpt_config(dtype)
        for shape in shapes:
            with dryrun.dry_world(math.prod(shape)):
                mesh = mesh_lib.make_lm_mesh(*shape, backend=mesh_lib.FAKE)
                out[tpt_key(cfg, shape)] = \
                    dryrun.lower_cell(
                        "gemma_2b", "train_4k", mesh, cfg=cfg,
                        ranks=[{"data": d, "model": m}
                               for d in range(shape[0])
                               for m in range(shape[1])],
                        engine="pallas", seq=TRAIN_SEQ, gbatch=TRAIN_BATCH)
    return out


def tpt_dry_bytes(runs: dict, dry: dict, phase: str = "35"):
    """The dry runs' (:func:`tpt_dry_runs`) bytes a rank sends a step
    against the gloo ranks', rank by rank and kind by kind, and their
    kernel-4 launches against the ranks'."""
    for key, rec in dry.items():
        sent = [run["bytes"][0] for run in runs[key]]
        got = [r["bytes_sent"] for r in rec["ranks"]]
        check(got == sent, f"dry run {key}: bytes a rank {got} != the "
              f"ranks' {sent}")
        kernels = rec["kernels"].get("cim_matmul", {}).get("launches")
        made = runs[key][rec["rank"]]["launches"][0]
        check(kernels == made, f"dry run {key}: {kernels} kernel-4 "
              f"launches, rank {rec['rank']} made {made} a step")
        print(f"({phase}) dry run of {key} on a fake world: every rank's "
              f"bytes a step equal the gloo ranks' (rank 0: {got[0]}); rank "
              f"{rec['rank']}'s kernel-4 launches {kernels}; its peak "
              f"{rec['peak_bytes_per_dev'] / 2 ** 30:.3f} GiB", flush=True)


def phase_tp_train(smi: str) -> dict:
    """35. Branch training over a model axis: Gemma-2B at full width cut
    to TRAIN_LAYERS, remat on, over 4 gloo ranks on the one card, the runs
    of TPT_RUNS (f32 on (data 1, model 4) and (2, 2), bf16 on (1, 4)),
    TPT_STEPS steps each, held to the one-process step on rank 0's whole
    batch; the bytes a rank sends held to the dry run's."""
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    print(f"phase 35 on {smi}: {DIST_RANKS} gloo ranks on one card; "
          f"Gemma-2B at full width cut to {TRAIN_LAYERS} layers (remat on), "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, 'pallas', (activations, "
          f"meshes) {TPT_RUNS}, {TPT_STEPS} steps each; the ranks "
          f"time-share the card, so the host times are no scaling figure",
          flush=True)
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(mesh_lib.spawn, phase_tp_train_rank,
                              DIST_RANKS, backend="gloo",
                              deadline_s=TPT_DEADLINE_S)
        t_dry = time.perf_counter()
        dry = tpt_dry_runs()            # meanwhile, on the host
        t_dry = time.perf_counter() - t_dry
        ranks = spawned.result()
    runs = {}
    for i, run in enumerate(ranks[0]["runs"]):
        rs = [r["runs"][i] for r in ranks]
        runs[run["key"]] = rs
        wit = ("" if run["witness"] is None else
               f" (the nudged witness {run['witness'][0]:.3e}, "
               f"{run['witness'][1]})")
        print(f"(35) {run['key']}: {run['rows']} rows a rank; loss "
              f"{run['loss0']:.6f} vs one process {run['ref']['loss']:.6f}, "
              f"bitwise on every rank with every whole leaf's gradient; "
              f"worst gradient block per rank "
              + ", ".join(f"{x['grad_rel'][0]:.3e}" for x in rs)
              + f" of its leaf's absmax ({run['grad_rel'][1]}){wit}; "
              f"grad_norm {run['grad_norm']:.6f} vs {run['ref']['grad_norm']:.6f}"
              f"; losses {[round(v, 6) for v in run['loss']]}; kernel-4 "
              f"launches per rank a step {[x['launches'][0] for x in rs]} "
              f"(forward + recompute, none in the backward), "
              f"{len(run['geoms'])} geometries on rank 0 torch.equal to the "
              f"plain version; ROM tensors unmoved"
              + (", its fingerprint too" if run["fingerprint"] else ""),
              flush=True)
        print(f"  step host ms per rank: " + "; ".join(
            ", ".join(f"{t:.1f}" for t in x["step_ms"]) for x in rs)
              + f" [{smi}]")
        print(f"  bytes sent per rank a step by kind: "
              + "; ".join(str(x["bytes"][0]) for x in rs)
              + f"; wire bytes {[x['wire'][0] for x in rs]}")
        k = run.get("kernel")
        if k is not None:
            print(f"  kernel 4, rank 0's {run['calls']} calls of a step's "
                  f"value_and_grad (M, K, N: {run['geoms']}), the others "
                  f"idle: {k['ms']:.3f} ms, plain {k['plain_ms']:.3f}, "
                  f"torch._int_mm {k['library_ms']:.3f}, bound "
                  f"{k['bound_ms']:.3f} ({k['bound_by']}) [{smi}]",
                  flush=True)
    tpt_dry_bytes(runs, dry)
    r0 = ranks[0]
    print(f"phase 35 {time.perf_counter() - t0:.1f} s (dry runs {t_dry:.1f} "
          f"s beside the ranks; rank 0 {r0['rank_s']:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in r0["parts_s"].items())
          + f"; peak device memory per rank "
          f"{[round(r['peak_gib'], 2) for r in ranks]} GiB)")
    return {key: {"launches": [x["launches"] for x in rs],
                  "kernel": rs[0].get("kernel")}
            for key, rs in runs.items()}


# ---------------------------------------------------------------------------
# phase 37: the moe family trained over a mesh
# ---------------------------------------------------------------------------

MOE_TRAIN_LAYERS = 3              # Granite-MoE-3B's depth cut (of 32), for
                                  # the script's time limit
MOE_TRAIN_SEQ = 96                # 8 x 96 = 768 tokens: 3 routing groups
                                  # of 256; over data 2 group 1 (tokens
                                  # 256-511) spans both data ranks
MOE_TRAIN_MESHES = ((1, 4), (2, 2))   # (data, model): E 40 over model 4
                                      # and 2, the "expert" layout
# the per-rank kernel-4 geometries (K, N) of the attention linears: q on
# whole heads, k and v on their columns, o row-parallel on whole 512-wide
# k-blocks (1, 1, 1, 0 over model 4; 2, 1 over model 2)
MOE_TRAIN_GEOMS = {(1536, 384), (1536, 128), (512, 1536),
                   (1536, 768), (1536, 256), (1024, 1536)}


def moe_train_config():
    """Granite-MoE-3B at full width cut to MOE_TRAIN_LAYERS layers, f32
    activations (the gradients' 1e-5 gate needs them), remat on."""
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get(MOE_TP_ARCH),
                              num_layers=MOE_TRAIN_LAYERS, dtype="float32")
    check(cfg.remat, "Granite-MoE-3B's config trains without remat")
    return cfg


def moe_train_geometries(cfg) -> dict:
    """:func:`phase_tp_kernels`' geometries of the phase: each rank's
    (K, N) of kernel 4 at the train step's M (the rank's tokens)."""
    out = {}
    for n_data, n in MOE_TRAIN_MESHES:
        m = TRAIN_BATCH // n_data * MOE_TRAIN_SEQ
        for site in tp_block_sites(cfg):
            for g in {tp_rank_geometry(cfg, site, n, r)
                      for r in range(n)} - {None}:
                _, m0, who = out.get(g, (0, 0, []))
                out[g] = (0, max(m0, m), who + [f"{site}@{n_data}x{n}"])
    return out


# the step's first loss against one process's, relative: a mean over 768
# tokens moves with the chaos more than a nudged witness does (the ranks
# read 1 to 2.7 x their witness), so it takes the rule of a loss on
# another rounding path (phases 16-17's card against the CPU)
MOE_LOSS_RTOL = 1e-3
MOE_BLOCK_SEED = 37
# the block check's sequence: 8 x 32 tokens are one routing group of 256,
# which spans both data ranks of (2, 2); every rank's expert stacks then
# hold the one process's slot count, so their GEMMs take its shapes
MOE_BLOCK_SEQ = 32


@contextlib.contextmanager
def experts_in_slices(per: int):
    """The moe block's expert linears (``moe.apply_expert_linear``) on
    consecutive slices of ``per`` experts: one process's block at the
    GEMM shapes of a rank that holds ``per`` experts whole (cuBLAS picks
    its algorithm by shape, so an expert's bits follow the slice)."""
    from repro_torch.models import moe
    whole = moe.apply_expert_linear
    mine = ("w_q", "w_scale", "core", "w")      # [E, ...]; C and U shared

    def sliced(params, x):
        return torch.cat([whole(
            {side: {k: v[lo:lo + per] if k in mine else v
                    for k, v in leaves.items()}
             for side, leaves in params.items()}, x[lo:lo + per])
            for lo in range(0, x.shape[0], per)])
    moe.apply_expert_linear = sliced
    try:
        yield
    finally:
        moe.apply_expert_linear = whole


def moe_block_grads(cfg, block, x, dy, sp=None, rows=None):
    """(dx, the trainable leaves' gradients, the leaves marked partial) of
    ``sum(apply_moe_block(block, x) * dy)``: one moe block's adjoints,
    under the bound mesh (``sp``, ``rows``) or in one process."""
    from repro_torch import bridge
    from repro_torch.core import rebranch
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import moe
    t, f = rebranch.partition(block)
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in bridge.flatten(t).items()}
    xx = x.detach().requires_grad_(True)
    kw = {k: v for k, v in (("sp", sp), ("rows", rows)) if v is not None}
    with torch.enable_grad(), shd.partial_leaves() as seen:
        params = rebranch.combine(bridge.map_named(t, lambda k, _: leaves[k]),
                                  f)
        y = moe.apply_moe_block(params, xx, cfg, **kw)
        got = torch.autograd.grad((y.float() * dy).sum(),
                                  [xx, *leaves.values()], allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), got[1:])}
    return (got[0], bridge.map_named(t, lambda k, _: grads[k]),
            {k for k, v in leaves.items() if id(v) in seen})


def moe_block_inputs(cfg, dev):
    """Layer 0's moe block input and output gradient, [TRAIN_BATCH,
    MOE_BLOCK_SEQ, d] each, seeded."""
    gen = torch.Generator(device=dev).manual_seed(MOE_BLOCK_SEED)
    shape = (TRAIN_BATCH, MOE_BLOCK_SEQ, cfg.d_model)
    return (torch.randn(shape, generator=gen, device=dev),
            torch.randn(shape, generator=gen, device=dev))


def moe_block_check(cfg, whole, mesh, ref: dict, dev) -> float:
    """Layer 0's moe block over ``mesh`` as the train step runs it (the
    rank's rows of the batch, the residual's seq_sp layout), fed the
    one-process block's input and output gradient: its dx (summed over
    the model axis where x came whole into parts) and every gradient
    block (the partial leaves summed over the model axis, all over the
    batch axes, as the step reduces them) against the one-process
    block's ``ref``, whose expert linears ran on slices of this mesh's
    experts a rank (:func:`experts_in_slices`).  The forward is then the
    one process's bit for bit up to the partial outputs' sum (the same
    routing frame, the same GEMM shapes), so no chaos stands between
    them.  Returns the worst distance over its leaf's absmax, and the
    leaf."""
    from repro_torch import bridge, deploy
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    model = deploy.compile_model(cfg, engine="pallas", mesh=mesh)
    block = transformer.layer(model.shard_params(whole)["layers"], 0)["moe"]
    x, dy = moe_block_inputs(cfg, dev)
    lo, hi = shd.batch_block(TRAIN_BATCH, mesh)
    x, dy = x[lo:hi], dy[lo:hi]
    with shd.use_mesh(mesh):
        at = shd.axis_layout("seq_sp", MOE_BLOCK_SEQ)
        sp = None if at is None else at[2]
        if sp is not None:
            c0, c1 = sp[mesh.coordinate("model")]
            dy = dy[:, c0:c1]
        dx, grads, partial = moe_block_grads(cfg, block, x, dy, sp,
                                             (lo, hi, TRAIN_BATCH))
        if sp is not None:            # x entered parts: the gather's sum
            dx = shd.sum_parts(dx, mesh, "model", "check")
        grads = steps.reduce_partial(grads, partial, mesh)
        _, grads = steps.reduce_grads(torch.zeros((), device=dev), grads,
                                      mesh)
        n = math.prod(mesh.shape[a] for a in shd.batch_axes(mesh))
        grads = bridge.tree_map(grads, lambda g: g * n)   # the ranks' sum
    check(bool(partial), "phase 37: the moe block marked no leaf partial")
    sh = bridge.flatten(shd.param_shardings(whole, mesh))
    experts = (cfg.num_experts, cfg.moe_d_ff)
    worst = [((dx.cpu() - ref["dx"][lo:hi]).abs().max().item()
              / ref["dx"].abs().max().item(), "dx")]
    for k, g in bridge.flatten(grads).items():
        path = "['layers']['moe']" + k
        want = ref["grads"][k]
        b = shd.param_bounds(path, (1, *want.shape), sh[path],
                             cfg.rebranch.cim.rows_per_subarray,
                             cfg.head_dim, experts)[1:]
        block_want = want[tuple(slice(a, z) for a, z in b)]
        worst.append(((g.cpu() - block_want).abs().max().item()
                      / max(want.abs().max().item(), 1e-30), k))
    return max(worst)


def phase_moe_train_rank(rank: int, world: int) -> dict:
    """Phase 37, one spawned rank."""
    import torch.distributed as dist
    from repro_torch import bridge, deploy
    from repro_torch import device as device_lib
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.models import transformer
    check(_build.target("cim_matmul").exists(),
          "cim_matmul is not built: the parent builds it before the ranks")
    dev = device_lib.resolve()
    torch.cuda.reset_peak_memory_stats()
    meshes = tp_meshes(MOE_TRAIN_MESHES)
    t_rank = time.perf_counter()
    cfg = moe_train_config()
    whole = tp_params(deploy.compile_model(cfg, engine="pallas"))
    batch = synthetic.markov_batch(synthetic.DataConfig(
        seed=0, vocab_size=cfg.vocab_size, seq_len=MOE_TRAIN_SEQ,
        global_batch=TRAIN_BATCH), 0, device=dev)
    ref = block_ref = None
    if rank == 0:
        ref = tpt_whole_rank(cfg, whole, batch, dev, witness=True)
        block_ref = {}
        for shape in MOE_TRAIN_MESHES:
            with experts_in_slices(cfg.num_experts // shape[1]):
                dx, grads, _ = moe_block_grads(
                    cfg, transformer.layer(whole["layers"], 0)["moe"],
                    *moe_block_inputs(cfg, dev))
            block_ref[shape] = {"dx": dx.cpu(), "grads": {
                k: g.cpu() for k, g in bridge.flatten(grads).items()}}
    box = [ref, block_ref]
    dist.broadcast_object_list(box, src=0)
    ref, block_ref = box
    # the whole step is chaotic at full width: an ulp moved before the
    # dispatch's bf16 cast (the reference's) rounds a token's element the
    # other way, and where that element is its row's absmax every int8
    # code of the row moves; so the step's gradients are held to the
    # nudged witness (phase 35's bf16 bar), its first loss to MOE_LOSS_RTOL
    # and the block alone to GRAD_RTOL
    grad_bar = max(GRAD_RTOL, TPT_WITNESS_FACTOR * ref["witness"][0])
    loss_bar = MOE_LOSS_RTOL
    res = {"runs": [], "one_s": time.perf_counter() - t_rank}
    for shape in MOE_TRAIN_MESHES:
        mesh = meshes[shape]
        block, leaf = moe_block_check(cfg, whole, mesh, block_ref[shape],
                                      dev)
        check(block <= GRAD_RTOL,
              f"phase 37 {shape} rank {rank}: layer 0's moe block adjoints "
              f"{block:.3e} of their absmax from the one-process block's "
              f"({leaf})")
        run = tpt_run(cfg, whole, mesh, batch, ref, rank, world,
                      not res["runs"])
        check(run["grad_rel"][0] <= grad_bar,
              f"{run['key']} rank {rank}: gradient block "
              f"{run['grad_rel'][1]} is {run['grad_rel'][0]:.3e} of its "
              f"absmax from the one-process step's, over {grad_bar:.3e} "
              f"(the nudged witness's {ref['witness'][0]:.3e})")
        loss_rel = abs(run["loss0"] - ref["loss"]) / abs(ref["loss"])
        check(loss_rel <= loss_bar,
              f"{run['key']}: loss {run['loss0']} vs one process "
              f"{ref['loss']}: {loss_rel:.3e}, over {loss_bar:.0e} (the "
              f"nudged witness's {ref['witness_loss']:.3e})")
        check(run["loss"][-1] < run["loss"][0],
              f"{run['key']}: the loss did not fall: {run['loss']}")
        run.update(block_rel=block, loss_rel=loss_rel, bars=(grad_bar,
                                                            loss_bar))
        run["ref"] = {k: ref[k] for k in ("loss", "grad_norm", "witness",
                                          "witness_loss")}
        res["runs"].append(run)
        gc.collect()
        torch.cuda.empty_cache()
    # the bar separates a wrong adjoint: the first mesh's step with the
    # block's partial leaves (the router) left unmarked, so their
    # gradients stay each rank's part
    fault = moe_fault_rel(cfg, whole, meshes[MOE_TRAIN_MESHES[0]], batch,
                          ref)
    check(fault[0] > grad_bar,
          f"phase 37 rank {rank}: with the moe block's partial leaves "
          f"unmarked the worst gradient block is {fault[0]:.3e} ({fault[1]})"
          f", within the step's bar {grad_bar:.3e}: the bar hides the fault")
    res["fault"] = fault
    # the loss bar separates a wrong forward: the same step's loss with
    # the ranks' partial expert outputs left unsummed
    lost = moe_unsummed_loss(cfg, whole, meshes[MOE_TRAIN_MESHES[0]], batch)
    lost_rel = abs(lost - ref["loss"]) / abs(ref["loss"])
    check(lost_rel > loss_bar,
          f"phase 37 rank {rank}: with the ranks' expert partials unsummed "
          f"the first loss is {lost_rel:.3e} of one process's, within the "
          f"bar {loss_bar:.0e}: the bar hides the fault")
    res["fault_loss"] = lost_rel
    res["rank_s"] = time.perf_counter() - t_rank
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return res


def moe_fault_rel(cfg, whole, mesh, batch, ref: dict):
    """The worst gradient block (:func:`tpt_worst_block`) of one step of
    ``cfg`` over ``mesh`` with ``moe._mark_partial`` a no-op: a fault of
    the adjoints the phase's bar must not hide."""
    from repro_torch import deploy
    from repro_torch.core import rebranch
    from repro_torch.launch import steps
    from repro_torch.models import moe
    model = deploy.compile_model(cfg, engine="pallas", mesh=mesh)
    t, f = rebranch.partition(model.shard_params(whole))
    mine = steps.local_batch(cfg, mesh, batch, TRAIN_BATCH)
    marked, moe._mark_partial = moe._mark_partial, lambda *a: None
    try:
        _, grads = tpt_step(cfg, model).grads(t, f, mine)
    finally:
        moe._mark_partial = marked
    return tpt_worst_block(cfg, whole, mesh, grads, ref)


class _UnsummedExperts:
    """``sharding`` as the moe block sees it with its ``expert`` partial
    outputs left unsummed: each rank keeps its own experts' part (its
    sequence chunk of it under seq_sp)."""

    def __init__(self, shd):
        self._shd = shd

    def __getattr__(self, name):
        return getattr(self._shd, name)

    @staticmethod
    def sum_parts(g, mesh, axis, kind):
        return g

    @staticmethod
    def sum_chunk(g, dim, layout, mesh, axis, kind):
        lo, hi = layout[mesh.coordinate(axis)]
        return g.narrow(dim, lo, hi - lo)


def moe_unsummed_loss(cfg, whole, mesh, batch) -> float:
    """The first loss of ``cfg``'s step over ``mesh`` (``expert`` layout)
    with the moe block's partial outputs unsummed: a fault of the forward
    the phase's loss bar must not hide."""
    from repro_torch import deploy
    from repro_torch.launch import steps
    from repro_torch.models import moe
    model = deploy.compile_model(cfg, engine="pallas", mesh=mesh)
    params = model.shard_params(whole)
    mine = steps.local_batch(cfg, mesh, batch, TRAIN_BATCH)
    shd, moe.shd = moe.shd, _UnsummedExperts(moe.shd)
    try:
        with torch.no_grad():
            loss = tpt_step(cfg, model).loss_fn(params, mine)
    finally:
        moe.shd = shd
    return float(loss)


def moe_train_dry_runs() -> dict:
    """Each mesh's train step per rank on ``meta`` over a fake world of
    it (``launch.dryrun``): {run key: record}."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    cfg, out = moe_train_config(), {}
    for shape in MOE_TRAIN_MESHES:
        with dryrun.dry_world(math.prod(shape)):
            mesh = mesh_lib.make_lm_mesh(*shape, backend=mesh_lib.FAKE)
            out[tpt_key(cfg, shape)] = dryrun.lower_cell(
                MOE_TP_ARCH, "train_4k", mesh, cfg=cfg,
                ranks=[{"data": d, "model": m} for d in range(shape[0])
                       for m in range(shape[1])],
                engine="pallas", seq=MOE_TRAIN_SEQ, gbatch=TRAIN_BATCH)
    return out


def phase_moe_train(dev, smi: str) -> dict:
    """37. The moe family trained over a mesh: Granite-MoE-3B at full
    width cut to MOE_TRAIN_LAYERS, f32, remat on, 'pallas', over 4 gloo
    ranks on the one card on (data 1, model 4) and (2, 2), whole experts a
    rank, TPT_STEPS steps each on TRAIN_BATCH x MOE_TRAIN_SEQ tokens (a
    routing group across the data ranks): kernel 4 at the attention's
    per-rank geometries at the train step's M in all three modes; every
    gradient block held to the one-process step on rank 0's whole batch,
    the loss and the leaves held whole bitwise equal on every rank, the
    loss falling, the ROM untouched; kernel-4 launches per rank per step
    as counted; each rank's bytes a step equal to the dry run's."""
    from repro_torch.launch import mesh as mesh_lib
    t_phase = time.perf_counter()
    cfg = moe_train_config()
    geoms = moe_train_geometries(cfg)
    check(set(geoms) == MOE_TRAIN_GEOMS, f"phase 37 geometries {set(geoms)}")
    phase_tp_kernels(dev, geoms, "37(a)")
    print(f"phase 37 on {smi}: {DIST_RANKS} gloo ranks on one card; "
          f"Granite-MoE-3B at full width cut to {MOE_TRAIN_LAYERS} layers "
          f"(remat on, f32, 40 experts top-8, groups of "
          f"{cfg.moe_group_size}), {TRAIN_BATCH} x {MOE_TRAIN_SEQ} tokens, "
          f"'pallas', meshes {MOE_TRAIN_MESHES}, {TPT_STEPS} steps each; the "
          f"ranks time-share the card, so the host times are no scaling "
          f"figure", flush=True)
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(mesh_lib.spawn, phase_moe_train_rank,
                              DIST_RANKS, backend="gloo",
                              deadline_s=TPT_DEADLINE_S)
        t_dry = time.perf_counter()
        dry = moe_train_dry_runs()      # meanwhile, on the host
        t_dry = time.perf_counter() - t_dry
        ranks = spawned.result()
    runs = {}
    for i, run in enumerate(ranks[0]["runs"]):
        rs = [r["runs"][i] for r in ranks]
        runs[run["key"]] = rs
        print(f"(37) {run['key']}: {run['rows']} rows a rank; layer 0's "
              f"moe block alone (dx and every gradient block) per rank "
              + ", ".join(f"{x['block_rel']:.3e}" for x in rs)
              + f" of the absmax from the one-process block's (bar "
              f"{GRAD_RTOL:.0e}); loss {run['loss0']:.6f} vs one process "
              f"{run['ref']['loss']:.6f} ({run['loss_rel']:.3e}; the "
              f"nudged witness's {run['ref']['witness_loss']:.3e}; bar "
              f"{run['bars'][1]:.0e}), bitwise on every "
              f"rank with every whole leaf's gradient and update; worst "
              f"gradient block per rank "
              + ", ".join(f"{x['grad_rel'][0]:.3e}" for x in rs)
              + f" of its leaf's absmax ({run['grad_rel'][1]}; the nudged "
              f"witness {run['ref']['witness'][0]:.3e}, "
              f"{run['ref']['witness'][1]}; bar {run['bars'][0]:.3e}); "
              f"grad_norm "
              f"{run['grad_norm']:.6f} vs {run['ref']['grad_norm']:.6f}; "
              f"losses {[round(v, 6) for v in run['loss']]}; kernel-4 "
              f"launches per rank a step {[x['launches'][0] for x in rs]} "
              f"(forward + recompute, none in the backward), "
              f"{len(run['geoms'])} geometries on rank 0 torch.equal to the "
              f"plain version; ROM tensors unmoved"
              + (", its fingerprint too" if run["fingerprint"] else ""),
              flush=True)
        print(f"  step host ms per rank: " + "; ".join(
            ", ".join(f"{t:.1f}" for t in x["step_ms"]) for x in rs)
              + f"; step 1 split (grads, update) per rank: " + "; ".join(
                  f"{x['split_ms']['grads']:.1f}, "
                  f"{x['split_ms']['update']:.1f}" for x in rs)
              + f" [{smi}]")
        print(f"  bytes sent per rank a step by kind: "
              + "; ".join(str(x["bytes"][0]) for x in rs)
              + f"; wire bytes {[x['wire'][0] for x in rs]}")
        k = run.get("kernel")
        if k is not None:
            print(f"  kernel 4, rank 0's {run['calls']} calls of a step's "
                  f"value_and_grad (M, K, N: {run['geoms']}), the others "
                  f"idle: {k['ms']:.3f} ms, plain {k['plain_ms']:.3f}, "
                  f"torch._int_mm {k['library_ms']:.3f}, bound "
                  f"{k['bound_ms']:.3f} ({k['bound_by']}) [{smi}]",
                  flush=True)
    print(f"(37) the step's bar separates a wrong adjoint: "
          f"{tpt_key(cfg, MOE_TRAIN_MESHES[0])} with the moe block's partial "
          f"leaves unmarked, worst gradient block per rank "
          + ", ".join(f"{r['fault'][0]:.3e}" for r in ranks)
          + f" ({ranks[0]['fault'][1]}), each over the bar "
          f"{ranks[0]['runs'][0]['bars'][0]:.3e}; the loss bar separates a "
          f"wrong forward: with the ranks' expert partials unsummed the "
          f"first loss per rank "
          + ", ".join(f"{r['fault_loss']:.3e}" for r in ranks)
          + f" of one process's, each over {MOE_LOSS_RTOL:.0e}", flush=True)
    tpt_dry_bytes(runs, dry, "37")
    r0 = ranks[0]
    print(f"phase 37 {time.perf_counter() - t_phase:.1f} s (dry runs "
          f"{t_dry:.1f} s beside the ranks; rank 0 {r0['rank_s']:.1f} s, "
          f"its one-process step {r0['one_s']:.1f} s; peak device memory "
          f"per rank {[round(r['peak_gib'], 2) for r in ranks]} GiB)")
    return {key: {"launches": [x["launches"] for x in rs],
                  "kernel": rs[0].get("kernel")}
            for key, rs in runs.items()}


# phase 33: the step cost counter on the card
COST_ROWS = 8                  # Gemma-2B's decode rows (phases 6-7)
COST_PEAK_RTOL = 0.10          # the meta record's peak against the card's
COST_DEADLINE_S = 240          # each dry-run subprocess
# phase 32's bytes a rank sends a decode step (PERF.md): full Gemma-2B, 18
# layers, 8 rows, max_len 256, on (data 1, model 4)
TP_STEP_BYTES = {"reduce": 16809984, "attention": 3566592, "gather": 552960,
                 "embed": 98304, "argmax": 384}
# PERF.md's ideal-mode Bound column, ms: kernel 1 per DarkNet-19/416
# forward at batch 8, kernels 3 and 4 per Gemma-2B decode pass at 8 rows
# (kernel 3 with x in its dtype: the bf16 x it reads at M <= 16)
COST_BOUNDS = {"trunk_conv": 0.267, "rebranch_matmul": 2.180,
               "cim_matmul": 0.600}


def kernel_bound_ms(entry: dict) -> float:
    """The least time of a record's kernel: per launch the larger of its
    int8 and f32 operations over their peaks and its bytes over the HBM
    rate, summed."""
    return sum(n * max(i8 / PEAK_INT8_OPS + f32 / PEAK_F32_OPS,
                       nbytes / PEAK_BYTES)
               for (i8, f32, nbytes), n in entry["work"].items()) * 1e3


def rom_macs(model) -> int:
    """The MACs a unit of work (an image, a token) of the model's ROM
    sites (``plan.site_tree``) costs."""
    from repro_torch import plan as plan_lib
    return sum(s.total_macs for s in plan_lib.site_tree(model.cfg)
               if model.layer_spec(s.name).enabled)


def cost_step(what: str, fn, args, kernel: str, launches: int, rows: int,
              model, smi: str) -> dict:
    """One step ``fn(*args)`` on the card under ``launch.cost.count()``
    and again on meta (``bridge.abstract`` of the same arguments): the
    launches, trunk FLOPs against the ROM sites' MACs, card == meta
    FLOPs and bytes op by op, the meta peak against the card's, the
    kernel's bound from the counted work; CUDA-event time printed."""
    from repro_torch import bridge
    from repro_torch.launch import cost, dryrun
    with torch.no_grad():
        fn(*args)                                   # warm-up
        torch.cuda.synchronize()
        ms = time_ms(lambda: fn(*args), 3)
        arg_bytes = sum(dryrun._storages(args).values())
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with cost.count() as card:
            fn(*args)
        torch.cuda.synchronize()
        got = read_launches()
        card_peak = torch.cuda.max_memory_allocated() - base + arg_bytes
        meta_args = bridge.abstract(lambda: args)
        t0 = time.perf_counter()
        meta, meta_rec = dryrun.measure(lambda: fn(*meta_args), meta_args)
        meta_s = time.perf_counter() - t0
    check(got == {k: launches if k == kernel else 0 for k in got},
          f"{what}: launches {got}, want {launches} of {kernel} only")
    k = card["kernels"][kernel]
    check(k["launches"] == launches, f"{what}: counted {k['launches']}")
    want = 2 * rows * rom_macs(model)
    check(k["trunk_flops"] == want,
          f"{what}: trunk FLOPs {k['trunk_flops']} != 2 x {rows} x the ROM "
          f"sites' MACs {want}")
    diff = {op: (e, meta_rec["by_op"].get(op))
            for op, e in card["by_op"].items()
            if meta_rec["by_op"].get(op) != e}
    diff.update({op: (None, e) for op, e in meta_rec["by_op"].items()
                 if op not in card["by_op"]})
    for op, (c, m) in diff.items():
        print(f"  {what}: {op} card {c} meta {m}")
    check(not diff and card["kernels"].keys() == meta_rec["kernels"].keys()
          and card["flops"] == meta["flops"]
          and card["hbm_bytes"] == meta["hbm_bytes"],
          f"{what}: card and meta counts differ ({len(diff)} ops)")
    rel = abs(meta["peak_bytes_per_dev"] - card_peak) / card_peak
    check(rel <= COST_PEAK_RTOL,
          f"{what}: meta peak {meta['peak_bytes_per_dev']} vs card "
          f"{card_peak} ({rel:.3f})")
    bound = kernel_bound_ms(k)
    check(round(bound, 3) == COST_BOUNDS[kernel],
          f"{what}: kernel bound {bound:.4f} ms != {COST_BOUNDS[kernel]}")
    print(f"(33) {what}: {k['launches']} {kernel} launches, trunk FLOPs "
          f"{k['trunk_flops']} = 2 x {rows} x {want // (2 * rows)} ROM MACs; "
          f"card == meta: FLOPs {card['flops']}, HBM bytes "
          f"{card['hbm_bytes']} ({len(card['by_op'])} ops); kernel "
          f"{k['flops']} FLOPs, {k['bytes']} bytes, bound {bound:.4f} ms; "
          f"peak meta {meta['peak_bytes_per_dev']} bytes (args "
          f"{meta['argument_bytes_per_dev']}, out "
          f"{meta['output_bytes_per_dev']}, temp "
          f"{meta['temp_bytes_per_dev']}) vs card {card_peak} "
          f"(max_memory_allocated {torch.cuda.max_memory_allocated()}, "
          f"{rel:.4f} apart); meta run {meta_s:.2f} s", flush=True)
    print(f"  {what}: step {ms:.3f} ms (CUDA events) -> "
          f"{card['flops'] / ms / 1e9:.3f} TFLOP/s, "
          f"{card['hbm_bytes'] / ms / 1e6:.1f} GB/s; kernel bound "
          f"{bound:.4f} ms [{smi}]", flush=True)
    return {"ms": ms, "flops": card["flops"], "hbm_bytes": card["hbm_bytes"],
            "kernel_flops": k["flops"], "kernel_bytes": k["bytes"],
            "bound_ms": bound, "peak_meta": meta["peak_bytes_per_dev"],
            "peak_card": card_peak}


def phase_cost(dev, smi: str, cnn_model, cnn_params, images, lm_model,
               lm_params) -> dict:
    """33. The step cost counter (``launch/cost.py``) and the dry run
    (``launch/dryrun.py``) on the card, on models phases 3 and 6 built."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serve import registry
    t_phase = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = {"fig12": ["--shape", "fig12", "--fast"],
            "deepseek_67b": ["--arch", "deepseek_67b", "--shape",
                             "decode_32k", "--single-pod", "--fast"]}
    procs = {}
    for name, argv in runs.items():
        out = os.path.join(ROOT, "build", f"dryrun_{name}.json")
        procs[name] = (out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
             "--out", out], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        x = torch.from_numpy(images).to(dev)
        out = {"darknet19": cost_step(
            f"DarkNet-19/{SIZE} forward, batch {x.shape[0]}",
            cnn_model.forward, (cnn_params, x), "trunk_conv", 20,
            x.shape[0], cnn_model, smi)}
        pallas, _ = registry.compile_entry("gemma-2b-pallas")
        for key, model, kernel in (
                ("gemma_2b", lm_model, "rebranch_matmul"),
                ("gemma_2b_pallas", pallas, "cim_matmul")):
            cache = model.init_cache(COST_ROWS, LM_MAX_LEN, device=dev)
            tok = torch.zeros((COST_ROWS, 1), dtype=torch.int32, device=dev)
            out[key] = cost_step(
                f"Gemma-2B {model.engine.name} decode step, {COST_ROWS} rows",
                model.decode_step, (lm_params, tok, cache), kernel,
                7 * model.cfg.num_layers, COST_ROWS, model, smi)
            del cache
        t0 = time.perf_counter()
        with dryrun.dry_world(4):
            mesh = mesh_lib.make_lm_mesh(1, 4, backend=mesh_lib.FAKE)
            rec = dryrun.lower_cell(
                "gemma_2b", "decode_32k", mesh, cfg=lm_config(),
                ranks=[{"model": m} for m in range(4)],
                engine="pallas_fused", seq=LM_MAX_LEN, gbatch=COST_ROWS)
        for r in rec["ranks"]:
            check(r["bytes_sent"] == TP_STEP_BYTES,
                  f"dry run rank {r['rank']}: bytes {r['bytes_sent']} != "
                  f"phase 32's {TP_STEP_BYTES}")
        print(f"(33) dry run, Gemma-2B (18 layers) decode step on a fake "
              f"(1, 4) world: every rank sends {TP_STEP_BYTES} bytes, "
              f"phase 32's; peak {rec['peak_bytes_per_dev']} bytes a rank, "
              f"{rec['flops']} FLOPs, {rec['hbm_bytes']} HBM bytes, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out["dry_tp"] = {k: rec[k] for k in ("peak_bytes_per_dev", "flops",
                                             "hbm_bytes", "bytes_sent")}
    finally:
        logs = {}
        for name, (path, proc) in procs.items():
            try:
                logs[name] = proc.communicate(timeout=max(
                    1.0, COST_DEADLINE_S - (time.perf_counter() - t_phase)))[0]
            except subprocess.TimeoutExpired:
                proc.kill()
                logs[name] = proc.communicate()[0] + "\n(timed out)"
    for name, (path, proc) in procs.items():
        lines = [ln for ln in logs[name].splitlines()
                 if ln.startswith(("[ok]", "[not", "[FAIL]")) or "records ok"
                 in ln]
        print(f"(33) python -m repro_torch.launch.dryrun {' '.join(runs[name])}"
              f": exit {proc.returncode}")
        for ln in lines:
            print(f"  {ln}")
        check(proc.returncode == 0, f"dry run {name} exited "
              f"{proc.returncode}:\n{logs[name][-3000:]}")
        with open(path) as f:
            for r in json.load(f):
                if r.get("kind") != "fig12":
                    print("  " + json.dumps({k: v for k, v in r.items()
                                             if k != "ranks"}))
    print(f"phase 33 {time.perf_counter() - t_phase:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import device as device_lib
    from repro_torch.models import cnn

    t_start = time.perf_counter()
    t_lap = [t_start]

    def lap(phases: str):
        # wall seconds per phase (or group), flushed as it ends, so a run
        # cut at the time limit still shows how far it got
        now = time.perf_counter()
        print(f"lap phase {phases}: {now - t_lap[0]:.1f} s (script "
              f"{now - t_start:.1f} s)", flush=True)
        t_lap[0] = now
    dev = device_lib.resolve()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    cfg = cnn.CNNConfig(name="darknet19", input_size=SIZE)

    phase_build()
    lap("build")
    tot = phase_kernels(dev, cfg)
    lap("2")
    model, params, images, launches = phase_serve(cfg)
    lap("3")
    phase_cpu(model, params, images[:1])
    lap("4")
    torch.cuda.empty_cache()

    lm = phase_lm_kernels(dev)
    lap("5")
    lm_model, lm_params, lm_srv, lm_launches = phase_lm_serve()
    lap("6")
    pallas_launches = phase_lm_pallas(lm_params)
    lap("7")
    phase_lm_cpu(lm_model, lm_params, lm_srv)
    lap("8")
    phase_cost(dev, smi, model, params, images, lm_model, lm_params)
    lap("33")
    del lm_model, lm_params, lm_srv
    torch.cuda.empty_cache()

    adc = phase_adc_kernels(dev, cfg)
    lap("9")
    adc_launches = phase_adc_serve(cfg, model, params, images)
    lap("10")
    adc_launches.update(phase_lm_adc())
    lap("11")
    torch.cuda.empty_cache()

    phase_tapeout(cfg, dev, smi)
    lap("12")
    swap_launches = {"trunk_conv": phase_cnn_swap(model, params, images, smi),
                     "rebranch_matmul": phase_lm_swap(smi)}
    lap("13-14")
    del model, params, images
    torch.cuda.empty_cache()

    train = phase_train_kernels(dev, smi)
    lap("15")
    train_launches = {
        "cim_matmul": phase_lm_train(smi, train["cim_matmul"]["ms"]),
        "trunk_conv": phase_cnn_train(dev, smi)}
    lap("16-17")
    torch.cuda.empty_cache()

    serve_launches = {"chunk_launches": phase_chunked_prefill(smi),
                      "spec_launches": phase_spec_decode(smi)}
    lap("18-19")
    torch.cuda.empty_cache()

    phase_family_kernels(dev)
    lap("20")
    hymba = phase_hymba(smi)
    lap("21")
    granite, falcon = phase_granite(smi), phase_falcon(smi)
    lap("22-23")
    family_launches = {
        "rebranch_matmul": {"hymba-1.5b": hymba["launches"],
                            "granite-moe-3b": granite["launches"],
                            "falcon-mamba-7b": falcon["launches"]},
        "cim_matmul": {"hymba-1.5b-pallas": hymba["pallas_launches"]}}
    family_step = {
        "rebranch_matmul": {"hymba-1.5b": hymba["split"]["kernel"],
                            "granite-moe-3b": granite["split"]["kernel"],
                            "falcon-mamba-7b": falcon["split"]["kernel"]},
        "cim_matmul": {"hymba-1.5b-pallas": hymba["pallas_kernel"]}}
    torch.cuda.empty_cache()

    phase_family_kernels(dev, 24, (VLM_ARCH, AUDIO_ARCH), VLM_AUDIO_ROWS,
                         skip=set(LM_GEOMS))
    lap("24")
    qwen = phase_qwen(smi)
    lap("25")
    musicgen = phase_musicgen(smi)
    lap("26")
    family_train = phase_family_train(dev, smi)
    lap("27")
    family_launches["rebranch_matmul"].update({
        "qwen2-vl-2b": qwen["launches"],
        "qwen2-vl-2b-spec": qwen["spec_launches"],
        "musicgen-large": musicgen["launches"]})
    family_launches["cim_matmul"]["qwen2-vl-2b-pallas"] = \
        qwen["pallas_launches"]
    family_step["rebranch_matmul"].update({
        "qwen2-vl-2b": qwen["split"]["kernel"],
        "musicgen-large": musicgen["kernel"]})
    family_step["cim_matmul"]["qwen2-vl-2b-pallas"] = qwen["pallas_kernel"]
    family_train_launches = {
        arch: {"launches": e["launches"], "per_step": e["per_step"]}
        for arch, e in family_train.items()}
    torch.cuda.empty_cache()

    phase_tune(dev, smi)
    lap("28")
    phase_tuned_serve(smi)
    lap("29")
    sharded = phase_sharded(smi)
    lap("30")
    dist_train = phase_dist_train(smi)
    lap("31")
    tp_serve, tp_held = phase_tp(dev, smi)
    lap("32")
    tp_serve.update(phase_tp_uneven(dev, smi, tp_held))
    del tp_held
    lap("34")
    tp_train = phase_tp_train(smi)
    lap("35")
    tp_serve.update(phase_moe_tp(dev, smi))
    lap("36")
    tp_train.update(phase_moe_train(dev, smi))
    lap("37")
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s")

    def row(name, source, replaces, launches, t):
        by = "bytes" if t["bytes_ms"] >= t["bound_ms"] / 2 else "operations"
        out = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{source}",
               "replaces": replaces, "launches": launches,
               "max_abs_err": t["max_abs_err"], "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": by, "library_ms": t.get("library_ms")}
        if "bound_p_ms" in t:
            # the trunk conv's bound had it read the patch matrix P (as the
            # patch-matrix kernel did); bound_ms is the NHWC input's
            out["bound_p_ms"] = t["bound_p_ms"]
        if "device_ms" in t:
            # the same launches' device time, from a replayed CUDA graph
            out["device_ms"] = t["device_ms"]
        if "ms_m128" in t:
            # library_ms is torch._int_mm per 126-launch pass at M = 128;
            # ms_m128 the kernel over the same pass, both timed as ms is
            out["ms_m128"] = t["ms_m128"]
        if name in swap_launches:
            # launches over the scenario hot-swap phases (13: four served
            # chunks; 14: the mid-stream swap's prefills and decode steps)
            out["swap_launches"] = swap_launches[name]
        if name in train_launches:
            # phases 15-17: launches over the training loops (16: Gemma-2B
            # cut to 3 layers, 30 steps; 17: ResNet-18, 50 steps), and per
            # pass at the train geometry (kernel 4: M = 512, 126 launches;
            # kernel 1: ResNet-18 at 32x32, batch 128, 20 launches), timed
            # as ms is
            out["train_launches"] = train_launches[name]
            for key, v in train[name].items():
                if key.endswith("ms"):
                    out[f"train_{key}"] = v
        if name == "rebranch_matmul":
            # phases 18-19: launches over the chunked-prefill run and the
            # speculative runs (checked: 126 per chunk and per verify
            # round, none in a draft step); per verify round at M = 32 (8
            # rows x k = 4, phase 5), timed as ms and device_ms are
            out.update(serve_launches)
            for key in ("verify_ms", "verify_device_ms", "verify_plain_ms",
                        "verify_bound_ms"):
                out[key] = t[key]
        if name in family_launches:
            # phases 21-23: launches over each new family's served run
            # (checked: one per ROM linear per prefill and decode step),
            # and per served model one decode step's calls of the kernel
            # run again in the served order
            out["family_launches"] = family_launches[name]
            out["family_step"] = family_step[name]
        if name == "trunk_conv":
            # phase 30: kernel-1 launches per rank on each mesh over the
            # sharded forward and two CNNServer requests (checked: 20 a
            # forward, none gathered)
            out["sharded_launches"] = sharded["launches"]
            # rank 0's slab launches of one sharded forward per mesh:
            # ms, plain_ms, bound_ms (and the unsharded 20 launches'
            # unsharded_ms), timed as ms is
            out["sharded"] = sharded["kernel"]
        if name in dist_train:
            # phase 31: launches per rank over the multi-rank training
            # (kernel 1: DarkNet-19's 3 sharded steps; kernel 4:
            # Gemma-2B's f32 plain and int8 steps and its bf16 step), and
            # over one step's launches on rank 0, the other ranks idle
            # (kernel 1: the training slabs of a forward; kernel 4: 21
            # calls at M = 128, with torch._int_mm's library_ms), timed as
            # ms is
            out["dist_train_launches"] = dist_train[name]["launches"]
            out["dist_train"] = dist_train[name]["kernel"]
        if name in ("rebranch_matmul", "cim_matmul"):
            # phases 32, 34 and 36: per tensor-parallel run (model, engine,
            # mesh), each rank's launches and bytes sent per decode step,
            # and rank 0's calls of one
            # decode step timed with the other ranks idle (``ms``,
            # ``device_ms``, ``plain_ms``, ``bound_ms``; kernel 4 also
            # ``library_ms``, torch._int_mm with W column-major)
            out["tp_serve"] = {
                k: v for k, v in tp_serve.items()
                if ("-pallas-" in k) == (name == "cim_matmul")}
        if name == "cim_matmul":
            # phases 35 and 37: per tensor-parallel training run (model,
            # dtype, mesh), each rank's launches per step (forward and remat
            # recompute) and rank 0's calls of one step's value_and_grad
            # timed with the other ranks idle (ms, plain_ms, library_ms:
            # torch._int_mm with W column-major, bound_ms)
            out["tp_train"] = tp_train
            # phase 27: launches over each new family's 10 train steps at
            # the 2-layer cut, and per step (checked: the block linears
            # plus the head per loss chunk, forward and recompute)
            out["family_train_launches"] = family_train_launches
        if name.startswith("rebranch_matmul"):
            out["library_ms_note"] = (
                "null: no PyTorch call quantises per (row, k-block)")
        return out

    kernels = [
        row("trunk_conv", "trunk_conv.cu",
            "src/repro/kernels/rebranch_conv.py:105", launches, tot),
        row("rebranch_matmul", "rebranch_matmul.cu",
            "src/repro/kernels/rebranch_matmul.py:40", lm_launches,
            lm["rebranch_matmul"]),
        row("cim_matmul", "cim_matmul.cu",
            "src/repro/kernels/cim_matmul.py:101", pallas_launches,
            lm["cim_matmul"]),
    ]
    for name, source, replaces in (
            ("trunk_conv", "trunk_conv.cu",
             "src/repro/kernels/rebranch_conv.py:105"),
            ("rebranch_matmul", "rebranch_matmul.cu",
             "src/repro/kernels/rebranch_matmul.py:40"),
            ("cim_matmul", "cim_matmul.cu",
             "src/repro/kernels/cim_matmul.py:101")):
        for mode in ADC_MODES:
            kernels.append(row(f"{name}[{mode}]", source, replaces,
                               adc_launches[name, mode], adc[name, mode]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
