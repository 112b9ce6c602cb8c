#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py [--phases device,autotune,pack_kernel,kernel,serve,paged_serve,
                                    mla_serve,phi3_serve,minitron_serve,mixtral_serve,
                                    vlm_serve,rwkv_serve,hybrid_serve,encdec_serve,
                                    serve_lut,tl1_kernel,tl1_serve,moe_kernel,moe_serve,
                                    bmm_kernel,bmm_serve,paper,onehot,train,audit,dist]
                          [--iters 20]

Phases, one JSON object per line:

1. ``device``  the card, torch/CUDA versions, and the build of every
   kernel from ``src/repro_torch/csrc`` with nvcc for sm_90a (one nvcc per
   source, all started together).
1a. ``autotune``  the autotuner (``kernels/lut_affine/autotune.py``,
   :func:`autotune_phase`) at the decode batch (SLOTS rows): the main
   path's seven weight plans (granite_8b, the serve cell's recipe) and the
   TL1 cell's seven, qwen2_moe_a2_7b's expert projections (the ragged
   kernel at the routed rows), minicpm3_4b's ``wq_a`` and ``wkv_a`` and the
   heads of phi3_medium_14b and minitron_4b.  Per point: the shape rule's
   tiling and its device ms, every candidate tiling's (so the measured
   winner), the analytic winner's, the number of candidates and the bound,
   each timed by the package's measured mode
   (``autotune.measure_candidates``); the rule, both winners and the
   extreme tilings (``block_k`` 1 and k) held to the plain version
   (KERNEL_TOL x max|plain|, TL1 bit for bit).  The ragged expert kernel
   keeps its shape rule under any tiles: its point reports the rule's time
   and holds every tiling's output to the rule's, bit for bit.  A
   main-path point whose analytic winner takes more than AUTOTUNE_SLACK x
   the shape rule's time fails the phase.
1b. ``pack_kernel``  the packing kernel (``bitplane_pack``) against its
   plain version, bit for bit, in each of its three kinds: ``shift`` at
   the inputs of the weight cell (granite_8b) and the MoE cell
   (qwen2_moe_a2_7b), ``fixed`` 8/6 at the binary cell's, ``float16`` (off
   every served path) at granite_8b's widths; decode and prefill rows, fp32
   (the paths' dtype) and bf16 input.  Each with the kernel's time, the
   plain version's and the bound, beside the launch floor (a one-row,
   4-element pack of the same kind) and the ratio to it; per layer, the
   sum over the cell's packs.  Then a grid of every kind and radix, both
   dtypes, ragged ``q``, a base one element off, leading dims, rows past
   the grid's y limit and fp16 rounding's edge values.
2. ``kernel``  each weight-family kernel (``lut_affine``) against its
   plain PyTorch version on the card, at the main path's full-width
   granite_8b shapes (decode B = 4 and prefill B = 4 slots x 32 tokens) and
   on a grid of table types, shift_bits and ragged edges; with the
   kernel's time, the plain version's, the least time the card could take
   (``bound_ms``) and, for context, the dense bf16 matmul the tables
   replace; repeated split launches checked bit-identical, and ptxas's
   report of the dense kernels.
3. ``serve``   full-width granite_8b, depth cut to 4 layers, planned
   with the serving recipe (its last step ``attach_tuned_blocks`` at the
   slots: the decode dispatches run the tuned k splits; ``tiles`` line: the
   graph's and the eager step's median decode step and the eager admission
   prefill's, tuned against the same tables on the shape rule, in turns,
   and the host microseconds the tiles add to a wrapper call), converted
   to i8 tables and served through ``BatchingEngine`` on the kernels
   (every projection's input packed by ``bitplane_pack``:
   ``plain_pack_codes_calls`` must be 0); then the same
   requests on the plain versions, whose ``pack_codes`` calls must equal
   the kernel run's packs, the prefill logits of both compared and every
   request's first token held equal.  The decode profiles count device
   kernels per step, with the graph, eager, and eager with the pack sites
   on the eager ``pack_codes`` (the packing before the kernel took it).
3b. ``paged_serve``  the same model (the serve phase's tables, or built
   anew) served through ``BatchingEngine(page_size=8)``: a paged KV cache
   with copy-on-write prefix sharing (first a ``tiles`` line on the paged
   graph, as ``serve``'s).  8 requests of 16 new tokens; 0, 2,
   4 and 6 open with one shared 16-token system prompt.  In one call: (a)
   the dense engine with the decode step as a CUDA graph, (b) the paged
   engine with the graph on the dense rectangle's 32 pages, (c) paged
   eager, (d) paged with the graph on 21 pages (the smallest pool that
   serves this traffic: 16 and 20 pages must raise CacheOverflowError
   mid-decode, since admission maps only a prompt's pages), (b) and (a)
   again, (e) paged on the plain versions, eager, PLAIN_NEW tokens a
   request, (f) the dense engine
   with the graph, its attention's K/V rounded to bf16.  Every kernel run
   launches 12 / 8 / 20 per forward and packs nothing off the kernel; (b),
   (c), (d) serve identical streams; first tokens are identical in (b)
   and (e); the first admission's prefill logits of (b) are within
   LOGITS_TOL / LOGITS_FRO_TOL of (a)'s (their first tokens are reported:
   a paged prefill attends over bf16 cached K/V, a dense one over fp32
   in-flight K/V); (f) serves (b)'s streams whole, and
   ``prefill_attribution``'s dense prefill on bf16-rounded K/V is within
   BF16_KV_TOL of the paged one; ``prefill_tokens`` is what
   sharing predicts; the live slots map no more than ceil(len / 8) pages
   each, the peak below the rectangle; no page is in use after
   ``release_prefixes()``.  One paged decode-shaped forward and a
   copy-on-write run under ``torch.cuda.set_sync_debug_mode("error")``.
   Reported: median decode step and tok/s per path, KV bytes, peak pages,
   and the decode profiles paged against dense with the kernels paging
   adds, by name.
3c. ``mla_serve``  full-width minicpm3_4b (MLA attention: a latent KV
   cache of ``c_kv`` and a shared ``k_rope``), depth cut from 62 to 16
   layers, planned by the serving recipe with chunks capped at 1 and
   ``wk_b``/``wv_b`` vetoed (the absorbed form reads them as raw weights),
   converted to i8 tables and served through ``BatchingEngine`` on the
   kernels, graph and eager in turns (``serve_paths``): launches 5L + 1 /
   L / 6L + 1 per forward, no pack off the kernel, no table copy; then on
   the plain versions (first tokens identical, prefill logits at 1 / 4 / 16
   layers within LOGITS_TOL / LOGITS_FRO_TOL); then paged at PAGE_SIZE on
   ``paged_requests``' traffic: (a) dense graph, (b) paged graph, (c) paged
   eager, (f) dense graph with its latents rounded to bf16; (b) and (c)
   serve identical streams, (f) serves (b)'s whole, ``prefill_tokens`` is
   what sharing predicts.  Last, each of the seven LUT calls (a layer's six
   and lm_head) at the decode shape, kernel against plain, its device ms
   beside its bound.
3d. ``phi3_serve`` and ``minitron_serve``  full-width phi3_medium_14b
   (GQA, 40 heads to 10 KV heads, SwiGLU) and minitron_4b (nemotron's
   two-matrix squared-ReLU MLP, a 256,000-token vocabulary) at the deepest
   cut whose recipe tables, layers and the untied lm_head, fit
   FAMILY_TABLE_BYTES (``family_depth``, from the plan on shapes, printed
   with its reason: 3 of 40 and 10 of 32 layers), planned by the serving
   recipe with chunks capped at 1 (the uncapped plan beside it), converted
   and served as ``mla_serve`` serves: launches per forward as the tree
   plans them (phi3 3L + 1 / 2L / 5L + 1, minitron 4L + 1 / L / 5L + 1), no
   pack off the kernel, no table copy, graph and eager streams identical;
   first tokens kernel against plain with the plain path given the kernel
   path's codes at every pack site (``synced_first_tokens``: the logits
   trap, where an activation at an fp16 rounding boundary rounds the other
   way, can flip a near-tie among 256,000 logits; the unsynchronized first
   tokens are reported beside), prefill logits at the cut within
   LOGITS_TOL / LOGITS_FRO_TOL; then every LUT call of a layer and lm_head
   at the decode shape beside its bound and the bf16 ``x @ W`` it replaces.
3e. ``mixtral_serve``  full-width mixtral_8x7b (GQA 32 to 8 heads, a
   4096-token sliding window kept as a ring KV cache, 8 routed experts
   top-2 of width 14,336 and no shared experts, vocab 32,000) at the cut
   ``family_depth`` computes with its experts converted (1 of 32 layers;
   ``moe_depth``'s conversion peak beside it), planned by the recipe with
   ``convert_experts=True`` and chunks capped at 1, served as ``phi3_serve``
   serves (launches 2L + 1 / L / 2L experts / 5L + 1 per forward, first
   tokens synchronized, prefill logits at the cut); the same requests paged
   at PAGE_SIZE, every page of a slot mapped at admission and no prefix
   shared: (a) dense graph, (b) paged graph, (c) paged eager, streams
   identical whole (the ring holds min(4096, MAX_LEN) = MAX_LEN slots here
   and never wraps); a decode-shaped forward past the wrap, dense and
   paged, under ``set_sync_debug_mode("error")``; each LUT call of a layer
   at the decode shape, the experts routed by the layer's router.  Then the
   ring at the published window, on the kernels only: two slots of 4096
   (512 pages of 8 each when paged), requests of 4,072 and 4,088 prompt
   tokens and 40 new tokens each, which write past slot 4095 mid-decode:
   dense and paged, graph and eager, all four streams identical whole, each
   slot's pos and valid what the ring must hold, 512 pages mapped a live
   slot and none after; a 4,072-token prefill then 40 fed decode steps
   against the windowed full forward of the 4,112-token sequence (norm
   error within LOGITS_FRO_TOL at every position; reported beside it on
   bf16-rounded K/V and, not gated, with no window mask); and
   ``generate()`` on a 4,200-token prompt (its ring exact, its first token
   the no-cache forward's).  The peak memory is reckoned before the run.
3f. ``vlm_serve``  full-width llava_next_mistral_7b (Mistral-7B's dense GQA
   decoder, 32 heads to 8 KV heads, vocab 32,000, untied; its prompt opens
   with 576 precomputed image patch embeddings: the vision tower is a stub,
   as in the reference) at the cut ``family_depth`` computes (6 of 32
   layers), planned, converted and served text-only through
   ``BatchingEngine`` as ``phi3_serve`` serves it (a ``Request`` carries no
   image, in either package), graph and eager, with no plain run.  Then the
   image prefix through ``generate(embeds=...)``: 4 rows of 576 seeded
   embeddings (at the scale of the seeded embedding rows) and a 32-token
   prompt, 16 new tokens each (a 624-slot cache): dense on the kernels,
   counted (launches 3L + 1 / 2L / 5L + 1 per forward for 16 forwards, no
   pack off the kernel, no table copy); its prefill and decode steps timed
   apart; the prefill logits of the first VLM_PLAIN_ROWS (1) row's 608
   positions kernel against plain at VLM_PLAIN_DEPTH layers within
   LOGITS_TOL / LOGITS_FRO_TOL; at the cut, the same prompts without the
   image give text logits further apart than LOGITS_FRO_TOL; the first
   tokens of all 4 rows (2,432 prefill rows) kernel against plain on the
   first VLM_SYNC_DEPTH (1) layer of the cut, with the plain path on the kernel
   path's codes at every pack site (every prefill site's input within
   SYNCED_TOL; the decode steps', whose K/V each path rounds to bf16 on its
   own, reported), and every prefill pack of those layers bit for bit with
   its plain version (layer 0's five packs timed); paged at PAGE_SIZE (78
   pages a row), whose
   streams a dense run on bf16-rounded K/V serves whole.  Last, each LUT call
   of a layer and lm_head at the decode shape (held to plain) and at the
   prefill's 2,432 rows (timed), beside its bound.
3g. ``rwkv_serve``  full-width rwkv6_3b (RWKV-6 "Finch": attention-free, 40
   heads of 64, a data-dependent decay through a rank-64 LoRA, d_ff 8,960,
   vocab 65,536, untied) at the cut ``family_depth`` computes (16 of 32
   layers), planned and converted, its zeroed ``mu_*``, ``u`` and
   ``decay_base`` then drawn from a seed (a ``seeded_leaves`` line), served
   through ``generate()`` alone (``BatchingEngine`` refuses a recurrent
   state, as the reference's does): a ``page_size`` and the engine raise
   before any launch; 4 rows of 512 seeded prompt tokens and 32 new tokens
   each, counted (launches 8L + 1 / 0 / 8L + 1 a forward, no pack off the
   kernel, no table copy); the call's prefill and eager decode steps timed
   apart, the decode step after 64 and after 512 prompt tokens (the O(1)
   check, reported) and a 127-token prefill (the scan at chunk 1); prefill
   logits of all 4 x 512 positions kernel against plain at 1 layer within
   LOGITS_TOL / LOGITS_FRO_TOL, and a layer's eight packs at those rows bit
   for bit and timed; first tokens of 4 x 64-token prompts at the cut
   kernel against plain with the plain path on the kernel path's codes
   (every prefill site's input within SYNCED_TOL, every prefill pack bit
   for bit; the decode sites', which read the fp32 state each path carried
   on its own, reported); the state across calls (a 64-token
   prefill and 8 fed decode steps against one chunked forward over the 72
   tokens, within RWKV_STATE_TOL on the bf16 cache, reported on fp32); a
   profile of the eager decode step (LUT kernels, packs, PyTorch's own);
   each LUT call of a layer and lm_head at the decode shape (held to
   plain) and at 2,048 rows (timed), beside its bound.
3h. ``hybrid_serve``  full-width zamba2_1_2b (Mamba-2 SSD layers, d_inner
   4,096, 64 heads of 64, state 64, conv 4; one shared attention + MLP
   block, 32 heads of 64 with as many KV heads, invoked after every 6
   layers with its own K/V cache per invocation; vocab 32,000, untied) at
   the cut ``family_depth`` computes, all 38 layers (33,688 MiB of i8
   tables; a layer's bytes from the plans of one and two layers, since the
   shared block is held once), planned and converted (the shared block's
   ``wq+wk+wv`` a G = 3 group, ``w_gate+w_up`` a G = 2 one), its zeroed
   ``A_log`` and ``dt_bias`` drawn from a seed as Mamba-2 initialises them
   (a ``seeded_leaves`` line), served through ``generate()`` alone: a
   ``page_size``, the engine and a ``token_mask`` raise before any launch;
   4 rows of 512 seeded prompt tokens and 32 new tokens each, counted
   (launches 2L + 2S + 1 / 2S / 2L + 4S + 1 a forward for S = 6 shared
   invocations, no pack off the kernel, no table copy); the call's prefill
   and eager decode steps timed apart, the decode step after 64 and after
   512 prompt tokens in turns (reported: the shared block's K/V grow) and
   a 127-token prefill (the SSD scan at chunk 1); prefill logits of 4 x
   128 positions kernel against plain at 7 layers (six mamba layers and one
   shared invocation) within LOGITS_TOL / LOGITS_FRO_TOL, every pack of
   that run bit for bit; first tokens of 4 x 64-token prompts at the cut
   kernel against plain with the plain path on the kernel path's codes
   (every prefill site within SYNCED_TOL and every prefill pack bit for
   bit; the decode sites', which attend over bf16 K/V each path rounded on
   its own, reported); the state across calls (a 64-token prefill and 8
   fed decode steps against one chunked forward, within HYBRID_STATE_TOL on
   the default cache, reported on fp32); a profile of the eager decode
   step; each LUT call of a mamba layer, of the shared block and of
   lm_head at the decode shape (held to plain) and at 2,048 rows (timed),
   beside its bound, and the G = 3 group with i8 shift tables held to
   plain at both.
3i. ``encdec_serve``  full-width whisper_base (a bidirectional encoder over
   precomputed frame embeddings, the audio frontend a stub as in the
   reference; a decoder of causal self-attention, cross-attention over the
   encoder's output and a biased GELU MLP, each after a LayerNorm; d_model
   512, 8 heads of 64, d_ff 2,048, vocab 51,865, the head tied to the
   embedding and a plain product) at all 6 + 6 layers, planned and
   converted (three G = 3 ``wq+wk+wv`` groups with stacked biases),
   served through ``generate(enc_embeds=...)`` alone: ``BatchingEngine``
   and a ``token_mask`` raise before any launch; 4 rows of 1,500 seeded
   frames (whisper's 30-second window) and a 4-token prompt, 60 new tokens
   each into a 64-slot decoder cache, counted (a prefill 3Le + 7L / Le + L /
   4Le + 7L, a decode step 5L / L / 6L: the cross-attention's ``wq`` and,
   at the prefill, ``wk``/``wv`` run alone on their group's leaf; no pack
   off the kernel, no table copy); its prefill, the encoder and the cross
   K/V and the decode steps timed apart; after the prefill the cross K/V
   float32 at (6, 4, 1500, 8, 64) and the self K/V bf16 at 64 slots;
   prefill logits kernel against plain at 1 + 1 layers within LOGITS_TOL /
   LOGITS_FRO_TOL and at 6 + 6 on the kernel path's codes within
   SYNCED_TOL, every pack bit for bit and the first tokens identical; paged
   at PAGE_SIZE (only the self K/V), whose streams a dense run
   on bf16-rounded self K/V serves whole; a profile of the eager decode
   step; each LUT call of an encoder layer at 6,000 rows and of a decoder
   layer at 4 rows beside its bound, the cross ``wk``/``wv`` at 6,000 rows
   alone on the leaf (no table copy), the encoder's G = 3 group held to
   plain at 6,000 rows.
3j. ``serve_lut``  the serving example's twin
   (``repro_torch.examples.serve_lut``, :func:`serve_lut_phase`) at its
   defaults on the kernels (reduced granite_8b, its own plan at half the
   uniform chunk-2 bytes, grouped launches, 6 requests on 2 slots), greedy
   and top-k 20 at temperature 0.8, each batched and ``--admit per-slot``:
   the streams identical across admissions in both modes, the LUT kernels
   launched; tok/s, readbacks and the packs off the kernel reported.
4. ``tl1_kernel``  each TL1 kernel (``lut_tl1``) against its plain
   version at the same full-width shapes and on a grid of int8/int4/exact
   fp32, ragged ``q`` and ``p``, leading dims and bias: int cases bit for
   bit, fp32 cases within 1e-5 x max|plain|; with ``torch._int_mm`` (a
   cuBLAS int8 GEMM over the unpacked ternary weights) as the library
   yardstick and an independent check of the integer accumulate.
5. ``tl1_serve``  full-width granite_8b at all 36 layers, planned into
   TL1 as the reference's ``serving_tl1_plan`` plans it (int8
   activations, tiles tuned at the slots), converted, its fp32 weights
   freed, served through
   ``BatchingEngine`` on the kernels and then on the plain versions
   (PLAIN_NEW tokens a request): every stream identical on the tokens the
   plain run serves, prefill logits within 1e-5 x max|plain|; the tuned
   streams equal the untuned ones whole (``tiles``: integer sums).
6. ``moe_kernel``  the ragged MoE kernel (``lut_affine_experts``) against
   its plain version at full-width qwen2_moe_a2_7b expert shapes (60
   experts, top-4, expert width 1408; decode 4 tokens = 16 expert rows and
   prefill 128 tokens = 512 rows, routed by a seeded router; each line
   with the k ``splits`` the wrapper chose, the decode split launch
   repeated and checked bit-identical) and on a grid of table types,
   shift_bits, empty experts, ragged T and p, G 1/2/3 and a zero tail;
   then one decode-shaped ``moe_ffn`` on the kernels under
   ``torch.cuda.set_sync_debug_mode("error")``: no read-back may happen;
   last ptxas's report of the ragged kernel.
7. ``moe_serve``  full-width qwen2_moe_a2_7b, depth set by the card's
   memory (2 of 24 layers), planned by the serving recipe with
   ``convert_experts=True``, converted to i8 tables and served through
   ``BatchingEngine`` on the kernels, then on the plain versions: every
   first token identical, packs and prefill logits held as in ``serve``.
8. ``bmm_kernel``  the binary-matmul mode's two kernels against their
   plain versions at full-width granite_8b shapes (decode 4 rows x 8
   planes = 32 folded rows, prefill 128 rows = 1024 folded rows; W in bf16
   as the path holds it, an fp32 W's time beside it): ``bitplane_pack`` bit
   for bit, ``binary_matmul``
   within 1e-5 x max|plain|, with a cuBLAS bf16 GEMM of the folded planes
   (``torch.matmul``) as the library yardstick and the dense bf16 ``x @ W``
   the mode replaces for context; then a grid of plane counts, ragged
   ``q``/``p``, leading dims, bias, bf16 ``W`` and every packing mode.
9. ``bmm_serve``  full-width granite_8b at all 36 layers, its projection
   weights rounded once to bf16 (``models/params.py::bf16_projections``;
   prefill logits identical to the fp32 tree's on both paths, checked),
   served through ``BatchingEngine`` under
   ``ExecCfg(linear_mode="binary_matmul")``
   on the kernels (7 packs and 7 binary matmuls per layer and forward, no
   LUT kernel), then on the plain versions: every first token identical,
   prefill logits compared at several depths and held to BMM_LOGITS_TOL.
10. ``paper``  the paper's own networks at their published widths (the
   linear classifier, the 784-1024-512-10 MLP, LeNet by im2col), each
   trained on the card with the reference's recipe
   (``repro_torch.examples.tablenet_mnist.train``: 300 SGD steps of 128
   images at lr 0.3; LeNet, unstable there, also at lr 0.1, which is the
   one converted), its dense accuracy over 1500 held-out images and at input bits
   1..8; converted to unsigned fp16 bitplane tables (chunk 1 for all
   three, chunk 2 for the classifier and the MLP) and run over the same
   images on the kernels (one ``bitplane_pack`` and one ``lut_affine``
   launch per converted layer and forward, ``plain_pack_codes_calls`` 0)
   and on the plain versions: every layer within 1e-5 x max|plain| of its
   plain version on the same input, at least 499 of 500 argmaxes equal per
   batch, accuracies beside the dense model's on fp16-rounded inputs,
   table bytes, peak memory, the table copies of the 10-column heads (and
   the head's time with and without a pre-padded operand), and device ms
   and images/s at B = 500 of the kernel path, the plain path and the
   dense fp32 forward.  Then the classifier at the Fig. 5 fixed 3/3 plan,
   chunks 1 / 2 / 7 / 14, whose accuracy on 3-bit inputs must equal the
   dense model's on the same inputs within one image; then the TL1 rows of
   ``repro_torch.benchmarks.accuracy_vs_bits`` on ``lut_tl1``, against the
   plain version.  Each fp16 conversion also runs under
   ``linear_mode="onehot_mxu"`` (the plain path: a one-hot of each code
   against the tables rounded to bf16, summed in fp32; a ``step: onehot``
   line): its held-out accuracy within ONEHOT_ACC_POINTS of the kernel
   path's, every converted layer within the tables' bf16 rounding
   (:func:`onehot_bound`) of the kernel on the same input, its device ms.
10a. ``onehot``  ``linear_mode="onehot_mxu"`` on one full-width granite_8b
   decoder layer under fixed-point 8/6 chunk-2 plans, fp32 and i8 tables
   (:func:`onehot_phase`): each LUT call (``wk+wv`` and ``w_gate+w_up``
   G = 2 groups, which the mode does not fuse) at 4 and 128 rows against
   the ``lut_affine`` / ``lut_affine_grouped`` kernel on the same codes,
   within the bf16 rounding bound (i8: within KERNEL_TOL), with both
   applies' device ms.
11. ``train``  the training path (:func:`train_phase`): the ``100m`` preset
   of ``examples/train_100m.py`` at full width and all 12 layers, 40 steps
   of 8 x 256 ``lm_stream`` tokens with remat ``"dots"``, bf16 compute and
   a checkpoint every 20, straight through and again restarted from the
   step-20 checkpoint in a fresh ``Trainer``: losses and final parameters
   equal bit for bit, every loss finite, the last 5 below the first 5; step
   ms, tokens/s, model FLOPs and their share of the bf16 peak, peak memory,
   checkpoint bytes and save / restore seconds; 4 steps each under remat
   ``none`` / ``full`` / ``dots`` and with the deterministic algorithms
   off.  ``granite_8b`` at full width, 2 of 36 layers, 4 steps.  Then a
   ``family_train`` line for rwkv6_3b (16 of 32 layers), zamba2_1_2b (all 38)
   and whisper_base (6 + 6, 1,500 frames a row) at full width, remat
   ``"dots"``, bf16 (:func:`family_train`): a ``Trainer``'s 4 steps, its step 1
   bit for bit remat ``none``'s, finite, at least 90 % of the gradient leaves
   non-zero, and one profiled step.  Then the
   trained tree planned, converted, its plan through a checkpoint's
   ``aux`` and ``generate`` on the kernels: launches as planned, no pack off
   the kernel, synchronized first tokens, 1-layer prefill logits; the
   held-out loss dense against LUT reported.
12. ``audit``  the audit (``repro_torch.audit``) on the kernel path
   (:func:`audit_phase`): the reference's three audit points at full
   width -- granite_8b at 2 of 36 layers under the serving recipe and
   under TL1 (exact activations), qwen2_moe_a2_7b at 2 of 24 with its
   experts converted, chunks capped at 1, tiles tuned at the point's batch
   (``blocks_over_smem`` audits them) -- each through one eager prefill
   and one eager decode step recorded with every kernel as an opaque leaf:
   the multiplier-free, zero-copy, in-place, plan-consistency and overflow
   rules all empty, and each step's leaves per kernel equal to the
   launches the wrappers counted in it.  A seeded dense ``wq`` spliced
   into the granite tree must trip the multiplier-free rule.  Each point's
   decode census (top ops), rule counts and seconds are printed.
13. ``dist``  data-parallel and pod-compressed training (:func:`dist_phase`)
   on an NCCL world of one rank (``launch/mesh.py::init_world``) with a
   ``("pod", "data")`` mesh of ``(1, 1)``: the ``train`` phase's ``100m``
   recipe at full width, DIST_STEPS steps of 8 x 256 tokens under the
   deterministic algorithms, with ``compress_pod_grads`` off and on.  Off,
   the mesh's steps equal the no-mesh ``Trainer``'s bit for bit (a mean
   over one rank divides by 1); on, step 1's gradients equal
   ``compressed_psum_ref`` of the uncompressed ones bit for bit and every
   residual lies within half a quantization step; every loss finite, the
   last 4 below the first 4; a checkpoint at step DIST_CKPT_AT (``err``
   included) restored by a fresh ``Trainer`` finishes equal to the straight
   run bit for bit; the collectives one compressed step records (the
   audit's walker, each an opaque leaf) are the predicted ones.  Reported:
   the median step ms off and on, one profiled step of each (device busy
   ms, host wall ms), ``collective_stats`` of the step at n = 1 and, from
   the same records, computed at n = 2 and 16.  One card holds one rank:
   NCCL refuses two ranks on one device, so a larger world runs only in
   the CPU tests (``tests/test_torch_dist_world.py``).

The engine's serve phases (3, 3c, 3d, 3e, 3f, 5, 7, 9) serve their requests on the kernels
with the engine's decode step captured as a CUDA graph and replayed (the
engine's default on the card, the main path) and eager
(``cuda_graph=False``), in turns: eager, graph, graph, eager, after one
untimed eager run (:func:`serve_paths`).  Each run must launch the
phase's kernels as often per forward as the eager step does (the replays
count what the capture recorded) and serve the same streams, whole; one
``graph_vs_eager`` line gives each path's median decode step, tok/s,
device kernels, busy ms and idle share per step (the decode profile of
each path: ``decode_profile`` with the graph, whose kernels the profiler
records per replay, beside the captured graph's nodes;
``decode_profile_eager`` without).  Each phase's plain engine run (eager,
its packs counted) is followed by its first SLOTS requests under the
engine's default graph, whose streams must equal the eager run's whole
(:func:`plain_graph_gate`; the weight, MoE and binary cells replay 13
steps, the cells served PLAIN_NEW tokens one): the plain versions read
their plane scales from device tensors made by the eager warm-up step
(``kernels/common.py::device_scales``), so the captured step copies
nothing from the host.

Kernel and library times are device times (:func:`device_ms`): many
calls back to back between one pair of CUDA events, each call on its own
copy of the tables so that it reads them from HBM as serving does, held
behind a spin kernel until the host has enqueued them all.

Every path is driven with the kernels' launch counts set to 0 just before
it and read just after; each phase ends with a ``seconds`` line.  Then one
``kernels`` summary line (the row of ``bitplane_pack`` sums its launches
over the fifteen paths that pack and ``serve_lut``, whose plans pack off
the kernel, ``launches_by_path``, and times one
binary-cell decode layer's 7 packs; ``lut_affine`` and ``lut_tl1`` add the
paper networks' launches to their serve phase's, the weight cell's kernels
the paged engine's and the MLA, phi3, minitron, mixtral, VLM, RWKV,
hybrid and enc-dec cells' and the ``serve_lut`` example's (the VLM cell's engine as
``vlm_serve``, its ``generate()``
with the image prefix as ``vlm_generate``; the RWKV cell's ``generate()``
as ``rwkv_serve``, the hybrid cell's as ``hybrid_generate``, the enc-dec
cell's as ``encdec_generate``, the trained 100m model's as
``train_serve``), the experts
kernel the mixtral cell's to the MoE cell's; a
null
``library_ms`` comes with its ``library_reason``),
the card's name and power limit as nvidia-smi prints them, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the script exits non-zero
without that last line.  It exits non-zero at once when no CUDA device is
present.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores
# fp32 adds: one per fp32 lane (128 per SM) per clock; int32 adds: the 64
# INT32 lanes per SM each retire a three-input IADD3, two adds per clock
ADDS_PER_S = 128 * 132 * 1.98e9
L2_BYTES = 50 * 2**20  # H100 SXM
SPIN_CYCLES_PER_S = 1.98e9  # torch.cuda._sleep counts SM clock cycles
KERNEL_TOL = 1e-5  # x max|plain|: fp32 sums taken in another order
LOGITS_TOL = 5e-2  # x max|plain|, see the serve phase
LOGITS_FRO_TOL = 5e-2  # ||kernel - plain|| / ||plain|| over the prefill logits

# the serve phase: depth (cut by memory), requests, new tokens each
LAYERS, REQUESTS, MAX_NEW = 4, 8, 16
# the recipe cells' plain engine runs (first tokens, packs a forward): new
# tokens a request (at 16 the four plain runs took 23-27 s each)
PLAIN_NEW = 4
SLOTS, MAX_LEN, BUCKET = 4, 64, 32  # engine slots, cache length, prefill bucket
TL1_LAYERS = 36  # the published depth: TL1 tables take 52 MiB per layer
TL1_TOL = 1e-5  # x max|plain| on the exact fp32 path; the int path is exact
# the moe_serve phase: memory kept free beside the converted model (the
# plain path's 1 GiB gathers, the caches, the allocator's slack)
MOE_HEADROOM = 16 * 2**30
BF16_OPS_PER_S = 989e12  # H100 SXM, dense bf16 on the tensor cores
# the bmm_serve phase: the published depth (its fp32 weights take 30 GiB)
# and the prefill logits' tolerance (see bmm_serve_phase)
BMM_LAYERS = 36
BMM_DEPTHS = (1, 4, 12, 36)
BMM_LOGITS_TOL = 1e-1  # x max|plain|
BMM_LOGITS_FRO_TOL = 1e-1
BMM_FIXED = (8, 6)  # ExecCfg.fixed_bits / fixed_frac: signed 8/6 fixed point
# the paged_serve phase: the serve cell's engine paged at the reference
# bench's page size; the traffic's shared system prefix (two full pages);
# the pools: the dense rectangle's 32 pages, the smallest pool that serves
# the traffic to its end (admission maps only a prompt's pages, so smaller
# pools run dry mid-decode: the phase checks that two of them raise)
PAGE_SIZE, SYS_PREFIX = 8, 16
RECT_POOL = SLOTS * MAX_LEN // PAGE_SIZE
SMALL_POOL = 21
DRY_POOLS = (16, SMALL_POOL - 1)
# a dense prefill whose K/V are rounded to bf16 before attention against the
# paged prefill, which reads them from its bf16 pool: the CPU test's limit
# (x max|dense on bf16 K/V|); PR 23's card runs measured 0
BF16_KV_TOL = 1e-3

# the mla_serve phase: full-width minicpm3_4b, depth cut from 62 to 16 (the
# recipe's chunk-1 i8 tables take ~1.8 GiB a layer and lm_head ~5.6 GiB:
# all 62 layers would need ~119 GiB), its prefill logits held kernel
# against plain at these depths (the plain path costs ~40x the kernels' per
# call, so not at every depth)
MLA_LAYERS = 16
MLA_DEPTHS = (1, 4, MLA_LAYERS)
# the phi3_serve and minitron_serve phases: the deepest cut whose recipe
# tables (layers and the untied lm_head) fit this budget, a little above
# moe_serve's 44,320 MiB, leaving room for the fp32 tree while it converts;
# each architecture's (lone, grouped) LUT calls a layer: phi3 wq, wo,
# w_down and wk+wv, w_gate+w_up; minitron wq, wo, w_in, w_out and wk+wv
FAMILY_TABLE_BYTES = 48 * 2**30
# their first tokens, kernel against plain with every input code the same
# (synced_first_tokens): the logits and each pack site's input within this x
# max, as each kernel is held to its plain version (measured: below 1e-6)
SYNCED_TOL = 1e-5
FAMILY_CALLS = {"phi3_medium_14b": (3, 2), "minitron_4b": (4, 1),
                "llava_next_mistral_7b": (3, 2), "rwkv6_3b": (8, 0)}
# the vlm_serve phase: full-width llava_next_mistral_7b at the cut family_depth
# computes (6 of 32 layers expected); VLM_ROWS rows, each 576 image patch
# embeddings and a VLM_PROMPT-token prompt (a chat turn about one image), and
# VLM_NEW new tokens through generate(embeds=...): a cache of 576 + 32 + 16 =
# 624 slots, 78 pages of PAGE_SIZE when paged.  The plain versions take ~100x
# the kernels' time at the prefill's 2,432 rows, so its logits are held kernel
# against plain at VLM_PLAIN_DEPTH layers (and the first tokens, synchronized,
# at the cut); VLM_TIMED prefills timed apart; the LUT calls at the prefill's
# rows timed over VLM_PREFILL_ITERS calls
VLM_ROWS, VLM_PROMPT, VLM_NEW, VLM_SEED = 4, 32, 16, 1
# the unsynchronized prefill logits, kernel against plain, on the first
# VLM_PLAIN_ROWS rows (608 positions each): the plain versions' time grows
# with the rows, and the synchronized first tokens below hold all VLM_ROWS
VLM_PLAIN_DEPTH, VLM_PLAIN_ROWS = 1, 1
VLM_TIMED, VLM_PREFILL_ITERS = 3, 5
# the synchronized kernel-against-plain generate runs on the first
# VLM_SYNC_DEPTH layers of the cut, on all VLM_ROWS rows (the prefill's
# 2,432): the plain versions take ~23 s a layer there, and the full call has
# to stay within two thirds of its time limit with the rwkv_serve,
# hybrid_serve and train phases beside it
VLM_SYNC_DEPTH = 1
# the train phase: examples/train_100m.py's 100m preset at full width,
# TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ stream tokens with a checkpoint
# every TRAIN_CKPT_EVERY (the restart resumes at the middle one), and
# TRAIN_HELD_OUT stream batches past them for the held-out loss; the remat
# policies compared over TRAIN_REMAT_STEPS steps; granite_8b at full width
# cut to TRAIN_GRANITE_LAYERS layers for TRAIN_GRANITE_STEPS steps; the
# trained tree served to TRAIN_ROWS x TRAIN_PROMPT stream tokens, TRAIN_NEW
# new (TRAIN_SYNC_NEW in the synchronized plain run: it holds first tokens)
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_BATCH, TRAIN_SEQ, TRAIN_HELD_OUT = 40, 20, 8, 256, 4
TRAIN_REMAT_STEPS, TRAIN_GRANITE_LAYERS, TRAIN_GRANITE_STEPS = 4, 2, 4
# the dist phase: the train phase's 100m recipe and batches, DIST_STEPS steps
# with compress_pod_grads off and on, a checkpoint at DIST_CKPT_AT; the
# collectives' link bytes also computed at the group sizes DIST_COMPUTED_N
DIST_STEPS, DIST_CKPT_AT, DIST_COMPUTED_N = 8, 4, (2, 16)
TRAIN_ROWS, TRAIN_PROMPT, TRAIN_NEW, TRAIN_SYNC_NEW = 4, 32, 16, 2
# the other families under autograd at full width: layers (None: all), rows,
# tokens a row (whisper: decoder tokens beside ENCDEC_FRAMES frames)
FAMILY_TRAIN = {"rwkv6_3b": (16, 8, 256), "zamba2_1_2b": (None, 8, 256),
                "whisper_base": (None, 8, 128)}
FAMILY_TRAIN_STEPS, FAMILY_TRAIN_NONZERO = 4, 0.9
# the rwkv_serve phase: full-width rwkv6_3b at the cut family_depth computes
# (16 of 32 expected).  The main path: RWKV_ROWS rows of RWKV_PROMPT seeded
# prompt tokens and RWKV_NEW new tokens through generate() (long-context
# chat or document continuation on a fixed-size state), its prefill timed
# RWKV_TIMED times; the short traffic, RWKV_SHORT prompt tokens and
# RWKV_SHORT_NEW new ones, for the synchronized first tokens, the state
# across calls and the O(1) check (its decode steps interleaved with the
# main traffic's); one prefill of RWKV_ODD tokens, whose odd length runs the
# WKV scan at chunk 1 (a token a step: at 511 tokens it took 10-12 s of the
# call, which the full call cannot spare).  The plain versions
# take ~7 s a layer at the prefill's 2,048 rows, so the prefill logits are
# held kernel against plain at RWKV_PLAIN_DEPTH layers
RWKV_ROWS, RWKV_PROMPT, RWKV_NEW, RWKV_SEED = 4, 512, 32, 2
RWKV_SHORT, RWKV_SHORT_NEW, RWKV_ODD = 64, 8, 127
RWKV_PLAIN_DEPTH, RWKV_TIMED, RWKV_PREFILL_ITERS = 1, 2, 5
RWKV_STATE_TOL = 5e-2  # norm error of the cached decode against one chunked forward
# the hybrid_serve phase: full-width zamba2_1_2b at the cut family_depth
# computes (all 38 layers expected).  The main path: HYBRID_ROWS rows of
# HYBRID_PROMPT seeded prompt tokens and HYBRID_NEW new tokens through
# generate() (long-context chat or document continuation on a small model: a
# 2,048-row prefill, 8 chunks of 64 a layer), its prefill timed HYBRID_TIMED
# times; the short traffic (HYBRID_SHORT prompt tokens, HYBRID_SHORT_NEW new)
# for the state across calls and the decode step after a short context (its
# steps interleaved with the main traffic's), and with HYBRID_SYNC_NEW new
# tokens for the synchronized first tokens (the plain versions take ~1 s a
# decode step at 38 layers); one prefill of HYBRID_ODD tokens, chunk 1.  The
# prefill logits are held kernel against plain on HYBRID_PLAIN_PROMPT tokens a
# row at HYBRID_PLAIN_DEPTH layers: six mamba layers and the first shared
# invocation
HYBRID_ROWS, HYBRID_PROMPT, HYBRID_NEW, HYBRID_SEED = 4, 512, 32, 3
HYBRID_SHORT, HYBRID_SHORT_NEW, HYBRID_SYNC_NEW, HYBRID_ODD = 64, 8, 2, 127
HYBRID_PLAIN_DEPTH, HYBRID_PLAIN_PROMPT = 7, 128
HYBRID_TIMED, HYBRID_PREFILL_ITERS = 2, 5
# the cached prefill and decode against one chunked forward, every site on
# the forward's codes: its input within this x max of the forward's (the
# cached decode attends over bf16 K/V, the forward over fp32)
HYBRID_STATE_TOL = 1e-2
# the encdec_serve phase: full-width whisper_base at all 6 + 6 layers (the
# recipe's chunk-1 i8 tables take ~1.3 GiB: nothing is cut).  The main path:
# ENCDEC_ROWS rows of ENCDEC_FRAMES seeded frame embeddings (std
# ENCDEC_FRAME_STD, as the reference's tests seed them; 1,500 frames is
# whisper's 30-second window after its conv stem, arXiv:2212.04356) and an
# ENCDEC_PROMPT-token seeded prompt (the length of whisper's
# start-of-transcript sequence), ENCDEC_NEW new tokens each through
# generate(enc_embeds=...) into an ENCDEC_LEN-slot decoder cache (8 pages of
# PAGE_SIZE when paged): one 30-second audio chunk transcribed per request.
# Its prefill timed ENCDEC_TIMED times; the prefill logits held kernel
# against plain unsynchronized at ENCDEC_PLAIN_DEPTH encoder and decoder
# layers and synchronized at the full depth, where they also give the
# synchronized first tokens; the LUT calls at the encoder's 6,000 rows timed
# over ENCDEC_PREFILL_ITERS calls
ENCDEC_ROWS, ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_NEW, ENCDEC_LEN = 4, 1500, 4, 60, 64
ENCDEC_SEED, ENCDEC_FRAME_STD = 4, 0.1
ENCDEC_PLAIN_DEPTH, ENCDEC_TIMED, ENCDEC_PREFILL_ITERS = 1, 3, 5
# the mixtral_serve phase: full-width mixtral_8x7b (a 4096-token sliding
# window, 8 experts top-2 of width 14,336, no shared experts) at the cut
# family_depth computes with its experts converted (1 of 32 layers); then its
# ring at the published window: RING_SLOTS slots of RING_LEN (the window; 512
# pages of PAGE_SIZE a slot when paged), two requests of RING_PROMPTS tokens
# and RING_NEW new tokens each (both write past slot 4095 mid-decode); a
# decode of RING_NEW fed tokens after a RING_PROMPTS[0]-token prefill, held
# to a windowed full forward; ``generate()`` on a RING_GENERATE-token prompt
RING_SLOTS, RING_LEN, RING_NEW = 2, 4096, 40
RING_PROMPTS = (4072, 4088)
RING_GENERATE, RING_GENERATE_NEW = 4200, 8

# the autotune phase: a main-path point's analytic winner may take at most
# AUTOTUNE_SLACK x the shape rule's measured time; calls a round per tiling
# (autotune._measure takes the median of three rounds)
AUTOTUNE_SLACK = 1.10
AUTOTUNE_REPS = 5
# the tiles A/B's turns (ABBA BAAB: a drift within the call weighs on both
# sides alike), for the graph replays and (serve) the eager step
TILES_ORDER = ("untuned", "tuned", "tuned", "untuned", "tuned", "untuned", "untuned", "tuned")

# the pack_kernel phase: per cell, the model, the kind of its packs and
# its packed inputs: (input, width, rows at decode, rows at prefill, packs
# per layer); the float16 kind is on no served path
# the paper phase: each network's chunks (unsigned fp16 bitplane tables;
# LeNet's fc1 alone would take 26 GB of tables at chunk 2), the held-out
# batches of tablenet_mnist.accuracy, the least argmax agreement of the
# kernel path with the plain one per batch, the Fig. 5 plan's input bits
# and chunks, the TL1 rows' activation widths
PAPER_CHUNKS = {"linear": (1, 2), "mlp": (1, 2), "lenet": (1,)}
# each network's learning rates, the recipe's first; the last one's weights
# are converted.  LeNet's 0.3 is at the edge of stability: on the same seeds
# it collapsed to chance in the JAX package (CPU) and in the port on the
# card, and reached 0.82 in the port on the CPU; at 0.1 it trains in all three
PAPER_LR = {"linear": (0.3,), "mlp": (0.3,), "lenet": (0.3, 0.1)}
PAPER_BATCHES, PAPER_ROWS = 3, 500
PAPER_AGREE = 499
TL1_BATCHES = 4  # accuracy_vs_bits' 2000 held-out images, batches of 500
FIG5_BITS, FIG5_CHUNKS = 3, (1, 2, 7, 14)
# linear_mode="onehot_mxu": the paper networks' held-out accuracy on it
# within ONEHOT_ACC_POINTS of the kernel path's; granite_8b's layer at
# full width under fixed-point 8/6 chunk-2 plans with fp32 and i8 tables, at
# ONEHOT_ROWS rows
ONEHOT_ACC_POINTS = 0.5
ONEHOT_ROWS = (4, 128)
ONEHOT_TABLES = (None, "i8")  # table_format: fp32 entries (rounded to bf16) and i8 (exact)
ONEHOT_X_STD = 0.5  # the inputs' std (8/6 fixed point holds [-2, 2))
TL1_ACT_BITS = (None, 8, 4, 2)
PACK_SERVED = {
    "weight": ("granite_8b", dict(kind="shift", m=1, signed=True, radix=4),
               [("d_model", 4096, 4, 128, 4), ("d_ff", 14336, 4, 128, 1)]),
    "moe": ("qwen2_moe_a2_7b", dict(kind="shift", m=1, signed=True, radix=4),
            [("d_model", 2048, 4, 128, 4), ("moe_d_ff", 1408, 16, 512, 1),
             ("shared_d_ff", 5632, 4, 128, 1)]),
    "binary": ("granite_8b", dict(kind="fixed", m=1, bits=BMM_FIXED[0], frac=BMM_FIXED[1],
                                  signed=True),
               [("d_model", 4096, 4, 128, 6), ("d_ff", 14336, 4, 128, 1)]),
    "float16": ("granite_8b", dict(kind="float16", m=1),
                [("d_model", 4096, 4, 128, 1), ("d_ff", 14336, 4, 128, 1)]),
}
# fp16 rounding's edges: +-0, subnormals (the smallest, ties to 0 and up),
# the smallest normal, RNE ties at 1, 65504, the overflow tie, +-inf
PACK_EDGES = [0.0, -0.0, 2.0**-24, -(2.0**-24), 2.0**-25, 3 * 2.0**-26, 2.0**-26,
              2.0**-14 - 2.0**-24, 2.0**-14, 1 + 2.0**-11, 1 + 3 * 2.0**-11, 65504.0,
              65519.996, 65520.0, -65520.0, 1e6, float("inf"), float("-inf"), -3.0, 0.5]

# main-path shapes of full-width granite_8b: name -> (G, k, p)
LONE = {"wq": (1, 4096, 4096), "wo": (1, 4096, 4096), "w_down": (1, 14336, 4096)}
GROUPED = {"wk+wv": (2, 4096, 1024), "w_gate+w_up": (2, 4096, 14336)}
# the binary-matmul path's projections: name -> (q, p, calls per layer)
BMM_SHAPES = {"wq|wo": (4096, 4096, 2), "wk|wv": (4096, 1024, 2),
              "w_gate|w_up": (4096, 14336, 2), "w_down": (14336, 4096, 1)}
SOURCES = {
    "lut_affine": "src/repro_torch/csrc/lut_affine.cu",
    "lut_affine_grouped": "src/repro_torch/csrc/lut_affine.cu",
    "lut_tl1": "src/repro_torch/csrc/lut_tl1.cu",
    "lut_tl1_grouped": "src/repro_torch/csrc/lut_tl1.cu",
    "lut_affine_experts": "src/repro_torch/csrc/lut_affine.cu",
    "binary_matmul": "src/repro_torch/csrc/binary_matmul.cu",
    "bitplane_pack": "src/repro_torch/csrc/bitplane_pack.cu",
}
# why a kernel line's library_ms is null (its tables' types, or no one call)
LIBRARY_REASONS = {
    "lut_affine": "no PyTorch call takes i8/i16 tables with exponent shifts",
    "lut_affine_grouped": "no PyTorch call takes i8/i16 tables with exponent shifts",
    "lut_affine_experts": "no PyTorch call takes i8 expert tables with exponent shifts",
    "bitplane_pack": "no single PyTorch call packs bitplanes",
}
REPLACES = {
    "lut_affine": "src/repro/kernels/lut_affine/lut_affine.py:275",
    "lut_affine_grouped": "src/repro/kernels/lut_affine/lut_affine.py:239",
    "lut_tl1": "src/repro/kernels/lut_tl1/lut_tl1.py:125",
    "lut_tl1_grouped": "src/repro/kernels/lut_tl1/lut_tl1.py:154",
    "lut_affine_experts": "src/repro/kernels/lut_affine/lut_affine.py:181",
    "binary_matmul": "src/repro/kernels/binary_matmul/binary_matmul.py:47",
    "bitplane_pack": "src/repro/kernels/bitplane_pack/bitplane_pack.py:56",
}


def ptxas_report(log: str) -> dict:
    """ptxas -v's report per kernel: registers, static shared memory, stack
    frame and spill bytes (dynamic shared memory is set at launch and
    reported beside it)."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", ln)
        if m:
            name = m.group(1)
            continue
        if name is None:
            continue
        row = out.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            row.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            row["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            row["static_smem"] = int(sm.group(1)) if sm else 0
    return {k: v for k, v in out.items() if "registers" in v}


def sass_loops(lib_path, kernels=("decode_kernel", "prefill_kernel", "experts_kernel")) -> dict:
    """Per named kernel of a built library (cuobjdump -sass): the innermost
    loop holding byte permutes (the span of a backward branch) -- its
    instructions, PRMTs and FADDs, and instructions per PRMT, which on the
    integer magic path is instructions per gathered entry."""
    from repro_torch.kernels import build

    exe = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    text = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for func, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", text, re.S):
        if not any(k in func for k in kernels):
            continue
        ins = [(int(a, 16), t.strip())
               for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
        best = None
        for a, t in ins:
            m = re.search(r"\bBRA\b[^0-9]*(0x[0-9a-f]+)", t)
            if not m or int(m.group(1), 16) > a:
                continue
            span = [x[1] for x in ins if int(m.group(1), 16) <= x[0] <= a]
            prmt = sum(" PRMT " in f" {x} " or x.startswith("PRMT") for x in span)
            if prmt and (best is None or len(span) < best["instructions"]):
                fadd = sum(re.search(r"(^|\s)FADD", x) is not None for x in span)
                best = {"instructions": len(span), "prmt": prmt, "fadd": fadd,
                        "per_prmt": len(span) / prmt}
        out[func] = best
    return out


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fns, iters: int, warmup: int = 2, hold: bool = True) -> float:
    """Time of one call: ``iters`` calls of ``fns`` (cycled, so that each
    can read its own copy of the operands, see :func:`copies_of`) back to
    back between one pair of CUDA events, over the count, after ``warmup``
    untimed calls.

    With ``hold``, a spin kernel keeps the stream busy until the host has
    enqueued every call, so the reading is the device's time alone and not
    the host's enqueue (allocation, the ctypes call); it is checked that
    the device had not reached the first event when the host was done.
    Without it (the plain versions, hundreds of small launches per call at
    prefill, more than the stream's queue holds) the reading includes the
    host's enqueue wherever that outlasts the device's work."""
    import torch

    fns = list(fns)
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fns[0]()
    torch.cuda.synchronize()
    spin_s = 2 * iters * (time.perf_counter() - t0) + 1e-3  # host + device, with room
    for _ in range(4):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        a.record()
        for i in range(iters):
            fns[i % len(fns)]()
        b.record()
        ahead = not a.query()
        b.synchronize()
        if ahead or not hold:
            return a.elapsed_time(b) / iters
        spin_s *= 4
    raise AssertionError("the host did not get ahead of the device; timing refused")


def copies_of(t) -> list:
    """``t`` and enough copies of it that together they hold twice the L2:
    between two reads of one copy the others stream more than the L2
    holds (or ``t`` alone exceeds it), so every timed call finds its
    operand in HBM, as the main path does, which reads each layer's tables
    once per step."""
    n = min(64, max(1, -(-2 * L2_BYTES // max(1, t.numel() * t.element_size()))))
    return [t] + [t.clone() for _ in range(n - 1)]


# ---------------------------------------------------------------------------
# autotune phase
# ---------------------------------------------------------------------------


def autotune_plans() -> list:
    """The autotune phase's plans, on shapes alone (one layer of each
    full-width model: a point does not depend on depth): the main path's
    seven weight plans (the serve cell's recipe, granite_8b) and the TL1
    cell's seven, then qwen2_moe_a2_7b's expert projections, minicpm3_4b's
    ``wq_a`` and ``wkv_a`` and the heads of phi3_medium_14b and minitron_4b
    under their cells' recipes.  Each as ``{"cell", "key", "plan", "G",
    "main", "experts"}``."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.planner import plan_model
    from repro_torch.kernels.lut_affine.autotune import _group_sizes
    from repro_torch.models.layers import mla_convertible

    def cut(arch):
        return meta_params(dataclasses.replace(get_config(arch), num_layers=1))

    out = []

    def add(cell, mplan, keep, main=False, experts=False):
        sizes = _group_sizes(mplan)
        out.extend({"cell": cell, "key": key, "plan": mplan.layers[key],
                    "G": sizes.get(key, 1), "main": main, "experts": experts}
                   for key in sorted(mplan.layers) if keep(key))

    granite = cut("granite_8b")
    _, serve = recipe_plans(granite)  # the serve cell's plan: chunks up to 2
    add("serve", serve, lambda key: True, main=True)
    add("tl1_serve", plan_model(granite, float("inf"), families=("tl1",)), lambda key: True,
        main=True)
    moe, _ = recipe_plans(cut("qwen2_moe_a2_7b"), convert_experts=True)
    add("moe_serve", moe, lambda key: key.startswith("blocks/ffn/w_"), experts=True)
    mla, _ = recipe_plans(cut("minicpm3_4b"), predicate=mla_convertible)
    add("mla_serve", mla, lambda key: key.rsplit("/", 1)[-1] in ("wq_a", "wkv_a"))
    for cell, arch in (("phi3_serve", "phi3_medium_14b"), ("minitron_serve", "minitron_4b")):
        plan, _ = recipe_plans(cut(arch))
        add(cell, plan, lambda key: key == "lm_head")
    return out


def autotune_case(pt, plan, experts: bool, seed: int):
    """Operands of one point, made on the card from ``seed``: real codes of
    seeded activations under ``plan`` (TL1: quantized activation codes; the
    expert point: SLOTS tokens routed top-k by a seeded router, as the
    moe_kernel phase routes them) and random i8 / packed tables.  Returns
    (call(blocks, tables), plain(), tables, the shape rule's splits, bound
    ms, bound_by, exact)."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.lut import pack_codes, plane_scales
    from repro_torch.core.lut_tl1 import quantize_acts
    from repro_torch.kernels.lut_affine import ops
    from repro_torch.kernels.lut_tl1 import ops as tl1_ops
    from repro_torch.models import moe

    gen = torch.Generator(device=DEV).manual_seed(seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    G, k, p = pt.G, pt.k, pt.p
    if pt.family == "tl1":
        x = torch.randn(pt.B, plan.in_features, generator=gen, device=DEV)
        acts, _ = quantize_acts(x, plan)
        nib = torch.randint(0, 9, (2, G, k, p), generator=gen, device=DEV, dtype=torch.uint8)
        tables = nib[0] | (nib[1] << 4)
        del nib

        def call(blocks, t):
            if G == 1:
                return tl1_ops.lut_tl1(acts, t[0], plan=plan, blocks=blocks)
            return tl1_ops.lut_tl1_grouped(acts, t, plan=plan, blocks=blocks)

        def plain():
            return tl1_ops.lut_tl1_grouped(acts, tables, plan=plan, use_kernels=False)[
                0 if G == 1 else slice(None)]

        ms, by = tl1_bound(G, pt.B, k, p)
        return call, plain, tables, tl1_ops.k_splits(G, pt.B, k, p, sms), ms, by, True
    if plan.table_format != "i8":
        raise AssertionError(f"autotune: {plan} stores no i8 tables")
    # the i8 tables' power-of-two dequant scale folds into the plane scales
    scales = plane_scales(plan).astype(np.float32) * np.float32(2.0**-6)
    row_bytes = -(-p // ops.ROW_ALIGN) * ops.ROW_ALIGN
    if experts:
        cfg = get_config("qwen2_moe_a2_7b")
        d, E = cfg.d_model, cfg.num_experts
        router = torch.randn(d, E, generator=gen, device=DEV) / math.sqrt(d)
        x = torch.randn(pt.B, d, generator=gen, device=DEV)
        _, _, _, token_of, gs = moe.dispatch(x, router, cfg)
        T = token_of.numel()
        src = torch.randn(T, plan.in_features, generator=gen, device=DEV) * 0.1
        codes = pack_codes(src, plan)
        tables = torch.randint(-127, 128, (E, G, k, pt.entries, p), generator=gen, device=DEV,
                               dtype=torch.int8)

        def call(blocks, t):
            return ops.lut_affine_experts(codes, t, scales, gs, shift_bits=plan.shift_bits,
                                          blocks=blocks)

        def plain():
            return ops.lut_affine_experts(codes, tables, scales, gs,
                                          shift_bits=plan.shift_bits, use_kernels=False)

        splits = ops.experts_tiling(G, T, k, row_bytes, sms).splits
        ms, by = bound(codes, G, pt.entries, p, 1, plan.shift_bits,
                       expert_of=sorted_expert_of(gs, T))
        return call, plain, tables, splits, ms, by, False
    x = torch.randn(pt.B, plan.in_features, generator=gen, device=DEV)
    codes = pack_codes(x, plan)
    tables = torch.randint(-127, 128, (G, k, pt.entries, p), generator=gen, device=DEV,
                           dtype=torch.int8)

    def call(blocks, t):
        if G == 1:
            return ops.lut_affine(codes, t[0], scales, shift_bits=plan.shift_bits,
                                  blocks=blocks)
        return ops.lut_affine_grouped(codes, t, scales, shift_bits=plan.shift_bits,
                                      blocks=blocks)

    def plain():
        return ops.lut_affine_grouped(codes, tables, scales, shift_bits=plan.shift_bits,
                                      use_kernels=False)[0 if G == 1 else slice(None)]

    splits = ops.tiling(G, pt.B, pt.n, k, pt.entries, row_bytes, sms).splits
    ms, by = bound(codes, G, pt.entries, p, 1, plan.shift_bits)
    return call, plain, tables, splits, ms, by, False


def autotune_phase(iters: int) -> dict:
    """The autotuner (``kernels/lut_affine/autotune.py``) on the card: for
    each point of :func:`autotune_plans` at the decode batch (SLOTS rows),
    the device time of the shape rule's tiling and of every candidate
    tiling (``block_k`` over the powers of two up to k, and k), so the
    measured winner; the analytic winner's time among them; the bound.
    Every time is the package's measured mode (``autotune.measure_candidates``
    on the point's operands: real codes, random tables in copies that cycle
    past the L2).  The shape rule, both winners and the extreme tilings
    (``block_k`` 1 and k) are held to the plain version on the same inputs:
    within KERNEL_TOL x max|plain| (TL1 bit for bit).  The expert points run
    the ragged kernel at the routed rows (their point is the reference's,
    of the dense kernel), which keeps its shape rule under any tiles: the
    rule's time, and every tiling's output the rule's bit for bit.  A
    main-path point whose analytic winner is more than AUTOTUNE_SLACK x the
    shape rule's time fails the phase."""
    import torch

    from repro_torch.kernels.lut_affine import autotune

    plans = autotune_plans()
    seen: dict = {}
    for entry in plans:
        pt = autotune.TunePoint.from_plan(entry["plan"], SLOTS, G=entry["G"])
        seen.setdefault(pt, []).append(entry)
    smi = smi_line()
    reps = min(iters, AUTOTUNE_REPS)
    rows = []
    for seed, (pt, entries) in enumerate(seen.items()):
        t0 = time.perf_counter()
        first = entries[0]
        experts = first["experts"]
        call, plain, tables, rule_splits, bound_ms, bound_by, exact = autotune_case(
            pt, first["plan"], experts, seed)
        cands = autotune.candidate_blocks(pt)
        operands = {"call": call, "tables": copies_of(tables)}
        if experts:  # the ragged kernel keeps its shape rule: only the rule is timed
            secs = {None: autotune._measure(operands, None, reps)}
        else:
            secs = autotune.measure_candidates(pt, reps, operands)
        times = {blk: t * 1e3 for blk, t in secs.items()}
        rule_ms = times.pop(None)
        ana = autotune.search_blocks(pt)
        ref = plain()
        scale = ref.abs().max().item()
        tilings = [("rule", None), ("analytic", ana), ("one_chunk", ana[:2] + (1,)),
                   ("whole_k", ana[:2] + (pt.k,))]
        if not experts:
            meas = min(cands, key=lambda blk: (times[blk], blk))
            tilings.insert(2, ("measured", meas))
        errs, outs = {}, {}
        for name, blocks in tilings:
            got = call(blocks, tables).to(ref.dtype)
            if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"autotune {pt} {name}: shape {tuple(got.shape)} or "
                                     "non-finite values")
            errs[name] = (got - ref).abs().max().item()
            outs[name] = got
        tol = 0.0 if exact else KERNEL_TOL * scale
        rule_blocks = list(ana[:2]) + [-(-pt.k // rule_splits)]
        row = {"phase": "autotune", "step": "point",
               "plans": [f"{e['cell']}:{e['key']}" for e in entries], "main": first["main"],
               "kernel": "lut_affine_experts" if experts else None,
               "point": pt.to_json(), "candidates": len(cands), "reps": reps,
               "rule": {"splits": rule_splits, "blocks_equivalent": rule_blocks, "ms": rule_ms},
               "bound_ms": bound_ms, "bound_by": bound_by,
               "max_abs_err": errs, "tol": tol, "max_abs_ref": scale, "nvidia_smi": smi}
        if experts:
            row["analytic"] = {"blocks": list(ana), "obeyed": False}
            row["kernel_reason"] = ("the ragged kernel at SLOTS tokens x top-k routed rows "
                                    "keeps its shape rule; the point is the reference's "
                                    "(from_plan knows no experts)")
            row["outputs_equal_rule"] = all(torch.equal(o, outs["rule"]) for o in outs.values())
        else:
            row.update({
                "analytic": {"blocks": list(ana), "splits": -(-pt.k // ana[2]),
                             "ms": times[ana], "model_us": autotune.analytic_cost(pt, ana)},
                "measured": {"blocks": list(meas), "splits": -(-pt.k // meas[2]),
                             "ms": times[meas]},
                "analytic_over_rule": times[ana] / rule_ms,
                "measured_over_rule": times[meas] / rule_ms,
                "candidate_ms": {str(blk[2]): t for blk, t in times.items()}})
        row["seconds"] = time.perf_counter() - t0
        emit(row)
        rows.append(row)
        if max(errs.values()) > tol:
            raise AssertionError(f"autotune {pt}: a tiling disagrees with plain: {errs} > {tol}")
        if experts and not row["outputs_equal_rule"]:
            raise AssertionError(f"autotune {pt}: tiles moved the ragged kernel's output")
        del call, plain, tables, operands, ref, outs
        torch.cuda.empty_cache()
    worst = max(r["analytic_over_rule"] for r in rows if r["main"])
    emit({"phase": "autotune", "step": "summary", "points": len(rows),
          "worst_main_analytic_over_rule": worst, "slack": AUTOTUNE_SLACK})
    if worst > AUTOTUNE_SLACK:
        raise AssertionError(f"autotune: a main-path point's analytic winner takes {worst:.3f}x "
                             f"the shape rule's time (> {AUTOTUNE_SLACK})")
    return {"rows": rows}


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def bound(codes, G, E, p, itemsize, shift_bits, expert_of=None):
    """Least time for the card: the table rows this run's codes touch (each
    read once), the codes and the output, over HBM bandwidth; or the
    shift + add per gathered element over the fp32 rate.  ``expert_of``
    (the ragged MoE form) gives each code row's expert: a row is then
    keyed by (expert, chunk, index)."""
    import torch

    B, n, k = codes.shape
    idx = codes & (E - 1) if shift_bits else codes
    chunk = torch.arange(k, device=codes.device, dtype=torch.int64)
    key = chunk * E + idx.to(torch.int64)
    if expert_of is not None:
        key = key + expert_of.to(torch.int64)[:, None, None] * (k * E)
    rows = torch.unique(key).numel()
    nbytes = G * rows * p * itemsize + codes.numel() * 4 + G * B * p * 4
    ops = 2 * G * B * n * k * p
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def make_case(gen, B, n, k, E, p, G, dtype, shift_bits, scales, real_codes=None):
    import torch

    dev = DEV
    if real_codes is not None:
        codes = real_codes
    else:
        idx = torch.randint(0, E, (B, n, k), generator=gen, device=dev, dtype=torch.int32)
        if shift_bits:
            exp = torch.randint(0, 31, (B, 1, k), generator=gen, device=dev, dtype=torch.int32)
            idx = idx + (exp << shift_bits)
        codes = idx
    shape = (G, k, E, p)
    if dtype in (torch.int8, torch.int16):
        hi = 127 if dtype == torch.int8 else 32767
        tables = torch.randint(-hi, hi + 1, shape, generator=gen, device=dev, dtype=dtype)
    else:
        tables = torch.randn(shape, generator=gen, device=dev).to(dtype)
    return codes.contiguous(), tables, scales


def run_case(name, codes, tables, scales, shift_bits, iters, plain_iters, lib_fn=None):
    """One LUT call, kernel against plain within KERNEL_TOL x max|plain|, with
    the kernel's device ms, the plain version's over ``plain_iters`` calls,
    the bound, the library call's and the dense bf16 matmul's; with
    ``plain_iters`` 0 the kernel is timed only (its caller holds it to its
    plain version elsewhere: ``max_abs_err`` and ``plain_ms`` are null)."""
    import torch

    from repro_torch.kernels.lut_affine import ops

    G, k, E, p = tables.shape
    B, n, _ = codes.shape

    def kern(t=tables):
        if name == "lut_affine":
            return ops.lut_affine(codes, t[0], scales, shift_bits=shift_bits)
        return ops.lut_affine_grouped(codes, t, scales, shift_bits=shift_bits)

    def plain():
        if name == "lut_affine":
            return ops.lut_affine(
                codes, tables[0], scales, shift_bits=shift_bits, use_kernels=False
            )
        return ops.lut_affine_grouped(
            codes, tables, scales, shift_bits=shift_bits, use_kernels=False
        )

    err = tol = plain_ms = None
    if plain_iters:
        got = kern()
        torch.cuda.synchronize()
        ref = plain()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        tol = KERNEL_TOL * scale
        if not (err <= tol and torch.isfinite(got).all().item()):
            raise AssertionError(f"{name} B={B} n={n} k={k} E={E} p={p}: err {err} > tol {tol}")
        del got, ref
        plain_ms = device_ms([plain], plain_iters, warmup=1, hold=False)
    ms = device_ms([functools.partial(kern, c) for c in copies_of(tables)], iters)
    calls = 1 if name == "lut_affine" else G
    bms, by = bound(codes, calls, E, p, tables.element_size(), shift_bits)
    lib_ms = device_ms([lib_fn], iters) if lib_fn is not None else None
    t = lut_tiling(name, codes, tables)
    return {
        "regime": t.regime, "splits": t.splits,
        "max_abs_err": err, "tol": tol,
        "tol_reason": f"{KERNEL_TOL} x max|plain|: fp32 sums in another order" if plain_iters
        else "timed only: its caller holds it to its plain version",
        "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": lib_ms,
        **({"library_reason": LIBRARY_REASONS[name]}
           if lib_fn is None and tables.dtype in (torch.int8, torch.int16) else {}),
        "dense_matmul_ms": dense_ms(B, calls, k, p, iters),
    }


def embedding_bag_fn(codes, tables, scales, shift_bits):
    """One PyTorch call computing the same function for f32 tables:
    ``embedding_bag(mode="sum")`` over the flattened tables with the shifts
    as per-sample weights (G bags per row, one call)."""
    import torch
    import torch.nn.functional as F

    G, k, E, p = tables.shape
    B, n, _ = codes.shape
    idx = (codes & (E - 1) if shift_bits else codes).to(torch.int64)
    chunk = torch.arange(k, device=codes.device, dtype=torch.int64)
    flat = chunk * E + idx  # (B, n, k)
    s = torch.as_tensor(scales, dtype=torch.float32, device=codes.device)[None, :, None]
    w = s.expand(B, n, k)
    if shift_bits:
        w = w * torch.exp2((torch.clamp(codes >> shift_bits, min=1) - 25).float())
    g = torch.arange(G, device=codes.device, dtype=torch.int64)[:, None, None] * (k * E)
    inp = (flat.reshape(1, B, n * k) + g).reshape(G * B, n * k)
    psw = w.reshape(1, B, n * k).expand(G, B, n * k).reshape(G * B, n * k).contiguous()
    weight = tables.reshape(G * k * E, p)
    return lambda: F.embedding_bag(inp, weight, mode="sum", per_sample_weights=psw)


def dense_ms(B, G, k, p, iters):
    import torch

    x = torch.randn(B, k, device=DEV, dtype=torch.bfloat16)
    ws = torch.randn(G, k, p, device=DEV, dtype=torch.bfloat16)
    return device_ms(
        [functools.partial(lambda w: [x @ w[g] for g in range(G)], c) for c in copies_of(ws)],
        iters,
    )


def kernel_phase(iters: int, prefill_rows: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.lut import LUTPlan, pack_codes, plane_scales
    from repro_torch.core.quantize import Float16Format
    from repro_torch.kernels import build
    from repro_torch.kernels.lut_affine import ops

    gen = torch.Generator(device=DEV).manual_seed(1)
    # worst error at the main path's shapes (the grid's values span other
    # magnitudes; each grid line is held to its own tolerance)
    worst = {"lut_affine": 0.0, "lut_affine_grouped": 0.0}
    main = {}  # decode-shape numbers per kernel, summed per layer
    # main path: bitplane_shift radix 4, i8, scales = plane scales * 2**-6
    fmt = Float16Format(signed=True, mantissa_radix=4)
    for rows in (4, prefill_rows):
        for name, shapes in (("lut_affine", LONE), ("lut_affine_grouped", GROUPED)):
            for proj, (G, k, p) in shapes.items():
                plan = LUTPlan(k, p, 1, fmt, mode="bitplane_shift", table_format="i8")
                x = torch.randn(rows, k, generator=gen, device=DEV)
                codes = pack_codes(x, plan)
                scales = plane_scales(plan).astype(np.float32) * np.float32(2.0**-6)
                c, t, s = make_case(
                    gen, rows, plan.num_planes, k, plan.num_entries, p, G,
                    torch.int8, plan.shift_bits, scales, real_codes=codes,
                )
                r = run_case(name, c, t, s, plan.shift_bits, iters, 5 if rows > 4 else 10)
                emit({"phase": "kernel", "kernel": name, "proj": proj, "rows": rows,
                      "G": G, "n": plan.num_planes, "k": k, "E": plan.num_entries, "p": p,
                      "table": "i8", "shift_bits": plan.shift_bits, **r})
                worst[name] = max(worst[name], r["max_abs_err"])
                m = main.setdefault(
                    name,
                    {"kernel_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": set(),
                     "prefill_ms": 0.0, "prefill_bound_ms": 0.0},
                )
                if rows == 4:
                    for key in ("kernel_ms", "plain_ms", "bound_ms"):
                        m[key] += r[key]
                    m["bound_by"].add(r["bound_by"])
                else:  # the engine's prefill: per call, summed over the layer's calls
                    m["prefill_ms"] += r["kernel_ms"]
                    m["prefill_bound_ms"] += r["bound_ms"]
                if rows == 4 and proj in ("wq", "w_gate+w_up"):
                    fn = ops.lut_affine if name == "lut_affine" else ops.lut_affine_grouped
                    determinism("kernel", name, functools.partial(
                        fn, c, t[0] if name == "lut_affine" else t, s,
                        shift_bits=plan.shift_bits),
                        {"rows": rows, "k": k, "p": p, "splits": r["splits"]})
                del c, t
                torch.cuda.empty_cache()
    # grid: table types, shift_bits 0/5, ragged k/p/B, negative plane scales
    grid = [
        # B, n, k, E, p, G, dtype, shift_bits, scales
        (3, 3, 37, 32, 130, 1, torch.float32, 5, [1.0, 16.0, 256.0]),
        (3, 3, 37, 32, 130, 2, torch.bfloat16, 5, [0.5, 8.0, 128.0]),
        (5, 3, 64, 32, 257, 1, torch.int16, 5, [2.0**-10, 2.0**-6, 2.0**-2]),
        (7, 11, 50, 128, 67, 1, torch.float32, 0, [2.0**j for j in range(11)]),
        (9, 8, 33, 16, 258, 2, torch.float32, 0, [2.0**j for j in range(7)] + [-128.0]),
        (17, 8, 45, 16, 131, 1, torch.int8, 0, [2.0**j for j in range(7)] + [-128.0]),
        (33, 6, 29, 64, 1000, 2, torch.int16, 0, [4.0**j for j in range(6)]),
        (2, 1, 20, 1024, 96, 1, torch.bfloat16, 0, [1.0]),
        # the prefill kernel: a ragged 64-row tile, ragged slabs, i16 / f32
        (129, 3, 40, 32, 1000, 2, torch.int8, 5, [2.0**-6, 2.0**-4, -(2.0**-2)]),
        (70, 1, 24, 64, 4100, 1, torch.int16, 5, [2.0**-3]),
        (65, 3, 17, 16, 513, 3, torch.float32, 0, [1.0, 2.0, -4.0]),
    ]
    for B, n, k, E, p, G, dtype, shift, scales in grid:
        c, t, s = make_case(gen, B, n, k, E, p, G, dtype, shift, np.asarray(scales, np.float32))
        if p == 4100:  # tables at an odd base, which the wrapper copies first
            flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=DEV)
            flat[1:] = t.reshape(-1)
            t = flat[1:].reshape(t.shape)
        for name in ("lut_affine", "lut_affine_grouped"):
            lib = embedding_bag_fn(c, t[:1] if name == "lut_affine" else t, s, shift) \
                if dtype == torch.float32 else None
            r = run_case(name, c, t, s, shift, iters, 5, lib_fn=lib)
            emit({"phase": "kernel", "kernel": name, "grid": True, "rows": B,
                  "G": G if name != "lut_affine" else 1, "n": n, "k": k, "E": E, "p": p,
                  "table": str(dtype).replace("torch.", ""), "shift_bits": shift, **r})
    emit({"phase": "kernel", "step": "ptxas",
          "kernels": {k: v for k, v in ptxas_report(build.BUILD_LOG.get("lut_affine", "")).items()
                      if "decode" in k or "prefill" in k}})
    return {"worst": worst, "main": main}


def lut_tiling(name, codes, tables):
    """The dense launch's kernel and grid for these operands (ops.tiling on
    the row pitch the kernels read)."""
    import torch

    from repro_torch.kernels.lut_affine import ops

    G, k, E, p = tables.shape
    B, n, _ = codes.shape
    vec = ops.ROW_ALIGN // tables.element_size()
    row_bytes = -(-p // vec) * vec * tables.element_size()
    return ops.tiling(1 if name == "lut_affine" else G, B, n, k, E, row_bytes,
                      torch.cuda.get_device_properties(0).multi_processor_count)


def determinism(phase, name, call, fields, repeats: int = 4) -> None:
    """Repeated launches of one case give equal bits (the split sums run in
    a fixed order)."""
    import torch

    outs = [call() for _ in range(repeats)]
    same = all(torch.equal(o, outs[0]) for o in outs[1:])
    emit({"phase": phase, "step": "determinism", "kernel": name, **fields, "repeats": repeats,
          "bit_identical": same})
    if not same:
        raise AssertionError(f"{name}: repeated launches differ")


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------


def weight_cell(phase: str, layers: int):
    """The weight cell's model: full-width granite_8b cut to ``layers``,
    seeded random weights planned by the serving recipe and converted;
    emits the ``plan`` and ``convert`` lines under ``phase`` and returns
    (config, converted tree)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.convert import conversion_summary, convert_params
    from repro_torch.core.planner import plan_model
    from repro_torch.kernels.lut_affine.autotune import attach_tuned_blocks
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import init_params

    full = get_config("granite_8b")
    cfg = dataclasses.replace(full, num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(model_specs(cfg), gen, device=DEV)
    uniform = plan_model(params, float("inf"), max_chunk=2)
    mplan = plan_model(
        params,
        uniform.total_lut_bytes // 2,
        max_chunk=2,
        modes=("bitplane", "bitplane_shift"),
        radices=(1, 2, 4),
        table_formats=(None, "i8"),
    )
    # the recipe's last step (serving_model_plan): tiles tuned at the slots
    mplan = attach_tuned_blocks(mplan, batch=SLOTS)
    kinds = sorted({
        f"{p.mode}-r{p.fmt.mantissa_radix}-{p.table_format}-c{p.chunk_size}"
        for p in mplan.layers.values()
    })
    per_layer = mplan.total_lut_bytes / layers / 2**20
    emit({"phase": phase, "step": "plan", "summary": mplan.summary(),
          "table_mib": mplan.total_lut_bytes / 2**20, "table_mib_per_layer": per_layer,
          "plans": kinds, "blocks": plan_blocks(mplan),
          "depth": {"layers": layers, "published": full.num_layers,
                    "reason": f"{per_layer:.0f} MiB of tables per layer: all "
                              f"{full.num_layers} layers would need "
                              f"{per_layer * full.num_layers / 1024:.0f} GiB, more than "
                              "the card's 80 GB; widths are the published ones"}})
    lut, report = convert_params(params, plan=mplan)
    del params
    torch.cuda.synchronize()
    emit({"phase": phase, "step": "convert", "summary": conversion_summary(report),
          "seconds": time.perf_counter() - t0,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
    return cfg, lut


def serve_phase(layers: int, requests: int, max_new: int) -> dict:
    import torch

    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.models.model import model_forward
    from repro_torch.serve import make_cache

    cfg, lut = weight_cell("serve", layers)
    prompts = serve_requests(cfg, requests)
    # one pack per lone projection and group: wq, wk+wv, wo, w_gate+w_up, w_down
    per_forward = {"lut_affine": 3 * layers, "lut_affine_grouped": 2 * layers,
                   "bitplane_pack": 5 * layers}
    reqs, eng, wall, decode_ms, launches, uncovered = serve_paths(
        "serve", lut, cfg, prompts, max_new, per_forward, eager_pack_profile=True)
    forwards = eng.readbacks
    expect = {**no_launches(), **{k: v * forwards for k, v in per_forward.items()}}
    tokens = sum(len(r.generated) for r in reqs)
    emit({"phase": "serve", "step": "kernels", "requests": len(reqs), "tokens": tokens,
          "tok_per_s": tokens / wall, "wall_s": wall,
          "median_decode_step_ms": statistics.median(decode_ms),
          "forwards": forwards, "launches": launches, "expected_launches": expect,
          "per_forward": per_forward, "plain_pack_codes_calls": uncovered,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
    if launches != expect or forwards <= 0 or uncovered:
        raise AssertionError(f"launch counts {launches} != expected {expect}, "
                             f"or {uncovered} packs off the kernel")
    if not all(len(r.generated) == max_new for r in reqs):
        raise AssertionError("a request stopped short of max_new")

    tiles_ab("serve", lut, cfg, prompts, max_new, per_forward, exact=False, eager=True)

    with count_plain_packs() as packs:
        plain_reqs, _, plain_wall, plain_decode = run_engine(lut, cfg, prompts, max_new,
                                                             False, cuda_graph=False)
    plain_graph_gate("serve", lut, cfg, prompts, max_new, plain_reqs, plain_decode)
    first_ok = all(a.generated[0] == b.generated[0] for a, b in zip(reqs, plain_reqs))
    same = sum(
        x == y for a, b in zip(reqs, plain_reqs) for x, y in zip(a.generated, b.generated)
    )
    emit({"phase": "serve", "step": "plain", "tok_per_s": tokens / plain_wall,
          "median_decode_step_ms": statistics.median(plain_decode),
          "first_tokens_identical": first_ok, "identical_token_share": same / tokens,
          "pack_codes_calls": packs["calls"]})
    if not first_ok:
        raise AssertionError("kernel and plain paths disagree on a first token")
    if packs["calls"] != launches["bitplane_pack"]:
        raise AssertionError(f"the plain run packed {packs['calls']} times, the kernel run "
                             f"{launches['bitplane_pack']}")

    # one prefill batch, both paths, fresh caches; first at every depth up to
    # the served one, to show how the paths' difference grows layer by layer
    inputs = prefill_inputs(prompts)

    def prefill_logits(depth: int, use_kernels: bool):
        dcfg = dataclasses.replace(cfg, num_layers=depth)
        params = dict(lut, blocks=first_layers(lut["blocks"], depth))
        ctx = Ctx(dcfg, ex=ExecCfg(lut_grouped=True, use_kernels=use_kernels))
        cache = make_cache(dcfg, SLOTS, MAX_LEN, ctx, device=DEV)
        with torch.no_grad():
            logits, _, _ = model_forward(params, inputs, ctx, cache=cache)
        return logits[inputs["token_mask"]]

    def compare(a, b):
        d = a - b
        return {"max_abs_err": d.abs().max().item(), "max_abs_ref": b.abs().max().item(),
                "rel_fro_err": (d.norm() / b.norm()).item(),
                "argmax_agree": (a.argmax(-1) == b.argmax(-1)).float().mean().item()}

    for depth in range(1, layers):
        emit({"phase": "serve", "step": "prefill_logits_by_depth", "layers": depth,
              **compare(prefill_logits(depth, True), prefill_logits(depth, False))})
    got, ref = prefill_logits(layers, True), prefill_logits(layers, False)
    # noise floor: the plain path against itself with its sums cut into
    # other chunk slices (the same function, another fp32 order)
    with plain_gather_bytes(64 * 2**20):
        floor = compare(prefill_logits(layers, False), ref)
    res = compare(got, ref)
    finite = bool(torch.isfinite(got).all().item())
    tol = LOGITS_TOL * res["max_abs_ref"]
    emit({"phase": "serve", "step": "prefill_logits", "layers": layers, "shape": list(got.shape),
          **res, "tol": tol, "rel_fro_tol": LOGITS_FRO_TOL, "finite": finite,
          "plain_vs_plain": floor,
          "tol_reason": "the paths sum in other orders (~1e-7 relative); where that moves an "
                        "activation across an fp16 rounding boundary before the next table "
                        "lookup, its code changes by 2**-11, and the random-init layers carry "
                        "and grow these steps to the logits (plain_vs_plain shows the same "
                        "effect between two orders of the plain version)"})
    if not (finite and res["max_abs_err"] <= tol and res["rel_fro_err"] <= LOGITS_FRO_TOL):
        raise AssertionError(f"prefill logits differ: {res} (tol {tol}, {LOGITS_FRO_TOL})")
    return {"launches": launches, "model": (cfg, lut)}


def _launch_counts() -> tuple:
    from repro_torch.kernels.binary_matmul import ops as bmm_ops
    from repro_torch.kernels.bitplane_pack import ops as pack_ops
    from repro_torch.kernels.lut_affine import ops
    from repro_torch.kernels.lut_tl1 import ops as tl1_ops

    return ops.LAUNCHES, tl1_ops.LAUNCHES, pack_ops.LAUNCHES, bmm_ops.LAUNCHES


def reset_launches() -> None:
    """Every kernel's launch count, the count of packs off the kernel and
    the count of table copies before a launch, to 0."""
    from repro_torch.kernels.common import launch_counters

    for counts in launch_counters():
        counts.update(dict.fromkeys(counts, 0))


def plain_pack_codes_calls() -> int:
    """Packs since :func:`reset_launches` of plans the packing kernel does
    not implement (``pack_codes`` on the card)."""
    from repro_torch.kernels.bitplane_pack import ops as pack_ops

    return pack_ops.PLAIN_CALLS["pack_codes"]


@contextlib.contextmanager
def count_plain_packs():
    """Count, inside a ``with`` block, the packs the plain versions make
    (``ref.py``'s, and ``pack_codes`` for the plans the kernel does not
    implement)."""
    from repro_torch.kernels.bitplane_pack import ops

    n = {"calls": 0}
    saved = ops.bitplane_pack_ref, ops.pack_codes

    def counted(fn):
        def call(*args, **kw):
            n["calls"] += 1
            return fn(*args, **kw)

        return call

    ops.bitplane_pack_ref, ops.pack_codes = (counted(fn) for fn in saved)
    try:
        yield n
    finally:
        ops.bitplane_pack_ref, ops.pack_codes = saved


@contextlib.contextmanager
def bf16_attention_inputs():
    """Inside a ``with`` block, the model's attention takes its K/V (MLA:
    its latents ``c_kv`` and ``k_rope``) rounded to bf16, as a paged
    prefill reads them from its cache (a dense prefill attends over its
    fp32 in-flight K/V; cached ones are bf16 already)."""
    import torch

    from repro_torch.models import layers

    sdpa, latent_sdpa = layers._sdpa, layers._latent_sdpa

    def rounded(q, k, v, mask):
        return sdpa(q, k.to(torch.bfloat16), v.to(torch.bfloat16), mask)

    def rounded_latents(q_nope, q_rope, c_kv, k_rope, mask, wk_b, wv_b):
        return latent_sdpa(q_nope, q_rope, c_kv.to(torch.bfloat16), k_rope.to(torch.bfloat16),
                           mask, wk_b, wv_b)

    layers._sdpa, layers._latent_sdpa = rounded, rounded_latents
    try:
        yield
    finally:
        layers._sdpa, layers._latent_sdpa = sdpa, latent_sdpa


@contextlib.contextmanager
def eager_pack():
    """The model's pack sites on the eager ``core/lut.py::pack_codes`` (the
    packing before the kernel took it) inside a ``with`` block."""
    from repro_torch.core.lut import pack_codes
    from repro_torch.models import layers, moe

    saved = layers.pack, moe.pack

    def plain(x, plan, use_kernels=True):
        return pack_codes(x, plan)

    layers.pack = moe.pack = plain
    try:
        yield
    finally:
        layers.pack, moe.pack = saved


PATH_ORDER = (False, True, True, False)  # eager, graph, graph, eager


def serve_paths(phase, params, cfg, prompts, max_new, per_forward, eager_pack_profile=False,
                **ex):
    """Serve ``prompts`` on the kernels with the decode step eager and as
    CUDA graph replays, in turns (PATH_ORDER, after one untimed eager run
    that takes the process's first-use costs off the first timed run), each
    run's launch counts set to 0 just before it and read just after: every
    run must launch
    ``per_forward`` of each kernel per forward (replays count what the
    capture recorded), pack nothing off the kernel, and serve the same
    streams, whole.  Then the decode profile of each path (and, with
    ``eager_pack_profile``, of the eager step with the pack sites on eager
    ``pack_codes``), one ``graph_vs_eager`` line, and the first graph run
    (the main path) returned as (requests, engine, wall s, decode step ms,
    launches, packs off the kernel)."""
    import torch

    run_engine(params, cfg, prompts, max_new, True, cuda_graph=False, **ex)
    runs = []
    for graph in PATH_ORDER:
        reset_launches()
        reqs, eng, wall, decode_ms = run_engine(params, cfg, prompts, max_new, True,
                                                cuda_graph=graph, **ex)
        launches, uncovered = read_launches(), plain_pack_codes_calls()
        expect = {**no_launches(), **{k: v * eng.readbacks for k, v in per_forward.items()}}
        if launches != expect or uncovered or eng.readbacks <= 0:
            raise AssertionError(f"{phase} ({'graph' if graph else 'eager'}): launch counts "
                                 f"{launches} != expected {expect}, or {uncovered} packs off "
                                 "the kernel")
        if eng.cuda_graph is not graph or (graph and eng._graph is None):
            raise AssertionError(f"{phase}: the engine did not run the step as asked "
                                 f"(cuda_graph {graph})")
        runs.append({"reqs": reqs, "eng": eng, "wall": wall, "decode_ms": decode_ms,
                     "launches": launches, "uncovered": uncovered})
    streams = [[r.generated for r in run["reqs"]] for run in runs]
    identical = all(s == streams[0] for s in streams)
    sub = prompts[:SLOTS]
    profiles = {"graph": profile_decode(params, cfg, sub, max_new, cuda_graph=True, **ex),
                "eager": profile_decode(params, cfg, sub, max_new, cuda_graph=False, **ex)}
    emit({"phase": phase, "step": "decode_profile", **profiles["graph"]})
    emit({"phase": phase, "step": "decode_profile_eager", **profiles["eager"]})
    if eager_pack_profile:
        with eager_pack():
            packs = profile_decode(params, cfg, sub, max_new, cuda_graph=False, **ex)
        emit({"phase": phase, "step": "decode_profile_eager_pack", **packs,
              "device_kernels_removed_per_step": packs["device_kernels_per_step"]
              - profiles["eager"]["device_kernels_per_step"],
              "busy_ms_saved_per_step": packs["busy_ms_per_step"]
              - profiles["eager"]["busy_ms_per_step"]})
    tokens = sum(len(r.generated) for r in runs[0]["reqs"])
    paths = {}
    for name, graph in (("eager", False), ("graph", True)):
        mine = [run for run, g in zip(runs, PATH_ORDER) if g is graph]
        steps = [ms for run in mine for ms in run["decode_ms"]]
        prof = profiles[name]
        paths[name] = {
            "median_decode_step_ms": statistics.median(steps),
            "median_decode_step_ms_by_run": [statistics.median(r["decode_ms"]) for r in mine],
            "tok_per_s": tokens * len(mine) / sum(r["wall"] for r in mine),
            "tok_per_s_by_run": [tokens / r["wall"] for r in mine],
            # the graph's: its capture and first replay
            "second_decode_step_ms_by_run": [r["decode_ms"][0] for r in mine],
            "device_kernels_per_step": prof["device_kernels_per_step"],
            "busy_ms_per_step": prof["busy_ms_per_step"],
            "idle_share": prof["idle_share"],
            "profiled_wall_ms_per_step": prof["wall_ms_per_step"],
            # the profiler slows the host: the share of the timed median step
            # that the profiled busy time leaves idle
            "idle_share_at_median_step": 1.0 - prof["busy_ms_per_step"]
            / statistics.median(steps),
        }
    emit({"phase": phase, "step": "graph_vs_eager",
          "order": ["graph" if g else "eager" for g in PATH_ORDER], "tokens": tokens,
          "forwards": runs[1]["eng"].readbacks, "streams_identical": identical, **paths,
          "median_step_ratio_eager_over_graph": paths["eager"]["median_decode_step_ms"]
          / paths["graph"]["median_decode_step_ms"],
          "graph_nodes": profiles["graph"]["graph_nodes"],
          "nvidia_smi": smi_line(),
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
    if not identical:
        raise AssertionError(f"{phase}: the graph and eager runs served different streams")
    main = runs[1]
    return (main["reqs"], main["eng"], main["wall"], main["decode_ms"], main["launches"],
            main["uncovered"])


def plan_blocks(mplan) -> dict:
    """Each layer's tuned tiles, as the plan carries them."""
    return {key: list(p.blocks) if p.blocks else None for key, p in sorted(mplan.layers.items())}


def strip_tiles(tree):
    """``tree`` with every converted node's plan stripped of its tiles (the
    tables shared, not copied): the same model on the shape rule."""
    from repro_torch.core.convert import LUTGroup, LUTLinear

    if isinstance(tree, (LUTLinear, LUTGroup)):
        return dataclasses.replace(tree, plan=dataclasses.replace(tree.plan, blocks=None))
    if isinstance(tree, dict):
        return {k: strip_tiles(v) for k, v in tree.items()}
    return tree


def tile_check_us(params, calls: int = 20000) -> dict:
    """Host microseconds a dense wrapper spends on its tiles, per call: the
    legality check and the grid (``ops.check_blocks`` and ``ops.tiling``,
    the check's memoised hit after the first) for the first tuned grouped
    leaf of ``params`` at the decode batch, with its tiles and with none."""
    import timeit

    from repro_torch.core.convert import LUTGroup
    from repro_torch.kernels.lut_affine import autotune, ops

    def leaves(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        elif isinstance(tree, LUTGroup) and tree.plan.blocks is not None:
            yield tree

    node = next(leaves(params))
    tables = node.tables.reshape(-1, *node.tables.shape[-4:])[0]
    pt = autotune.TunePoint.from_plan(node.plan, SLOTS, G=tables.shape[0])
    shape = (SLOTS, pt.n, pt.k)
    row_bytes = pt.p * pt.table_bytes
    out = {}
    for side, blocks in (("untuned", None), ("tuned", node.plan.blocks)):
        def one():
            ops.check_blocks("lut_affine_grouped", shape, tables, blocks)
            ops.tiling(pt.G, SLOTS, pt.n, pt.k, pt.entries, row_bytes, 132, blocks)

        out[side] = timeit.timeit(one, number=calls) / calls * 1e6
    return {"point": pt.to_json(), "blocks": list(node.plan.blocks), **out}


def tiles_ab(phase, params, cfg, prompts, max_new, per_forward, exact: bool, engine=None,
             eager=False):
    """The cell's tuned tree against the same tables on the shape rule
    (:func:`strip_tiles`), the decode step as graph replays, in the turns
    of TILES_ORDER, each run's launch counts set to 0 just before it and
    read just after and held to ``per_forward`` (tiles move no launch); one
    ``tiles`` line with each side's median decode step.  With ``eager``, the
    same turns with the step eager (every wrapper runs its Python, the
    memoised tile check among it): each side's median eager decode step
    and admission prefill step, each side's eager streams held to its graph
    streams whole (the same tiles, the same sums), and the host
    microseconds the tiles add to one wrapper call (:func:`tile_check_us`).
    With ``exact`` (TL1's integer sums) the tuned and untuned streams must
    be identical whole; else (fp32 sums cut at other k ranges, ~1e-7 a
    call) their agreement is reported."""
    untuned = strip_tiles(params)
    line = {"phase": phase, "step": "tiles", "order": list(TILES_ORDER),
            "nvidia_smi": smi_line()}
    streams = {}
    for graph in (True, False) if eager else (True,):
        runs = {"tuned": [], "untuned": []}
        for side in TILES_ORDER:
            steps = []
            reset_launches()
            reqs, eng, wall, decode_ms = run_engine(
                params if side == "tuned" else untuned, cfg, prompts, max_new, True,
                cuda_graph=None if graph else False, engine=engine, steps=steps)
            launches = read_launches()
            expect = {**no_launches(), **{k: v * eng.readbacks for k, v in per_forward.items()}}
            if launches != expect or (eng._graph is None) is graph:
                raise AssertionError(f"{phase} tiles ({side}, graph {graph}): launch counts "
                                     f"{launches} != expected {expect}, or the step ran "
                                     f"{'eager' if graph else 'as a graph'}")
            prefill_ms = [ms for prefilled, ms in steps if prefilled]
            runs[side].append((wall, decode_ms, prefill_ms, sum(len(r.generated) for r in reqs)))
            got = [r.generated for r in reqs]
            if streams.setdefault(side, got) != got:
                raise AssertionError(f"{phase} tiles: two {side} runs (graph {graph}) served "
                                     "different streams")
        key = "" if graph else "eager_"
        for side, rs in runs.items():
            steps = [ms for _, d, _, _ in rs for ms in d]
            line[key + side] = {
                "median_decode_step_ms": statistics.median(steps),
                "median_decode_step_ms_by_run": [statistics.median(d) for _, d, _, _ in rs],
                "tok_per_s": sum(n for *_, n in rs) / sum(w for w, *_ in rs)}
            if not graph:
                line[key + side]["median_prefill_step_ms"] = statistics.median(
                    ms for _, _, p, _ in rs for ms in p)
                line[key + side]["median_prefill_step_ms_by_run"] = [
                    statistics.median(p) for _, _, p, _ in rs]
        line[f"median_{key}step_ratio_tuned_over_untuned"] = (
            line[key + "tuned"]["median_decode_step_ms"]
            / line[key + "untuned"]["median_decode_step_ms"])
        if not graph:
            line["median_eager_prefill_ratio_tuned_over_untuned"] = (
                line["eager_tuned"]["median_prefill_step_ms"]
                / line["eager_untuned"]["median_prefill_step_ms"])
    same = sum(x == y for a, b in zip(streams["tuned"], streams["untuned"])
               for x, y in zip(a, b))
    total = sum(len(a) for a in streams["tuned"])
    line["streams_identical"] = streams["tuned"] == streams["untuned"]
    line["identical_token_share"] = same / total
    if eager:
        line["eager_streams_equal_graph"] = True  # held above, per side
        line["tile_check_us"] = tile_check_us(params)
    emit(line)
    if exact and not line["streams_identical"]:
        raise AssertionError(f"{phase}: tuned and untuned integer streams differ")
    return line


# ---------------------------------------------------------------------------
# paged_serve phase
# ---------------------------------------------------------------------------


def paged_requests(cfg):
    """The paged_serve phase's 8 requests: 0, 2, 4 and 6 open with one
    shared SYS_PREFIX-token system prompt and 4..16 tokens of their own
    (chat serving, where every conversation opens with the same system
    prompt); 1, 3, 5 and 7 are serve_requests' first four prompts."""
    import numpy as np

    rng = np.random.default_rng(1)
    system = rng.integers(0, cfg.vocab_size, SYS_PREFIX).astype(np.int32)
    base = serve_requests(cfg, 4)
    out = []
    for i in range(4):
        own = rng.integers(0, cfg.vocab_size, int(rng.integers(4, 17))).astype(np.int32)
        out += [np.concatenate([system, own]), base[i]]
    return out


def shared_prefill_tokens(prompts) -> int:
    """The tokens the reference's prefix sharing prefills for ``prompts``:
    the first holder of the system prompt prefills it in full, every later
    holder only its tail (a holder's prompt is longer than the prefix, so
    the hit never covers its last token)."""
    system = prompts[0][:SYS_PREFIX]
    holders = sum(len(p) > SYS_PREFIX and bool((p[:SYS_PREFIX] == system).all())
                  for p in prompts)
    return sum(len(p) for p in prompts) - (holders - 1) * SYS_PREFIX


def page_watch(stats: dict):
    """A ``run_engine`` watch for a paged engine: counts the admissions that
    left a slot free with a request queued (a dry pool), the registry's
    evictions, and per step the pages in use beside the pages the live
    slots map and the bound ceil(len / PAGE_SIZE) summed over them."""
    stats.update(steps=0, dry_deferrals=0, evictions=0, peak_pages_in_use=0,
                 peak_live_bound=0, live_mapped_over_bound=[])

    def watch(eng):
        admit, evict = eng._admit, eng.alloc._evict_one

        def admitted():
            admit()
            stats["dry_deferrals"] += bool(eng.queue) and any(r is None for r in eng.slots)

        def evicted():
            done = evict()
            stats["evictions"] += done
            return done

        eng._admit, eng.alloc._evict_one = admitted, evicted

        def step():
            live = [s for s, r in enumerate(eng.slots) if r is not None]
            rows = eng.alloc.table[live]
            mapped = len(set(rows[rows >= 0].tolist()))
            bound = sum(-(-eng._slot_len[s] // PAGE_SIZE) for s in live)
            in_use = eng.alloc.pages_in_use
            stats["steps"] += 1
            stats["peak_live_bound"] = max(stats["peak_live_bound"], bound)
            if in_use > stats["peak_pages_in_use"]:
                stats.update(peak_pages_in_use=in_use, at_peak={
                    "live_slots": len(live), "live_mapped_pages": mapped,
                    "live_bound": bound, "registry_only_pages": in_use - mapped})
            if mapped > bound:
                stats["live_mapped_over_bound"].append((stats["steps"], mapped, bound))

        return step

    return watch


def paged_serve_phase(model, layers: int, max_new: int) -> dict:
    """The weight cell's model served through ``BatchingEngine(page_size=8)``
    on traffic whose even requests share a system prompt, in one call: (a)
    the dense engine with the graph (the yardstick), (b) the paged engine
    with the graph on the rectangle's pool, (c) paged eager, (d) paged with
    the graph on SMALL_POOL pages, then the DRY_POOLS (each must raise
    CacheOverflowError mid-decode), (b) and (a) again, (e) paged on the
    plain versions, eager, and (f) the dense engine with the graph and its
    attention's K/V rounded to bf16, as a paged prefill reads them: (f)
    must serve (b)'s streams whole, which holds decode, prefix mapping and
    copy-on-write against a dense run.  ``model``: the serve phase's
    (config, tree), or None to build it."""
    import numpy as np
    import torch

    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.models.model import model_forward
    from repro_torch.serve import CacheOverflowError, _engine, make_cache
    from repro_torch.serve._cache import copy_pages

    cfg, lut = model if model is not None else weight_cell("paged_serve", layers)
    prompts = paged_requests(cfg)
    per_forward = {"lut_affine": 3 * layers, "lut_affine_grouped": 2 * layers,
                   "bitplane_pack": 5 * layers}
    forward = _engine.model_forward

    def served(name, pages=None, use_kernels=True, cuda_graph=None, record=False,
               new=max_new):
        """One run of ``new`` tokens a request, its launch counts set to 0
        just before it and read just after, held to ``per_forward`` per
        forward (kernel runs) or to none; with ``record``, the first
        admission's prefill logits are kept."""
        first = {}

        def recording(params, inputs, ctx, cache=None):
            out = forward(params, inputs, ctx, cache=cache)
            if not first:
                first.update(logits=out[0].clone(), mask=inputs["token_mask"].clone())
            return out

        stats = {}
        engine = None if pages is None else {"page_size": PAGE_SIZE, "num_pages": pages}
        _engine.model_forward = recording if record else forward
        try:
            reset_launches()
            with count_plain_packs() as packs:
                reqs, eng, wall, decode_ms = run_engine(
                    lut, cfg, prompts, new, use_kernels, cuda_graph=cuda_graph,
                    engine=engine, watch=page_watch(stats) if pages else None)
            launches, uncovered = read_launches(), plain_pack_codes_calls()
        finally:
            _engine.model_forward = forward
        forwards = eng.readbacks
        expect = no_launches()
        if use_kernels:
            expect.update({k: v * forwards for k, v in per_forward.items()})
        if launches != expect or uncovered or forwards <= 0:
            raise AssertionError(f"paged_serve {name}: launch counts {launches} != expected "
                                 f"{expect}, or {uncovered} packs off the kernel")
        if (cuda_graph is None) is not (eng._graph is not None):
            raise AssertionError(f"paged_serve {name}: the decode step did not run as asked")
        if not all(len(r.generated) == new for r in reqs):
            raise AssertionError(f"paged_serve {name}: a request stopped short of {new}")
        tokens = sum(len(r.generated) for r in reqs)
        run = {"name": name, "num_pages": pages, "cuda_graph": eng._graph is not None,
               "use_kernels": use_kernels, "median_decode_step_ms": statistics.median(decode_ms),
               "tok_per_s": tokens / wall, "wall_s": wall, "tokens": tokens,
               "decode_steps": len(decode_ms), "forwards": forwards,
               "prefill_tokens": eng.prefill_tokens, "launches": launches,
               "plain_pack_calls": packs["calls"], "pages": dict(stats),
               "kv_bytes": sum(t.nbytes for t in eng.cache["layers"].values())}
        if pages:
            run["pages_in_use_drained"] = eng.alloc.pages_in_use
            eng.alloc.release_prefixes()
            run["pages_in_use_released"] = eng.alloc.pages_in_use
            if run["pages_in_use_released"]:
                raise AssertionError(f"paged_serve {name}: {eng.alloc.pages_in_use} pages in "
                                     "use after release_prefixes()")
        emit({"phase": "paged_serve", "step": "run", **run})
        run["decode_ms"] = decode_ms
        return run, [r.generated for r in reqs], first

    run_engine(lut, cfg, prompts, max_new, True, cuda_graph=False,
               engine={"page_size": PAGE_SIZE})  # untimed: first-use costs
    tiles_ab("paged_serve", lut, cfg, prompts, max_new, per_forward, exact=False,
             engine={"page_size": PAGE_SIZE, "num_pages": RECT_POOL})
    a, a_streams, a_first = served("a_dense_graph", record=True)
    b, b_streams, b_first = served("b_paged_graph", RECT_POOL, record=True)
    c, c_streams, _ = served("c_paged_eager", RECT_POOL, cuda_graph=False)
    d, d_streams, _ = served("d_paged_graph_small_pool", SMALL_POOL)
    dry = {}
    for pages in DRY_POOLS:
        stats = {}
        try:
            run_engine(lut, cfg, prompts, max_new, True, engine={"page_size": PAGE_SIZE,
                       "num_pages": pages}, watch=page_watch(stats))
        except CacheOverflowError as e:
            dry[pages] = {"raised": str(e), "after_steps": stats["steps"],
                          "evictions": stats["evictions"]}
        else:
            raise AssertionError(f"paged_serve: a {pages}-page pool served the traffic")
    b2, b2_streams, _ = served("b_paged_graph_again", RECT_POOL)
    a2, a2_streams, _ = served("a_dense_graph_again")
    # the plain versions serve PLAIN_NEW tokens a request: the run holds the
    # first tokens (at 16 it took ~17 s of the call)
    e, e_streams, _ = served("e_paged_plain_eager", RECT_POOL, use_kernels=False,
                             cuda_graph=False, new=min(max_new, PLAIN_NEW))
    with bf16_attention_inputs():
        f, f_streams, _ = served("f_dense_graph_bf16_kv")

    # the first admission: (b) admits 0 and 1 (2 waits to share 0's prefix),
    # (a) admits 0..3; the rows both admitted, at their real tokens
    rows = b_first["mask"].any(1)
    mask = b_first["mask"][rows]
    if not torch.equal(a_first["mask"][rows], mask):
        raise AssertionError("paged_serve: the first admissions differ in their tokens")
    logits = compare_logits(b_first["logits"][rows][mask], a_first["logits"][rows][mask])
    tol = LOGITS_TOL * logits["max_abs_ref"]
    agree = [sum(x == y for x, y in zip(p, q)) for p, q in zip(a_streams, b_streams)]
    first = {"a": [x[0] for x in a_streams], "b": [x[0] for x in b_streams],
             "e": [x[0] for x in e_streams], "f": [x[0] for x in f_streams]}
    checks = {
        "paged_streams_identical": b_streams == c_streams == d_streams == b2_streams,
        "dense_graph_streams_repeat": a_streams == a2_streams,
        # kernel against plain on the paged path; paged against dense is held
        # to the logits' tolerance (its first tokens are reported: a paged
        # prefill reads bf16 K/V, a dense one fp32, see prefill_attribution)
        "first_tokens_identical_b_e": first["b"] == first["e"],
        # paged against dense, the K/V rounding aside: whole streams
        "dense_bf16_kv_streams_identical_b": f_streams == b_streams,
        "prefill_logits_within_tol": logits["max_abs_err"] <= tol
        and logits["rel_fro_err"] <= LOGITS_FRO_TOL,
        "prefill_tokens_as_shared": b["prefill_tokens"] == c["prefill_tokens"]
        == shared_prefill_tokens(prompts),
        "live_pages_within_bound": not b["pages"]["live_mapped_over_bound"],
        "peak_pages_below_rectangle": b["pages"]["peak_pages_in_use"] < RECT_POOL,
        "dry_pools_raise": sorted(dry) == sorted(DRY_POOLS),
    }
    emit({"phase": "paged_serve", "step": "checks", **checks,
          "prefill_logits": {**logits, "tol": tol, "rel_fro_tol": LOGITS_FRO_TOL,
                             "rows": int(rows.sum()), "shape": list(mask.shape),
                             "tol_reason": "the paged prefill attends over the bf16 cached "
                                           "keys, the dense one over its fp32 in-flight "
                                           "keys; each projection re-quantizes its input"},
          "tokens_agreeing_a_b_per_request": agree, "max_new": max_new,
          "tokens_agreeing_f_b_per_request": [
              sum(x == y for x, y in zip(p, q)) for p, q in zip(f_streams, b_streams)],
          "first_tokens": first,
          "first_tokens_agreeing_a_b": sum(x == y for x, y in zip(first["a"], first["b"])),
          "prefill_tokens": {"dense": a["prefill_tokens"], "paged": b["prefill_tokens"],
                             "small_pool": d["prefill_tokens"],
                             "predicted": shared_prefill_tokens(prompts),
                             "prompt_tokens": sum(len(p) for p in prompts)},
          "dry_pools": dry})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"paged_serve: failed checks {failed}")

    # what parts a paged prefill from a dense one: the prefill batch of the
    # first SLOTS prompts on fresh caches, dense (fp32 in-flight K/V), paged
    # (bf16 K/V through the page view), and dense with its in-flight K/V
    # rounded to bf16 before attention
    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True))
    inputs = prefill_inputs(prompts)

    def prefill(page_size=None):
        cache = make_cache(cfg, SLOTS, MAX_LEN, ctx, page_size=page_size, device=DEV)
        with torch.no_grad():
            logits, _, _ = model_forward(lut, inputs, ctx, cache=cache)
        return logits

    dense, paged = prefill(), prefill(PAGE_SIZE)
    with bf16_attention_inputs():
        rounded = prefill()
    last = torch.tensor([len(p) - 1 for p in prompts[:SLOTS]], device=DEV)
    rows = torch.arange(SLOTS, device=DEV)
    m = inputs["token_mask"]
    bf16_kv = compare_logits(paged[m], rounded[m])
    bf16_kv_tol = BF16_KV_TOL * bf16_kv["max_abs_ref"]
    emit({"phase": "paged_serve", "step": "prefill_attribution",
          "paged_vs_dense": compare_logits(paged[m], dense[m]),
          "paged_vs_dense_bf16_kv": {**bf16_kv, "tol": bf16_kv_tol},
          "first_tokens": {name: x[rows, last].argmax(-1).tolist() for name, x in
                           (("dense", dense), ("paged", paged), ("dense_bf16_kv", rounded))}})
    if not bf16_kv["max_abs_err"] <= bf16_kv_tol:
        raise AssertionError(f"paged_serve: the paged prefill is {bf16_kv['max_abs_err']} off "
                             f"the dense prefill on bf16 K/V (limit {bf16_kv_tol})")

    # one paged decode-shaped forward (and a copy-on-write) with no read-back
    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True))
    cache = make_cache(cfg, SLOTS, MAX_LEN, ctx, page_size=PAGE_SIZE, device=DEV)
    cache["overflow"] = torch.zeros(SLOTS, dtype=torch.bool, device=DEV)
    with torch.no_grad():
        model_forward(lut, prefill_inputs(prompts), ctx, cache=cache)
        tok = torch.tensor([[int(p[0])] for p in prompts[:SLOTS]], dtype=torch.int32,
                           device=DEV)
        live = torch.tensor([[True], [True], [False], [True]], device=DEV)
        src = torch.tensor([0, -1, -1, -1], dtype=torch.int32, device=DEV)
        dst = torch.tensor([RECT_POOL - 1, -1, -1, -1], dtype=torch.int32, device=DEV)
        model_forward(lut, {"tokens": tok, "token_mask": live}, ctx, cache=cache)
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for leaf in cache["layers"].values():
                copy_pages(leaf, src, dst)
            out, _, _ = model_forward(lut, {"tokens": tok, "token_mask": live}, ctx,
                                      cache=cache)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        launched = read_launches()
    expect = {**no_launches(), **per_forward}
    emit({"phase": "paged_serve", "step": "sync_debug", "sync_debug_mode": "error",
          "raised": False, "tokens": list(tok.shape), "launches": launched,
          "expected_launches": expect, "finite": bool(torch.isfinite(out).all().item())})
    if launched != expect or not torch.isfinite(out).all():
        raise AssertionError(f"paged decode forward: launches {launched} != {expect}")

    # where a decode step's time goes, paged against dense, on the same prompts
    sub = prompts[:SLOTS]
    prof = {"paged": profile_decode(lut, cfg, sub, max_new, engine={"page_size": PAGE_SIZE}),
            "dense": profile_decode(lut, cfg, sub, max_new)}
    names = set(prof["paged"]["kernels_by_name"]) | set(prof["dense"]["kernels_by_name"])
    added = {n: prof["paged"]["kernels_by_name"].get(n, 0)
             - prof["dense"]["kernels_by_name"].get(n, 0) for n in sorted(names)}
    for name, p in prof.items():
        emit({"phase": "paged_serve", "step": f"decode_profile_{name}",
              **{k: v for k, v in p.items() if k != "kernels_by_name"}})
    summary = {  # medians over every decode step of a path's runs
        name: {"median_decode_step_ms": statistics.median(
                   [ms for r in runs for ms in r["decode_ms"]]),
               "median_decode_step_ms_by_run": [r["median_decode_step_ms"] for r in runs],
               "tok_per_s": sum(r["tokens"] for r in runs) / sum(r["wall_s"] for r in runs),
               "tok_per_s_by_run": [r["tok_per_s"] for r in runs]}
        for name, runs in (("a_dense_graph", [a, a2]), ("b_paged_graph", [b, b2]),
                           ("c_paged_eager", [c]), ("d_paged_graph_small_pool", [d]))
    }
    emit({"phase": "paged_serve", "step": "paged_vs_dense", **summary,
          "kv_bytes": {"paged_pool": b["kv_bytes"], "small_pool": d["kv_bytes"],
                       "dense_rectangle": a["kv_bytes"],
                       "pool_pages": RECT_POOL + 1, "small_pool_pages": SMALL_POOL + 1,
                       "page_bytes_all_layers": b["kv_bytes"] // (RECT_POOL + 1)},
          "peak_pages_in_use": b["pages"]["peak_pages_in_use"],
          "at_peak": b["pages"].get("at_peak"), "peak_live_bound": b["pages"]["peak_live_bound"],
          "small_pool_peak_pages_in_use": d["pages"]["peak_pages_in_use"],
          "dry_deferrals": {"b": b["pages"]["dry_deferrals"], "d": d["pages"]["dry_deferrals"]},
          "evictions": {"b": b["pages"]["evictions"], "d": d["pages"]["evictions"]},
          "device_kernels_per_step": {n: p["device_kernels_per_step"] for n, p in prof.items()},
          "busy_ms_per_step": {n: p["busy_ms_per_step"] for n, p in prof.items()},
          "graph_nodes": {n: p["graph_nodes"] for n, p in prof.items()},
          "kernels_paging_adds_per_step": {n: v for n, v in added.items() if v},
          "nvidia_smi": smi_line(),
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
    return {"launches": b["launches"]}


# ---------------------------------------------------------------------------
# recipe-planned serve cells: mla_serve, phi3_serve, minitron_serve
# ---------------------------------------------------------------------------


# the serving recipe's widened frontier (plan_model arguments)
RECIPE_FRONTIER = dict(modes=("bitplane", "bitplane_shift"), radices=(1, 2, 4),
                       table_formats=(None, "i8"))


def recipe_plans(params, **kw):
    """The serving recipe (``benchmarks/serving.py::serving_model_plan``:
    half the uniform chunk-2 footprint, the widened frontier) with chunks
    capped at 1, and the uncapped recipe's plan of the same weights; ``kw``
    further ``plan_model`` arguments (a predicate, ``convert_experts``)."""
    from repro_torch.core.planner import plan_model

    uniform = plan_model(params, float("inf"), max_chunk=2, **kw)
    kw.update(RECIPE_FRONTIER)
    budget = uniform.total_lut_bytes // 2
    return (plan_model(params, budget, max_chunk=1, **kw),
            plan_model(params, budget, max_chunk=2, **kw))


def meta_params(cfg):
    """``cfg``'s parameter tree on the meta device: shapes, no memory."""
    import torch

    from repro_torch.models.model import model_specs
    from repro_torch.models.params import tree_map

    return tree_map(
        lambda s: torch.empty(s.shape, dtype=s.dtype or torch.float32, device="meta"),
        model_specs(cfg),
    )


def head_bytes(plan) -> int:
    """The table bytes of a plan's ``lm_head``; 0 where the head is no LUT
    (the enc-dec family's tied raw head)."""
    head = plan.layers.get("lm_head")
    return head.total_lut_bytes if head is not None else 0


def recipe_bytes(full, layers: int, **kw) -> tuple[int, int]:
    """(table bytes of the blocks, of ``lm_head``) that :func:`recipe_plans`
    plans for full-width ``full`` at ``layers`` layers, on shapes alone."""
    plan, _ = recipe_plans(meta_params(dataclasses.replace(full, num_layers=layers)), **kw)
    head = head_bytes(plan)
    return plan.total_lut_bytes - head, head


def family_depth(full, **kw) -> tuple[int, dict]:
    """The deepest cut of full-width ``full`` whose recipe-planned tables,
    its layers plus what the tree holds once (the untied ``lm_head``; the
    hybrid's shared block; the enc-dec's encoder, whose depth stays whole),
    fit in FAMILY_TABLE_BYTES: a layer's bytes from
    the plans of one and two layers on shapes alone, then checked by
    planning that depth and the next (``kw``: further ``plan_model``
    arguments)."""
    one, head = recipe_bytes(full, 1, **kw)
    layer = recipe_bytes(full, 2, **kw)[0] - one
    once = head + one - layer  # the head and any block held once
    layers = min(full.num_layers, (FAMILY_TABLE_BYTES - once) // layer)
    while layers >= 1 and sum(recipe_bytes(full, layers, **kw)) > FAMILY_TABLE_BYTES:
        layers -= 1
    if layers < 1:
        raise AssertionError(f"not one layer of {full.name} fits {FAMILY_TABLE_BYTES} B")
    total = sum(recipe_bytes(full, layers, **kw))
    nxt = sum(recipe_bytes(full, layers + 1, **kw)) if layers < full.num_layers else None
    mib, gib = 2**20, 2**30
    shared = once - head
    return layers, {
        "layers": layers, "published": full.num_layers,
        "table_mib": total / mib, "next_depth_table_mib": nxt and nxt / mib,
        "budget_mib": FAMILY_TABLE_BYTES / mib,
        "reason": f"{layer / mib:.0f} MiB of i8 tables per layer and "
                  + (f"{head / mib:.0f} MiB for the untied lm_head" if head else
                     "no LUT head (tied, a plain product)")
                  + (f" and {shared / mib:.0f} MiB for the blocks held once" if shared else "")
                  + f": {layers} layers take {total / mib:.0f} MiB"
                  + (f", {layers + 1} would take {nxt / mib:.0f} MiB, over "
                     f"{FAMILY_TABLE_BYTES / gib:.0f} GiB (a little above moe_serve's tables, "
                     "leaving the card room for the fp32 tree while it converts); all "
                     f"{full.num_layers} layers would need "
                     f"{(once + full.num_layers * layer) / gib:.0f} GiB" if nxt else
                     " (every published layer)") + "; widths are the published ones",
    }


def recipe_cell(phase: str, full, depth: dict, **kw):
    """A recipe-planned cell's model: full-width ``full`` cut to
    ``depth["layers"]``, seeded random weights planned by
    :func:`recipe_plans` (``kw``: its further arguments) and converted;
    emits the ``plan`` line (with the uncapped plan and ``depth``) and the
    ``convert`` line and returns (config, converted tree)."""
    import torch

    from repro_torch.core.convert import conversion_summary, convert_params
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import init_params

    layers = depth["layers"]
    cfg = dataclasses.replace(full, num_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(model_specs(cfg), gen, device=DEV)
    mplan, uncapped = recipe_plans(params, **kw)
    kinds = sorted({
        f"{p.mode}-r{p.fmt.mantissa_radix}-{p.table_format}-c{p.chunk_size}"
        for p in mplan.layers.values()
    })
    mib = 2**20
    head = head_bytes(mplan)
    # a stacked entry's bytes are one layer's
    entries = {key: p.total_lut_bytes / mib for key, p in mplan.layers.items()}
    wider = {key: {"chunk": p.chunk_size, "mib_per_layer": p.total_lut_bytes / mib}
             for key, p in uncapped.layers.items() if p.chunk_size > 1}
    emit({"phase": phase, "step": "plan", "summary": mplan.summary(),
          "table_mib": mplan.total_lut_bytes / mib,
          "table_mib_per_layer": (mplan.total_lut_bytes - head) / layers / mib,
          "lm_head_table_mib": head / mib, "entry_mib_per_layer": entries, "plans": kinds,
          "groups": [list(g) for g in mplan.groups], "depth": depth,
          "uncapped_recipe": {"table_mib": uncapped.total_lut_bytes / mib,
                              "entries_above_chunk_1": wider},
          "chunk_cap_reason": "chunks capped at 1 as in moe_serve: the halved uniform chunk-2 "
                              "budget is the recipe's, sized on the reduced configs; the "
                              "uncapped plan of the same weights is reported beside it"})
    if "table_mib" in depth and mplan.total_lut_bytes != depth["table_mib"] * mib:
        raise AssertionError(f"{phase}: the plan of the weights takes "
                             f"{mplan.total_lut_bytes / mib} MiB, the cut's plan on shapes "
                             f"{depth['table_mib']} MiB")
    lut, report = convert_params(params, plan=mplan, **kw)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({"phase": phase, "step": "convert", "summary": conversion_summary(report),
          "seconds": time.perf_counter() - t0, "table_bytes": report.table_bytes,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
          "memory_allocated_after_free_gib": torch.cuda.memory_allocated() / 2**30})
    if report.table_bytes != mplan.total_lut_bytes:
        raise AssertionError(f"tables {report.table_bytes} B != plan {mplan.total_lut_bytes} B")
    return cfg, lut


def lut_calls_per_forward(tree, layers: int, experts: bool = False, shared: int = 0,
                          encoder: int = 0) -> dict:
    """The LUT launches one forward of a converted model of ``layers``
    stacked layers makes, from its tree: one ``lut_affine`` per lone
    projection and layer, one ``lut_affine_grouped`` per group and layer,
    and one pack before each (``linear`` packs its input, ``fused_linears``
    once per group).  The stacked layers are ``blocks`` (the hybrid's
    ``mamba``, the enc-dec's ``decoder``); the hybrid's ``shared`` block
    runs ``shared`` times a forward; the enc-dec's ``encoder`` runs
    ``encoder`` layers (its prefill's count; 0 at decode).  An enc-dec
    decoder layer's ``cross_attn`` runs ``wq`` and ``wo`` a forward and, at
    the prefill (``encoder`` > 0), ``wk`` and ``wv`` over the encoder's
    output: one pack of each use's input, and the members of a group that
    a use does not take whole each alone on the group's leaf.  With
    ``experts``, the nodes of a block's ``ffn`` are routed experts: one
    ``lut_affine_experts`` each (the pre-stacked ``w_gate+w_up`` and
    ``w_down``), each after one pack (``moe.py`` packs a token once and
    gathers its codes)."""
    from repro_torch.core.convert import LUTGroup, LUTLinear

    calls = {"lut_affine": 0, "lut_affine_grouped": 0}
    if experts:
        calls["lut_affine_experts"] = 0
    packs = 0
    cross_uses = [("wq",), ("wo",)] + ([("wk", "wv")] if encoder else [])

    def walk(node, n, ragged=False):
        nonlocal packs
        if isinstance(node, dict):
            for key, v in node.items():
                if key == "cross_attn":
                    cross(v, n)
                else:
                    walk(v, n, experts and key == "ffn" if isinstance(v, dict) else ragged)
        elif isinstance(node, (LUTLinear, LUTGroup)):
            kind = ("lut_affine_experts" if ragged else
                    "lut_affine" if isinstance(node, LUTLinear) else "lut_affine_grouped")
            calls[kind] += n
            packs += n

    def cross(node, n):
        nonlocal packs
        for use in cross_uses:
            for key, v in node.items():
                members = key.split("+")
                wanted = [m for m in members if m in use]
                if not wanted or not isinstance(v, (LUTLinear, LUTGroup)):
                    continue
                packs += n
                if isinstance(v, LUTGroup) and len(wanted) == len(members):
                    calls["lut_affine_grouped"] += n
                else:
                    calls["lut_affine"] += n * len(wanted)

    repeats = {"blocks": layers, "mamba": layers, "decoder": layers, "shared": shared,
               "encoder": encoder}
    for key, node in tree.items():
        walk(node, repeats.get(key, 1))
    return {**calls, "bitplane_pack": packs}


@contextlib.contextmanager
def pack_tape(codes=None):
    """Inside a ``with`` block, each pack site of the model (``layers.pack``)
    records its input, codes and plan, in call order (the MoE FFN's sites
    among them); given ``codes`` (an earlier block's record), each site takes
    the recorded codes of the same site instead of packing its own input
    (which it still records)."""
    from repro_torch.models import layers, moe

    pack0, sites = layers.pack, []
    replay = None if codes is None else iter(codes)

    def pack(x, plan, use_kernels=True):
        own = pack0(x, plan, use_kernels=use_kernels) if replay is None else next(replay)[1]
        sites.append((x.clone(), own, plan))
        return own

    layers.pack = moe.pack = pack
    try:
        yield sites
    finally:
        layers.pack = moe.pack = pack0
    if replay is not None and next(replay, None) is not None:
        raise AssertionError("a recorded pack site was not replayed")


def synced_first_tokens(phase: str, lut, cfg, prompts, reqs, plain_reqs) -> bool:
    """Every request's first token (the argmax at its prompt's last position
    in an admission prefill of SLOTS prompts, as the engine admits them) on
    the kernels and on the plain versions, the plain path given the kernel
    path's codes at every pack site, in order.  The paths then differ only
    by their fp32 sums' order: an activation at an fp16 rounding boundary
    cannot take the neighbouring code in one of them, which at random init
    can flip a near-tie among the logits (the serve phase's tolerance says
    why).  Each site's plain input must lie within SYNCED_TOL x max of the
    kernel's, the logits too; emits a ``first_tokens`` line beside the
    engines' own first tokens and the kernel logits' top-2 gap at each last
    position; returns whether every synced first token is the kernel's."""
    import torch

    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.models.model import model_forward
    from repro_torch.serve import make_cache

    def forward(inputs, use_kernels):
        ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True, use_kernels=use_kernels))
        with torch.no_grad():
            return model_forward(lut, inputs, ctx,
                                 cache=make_cache(cfg, SLOTS, MAX_LEN, ctx, device=DEV))[0]

    kernel, plain, gaps, site_err, logits_err = [], [], [], 0.0, 0.0
    for b0 in range(0, len(prompts), SLOTS):
        inputs = prefill_inputs(prompts[b0:b0 + SLOTS])
        rows = torch.arange(SLOTS, device=DEV)
        last = inputs["token_mask"].sum(1) - 1
        with pack_tape() as tape:
            got = forward(inputs, True)[rows, last]
        with pack_tape(tape) as seen:
            ref = forward(inputs, False)[rows, last]
        for (x, *_), (x_ref, *_) in zip(seen, tape):
            site_err = max(site_err, ((x - x_ref).abs().max() / x_ref.abs().max()).item())
        logits_err = max(logits_err, ((got - ref).abs().max() / ref.abs().max()).item())
        top2 = got.topk(2, dim=-1).values
        kernel += got.argmax(-1).tolist()
        plain += ref.argmax(-1).tolist()
        gaps += (top2[:, 0] - top2[:, 1]).tolist()
        del tape, seen
    ok = kernel == plain and site_err <= SYNCED_TOL and logits_err <= SYNCED_TOL
    emit({"phase": phase, "step": "first_tokens", "synced_identical": kernel == plain,
          "kernel": kernel, "plain_synced": plain,
          "engine_kernel": [r.generated[0] for r in reqs],
          "engine_plain": [r.generated[0] for r in plain_reqs],
          "kernel_top2_gap": gaps, "site_input_rel_err": site_err,
          "logits_rel_err": logits_err, "tol": SYNCED_TOL,
          "tol_reason": "the paths' fp32 sums in other orders, carried through the layers "
                        "with every input code the same"})
    return ok


def serve_recipe_cell(phase: str, lut, cfg, per_forward: dict, prompts, max_new: int,
                      synced: bool = False, plain: bool = True):
    """A recipe cell's requests through ``BatchingEngine`` on the kernels,
    graph and eager in turns (:func:`serve_paths`), then (with ``plain``) on
    the plain versions, PLAIN_NEW tokens a request: every run launches
    ``per_forward`` a forward with no pack off the kernel and no table
    copy, every request's first token is the plain run's (with ``synced``,
    in :func:`synced_first_tokens`, whose plain prefills take every
    request: the plain engine then serves only the first SLOTS requests),
    and the plain run packs ``per_forward`` times a forward too; emits the
    ``kernels`` and ``plain`` lines and returns the main path's launches."""
    import torch

    from repro_torch.kernels.lut_affine import ops as lut_ops

    torch.cuda.reset_peak_memory_stats()
    reqs, eng, wall, decode_ms, launches, uncovered = serve_paths(
        phase, lut, cfg, prompts, max_new, per_forward)
    copies = lut_ops.TABLE_COPIES["table_operand"]
    forwards = eng.readbacks
    expect = {**no_launches(), **{k: v * forwards for k, v in per_forward.items()}}
    tokens = sum(len(r.generated) for r in reqs)
    emit({"phase": phase, "step": "kernels", "requests": len(reqs), "tokens": tokens,
          "tok_per_s": tokens / wall, "wall_s": wall,
          "median_decode_step_ms": statistics.median(decode_ms),
          "forwards": forwards, "launches": launches, "expected_launches": expect,
          "per_forward": per_forward, "plain_pack_codes_calls": uncovered,
          "table_copies": copies,
          "kv_bytes": sum(t.nbytes for t in eng.cache["layers"].values()),
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
    if launches != expect or forwards <= 0 or uncovered or copies:
        raise AssertionError(f"{phase}: launch counts {launches} != expected {expect}, or "
                             f"{uncovered} packs off the kernel, or {copies} table copies")
    if not all(len(r.generated) == max_new for r in reqs):
        raise AssertionError(f"{phase}: a request stopped short of max_new")
    if not plain:
        return launches

    with count_plain_packs() as packs:
        plain_reqs, plain_eng, plain_wall, plain_decode = run_engine(
            lut, cfg, prompts[:SLOTS] if synced else prompts, min(max_new, PLAIN_NEW),
            False, cuda_graph=False)
    plain_graph_gate(phase, lut, cfg, prompts, min(max_new, PLAIN_NEW), plain_reqs,
                     plain_decode)
    first_ok = all(a.generated[0] == b.generated[0] for a, b in zip(reqs, plain_reqs))
    pairs = [(x, y) for a, b in zip(reqs, plain_reqs) for x, y in zip(a.generated, b.generated)]
    plain_tokens = sum(len(r.generated) for r in plain_reqs)
    emit({"phase": phase, "step": "plain", "requests": len(plain_reqs),
          "new_tokens": min(max_new, PLAIN_NEW),
          "tok_per_s": plain_tokens / plain_wall, "wall_s": plain_wall,
          "median_decode_step_ms": statistics.median(plain_decode),
          "first_tokens_identical": first_ok,
          "identical_token_share": sum(x == y for x, y in pairs) / len(pairs),
          "pack_codes_calls": packs["calls"], "forwards": plain_eng.readbacks})
    if synced:
        first_ok = synced_first_tokens(phase, lut, cfg, prompts, reqs, plain_reqs)
    if not first_ok:
        raise AssertionError(f"{phase}: kernel and plain paths disagree on a first token")
    if packs["calls"] != per_forward["bitplane_pack"] * plain_eng.readbacks:
        raise AssertionError(f"{phase}: the plain run packed {packs['calls']} times in "
                             f"{plain_eng.readbacks} forwards, not "
                             f"{per_forward['bitplane_pack']} a forward")
    return launches


def recipe_prefill_logits(phase: str, lut, cfg, prompts, depths) -> None:
    """The first SLOTS prompts' prefill logits on the kernels against the
    plain versions at each of ``depths`` layers, within LOGITS_TOL x
    max|plain| and LOGITS_FRO_TOL; at the full depth beside the plain path
    against itself in another fp32 order (the noise floor)."""
    import torch

    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.models.model import model_forward
    from repro_torch.serve import make_cache

    inputs = prefill_inputs(prompts)

    def prefill_logits(depth: int, use_kernels: bool):
        dcfg = dataclasses.replace(cfg, num_layers=depth)
        params = dict(lut, blocks=first_layers(lut["blocks"], depth))
        ctx = Ctx(dcfg, ex=ExecCfg(lut_grouped=True, use_kernels=use_kernels))
        cache = make_cache(dcfg, SLOTS, MAX_LEN, ctx, device=DEV)
        with torch.no_grad():
            logits, _, _ = model_forward(params, inputs, ctx, cache=cache)
        return logits[inputs["token_mask"]]

    for depth in depths:
        got, ref = prefill_logits(depth, True), prefill_logits(depth, False)
        res = compare_logits(got, ref)
        finite = bool(torch.isfinite(got).all().item())
        tol = LOGITS_TOL * res["max_abs_ref"]
        line = {"phase": phase, "step": "prefill_logits", "layers": depth,
                "shape": list(got.shape), **res, "tol": tol, "rel_fro_tol": LOGITS_FRO_TOL,
                "finite": finite, "tol_reason": "as the serve phase's: the paths sum in other "
                "orders and each projection re-quantizes its input, so an activation near an "
                "fp16 rounding boundary takes the neighbouring code before the next lookup"}
        if depth == cfg.num_layers:
            with plain_gather_bytes(64 * 2**20):
                line["plain_vs_plain"] = compare_logits(prefill_logits(depth, False), ref)
        emit(line)
        if not (finite and res["max_abs_err"] <= tol and res["rel_fro_err"] <= LOGITS_FRO_TOL):
            raise AssertionError(f"{phase}: prefill logits differ at {depth} layers: {res} "
                                 f"(tol {tol}, {LOGITS_FRO_TOL})")
        del got, ref


def recipe_layer_calls(phase: str, lut, iters: int, parts=("attn", "ffn"), rows: int = 4,
                       plain: bool = True, block: str = "blocks", head: bool = True) -> dict:
    """Each LUT call of a layer's ``parts`` (layer 0's tables of the stacked
    ``block``, or the hybrid's ``shared`` block, held once) and, with
    ``head``, ``lm_head`` at ``rows`` rows (the decode shape by default),
    kernel against plain as the kernel phase holds them (without ``plain``,
    the kernel timed only: its caller holds it elsewhere), with its device
    ms beside ``bound`` and the bf16 ``x @ W`` it replaces; then a ``layer``
    line with the sums over the layer's calls, which it returns."""
    import torch

    from repro_torch.core.convert import LUTGroup, LUTLinear
    from repro_torch.core.lut import pack_codes
    from repro_torch.models.layers import _host_scales

    gen = torch.Generator(device=DEV).manual_seed(2)
    layer = {"kernel_ms": 0.0, "bound_ms": 0.0, "dense_matmul_ms": 0.0,
             **({"plain_ms": 0.0} if plain else {})}
    nodes = [(part, name, node if block == "shared" else node.layer(0)) for part in parts
             for name, node in lut[block][part].items()
             if isinstance(node, (LUTLinear, LUTGroup))]
    # names shared across parts (RWKV's time- and channel-mix w_k, w_r) keep
    # their part
    names = [name for _, name, _ in nodes]
    nodes = [(f"{part}/{name}" if names.count(name) > 1 else name, node)
             for part, name, node in nodes]
    for proj, node in nodes + ([("lm_head", lut["lm_head"])] if head else []):
        plan = node.plan
        grouped = isinstance(node, LUTGroup)
        tables = node.tables if grouped else node.tables[None]
        x = torch.randn(rows, plan.in_features, generator=gen, device=DEV)
        codes = pack_codes(x, plan)
        r = run_case("lut_affine_grouped" if grouped else "lut_affine", codes, tables,
                     _host_scales(plan, node.scale), plan.shift_bits, iters, 3 if plain else 0)
        emit({"phase": phase, "step": "layer_call", "proj": proj, "rows": rows,
              "G": tables.shape[0], "n": plan.num_planes, "k": plan.in_features,
              "E": plan.num_entries, "p": plan.out_features, "table": plan.table_format,
              "table_bytes": tables.numel() * tables.element_size(), **r,
              "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
        if proj != "lm_head":
            for key in layer:
                layer[key] += r[key]
    emit({"phase": phase, "step": "layer", "block": block, "calls": len(nodes), "rows": rows,
          **layer,
          "nvidia_smi": smi_line(),
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
    return layer


def counted_run(phase, name, lut, cfg, prompts, max_new, per_forward, paged,
                cuda_graph=None, engine=None, watch=None):
    """One engine run on the kernels (paged at PAGE_SIZE or dense; graph by
    default, or ``cuda_graph``; ``engine``: further engine arguments), its
    launch counts set to 0 just before and read just after: ``per_forward``
    of each kernel a forward, no pack off the kernel, the step as asked;
    emits a ``paged_run`` line and returns (streams, engine)."""
    reset_launches()
    kw = {**({"page_size": PAGE_SIZE} if paged else {}), **(engine or {})}
    reqs, eng, wall, decode_ms = run_engine(lut, cfg, prompts, max_new, True,
                                            cuda_graph=cuda_graph, engine=kw, watch=watch)
    launches, uncovered = read_launches(), plain_pack_codes_calls()
    expect = {**no_launches(), **{k: v * eng.readbacks for k, v in per_forward.items()}}
    if launches != expect or uncovered or eng.readbacks <= 0:
        raise AssertionError(f"{phase} {name}: launch counts {launches} != expected "
                             f"{expect}, or {uncovered} packs off the kernel")
    if (cuda_graph is None) is not (eng._graph is not None):
        raise AssertionError(f"{phase} {name}: the decode step did not run as asked")
    tokens = sum(len(r.generated) for r in reqs)
    emit({"phase": phase, "step": "paged_run", "name": name, "paged": paged,
          "cuda_graph": eng._graph is not None,
          "median_decode_step_ms": statistics.median(decode_ms), "tok_per_s": tokens / wall,
          "wall_s": wall, "forwards": eng.readbacks, "prefill_tokens": eng.prefill_tokens,
          "launches": launches,
          "kv_bytes": sum(t.nbytes for t in eng.cache["layers"].values())})
    return [r.generated for r in reqs], eng


def mla_serve_phase(layers: int, requests: int, max_new: int, iters: int) -> dict:
    """Full-width minicpm3_4b (MLA attention, latent KV cache) cut to
    ``layers``, planned by the recipe with ``wk_b``/``wv_b`` vetoed
    (``models/layers.py::mla_convertible``: the absorbed form reads them as
    raw weights), served through ``BatchingEngine`` on the LUT kernels:
    dense (graph and eager in turns, :func:`serve_paths`), then on the plain
    versions (first tokens identical, prefill logits at MLA_DEPTHS), then
    paged at PAGE_SIZE on ``paged_requests``' traffic: (a) dense graph, (b)
    paged graph, (c) paged eager, (f) dense graph with its latents rounded
    to bf16, which must serve (b)'s streams whole; last, the decode-shape
    time of each LUT call of a layer beside its bound."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models.layers import MLA_RAW_WEIGHTS, mla_convertible

    full = get_config("minicpm3_4b")
    layer, head = recipe_bytes(full, 1, predicate=mla_convertible)
    mib = 2**20
    depth = {"layers": layers, "published": full.num_layers, "vetoed": list(MLA_RAW_WEIGHTS),
             "reason": f"{layer / mib:.1f} MiB of i8 tables per layer and {head / mib:.0f} MiB "
                       f"for the untied lm_head: all {full.num_layers} layers would need "
                       f"{(layer * full.num_layers + head) / 2**30:.0f} GiB, more than the "
                       "card's 80 GB; widths are the published ones"}
    cfg, lut = recipe_cell("mla_serve", full, depth, predicate=mla_convertible)
    # wq_a, wq_b, wkv_a, wo and w_down alone, w_gate+w_up grouped, lm_head;
    # one pack each (wq_a and wkv_a pack the same x twice)
    per_forward = lut_calls_per_forward(lut, layers)
    want = {"lut_affine": 5 * layers + 1, "lut_affine_grouped": layers,
            "bitplane_pack": 6 * layers + 1}
    if per_forward != want:
        raise AssertionError(f"the converted tree makes {per_forward} calls a forward, "
                             f"not {want}")
    prompts = serve_requests(cfg, requests)
    launches = serve_recipe_cell("mla_serve", lut, cfg, per_forward, prompts, max_new)
    recipe_prefill_logits("mla_serve", lut, cfg, prompts, MLA_DEPTHS)

    # paged: the latent cache in pages of PAGE_SIZE, a shared system prompt
    pprompts = paged_requests(cfg)

    def served(name, paged, cuda_graph=None):
        streams, eng = counted_run("mla_serve", name, lut, cfg, pprompts, max_new,
                                   per_forward, paged, cuda_graph)
        return streams, eng.prefill_tokens

    a, _ = served("a_dense_graph", False)
    b, b_prefilled = served("b_paged_graph", True)
    c, c_prefilled = served("c_paged_eager", True, cuda_graph=False)
    with bf16_attention_inputs():
        f, _ = served("f_dense_graph_bf16_latents", False)
    predicted = shared_prefill_tokens(pprompts)
    checks = {
        "paged_streams_identical_b_c": b == c,
        "dense_bf16_latents_streams_identical_b": f == b,
        "prefill_tokens_as_shared": b_prefilled == c_prefilled == predicted,
    }
    emit({"phase": "mla_serve", "step": "paged_checks", **checks,
          "prefill_tokens": {"paged": b_prefilled, "predicted": predicted,
                             "prompt_tokens": sum(len(p) for p in pprompts)},
          "tokens_agreeing_a_b_per_request": [sum(x == y for x, y in zip(p, q))
                                              for p, q in zip(a, b)],
          "first_tokens": {"a": [s[0] for s in a], "b": [s[0] for s in b]}})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"mla_serve: failed paged checks {failed}")

    recipe_layer_calls("mla_serve", lut, iters)
    del lut
    torch.cuda.empty_cache()
    return {"launches": launches}


def family_serve_phase(phase: str, arch: str, requests: int, max_new: int, iters: int) -> dict:
    """Full-width ``arch`` (phi3_medium_14b: dense GQA, 40 heads to 10 KV
    heads, SwiGLU; minitron_4b: the two-matrix squared-ReLU MLP and a
    256,000-token vocabulary) at the deepest cut whose tables fit
    FAMILY_TABLE_BYTES (:func:`family_depth`), planned by the recipe,
    converted and served through ``BatchingEngine`` on the LUT kernels,
    graph and eager in turns, then on the plain versions
    (:func:`serve_recipe_cell`); prefill logits at the cut held kernel
    against plain; last, the decode-shape time of each LUT call beside its
    bound and the bf16 ``x @ W`` it replaces."""
    import torch

    from repro_torch.configs.base import get_config

    full = get_config(arch)
    layers, depth = family_depth(full)
    cfg, lut = recipe_cell(phase, full, depth)
    lone, grouped = FAMILY_CALLS[arch]
    per_forward = lut_calls_per_forward(lut, layers)
    want = {"lut_affine": lone * layers + 1, "lut_affine_grouped": grouped * layers,
            "bitplane_pack": (lone + grouped) * layers + 1}
    if per_forward != want:
        raise AssertionError(f"{phase}: the converted tree makes {per_forward} calls a "
                             f"forward, not {want}")
    prompts = serve_requests(cfg, requests)
    launches = serve_recipe_cell(phase, lut, cfg, per_forward, prompts, max_new, synced=True)
    recipe_prefill_logits(phase, lut, cfg, prompts, (layers,))
    recipe_layer_calls(phase, lut, iters)
    del lut
    torch.cuda.empty_cache()
    return {"launches": launches}


def vlm_len(cfg) -> int:
    """The VLM cell's cache length: image tokens, prompt and new tokens."""
    return cfg.num_image_tokens + VLM_PROMPT + VLM_NEW


def vlm_inputs(cfg, lut):
    """VLM_ROWS prompts of VLM_PROMPT tokens, each after its num_image_tokens
    image patch embeddings (the vision tower is a stub, as in the reference),
    from a numpy seed: the embeddings at the scale of the seeded embedding
    rows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(VLM_SEED)
    prompts = rng.integers(0, cfg.vocab_size, (VLM_ROWS, VLM_PROMPT)).astype(np.int32)
    scale = lut["embed"].std().item()
    embeds = rng.standard_normal((VLM_ROWS, cfg.num_image_tokens, cfg.d_model)) * scale
    return prompts, torch.from_numpy(embeds.astype(np.float32)).to(DEV)


def vlm_generate(lut, cfg, prompts, embeds, use_kernels=True, page_size=None):
    """Greedy ``generate(embeds=...)`` of VLM_NEW tokens (the head on the
    last position only, ``logits="last"``); returns (streams, wall ms)."""
    import torch

    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.serve import generate

    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True, use_kernels=use_kernels, logits="last"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = generate(lut, ctx, prompts, VLM_NEW, embeds=embeds, page_size=page_size,
                       device=DEV)
    streams = out.tolist()
    return streams, (time.perf_counter() - t0) * 1e3


def vlm_counted(phase, name, lut, cfg, prompts, embeds, per_forward, page_size=None):
    """One :func:`vlm_generate` on the kernels, its launch counts set to 0
    just before and read just after: ``per_forward`` of each kernel for
    each of its VLM_NEW forwards, no pack off the kernel, no table copy;
    emits a ``generate`` line and returns (streams, launches, wall ms)."""
    from repro_torch.kernels.lut_affine import ops as lut_ops

    reset_launches()
    streams, ms = vlm_generate(lut, cfg, prompts, embeds, page_size=page_size)
    launches, uncovered = read_launches(), plain_pack_codes_calls()
    copies = lut_ops.TABLE_COPIES["table_operand"]
    expect = {**no_launches(), **{k: v * VLM_NEW for k, v in per_forward.items()}}
    T = vlm_len(cfg)
    emit({"phase": phase, "step": "generate", "name": name, "rows": VLM_ROWS,
          "image_tokens": cfg.num_image_tokens, "prompt_tokens": VLM_PROMPT,
          "new_tokens": VLM_NEW, "cache_len": T, "page_size": page_size,
          "pages_per_row": page_size and T // page_size, "ms": ms,
          "tok_per_s": VLM_ROWS * VLM_NEW / (ms / 1e3), "forwards": VLM_NEW,
          "launches": launches, "expected_launches": expect,
          "plain_pack_codes_calls": uncovered, "table_copies": copies,
          "first_tokens": [row[0] for row in streams]})
    if launches != expect or uncovered or copies:
        raise AssertionError(f"{phase} {name}: launch counts {launches} != expected {expect}, "
                             f"or {uncovered} packs off the kernel, or {copies} table copies")
    if any(len(row) != VLM_NEW for row in streams):
        raise AssertionError(f"{phase} {name}: a row stopped short of {VLM_NEW} tokens")
    return streams, launches, ms


def vlm_prefill_logits(lut, cfg, inputs, depth: int, use_kernels: bool = True):
    """The prefill logits, every position, of the first ``depth`` layers
    into a fresh cache of :func:`vlm_len` slots."""
    import torch

    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.models.model import model_forward
    from repro_torch.serve import make_cache

    dcfg = dataclasses.replace(cfg, num_layers=depth)
    params = dict(lut, blocks=first_layers(lut["blocks"], depth))
    ctx = Ctx(dcfg, ex=ExecCfg(lut_grouped=True, use_kernels=use_kernels))
    cache = make_cache(dcfg, inputs["tokens"].shape[0], vlm_len(cfg), ctx, device=DEV)
    with torch.no_grad():
        return model_forward(params, inputs, ctx, cache=cache)[0]


def vlm_timing(lut, cfg, prompts, embeds) -> dict:
    """The main path's ``generate`` split into its prefill (VLM_TIMED
    prefills into fresh caches) and its VLM_NEW - 1 decode steps after the
    last, at a cache length of ~600, each on the host clock from a
    synchronize to a synchronize."""
    import torch

    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.serve import make_cache, make_decode_step, make_prefill_step

    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True, logits="last"))
    inputs = {"tokens": torch.from_numpy(prompts).to(DEV), "embeds": embeds}
    prefill, decode = make_prefill_step(ctx), make_decode_step(ctx)
    prefill_ms, decode_ms = [], []

    def timed(fn, out):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
        return res

    with torch.no_grad():
        for _ in range(VLM_TIMED):
            cache = make_cache(cfg, VLM_ROWS, vlm_len(cfg), ctx, device=DEV)
            logits, cache = timed(lambda: prefill(lut, inputs, cache), prefill_ms)
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        for _ in range(VLM_NEW - 1):
            tok, _, cache = timed(lambda: decode(lut, cache, tok), decode_ms)
    return {"prefill_ms": prefill_ms, "median_prefill_ms": statistics.median(prefill_ms),
            "decode_step_ms": decode_ms, "median_decode_step_ms": statistics.median(decode_ms),
            "cache_len_at_decode": [cfg.num_image_tokens + VLM_PROMPT + i
                                    for i in (0, VLM_NEW - 2)]}


def vlm_serve_phase(requests: int, max_new: int, iters: int) -> dict:
    """Full-width llava_next_mistral_7b (a dense GQA decoder, 32 heads to 8
    KV heads, whose prompt opens with 576 image patch embeddings) at the
    cut :func:`family_depth` computes, planned by the recipe with chunks
    capped at 1 and converted (:func:`recipe_cell`).  The engine serves the
    family text-only (a ``Request`` carries no image, as in the reference):
    the serve cell's requests, graph and eager in turns
    (:func:`serve_recipe_cell`, no plain run).  Then the image prefix
    through ``generate(embeds=...)`` on VLM_ROWS rows (:func:`vlm_inputs`):
    the main path dense and counted; its prefill and decode steps timed
    apart; prefill logits of VLM_PLAIN_ROWS x 608 positions kernel against
    plain at VLM_PLAIN_DEPTH layers; at the cut the prefix moving the text
    positions' logits; first tokens of all VLM_ROWS rows kernel against
    plain on the first VLM_SYNC_DEPTH layers with the plain path on
    the kernel path's codes at every pack site, which also holds every prefill pack of those layers bit
    for bit to its plain version; paged at PAGE_SIZE,
    whose streams a dense run on bf16-rounded K/V must serve whole; last,
    each LUT call of a layer at the decode shape and at the prefill's 2,432
    rows beside its bound."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.bitplane_pack import ops as pack_ops

    phase, arch = "vlm_serve", "llava_next_mistral_7b"
    full = get_config(arch)
    layers, depth = family_depth(full)
    cfg, lut = recipe_cell(phase, full, depth)
    lone, grouped = FAMILY_CALLS[arch]
    per_forward = lut_calls_per_forward(lut, layers)
    want = {"lut_affine": lone * layers + 1, "lut_affine_grouped": grouped * layers,
            "bitplane_pack": (lone + grouped) * layers + 1}
    if per_forward != want:
        raise AssertionError(f"{phase}: the converted tree makes {per_forward} calls a "
                             f"forward, not {want}")
    engine = serve_recipe_cell(phase, lut, cfg, per_forward, serve_requests(cfg, requests),
                               max_new, plain=False)

    torch.cuda.reset_peak_memory_stats()
    t_gen = time.perf_counter()
    prompts, embeds = vlm_inputs(cfg, lut)
    a, launches, a_ms = vlm_counted(phase, "a_dense", lut, cfg, prompts, embeds, per_forward)
    timing = vlm_timing(lut, cfg, prompts, embeds)
    emit({"phase": phase, "step": "generate_timing", **timing, "generate_ms": a_ms,
          "prefill_share_of_generate": timing["median_prefill_ms"] / a_ms,
          "nvidia_smi": smi_line()})

    # prefill logits: kernel against plain at VLM_PLAIN_DEPTH layers; the
    # image prefix moving the text positions' logits at the cut
    inputs = {"tokens": torch.from_numpy(prompts).to(DEV), "embeds": embeds}
    some = {k: v[:VLM_PLAIN_ROWS] for k, v in inputs.items()}
    got = vlm_prefill_logits(lut, cfg, some, VLM_PLAIN_DEPTH)
    ref = vlm_prefill_logits(lut, cfg, some, VLM_PLAIN_DEPTH, use_kernels=False)
    res = compare_logits(got, ref)
    finite = bool(torch.isfinite(got).all().item())
    tol = LOGITS_TOL * res["max_abs_ref"]
    emit({"phase": phase, "step": "prefill_logits", "layers": VLM_PLAIN_DEPTH,
          "rows": VLM_PLAIN_ROWS, "shape": list(got.shape), **res, "tol": tol,
          "rel_fro_tol": LOGITS_FRO_TOL, "finite": finite,
          "depth_reason": "the plain versions gather each call's table rows for every "
          "position (~23 s a layer at 4 rows); the first tokens below hold all 4 rows "
          "synchronized, every prefill site's input and pack",
          "tol_reason": "as the serve phase's: each projection re-quantizes its input"})
    if not (finite and res["max_abs_err"] <= tol and res["rel_fro_err"] <= LOGITS_FRO_TOL):
        raise AssertionError(f"{phase}: prefill logits differ: {res} (tol {tol}, "
                             f"{LOGITS_FRO_TOL})")
    del got, ref
    S_img = cfg.num_image_tokens
    with_image = vlm_prefill_logits(lut, cfg, inputs, layers)[:, S_img:]
    text_only = vlm_prefill_logits(lut, cfg, {"tokens": inputs["tokens"]}, layers)
    moved = compare_logits(with_image, text_only)
    finite = bool(torch.isfinite(with_image).all().item())
    emit({"phase": phase, "step": "image_prefix", "layers": layers, "shape":
          list(with_image.shape), "finite": finite, "with_against_without": moved,
          "last_position_argmax": with_image[:, -1].argmax(-1).tolist(),
          "generate_first_tokens": [row[0] for row in a], "min_rel_fro": LOGITS_FRO_TOL})
    if not (finite and moved["rel_fro_err"] > LOGITS_FRO_TOL):
        raise AssertionError(f"{phase}: the image prefix does not move the logits: {moved}")
    del with_image, text_only

    # first tokens, the plain path on the kernel path's codes at every site,
    # on the first VLM_SYNC_DEPTH layers of the cut
    sync_cfg = dataclasses.replace(cfg, num_layers=VLM_SYNC_DEPTH)
    sync_lut = dict(lut, blocks=first_layers(lut["blocks"], VLM_SYNC_DEPTH))
    with pack_tape() as tape:
        k, _ = vlm_generate(sync_lut, sync_cfg, prompts, embeds)
    with pack_tape(tape) as seen:
        p, plain_ms = vlm_generate(sync_lut, sync_cfg, prompts, embeds, use_kernels=False)
    site_err = [((x - x_ref).abs().max() / x_ref.abs().max()).item()
                for (x, *_), (x_ref, *_) in zip(seen, tape)]
    del seen
    # the prefill's sites decide the first tokens; the decode steps' attend
    # over K/V that each path rounded to bf16 on its own
    n_prefill = (lone + grouped) * VLM_SYNC_DEPTH + 1
    prefill_err, decode_err = max(site_err[:n_prefill]), max(site_err[n_prefill:])
    first_ok = [r[0] for r in k] == [r[0] for r in p] and prefill_err <= SYNCED_TOL
    emit({"phase": phase, "step": "first_tokens", "synced_identical": first_ok,
          "layers": VLM_SYNC_DEPTH, "rows": VLM_ROWS,
          "depth_reason": "the plain versions take ~23 s a layer at the prefill's 2,432 "
          "rows; the first layer of the cut keeps the full call within "
          "two thirds of its time limit beside the rwkv_serve and train phases",
          "kernel": [r[0] for r in k], "plain_synced": [r[0] for r in p],
          "streams_identical_synced": k == p,
          "prefill_site_input_rel_err": prefill_err, "tol": SYNCED_TOL,
          "decode_site_input_rel_err": decode_err,
          "decode_reason": "a decode step attends over the bf16 cache, whose K/V each path "
                           "rounded from its own fp32 sums: a value at a bf16 rounding "
                           "boundary takes the neighbouring value in one of them",
          "plain_generate_ms": plain_ms, "sites": len(tape)})
    if not first_ok:
        raise AssertionError(f"{phase}: kernel and plain first tokens differ on the same "
                             f"codes, or a prefill site's input is {prefill_err} x max off")
    # every prefill pack of the kernel run against its plain version, bit for
    # bit; layer 0's five packs timed
    prefill_sites = tape[:n_prefill]
    for i, (x, codes, plan) in enumerate(prefill_sites):
        if not torch.equal(pack_ops.pack(x, plan, use_kernels=False), codes):
            raise AssertionError(f"{phase}: prefill pack site {i} differs from its plain version")
    packs = {"kernel_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for i, (x, codes, plan) in enumerate(prefill_sites[:lone + grouped]):
        r, _ = run_pack_case(x, iters, 3, **pack_ops.kernel_args(plan))
        emit({"phase": phase, "step": "pack", "site": i, "shape": list(x.shape), **r})
        for key in packs:
            packs[key] += r[key]
    emit({"phase": phase, "step": "pack_layer", "rows": VLM_ROWS * (S_img + VLM_PROMPT),
          "sites_checked": len(prefill_sites), "max_abs_err": 0, **packs})
    del tape, prefill_sites

    # paged at PAGE_SIZE, against a dense run on bf16-rounded K/V
    b, _, _ = vlm_counted(phase, "b_paged", lut, cfg, prompts, embeds, per_forward,
                          page_size=PAGE_SIZE)
    with bf16_attention_inputs():
        f, f_ms = vlm_generate(lut, cfg, prompts, embeds)
    checks = {"dense_bf16_kv_streams_identical_b": f == b}
    emit({"phase": phase, "step": "paged_checks", **checks, "f_ms": f_ms,
          "tokens_agreeing_a_b_per_row": [sum(x == y for x, y in zip(r, q))
                                          for r, q in zip(a, b)],
          "first_tokens": {"a": [r[0] for r in a], "b": [r[0] for r in b],
                           "f": [r[0] for r in f]},
          "seconds": time.perf_counter() - t_gen,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
    failed = [key for key, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{phase}: failed paged checks {failed}")

    recipe_layer_calls(phase, lut, iters)
    recipe_layer_calls(phase, lut, VLM_PREFILL_ITERS, rows=VLM_ROWS * (S_img + VLM_PROMPT),
                       plain=False)
    del lut
    torch.cuda.empty_cache()
    return {"launches": engine, "generate_launches": launches}


def rwkv_seed_leaves(params) -> dict:
    """Redraw, in place, the raw leaves ``init_params`` zeroes in an RWKV
    tree (at zero the token shift multiplies the carried state by 0 and the
    bonus vanishes, so a wrong carry would show nothing): ``mu_*`` ~ U(0,
    1), ``u`` ~ N(0, 0.5), ``decay_base`` ~ U(-6, 1), from RWKV_SEED on the
    card.  They are raw leaves, which the plan and the conversion leave as
    they are; both paths run the same tree, so they get the same values."""
    import torch

    gen = torch.Generator(device=DEV).manual_seed(RWKV_SEED)
    time_mix = params["blocks"]["time"]
    for part in (time_mix, params["blocks"]["channel"]):
        for name, leaf in part.items():
            if name.startswith("mu_"):
                leaf.copy_(torch.rand(leaf.shape, generator=gen, device=DEV))
    time_mix["u"].copy_(0.5 * torch.randn(time_mix["u"].shape, generator=gen, device=DEV))
    base = time_mix["decay_base"]
    base.copy_(7.0 * torch.rand(base.shape, generator=gen, device=DEV) - 6.0)
    return {"mu_*": "U(0, 1)", "u": "N(0, 0.5)", "decay_base": "U(-6, 1)",
            "seed": RWKV_SEED, "reason": "init_params zeroes them: a wrong token-shift "
            "carry or bonus would show nothing; both paths run these values"}


def seeded_tokens(cfg, rows: int, length: int, seed: int):
    """(rows, length) int32 seeded tokens on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (rows, length)).astype(np.int32)).to(DEV)


def greedy_generate(lut, cfg, prompts, max_new: int, use_kernels: bool = True, **kw):
    """Greedy ``generate`` of ``max_new`` tokens (the head on the last
    position, ``logits="last"``; each pre-stacked group one grouped launch;
    ``kw``: further ``generate`` arguments); returns (streams, wall ms)."""
    import torch

    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.serve import generate

    ctx = Ctx(cfg, ex=ExecCfg(use_kernels=use_kernels, logits="last", lut_grouped=True))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = generate(lut, ctx, prompts, max_new, device=DEV, **kw)
    streams = out.tolist()
    return streams, (time.perf_counter() - t0) * 1e3


def timed_steps(lut, cfg, prompt_sets, steps: int, prefills: int = 1) -> list:
    """For each of ``prompt_sets``, ``prefills`` prefills into fresh caches;
    then ``steps`` eager decode steps on each set's last cache, one step of
    each set in turn (so that the host's drift falls on all of them alike),
    each on the host clock from a synchronize to a synchronize (the steps of
    ``generate``).  One dict of times per set."""
    import torch

    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.serve import make_cache, make_decode_step, make_prefill_step

    ctx = Ctx(cfg, ex=ExecCfg(logits="last", lut_grouped=True))
    prefill, decode = make_prefill_step(ctx), make_decode_step(ctx)

    def timed(fn, out):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
        return res

    runs = []
    with torch.no_grad():
        for prompts in prompt_sets:
            B, S = prompts.shape
            run = {"prompt_tokens": S, "prefill_ms": [], "decode_step_ms": []}
            for _ in range(prefills):
                cache = make_cache(cfg, B, S + steps, ctx, device=DEV)
                logits, cache = timed(lambda: prefill(lut, {"tokens": prompts}, cache),
                                      run["prefill_ms"])
            run["state"] = [cache, logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)]
            runs.append(run)
        for _ in range(steps):
            for run in runs:
                cache, tok = run["state"]
                tok, _, cache = timed(lambda: decode(lut, cache, tok), run["decode_step_ms"])
                run["state"] = [cache, tok]
    for run in runs:
        del run["state"]
        run["median_prefill_ms"] = statistics.median(run["prefill_ms"])
        run["median_decode_step_ms"] = (statistics.median(run["decode_step_ms"])
                                        if steps else None)
    return runs


def cut_tree(lut, depth: int) -> dict:
    """A converted model's tree at its first ``depth`` stacked layers
    (``blocks``, or the hybrid's ``mamba``; a hybrid's shared block, held
    once, stays whole)."""
    stack = "mamba" if "mamba" in lut else "blocks"
    return dict(lut, **{stack: first_layers(lut[stack], depth)})


def cut_logits(lut, cfg, tokens, depth: int, use_kernels: bool = True, cache_len=None):
    """The logits of every position of ``tokens`` through the first
    ``depth`` layers (:func:`cut_tree`), into a fresh (bf16) cache of
    ``cache_len`` slots or, without ``cache_len``, with no cache."""
    import torch

    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.models.model import model_forward
    from repro_torch.serve import make_cache

    dcfg = dataclasses.replace(cfg, num_layers=depth)
    params = cut_tree(lut, depth)
    ctx = Ctx(dcfg, ex=ExecCfg(use_kernels=use_kernels, lut_grouped=True))
    cache = None
    if cache_len is not None:
        cache = make_cache(dcfg, tokens.shape[0], cache_len, ctx, device=DEV)
    with torch.no_grad():
        return model_forward(params, {"tokens": tokens}, ctx, cache=cache)[0]


def state_across_calls(lut, cfg, tokens, dtype, fed: int) -> dict:
    """A prefill of all but the last ``fed`` tokens into a cache of
    ``dtype``, then those tokens fed one decode step each: the logits at
    their positions against one chunked forward over the whole sequence
    without a cache, on the kernels."""
    import torch

    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.serve import make_cache, make_decode_step, make_prefill_step

    B, S = tokens.shape
    n = S - fed
    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True))
    cache = make_cache(cfg, B, S, ctx, dtype=dtype, device=DEV)
    prefill, decode = make_prefill_step(ctx), make_decode_step(ctx)
    with torch.no_grad():
        _, cache = prefill(lut, {"tokens": tokens[:, :n]}, cache)
        got = []
        for t in range(n, S):
            _, logits, cache = decode(lut, cache, tokens[:, t:t + 1])
            got.append(logits[:, -1])
    got = torch.stack(got, 1)
    want = cut_logits(lut, cfg, tokens, cfg.num_layers)[:, n:]
    res = compare_logits(got, want)
    per_position = ((got - want).norm(dim=(0, 2)) / want.norm(dim=(0, 2))).tolist()
    return {"cache_dtype": str(dtype).split(".")[-1], **res,
            "rel_fro_err_per_position": per_position,
            "finite": bool(torch.isfinite(got).all().item()),
            "index": cache["index"].tolist()}


def synced_generate(phase: str, lut, cfg, prompts, max_new: int, n_prefill: int,
                    decode_reason: str) -> None:
    """First tokens of ``generate`` at the cut, kernel against plain with
    the plain path on the kernel path's codes at every pack site: every
    prefill site's input (the first ``n_prefill``) within SYNCED_TOL x max
    of the kernel path's and every prefill pack bit for bit with its plain
    version; the decode sites' inputs, which read state each path carried
    on its own, reported (``decode_reason``).  Emits a ``first_tokens``
    line; raises when a first token, a prefill site or a pack differs."""
    import torch

    from repro_torch.kernels.bitplane_pack import ops as pack_ops

    with pack_tape() as tape:
        k, _ = greedy_generate(lut, cfg, prompts, max_new)
    with pack_tape(tape) as seen:
        p, plain_ms = greedy_generate(lut, cfg, prompts, max_new, use_kernels=False)
    site_err = [((x - x_ref).abs().max() / x_ref.abs().max()).item()
                for (x, *_), (x_ref, *_) in zip(seen, tape)]
    del seen
    prefill_err = max(site_err[:n_prefill])
    decode_err = max(site_err[n_prefill:]) if len(site_err) > n_prefill else None
    bad_packs = [i for i, (x, codes, plan) in enumerate(tape[:n_prefill])
                 if not torch.equal(pack_ops.pack(x, plan, use_kernels=False), codes)]
    first_ok = ([r[0] for r in k] == [r[0] for r in p] and prefill_err <= SYNCED_TOL
                and not bad_packs)
    emit({"phase": phase, "step": "first_tokens", "synced_identical": first_ok,
          "layers": cfg.num_layers, "kernel": [r[0] for r in k],
          "plain_synced": [r[0] for r in p], "streams_identical_synced": k == p,
          "new_tokens": max_new, "prefill_site_input_rel_err": prefill_err,
          "tol": SYNCED_TOL, "prefill_packs_bit_for_bit": not bad_packs,
          "prefill_sites": n_prefill, "decode_site_input_rel_err": decode_err,
          "decode_reason": decode_reason, "plain_generate_ms": plain_ms, "sites": len(tape)})
    if not first_ok:
        raise AssertionError(f"{phase}: kernel and plain first tokens differ on the same "
                             f"codes, a prefill site's input is {prefill_err} x max off, or "
                             f"prefill packs {bad_packs} differ from their plain version")


def synced_state_across_calls(lut, cfg, tokens, dtype, fed: int) -> dict:
    """A prefill of all but the last ``fed`` tokens into a cache of
    ``dtype``, then those tokens fed one decode step each, on the kernels,
    with each pack site given the codes of its rows from one chunked forward
    over the whole sequence (so that no fp16 code rounds the other way and
    sets the two apart, as the phase's prefill logits show they would): the
    largest distance of a site's own input from the forward's at the same
    rows, over the prefill's sites and over the decode steps'; beside it
    :func:`state_across_calls`, without the codes given (reported)."""
    import torch

    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.serve import make_cache, make_decode_step, make_prefill_step

    B, S = tokens.shape
    n = S - fed
    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True))
    prefill, decode = make_prefill_step(ctx), make_decode_step(ctx)
    with pack_tape() as tape:
        cut_logits(lut, cfg, tokens, cfg.num_layers)
    windows = [(0, n)] + [(t, t + 1) for t in range(n, S)]
    rows = [(x[:, lo:hi], codes[:, lo:hi], plan) for lo, hi in windows
            for x, codes, plan in tape]
    cache = make_cache(cfg, B, S, ctx, dtype=dtype, device=DEV)
    with torch.no_grad(), pack_tape(rows) as seen:
        _, cache = prefill(lut, {"tokens": tokens[:, :n]}, cache)
        for t in range(n, S):
            _, logits, cache = decode(lut, cache, tokens[:, t:t + 1])
    err = [((x - x_ref).abs().max() / x_ref.abs().max()).item()
           for (x, *_), (x_ref, *_) in zip(seen, rows)]
    unsynced = state_across_calls(lut, cfg, tokens, dtype, fed)
    return {"cache_dtype": str(dtype).split(".")[-1], "site_input_rel_err": max(err),
            "prefill_site_input_rel_err": max(err[:len(tape)]),
            "decode_site_input_rel_err": max(err[len(tape):]), "sites": len(err),
            "finite": unsynced["finite"], "index": cache["index"].tolist(),
            "unsynced": {k: unsynced[k] for k in ("max_abs_err", "max_abs_ref",
                                                   "rel_fro_err", "argmax_agree")}}


def eager_decode_profile(lut, cfg, prompts, steps: int = 4, enc_embeds=None) -> dict:
    """torch.profiler over ``steps`` eager decode steps of ``generate``'s
    kind after a prefill of ``prompts`` (an enc-dec model's with its
    ``enc_embeds``) and one untimed step: device kernels per step split
    into LUT kernels (``lut_affine``'s decode, prefill and split-sum
    kernels), packs and PyTorch's own, with their busy ms and the idle
    share of the host-clock wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.serve import make_cache, make_decode_step, make_prefill_step

    ctx = Ctx(cfg, ex=ExecCfg(logits="last", lut_grouped=True))
    prefill, decode = make_prefill_step(ctx), make_decode_step(ctx)
    B, S = prompts.shape
    inputs = {"tokens": prompts}
    enc_len = None
    if enc_embeds is not None:
        inputs["enc_embeds"], enc_len = enc_embeds, enc_embeds.shape[1]
    with torch.no_grad():
        cache = make_cache(cfg, B, S + steps + 1, ctx, device=DEV, enc_len=enc_len)
        logits, cache = prefill(lut, inputs, cache)
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        tok, _, cache = decode(lut, cache, tok)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            for _ in range(steps):
                tok, _, cache = decode(lut, cache, tok)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - start) * 1e3
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    if not kernels:
        raise AssertionError("the profiler recorded no kernel")
    lut_names = ("decode_kernel", "prefill_kernel", "sum_splits")
    groups = {"lut": [e for e in kernels if any(n in e.key for n in lut_names)],
              "pack": [e for e in kernels if "pack_kernel" in e.key]}
    groups["pytorch"] = [e for e in kernels if e not in groups["lut"] + groups["pack"]]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(groups["pytorch"], key=lambda e: -e.count)[:10]
    return {
        "steps": steps, "wall_ms_per_step": wall_ms / steps, "busy_ms_per_step": busy / steps,
        "idle_share": 1.0 - busy / wall_ms,
        "device_kernels_per_step": sum(e.count for e in kernels) / steps,
        **{f"{name}_kernels_per_step": sum(e.count for e in g) / steps
           for name, g in groups.items()},
        **{f"{name}_ms_per_step": sum(e.self_device_time_total for e in g) / 1e3 / steps
           for name, g in groups.items()},
        "pytorch_kernels_by_count": {e.key[:60]: e.count / steps for e in top},
    }


def rwkv_serve_phase(iters: int) -> dict:
    """Full-width rwkv6_3b (RWKV-6: attention-free, a data-dependent decay,
    an O(1) recurrent state a request) at the cut :func:`family_depth`
    computes, its zeroed raw leaves seeded (:func:`rwkv_seed_leaves`),
    planned by the recipe with chunks capped at 1 and converted
    (:func:`recipe_cell`): eight lone LUT projections a layer, each after
    its own pack, and the untied head.  Served through ``generate()`` alone
    (``BatchingEngine`` refuses a recurrent state, as the reference's does):
    the refusals first; the main path (RWKV_ROWS x RWKV_PROMPT prompt
    tokens, RWKV_NEW new) counted, after one untimed short generate; its
    prefill and decode steps timed apart; the O(1) check (the decode step
    after RWKV_SHORT and after RWKV_PROMPT prompt tokens, in turns) and the
    odd-length prefill timed; prefill
    logits of the main traffic kernel against plain at RWKV_PLAIN_DEPTH
    layers, and a layer's packs at its rows; first tokens of the short
    traffic at the cut kernel against plain with the plain path on the
    kernel path's codes at every pack site; the state across calls (a
    cached prefill and decode against one chunked forward); a profile of
    the eager decode step; last each LUT call of a layer at the decode
    shape (held to plain) and at the prefill's rows (timed)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.bitplane_pack import ops as pack_ops
    from repro_torch.kernels.lut_affine import ops as lut_ops
    from repro_torch.models.layers import Ctx
    from repro_torch.serve import BatchingEngine

    phase, arch = "rwkv_serve", "rwkv6_3b"
    full = get_config(arch)
    layers, depth = family_depth(full)
    cfg, lut = recipe_cell(phase, full, depth)
    emit({"phase": phase, "step": "seeded_leaves", **rwkv_seed_leaves(lut)})
    lone, grouped = FAMILY_CALLS[arch]
    per_forward = lut_calls_per_forward(lut, layers)
    want = {"lut_affine": lone * layers + 1, "lut_affine_grouped": grouped * layers,
            "bitplane_pack": (lone + grouped) * layers + 1}
    if per_forward != want:
        raise AssertionError(f"{phase}: the converted tree makes {per_forward} calls a "
                             f"forward, not {want}")

    # the refusals, before any launch
    prompts = seeded_tokens(cfg, RWKV_ROWS, RWKV_PROMPT, RWKV_SEED)
    reset_launches()
    refused = {}
    for name, exc, call in (
            ("generate_page_size", ValueError,
             lambda: greedy_generate(lut, cfg, prompts, RWKV_NEW, page_size=PAGE_SIZE)),
            ("batching_engine", NotImplementedError,
             lambda: BatchingEngine(lut, Ctx(cfg), SLOTS, MAX_LEN, device=DEV))):
        try:
            call()
        except exc as e:
            refused[name] = f"{type(e).__name__}: {e}"
    launched = {k: v for k, v in read_launches().items() if v}
    emit({"phase": phase, "step": "refusals", **refused, "launches": launched})
    if len(refused) != 2 or launched:
        raise AssertionError(f"{phase}: refusals {refused}, launches before them {launched}")

    # the main path: generate() on the kernels, counted, after one untimed
    # short generate (the first launch of each kernel loads its module)
    short = seeded_tokens(cfg, RWKV_ROWS, RWKV_SHORT + RWKV_SHORT_NEW, RWKV_SEED + 1)
    short_prompts = short[:, :RWKV_SHORT]
    greedy_generate(lut, cfg, short_prompts, 2)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    streams, gen_ms = greedy_generate(lut, cfg, prompts, RWKV_NEW)
    launches, uncovered = read_launches(), plain_pack_codes_calls()
    copies = lut_ops.TABLE_COPIES["table_operand"]
    expect = {**no_launches(), **{k: v * RWKV_NEW for k, v in per_forward.items()}}
    mib = 2**20
    state_bytes = layers * RWKV_ROWS * (cfg.rwkv_heads * cfg.rwkv_head_dim**2 + 2 * cfg.d_model) * 4
    emit({"phase": phase, "step": "generate", "rows": RWKV_ROWS,
          "prompt_tokens": RWKV_PROMPT, "new_tokens": RWKV_NEW, "ms": gen_ms,
          "tok_per_s": RWKV_ROWS * RWKV_NEW / (gen_ms / 1e3), "forwards": RWKV_NEW,
          "launches": launches, "expected_launches": expect,
          "plain_pack_codes_calls": uncovered, "table_copies": copies,
          "state_mib": state_bytes / mib,
          "state_mib_per_request_and_layer": state_bytes / layers / RWKV_ROWS / mib,
          "table_mib": depth["table_mib"],
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
          "first_tokens": [row[0] for row in streams]})
    if launches != expect or uncovered or copies:
        raise AssertionError(f"{phase}: launch counts {launches} != expected {expect}, "
                             f"or {uncovered} packs off the kernel, or {copies} table copies")
    if any(len(row) != RWKV_NEW for row in streams):
        raise AssertionError(f"{phase}: a row stopped short of {RWKV_NEW} tokens")

    # the generate call split into its prefill and decode steps, beside the
    # same steps after the short prompts (the O(1) check); the odd-length
    # prefill (chunk 1)
    timing, after_short = timed_steps(lut, cfg, (prompts, short_prompts), RWKV_NEW - 1,
                                     prefills=RWKV_TIMED)
    emit({"phase": phase, "step": "generate_timing", **timing, "generate_ms": gen_ms,
          "prefill_share_of_generate": timing["median_prefill_ms"] / gen_ms,
          "nvidia_smi": smi_line()})
    odd, = timed_steps(lut, cfg, (prompts[:, :RWKV_ODD],), 0)
    emit({"phase": phase, "step": "o1_check",
          "median_decode_step_ms": {RWKV_SHORT: after_short["median_decode_step_ms"],
                                    RWKV_PROMPT: timing["median_decode_step_ms"]},
          "decode_step_ms_after_short": after_short["decode_step_ms"],
          "ratio_long_to_short": timing["median_decode_step_ms"]
          / after_short["median_decode_step_ms"],
          "steps_interleaved": True,
          "odd_prefill": {"prompt_tokens": RWKV_ODD, "chunk": 1, "prefill_ms": odd["prefill_ms"],
                          "against_even_prefill_ms": timing["median_prefill_ms"]}})

    # prefill logits of the main traffic, kernel against plain, at
    # RWKV_PLAIN_DEPTH layers; the kernel run's packs recorded
    cache_len = RWKV_PROMPT + RWKV_NEW
    with pack_tape() as tape:
        got = cut_logits(lut, cfg, prompts, RWKV_PLAIN_DEPTH, cache_len=cache_len)
    ref = cut_logits(lut, cfg, prompts, RWKV_PLAIN_DEPTH, use_kernels=False,
                      cache_len=cache_len)
    res = compare_logits(got, ref)
    finite = bool(torch.isfinite(got).all().item())
    tol = LOGITS_TOL * res["max_abs_ref"]
    emit({"phase": phase, "step": "prefill_logits", "layers": RWKV_PLAIN_DEPTH,
          "shape": list(got.shape), **res, "tol": tol, "rel_fro_tol": LOGITS_FRO_TOL,
          "finite": finite, "depth_reason": "the plain versions gather each call's table rows "
          "for all 2,048 rows; the first tokens below hold the cut synchronized",
          "tol_reason": "as the serve phase's: each projection re-quantizes its input"})
    if not (finite and res["max_abs_err"] <= tol and res["rel_fro_err"] <= LOGITS_FRO_TOL):
        raise AssertionError(f"{phase}: prefill logits differ: {res} (tol {tol}, "
                             f"{LOGITS_FRO_TOL})")
    del got, ref
    # a layer's packs at the prefill's rows, bit for bit and timed
    packs = {"kernel_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for i, (x, codes, plan) in enumerate(tape[:lone + grouped]):
        r, got_codes = run_pack_case(x, iters, 3, **pack_ops.kernel_args(plan))
        if not torch.equal(got_codes, codes):
            raise AssertionError(f"{phase}: pack site {i} differs from the recorded codes")
        emit({"phase": phase, "step": "pack", "site": i, "shape": list(x.shape), **r})
        for key in packs:
            packs[key] += r[key]
    emit({"phase": phase, "step": "pack_layer", "rows": RWKV_ROWS * RWKV_PROMPT,
          "packs": lone + grouped, "max_abs_err": 0, **packs})
    del tape

    # first tokens of the short traffic at the cut, the plain path on the
    # kernel path's codes at every pack site
    synced_generate(phase, lut, cfg, short_prompts, RWKV_SHORT_NEW,
                    per_forward["bitplane_pack"],
                    "a decode step mixes in the fp32 recurrent state each path carried "
                    "from its own fp32 sums")

    # the state across calls: prefill then decode through the cache against
    # one chunked forward, on the default bf16 cache (gated) and on fp32
    across = {str(dt).split(".")[-1]: state_across_calls(lut, cfg, short, dt, RWKV_SHORT_NEW)
              for dt in (torch.bfloat16, torch.float32)}
    gate = across["bfloat16"]
    emit({"phase": phase, "step": "state_across_calls", "prefill_tokens": RWKV_SHORT,
          "decode_tokens": RWKV_SHORT_NEW, "tol": RWKV_STATE_TOL, **across})
    if not (gate["finite"] and gate["rel_fro_err"] <= RWKV_STATE_TOL):
        raise AssertionError(f"{phase}: the cached decode is {gate['rel_fro_err']} from one "
                             f"chunked forward (tol {RWKV_STATE_TOL})")

    emit({"phase": phase, "step": "decode_profile_eager",
          **eager_decode_profile(lut, cfg, short_prompts), "nvidia_smi": smi_line()})
    parts = ("time", "channel")
    recipe_layer_calls(phase, lut, iters, parts=parts)
    recipe_layer_calls(phase, lut, RWKV_PREFILL_ITERS, parts=parts,
                       rows=RWKV_ROWS * RWKV_PROMPT, plain=False)
    emit({"phase": phase, "step": "memory",
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
    del lut
    torch.cuda.empty_cache()
    return {"launches": launches}


def hybrid_seed_leaves(params) -> dict:
    """Redraw, in place, the raw SSD leaves ``init_params`` zeroes in a
    hybrid tree (at zero every head decays at A = -1 with one step size)
    from HYBRID_SEED on the card, as Mamba-2's published initialisation
    draws them: A ~ U[1, 16] with ``A_log = log A``; dt log-uniform in
    [1e-3, 1e-1] with ``dt_bias = dt + log(-expm1(-dt))``, the inverse of
    the softplus the block applies.  Raw leaves, which the plan and the
    conversion leave as they are; both paths run the same tree."""
    import torch

    gen = torch.Generator(device=DEV).manual_seed(HYBRID_SEED)
    mix = params["mamba"]["mix"]
    shape = mix["A_log"].shape
    mix["A_log"].copy_(torch.log(1.0 + 15.0 * torch.rand(shape, generator=gen, device=DEV)))
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + (hi - lo) * torch.rand(shape, generator=gen, device=DEV))
    mix["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))
    return {"A": "U[1, 16], A_log = log A", "dt": "log-uniform in [1e-3, 1e-1]",
            "dt_bias": "dt + log(-expm1(-dt))", "seed": HYBRID_SEED,
            "reason": "init_params zeroes A_log and dt_bias (every head would decay at "
            "A = -1 with one step size); Mamba-2's published initialisation; both paths "
            "run these values"}


def hybrid_serve_phase(iters: int) -> dict:
    """Full-width zamba2_1_2b (Mamba-2 SSD layers and one shared attention +
    MLP block invoked every 6, its K/V cached per invocation) at the cut
    :func:`family_depth` computes (all 38 layers), its zeroed SSD leaves
    seeded (:func:`hybrid_seed_leaves`), planned by the recipe with chunks
    capped at 1 and converted (:func:`recipe_cell`): ``in_proj`` and
    ``out_proj`` lone a layer, the shared block's ``wq+wk+wv`` (G = 3) and
    ``w_gate+w_up`` grouped, ``wo`` and ``w_down`` lone, and the untied
    head.  Served through ``generate()`` alone (``BatchingEngine`` refuses
    a recurrent state, as the reference's does): the refusals first; the
    main path (HYBRID_ROWS x HYBRID_PROMPT prompt tokens, HYBRID_NEW new)
    counted, after one untimed short generate; its prefill and decode steps
    timed apart, beside the decode step after HYBRID_SHORT prompt tokens
    (in turns) and an odd prefill of HYBRID_ODD tokens (chunk 1); prefill
    logits at HYBRID_PLAIN_DEPTH layers (six mamba layers and the first
    shared invocation) kernel against plain, every pack of that run bit for
    bit; first tokens of the short traffic at the cut kernel against plain
    on the kernel path's codes; the state across calls; a profile of the
    eager decode step; each LUT call of a mamba layer, of the shared block
    and the head at the decode shape (held to plain) and at the prefill's
    rows (timed), and the G = 3 group held to plain at both."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.convert import LUTGroup
    from repro_torch.core.lut import pack_codes
    from repro_torch.kernels.bitplane_pack import ops as pack_ops
    from repro_torch.kernels.lut_affine import ops as lut_ops
    from repro_torch.models.hybrid import segments
    from repro_torch.models.layers import Ctx, _host_scales
    from repro_torch.models.model import model_forward
    from repro_torch.serve import BatchingEngine
    from repro_torch.serve._cache import cache_specs

    phase, arch = "hybrid_serve", "zamba2_1_2b"
    full = get_config(arch)
    layers, depth = family_depth(full)
    if layers != full.num_layers:
        raise AssertionError(f"{phase}: the cut is {layers} of {full.num_layers} layers")
    cfg, lut = recipe_cell(phase, full, depth)
    emit({"phase": phase, "step": "seeded_leaves", **hybrid_seed_leaves(lut)})
    shared = len(segments(cfg)) - 1
    qkv, gate_up = lut["shared"]["attn"].get("wq+wk+wv"), lut["shared"]["mlp"].get("w_gate+w_up")
    if not (isinstance(qkv, LUTGroup) and qkv.tables.shape[0] == 3
            and isinstance(gate_up, LUTGroup) and qkv.plan.table_format == "i8"
            and qkv.plan.shift_bits):
        raise AssertionError(f"{phase}: the shared block's groups are not the G = 3 i8 "
                             "shift wq+wk+wv and w_gate+w_up")
    per_forward = lut_calls_per_forward(lut, layers, shared=shared)
    want = {"lut_affine": 2 * layers + 2 * shared + 1, "lut_affine_grouped": 2 * shared,
            "bitplane_pack": 2 * layers + 4 * shared + 1}
    if per_forward != want:
        raise AssertionError(f"{phase}: the converted tree makes {per_forward} calls a "
                             f"forward, not {want}")

    # the refusals, before any launch
    prompts = seeded_tokens(cfg, HYBRID_ROWS, HYBRID_PROMPT, HYBRID_SEED)
    mask = torch.ones(prompts.shape, dtype=torch.bool, device=DEV)
    reset_launches()
    refused = {}
    for name, exc, call in (
            ("generate_page_size", ValueError,
             lambda: greedy_generate(lut, cfg, prompts, HYBRID_NEW, page_size=PAGE_SIZE)),
            ("batching_engine", NotImplementedError,
             lambda: BatchingEngine(lut, Ctx(cfg), SLOTS, MAX_LEN, device=DEV)),
            ("token_mask", NotImplementedError,
             lambda: model_forward(lut, {"tokens": prompts, "token_mask": mask}, Ctx(cfg)))):
        try:
            call()
        except exc as e:
            refused[name] = f"{type(e).__name__}: {e}"
    launched = {k: v for k, v in read_launches().items() if v}
    emit({"phase": phase, "step": "refusals", **refused, "launches": launched})
    if len(refused) != 3 or launched:
        raise AssertionError(f"{phase}: refusals {refused}, launches before them {launched}")

    # the main path: generate() on the kernels, counted, after one untimed
    # short generate (the first launch of each kernel loads its module)
    short = seeded_tokens(cfg, HYBRID_ROWS, HYBRID_SHORT + HYBRID_SHORT_NEW, HYBRID_SEED + 1)
    short_prompts = short[:, :HYBRID_SHORT]
    greedy_generate(lut, cfg, short_prompts, 2)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    streams, gen_ms = greedy_generate(lut, cfg, prompts, HYBRID_NEW)
    launches, uncovered = read_launches(), plain_pack_codes_calls()
    copies = lut_ops.TABLE_COPIES["table_operand"]
    expect = {**no_launches(), **{k: v * HYBRID_NEW for k, v in per_forward.items()}}
    mib = 2**20
    specs = cache_specs(cfg, HYBRID_ROWS, HYBRID_PROMPT + HYBRID_NEW)
    nbytes = {part: sum(math.prod(t.shape) * (t.dtype or torch.bfloat16).itemsize
                        for t in specs[part].values()) for part in ("layers", "shared_attn")}
    emit({"phase": phase, "step": "generate", "rows": HYBRID_ROWS,
          "prompt_tokens": HYBRID_PROMPT, "new_tokens": HYBRID_NEW, "ms": gen_ms,
          "tok_per_s": HYBRID_ROWS * HYBRID_NEW / (gen_ms / 1e3), "forwards": HYBRID_NEW,
          "launches": launches, "expected_launches": expect, "per_forward": per_forward,
          "plain_pack_codes_calls": uncovered, "table_copies": copies,
          "ssd_state_mib": nbytes["layers"] / mib, "shared_kv_mib": nbytes["shared_attn"] / mib,
          "table_mib": depth["table_mib"],
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
          "first_tokens": [row[0] for row in streams]})
    if launches != expect or uncovered or copies:
        raise AssertionError(f"{phase}: launch counts {launches} != expected {expect}, "
                             f"or {uncovered} packs off the kernel, or {copies} table copies")
    if any(len(row) != HYBRID_NEW for row in streams):
        raise AssertionError(f"{phase}: a row stopped short of {HYBRID_NEW} tokens")

    # the generate call split into its prefill and decode steps, beside the
    # same steps after the short prompts (in turns); the odd prefill (chunk 1)
    timing, after_short = timed_steps(lut, cfg, (prompts, short_prompts), HYBRID_NEW - 1,
                                      prefills=HYBRID_TIMED)
    emit({"phase": phase, "step": "generate_timing", **timing, "generate_ms": gen_ms,
          "prefill_share_of_generate": timing["median_prefill_ms"] / gen_ms,
          "nvidia_smi": smi_line()})
    odd, = timed_steps(lut, cfg, (prompts[:, :HYBRID_ODD],), 0)
    emit({"phase": phase, "step": "context_check",
          "median_decode_step_ms": {HYBRID_SHORT: after_short["median_decode_step_ms"],
                                    HYBRID_PROMPT: timing["median_decode_step_ms"]},
          "decode_step_ms_after_short": after_short["decode_step_ms"],
          "ratio_long_to_short": timing["median_decode_step_ms"]
          / after_short["median_decode_step_ms"], "steps_interleaved": True,
          "reason": "the SSD states are O(1); the shared block's K/V grow with the context "
                    "(reported, not gated)",
          "odd_prefill": {"prompt_tokens": HYBRID_ODD, "chunk": 1,
                          "prefill_ms": odd["prefill_ms"],
                          "against_even_prefill_ms": timing["median_prefill_ms"]}})

    # prefill logits kernel against plain: at 1 layer as they come; at
    # HYBRID_PLAIN_DEPTH layers, the least depth that reaches the shared
    # block, with the plain path on the kernel path's codes (the unsynchronized
    # logits and the plain path against itself in another fp32 order beside
    # them); every pack of the kernel run bit for bit with its plain version
    head = prompts[:, :HYBRID_PLAIN_PROMPT]

    def logits(depth, use_kernels, codes=None):
        with pack_tape(codes) as sites:
            out = cut_logits(lut, cfg, head, depth, use_kernels=use_kernels,
                             cache_len=HYBRID_PLAIN_PROMPT)
        return out, sites

    got, _ = logits(1, True)
    res = compare_logits(got, logits(1, False)[0])
    finite = bool(torch.isfinite(got).all().item())
    tol = LOGITS_TOL * res["max_abs_ref"]
    emit({"phase": phase, "step": "prefill_logits", "layers": 1, "shape": list(got.shape),
          **res, "tol": tol, "rel_fro_tol": LOGITS_FRO_TOL, "finite": finite,
          "tol_reason": "as the serve phase's: each projection re-quantizes its input"})
    if not (finite and res["max_abs_err"] <= tol and res["rel_fro_err"] <= LOGITS_FRO_TOL):
        raise AssertionError(f"{phase}: prefill logits differ at 1 layer: {res} (tol {tol}, "
                             f"{LOGITS_FRO_TOL})")
    got, tape = logits(HYBRID_PLAIN_DEPTH, True)
    ref, seen = logits(HYBRID_PLAIN_DEPTH, False, codes=tape)
    synced = compare_logits(ref, got)
    site_err = max(((x - x_ref).abs().max() / x_ref.abs().max()).item()
                   for (x, *_), (x_ref, *_) in zip(seen, tape))
    bad_packs = [i for i, (x, codes, plan) in enumerate(tape)
                 if not torch.equal(pack_ops.pack(x, plan, use_kernels=False), codes)]
    del seen
    plain, plain_tape = logits(HYBRID_PLAIN_DEPTH, False)
    # where the unsynchronized paths part: each site's input and fp16 codes
    drift = {"site_input_rel_err": [((x - x_ref).abs().max() / x_ref.abs().max()).item()
                                    for (x, *_), (x_ref, *_) in zip(plain_tape, tape)],
             "codes_differing": [int((c != c_ref).sum().item())
                                 for (_, c, _), (_, c_ref, _) in zip(plain_tape, tape)],
             "codes": [c.numel() for _, c, _ in tape]}
    del plain_tape
    with plain_gather_bytes(64 * 2**20):
        plain_other, _ = logits(HYBRID_PLAIN_DEPTH, False)
    finite = bool(torch.isfinite(got).all().item())
    ok = (finite and synced["max_abs_err"] <= SYNCED_TOL * synced["max_abs_ref"]
          and site_err <= SYNCED_TOL and not bad_packs)
    emit({"phase": phase, "step": "prefill_logits_synced", "layers": HYBRID_PLAIN_DEPTH,
          "shared_invocations": len(segments(dataclasses.replace(
              cfg, num_layers=HYBRID_PLAIN_DEPTH))) - 1,
          "shape": list(got.shape), "synced": synced, "site_input_rel_err": site_err,
          "tol": SYNCED_TOL, "finite": finite, "packs": len(tape),
          "packs_bit_for_bit": not bad_packs,
          "unsynced": {**compare_logits(got, plain), "sites": drift},
          "plain_vs_plain": compare_logits(plain_other, plain),
          "depth_reason": "six mamba layers and one shared invocation, the least depth that "
          "reaches the shared block",
          "tol_reason": "with every code the same the paths differ only by their fp32 sums' "
          "order; unsynchronized, each projection re-quantizes its input, and on these "
          "weights one layer's fp32-order differences flip fp16 codes whose i8 table steps "
          "grow from layer to layer (unsynced and plain_vs_plain: reported, not gated)"})
    if not ok:
        raise AssertionError(f"{phase}: synchronized prefill logits at {HYBRID_PLAIN_DEPTH} "
                             f"layers differ: {synced}, site inputs {site_err} x max off, or "
                             f"packs {bad_packs} differ")
    del got, ref, plain, plain_other, tape

    # first tokens of the short traffic at the cut, the plain path on the
    # kernel path's codes at every pack site
    synced_generate(phase, lut, cfg, short_prompts, HYBRID_SYNC_NEW,
                    per_forward["bitplane_pack"],
                    "a decode step attends over the shared block's bf16 K/V, which each path "
                    "rounded from its own fp32 sums; the SSD states are fp32")

    # the state across calls: prefill then decode through the cache against
    # one chunked forward, each site of the cached run on the forward's codes
    # of its rows; gated on the default cache (bf16 K/V), reported on fp32
    across = {str(dt).split(".")[-1]: synced_state_across_calls(lut, cfg, short, dt,
                                                                HYBRID_SHORT_NEW)
              for dt in (torch.bfloat16, torch.float32)}
    gate = across["bfloat16"]
    emit({"phase": phase, "step": "state_across_calls", "prefill_tokens": HYBRID_SHORT,
          "decode_tokens": HYBRID_SHORT_NEW, "tol": HYBRID_STATE_TOL,
          "tol_reason": "every site's input on the forward's codes: one bf16 rounding of the "
                        "cached K and V (2^-8 relative each) through the softmax and the "
                        "weighted sum, at the shared block's wo inputs; elsewhere fp32 order",
          **across})
    if not (gate["finite"] and gate["site_input_rel_err"] <= HYBRID_STATE_TOL):
        raise AssertionError(f"{phase}: the cached decode's site inputs are "
                             f"{gate['site_input_rel_err']} x max from one chunked forward's "
                             f"(tol {HYBRID_STATE_TOL})")

    emit({"phase": phase, "step": "decode_profile_eager",
          **eager_decode_profile(lut, cfg, short_prompts), "nvidia_smi": smi_line()})
    rows = HYBRID_ROWS * HYBRID_PROMPT
    for r, kw in ((4, {}), (rows, {"plain": False})):
        n = iters if r == 4 else HYBRID_PREFILL_ITERS
        recipe_layer_calls(phase, lut, n, parts=("mix",), block="mamba", rows=r, **kw)
        recipe_layer_calls(phase, lut, n, parts=("attn", "mlp"), block="shared", rows=r,
                           head=False, **kw)
    # the G = 3 group with i8 shift tables, held to plain at both shapes
    gen = torch.Generator(device=DEV).manual_seed(3)
    plan = qkv.plan
    for r in (4, rows):
        x = torch.randn(r, plan.in_features, generator=gen, device=DEV)
        res = run_case("lut_affine_grouped", pack_codes(x, plan), qkv.tables,
                       _host_scales(plan, qkv.scale), plan.shift_bits,
                       iters if r == 4 else HYBRID_PREFILL_ITERS, 3 if r == 4 else 1)
        emit({"phase": phase, "step": "g3_group", "proj": "wq+wk+wv", "rows": r,
              "G": qkv.tables.shape[0], "n": plan.num_planes, "k": plan.in_features,
              "E": plan.num_entries, "p": plan.out_features, "table": plan.table_format,
              "shift_bits": plan.shift_bits, **res})
    emit({"phase": phase, "step": "memory",
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
    del lut
    torch.cuda.empty_cache()
    return {"launches": launches}


@contextlib.contextmanager
def bf16_self_kv():
    """Inside a ``with`` block, the enc-dec decoder's self-attention takes
    its K/V rounded to bf16 (:func:`bf16_attention_inputs`), as a paged
    prefill reads them from its cache; the encoder's attention and the
    cross-attention, whose fp32 K/V no paging touches, as they are."""
    from repro_torch.models import layers

    attention = layers.attention

    def rounded(p, x, ctx, positions, cache=None, cross_kv=None):
        if cross_kv is not None or cache is None:
            return attention(p, x, ctx, positions, cache=cache, cross_kv=cross_kv)
        with bf16_attention_inputs():
            return attention(p, x, ctx, positions, cache=cache)

    layers.attention = rounded
    try:
        yield
    finally:
        layers.attention = attention


def encdec_inputs(cfg):
    """ENCDEC_ROWS seeded prompts of ENCDEC_PROMPT tokens, each with
    ENCDEC_FRAMES seeded frame embeddings at std ENCDEC_FRAME_STD (the audio
    frontend is a stub, as in the reference), from a numpy seed, on the
    card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(ENCDEC_SEED)
    prompts = rng.integers(0, cfg.vocab_size, (ENCDEC_ROWS, ENCDEC_PROMPT)).astype(np.int32)
    frames = rng.standard_normal((ENCDEC_ROWS, ENCDEC_FRAMES, cfg.d_model)) * ENCDEC_FRAME_STD
    return (torch.from_numpy(prompts).to(DEV),
            torch.from_numpy(frames.astype(np.float32)).to(DEV))


def encdec_cut(lut, cfg, depth: int):
    """(config, tree) of the first ``depth`` encoder and decoder layers."""
    dcfg = dataclasses.replace(cfg, num_layers=depth, encoder_layers=depth)
    return dcfg, dict(lut, encoder=first_layers(lut["encoder"], depth),
                      decoder=first_layers(lut["decoder"], depth))


def encdec_generate(lut, cfg, prompts, frames, max_new: int, use_kernels: bool = True,
                    page_size=None):
    """Greedy ``generate(enc_embeds=...)`` of ``max_new`` tokens into an
    ENCDEC_LEN-slot decoder cache (:func:`greedy_generate`)."""
    return greedy_generate(lut, cfg, prompts, max_new, use_kernels=use_kernels,
                           enc_embeds=frames, max_len=ENCDEC_LEN, page_size=page_size)


def encdec_counted(phase, name, lut, cfg, prompts, frames, launches_per_call: dict,
                   page_size=None):
    """One :func:`encdec_generate` of ENCDEC_NEW tokens on the kernels, its
    launch counts set to 0 just before and read just after: the prefill's
    and ENCDEC_NEW - 1 decode steps' launches (``launches_per_call``), no
    pack off the kernel, no table copy; emits a ``generate`` line and
    returns (streams, launches, wall ms)."""
    import torch

    from repro_torch.kernels.lut_affine import ops as lut_ops

    reset_launches()
    streams, ms = encdec_generate(lut, cfg, prompts, frames, ENCDEC_NEW, page_size=page_size)
    launches, uncovered = read_launches(), plain_pack_codes_calls()
    copies = lut_ops.TABLE_COPIES["table_operand"]
    expect = {**no_launches(), **launches_per_call}
    emit({"phase": phase, "step": "generate", "name": name, "rows": ENCDEC_ROWS,
          "encoder_frames": ENCDEC_FRAMES, "prompt_tokens": ENCDEC_PROMPT,
          "new_tokens": ENCDEC_NEW, "cache_len": ENCDEC_LEN, "page_size": page_size,
          "pages_per_row": page_size and ENCDEC_LEN // page_size, "ms": ms,
          "tok_per_s": ENCDEC_ROWS * ENCDEC_NEW / (ms / 1e3), "forwards": ENCDEC_NEW,
          "launches": launches, "expected_launches": expect,
          "plain_pack_codes_calls": uncovered, "table_copies": copies,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
          "first_tokens": [row[0] for row in streams]})
    if launches != expect or uncovered or copies:
        raise AssertionError(f"{phase} {name}: launch counts {launches} != expected {expect}, "
                             f"or {uncovered} packs off the kernel, or {copies} table copies")
    if any(len(row) != ENCDEC_NEW for row in streams):
        raise AssertionError(f"{phase} {name}: a row stopped short of {ENCDEC_NEW} tokens")
    return streams, launches, ms


def encdec_prefill(lut, cfg, prompts, frames, use_kernels: bool = True, codes=None):
    """``generate``'s prefill (grouped launches, a fresh ENCDEC_LEN-slot
    cache) with every position's logits, under :func:`pack_tape` (given
    ``codes``, each pack site takes the recorded codes); returns (logits,
    the pack sites, the cache)."""
    import torch

    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.models.model import model_forward
    from repro_torch.serve import make_cache

    ctx = Ctx(cfg, ex=ExecCfg(use_kernels=use_kernels, lut_grouped=True))
    cache = make_cache(cfg, prompts.shape[0], ENCDEC_LEN, ctx, device=DEV,
                       enc_len=frames.shape[1])
    with torch.no_grad(), pack_tape(codes) as sites:
        logits = model_forward(lut, {"tokens": prompts, "enc_embeds": frames}, ctx,
                               cache=cache)[0]
    return logits, sites, cache


def encdec_timing(lut, cfg, prompts, frames) -> dict:
    """The main path's ``generate`` split apart: ENCDEC_TIMED prefills into
    fresh caches, each beside the encoder alone and the cross K/V of every
    decoder layer alone from its output; then the ENCDEC_NEW - 1 eager decode
    steps after the last; each on the host clock from a synchronize to a
    synchronize."""
    import torch

    from repro_torch.models.encdec import _cross_kv_from, encode
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.models.transformer import unbind_layers
    from repro_torch.serve import make_cache, make_decode_step, make_prefill_step

    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True, logits="last"))
    prefill, decode = make_prefill_step(ctx), make_decode_step(ctx)
    inputs = {"tokens": prompts, "enc_embeds": frames}
    out = {"prefill_ms": [], "encoder_ms": [], "cross_kv_ms": [], "decode_step_ms": []}

    def timed(fn, key):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[key].append((time.perf_counter() - t0) * 1e3)
        return res

    cross = lut["decoder"]["cross_attn"]
    with torch.no_grad():
        for _ in range(ENCDEC_TIMED):
            cache = make_cache(cfg, ENCDEC_ROWS, ENCDEC_LEN, ctx, device=DEV,
                               enc_len=ENCDEC_FRAMES)
            logits, cache = timed(lambda: prefill(lut, inputs, cache), "prefill_ms")
            enc = timed(lambda: encode(lut, frames, ctx), "encoder_ms")
            timed(lambda: [_cross_kv_from(lp, enc, ctx)
                           for lp in unbind_layers(cross, cfg.num_layers)], "cross_kv_ms")
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        for _ in range(ENCDEC_NEW - 1):
            tok, _, cache = timed(lambda: decode(lut, cache, tok), "decode_step_ms")
    return {**out, **{f"median_{key}": statistics.median(v) for key, v in out.items()}}


def encdec_serve_phase(iters: int) -> dict:
    """Full-width whisper_base (a bidirectional encoder over 1,500 frames and
    a decoder of causal self-attention, cross-attention over the encoder's
    output and a biased GELU MLP, each after a LayerNorm; 8 heads of 64,
    d_ff 2,048, vocab 51,865, the head tied to the embedding) at all 6 + 6
    layers (:func:`family_depth`: nothing is cut), planned by the recipe
    with chunks capped at 1 and converted (:func:`recipe_cell`): three G =
    3 ``wq+wk+wv`` groups with stacked biases (the encoder's, the decoder's
    self- and cross-attention's), ``wo``, ``w_in``, ``w_out`` lone; the head
    a plain product.  Served through ``generate(enc_embeds=...)`` alone
    (``BatchingEngine`` refuses a cross cache, as the reference's does):
    the refusals first; the main path (ENCDEC_ROWS x ENCDEC_FRAMES frames,
    ENCDEC_PROMPT prompt tokens, ENCDEC_NEW new) dense and counted, after
    one untimed short generate; its prefill, the encoder and the cross K/V
    and the decode steps timed apart; the cache after the prefill (cross
    K/V fp32 at S_enc, self K/V bf16); prefill logits kernel against plain
    at ENCDEC_PLAIN_DEPTH encoder and decoder layers, and at the full depth
    on the kernel path's codes, every pack of that prefill bit for bit and
    the first tokens (the last position's argmax) identical; paged at
    PAGE_SIZE, whose streams a dense run on bf16-rounded self K/V must serve
    whole; a profile of the eager decode step; each LUT call of an encoder
    layer at the prefill's rows and of a decoder layer at the decode shape
    (the cross-attention's members alone on the group's leaf: ``wq`` and
    ``wo`` at 4 rows, ``wk``/``wv`` at the encoder's rows), beside its
    bound, and the encoder's G = 3 group held to plain at its rows."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.convert import LUTGroup
    from repro_torch.core.lut import pack_codes
    from repro_torch.kernels.bitplane_pack import ops as pack_ops
    from repro_torch.kernels.lut_affine import ops as lut_ops
    from repro_torch.models.layers import Ctx, _host_scales
    from repro_torch.models.model import model_forward
    from repro_torch.models.transformer import layer_params
    from repro_torch.serve import BatchingEngine

    phase, arch = "encdec_serve", "whisper_base"
    full = get_config(arch)
    layers, depth = family_depth(full)
    if layers != full.num_layers:
        raise AssertionError(f"{phase}: the cut is {layers} of {full.num_layers} layers")
    cfg, lut = recipe_cell(phase, full, depth)
    Le, d = cfg.encoder_layers, cfg.d_model
    groups = {f"{stack}/{part}": lut[stack][part].get("wq+wk+wv")
              for stack, part in (("encoder", "attn"), ("decoder", "self_attn"),
                                  ("decoder", "cross_attn"))}
    for where, g in groups.items():
        n = Le if where.startswith("encoder") else layers
        if not (isinstance(g, LUTGroup) and tuple(g.tables.shape[:2]) == (n, 3)
                and g.plan.table_format == "i8" and g.plan.shift_bits
                and isinstance(g.b, torch.Tensor) and tuple(g.b.shape) == (n, 3, d)):
            raise AssertionError(f"{phase}: {where} is not a biased G = 3 i8 shift wq+wk+wv")
    if "lm_head" in lut:
        raise AssertionError(f"{phase}: the tied head was converted")
    decode_calls = lut_calls_per_forward(lut, layers)
    prefill_calls = lut_calls_per_forward(lut, layers, encoder=Le)
    want = ({"lut_affine": 5 * layers, "lut_affine_grouped": layers,
             "bitplane_pack": 6 * layers},
            {"lut_affine": 3 * Le + 7 * layers, "lut_affine_grouped": Le + layers,
             "bitplane_pack": 4 * Le + 7 * layers})
    if (decode_calls, prefill_calls) != want:
        raise AssertionError(f"{phase}: the converted tree makes {decode_calls} calls a "
                             f"decode step and {prefill_calls} a prefill, not {want}")
    per_generate = {k: prefill_calls[k] + (ENCDEC_NEW - 1) * decode_calls[k]
                    for k in decode_calls}
    emit({"phase": phase, "step": "calls_per_forward", "decode": decode_calls,
          "prefill": prefill_calls, "generate": per_generate,
          "rule": "decode 5L / L / 6L: per decoder layer self wq+wk+wv grouped, wo, cross wq "
                  "alone on the group's leaf, cross wo, w_in, w_out; prefill 3Le + 7L / Le + L "
                  "/ 4Le + 7L: the encoder's layers, each decoder layer's cross wk and wv alone "
                  "on the leaf after one pack, the decoder; the tied head is a plain product"})

    # the refusals, before any launch
    prompts, frames = encdec_inputs(cfg)
    mask = torch.ones(prompts.shape, dtype=torch.bool, device=DEV)
    reset_launches()
    refused = {}
    for name, call in (
            ("batching_engine", lambda: BatchingEngine(lut, Ctx(cfg), SLOTS, MAX_LEN,
                                                       device=DEV)),
            ("token_mask", lambda: model_forward(
                lut, {"tokens": prompts, "enc_embeds": frames, "token_mask": mask},
                Ctx(cfg)))):
        try:
            call()
        except NotImplementedError as e:
            refused[name] = f"{type(e).__name__}: {e}"
    launched = {k: v for k, v in read_launches().items() if v}
    emit({"phase": phase, "step": "refusals", **refused, "launches": launched})
    if len(refused) != 2 or launched:
        raise AssertionError(f"{phase}: refusals {refused}, launches before them {launched}")

    # the main path: generate(enc_embeds=...) on the kernels, counted, after
    # one untimed short generate (the first launch of each kernel loads its
    # module)
    encdec_generate(lut, cfg, prompts, frames, 2)
    torch.cuda.reset_peak_memory_stats()
    a, launches, a_ms = encdec_counted(phase, "a_dense", lut, cfg, prompts, frames,
                                       per_generate)
    timing = encdec_timing(lut, cfg, prompts, frames)
    emit({"phase": phase, "step": "generate_timing", **timing, "generate_ms": a_ms,
          "prefill_share_of_generate": timing["median_prefill_ms"] / a_ms,
          "encoder_share_of_generate": timing["median_encoder_ms"] / a_ms,
          "nvidia_smi": smi_line()})

    # prefill logits kernel against plain: at ENCDEC_PLAIN_DEPTH layers as
    # they come; at the full depth with the plain path on the kernel path's
    # codes; every pack of the kernel run bit for bit with its plain
    # version; the kernel run's cache
    dcfg, dlut = encdec_cut(lut, cfg, ENCDEC_PLAIN_DEPTH)
    got = encdec_prefill(dlut, dcfg, prompts, frames)[0]
    res = compare_logits(got, encdec_prefill(dlut, dcfg, prompts, frames, False)[0])
    finite = bool(torch.isfinite(got).all().item())
    tol = LOGITS_TOL * res["max_abs_ref"]
    emit({"phase": phase, "step": "prefill_logits", "layers": ENCDEC_PLAIN_DEPTH,
          "encoder_layers": ENCDEC_PLAIN_DEPTH, "shape": list(got.shape), **res, "tol": tol,
          "rel_fro_tol": LOGITS_FRO_TOL, "finite": finite,
          "tol_reason": "as the serve phase's: each projection re-quantizes its input"})
    if not (finite and res["max_abs_err"] <= tol and res["rel_fro_err"] <= LOGITS_FRO_TOL):
        raise AssertionError(f"{phase}: prefill logits differ at {ENCDEC_PLAIN_DEPTH} layers: "
                             f"{res} (tol {tol}, {LOGITS_FRO_TOL})")
    got, tape, cache = encdec_prefill(lut, cfg, prompts, frames)
    shapes = {f"{part}.{key}": [list(t.shape), str(t.dtype).split(".")[-1]]
              for part in ("cross", "layers") for key, t in cache[part].items()}
    cross_shape = (layers, ENCDEC_ROWS, ENCDEC_FRAMES, cfg.num_kv_heads, cfg.head_dim)
    self_shape = (layers, ENCDEC_ROWS, ENCDEC_LEN, cfg.num_kv_heads, cfg.head_dim)
    cache_ok = all(tuple(cache["cross"][k].shape) == cross_shape
                   and cache["cross"][k].dtype == torch.float32
                   and tuple(cache["layers"][k].shape) == self_shape
                   and cache["layers"][k].dtype == torch.bfloat16 for k in ("k", "v"))
    mib = 2**20
    emit({"phase": phase, "step": "cache", "leaves": shapes, "ok": cache_ok,
          "cross_mib": sum(t.nbytes for t in cache["cross"].values()) / mib,
          "self_kv_mib": sum(t.nbytes for t in cache["layers"].values()) / mib,
          "cross_finite": all(bool(torch.isfinite(t).all().item())
                              for t in cache["cross"].values()),
          "index": cache["index"].tolist()})
    if not cache_ok:
        raise AssertionError(f"{phase}: the cache after the prefill holds {shapes}")
    del cache
    ref, seen = encdec_prefill(lut, cfg, prompts, frames, False, codes=tape)[:2]
    synced = compare_logits(ref, got)
    site_err = max(((x - x_ref).abs().max() / x_ref.abs().max()).item()
                   for (x, *_), (x_ref, *_) in zip(seen, tape))
    bad_packs = [i for i, (x, codes, plan) in enumerate(tape)
                 if not torch.equal(pack_ops.pack(x, plan, use_kernels=False), codes)]
    del seen
    finite = bool(torch.isfinite(got).all().item())
    # the first tokens: the argmax at the last position, as generate takes it
    kernel_first, plain_first = got[:, -1].argmax(-1).tolist(), ref[:, -1].argmax(-1).tolist()
    top2 = got[:, -1].topk(2, dim=-1).values
    ok = (finite and synced["max_abs_err"] <= SYNCED_TOL * synced["max_abs_ref"]
          and site_err <= SYNCED_TOL and not bad_packs and kernel_first == plain_first
          and len(tape) == prefill_calls["bitplane_pack"])
    emit({"phase": phase, "step": "prefill_logits_synced", "layers": layers,
          "encoder_layers": Le, "shape": list(got.shape), "synced": synced,
          "site_input_rel_err": site_err, "tol": SYNCED_TOL, "finite": finite,
          "packs": len(tape), "packs_bit_for_bit": not bad_packs,
          "first_tokens": {"synced_identical": kernel_first == plain_first,
                           "kernel": kernel_first, "plain_synced": plain_first,
                           "generate_a": [row[0] for row in a],
                           "kernel_top2_gap": (top2[:, 0] - top2[:, 1]).tolist()},
          "tol_reason": "with every code the same the paths differ only by their fp32 sums' "
                        "order (unsynchronized, each projection re-quantizes its input: held "
                        "at ENCDEC_PLAIN_DEPTH layers above)"})
    if not ok:
        raise AssertionError(f"{phase}: synchronized prefill logits or first tokens at the full "
                             f"depth differ: {synced}, {kernel_first} != {plain_first}, site "
                             f"inputs {site_err} x max off, packs {bad_packs} differ, or "
                             f"{len(tape)} packs")
    del got, ref, tape

    # paged at PAGE_SIZE (only the self K/V), against a dense run on
    # bf16-rounded self K/V
    b, _, b_ms = encdec_counted(phase, "b_paged", lut, cfg, prompts, frames, per_generate,
                                page_size=PAGE_SIZE)
    with bf16_self_kv():
        f, f_ms = encdec_generate(lut, cfg, prompts, frames, ENCDEC_NEW)
    checks = {"dense_bf16_kv_streams_identical_b": f == b}
    emit({"phase": phase, "step": "paged_checks", **checks, "f_ms": f_ms,
          "tokens_agreeing_a_b_per_row": [sum(x == y for x, y in zip(r, q))
                                          for r, q in zip(a, b)],
          "first_tokens": {"a": [r[0] for r in a], "b": [r[0] for r in b],
                           "f": [r[0] for r in f]},
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
    failed = [key for key, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{phase}: failed paged checks {failed}")

    emit({"phase": phase, "step": "decode_profile_eager",
          **eager_decode_profile(lut, cfg, prompts, enc_embeds=frames),
          "nvidia_smi": smi_line()})

    # each LUT call: an encoder layer's at the prefill's rows (timed), a
    # decoder layer's at the decode shape (held to plain); the cross
    # attention's members alone on layer 0's G = 3 leaf, wq and wo at 4
    # rows, wk and wv at the encoder's rows, held to plain
    rows = ENCDEC_ROWS * ENCDEC_FRAMES
    recipe_layer_calls(phase, lut, ENCDEC_PREFILL_ITERS, parts=("attn", "mlp"),
                       block="encoder", rows=rows, plain=False, head=False)
    decoder = recipe_layer_calls(phase, lut, iters, parts=("self_attn", "mlp"),
                                 block="decoder", head=False)
    gen = torch.Generator(device=DEV).manual_seed(4)
    cross = layer_params(lut["decoder"]["cross_attn"], 0)
    qkv = cross["wq+wk+wv"]
    for name, node, g, r in (("wq", qkv, 0, 4), ("wo", cross["wo"], None, 4),
                             ("wk", qkv, 1, rows), ("wv", qkv, 2, rows)):
        plan = node.plan
        tables = node.tables if g is None else node.tables[g]
        x = torch.randn(r, plan.in_features, generator=gen, device=DEV)
        codes = pack_codes(x, plan)
        scales = _host_scales(plan, node.scale)
        copies = lut_ops.TABLE_COPIES["table_operand"]
        lut_ops.lut_affine(codes, tables, scales, shift_bits=plan.shift_bits)
        view_copies = lut_ops.TABLE_COPIES["table_operand"] - copies
        res = run_case("lut_affine", codes, tables[None], scales, plan.shift_bits,
                       iters if r == 4 else ENCDEC_PREFILL_ITERS, 3 if r == 4 else 1)
        emit({"phase": phase, "step": "cross_call", "proj": name,
              "member_of": "wq+wk+wv" if g is not None else None, "rows": r,
              "n": plan.num_planes, "k": plan.in_features, "E": plan.num_entries,
              "p": plan.out_features, "table": plan.table_format,
              "table_copies_on_the_leaf_view": view_copies, **res})
        if view_copies:
            raise AssertionError(f"{phase}: the cross {name} call copied its tables")
        if r == 4:
            for key in decoder:
                decoder[key] += res[key]
    emit({"phase": phase, "step": "decoder_layer", "rows": 4,
          "calls": "self wq+wk+wv, wo, w_in, w_out; cross wq, wo", **decoder})
    # the encoder's biased G = 3 group, held to plain at its rows
    enc_qkv = layer_params(lut["encoder"]["attn"], 0)["wq+wk+wv"]
    plan = enc_qkv.plan
    x = torch.randn(rows, plan.in_features, generator=gen, device=DEV)
    res = run_case("lut_affine_grouped", pack_codes(x, plan), enc_qkv.tables,
                   _host_scales(plan, enc_qkv.scale), plan.shift_bits, ENCDEC_PREFILL_ITERS, 1)
    emit({"phase": phase, "step": "g3_group", "proj": "encoder wq+wk+wv", "rows": rows,
          "G": enc_qkv.tables.shape[0], "n": plan.num_planes, "k": plan.in_features,
          "E": plan.num_entries, "p": plan.out_features, "table": plan.table_format,
          "shift_bits": plan.shift_bits, **res})
    emit({"phase": phase, "step": "memory",
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
    del lut
    torch.cuda.empty_cache()
    return {"launches": launches}


def ring_positions(last: int, T: int) -> list:
    """Slot j of a ring of T slots after positions 0..``last`` were written:
    the latest p <= last with p % T == j, or -1 where none was."""
    return [j + (last - j) // T * T if j <= last else -1 for j in range(T)]


def ring_holds(cache, last_by_row: dict) -> bool:
    """Whether each row's ``pos`` and ``valid``, read back once, are what
    :func:`ring_positions` works out from the row's last written position."""
    import numpy as np

    T = cache["pos"].shape[1]
    pos, valid = cache["pos"].cpu().numpy(), cache["valid"].cpu().numpy()
    ok = True
    for row, last in last_by_row.items():
        want = np.asarray(ring_positions(last, T))
        ok &= bool((valid[row] == (want >= 0)).all() and (pos[row][want >= 0] ==
                                                          want[want >= 0]).all())
    return ok


def mapped_pages(counts: list):
    """A ``run_engine`` watch that appends, after every step, the pages each
    live slot maps in the allocator's table to ``counts``."""
    def watch(eng):
        def after():
            live = [s for s, r in enumerate(eng.slots) if r is not None]
            counts.extend((eng.alloc.table[live] >= 0).sum(1).tolist())
        return after
    return watch


def experts_layer_calls(phase: str, lut, cfg, iters: int) -> dict:
    """Layer 0's two routed-expert calls at the decode shape: SLOTS tokens
    routed by the layer's own router into 2 x SLOTS expert-sorted rows,
    ``w_gate+w_up`` on the tokens' gathered codes and ``w_down`` on the
    sorted rows, kernel against plain (:func:`run_experts_case`) beside the
    bound; returns the sums over both."""
    import numpy as np
    import torch

    from repro_torch.core.convert import LUTGroup
    from repro_torch.core.lut import pack_codes, plane_scales
    from repro_torch.models.moe import dispatch
    from repro_torch.models.transformer import layer_params

    ffn = layer_params(lut["blocks"]["ffn"], 0)
    gen = torch.Generator(device=DEV).manual_seed(3)
    x = torch.randn(SLOTS, cfg.d_model, generator=gen, device=DEV)
    _, _, _, token_of, gs = dispatch(x, ffn["router"], cfg)
    h = torch.randn(token_of.numel(), cfg.moe_d_ff, generator=gen, device=DEV)
    total = {"kernel_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for name, src in (("w_gate+w_up", x), ("w_down", h)):
        node = ffn[name]
        plan = node.plan
        codes = pack_codes(src, plan)
        if name == "w_gate+w_up":
            codes = codes[token_of]
        tables = node.tables if isinstance(node, LUTGroup) else node.tables[:, None]
        scales = plane_scales(plan).astype(np.float32)
        if node.scale is not None:
            scales = scales * np.float32(float(node.scale))
        r = run_experts_case(codes, tables, scales, gs, plan.shift_bits, iters, 3)
        emit({"phase": phase, "step": "layer_call", "proj": name, "rows": codes.shape[0],
              "experts_used": int((gs > 0).sum().item()), "E": tables.shape[0],
              "G": tables.shape[1], "n": plan.num_planes, "k": plan.in_features,
              "p": plan.out_features, "table_bytes": tables.numel() * tables.element_size(),
              **r})
        for key in total:
            total[key] += r[key]
    return total


def mixtral_ring(phase: str, lut, cfg, per_forward: dict) -> None:
    """The ring at the published window, on the kernels (the plain versions
    cost ~40x at these row counts): ``BatchingEngine(RING_SLOTS, RING_LEN)``
    dense and paged, graph and eager, on two requests that write past slot
    4095 (streams identical whole; each slot's pos and valid exactly the
    ring's; a paged slot maps all 512 pages at admission and none after);
    a decode past the window against the windowed full forward of the same
    sequence (norm error per position within LOGITS_FRO_TOL; beside it the
    forward on bf16-rounded K/V and, not gated, with no window mask); and
    ``generate()`` on a prompt longer than the window (its ring exact, its
    first token the no-cache forward's)."""
    import numpy as np
    import torch

    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.models.model import model_forward
    from repro_torch.serve import (
        _engine,
        generate,
        make_cache,
        make_decode_step,
        make_prefill_step,
    )

    t0 = time.perf_counter()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in RING_PROMPTS]
    # the peak, reckoned before the run: what is resident, plus the larger of
    # the admission prefill's fp32 attention (scores, their masked copy and
    # the probabilities over RING_SLOTS x heads x RING_LEN^2) and its expert
    # activations (gate, up, their product and w_down's int32 codes over
    # 2 x RING_SLOTS x RING_LEN rows), plus its fp32 logits
    gib, S = 2**30, RING_SLOTS * RING_LEN
    planes = lut["blocks"]["ffn"]["w_down"].plan.num_planes
    attn = 3 * RING_SLOTS * cfg.num_heads * RING_LEN**2 * 4
    moe_act = 2 * S * cfg.moe_d_ff * 4 * (4 + planes)
    logits = S * cfg.padded_vocab * 4
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    predicted = resident + max(attn, moe_act) + logits
    emit({"phase": phase, "step": "ring_memory", "resident_gib": resident / gib,
          "attention_gib": attn / gib, "expert_activations_gib": moe_act / gib,
          "logits_gib": logits / gib, "predicted_peak_gib": predicted / gib,
          "card_gib": torch.cuda.get_device_properties(0).total_memory / gib})
    torch.cuda.reset_peak_memory_stats()

    engine = {"num_slots": RING_SLOTS, "max_len": RING_LEN, "prefill_bucket": None}
    last = {i: n + RING_NEW - 2 for i, n in enumerate(RING_PROMPTS)}
    pages = RING_LEN // PAGE_SIZE
    streams, checks = {}, {}
    for name, paged, graph in (("dense_graph", False, None), ("dense_eager", False, False),
                               ("paged_graph", True, None), ("paged_eager", True, False)):
        mapped = []
        streams[name], eng = counted_run(phase, f"ring_{name}", lut, cfg, prompts, RING_NEW,
                                         per_forward, paged, graph, engine=engine,
                                         watch=mapped_pages(mapped) if paged else None)
        checks[f"ring_holds_{name}"] = ring_holds(eng.cache, last)
        if paged:
            checks[f"pages_mapped_{name}"] = bool(mapped) and set(mapped) == {pages}
            checks[f"no_page_in_use_after_{name}"] = eng.alloc.pages_in_use == 0
        del eng
    checks["graph_eager_streams_identical"] = (streams["dense_graph"] == streams["dense_eager"]
                                               and streams["paged_graph"]
                                               == streams["paged_eager"])
    checks["paged_dense_streams_identical"] = streams["paged_graph"] == streams["dense_graph"]
    engines_peak = torch.cuda.max_memory_allocated()

    # decode past the window against the windowed full forward
    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True))
    n0 = RING_PROMPTS[0]
    seq = torch.from_numpy(rng.integers(0, cfg.vocab_size, n0 + RING_NEW).astype(np.int32))
    tok = seq.to(DEV)[None]
    cache = make_cache(cfg, 1, RING_LEN, ctx, device=DEV)
    with torch.no_grad():
        _, cache = make_prefill_step(ctx)(lut, {"tokens": tok[:, :n0]}, cache)
        decode, steps = make_decode_step(ctx), []
        for t in range(n0, n0 + RING_NEW):
            _, lg, cache = decode(lut, cache, tok[:, t:t + 1])
            steps.append(lg[0, -1])
        got = torch.stack(steps)
        checks["ring_holds_decode"] = ring_holds(cache, {0: n0 + RING_NEW - 1})
        del cache

        def full(c=cfg):
            ctx_c = Ctx(c, ex=ExecCfg(lut_grouped=True))
            return model_forward(lut, {"tokens": tok}, ctx_c)[0][0, n0:]

        refs = {"windowed": full()}
        with bf16_attention_inputs():
            refs["windowed_bf16_kv"] = full()
        refs["no_window"] = full(dataclasses.replace(cfg, sliding_window=None))
    past = torch.arange(n0, n0 + RING_NEW, device=DEV) >= cfg.sliding_window
    line = {"phase": phase, "step": "ring_decode", "prefill": n0, "decoded": RING_NEW,
            "positions": [n0, n0 + RING_NEW - 1], "window": cfg.sliding_window,
            "positions_past_window": int(past.sum().item()),
            "rel_fro_tol": LOGITS_FRO_TOL,
            "argmax_not_gated": f"the logits trap: a 1-row decode and a {n0 + RING_NEW}-row "
                                "forward run different kernels, other fp32 orders"}
    for name, ref in refs.items():
        per_pos = ((got - ref).norm(dim=-1) / ref.norm(dim=-1))
        line[name] = {**compare_logits(got, ref),
                      "max_rel_fro_err_per_position": per_pos.max().item(),
                      "max_rel_fro_err_past_window": per_pos[past].max().item(),
                      "max_rel_fro_err_inside_window": per_pos[~past].max().item()}
    emit(line)
    checks["decode_within_tol_of_windowed_forward"] = (
        line["windowed"]["max_rel_fro_err_per_position"] <= LOGITS_FRO_TOL
        and bool(torch.isfinite(got).all().item()))
    del got, refs

    # generate() past the window: its cache, seen through make_cache
    gprompt = rng.integers(0, cfg.vocab_size, RING_GENERATE).astype(np.int32)
    made, make = [], _engine.make_cache

    def keep(*a, **kw):
        made.append(make(*a, **kw))
        return made[-1]

    _engine.make_cache = keep
    try:
        toks = generate(lut, ctx, gprompt[None], RING_GENERATE_NEW, device=DEV)
    finally:
        _engine.make_cache = make
    checks["ring_holds_generate"] = ring_holds(
        made[0], {0: RING_GENERATE + RING_GENERATE_NEW - 2})
    with torch.no_grad():
        last_logits = model_forward(lut, {"tokens": torch.from_numpy(gprompt).to(DEV)[None]},
                                    ctx)[0][0, -1]
    checks["generate_first_token_is_forward_argmax"] = int(toks[0, 0]) == int(
        last_logits.argmax().item())
    del made
    emit({"phase": phase, "step": "ring_checks", **checks,
          "ring": {"T": min(cfg.sliding_window, RING_LEN), "slots": RING_SLOTS,
                   "prompts": list(RING_PROMPTS), "new_tokens": RING_NEW,
                   "last_positions": list(last.values()), "pages_per_slot": pages,
                   "generate_prompt": RING_GENERATE, "generate_tokens": toks[0].tolist()},
          "predicted_peak_gib": predicted / gib, "engines_peak_gib": engines_peak / gib,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / gib,
          "seconds": time.perf_counter() - t0})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{phase}: failed ring checks {failed}")


def mixtral_serve_phase(requests: int, max_new: int, iters: int) -> dict:
    """Full-width mixtral_8x7b at the cut :func:`family_depth` computes
    with its experts converted (the conversion's peak from
    :func:`moe_depth` beside it), planned by the recipe with
    ``convert_experts=True`` and chunks capped at 1, converted and served
    through ``BatchingEngine`` on the LUT kernels: the serve cell's requests
    (a ring of min(4096, MAX_LEN) = MAX_LEN slots, which they never wrap),
    graph and eager in turns, then on the plain versions, first tokens
    synchronized (:func:`serve_recipe_cell`); prefill logits at the cut;
    paged at PAGE_SIZE (every page mapped at admission, no sharing): (a)
    dense graph, (b) paged graph, (c) paged eager, all three streams
    identical whole; one decode-shaped forward past the ring's wrap, dense
    and paged, under ``set_sync_debug_mode("error")``; each LUT call of a
    layer at the decode shape; last, the ring at the published window
    (:func:`mixtral_ring`)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.lut_affine import ops as lut_ops
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.models.model import model_forward
    from repro_torch.serve import make_cache

    phase = "mixtral_serve"
    full = get_config("mixtral_8x7b")
    layers, depth = family_depth(full, convert_experts=True)
    conv_layers, conv = moe_depth(full)
    depth.update(conversion_layers=conv_layers, conversion_peak_gib=conv["conversion_peak_gib"],
                 conversion_reason=conv["reason"])
    cfg, lut = recipe_cell(phase, full, depth, convert_experts=True)
    # wq, wo and lm_head alone, wk+wv grouped, the routed w_gate+w_up and
    # w_down ragged; one pack each
    per_forward = lut_calls_per_forward(lut, layers, experts=True)
    want = {"lut_affine": 2 * layers + 1, "lut_affine_grouped": layers,
            "lut_affine_experts": 2 * layers, "bitplane_pack": 5 * layers + 1}
    if per_forward != want:
        raise AssertionError(f"{phase}: the converted tree makes {per_forward} calls a "
                             f"forward, not {want}")
    prompts = serve_requests(cfg, requests)
    launches = serve_recipe_cell(phase, lut, cfg, per_forward, prompts, max_new, synced=True)
    recipe_prefill_logits(phase, lut, cfg, prompts, (layers,))

    # the same requests paged, every page of a slot mapped at admission
    mapped = []
    a, _ = counted_run(phase, "a_dense_graph", lut, cfg, prompts, max_new, per_forward, False)
    b, beng = counted_run(phase, "b_paged_graph", lut, cfg, prompts, max_new, per_forward, True,
                          watch=mapped_pages(mapped))
    c, ceng = counted_run(phase, "c_paged_eager", lut, cfg, prompts, max_new, per_forward, True,
                          cuda_graph=False, watch=mapped_pages(mapped))
    T = beng.cache["pos"].shape[1]
    checks = {
        "paged_streams_identical_b_c": b == c,
        "paged_dense_streams_identical_a_b": a == b,
        "sharing_off": not beng.alloc.share,
        "pages_mapped_at_admission": bool(mapped) and set(mapped) == {T // PAGE_SIZE},
        "prefill_tokens_every_prompt_token": beng.prefill_tokens == ceng.prefill_tokens
        == sum(len(p) for p in prompts),
        "no_page_in_use_after": beng.alloc.pages_in_use == ceng.alloc.pages_in_use == 0,
    }
    emit({"phase": phase, "step": "paged_checks", **checks, "ring_slots": T,
          "ring_wraps": max(len(p) for p in prompts) + max_new - 1 > T})
    del beng, ceng

    # one decode-shaped forward past the ring's wrap, reading nothing back
    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True))
    sync = {}
    for name, page_size in (("dense", None), ("paged", PAGE_SIZE)):
        cache = make_cache(cfg, SLOTS, MAX_LEN, ctx, page_size=page_size, device=DEV)
        cache["overflow"] = torch.zeros(SLOTS, dtype=torch.bool, device=DEV)
        cache["index"].fill_(T + 5)
        tok = torch.arange(1, SLOTS + 1, dtype=torch.int32, device=DEV)[:, None]
        live = torch.ones((SLOTS, 1), dtype=torch.bool, device=DEV)
        with torch.no_grad():
            model_forward(lut, {"tokens": tok, "token_mask": live}, ctx, cache=cache)
            torch.cuda.synchronize()
            reset_launches()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out, _, _ = model_forward(lut, {"tokens": tok, "token_mask": live}, ctx,
                                          cache=cache)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        sync[name] = {"launches": {k: v for k, v in read_launches().items() if v},
                      "plain_pack_codes_calls": plain_pack_codes_calls(),
                      "table_copies": lut_ops.TABLE_COPIES["table_operand"],
                      "finite": bool(torch.isfinite(out).all().item())}
        del cache
    emit({"phase": phase, "step": "sync_debug", **sync})
    for name, r in sync.items():
        if (r["launches"] != per_forward or r["plain_pack_codes_calls"] or r["table_copies"]
                or not r["finite"]):
            raise AssertionError(f"{phase}: the {name} forward under sync debug: {r}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{phase}: failed paged checks {failed}")

    attn = recipe_layer_calls(phase, lut, iters, parts=("attn",))
    experts = experts_layer_calls(phase, lut, cfg, iters)
    emit({"phase": phase, "step": "layer", "calls": "attention and experts",
          **{k: attn[k] + experts[k] for k in experts}, "nvidia_smi": smi_line()})
    mixtral_ring(phase, lut, cfg, per_forward)
    del lut
    torch.cuda.empty_cache()
    return {"launches": launches}


def read_launches() -> dict:
    return {k: v for counts in _launch_counts() for k, v in counts.items()}


def no_launches() -> dict:
    """Every kernel's name with a count of 0 (what a path that does not run
    a kernel expects of it)."""
    return dict.fromkeys(read_launches(), 0)


def serve_requests(cfg, requests: int):
    """The serve phases' requests: prompts of 8..32 tokens from a seed."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [
        rng.integers(0, cfg.vocab_size, int(rng.integers(8, 33))).astype(np.int32)
        for _ in range(requests)
    ]


def run_engine(params, cfg, prompts, max_new: int, use_kernels: bool, cuda_graph=None,
               engine=None, watch=None, steps=None, **ex):
    """Serve ``prompts`` through ``BatchingEngine`` (SLOTS slots of MAX_LEN,
    bucket BUCKET, grouped launches; ``engine`` further engine arguments
    such as ``page_size``, or others in their place,
    ``ex`` further ExecCfg fields) on the kernels or the plain versions, the
    decode step as graph replays (the engine's default on the card, on
    either path) or eager (``cuda_graph=False``); returns the requests, the
    engine, the wall seconds and each pure decode step's ms.  ``watch(eng)``,
    if given, is called once before the first step and returns a callable
    run after every step.  ``steps``, if given, a list that gets ``(prefilled,
    ms)`` of every step."""
    import torch

    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.serve import BatchingEngine, Request

    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True, use_kernels=use_kernels, **ex))
    kw = {"num_slots": SLOTS, "max_len": MAX_LEN, "prefill_bucket": BUCKET, **(engine or {})}
    eng = BatchingEngine(params, ctx, device=DEV, cuda_graph=cuda_graph, **kw)
    after_step = watch(eng) if watch is not None else None
    reqs = [Request(i, pr, max_new) for i, pr in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    decode_ms = []
    torch.cuda.synchronize()
    start = time.perf_counter()
    while True:
        before, t = eng.prefill_tokens, time.perf_counter()
        if not eng.step():
            break
        ms = (time.perf_counter() - t) * 1e3
        if eng.prefill_tokens == before:  # a pure decode step
            decode_ms.append(ms)
        if steps is not None:
            steps.append((eng.prefill_tokens != before, ms))
        if after_step is not None:
            after_step()
    return reqs, eng, time.perf_counter() - start, decode_ms


def plain_graph_gate(phase: str, params, cfg, prompts, max_new: int, eager_reqs,
                     eager_decode, **ex) -> None:
    """The plain versions' eager engine run (``eager_reqs`` / ``eager_decode``,
    ``max_new`` tokens a request of ``prompts``) again on its first SLOTS
    requests under the engine's default CUDA graph.  Those requests fill the
    slots alone in both runs (no request ends early), so their streams must
    equal the eager run's whole.  The graph run's first step admits them and
    warms up, the second captures, the rest replay: the line reports the
    replayed steps' ms apart from the capture's, and fails unless the step
    was captured, replayed at least once and the streams are equal."""
    steps = []
    reqs, eng, wall, _ = run_engine(params, cfg, prompts[:SLOTS], max_new, False, steps=steps,
                                    **ex)
    identical = [r.generated for r in reqs] == [r.generated for r in eager_reqs[:SLOTS]]
    captured = bool(eng.cuda_graph and eng._graph is not None)
    replays = [ms for prefilled, ms in steps[2:] if not prefilled]
    emit({"phase": phase, "step": "plain_graph_vs_eager", "requests": len(reqs),
          "new_tokens": max_new, "graph_wall_s": wall,
          "capture_step_ms": steps[1][1] if len(steps) > 1 else None,
          "replays": len(replays),
          "replay_median_decode_step_ms": statistics.median(replays) if replays else None,
          "eager_median_decode_step_ms": statistics.median(eager_decode),
          "captured": captured, "streams_identical": identical})
    if not (captured and replays and identical):
        raise AssertionError(f"{phase}: the plain graph engine (captured {captured}, "
                             f"{len(replays)} replays) does not serve the eager plain "
                             "engine's streams")


def prefill_inputs(prompts):
    """The first SLOTS prompts right-padded into one masked prefill batch."""
    import numpy as np
    import torch

    tok = np.zeros((SLOTS, BUCKET), np.int32)
    mask = np.zeros((SLOTS, BUCKET), bool)
    for i in range(SLOTS):
        tok[i, : len(prompts[i])] = prompts[i]
        mask[i, : len(prompts[i])] = True
    return {"tokens": torch.from_numpy(tok).to(DEV),
            "token_mask": torch.from_numpy(mask).to(DEV)}


# ---------------------------------------------------------------------------
# TL1 kernel phase
# ---------------------------------------------------------------------------


def tl1_bound(G, B, kb, p):
    """Least time for the card: the packed tables, the codes and the output
    once over HBM bandwidth; or the adds over the add rate.  The least work
    is one add per packed byte per column (an 81-entry LUT per packed byte,
    i.e. per pair of pairs), plus building those LUTs: the two 9-entry pair
    LUTs and the 81 entries, one add each, per token and packed byte."""
    nbytes = G * kb * p + B * 4 * kb * 4 + G * B * p * 4
    ops = G * B * kb * p + B * kb * (2 * 9 + 81)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ADDS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def int_mm_fn(codes, tables):
    """One cuBLAS call computing the same int32 accumulate: ``_int_mm`` of
    the int8 codes (rows padded to 32, as it takes no fewer than 17) and
    the unpacked int8 ternary weights of all G members side by side,
    stored column-major.
    Returns ``(calls, result reshaped to (G, B, p))``, one call for each of
    :func:`copies_of` the weights; ``(None, None)`` where ``_int_mm``
    refuses the shape."""
    import torch

    from repro_torch.core.lut_tl1 import unpack_indices

    G, kb, p = tables.shape
    B = codes.shape[0]
    if p % 8 or kb % 2 or codes.is_floating_point():  # _int_mm: dims multiples of 8
        return None, None
    idx = unpack_indices(tables)  # (G, 2kb, p): pair j covers elements 2j, 2j+1
    t = torch.stack([idx // 3 - 1, idx % 3 - 1], dim=2).reshape(G, 4 * kb, p)
    # column-major, the layout cuBLAS's int8 tensor-core GEMM takes as is
    w = t.to(torch.int8).permute(1, 0, 2).reshape(4 * kb, G * p).t().contiguous().t()
    rows = max(32, -(-B // 8) * 8)
    a = torch.zeros((rows, 4 * kb), dtype=torch.int8, device=codes.device)
    a[:B] = codes.to(torch.int8)
    calls = [functools.partial(torch._int_mm, a, c) for c in copies_of(w)]
    return calls, calls[0]()[:B].reshape(B, G, p).permute(1, 0, 2)


def run_tl1_case(name, acts, act_scale, tables, scale, bias, iters, plain_iters, plan):
    """Kernel vs plain on one case under ``plan`` (which sets the kernel's
    entry width): the int path bit for bit (raw accumulate and dequantized
    output), the fp32 path within TL1_TOL x max|plain|; then the kernel's,
    the plain version's and ``_int_mm``'s times."""
    import torch

    from repro_torch.kernels.lut_tl1 import ops
    from repro_torch.kernels.lut_tl1.ref import lut_tl1_grouped_ref

    G, kb, p = tables.shape
    exact = not acts.is_floating_point()
    if name == "lut_tl1":
        got = ops.lut_tl1(acts, tables[0], act_scale, scale[0], bias=bias[0], plan=plan)[None]
        want = ops.lut_tl1(
            acts, tables[0], act_scale, scale[0], bias=bias[0], use_kernels=False
        )[None]
    else:
        got = ops.lut_tl1_grouped(acts, tables, act_scale, scale, biases=bias, plan=plan)
        want = ops.lut_tl1_grouped(
            acts, tables, act_scale, scale, biases=bias, use_kernels=False
        )
    flat = acts.reshape(-1, acts.shape[-1])
    B = flat.shape[0]
    raw = ops._launch(name, flat, tables, plan)
    torch.cuda.synchronize()
    raw_plain = lut_tl1_grouped_ref(flat, tables)
    err = max((got - want).abs().max().item(), (raw - raw_plain).abs().max().item())
    scale_ref = want.abs().max().item()
    tol = 0.0 if exact else TL1_TOL * scale_ref
    if not (err <= tol and torch.isfinite(got).all().item()):
        raise AssertionError(f"{name} B={B} kb={kb} p={p} G={G}: err {err} > tol {tol}")
    lib, lib_out = int_mm_fn(flat, tables)
    if lib_out is not None and not torch.equal(lib_out, raw):
        raise AssertionError(f"{name} B={B} kb={kb} p={p}: _int_mm disagrees with the kernel")
    del got, want, raw, raw_plain, lib_out
    ms = device_ms(
        [functools.partial(ops._launch, name, flat, t, plan) for t in copies_of(tables)], iters
    )
    plain_ms = device_ms(
        [lambda: lut_tl1_grouped_ref(flat, tables)], plain_iters, warmup=1, hold=False
    )
    lib_ms = device_ms(lib, iters) if lib is not None else None
    bms, by = tl1_bound(G, B, kb, p)
    return {
        "max_abs_err": err, "tol": tol,
        "tol_reason": "int path: integer accumulate, bit for bit" if exact
        else f"{TL1_TOL} x max|plain|: fp32 sums in another order",
        "int_mm_agrees": None if lib is None else True,
        "entry": ops.entry_format(plan, not exact),
        "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": lib_ms,
    }


def tl1_kernel_phase(iters: int, prefill_rows: int) -> dict:
    import torch

    from repro_torch.core.lut_tl1 import TL1Plan, build_tl1_tables, quantize_acts

    gen = torch.Generator(device=DEV).manual_seed(2)
    worst = {"lut_tl1": 0.0, "lut_tl1_grouped": 0.0}
    main = {}  # decode-shape numbers per kernel, summed over one layer's calls
    for rows in (4, prefill_rows):
        for name, shapes in (("lut_tl1", LONE), ("lut_tl1_grouped", GROUPED)):
            for proj, (G, q, p) in shapes.items():
                plan = TL1Plan(q, p, act_bits=8)
                built = [
                    build_tl1_tables(torch.randn(q, p, generator=gen, device=DEV))
                    for _ in range(G)
                ]
                tables = torch.stack([t for t, _ in built])
                scale = torch.stack([s for _, s in built])
                bias = torch.randn(G, p, generator=gen, device=DEV)
                x = torch.randn(rows, q, generator=gen, device=DEV)
                codes, act_scale = quantize_acts(x, plan)
                r = run_tl1_case(name, codes, act_scale, tables, scale, bias, iters,
                                 5 if rows > 4 else 10, plan)
                emit({"phase": "tl1_kernel", "kernel": name, "proj": proj, "rows": rows,
                      "G": G, "q": q, "kb": plan.packed_chunks, "p": p, "act_bits": 8, **r})
                worst[name] = max(worst[name], r["max_abs_err"])
                if rows == 4:
                    m = main.setdefault(name, {"kernel_ms": 0.0, "plain_ms": 0.0,
                                               "bound_ms": 0.0, "library_ms": 0.0,
                                               "bound_by": set()})
                    for key in ("kernel_ms", "plain_ms", "bound_ms", "library_ms"):
                        m[key] += r[key]
                    m["bound_by"].add(r["bound_by"])
                del tables, built, codes
                torch.cuda.empty_cache()
    # grid: int8 / int4 / exact fp32 codes, ragged q (zero-padded tail),
    # p off the 1024-column tile and off 4, leading dims, few packed rows,
    # packed rows around the 64-row stage of the int16 entries, G = 3; the
    # first token's codes at +-qa, where folded entries are largest
    grid = [
        # lead, kb, p, G
        ((2, 5), 77, 130, 2),
        ((3,), 50, 67, 2),
        ((40,), 9, 256, 2),
        ((1,), 300, 1000, 1),
        ((4,), 63, 1030, 3),
        ((9,), 65, 2100, 2),
        ((4,), 129, 513, 3),
    ]
    for act_bits in (8, 4, None):
        for lead, kb, p, G in grid:
            q = 4 * kb - 3
            if act_bits is None:
                acts = torch.randn(lead + (4 * kb,), generator=gen, device=DEV)
                act_scale = None
            else:
                qa = 2 ** (act_bits - 1) - 1
                acts = torch.randint(-qa, qa + 1, lead + (4 * kb,), generator=gen,
                                     device=DEV, dtype=torch.int32)
                act_scale = torch.rand(lead + (1,), generator=gen, device=DEV)
                first = acts.view(-1, 4 * kb)[0]
                first.copy_(torch.where(first < 0, -qa, qa))
            acts[..., q:] = 0
            nib = torch.randint(0, 9, (G, kb, p, 2), generator=gen, device=DEV)
            tables = (nib[..., 0] | (nib[..., 1] << 4)).to(torch.uint8)
            scale = torch.rand(G, generator=gen, device=DEV)
            bias = torch.randn(G, p, generator=gen, device=DEV)
            for name in ("lut_tl1", "lut_tl1_grouped"):
                t, s, b = (tables[:1], scale[:1], bias[:1]) if name == "lut_tl1" \
                    else (tables, scale, bias)
                r = run_tl1_case(name, acts, act_scale, t, s, b, iters, 5,
                                 TL1Plan(q, p, act_bits=act_bits))
                emit({"phase": "tl1_kernel", "kernel": name, "grid": True,
                      "lead": list(lead), "G": t.shape[0], "q": q, "kb": kb, "p": p,
                      "act_bits": act_bits, **r})
    return {"worst": worst, "main": main}


# ---------------------------------------------------------------------------
# TL1 serve phase
# ---------------------------------------------------------------------------


def tl1_serve_phase(layers: int, requests: int, max_new: int) -> dict:
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.convert import conversion_summary, convert_params
    from repro_torch.core.planner import plan_model
    from repro_torch.kernels.lut_affine.autotune import attach_tuned_blocks
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.models.model import model_forward, model_specs
    from repro_torch.models.params import init_params
    from repro_torch.serve import make_cache

    full = get_config("granite_8b")
    cfg = dataclasses.replace(full, num_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(model_specs(cfg), gen, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the reference's serving_tl1_plan: every projection into TL1, int8
    # activations, then tiles tuned at the slots (Hopper tiles here)
    mplan = attach_tuned_blocks(plan_model(params, float("inf"), families=("tl1",)),
                                batch=SLOTS)
    emit({"phase": "tl1_serve", "step": "plan", "summary": mplan.summary(),
          "blocks": plan_blocks(mplan),
          "families": list(mplan.families), "table_mib": mplan.total_lut_bytes / 2**20,
          "table_mib_per_layer": mplan.total_lut_bytes / layers / 2**20,
          "act_bits": sorted({p.act_bits for p in mplan.layers.values()}),
          "depth": {"layers": layers, "published": full.num_layers},
          "init_seconds": init_s})
    t0 = time.perf_counter()
    tl1, report = convert_params(params, plan=mplan)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    peak_convert = torch.cuda.max_memory_allocated() / 2**30
    del params
    torch.cuda.empty_cache()
    emit({"phase": "tl1_serve", "step": "convert", "summary": conversion_summary(report),
          "seconds": convert_s, "max_memory_allocated_gib": peak_convert,
          "table_bytes": report.table_bytes, "planned_fp32_gib": report.weight_bytes / 2**30,
          "memory_allocated_after_free_gib": torch.cuda.memory_allocated() / 2**30})
    if report.table_bytes != mplan.total_lut_bytes:
        raise AssertionError(f"tables {report.table_bytes} B != plan {mplan.total_lut_bytes} B")

    prompts = serve_requests(cfg, requests)
    torch.cuda.reset_peak_memory_stats()
    per_forward = {"lut_tl1": 3 * layers, "lut_tl1_grouped": 2 * layers}
    reqs, eng, wall, decode_ms, launches, _ = serve_paths(
        "tl1_serve", tl1, cfg, prompts, max_new, per_forward)
    forwards = eng.readbacks
    expect = {**no_launches(), **{k: v * forwards for k, v in per_forward.items()}}
    tokens = sum(len(r.generated) for r in reqs)
    emit({"phase": "tl1_serve", "step": "kernels", "requests": len(reqs), "tokens": tokens,
          "tok_per_s": tokens / wall, "wall_s": wall,
          "median_decode_step_ms": statistics.median(decode_ms),
          "forwards": forwards, "launches": launches, "expected_launches": expect,
          "per_forward": per_forward,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
    if launches != expect or forwards <= 0:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    if not all(len(r.generated) == max_new for r in reqs):
        raise AssertionError("a request stopped short of max_new")
    tiles_ab("tl1_serve", tl1, cfg, prompts, max_new, per_forward, exact=True)

    # the plain versions serve PLAIN_NEW tokens a request (at 16 this run
    # took ~25 s of the call), held to the kernel run's streams on the
    # tokens they serve
    plain_new = min(max_new, PLAIN_NEW)
    plain_reqs, _, plain_wall, plain_decode = run_engine(tl1, cfg, prompts, plain_new, False,
                                                         cuda_graph=False)
    plain_graph_gate("tl1_serve", tl1, cfg, prompts, plain_new, plain_reqs, plain_decode)
    plain_tokens = sum(len(r.generated) for r in plain_reqs)
    same = sum(
        x == y for a, b in zip(reqs, plain_reqs) for x, y in zip(a.generated, b.generated)
    )
    identical = all(len(b.generated) == plain_new and a.generated[:plain_new] == b.generated
                    for a, b in zip(reqs, plain_reqs))
    emit({"phase": "tl1_serve", "step": "plain", "layers": layers, "new_tokens": plain_new,
          "tok_per_s": plain_tokens / plain_wall, "wall_s": plain_wall,
          "median_decode_step_ms": statistics.median(plain_decode),
          "streams_identical": identical, "identical_token_share": same / plain_tokens})
    if not identical:
        raise AssertionError("kernel and plain paths disagree on a TL1 stream")

    inputs = prefill_inputs(prompts)

    def prefill_logits(use_kernels: bool):
        ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True, use_kernels=use_kernels))
        cache = make_cache(cfg, SLOTS, MAX_LEN, ctx, device=DEV)
        with torch.no_grad():
            logits, _, _ = model_forward(tl1, inputs, ctx, cache=cache)
        return logits[inputs["token_mask"]]

    got, ref = prefill_logits(True), prefill_logits(False)
    err = (got - ref).abs().max().item()
    tol = TL1_TOL * ref.abs().max().item()
    finite = bool(torch.isfinite(got).all().item())
    emit({"phase": "tl1_serve", "step": "prefill_logits", "layers": layers,
          "shape": list(got.shape), "max_abs_err": err, "max_abs_ref": ref.abs().max().item(),
          "tol": tol, "finite": finite,
          "argmax_agree": (got.argmax(-1) == ref.argmax(-1)).float().mean().item(),
          "tol_reason": f"{TL1_TOL} x max|plain|; the integer TL1 accumulate makes both "
                        "paths compute the same values, so 0 is expected"})
    if not (finite and err <= tol):
        raise AssertionError(f"TL1 prefill logits differ: {err} > {tol}")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# MoE kernel phase
# ---------------------------------------------------------------------------


def moe_fmt_plan(k, p):
    """The serving plan of every qwen2_moe_a2_7b projection at full width."""
    from repro_torch.core.lut import LUTPlan
    from repro_torch.core.quantize import Float16Format

    fmt = Float16Format(signed=True, mantissa_radix=4)
    return LUTPlan(k, p, 1, fmt, mode="bitplane_shift", table_format="i8")


def sorted_expert_of(gs, T):
    """(T,) expert of each expert-sorted row (measurement helper)."""
    import torch

    return torch.repeat_interleave(
        torch.arange(gs.numel(), device=gs.device), gs, output_size=T
    )


def run_experts_case(codes, tables, scales, gs, shift_bits, iters, plain_iters):
    """Kernel vs plain on one ragged case, then the kernel's device time,
    the plain version's time and the bound."""
    import torch

    from repro_torch.kernels.lut_affine import ops

    E, G, k, En, p = tables.shape
    T = codes.shape[0]

    def kern(t=tables):
        return ops.lut_affine_experts(codes, t, scales, gs, shift_bits=shift_bits)

    def plain():
        return ops.lut_affine_experts(
            codes, tables, scales, gs, shift_bits=shift_bits, use_kernels=False
        )

    got = kern()
    torch.cuda.synchronize()
    ref = plain()
    err = (got - ref).abs().max().item() if got.numel() else 0.0
    tol = KERNEL_TOL * (ref.abs().max().item() if ref.numel() else 0.0)
    live = int(gs.sum().item())
    if not (err <= tol and torch.isfinite(got).all().item() and not got[:, live:].any()):
        raise AssertionError(f"lut_affine_experts E={E} G={G} T={T} k={k} p={p}: "
                             f"err {err} > tol {tol} (or a nonzero tail row)")
    del got, ref
    ms = device_ms([functools.partial(kern, c) for c in copies_of(tables)], iters)
    plain_ms = device_ms([plain], plain_iters, warmup=1, hold=False)
    eot = sorted_expert_of(gs, live)
    bms, by = bound(codes[:live], G, En, p, tables.element_size(), shift_bits, expert_of=eot)
    vec = ops.ROW_ALIGN // tables.element_size()
    t = ops.experts_tiling(G, T, k, -(-p // vec) * vec * tables.element_size(),
                           torch.cuda.get_device_properties(0).multi_processor_count)
    return {
        "splits": t.splits, "max_abs_err": err, "tol": tol,
        "tol_reason": f"{KERNEL_TOL} x max|plain|: fp32 sums in another order",
        "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": None, "library_reason": LIBRARY_REASONS["lut_affine_experts"],
    }


def dense_experts_ms(rows, gs, k, p, iters):
    """For context only: the dense bf16 expert products the tables replace,
    each sorted row times its expert's (k, p) weights -- one
    ``torch._grouped_mm`` where this torch has it, else a ``torch.matmul``
    per occupied expert."""
    import torch

    E = gs.numel()
    xs = torch.randn(rows, k, device=DEV, dtype=torch.bfloat16)
    w = torch.randn(E, p, k, device=DEV, dtype=torch.bfloat16).transpose(1, 2)
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    if hasattr(torch, "_grouped_mm"):
        how = "torch._grouped_mm"
        fn = functools.partial(torch._grouped_mm, xs, w, offs=offs)
    else:
        how = "torch.matmul per occupied expert"
        ends = offs.tolist()
        spans = [(e, a, b) for e, (a, b) in enumerate(zip([0] + ends[:-1], ends)) if b > a]

        def fn():
            return [xs[a:b] @ w[e] for e, a, b in spans]
    return device_ms([fn], iters), how


def moe_kernel_phase(iters: int, prefill_tokens: int) -> dict:
    import math

    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.convert import LUTGroup, LUTLinear
    from repro_torch.core.lut import pack_codes, plane_scales
    from repro_torch.kernels import build
    from repro_torch.kernels.lut_affine import ops
    from repro_torch.models import moe
    from repro_torch.models.layers import Ctx, ExecCfg

    cfg = get_config("qwen2_moe_a2_7b")
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    gen = torch.Generator(device=DEV).manual_seed(3)
    router = torch.randn(d, E, generator=gen, device=DEV) / math.sqrt(d)
    plans = {"w_gate+w_up": (2, moe_fmt_plan(d, f)), "w_down": (1, moe_fmt_plan(f, d))}
    tables = {
        name: torch.randint(-127, 128, (E, G, plan.num_chunks, plan.num_entries,
                                        plan.out_features),
                            generator=gen, device=DEV, dtype=torch.int8)
        for name, (G, plan) in plans.items()
    }
    dequant = 2.0**-6
    worst, main = 0.0, {"kernel_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                        "bound_by": set(), "prefill_ms": 0.0, "prefill_bound_ms": 0.0}
    for tokens in (SLOTS, prefill_tokens):
        # real routing of seeded activations through a seeded router
        x = torch.randn(tokens, d, generator=gen, device=DEV)
        _, _, order, token_of, gs = moe.dispatch(x, router, cfg)
        T = token_of.numel()
        h = torch.randn(T, f, generator=gen, device=DEV) * 0.1
        for name, (G, plan) in plans.items():
            src = x[token_of] if name == "w_gate+w_up" else h
            codes = pack_codes(src, plan)
            scales = plane_scales(plan).astype(np.float32) * np.float32(dequant)
            r = run_experts_case(codes, tables[name], scales, gs, plan.shift_bits, iters,
                                 2 if T > 16 else 5)
            dense, how = dense_experts_ms(T, gs, plan.in_features, G * plan.out_features,
                                          iters)
            emit({"phase": "moe_kernel", "kernel": "lut_affine_experts", "proj": name,
                  "tokens": tokens, "rows": T, "experts": E,
                  "occupied_experts": int((gs > 0).sum().item()), "G": G,
                  "n": plan.num_planes, "k": plan.num_chunks, "En": plan.num_entries,
                  "p": plan.out_features, "table": "i8", "shift_bits": plan.shift_bits,
                  **r, "dense_bf16_ms": dense, "dense_bf16_how": how})
            worst = max(worst, r["max_abs_err"])
            if tokens == SLOTS:
                for key in ("kernel_ms", "plain_ms", "bound_ms"):
                    main[key] += r[key]
                main["bound_by"].add(r["bound_by"])
            else:  # the engine's prefill: summed over the layer's calls
                main["prefill_ms"] += r["kernel_ms"]
                main["prefill_bound_ms"] += r["bound_ms"]
            if tokens == SLOTS and name == "w_gate+w_up":  # a split launch
                determinism("moe_kernel", "lut_affine_experts", functools.partial(
                    ops.lut_affine_experts, codes, tables[name], scales, gs,
                    shift_bits=plan.shift_bits),
                    {"proj": name, "rows": T, "k": plan.num_chunks, "p": plan.out_features,
                     "splits": r["splits"]})
        torch.cuda.empty_cache()

    # grid: table types x shift_bits, empty experts, every row on one
    # expert, T = 1, ragged T and p, G 1/2/3, a zero tail past the groups
    grid = [
        # E, G, T, n, k, En, p, group sizes
        (5, 2, 11, 3, 77, 32, 130, (3, 0, 6, 2, 0)),
        (3, 3, 9, 3, 40, 32, 96, (0, 9, 0)),
        (4, 1, 1, 3, 64, 32, 67, (0, 0, 1, 0)),
        (6, 1, 30, 3, 33, 32, 64, (5, 1, 0, 7, 4, 2)),
        (60, 2, 37, 3, 48, 32, 45, tuple(int(v) for v in np.bincount(
            np.random.default_rng(0).integers(0, 60, 37), minlength=60))),
    ]
    for dtype in (torch.float32, torch.bfloat16, torch.int8, torch.int16):
        for shift in (0, 5):
            for Ex, G, T, n, k, En, p, sizes in grid:
                c, t, s = make_case(gen, T, n, k, En, p, Ex * G, dtype, shift,
                                    np.asarray([1.0, -16.0, 2.0**-5], np.float32))
                t = t.reshape(Ex, G, k, En, p)
                gs = torch.tensor(sizes, dtype=torch.int64, device=DEV)
                r = run_experts_case(c, t, s, gs, shift, iters, 5)
                emit({"phase": "moe_kernel", "kernel": "lut_affine_experts", "grid": True,
                      "experts": Ex, "G": G, "rows": T, "live_rows": sum(sizes), "n": n,
                      "k": k, "En": En, "p": p, "table": str(dtype).replace("torch.", ""),
                      "shift_bits": shift, **r})

    # one decode-shaped moe_ffn on the kernels with the stream's sync
    # debugging set to raise: routing, sort, dispatch and combine must not
    # read the device back
    shared = {"w_gate+w_up": (2, moe_fmt_plan(d, cfg.d_ff)),
              "w_down": (1, moe_fmt_plan(cfg.d_ff, d))}
    sh = {}
    for name, (G, plan) in shared.items():
        shape = (G,) if G > 1 else ()
        t = torch.randint(-127, 128, shape + (plan.num_chunks, plan.num_entries,
                                              plan.out_features),
                          generator=gen, device=DEV, dtype=torch.int8)
        sh[name] = (LUTGroup(t, plan, ("w_gate", "w_up"), scale=torch.tensor(dequant))
                    if G > 1 else LUTLinear(t, plan, scale=torch.tensor(dequant)))
    params = {
        "router": router,
        "w_gate+w_up": LUTGroup(tables["w_gate+w_up"], plans["w_gate+w_up"][1],
                                ("w_gate", "w_up"), scale=torch.tensor(dequant)),
        "w_down": LUTLinear(tables["w_down"][:, 0], plans["w_down"][1],
                            scale=torch.tensor(dequant)),
        "shared": sh,
        "shared_gate": torch.randn(d, 1, generator=gen, device=DEV) / math.sqrt(d),
    }
    x = torch.randn(SLOTS, 1, d, generator=gen, device=DEV)
    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True))
    with torch.no_grad():
        moe.moe_ffn(params, x, ctx)  # warm: the first call builds nothing new
        torch.cuda.synchronize()
        before = dict(ops.LAUNCHES)
        torch.cuda.set_sync_debug_mode("error")
        y, aux = moe.moe_ffn(params, x, ctx)
        torch.cuda.set_sync_debug_mode(0)
        launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
        want, _ = moe.moe_ffn(params, x, Ctx(cfg, ex=ExecCfg(lut_grouped=True,
                                                             use_kernels=False)))
    err = (y - want).abs().max().item()
    scale = want.abs().max().item()
    expect = {"lut_affine": 1, "lut_affine_grouped": 1, "lut_affine_experts": 2}
    emit({"phase": "moe_kernel", "step": "moe_ffn_sync_debug", "sync_debug_mode": "error",
          "raised": False, "x": list(x.shape), "launches": launched,
          "expected_launches": expect, "max_abs_err": err, "max_abs_ref": scale,
          "tol": LOGITS_TOL * scale, "aux": aux.item()})
    if launched != expect:
        raise AssertionError(f"moe_ffn launches {launched} != {expect}")
    if not err <= LOGITS_TOL * scale:
        raise AssertionError(f"moe_ffn kernel vs plain: {err} > {LOGITS_TOL * scale}")
    del tables, params, sh
    torch.cuda.empty_cache()
    emit({"phase": "moe_kernel", "step": "ptxas",
          "kernels": {k: v for k, v in ptxas_report(build.BUILD_LOG.get("lut_affine", "")).items()
                      if "experts" in k}})
    return {"worst": {"lut_affine_experts": worst}, "main": {"lut_affine_experts": main}}


# ---------------------------------------------------------------------------
# MoE serve phase
# ---------------------------------------------------------------------------


def moe_depth(full) -> tuple[int, dict]:
    """Layers of full-width ``full`` that convert on this card: a 1-layer
    plan's table bytes (on shapes alone) plus the fp32 weights held while
    converting, against the card's memory less MOE_HEADROOM."""
    import torch

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        return tree.numel() * tree.element_size()

    one = meta_params(dataclasses.replace(full, num_layers=1))
    plan, uncapped = recipe_plans(one, convert_experts=True)
    head = plan.layers["lm_head"].total_lut_bytes
    layer_tables = plan.total_lut_bytes - head
    layer_fp32 = nbytes(one["blocks"])
    rest_fp32 = nbytes(one) - layer_fp32
    total = torch.cuda.get_device_properties(0).total_memory
    avail = total - MOE_HEADROOM

    def peak(n):
        return head + n * (layer_tables + layer_fp32) + rest_fp32

    layers = max([n for n in range(1, full.num_layers + 1) if peak(n) <= avail] or [0])
    if layers < 1:
        raise AssertionError(f"not one layer of {full.name} fits: {peak(1) / 2**30:.1f} GiB")
    gib = 2**30
    return layers, {
        "layers": layers, "published": full.num_layers,
        "table_gib_per_layer": layer_tables / gib, "lm_head_table_gib": head / gib,
        "conversion_peak_gib": peak(layers) / gib,
        "next_depth_peak_gib": peak(layers + 1) / gib,
        "card_gib": total / gib, "headroom_gib": MOE_HEADROOM / gib,
        "uncapped_recipe_table_gib_1_layer": uncapped.total_lut_bytes / gib,
        "reason": f"{layer_tables / gib:.1f} GiB of i8 tables per layer and "
                  f"{head / gib:.1f} GiB for lm_head: converting {layers} layers peaks at "
                  f"{peak(layers) / gib:.1f} GiB with the fp32 weights, {layers + 1} "
                  f"would reach {peak(layers + 1) / gib:.1f} GiB, over the card's "
                  f"{total / gib:.1f} GiB less {MOE_HEADROOM / gib:.0f} GiB kept for the "
                  f"plain path's 1 GiB gathers and the allocator; all {full.num_layers} "
                  f"layers would need {(head + full.num_layers * layer_tables) / gib:.0f} "
                  "GiB of tables; widths are the published ones",
        "chunk_cap_reason": "the recipe's halved uniform budget admits chunk-2 tables at "
                            "full width (a 1-layer plan of "
                            f"{uncapped.total_lut_bytes / gib:.0f} GiB); at chunk 1 it "
                            "plans what it plans on the reduced config",
    }


def moe_serve_phase(requests: int, max_new: int) -> dict:
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.convert import conversion_summary, convert_params
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.models.model import model_forward, model_specs
    from repro_torch.models.params import init_params
    from repro_torch.serve import make_cache

    full = get_config("qwen2_moe_a2_7b")
    torch.cuda.empty_cache()
    layers, depth = moe_depth(full)
    cfg = dataclasses.replace(full, num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(model_specs(cfg), gen, device=DEV)
    mplan, _ = recipe_plans(params, convert_experts=True)
    kinds = sorted({
        f"{p.mode}-r{p.fmt.mantissa_radix}-{p.table_format}-c{p.chunk_size}"
        for p in mplan.layers.values()
    })
    emit({"phase": "moe_serve", "step": "plan", "summary": mplan.summary(),
          "table_mib": mplan.total_lut_bytes / 2**20, "plans": kinds,
          "groups": [list(g) for g in mplan.groups], "depth": depth})
    lut, report = convert_params(params, plan=mplan, convert_experts=True)
    torch.cuda.synchronize()
    peak_convert = torch.cuda.max_memory_allocated() / 2**30
    del params
    torch.cuda.empty_cache()
    emit({"phase": "moe_serve", "step": "convert", "summary": conversion_summary(report),
          "seconds": time.perf_counter() - t0, "max_memory_allocated_gib": peak_convert,
          "table_bytes": report.table_bytes,
          "memory_allocated_after_free_gib": torch.cuda.memory_allocated() / 2**30})
    if report.table_bytes != mplan.total_lut_bytes:
        raise AssertionError(f"tables {report.table_bytes} B != plan {mplan.total_lut_bytes} B")

    prompts = serve_requests(cfg, requests)
    torch.cuda.reset_peak_memory_stats()
    # packs: the attention group, wo, the routed gate+up (once per token)
    # and w_down, the shared expert's gate+up and w_down, and lm_head
    per_forward = {"lut_affine": 2 * layers + 1, "lut_affine_grouped": 2 * layers,
                   "lut_affine_experts": 2 * layers, "bitplane_pack": 6 * layers + 1}
    reqs, eng, wall, decode_ms, launches, uncovered = serve_paths(
        "moe_serve", lut, cfg, prompts, max_new, per_forward, eager_pack_profile=True)
    forwards = eng.readbacks
    expect = {**no_launches(), **{k: v * forwards for k, v in per_forward.items()}}
    tokens = sum(len(r.generated) for r in reqs)
    emit({"phase": "moe_serve", "step": "kernels", "requests": len(reqs), "tokens": tokens,
          "tok_per_s": tokens / wall, "wall_s": wall,
          "median_decode_step_ms": statistics.median(decode_ms),
          "forwards": forwards, "launches": launches, "expected_launches": expect,
          "per_forward": per_forward, "plain_pack_codes_calls": uncovered,
          "table_mib": report.table_bytes / 2**20,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
    if launches != expect or forwards <= 0 or uncovered:
        raise AssertionError(f"launch counts {launches} != expected {expect}, "
                             f"or {uncovered} packs off the kernel")
    if not all(len(r.generated) == max_new for r in reqs):
        raise AssertionError("a request stopped short of max_new")

    with count_plain_packs() as packs:
        plain_reqs, _, plain_wall, plain_decode = run_engine(lut, cfg, prompts, max_new,
                                                             False, cuda_graph=False)
    plain_graph_gate("moe_serve", lut, cfg, prompts, max_new, plain_reqs, plain_decode)
    first_ok = all(a.generated[0] == b.generated[0] for a, b in zip(reqs, plain_reqs))
    same = sum(
        x == y for a, b in zip(reqs, plain_reqs) for x, y in zip(a.generated, b.generated)
    )
    emit({"phase": "moe_serve", "step": "plain", "tok_per_s": tokens / plain_wall,
          "wall_s": plain_wall, "median_decode_step_ms": statistics.median(plain_decode),
          "first_tokens_identical": first_ok, "identical_token_share": same / tokens,
          "pack_codes_calls": packs["calls"]})
    if not first_ok:
        raise AssertionError("kernel and plain paths disagree on a first token")
    if packs["calls"] != launches["bitplane_pack"]:
        raise AssertionError(f"the plain run packed {packs['calls']} times, the kernel run "
                             f"{launches['bitplane_pack']}")

    inputs = prefill_inputs(prompts)

    def prefill_logits(use_kernels: bool):
        ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True, use_kernels=use_kernels))
        cache = make_cache(cfg, SLOTS, MAX_LEN, ctx, device=DEV)
        with torch.no_grad():
            logits, _, _ = model_forward(lut, inputs, ctx, cache=cache)
        return logits[inputs["token_mask"]]

    got, ref = prefill_logits(True), prefill_logits(False)
    with plain_gather_bytes(64 * 2**20):
        other = prefill_logits(False)
    res, floor = compare_logits(got, ref), compare_logits(other, ref)
    finite = bool(torch.isfinite(got).all().item())
    tol = LOGITS_TOL * res["max_abs_ref"]
    emit({"phase": "moe_serve", "step": "prefill_logits", "layers": layers,
          "shape": list(got.shape), **res, "tol": tol, "rel_fro_tol": LOGITS_FRO_TOL,
          "finite": finite, "plain_vs_plain": floor,
          "tol_reason": "as the serve phase's: the paths sum in other orders, an "
                        "activation near an fp16 rounding boundary takes the neighbouring "
                        "code before the next lookup, and top-k routing is a second "
                        "discontinuity"})
    if not (finite and res["max_abs_err"] <= tol and res["rel_fro_err"] <= LOGITS_FRO_TOL):
        raise AssertionError(f"MoE prefill logits differ: {res} (tol {tol}, {LOGITS_FRO_TOL})")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# binary-matmul kernel phase
# ---------------------------------------------------------------------------


def pack_bound(x, n, k):
    """Least time for the card: the input read once and the codes written
    once over HBM bandwidth; or, per element, a multiply, a rounding and two
    clamps, and per plane a shift, a mask and an OR, over the add rate."""
    B, q = x.shape
    nbytes = x.numel() * x.element_size() + B * n * k * 4
    ops = B * q * (4 + 3 * n)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ADDS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bmm_bound(planes, W, p):
    """Least time for the card: the planes and W read once and the output
    written once over HBM bandwidth; or the 2*(B*n)*q*p products and sums of
    the folded GEMM over the bf16 tensor-core rate."""
    B, n, q = planes.shape
    nbytes = planes.numel() * planes.element_size() + W.numel() * W.element_size() + B * p * 4
    ops = 2 * B * n * q * p
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def run_pack_case(x, iters, plain_iters, **kw):
    """Kernel vs plain packing, bit for bit; then their times and the bound."""
    import torch

    from repro_torch.kernels.bitplane_pack import ops

    got = ops.bitplane_pack(x, **kw)
    torch.cuda.synchronize()
    want = ops.bitplane_pack(x, use_kernels=False, **kw)
    if not torch.equal(got, want):
        bad = int((got != want).sum().item())
        raise AssertionError(f"bitplane_pack {kw} x{list(x.shape)}: {bad} codes differ")
    n, k = got.shape[-2:]
    bms, by = pack_bound(x.reshape(-1, x.shape[-1]), n, k)
    return {
        "max_abs_err": 0, "tol": 0, "tol_reason": "integer codes: bit for bit",
        "kernel_ms": device_ms([lambda: ops.bitplane_pack(x, **kw)], iters),
        "plain_ms": device_ms([lambda: ops.bitplane_pack(x, use_kernels=False, **kw)],
                              plain_iters, warmup=1, hold=False),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "library_reason": LIBRARY_REASONS["bitplane_pack"],
    }, got


def check_bmm(planes, W, scales, bias=None):
    """Kernel vs plain binary matmul within KERNEL_TOL x max|plain|."""
    import torch

    from repro_torch.kernels.binary_matmul import ops

    got = ops.binary_matmul(planes, W, scales, bias=bias)
    torch.cuda.synchronize()
    want = ops.binary_matmul(planes, W, scales, bias=bias, use_kernels=False)
    err = (got - want).abs().max().item()
    tol = KERNEL_TOL * want.abs().max().item()
    if not (err <= tol and torch.isfinite(got).all().item()):
        raise AssertionError(
            f"binary_matmul planes{list(planes.shape)} W{list(W.shape)} {W.dtype}: "
            f"err {err} > tol {tol}"
        )
    return err, tol


def bmm_kernel_phase(iters: int, prefill_rows: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.quantize import FixedPointFormat
    from repro_torch.kernels.binary_matmul import ops as bmm_ops
    from repro_torch.kernels.bitplane_pack import ops as pack_ops

    gen = torch.Generator(device=DEV).manual_seed(4)
    bits, frac = BMM_FIXED
    scales = FixedPointFormat(bits, frac, signed=True).plane_scales()
    pack_kw = dict(kind="fixed", m=1, bits=bits, frac=frac, signed=True)
    worst = {"binary_matmul": 0.0}
    keys = ("kernel_ms", "plain_ms", "bound_ms", "library_ms")
    main = {"binary_matmul": {**dict.fromkeys(keys, 0.0), "bound_by": set()}}
    for rows in (SLOTS, prefill_rows):
        for proj, (q, p, calls) in BMM_SHAPES.items():
            # a normed activation's scale: the 8/6 range [-2, 2) clips its tails
            x = torch.randn(rows, q, generator=gen, device=DEV)
            rp, planes = run_pack_case(x, iters, 10 if rows == SLOTS else 5, **pack_kw)
            emit({"phase": "bmm_kernel", "kernel": "bitplane_pack", "proj": proj, "rows": rows,
                  "q": q, "n": bits, "fixed": [bits, frac], **rp})
            W = torch.randn(q, p, generator=gen, device=DEV) / q**0.5
            Wb = W.to(torch.bfloat16)  # the path's W (models/params.py::bf16_projections)
            err, tol = check_bmm(planes, Wb, scales)
            err32, tol32 = check_bmm(planes, W, scales)  # fp32 W: rounded by the wrapper
            worst["binary_matmul"] = max(worst["binary_matmul"], err, err32)
            wb = copies_of(Wb)
            ms = device_ms(
                [functools.partial(bmm_ops.binary_matmul, planes, w, scales) for w in wb], iters
            )
            folded = planes.reshape(rows * bits, q).to(torch.bfloat16)
            lib_ms = device_ms([functools.partial(torch.matmul, folded, w) for w in wb], iters)
            plain_ms = device_ms(
                [lambda: bmm_ops.binary_matmul(planes, Wb, scales, use_kernels=False)],
                10 if rows == SLOTS else 3, warmup=1, hold=False,
            )
            del wb, folded
            ws = copies_of(W)
            fp32_w_ms = device_ms(
                [functools.partial(bmm_ops.binary_matmul, planes, w, scales) for w in ws], iters
            )
            del ws
            bms, by = bmm_bound(planes, Wb, p)
            emit({"phase": "bmm_kernel", "kernel": "binary_matmul", "proj": proj, "rows": rows,
                  "folded_rows": rows * bits, "q": q, "p": p, "w": "bfloat16",
                  "planes": str(planes.dtype).replace("torch.", ""),
                  "max_abs_err": err, "tol": tol, "fp32_w_max_abs_err": err32,
                  "fp32_w_tol": tol32,
                  "tol_reason": f"{KERNEL_TOL} x max|plain|: exact bit x bf16 products, "
                                "fp32 sums in another order",
                  "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                  "library_ms": lib_ms,
                  "library_how": "torch.matmul of the folded planes and W, both bf16 "
                                 "(cuBLAS; the same W bytes as the kernel; no plane sum)",
                  "kernel_fp32_w_ms": fp32_w_ms,
                  "fp32_w_how": "an fp32 W, rounded to bf16 by the wrapper (one copy) "
                                "before the same kernel; the serve path never takes it",
                  "dense_bf16_ms": dense_ms(rows, 1, q, p, iters),
                  "tile": list(bmm_ops.tile(rows, bits)),
                  "splits": bmm_ops.k_splits(rows, bits, q, p,
                                             bmm_ops._sm_count(torch.device(DEV)))})
            if rows == SLOTS:
                m = main["binary_matmul"]
                for key, v in zip(keys, (ms, plain_ms, bms, lib_ms)):
                    m[key] += calls * v
                m["bound_by"].add(by)
            del W, Wb, planes, x
            torch.cuda.empty_cache()

    # grid, after tests/test_kernels.py: binary_matmul over n 1..16, ragged
    # q and p, leading dims, bias, int8 / int32 planes, fp32 / bf16 W, 800
    # folded rows (not a multiple of the tile), a W at an unaligned base
    for lead, n, q, p, wdt, pdt, bias in [
        ((1,), 1, 1, 1, torch.float32, torch.int8, False),
        ((4,), 8, 100, 30, torch.bfloat16, torch.int8, True),
        ((65,), 11, 300, 140, torch.float32, torch.int32, False),
        ((2,), 16, 513, 257, torch.bfloat16, torch.int32, True),
        ((2, 3), 8, 4096, 1024, torch.float32, torch.int32, True),
        ((5,), 3, 64, 64, torch.float32, torch.int8, False),
        ((100,), 8, 4096, 1024, torch.bfloat16, torch.int32, False),
        ((4,), 8, 1000, 600, "bf16_unaligned", torch.int32, True),
    ]:
        planes = (torch.rand(lead + (n, q), generator=gen, device=DEV) < 0.5).to(pdt)
        if wdt == "bf16_unaligned":  # a contiguous W at a 2-byte offset
            buf = (torch.randn(q * p + 1, generator=gen, device=DEV) / q**0.5).to(torch.bfloat16)
            W = buf[1:].view(q, p)
        else:
            W = (torch.randn(q, p, generator=gen, device=DEV) / q**0.5).to(wdt)
        scales = 0.5 ** np.arange(n)
        scales[-1] = -scales[-1]
        b = torch.randn(p, generator=gen, device=DEV) if bias else None
        err, tol = check_bmm(planes, W, scales, b)
        emit({"phase": "bmm_kernel", "kernel": "binary_matmul", "grid": True,
              "lead": list(lead), "n": n, "q": q, "p": p,
              "w": str(W.dtype).replace("torch.", ""), "planes": str(pdt).replace("torch.", ""),
              "w_aligned_16": W.data_ptr() % 16 == 0,
              "bias": bias, "max_abs_err": err, "tol": tol})
    # bitplane_pack: fixed bits 2..8, frac 0..4, both signs, m 1..4; fp16
    # with m 1..4, zeros, subnormals, negatives and overflow
    cases = [dict(kind="fixed", bits=b, frac=f, signed=sg, m=m)
             for b, f, sg, m in [(2, 0, False, 1), (3, 1, True, 2), (4, 2, False, 3),
                                 (5, 3, True, 4), (6, 4, False, 1), (7, 0, True, 3),
                                 (8, 4, False, 4), (8, 6, True, 1)]]
    cases += [dict(kind="float16", m=m) for m in (1, 2, 3, 4)]
    for kw in cases:
        x = torch.rand(2, 3, 70, generator=gen, device=DEV) * 8 - 4
        if kw["kind"] == "float16":
            x = x.abs() * 25
            x[0, 0, :6] = torch.tensor([0.0, 5.96e-8, 1.2e-7, 6.0e-5, -3.0, 1e6], device=DEV)
            x[1, 2] = 0.0
        out = pack_ops.bitplane_pack(x, **kw)
        torch.cuda.synchronize()
        if not torch.equal(out, pack_ops.bitplane_pack(x, use_kernels=False, **kw)):
            raise AssertionError(f"bitplane_pack {kw}: codes differ")
        emit({"phase": "bmm_kernel", "kernel": "bitplane_pack", "grid": True,
              "x": list(x.shape), **kw, "codes": list(out.shape), "max_abs_err": 0})
    return {"worst": worst, "main": main}


# ---------------------------------------------------------------------------
# packing kernel phase
# ---------------------------------------------------------------------------


def pack_kernel_phase(iters: int) -> dict:
    import torch

    from repro_torch.kernels.bitplane_pack import ops

    gen = torch.Generator(device=DEV).manual_seed(5)
    floor = {}
    for _, kw, _ in PACK_SERVED.values():
        x = torch.randn(1, 4, generator=gen, device=DEV)
        floor[kw["kind"]] = device_ms([functools.partial(ops.bitplane_pack, x, **kw)],
                                      10 * iters)
    emit({"phase": "pack_kernel", "step": "launch_floor", "ms": floor,
          "how": "a one-row, 4-element fp32 pack of each kind (one thread of the "
                 "4-element path) back to back under device_ms"})
    layers = {}
    for cell, (model, kw, inputs) in PACK_SERVED.items():
        kind = kw["kind"]
        layer = {**dict.fromkeys(("kernel_ms", "plain_ms", "bound_ms", "prefill_ms",
                                  "prefill_bound_ms"), 0.0), "bound_by": set()}
        ratios = []
        for name, q, decode_rows, prefill_rows, calls in inputs:
            for regime, rows in (("decode", decode_rows), ("prefill", prefill_rows)):
                for dtype in (torch.float32, torch.bfloat16):
                    # a normed activation's scale
                    x = torch.randn(rows, q, generator=gen, device=DEV).to(dtype)
                    r, _ = run_pack_case(x, iters, 10 if regime == "decode" else 5, **kw)
                    ratio = r["kernel_ms"] / floor[kind]
                    emit({"phase": "pack_kernel", "kernel": "bitplane_pack", "cell": cell,
                          "model": model, "input": name, "regime": regime, "rows": rows,
                          "q": q, **kw, "dtype": str(dtype).replace("torch.", ""),
                          "packs_per_layer": calls,
                          "vectorized": ops.vectorized(q, kw["m"], x.data_ptr(),
                                                       x.element_size()),
                          **r, "launch_floor_ms": floor[kind], "over_launch_floor": ratio})
                    if dtype != torch.float32:  # the served paths hand in fp32
                        continue
                    if regime == "decode":
                        for key in ("kernel_ms", "plain_ms", "bound_ms"):
                            layer[key] += calls * r[key]
                        layer["bound_by"].add(r["bound_by"])
                        ratios.append(ratio)
                    else:
                        layer["prefill_ms"] += calls * r["kernel_ms"]
                        layer["prefill_bound_ms"] += calls * r["bound_ms"]
        layers[cell] = layer
        emit({"phase": "pack_kernel", "step": "layer", "cell": cell, "model": model,
              **kw, "served": cell != "float16", "calls": sum(c for *_, c in inputs),
              **{k: v for k, v in layer.items() if k != "bound_by"},
              "max_decode_over_launch_floor": max(ratios)})

    # grid: every kind and radix, both dtypes; the launch floor's shape,
    # q % 4 != 0, a base one element off, leading dims, rows past the
    # grid's y limit; values over fp16's range, its edges first
    kinds = [dict(kind="fixed", m=1, bits=8, frac=6, signed=True),
             dict(kind="fixed", m=2, bits=12, frac=3, signed=True),
             dict(kind="fixed", m=4, bits=3, frac=0, signed=False),
             dict(kind="float16", m=1), dict(kind="float16", m=3)]
    kinds += [dict(kind="shift", m=1, signed=sg, radix=r)
              for r in (1, 2, 3, 4, 5, 11) for sg in (False, True)]
    shapes = [((1,), 4, 0), ((3,), 37, 0), ((2,), 4096, 1), ((2, 3), 1408, 0),
              ((1,), 4098, 0), ((70000,), 8, 0)]
    edges = torch.tensor(PACK_EDGES, device=DEV)
    for kw in kinds:
        for dtype in (torch.float32, torch.bfloat16):
            for lead, q, off in shapes:
                n = math.prod(lead) * q
                flat = torch.randn(n + off, generator=gen, device=DEV) * torch.exp2(
                    torch.randint(-26, 18, (n + off,), generator=gen, device=DEV).float())
                flat[off: off + len(PACK_EDGES)] = edges[: n]
                x = flat.to(dtype)[off:].view(*lead, q)
                got = ops.bitplane_pack(x, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, ops.bitplane_pack(x, use_kernels=False, **kw)):
                    raise AssertionError(f"bitplane_pack {kw} {dtype} x{[*lead, q]}+{off}: "
                                         "codes differ")
            emit({"phase": "pack_kernel", "kernel": "bitplane_pack", "grid": True, **kw,
                  "dtype": str(dtype).replace("torch.", ""),
                  "shapes": [[*lead, q, off] for lead, q, off in shapes], "max_abs_err": 0})
    return {"worst": {"bitplane_pack": 0}, "layers": layers}


# ---------------------------------------------------------------------------
# binary-matmul serve phase
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_bmm_split(parts: int):
    """Run the plain binary matmul with q cut into ``parts`` slices whose
    products are summed in order (another fp32 order of the same function)
    inside a ``with`` block."""
    from repro_torch.kernels.binary_matmul import ops

    saved = ops.binary_matmul_ref

    def split(planes, W, scales):
        cuts = [W.shape[0] * i // parts for i in range(parts + 1)]
        out = None
        for a, b in zip(cuts[:-1], cuts[1:]):
            y = saved(planes[..., a:b], W[a:b], scales)
            out = y if out is None else out + y
        return out

    ops.binary_matmul_ref = split
    try:
        yield
    finally:
        ops.binary_matmul_ref = saved


def bmm_serve_phase(layers: int, requests: int, max_new: int) -> dict:
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.models.model import model_forward, model_specs
    from repro_torch.models.params import bf16_projections, init_params
    from repro_torch.serve import make_cache

    full = get_config("granite_8b")
    cfg = dataclasses.replace(full, num_layers=layers)
    bits, frac = BMM_FIXED
    mode = dict(linear_mode="binary_matmul", fixed_bits=bits, fixed_frac=frac)
    prompts = serve_requests(cfg, requests)
    inputs = prefill_inputs(prompts)

    def prefill_logits(tree, depth: int, use_kernels: bool):
        dcfg = dataclasses.replace(cfg, num_layers=depth)
        dparams = dict(tree, blocks=first_layers(tree["blocks"], depth))
        ctx = Ctx(dcfg, ex=ExecCfg(lut_grouped=True, use_kernels=use_kernels, **mode))
        cache = make_cache(dcfg, SLOTS, MAX_LEN, ctx, device=DEV)
        with torch.no_grad():
            logits, _, _ = model_forward(dparams, inputs, ctx, cache=cache)
        return logits[inputs["token_mask"]]

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(0)
    t0 = time.perf_counter()
    params32 = init_params(model_specs(cfg), gen, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the fp32 tree's prefill logits on both paths, before its projections
    # are rounded once to bf16 (both paths round W to bf16 before the
    # product, so the bf16 tree must give them bit for bit)
    depth = BMM_DEPTHS[1]
    ref32 = {uk: prefill_logits(params32, depth, uk) for uk in (True, False)}
    t0 = time.perf_counter()
    params = bf16_projections(params32)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    del params32
    torch.cuda.empty_cache()
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    proj_bytes = sum(t.numel() * t.element_size() for t in _leaves(params["blocks"])
                     if t.ndim == 3)
    emit({"phase": "bmm_serve", "step": "init", "seconds": init_s, "round_seconds": round_s,
          "weight_gib": weight_bytes / 2**30, "projection_gib": proj_bytes / 2**30,
          "projection_dtype": "bfloat16",
          "depth": {"layers": layers, "published": full.num_layers}, "fixed": [bits, frac],
          "memory_allocated_gib": torch.cuda.memory_allocated() / 2**30,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
    same = {("kernels" if uk else "plain"): torch.equal(prefill_logits(params, depth, uk), ref)
            for uk, ref in ref32.items()}
    emit({"phase": "bmm_serve", "step": "bf16_tree", "layers": depth,
          "logits_identical_to_fp32_tree": same})
    if not all(same.values()):
        raise AssertionError(f"the bf16-projection tree changed the prefill logits: {same}")
    del ref32

    torch.cuda.reset_peak_memory_stats()
    per_forward = {"bitplane_pack": 7 * layers, "binary_matmul": 7 * layers}
    reqs, eng, wall, decode_ms, launches, _ = serve_paths(
        "bmm_serve", params, cfg, prompts, max_new, per_forward, **mode)
    forwards = eng.readbacks
    expect = {**no_launches(), **{k: v * forwards for k, v in per_forward.items()}}
    tokens = sum(len(r.generated) for r in reqs)
    emit({"phase": "bmm_serve", "step": "kernels", "requests": len(reqs), "tokens": tokens,
          "tok_per_s": tokens / wall, "wall_s": wall,
          "median_decode_step_ms": statistics.median(decode_ms),
          "forwards": forwards, "launches": launches, "expected_launches": expect,
          "per_forward": per_forward,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
    if launches != expect or forwards <= 0:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    if not all(len(r.generated) == max_new for r in reqs):
        raise AssertionError("a request stopped short of max_new")

    plain_reqs, _, plain_wall, plain_decode = run_engine(params, cfg, prompts, max_new, False,
                                                         cuda_graph=False, **mode)
    plain_graph_gate("bmm_serve", params, cfg, prompts, max_new, plain_reqs, plain_decode,
                     **mode)
    first_ok = all(a.generated[0] == b.generated[0] for a, b in zip(reqs, plain_reqs))
    same = sum(
        x == y for a, b in zip(reqs, plain_reqs) for x, y in zip(a.generated, b.generated)
    )
    emit({"phase": "bmm_serve", "step": "plain", "tok_per_s": tokens / plain_wall,
          "wall_s": plain_wall, "median_decode_step_ms": statistics.median(plain_decode),
          "first_tokens_identical": first_ok, "identical_token_share": same / tokens,
          "streams_identical": all(a.generated == b.generated
                                   for a, b in zip(reqs, plain_reqs))})
    if not first_ok:
        raise AssertionError("kernel and plain paths disagree on a first token")

    for depth in BMM_DEPTHS:
        if depth < layers:
            emit({"phase": "bmm_serve", "step": "prefill_logits_by_depth", "layers": depth,
                  **compare_logits(prefill_logits(params, depth, True),
                                   prefill_logits(params, depth, False))})
    got, ref = prefill_logits(params, layers, True), prefill_logits(params, layers, False)
    # noise floor: the plain path against itself with q cut in two (the
    # same function, another fp32 order)
    with plain_bmm_split(2):
        floor = compare_logits(prefill_logits(params, layers, False), ref)
    res = compare_logits(got, ref)
    finite = bool(torch.isfinite(got).all().item())
    tol = BMM_LOGITS_TOL * res["max_abs_ref"]
    emit({"phase": "bmm_serve", "step": "prefill_logits", "layers": layers,
          "shape": list(got.shape), **res, "tol": tol, "rel_fro_tol": BMM_LOGITS_FRO_TOL,
          "finite": finite, "plain_vs_plain": floor,
          "tol_reason": "the paths sum each projection's products in other fp32 orders "
                        "(~1e-7 relative); each projection re-quantizes its input to 8/6 "
                        "fixed point (a step of 1/64), so an activation that close to a "
                        "rounding boundary takes the neighbouring code, and 36 random-init "
                        "layers carry these steps to the logits: measured on an H100, the "
                        "norm error grows 0.07 / 2.1 / 3.3 / 4.4 % at 1 / 4 / 12 / 36 "
                        "layers, and the plain version against itself in another order "
                        "(plain_vs_plain) differs by as much; the tolerance is about twice "
                        "that (a wrong plane, row or sign shows in the bmm_kernel lines, "
                        "each call held to 1e-5 x max|plain|)"})
    if not (finite and res["max_abs_err"] <= tol and res["rel_fro_err"] <= BMM_LOGITS_FRO_TOL):
        raise AssertionError(f"prefill logits differ: {res} (tol {tol}, {BMM_LOGITS_FRO_TOL})")
    del params
    torch.cuda.empty_cache()
    return {"launches": launches}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def compare_logits(a, b) -> dict:
    d = a - b
    return {"max_abs_err": d.abs().max().item(), "max_abs_ref": b.abs().max().item(),
            "rel_fro_err": (d.norm() / b.norm()).item(),
            "argmax_agree": (a.argmax(-1) == b.argmax(-1)).float().mean().item()}


def graph_nodes(graph) -> dict:
    """The nodes of a captured ``torch.cuda.CUDAGraph`` (made with
    ``keep_graph=True``) by type, from CUDA's runtime (``cudaGraphGetNodes``
    and ``cudaGraphNodeGetType``, through the runtime torch loaded)."""
    import ctypes

    import torch

    rt = ctypes.CDLL(f"libcudart.so.{torch.version.cuda.split('.')[0]}")
    rt.cudaGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]
    rt.cudaGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    g, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if rt.cudaGraphGetNodes(g, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cudaGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if rt.cudaGraphGetNodes(g, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cudaGraphGetNodes failed")
    # cudaGraphNodeType: kernel 0, memcpy 1, memset 2, the rest other
    names = {0: "kernel", 1: "memcpy", 2: "memset"}
    kinds: dict = {}
    for node in nodes:
        t = ctypes.c_int(-1)
        if rt.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) != 0:
            raise RuntimeError("cudaGraphNodeGetType failed")
        kind = names.get(t.value, f"type_{t.value}")
        kinds[kind] = kinds.get(kind, 0) + 1
    return kinds


def profile_decode(lut, cfg, prompts, max_new, steps=4, cuda_graph=True, engine=None, **ex):
    """Where a steady decode step's time goes: ``torch.profiler`` over
    ``steps`` engine steps after admission and two decode steps (with the
    graph: the eager warm-up and the capture, whose graph is kept so that
    its nodes can be counted beside the profiler's records).  ``busy_ms``
    sums the device time of every kernel; the idle share is the rest of the
    host-clock wall time; ``kernels_by_name`` each kernel's launches per
    step.  ``engine``: further engine arguments.  (Its launches are not the
    main-path run's: the counts were read before.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.serve import BatchingEngine, Request

    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True, **ex))
    eng = BatchingEngine(lut, ctx, SLOTS, MAX_LEN, prefill_bucket=BUCKET, device=DEV,
                         cuda_graph=cuda_graph, **(engine or {}))
    for i, pr in enumerate(prompts):
        eng.submit(Request(i, pr, max_new))
    made = torch.cuda.CUDAGraph
    torch.cuda.CUDAGraph = functools.partial(made, keep_graph=True)
    try:
        eng.step()  # admission prefill + first decode (the graph's warm-up)
        eng.step()  # with the graph: its capture and first replay
    finally:
        torch.cuda.CUDAGraph = made
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            eng.step()
        wall_ms = (time.perf_counter() - start) * 1e3
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    packs = [e for e in kernels if "pack_kernel" in e.key]
    profiled = sum(e.count for e in kernels) / steps
    # the profiler records each kernel of a replay; the captured graph's
    # nodes (kernels and copies; the step's readback is outside) beside them
    nodes = graph_nodes(eng._graph[0]) if cuda_graph else None
    if not profiled:
        raise AssertionError(f"the profiler recorded no kernel (cuda_graph {cuda_graph})")
    by_name: dict = {}
    for e in kernels:
        by_name[e.key[:80]] = by_name.get(e.key[:80], 0) + e.count / steps
    return {
        "cuda_graph": cuda_graph, "steps": steps, "wall_ms_per_step": wall_ms / steps,
        "busy_ms_per_step": busy / steps,
        "idle_share": 1.0 - busy / wall_ms,
        "device_kernels_per_step": profiled, "graph_nodes": nodes,
        "pack_kernels_per_step": sum(e.count for e in packs) / steps,
        "pack_ms_per_step": sum(e.self_device_time_total for e in packs) / 1e3 / steps,
        "top_kernels_ms_per_step": {
            e.key[:60]: e.self_device_time_total / 1e3 / steps for e in top
        },
        "kernels_by_name": by_name,
    }


def first_layers(tree, depth: int):
    """Views of the first ``depth`` layers of a stacked block tree."""
    from repro_torch.core.convert import LUTGroup, LUTLinear

    if isinstance(tree, dict):
        return {k: first_layers(v, depth) for k, v in tree.items()}
    if isinstance(tree, (LUTLinear, LUTGroup)):
        return dataclasses.replace(
            tree, tables=tree.tables[:depth],
            b=None if tree.b is None else tree.b[:depth],
            scale=None if tree.scale is None else tree.scale[:depth],
        )
    return tree[:depth]


@contextlib.contextmanager
def plain_gather_bytes(nbytes: int):
    """Run the plain versions with another chunk-slice size (so another
    fp32 summation order) inside a ``with`` block."""
    from repro_torch.kernels.lut_affine import ops

    names = ("lut_affine_ref", "lut_affine_grouped_ref", "lut_affine_experts_ref")
    saved = {name: getattr(ops, name) for name in names}
    for name, fn in saved.items():
        setattr(ops, name, functools.partial(fn, max_gather_bytes=nbytes))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


# ---------------------------------------------------------------------------
# paper phase: the paper's own networks, trained, converted and evaluated
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def paper_layer_spy(fn):
    """Inside a ``with`` block, every ``linear`` call of the paper models
    (``models/paper_models.py`` imports it by name) also calls ``fn(p, x,
    y)`` with its parameters, input and output."""
    from repro_torch.models import paper_models

    saved = paper_models.linear

    def spy(p, x, ctx):
        y = saved(p, x, ctx)
        fn(p, x, y)
        return y

    paper_models.linear = spy
    try:
        yield
    finally:
        paper_models.linear = saved


def head_copy_ms(node, x, iters: int) -> dict:
    """One converted head's ``lut_affine`` call on its B = 500 input, as
    served (10 fp32 columns, 40-byte rows: ``table_operand`` copies the
    tables into 48-byte rows first) and on tables padded once to 12
    columns (no copy); with the served call's bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.bitplane_pack.ops import pack
    from repro_torch.kernels.lut_affine import ops
    from repro_torch.models.layers import _host_scales

    codes = pack(x, node.plan)
    scales = _host_scales(node.plan, node.scale)
    p = node.tables.shape[-1]
    served = copies_of(node.tables)
    padded = [F.pad(t, (0, -p % (ops.ROW_ALIGN // t.element_size()))) for t in served]
    before = ops.TABLE_COPIES["table_operand"]
    got = ops.lut_affine(codes, padded[0], scales)[:, :p]
    if ops.TABLE_COPIES["table_operand"] != before:
        raise AssertionError("a pre-padded table was copied")
    ops.lut_affine(codes, served[0], scales)
    copies = ops.TABLE_COPIES["table_operand"] - before
    want = ops.lut_affine(codes, node.tables, scales, use_kernels=False)
    err = (got - want).abs().max().item()
    if err > KERNEL_TOL * want.abs().max().item():
        raise AssertionError(f"the pre-padded head is {err} off its plain version")
    with_copy = device_ms([functools.partial(ops.lut_affine, codes, t, scales)
                           for t in served], iters)
    pre_padded = device_ms([functools.partial(ops.lut_affine, codes, t, scales)
                            for t in padded], iters)
    b_ms, b_by = bound(codes, 1, node.tables.shape[-2], p, node.tables.element_size(), 0)
    return {"copies_per_call": copies, "ms_with_copy": with_copy,
            "ms_pre_padded": pre_padded, "copy_ms": with_copy - pre_padded,
            "table_bytes": node.tables.numel() * node.tables.element_size(),
            "bound_ms": b_ms, "bound_by": b_by, "codes_shape": list(codes.shape),
            "max_abs_err_pre_padded": err}


def paper_layer_ms(node, x, ctx, iters: int) -> dict:
    """Where a converted forward's time goes: one layer's ``linear`` call
    (its pack, any table copy and its ``lut_affine``) and its pack alone,
    on the layer's own input in the forward, with the regime the wrapper
    picks and the bound of the ``lut_affine`` call (its tables are read in
    place, so a small layer's may sit in L2 between calls)."""
    from repro_torch.kernels.bitplane_pack.ops import pack
    from repro_torch.models.layers import linear

    codes = pack(x, node.plan)
    t = node.tables
    b_ms, b_by = bound(codes, 1, t.shape[-2], t.shape[-1], t.element_size(), 0)
    return {"rows": x.shape[0], "q": x.shape[1], "p": t.shape[-1],
            "n": node.plan.num_planes, "k": node.plan.num_chunks, "E": t.shape[-2],
            "regime": lut_tiling("lut_affine", codes, t[None]).regime,
            "ms": device_ms([functools.partial(linear, node, x, ctx)], iters),
            "pack_ms": device_ms([functools.partial(pack, x, node.plan)], iters),
            "lut_affine_bound_ms": b_ms, "bound_by": b_by}


def onehot_bound(codes, tables, scales):
    """The most ``linear_mode="onehot_mxu"``'s bf16 rounding of ``tables``
    can move each output: ``sum_j |s_j| sum_c |T - bf16(T)|[c, idx]``, the
    plain gather over the rounding errors (0 for entries bf16 holds, such
    as i8's)."""
    import torch

    from repro_torch.kernels.lut_affine import ops

    err = (tables.float() - tables.to(torch.bfloat16).float()).abs()
    return ops.lut_affine(codes, err, [abs(float(v)) for v in ops.host_scales(scales)],
                          use_kernels=False)


def onehot_compare(kern, onehot, bound) -> dict:
    """The one-hot mode's output against the kernel's on the same input:
    the largest difference against max|kernel|, and whether every element
    lies within ``bound`` (the tables' bf16 rounding) plus KERNEL_TOL x
    max|kernel| (fp32 sums in another order)."""
    import torch

    d = (onehot.float() - kern.float()).abs()
    top = kern.abs().max().item()
    ok = bool((d <= bound * (1 + 1e-6) + KERNEL_TOL * top).all())
    return {"max_abs_err": d.max().item(), "max_abs_kernel": top,
            "rel_err": d.max().item() / top, "max_bound": bound.max().item(),
            "within_bound": ok and bool(torch.isfinite(onehot).all())}


def paper_batches(bits=None):
    """The held-out images of ``examples/tablenet_mnist.py::accuracy`` (3
    batches of 500 from step 50,000) on the card, on the ``bits`` grid
    when given."""
    from repro_torch.data.synthetic import image_batch
    from repro_torch.models.paper_models import quantize_inputs

    out = []
    for s in range(PAPER_BATCHES):
        x, y = image_batch(PAPER_ROWS, 50_000 + s, device=DEV)
        out.append((quantize_inputs(x, bits), y))
    return out


def run_converted(tag: dict, lut, report, params, forward, batches, iters: int,
                  dense_inputs, onehot: bool = False) -> dict:
    """A converted paper network over ``batches``: one counted pass on the
    kernels (per forward one ``bitplane_pack`` and one ``lut_affine`` launch
    per converted layer, no pack off the kernel), the plain versions on the
    same images, every converted layer against its plain version on the
    same input, device times of the kernel path, the plain path and the
    dense forward at B = 500, and the 10-column head's table copy.
    ``dense_inputs`` maps an image batch to the dense model's input for the
    accuracy beside the LUT path's.  With ``onehot``, also the
    ``linear_mode="onehot_mxu"`` plain path over the same images (its own
    line): its accuracy within ONEHOT_ACC_POINTS of the kernel path's and
    every converted layer within :func:`onehot_bound` of the kernel on the
    same input."""
    import torch

    from repro_torch.core.convert import LUTLinear
    from repro_torch.kernels.bitplane_pack.ops import pack
    from repro_torch.kernels.lut_affine import ops as lut_ops
    from repro_torch.models.layers import _host_scales, linear
    from repro_torch.models.paper_models import paper_ctx

    kctx, pctx = paper_ctx(), paper_ctx(use_kernels=False)
    octx = paper_ctx(use_kernels=False, linear_mode="onehot_mxu")
    names = [k for k, v in lut.items() if isinstance(v, LUTLinear)]
    by_node = {id(lut[k]): k for k in names}
    reset_launches()
    with torch.no_grad():
        kern = [forward(lut, x, kctx) for x, _ in batches]
    torch.cuda.synchronize()
    launches, uncovered = read_launches(), plain_pack_codes_calls()
    copies = lut_ops.TABLE_COPIES["table_operand"]
    peak = torch.cuda.max_memory_allocated()
    n = len(batches)
    expect = {**no_launches(), "lut_affine": len(names) * n, "bitplane_pack": len(names) * n}
    if launches != expect or uncovered:
        raise AssertionError(f"{tag}: launches {launches} != {expect}, or {uncovered} "
                             "packs off the kernel")
    with torch.no_grad():
        plain = [forward(lut, x, pctx) for x, _ in batches]
        dense = [forward(params, dense_inputs(x), kctx) for x, _ in batches]
    labels = [y for _, y in batches]
    agree = [int((a.argmax(-1) == b.argmax(-1)).sum()) for a, b in zip(kern, plain)]
    cat_k, cat_p = torch.cat(kern), torch.cat(plain)
    finite = bool(torch.isfinite(cat_k).all())

    def correct(logits):
        return sum(int((lg.argmax(-1) == y).sum()) for lg, y in zip(logits, labels))

    # every converted layer against its plain version on the same input
    # (and against the one-hot mode's)
    layer_err, layer_in, onehot_err = {}, {}, {}

    def check(p, x, y):
        if not isinstance(p, LUTLinear):
            return
        name = by_node[id(p)]
        want = linear(p, x, pctx)
        err, ref = (y - want).abs().max().item(), want.abs().max().item()
        layer_err[name] = {"rows": x.numel() // x.shape[-1], "max_abs_err": err,
                           "max_abs_ref": ref, "ok": err <= KERNEL_TOL * ref}
        layer_in[name] = x.reshape(-1, x.shape[-1])
        if onehot:
            bound = onehot_bound(pack(x, p.plan), p.tables, _host_scales(p.plan, p.scale))
            onehot_err[name] = onehot_compare(y, linear(p, x, octx), bound)
            del bound

    with torch.no_grad(), paper_layer_spy(check):
        forward(lut, batches[0][0], kctx)
    x0 = batches[0][0]
    with torch.no_grad():
        kernel_ms = device_ms([functools.partial(forward, lut, x0, kctx)], iters)
        plain_ms = device_ms([functools.partial(forward, lut, x0, pctx)], max(1, iters // 4),
                             warmup=1, hold=False)
        dense_x = dense_inputs(x0)
        dense_ms = device_ms([functools.partial(forward, params, dense_x, kctx)], iters)
        per_layer = {k: paper_layer_ms(lut[k], x, kctx, iters) for k, x in layer_in.items()}
        heads = {k: head_copy_ms(lut[k], x, iters) for k, x in layer_in.items()
                 if lut[k].tables.shape[-1] * lut[k].tables.element_size()
                 % lut_ops.ROW_ALIGN}
    del layer_in
    res = {
        **tag, "converted_layers": names, "table_bytes": report.table_bytes,
        "weight_bytes": report.weight_bytes, "peak_bytes": peak,
        "launches": launches, "per_forward": {k: v // n for k, v in launches.items() if v},
        "plain_pack_codes_calls": uncovered, "table_copies_per_forward": copies / n,
        "layers": layer_err, "argmax_agree_per_batch": agree, "argmax_agree_min": PAPER_AGREE,
        "finite": finite, **compare_logits(cat_k, cat_p),
        "lut_correct": correct(kern), "plain_correct": correct(plain),
        "dense_correct": correct(dense), "images": n * PAPER_ROWS,
        "device_ms": {"kernel": kernel_ms, "plain": plain_ms, "dense_fp32": dense_ms},
        "images_per_s": {"kernel": PAPER_ROWS / kernel_ms * 1e3,
                         "plain": PAPER_ROWS / plain_ms * 1e3,
                         "dense_fp32": PAPER_ROWS / dense_ms * 1e3},
        "per_layer": per_layer, "heads": heads,
    }
    res["lut_accuracy"] = res["lut_correct"] / res["images"]
    res["dense_accuracy"] = res["dense_correct"] / res["images"]
    emit({"phase": "paper", **res})
    bad = [k for k, v in layer_err.items() if not v["ok"]]
    if bad or set(layer_err) != set(names):
        raise AssertionError(f"{tag}: layers {bad} off their plain version (or unchecked)")
    if min(agree) < PAPER_AGREE or not finite:
        raise AssertionError(f"{tag}: argmax agreement {agree} below {PAPER_AGREE} a batch")
    if onehot:
        onehot_line(tag, lut, forward, batches, octx, onehot_err, names, res, iters)
    return res


def onehot_line(tag, lut, forward, batches, octx, layer_err, names, res, iters) -> None:
    """A converted paper network under ``linear_mode="onehot_mxu"`` (the
    plain path: no LUT kernel launches) over ``batches``: its held-out
    accuracy beside the kernel path's and the plain gather's (gated within
    ONEHOT_ACC_POINTS of the kernel path's), its device ms at B = 500, and
    each converted layer against the kernel on the same input
    (``layer_err``, gated within :func:`onehot_bound`)."""
    import torch

    reset_launches()
    with torch.no_grad():
        logits = [forward(lut, x, octx) for x, _ in batches]
    torch.cuda.synchronize()
    launches = read_launches()
    correct = sum(int((lg.argmax(-1) == y).sum()) for lg, (_, y) in zip(logits, batches))
    finite = all(bool(torch.isfinite(lg).all()) for lg in logits)
    del logits
    with torch.no_grad():
        onehot_ms = device_ms([functools.partial(forward, lut, batches[0][0], octx)],
                              min(2, iters), warmup=1, hold=False)
    points = 100.0 * (correct - res["lut_correct"]) / res["images"]
    line = {"phase": "paper", **tag, "step": "onehot", "linear_mode": "onehot_mxu",
            "images": res["images"], "onehot_correct": correct,
            "onehot_accuracy": correct / res["images"], "lut_accuracy": res["lut_accuracy"],
            "plain_accuracy": res["plain_correct"] / res["images"],
            "accuracy_points_from_kernel": points, "accuracy_points_tol": ONEHOT_ACC_POINTS,
            "layers": layer_err, "finite": finite,
            "device_ms": {"onehot": onehot_ms, **res["device_ms"]},
            "lut_launches": {k: v for k, v in launches.items() if v},
            "nvidia_smi": smi_line()}
    emit(line)
    bad = [k for k, v in layer_err.items() if not v["within_bound"]]
    if bad or set(layer_err) != set(names) or not finite:
        raise AssertionError(f"{tag}: one-hot layers {bad} off the kernel beyond the bf16 "
                             "rounding (or unchecked, or not finite)")
    if abs(points) > ONEHOT_ACC_POINTS:
        raise AssertionError(f"{tag}: one-hot accuracy {points} points from the kernel path's")
    if launches["lut_affine"] or launches["lut_affine_grouped"]:
        raise AssertionError(f"{tag}: the one-hot path launched LUT kernels: {launches}")


def paper_phase(iters: int) -> dict:
    """The paper's three networks at their published widths, each trained on
    the card with the reference's recipe (``examples/tablenet_mnist.py``;
    LeNet also at a stable learning rate, :data:`PAPER_LR`), its dense
    accuracy over 1500 held-out images and at input bits 1..8,
    converted to unsigned fp16 bitplane tables (chunk 1 for all three,
    chunk 2 for the classifier and the MLP) and run on the kernels and on
    the plain versions; then the classifier at the Fig. 5 fixed 3/3 plan,
    chunks 1 / 2 / 7 / 14, against the dense model on the same 3-bit
    inputs; then the TL1 rows of ``benchmarks/accuracy_vs_bits.py`` on
    ``lut_tl1``, the head's output held against its plain version on every
    batch (the accuracies beside the plain version's are a report)."""
    import torch

    from repro_torch.benchmarks import accuracy_vs_bits as avb
    from repro_torch.core.convert import conversion_summary, convert_params
    from repro_torch.core.lut import LUTPlan
    from repro_torch.core.lut_tl1 import TL1Plan
    from repro_torch.core.planner import ModelPlan
    from repro_torch.core.quantize import FixedPointFormat
    from repro_torch.examples import tablenet_mnist as tm
    from repro_torch.models.layers import linear
    from repro_torch.models.paper_models import paper_ctx

    total = no_launches()

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    for name, chunks in PAPER_CHUNKS.items():
        for lr in PAPER_LR[name]:
            t0 = time.perf_counter()
            params, forward, ctx = tm.train(name, lr=lr, device=DEV)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            emit({"phase": "paper", "net": name, "step": "train", "steps": 300,
                  "batch": 128, "lr": lr, "recipe": lr == 0.3, "train_s": train_s,
                  "converted": lr == PAPER_LR[name][-1],
                  "accuracy_fp32": tm.accuracy(forward, params, ctx, device=DEV),
                  "accuracy_by_input_bits": {str(b): tm.accuracy(forward, params, ctx, b,
                                                                 device=DEV)
                                             for b in range(1, 9)}})
        batches = paper_batches()
        for chunk in chunks:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            lut, report = convert_params(params, chunk_size=chunk, signed=False)
            torch.cuda.synchronize()
            tag = {"net": name, "step": "lut", "plan": f"fp16-unsigned-bitplane-c{chunk}",
                   "convert_s": time.perf_counter() - t0,
                   "summary": conversion_summary(report)}
            res = run_converted(tag, lut, report, params, forward, batches, iters,
                                lambda x: x.half().float(), onehot=True)
            add(res["launches"])
            del lut
            torch.cuda.empty_cache()
        if name == "linear":  # the Fig. 5 point: 3-bit inputs, fixed-point tables
            fig5 = paper_batches(FIG5_BITS)
            fmt = FixedPointFormat(FIG5_BITS, FIG5_BITS)
            for m in FIG5_CHUNKS:
                torch.cuda.reset_peak_memory_stats()
                plan = LUTPlan(784, 10, m, fmt)
                lut, report = convert_params(params, plan=ModelPlan({"fc": plan}))
                tag = {"net": name, "step": "fig5",
                       "plan": f"fixed{FIG5_BITS}/{FIG5_BITS}-unsigned-bitplane-c{m}",
                       "entries": plan.num_entries, "tables": plan.num_chunks}
                res = run_converted(tag, lut, report, params, forward, fig5, iters,
                                    lambda x: x)
                if abs(res["lut_correct"] - res["dense_correct"]) > 1:
                    raise AssertionError(f"fig5 c{m}: {res['lut_correct']} LUT against "
                                         f"{res['dense_correct']} dense correct images")
                add(res["launches"])
                del lut
        del params
        torch.cuda.empty_cache()

    # the TL1 rows of accuracy_vs_bits: its recipe, its held-out images
    params, ctx = avb.train_linear(device=DEV)
    ref = avb.accuracy(params, ctx, None, device=DEV)
    emit({"phase": "paper", "net": "linear", "step": "fig4", "recipe": "accuracy_vs_bits",
          "accuracy_fp32": ref,
          "accuracy_by_input_bits": {str(b): avb.accuracy(params, ctx, b, device=DEV)
                                     for b in range(1, 9)}})
    pctx = paper_ctx(use_kernels=False)
    for act_bits in TL1_ACT_BITS:
        # the TL1 node's kernel output against its plain version on the same
        # input, every batch: the int path bit for bit (integer accumulate),
        # the fp32 path within TL1_TOL x max|plain| (sums in another order)
        batch_err = []

        def check(p, x, y):
            want = linear(p, x, pctx)
            err, top = (y - want).abs().max().item(), want.abs().max().item()
            tol = 0.0 if act_bits is not None else TL1_TOL * top
            batch_err.append({"max_abs_err": err, "max_abs_ref": top, "tol": tol,
                              "ok": err <= tol and bool(torch.isfinite(y).all())})

        reset_launches()
        with paper_layer_spy(check):
            acc = avb.tl1_accuracy(params, ctx, act_bits, device=DEV)
        torch.cuda.synchronize()
        launches = read_launches()
        plain = avb.tl1_accuracy(params, pctx, act_bits, device=DEV)
        expect = {**no_launches(), "lut_tl1": TL1_BATCHES}
        plan = TL1Plan(784, 10, act_bits=act_bits)
        err = max(b["max_abs_err"] for b in batch_err)
        emit({"phase": "paper", "net": "linear", "step": "tl1", "act_bits": act_bits,
              "accuracy": acc, "plain_accuracy": plain, "accuracy_fp32": ref,
              "table_bytes": plan.total_lut_bytes, "launches": launches,
              "expected_launches": expect, "max_abs_err": err, "batches": batch_err})
        if launches != expect:
            raise AssertionError(f"tl1 a{act_bits}: launches {launches} != {expect}")
        if len(batch_err) != TL1_BATCHES or not all(b["ok"] for b in batch_err):
            raise AssertionError(f"tl1 a{act_bits}: the kernel is off its plain version "
                                 f"(or a batch went unchecked): {batch_err}")
        add(launches)
    return {"launches": total}


# ---------------------------------------------------------------------------
# onehot phase: linear_mode="onehot_mxu" on a full-width granite_8b layer
# ---------------------------------------------------------------------------


def onehot_phase(iters: int) -> dict:
    """``linear_mode="onehot_mxu"`` (the plain path, asked for: a one-hot
    of each code against the tables rounded to bf16, summed in fp32)
    against the ``lut_affine`` and ``lut_affine_grouped`` kernels on the
    same codes, on one granite_8b decoder layer at full width (d_model
    4,096, d_ff 14,336) with seeded weights, converted under fixed-point
    8/6 ``bitplane`` plans at chunk 2 (not shift plans: their codes cannot
    feed a one-hot), with fp32 tables (2,048 x 4 x 4,096 entries for
    ``wq``; bf16 rounds them) and with i8 tables (exact in bf16), ``wk+wv``
    and ``w_gate+w_up`` G = 2 groups.  At ONEHOT_ROWS rows each call: the
    kernel path (grouped launch for a group) and the one-hot path (no
    fusion: each member alone, as in the reference) on inputs of std
    ONEHOT_X_STD; every element within :func:`onehot_bound` plus
    KERNEL_TOL x max|kernel|; the LUT apply's device ms of each (the codes
    given), the kernel call's bound (:func:`bound`) and the one-hot path's
    LUT launches (0)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.convert import LUTGroup, convert_params
    from repro_torch.core.lut import LUTPlan
    from repro_torch.core.planner import ModelPlan
    from repro_torch.core.quantize import FixedPointFormat
    from repro_torch.kernels.bitplane_pack.ops import pack
    from repro_torch.kernels.lut_affine import ops
    from repro_torch.models import layers as L
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import block_specs, layer_params, stack_specs

    cfg = dataclasses.replace(get_config("granite_8b"), num_layers=1)
    params = init_params({"blocks": stack_specs(block_specs(cfg), 1)},
                         torch.Generator(device=DEV).manual_seed(0), device=DEV)
    fmt = FixedPointFormat(8, 6, signed=True)
    kctx = L.Ctx(cfg, ex=L.ExecCfg(remat="none", lut_grouped=True))
    octx = L.Ctx(cfg, ex=L.ExecCfg(remat="none", lut_grouped=True, linear_mode="onehot_mxu",
                                   use_kernels=False))
    calls = (("attn", ("wq",)), ("attn", ("wk", "wv")), ("attn", ("wo",)),
             ("ffn", ("w_gate", "w_up")), ("ffn", ("w_down",)))
    gen = torch.Generator(device=DEV).manual_seed(1)
    worst = 0.0
    for table_format in ONEHOT_TABLES:
        layers, groups = {}, []
        for part, names in calls:
            for name in names:
                q, p = params["blocks"][part][name]["w"].shape[-2:]
                layers[f"blocks/{part}/{name}"] = LUTPlan(q, p, 2, fmt, mode="bitplane",
                                                          table_format=table_format)
            if len(names) > 1:
                groups.append(tuple(f"blocks/{part}/{n}" for n in names))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lut, report = convert_params(params, plan=ModelPlan(layers, groups=tuple(groups)))
        torch.cuda.synchronize()
        convert_s = time.perf_counter() - t0
        layer = layer_params(lut["blocks"], 0)
        tag = f"fixed8/6-bitplane-c2-{table_format or 'f32'}"
        for rows in ONEHOT_ROWS:
            for part, names in calls:
                parent = layer[part]
                node = parent.get("+".join(names)) if len(names) > 1 else parent[names[0]]
                plan = node.plan
                x = ONEHOT_X_STD * torch.randn((rows, plan.in_features), generator=gen,
                                               device=DEV)
                reset_launches()
                kern = L.fused_linears(parent, names, x, kctx)
                torch.cuda.synchronize()
                klaunch = read_launches()
                reset_launches()
                onehot = L.fused_linears(parent, names, x, octx)
                torch.cuda.synchronize()
                olaunch = read_launches()
                codes = pack(x, plan)
                scales = L._host_scales(plan, node.scale)
                members = {}
                for g, name in enumerate(names):
                    tables = node.tables[g] if isinstance(node, LUTGroup) else node.tables
                    members[name] = onehot_compare(kern[g], onehot[g],
                                                   onehot_bound(codes, tables, scales))
                if isinstance(node, LUTGroup):
                    kernel_fn = functools.partial(ops.lut_affine_grouped, codes, node.tables,
                                                  scales)
                    onehot_fns = [functools.partial(L._onehot_apply, t, None, codes, scales)
                                  for t in node.tables]
                else:
                    kernel_fn = functools.partial(ops.lut_affine, codes, node.tables, scales)
                    onehot_fns = [functools.partial(L._onehot_apply, node.tables, None, codes,
                                                    scales)]
                kernel_ms = device_ms([kernel_fn], iters)
                b_ms, b_by = bound(codes.reshape(-1, *codes.shape[-2:]), len(names),
                                   plan.num_entries, plan.out_features,
                                   node.tables.element_size(), 0)
                # without the hold: the one-hot path copies its host scales
                # to the card (a synchronous copy), as the plain versions do
                onehot_ms = device_ms([lambda: [f() for f in onehot_fns]], max(1, iters // 4),
                                      warmup=1, hold=False)
                expect = {"lut_affine_grouped" if len(names) > 1 else "lut_affine": 1,
                          "bitplane_pack": 1}
                line = {"phase": "onehot", "plan": tag, "call": "+".join(names), "rows": rows,
                        "q": plan.in_features, "p": plan.out_features, "G": len(names),
                        "n": plan.num_planes, "k": plan.num_chunks, "E": plan.num_entries,
                        "table_dtype": str(node.tables.dtype), "members": members,
                        "kernel_ms": kernel_ms, "kernel_bound_ms": b_ms, "bound_by": b_by,
                        "onehot_ms": onehot_ms, "onehot_over_kernel": onehot_ms / kernel_ms,
                        "kernel_launches": {k: v for k, v in klaunch.items() if v},
                        "onehot_launches": {k: v for k, v in olaunch.items() if v},
                        "convert_s": convert_s, "table_bytes": report.table_bytes,
                        "nvidia_smi": smi_line()}
                emit(line)
                if not all(m["within_bound"] for m in members.values()):
                    raise AssertionError(f"onehot {tag} {names} at {rows} rows: off the kernel "
                                         f"beyond the bf16 rounding: {members}")
                if table_format == "i8" and any(m["max_abs_err"] > KERNEL_TOL
                                                * m["max_abs_kernel"] for m in members.values()):
                    raise AssertionError(f"onehot {tag} {names}: i8 tables off the kernel")
                if any(klaunch[k] != v for k, v in expect.items()) or any(
                        olaunch[k] for k in ("lut_affine", "lut_affine_grouped")):
                    raise AssertionError(f"onehot {names}: launches {klaunch} / {olaunch}")
                worst = max(worst, *(m["rel_err"] for m in members.values()))
        del lut, layer
        torch.cuda.empty_cache()
    return {"worst_rel_err": worst}


# ---------------------------------------------------------------------------
# serve_lut phase: the serving example's twin on the card
# ---------------------------------------------------------------------------


def serve_lut_phase() -> dict:
    """``repro_torch.examples.serve_lut`` at its defaults (reduced
    granite_8b, 6 requests on 2 slots, 8 new tokens each, the plan at half
    the uniform chunk-2 bytes, grouped launches) on the card, greedy and
    ``--temperature 0.8 --top-k 20``, each batched and ``--admit per-slot``:
    the streams identical across the admissions in both modes, the LUT
    kernels' launches counted (after one untimed run at the defaults).
    Reported: tok/s (the run's wall clock, its graph capture included),
    host readbacks, decode
    steps and the packs off the kernel (its signed fp16 ``bitplane`` plans
    pack through ``pack_codes``, ``PLAIN_CALLS``)."""
    import torch

    from repro_torch.examples import serve_lut

    serve_lut.main([])  # untimed: the card's first launches and allocations
    runs, total = {}, no_launches()
    for mode, flags in (("greedy", []), ("top_k", ["--temperature", "0.8", "--top-k", "20"])):
        for admit in ("batched", "per-slot"):
            reset_launches()
            out = serve_lut.main(flags + ["--admit", admit])
            torch.cuda.synchronize()
            launches, off_kernel = read_launches(), plain_pack_codes_calls()
            for k, v in launches.items():
                total[k] += v
            runs[f"{mode}/{admit}"] = {
                "streams": [r.generated for r in out["requests"]], "steps": out["steps"],
                "tokens": out["tokens"], "seconds": out["seconds"],
                "tok_per_s": out["tok_per_s"], "readbacks": out["engine"].readbacks,
                "cuda_graph": out["engine"].cuda_graph,
                "launches": {k: v for k, v in launches.items() if v},
                "plain_pack_codes_calls": off_kernel}
            del out
    checks = {f"{mode}_streams_identical": runs[f"{mode}/batched"]["streams"]
              == runs[f"{mode}/per-slot"]["streams"] for mode in ("greedy", "top_k")}
    checks["lut_kernels_launched"] = all(
        r["launches"].get("lut_affine", 0) + r["launches"].get("lut_affine_grouped", 0) > 0
        for r in runs.values())
    emit({"phase": "serve_lut", "runs": runs, "checks": checks, "nvidia_smi": smi_line()})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serve_lut: failed checks {failed}")
    return {"launches": total}


# ---------------------------------------------------------------------------
# train phase: the training path, then the quickstart's serve half
# ---------------------------------------------------------------------------


def train_flops(cfg, rows: int, seq: int) -> dict:
    """Model FLOPs of one training step (no recompute counted): 6 N per
    token for the N weights of the matmuls (every stacked projection and the
    head; the embedding's gather does none), plus attention's 12 L H hd S
    per token (QK^T and PV, 2 S hd each a head and layer in the forward,
    three times that with the backward; the port computes every score of
    the masked square)."""
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import tree_flatten

    specs = model_specs(cfg)
    leaves = tree_flatten(specs)[0]
    n_matmul = sum(math.prod(s.shape) for s in leaves if len(s.shape) >= 2) - \
        (0 if cfg.tie_embeddings else math.prod(specs["embed"].shape))
    tokens = rows * seq
    attn = 12 * cfg.num_layers * cfg.num_heads * cfg.head_dim * seq
    return {"matmul_params": n_matmul, "tokens": tokens,
            "flops_per_step": tokens * (6 * n_matmul + attn),
            "formula": "tokens x (6 N + 12 L H hd S), N the matmul weights (head "
                       "included, embedding gather not), no recompute"}


@contextlib.contextmanager
def deterministic(on: bool):
    """Inside a ``with`` block, ``torch.use_deterministic_algorithms(on)``
    (with cuBLAS's fixed workspace, which it asks for); both put back
    after.  The mode's filling of every new uninitialized tensor with NaN,
    a debugging aid that determinism does not need, stays off: it adds a
    kernel to each allocation."""
    import torch
    import torch.utils.deterministic

    was, env = torch.are_deterministic_algorithms_enabled(), os.environ.get(
        "CUBLAS_WORKSPACE_CONFIG")
    fill = torch.utils.deterministic.fill_uninitialized_memory
    if on:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(on)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        torch.utils.deterministic.fill_uninitialized_memory = fill
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env


@contextlib.contextmanager
def timed_saves():
    """Inside a ``with`` block, each ``dist.checkpoint.save_checkpoint`` call
    (the Trainer's saves: the copy to the host, the npz and the commit)
    timed from a synchronize; yields the list of seconds."""
    import torch

    from repro_torch.dist import checkpoint as ckpt

    save, seconds = ckpt.save_checkpoint, []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = save(*args, **kw)
        seconds.append(time.perf_counter() - t0)
        return out

    ckpt.save_checkpoint = timed
    try:
        yield seconds
    finally:
        ckpt.save_checkpoint = save


def clone_tree(tree):
    from repro_torch.models.params import tree_map

    return tree_map(lambda t: t.clone(), tree)


def step_stats(times_s, flops: dict) -> dict:
    """Median and p99 step ms, tokens/s and the model FLOPs' share of the
    card's dense bf16 peak at the median."""
    ms = sorted(t * 1e3 for t in times_s)
    med = statistics.median(ms)
    return {"steps": len(ms), "step_ms_median": med,
            "step_ms_p99": ms[min(len(ms) - 1, max(0, math.ceil(0.99 * len(ms)) - 1))],
            "tokens_per_s": flops["tokens"] / med * 1e3,
            "model_tflops_per_s": flops["flops_per_step"] / med / 1e9,
            "bf16_peak_share": flops["flops_per_step"] / (med / 1e3) / BF16_OPS_PER_S}


def timed_steps_of(step_fn, params, opt, batches) -> tuple[list, list]:
    """``step_fn`` over ``batches``; (losses, seconds a step, host clock
    from a synchronize to the loss read back)."""
    import torch

    losses, times = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    return losses, times


def train_step_profile(step_fn, params, opt, batches) -> dict:
    """torch.profiler over the last of ``batches``' train steps (the ones
    before it untimed): the step's wall ms on the host clock, device kernels,
    busy ms and idle share, and the ops that take most of the host's time
    and of the device's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for batch in batches[:-1]:
        params, opt, m = step_fn(params, opt, batch)
    float(m["loss"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        params, opt, m = step_fn(params, opt, batches[-1])
        float(m["loss"])
        wall_ms = (time.perf_counter() - start) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    if not kernels:
        raise AssertionError("the profiler recorded no kernel")
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    host = [e for e in events if not str(e.device_type).endswith("CUDA")]
    return {
        "wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
        "device_kernels": sum(e.count for e in kernels),
        "top_host_ops_self_ms": {e.key[:60]: [e.count, e.self_cpu_time_total / 1e3] for e in
                                 sorted(host, key=lambda e: -e.self_cpu_time_total)[:12]},
        "top_kernels_ms": {e.key[:60]: [e.count, e.self_device_time_total / 1e3] for e in
                           sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]},
        "wall_reason": "the profiler's own cost on the host is in this wall",
    }


def stream_bits_check(phase: str) -> None:
    """The LM stream's threefry bits and uniforms drawn on the card against
    the same draws on the CPU, bit for bit (the CPU's are held to JAX's in
    ``tests/test_torch_train.py``; the card's rest on int32 additions
    wrapping and on arithmetic shifts there): a vocab-512 batch's base draw
    and repeat mask as ``lm_batch`` keys them, and a run of elements across
    the 2**32 boundary, where the counter's high word turns non-zero."""
    import torch

    from repro_torch.data import synthetic as syn

    k1, k2 = syn.split(syn.fold_in(syn.prng_key(0), 3))
    draws = {"base": (k1, 0, 4 * 65 * 512), "repeat": (k2, 0, 4 * 65),
             "high_word": (k1, 2**32 - 4096, 8192)}
    equal = {}
    for name, (key, start, count) in draws.items():
        cpu = syn.random_bits(key, start, count, "cpu")
        card = syn.random_bits(key, start, count, DEV)
        equal[name] = {
            "bits": torch.equal(card.cpu(), cpu),
            "uniforms": torch.equal(syn.uniform_from_bits(card).cpu().view(torch.int32),
                                    syn.uniform_from_bits(cpu).view(torch.int32))}
    emit({"phase": phase, "step": "stream_bits", "draws": {k: v[2] for k, v in draws.items()},
          "card_equals_cpu": equal})
    if not all(all(v.values()) for v in equal.values()):
        raise AssertionError(f"{phase}: the card's stream bits differ from the CPU's: {equal}")


def family_flops(cfg, rows: int, seq: int, enc_len: int = 0) -> dict:
    """Model FLOPs of one training step of a non-decoder family, an
    estimate of this script's own (no recompute counted): 6 per weight and
    token for the matmul weights (2-D and up, head included, the embedding's
    gather not; the zamba2 shared block's once per invocation; whisper's
    encoder over its frames, its decoder and tied head over its tokens),
    plus attention's 12 H hd S per token and layer (self-attention over S,
    whisper's cross-attention over the frames).  The RWKV and SSD scans'
    element-wise work is not counted."""
    from repro_torch.models.hybrid import segments
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import tree_flatten

    specs = model_specs(cfg)

    def weights(tree) -> int:
        return sum(math.prod(t.shape) for t in tree_flatten(tree)[0] if len(t.shape) >= 2)

    hd = cfg.head_dim
    tokens = rows * seq
    if cfg.family == "encdec":
        enc_tokens = rows * enc_len
        head = math.prod(specs["embed"].shape)  # tied: the head is embed^T
        attn_enc = 12 * cfg.encoder_layers * cfg.num_heads * hd * enc_len
        attn_dec = 12 * cfg.num_layers * cfg.num_heads * hd * (seq + enc_len)
        flops = (enc_tokens * (6 * weights(specs["encoder"]) + attn_enc)
                 + tokens * (6 * (weights(specs["decoder"]) + head) + attn_dec))
        n = weights(specs["encoder"]) + weights(specs["decoder"]) + head
    elif cfg.family == "hybrid":
        calls = len(segments(cfg)) - 1
        head = (weights(specs["lm_head"]) if "lm_head" in specs
                else math.prod(specs["embed"].shape))
        n = weights(specs["mamba"]) + calls * weights(specs["shared"]) + head
        flops = tokens * (6 * n + 12 * calls * cfg.num_heads * hd * seq)
    else:
        n = weights(specs) - math.prod(specs["embed"].shape)
        flops = tokens * 6 * n
    return {"matmul_weights_per_token": n, "tokens": tokens, "frames": rows * enc_len,
            "flops_per_step": flops,
            "formula": "6 x matmul weights x tokens (the shared block per invocation, the "
                       "encoder over its frames) + 12 H hd S per token and attention layer; "
                       "scans not counted; no recompute"}


def no_save_trainer(*args):
    """A ``Trainer(*args)`` whose checkpoint writes are skipped (a family's
    weights and AdamW moments are tens of GB; the ``train_100m`` line
    measures the checkpoints)."""
    from repro_torch.train.trainer import Trainer

    class NoSaveTrainer(Trainer):
        def _save(self, step: int):
            pass

    return NoSaveTrainer(*args)


def kernels_of_step(step_fn, params, opt, batch) -> dict:
    """torch.profiler (device activity only: the host's events of a
    25,000-kernel step take longer to gather than the step) over one train
    step: its device kernels, busy ms, wall ms and idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        _, _, m = step_fn(params, opt, batch)
        float(m["loss"])
        wall_ms = (time.perf_counter() - start) * 1e3
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    if not kernels:
        raise AssertionError("the profiler recorded no kernel")
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"device_kernels": sum(e.count for e in kernels), "busy_ms": busy,
            "wall_ms": wall_ms, "idle_share": 1.0 - busy / wall_ms,
            "top_kernels_ms": {e.key[:60]: [e.count, e.self_device_time_total / 1e3] for e in
                               sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]}}


def family_train(phase: str, arch: str) -> None:
    """One ``family_train`` line: ``arch`` at full width (FAMILY_TRAIN: its
    depth, rows and tokens; whisper with ENCDEC_FRAMES seeded frame
    embeddings a row at std ENCDEC_FRAME_STD), seeded weights (RWKV's and
    the SSD's zeroed leaves redrawn as their serve cells draw them), bf16
    compute on fp32 weights, ``lm_stream`` batches, under the deterministic
    algorithms.  Step 1's gradients under remat ``none``: every leaf finite,
    at least FAMILY_TRAIN_NONZERO of them non-zero.  Then
    FAMILY_TRAIN_STEPS steps of a ``Trainer`` with remat ``"dots"`` (no
    checkpoint writes): its step-1 loss and gradient norm bit for bit those
    under ``none``, every loss and gradient norm finite; the median step ms
    (the first step untimed), tokens/s, peak memory, model FLOPs and their
    share of the bf16 peak; then one more step profiled
    (:func:`kernels_of_step`)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import lm_stream
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import init_params, tree_flatten
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train.trainer import TrainConfig, make_grad_fn

    t0 = time.perf_counter()
    seconds = {}
    layers, rows, seq = FAMILY_TRAIN[arch]
    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full, num_layers=layers)
    enc_len = ENCDEC_FRAMES if cfg.family == "encdec" else 0
    flops = family_flops(cfg, rows, seq, enc_len)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(model_specs(cfg), torch.Generator(device=DEV).manual_seed(0),
                         device=DEV)
    seeded = {"ssm": rwkv_seed_leaves, "hybrid": hybrid_seed_leaves}.get(cfg.family)
    seeded = seeded(params) if seeded else None
    stream = lm_stream(cfg.vocab_size, seq, rows, seed=0, device=DEV)
    batches = [next(stream) for _ in range(FAMILY_TRAIN_STEPS + 1)]
    if enc_len:
        gen = torch.Generator(device=DEV).manual_seed(ENCDEC_SEED)
        for b in batches:
            b["enc_embeds"] = ENCDEC_FRAME_STD * torch.randn(
                (rows, enc_len, cfg.d_model), generator=gen, device=DEV)
    tc = TrainConfig(peak_lr=3e-4, warmup_steps=2, total_steps=FAMILY_TRAIN_STEPS + 1,
                     out_dir=os.path.join(ROOT, "build", f"family_train_{arch}"))
    ctx = Ctx(cfg, ex=ExecCfg(remat="dots"))
    torch.cuda.synchronize()
    seconds["setup"] = time.perf_counter() - t0
    with deterministic(True):
        t1 = time.perf_counter()
        grads, loss, _ = make_grad_fn(Ctx(cfg, ex=ExecCfg(remat="none")), tc)(
            params, batches[0])
        leaves = tree_flatten(grads)[0]
        none = {"loss": float(loss), "grad_norm": float(global_norm(grads)),
                "leaves": len(leaves),
                "nonzero_leaves": sum(bool((g != 0).any()) for g in leaves),
                "finite": all(bool(torch.isfinite(g).all()) for g in leaves)
                and math.isfinite(float(loss))}
        del grads, leaves
        torch.cuda.synchronize()
        grad_peak = torch.cuda.max_memory_allocated()
        seconds["step1_none"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        trainer = no_save_trainer(ctx, tc, params, iter(batches[:-1]))
        log = trainer.run(FAMILY_TRAIN_STEPS)
        peak = torch.cuda.max_memory_allocated()
        seconds["trainer"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        profile = kernels_of_step(trainer.step_fn, trainer.params, trainer.opt_state,
                                  batches[-1])
        seconds["profiled_step"] = time.perf_counter() - t1
    losses = [r["loss"] for r in log]
    norms = [r["grad_norm"] for r in log]
    dots = {"loss": losses[0], "grad_norm": norms[0]}
    checks = {
        "step1_finite": none["finite"],
        "step1_nonzero_leaves": none["nonzero_leaves"] >= FAMILY_TRAIN_NONZERO * none["leaves"],
        "step1_remat_dots_equals_none": (none["loss"], none["grad_norm"])
        == (dots["loss"], dots["grad_norm"]),
        "every_step_once": [r["step"] for r in log] == list(range(1, FAMILY_TRAIN_STEPS + 1)),
        "losses_finite": all(math.isfinite(x) for x in losses + norms)}
    seconds["total"] = time.perf_counter() - t0
    emit({"phase": phase, "step": "family_train", "arch": arch, "family": cfg.family,
          "layers": cfg.num_layers, "published_layers": full.num_layers,
          **({"encoder_layers": cfg.encoder_layers, "frames": enc_len} if enc_len else {}),
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "params": sum(t.numel() for t in tree_flatten(params)[0]), "rows": rows, "seq": seq,
          "remat": "dots", "compute_dtype": str(tc.compute_dtype),
          "deterministic_algorithms": True, **({"seeded_leaves": seeded} if seeded else {}),
          "step1": {"none": none, "dots": dots}, "losses": losses, "grad_norms": norms,
          **step_stats([r["time_s"] for r in log[1:]], flops), **flops,
          "max_memory_allocated_gib": peak / 2**30,
          "step1_none_max_memory_allocated_gib": grad_peak / 2**30,
          "kernels_per_step": profile["device_kernels"], "step_profile": profile,
          "timing_reason": "the first Trainer step untimed (allocator warm-up)",
          "seconds": seconds, "checks": checks, "nvidia_smi": smi_line()})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{phase} {arch}: failed checks {failed}")


def train_phase() -> dict:
    """The port's training path, then the quickstart's serve half.

    (a) ``examples/train_100m.py``'s ``100m`` preset at full width and all
    12 layers (d_model 768, 12 heads to 4 KV heads of 64, d_ff 3072, vocab
    32,000), weights drawn on the card from seed 0, the example's recipe (remat ``"dots"``, bf16 compute on fp32
    weights, peak lr 3e-4 after max(steps // 10, 5) warmup steps, AdamW):
    TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens from ``lm_stream``
    with a checkpoint every TRAIN_CKPT_EVERY, straight through, then the
    ``--demo-restart`` way (a fresh ``Trainer`` restores the step-20
    checkpoint and finishes), both under ``torch.use_deterministic_algorithms``
    (:func:`deterministic`).  Gates: the two runs' losses and final
    parameters equal bit for bit; every step once (no replay); every loss
    finite, the last 5 below the first 5.  Then TRAIN_REMAT_STEPS steps
    under remat ``none``, ``full`` and ``dots`` (losses compared), and
    ``dots`` with the deterministic algorithms off.
    (b) ``granite_8b`` at full width, TRAIN_GRANITE_LAYERS of 36 layers:
    TRAIN_GRANITE_STEPS steps, no checkpoint.
    (c) (a)'s trained tree planned by the serving recipe (the quickstart's
    uniform chunk-2 plan and a plan at half its bytes, with the frontier
    widened to the shift modes and i8 tables, chunks capped at 1, as every
    served cell; the quickstart's own signed fp16 ``bitplane`` tables would
    take ~2,800 x the weights' bytes and pack off the kernel), converted,
    its plan through a checkpoint's ``aux`` and back; ``generate`` of
    TRAIN_ROWS x TRAIN_PROMPT stream tokens and TRAIN_NEW new on the kernels
    (``lut_grouped``), its launches counted: as the plan says a forward, no
    pack off the kernel; first tokens against the plain path on the kernel
    path's codes (:func:`synced_generate`); 1-layer prefill logits within
    LOGITS_TOL.  Reported: table bytes, the held-out loss of TRAIN_HELD_OUT
    stream batches past the last step dense against LUT, next-token argmax
    agreement, and the LUT streams against the dense ``generate``'s."""
    import shutil

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.convert import conversion_summary, convert_params
    from repro_torch.core.planner import ModelPlan, plan_model
    from repro_torch.data.pipeline import lm_stream
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.examples.train_100m import PRESETS, setup
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.models.model import model_forward, model_specs
    from repro_torch.models.params import init_params, tree_leaves
    from repro_torch.train.losses import cross_entropy
    from repro_torch.train.trainer import (
        TrainConfig,
        Trainer,
        init_train_state,
        make_train_step,
    )

    phase = "train"
    out = os.path.join(ROOT, "build", "train_smoke")  # /build/ is git-ignored
    shutil.rmtree(out, ignore_errors=True)
    cfg = PRESETS["100m"]
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    ctx, tc, _, data_from = setup(
        cfg, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_CKPT_EVERY, os.path.join(out, "a"), DEV)

    # the stream: TRAIN_STEPS training batches and TRAIN_HELD_OUT past them,
    # drawn once on the card (the restart replays the same steps' batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream = data_from(0)
    batches = [next(stream) for _ in range(TRAIN_STEPS + TRAIN_HELD_OUT)]
    torch.cuda.synchronize()
    data_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    held_out = batches[TRAIN_STEPS:]
    stream_bits_check(phase)
    t0 = time.perf_counter()
    init = init_params(model_specs(cfg), torch.Generator(device=DEV).manual_seed(0), device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    half = TRAIN_STEPS // 2
    with deterministic(True), timed_saves() as saves:
        torch.cuda.reset_peak_memory_stats()
        straight = Trainer(ctx, tc, clone_tree(init), iter(batches))
        log_a = straight.run(TRAIN_STEPS)
        peak_a = torch.cuda.max_memory_allocated()
        # the restart: a fresh Trainer over a directory holding only the
        # straight run's committed step-`half` checkpoint (hard links: the
        # bytes that run wrote) restores it and finishes
        tc_b = dataclasses.replace(tc, out_dir=os.path.join(out, "b"))
        src = os.path.join(tc.out_dir, "checkpoints", f"step_{half:08d}")
        dst = os.path.join(tc_b.out_dir, "checkpoints", f"step_{half:08d}")
        os.makedirs(dst)
        for name in os.listdir(src):
            os.link(os.path.join(src, name), os.path.join(dst, name))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        second = Trainer(ctx, tc_b, clone_tree(init), iter(batches[half:TRAIN_STEPS]))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        log_b = log_a[:half] + second.run(TRAIN_STEPS)
    ckpt_dir = os.path.join(tc.out_dir, "checkpoints")
    step_dir = os.path.join(ckpt_dir, f"step_{TRAIN_STEPS:08d}")
    ckpt_bytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
    losses_a, losses_b = [r["loss"] for r in log_a], [r["loss"] for r in log_b]
    params_equal = all(torch.equal(x, y) for x, y in
                       zip(tree_leaves(straight.params), tree_leaves(second.params)))
    steps_once = ([r["step"] for r in log_a] == list(range(1, TRAIN_STEPS + 1)) and
                  [r["step"] for r in log_b] == list(range(1, TRAIN_STEPS + 1)))
    finite = all(math.isfinite(x) for x in losses_a + losses_b)
    first5, last5 = statistics.mean(losses_a[:5]), statistics.mean(losses_a[-5:])
    checks = {"restart_losses_bit_equal": losses_a == losses_b,
              "restart_params_bit_equal": params_equal, "every_step_once": steps_once,
              "losses_finite": finite, "loss_falls": last5 < first5,
              "restart_start_step": second.start_step == half}
    emit({"phase": phase, "step": "train_100m", "config": dataclasses.asdict(cfg),
          "params": sum(t.numel() for t in tree_leaves(init)), "batch": TRAIN_BATCH,
          "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "checkpoint_every": TRAIN_CKPT_EVERY,
          "remat": ctx.ex.remat, "compute_dtype": str(tc.compute_dtype), "peak_lr": tc.peak_lr,
          "warmup_steps": tc.warmup_steps, "deterministic_algorithms": True,
          **step_stats([r["time_s"] for r in log_a], flops), **flops,
          "restart_run": step_stats([r["time_s"] for r in log_b[half:]], flops),
          "losses": losses_a, "first5_mean": first5, "last5_mean": last5,
          "grad_norm_last": log_a[-1]["grad_norm"], "lr_last": log_a[-1]["lr"],
          "max_memory_allocated_gib": peak_a / 2**30, "data_ms_per_batch": data_ms,
          "init_s": init_s, "checkpoint_bytes": ckpt_bytes, "save_s": saves,
          "restore_s": restore_s, "restore_reason": "a fresh Trainer's construction: zero "
          f"moments, then the step-{half} checkpoint read and put on the card",
          "checks": checks, "nvidia_smi": smi_line()})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{phase}: failed checks {failed}")
    trained = straight.params
    del second, straight

    # remat policies and the deterministic algorithms, TRAIN_REMAT_STEPS steps each
    runs = {}
    some = batches[:TRAIN_REMAT_STEPS]
    for name, remat, det in (("none", "none", True), ("full", "full", True),
                             ("dots", "dots", True), ("dots_nondeterministic", "dots", False)):
        with deterministic(det):
            step_fn = make_train_step(Ctx(cfg, ex=ExecCfg(remat=remat)), tc)
            params = clone_tree(init)
            opt = init_train_state(ctx, tc, params)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            losses, times = timed_steps_of(step_fn, params, opt, some)
            runs[name] = {"remat": remat, "deterministic_algorithms": det, "losses": losses,
                          **step_stats(times[1:], flops),
                          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
                          "losses_equal_straight_run": losses == losses_a[:TRAIN_REMAT_STEPS]}
            del params, opt
    emit({"phase": phase, "step": "remat", "runs": runs,
          "timing_reason": "the first of each run's steps untimed (allocator warm-up)",
          "losses_equal_across_remat": runs["none"]["losses"] == runs["full"]["losses"]
          == runs["dots"]["losses"]})
    with deterministic(True):
        params = clone_tree(init)
        emit({"phase": phase, "step": "step_profile", "remat": "dots",
              **train_step_profile(make_train_step(ctx, tc), params,
                                   init_train_state(ctx, tc, params), batches[:2])})
        del params
    del init

    # (b) granite_8b at full width, TRAIN_GRANITE_LAYERS layers
    gcfg = dataclasses.replace(get_config("granite_8b"), num_layers=TRAIN_GRANITE_LAYERS)
    gflops = train_flops(gcfg, TRAIN_BATCH, TRAIN_SEQ)
    gctx = Ctx(gcfg, ex=ExecCfg(remat="dots"))
    gtc = TrainConfig(peak_lr=3e-4, warmup_steps=5, total_steps=TRAIN_GRANITE_STEPS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gparams = init_params(model_specs(gcfg), torch.Generator(device=DEV).manual_seed(0),
                          device=DEV)
    gstream = lm_stream(gcfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0, device=DEV)
    gbatches = [next(gstream) for _ in range(TRAIN_GRANITE_STEPS)]
    glosses, gtimes = timed_steps_of(make_train_step(gctx, gtc), gparams,
                                     init_train_state(gctx, gtc, gparams), gbatches)
    emit({"phase": phase, "step": "granite_8b", "layers": TRAIN_GRANITE_LAYERS,
          "published_layers": get_config("granite_8b").num_layers,
          "d_model": gcfg.d_model, "d_ff": gcfg.d_ff, "vocab": gcfg.vocab_size,
          "params": sum(t.numel() for t in tree_leaves(gparams)), "remat": "dots",
          "compute_dtype": "torch.bfloat16", "losses": glosses,
          **step_stats(gtimes[1:], gflops), **gflops,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
          "timing_reason": "the first step untimed (allocator warm-up)"})
    if not all(math.isfinite(x) for x in glosses):
        raise AssertionError(f"{phase}: granite_8b losses {glosses}")
    del gparams, gbatches
    torch.cuda.empty_cache()
    for arch in FAMILY_TRAIN:
        family_train(phase, arch)
        torch.cuda.empty_cache()

    # (c) the quickstart's serve half on (a)'s trained tree
    t0 = time.perf_counter()
    uniform = plan_model(trained, float("inf"), max_chunk=2)
    plan = plan_model(trained, uniform.total_lut_bytes // 2, max_chunk=1, **RECIPE_FRONTIER)
    plan_s = time.perf_counter() - t0
    lut, report = convert_params(trained, plan=plan)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0 - plan_s
    aux_dir = os.path.join(out, "lut_ckpt")
    ckpt.save_checkpoint(aux_dir, 0, trained, aux={"model_plan": plan.to_json()})
    restored = ModelPlan.from_json(ckpt.load_aux(aux_dir, ckpt.latest_step(aux_dir))["model_plan"])
    plan_roundtrip = dict(restored.layers) == dict(plan.layers) and restored.groups == plan.groups
    kinds = sorted({f"{p.mode}-r{p.fmt.mantissa_radix}-{p.table_format}-c{p.chunk_size}"
                    for p in plan.layers.values()})
    per_forward = lut_calls_per_forward(lut, cfg.num_layers)
    prompts = held_out[0]["tokens"][:TRAIN_ROWS, :TRAIN_PROMPT].contiguous()
    reset_launches()
    streams, gen_ms = greedy_generate(lut, cfg, prompts, TRAIN_NEW)
    torch.cuda.synchronize()
    launches, off_kernel = read_launches(), plain_pack_codes_calls()
    expect = {**no_launches(), **{k: v * TRAIN_NEW for k, v in per_forward.items()}}
    dense_streams, dense_ms = greedy_generate(trained, cfg, prompts, TRAIN_NEW)
    agree = [sum(x == y for x, y in zip(r, q)) for r, q in zip(streams, dense_streams)]
    one = compare_logits(cut_logits(lut, cfg, prompts, 1),
                         cut_logits(lut, cfg, prompts, 1, use_kernels=False))
    tol = LOGITS_TOL * one["max_abs_ref"]
    # held-out loss, dense (fp32) against LUT, and next-token agreement
    dctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True))
    dense_loss, lut_loss, next_agree = [], [], []
    t0 = time.perf_counter()
    with torch.no_grad():
        for b in held_out:
            d = model_forward(trained, {"tokens": b["tokens"]}, dctx)[0]
            q = model_forward(lut, {"tokens": b["tokens"]}, dctx)[0]
            dense_loss.append(float(cross_entropy(d, b["labels"], cfg.vocab_size)[0]))
            lut_loss.append(float(cross_entropy(q, b["labels"], cfg.vocab_size)[0]))
            next_agree.append((d.argmax(-1) == q.argmax(-1)).float().mean().item())
            del d, q
    held_out_s = time.perf_counter() - t0
    checks = {"launches_as_planned": launches == expect, "no_pack_off_kernel": off_kernel == 0,
              "plan_through_aux": plan_roundtrip,
              "prefill_logits_1_layer": one["max_abs_err"] <= tol
              and one["rel_fro_err"] <= LOGITS_FRO_TOL}
    emit({"phase": phase, "step": "serve", "plan": plan.summary(), "plans": kinds,
          "table_bytes": report.table_bytes, "weight_bytes": report.weight_bytes,
          "uniform_chunk2_table_bytes": uniform.total_lut_bytes,
          "conversion": conversion_summary(report), "plan_s": plan_s, "convert_s": convert_s,
          "per_forward": per_forward, "forwards": TRAIN_NEW, "launches": launches,
          "expected_launches": expect, "plain_pack_codes_calls": off_kernel,
          "generate_ms": gen_ms, "dense_generate_ms": dense_ms, "rows": TRAIN_ROWS,
          "prompt": TRAIN_PROMPT, "new": TRAIN_NEW, "streams": streams,
          "dense_streams": dense_streams, "tokens_agreeing_dense_per_row": agree,
          "prefill_logits_1_layer": {**one, "tol": tol, "rel_fro_tol": LOGITS_FRO_TOL},
          "held_out_loss": {"dense_fp32": dense_loss, "lut": lut_loss,
                            "batches": TRAIN_HELD_OUT, "steps_from": TRAIN_STEPS},
          "held_out_next_token_argmax_agree": next_agree, "held_out_s": held_out_s,
          "checks": checks,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{phase}: failed serve checks {failed}")
    synced_generate(phase, lut, cfg, prompts, TRAIN_SYNC_NEW, per_forward["bitplane_pack"],
                    "the decode steps attend over K/V that each path rounded to bf16 on its own")
    del lut, trained
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches": launches}


# the audit phase: the reference's three audit points at full width, cut in
# depth as the train phase cuts granite_8b (2 of 36) and as moe_serve cuts
# qwen2_moe_a2_7b (2 of 24)
AUDIT_LAYERS = {"granite_weight": TRAIN_GRANITE_LAYERS, "granite_tl1": TRAIN_GRANITE_LAYERS,
                "moe_weight_experts": 2}
AUDIT_CENSUS_TOP = 12


def audit_model(pt):
    """One audit point at full width on the card: seeded weights, the cut
    of AUDIT_LAYERS, and the plan the card's kernels serve -- the serving
    recipe with chunks capped at 1 (:func:`recipe_plans`) for the weight
    points (the point's own fp16 bitplane tables are a type no weight
    kernel takes), the point's own TL1 plan for ``granite_tl1``; tiles tuned
    at the point's batch; converted.  Returns (published config, config,
    plan, converted tree)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.convert import convert_params
    from repro_torch.core.planner import plan_model
    from repro_torch.kernels.lut_affine.autotune import attach_tuned_blocks
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import init_params

    full = get_config(pt.arch)
    cfg = dataclasses.replace(full, num_layers=AUDIT_LAYERS[pt.name])
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = init_params(model_specs(cfg), gen, device=DEV)
    if "tl1" in pt.families:
        mplan = plan_model(params, float("inf"), families=pt.families,
                           tl1_act_bits=pt.tl1_act_bits)
    else:
        mplan, _ = recipe_plans(params, convert_experts=pt.convert_experts)
    # tiles tuned at the point's batch, as audit/points.py::build_point attaches them
    mplan = attach_tuned_blocks(mplan, pt.batch)
    lut, report = convert_params(params, plan=mplan, convert_experts=pt.convert_experts)
    del params
    if report.table_bytes != mplan.total_lut_bytes:
        raise AssertionError(f"tables {report.table_bytes} B != plan {mplan.total_lut_bytes} B")
    return full, cfg, mplan, lut


def audit_phase() -> dict:
    """The audit (``repro_torch.audit``) over the port's serving steps on the
    kernels: per point one eager prefill and one eager decode step under the
    recorder, every rule class empty, each step's opaque kernel leaves equal
    to the launches the wrappers counted in it; then a seeded dense fallback
    (``wq`` left unconverted at full width) must trip ``multiplier_free``.
    Any failure raises."""
    import torch

    from repro_torch.audit.points import (
        AUDIT_POINTS,
        audit_artifacts,
        point_artifacts,
        trace_steps,
    )
    from repro_torch.audit.rules import multiplier_free_violations, planned_weight_shapes
    from repro_torch.audit.walker import kernel_leaves, record
    from repro_torch.serve import make_cache

    for pt in AUDIT_POINTS:
        t0 = time.perf_counter()
        full, cfg, mplan, lut = audit_model(pt)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (pt.batch, pt.prefill_len), generator=gen,
                               dtype=torch.int32)
        art = point_artifacts(pt, cfg, mplan, lut, tokens.to(DEV), DEV)
        t1 = time.perf_counter()
        art.update(trace_steps(art))
        torch.cuda.synchronize()
        record_s = time.perf_counter() - t1
        entry = audit_artifacts(art)
        leaves = {step: kernel_leaves(art[f"{step}_ops"]) for step in ("prefill", "decode")}
        census = entry["census"]["decode"]
        top = dict(sorted(census.items(), key=lambda kv: -kv[1])[:AUDIT_CENSUS_TOP])
        line = {
            "phase": "audit", "step": "point", "name": pt.name, "arch": pt.arch,
            "depth": {"layers": cfg.num_layers, "published": full.num_layers},
            "plan": mplan.summary(),
            "plans": sorted({
                f"{p.mode}-r{p.fmt.mantissa_radix}-{p.table_format}-c{p.chunk_size}"
                if p.table_family == "weight" else f"tl1-act{p.act_bits}"
                for p in mplan.layers.values()
            }),
            "rules": {rule: len(v) for rule, v in entry["rules"].items()},
            "violations": [v for vs in entry["rules"].values() for v in vs][:8],
            "ops": {step: sum(entry["census"][step].values()) for step in ("prefill", "decode")},
            "decode_census_top": top,
            "kernel_leaves": leaves, "launches": art["launches"],
            "leaves_equal_launches": all(leaves[s] == art["launches"][s] for s in leaves),
            "build_seconds": build_s, "record_seconds": record_s,
        }
        emit(line)
        if any(entry["rules"].values()):
            raise AssertionError(f"audit {pt.name}: rules violated: {line['violations']}")
        if not line["leaves_equal_launches"]:
            raise AssertionError(f"audit {pt.name}: leaves {leaves} != launches {art['launches']}")
        if not leaves["decode"] or not leaves["prefill"]:
            raise AssertionError(f"audit {pt.name}: a step launched no kernel: {leaves}")
        if pt.name == "granite_weight":
            # the seeded dense fallback: wq left unconverted, at full width
            wq = lut["blocks"]["attn"]["wq"]
            q, p = wq.plan.in_features, wq.plan.out_features
            g = torch.Generator(device=DEV).manual_seed(2)
            w = torch.randn((cfg.num_layers, q, p), generator=g, device=DEV) / math.sqrt(q)
            attn = {**lut["blocks"]["attn"], "wq": {"w": w}}
            broken = {**lut, "blocks": {**lut["blocks"], "attn": attn}}
            cache = make_cache(cfg, pt.batch, pt.cache_len, art["ctx"], device=DEV)
            with torch.no_grad():
                _, ops = record(art["decode"], broken, cache,
                                torch.zeros((pt.batch, 1), dtype=torch.int32, device=DEV))
            hits = multiplier_free_violations(ops, weight_shapes=planned_weight_shapes(mplan))
            emit({"phase": "audit", "step": "dense_fallback", "name": pt.name,
                  "spliced": "blocks/attn/wq", "weight": [cfg.num_layers, q, p],
                  "flagged": [v.to_json() for v in hits],
                  "kernel_leaves": kernel_leaves(ops)})
            if not hits or {v.primitive for v in hits} != {"mm"}:
                raise AssertionError(f"audit: the dense fallback was not flagged: {hits}")
            del w, attn, broken, cache, ops
        del art, lut
        torch.cuda.empty_cache()
        emit({"phase": "audit", "step": "point_seconds", "name": pt.name,
              "seconds": time.perf_counter() - t0})


def dist_phase() -> dict:
    """Data-parallel and pod-compressed training on an NCCL world of one
    rank (``launch/mesh.py``: ``init_world`` and a ``("pod", "data")`` mesh
    of ``(1, 1)``): the ``train`` phase's ``100m`` recipe (full width, all
    12 layers, remat ``"dots"``, bf16 compute on fp32 weights), DIST_STEPS
    ``lm_stream`` batches of TRAIN_BATCH x TRAIN_SEQ tokens, under the
    deterministic algorithms.

    Gates: (off) the mesh's ``Trainer`` equals the no-mesh ``Trainer`` bit
    for bit, losses and final weights; (on) step 1's gradients equal
    ``compressed_psum_ref`` of the no-mesh gradients bit for bit, the
    residual rows too, each within half a quantization step (and fp32's
    rounding of ``c / scale``: 2**-15 of a step); every loss finite and the
    mean of the last 4 below the first 4's, off and on; the compressed run
    checkpointed at DIST_CKPT_AT (``err`` included, ``(1,) + shape``) and
    restored by a fresh ``Trainer`` finishes equal to the straight run bit
    for bit; the collectives recorded in one compressed step (the audit's
    walker, each an opaque leaf) are the predicted ones: the valid-label
    count, loss and gradient sums over ``data``, then one MAX of the
    leaves' absmax (4 bytes a leaf) and one int32 SUM of their codes (4
    bytes an element) over ``pod``, then the pod mean of loss and aux.
    Reported: median step ms of the no-mesh, off and on runs without
    checkpoint writes, each run twice in turns (no mesh, off, on, on, off,
    no mesh; the first step of each run untimed), and every step's ms, one device-only profiled step of each, ``collective_stats`` at n = 1 and,
    from the same records, computed at DIST_COMPUTED_N."""
    import datetime
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.audit.walker import record
    from repro_torch.dist.compression import collective_stats, compressed_psum_ref
    from repro_torch.dist.sharding import ShardCtx
    from repro_torch.examples.train_100m import PRESETS, setup
    from repro_torch.launch.mesh import init_world, make_mesh
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import init_params, tree_flatten, tree_leaves, tree_map
    from repro_torch.train.trainer import Trainer, init_train_state, make_grad_fn, \
        make_train_step

    phase = "dist"
    t_phase = time.perf_counter()
    out = os.path.join(ROOT, "build", "dist_smoke")  # /build/ is git-ignored
    shutil.rmtree(out, ignore_errors=True)
    cfg = PRESETS["100m"]
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    ctx, tc, _, data_from = setup(cfg, DIST_STEPS, TRAIN_BATCH, TRAIN_SEQ, DIST_CKPT_AT,
                                  os.path.join(out, "off"), DEV)
    tc_on = dataclasses.replace(tc, compress_pod_grads=True, out_dir=os.path.join(out, "on"))
    stream = data_from(0)
    batches = [next(stream) for _ in range(DIST_STEPS)]
    init = init_params(model_specs(cfg), torch.Generator(device=DEV).manual_seed(0), device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    init_world(device=DEV, timeout=datetime.timedelta(seconds=300))
    world_s, backend = time.perf_counter() - t0, dist.get_backend()
    try:
        mesh = make_mesh((1, 1), ("pod", "data"), device=DEV)
        mctx = dataclasses.replace(ctx, shard=ShardCtx(mesh))
        with deterministic(True):
            # off: the mesh's Trainer against the no-mesh Trainer
            alone = no_save_trainer(ctx, tc, clone_tree(init), iter(batches))
            log_alone = alone.run(DIST_STEPS)
            meshed = no_save_trainer(mctx, tc, clone_tree(init), iter(batches))
            log_off = meshed.run(DIST_STEPS)
            off_equal = ([r["loss"] for r in log_off] == [r["loss"] for r in log_alone] and
                         all(torch.equal(a, b) for a, b in zip(tree_leaves(meshed.params),
                                                               tree_leaves(alone.params))))
            del alone, meshed
            # on, timed as off is (no checkpoint writes between its steps); then
            # the three again in the other order: turns no mesh, off, on, on,
            # off, no mesh
            log_on_timed = no_save_trainer(mctx, tc_on, clone_tree(init),
                                           iter(batches)).run(DIST_STEPS)
            again = {name: no_save_trainer(c, t, clone_tree(init), iter(batches)).run(DIST_STEPS)
                     for name, c, t in (("on", mctx, tc_on), ("off", mctx, tc),
                                        ("no_mesh", ctx, tc))}
            # on, step 1: the no-mesh gradients through compressed_psum_ref
            params = clone_tree(init)
            g_alone, _, _ = make_grad_fn(ctx, tc)(params, batches[0])
            opt = init_train_state(mctx, tc_on, params)
            (g_on, _, _), ops = record(make_grad_fn(mctx, tc_on), params, batches[0],
                                       opt["err"])
            want, want_err = compressed_psum_ref(tree_map(lambda g: g[None], g_alone),
                                                 tree_map(torch.zeros_like, opt["err"]))
            grads_equal = all(torch.equal(a, b) for a, b in zip(tree_leaves(g_on),
                                                                tree_leaves(want)))
            err_equal = all(torch.equal(a, b) for a, b in zip(tree_leaves(opt["err"]),
                                                              tree_leaves(want_err)))
            worst = 0.0  # the largest |residual| over its leaf's step
            for g, e in zip(tree_leaves(g_alone), tree_leaves(opt["err"])):
                scale = max(float(g.float().abs().max()), torch.finfo(torch.float32).tiny) / 127
                worst = max(worst, float(e.abs().max()) / scale)
            del g_alone, g_on, want, want_err, params, opt
            # on: straight through with a checkpoint, then restarted from it
            straight = Trainer(mctx, tc_on, clone_tree(init), iter(batches))
            log_on = straight.run(DIST_STEPS)
            tc_b = dataclasses.replace(tc_on, out_dir=os.path.join(out, "on_restart"))
            src = os.path.join(tc_on.out_dir, "checkpoints", f"step_{DIST_CKPT_AT:08d}")
            dst = os.path.join(tc_b.out_dir, "checkpoints", f"step_{DIST_CKPT_AT:08d}")
            os.makedirs(dst)
            for name in os.listdir(src):
                os.link(os.path.join(src, name), os.path.join(dst, name))
            with open(os.path.join(src, "meta.json")) as f:
                err_shapes = [rec["shape"] for rec in json.load(f)["leaves"]
                              [:len(tree_leaves(init))]]
            second = Trainer(mctx, tc_b, clone_tree(init), iter(batches[DIST_CKPT_AT:]))
            log_b = log_on[:DIST_CKPT_AT] + second.run(DIST_STEPS)
            restart_equal = ([r["loss"] for r in log_b] == [r["loss"] for r in log_on] and
                             all(torch.equal(a, b) for a, b in zip(
                                 tree_leaves((straight.params, straight.opt_state)),
                                 tree_leaves((second.params, second.opt_state)))))
            profiles = {}
            for name, c, t in (("off", mctx, tc), ("on", mctx, tc_on)):
                params = clone_tree(init)
                profiles[name] = kernels_of_step(make_train_step(c, t), params,
                                                 init_train_state(c, t, params), batches[0])
                del params
            del second, straight
    finally:
        dist.destroy_process_group()
        shutil.rmtree(out, ignore_errors=True)

    leaves = tree_flatten(init)[0]
    n_elems, n_leaves = sum(t.numel() for t in leaves), len(leaves)
    got = [(op.kwargs["collective"], op.kwargs["reduce"], op.kwargs["dtype"],
            list(op.kwargs["shape"]), op.kwargs["group_size"])
           for op in ops if "collective" in op.kwargs]
    predicted = [("all-reduce", "sum", "torch.int64", [1], 1),
                 ("all-reduce", "sum", "torch.float32", [2], 1),
                 ("all-reduce", "sum", "torch.float32", [n_elems], 1),
                 ("all-reduce", "max", "torch.float32", [n_leaves], 1),
                 ("all-reduce", "sum", "torch.int32", [n_elems], 1),
                 ("all-reduce", "sum", "torch.float32", [2], 1)]
    stats = {"n_1": collective_stats(ops).to_dict(),
             **{f"n_{n}_computed": collective_stats(ops, group_size=n).to_dict()
                for n in DIST_COMPUTED_N}}
    losses = {"off": [r["loss"] for r in log_off], "on": [r["loss"] for r in log_on]}
    timed = {"no_mesh": (log_alone, again["no_mesh"]), "off": (log_off, again["off"]),
             "on": (log_on_timed, again["on"])}
    ms = {k: statistics.median(r["time_s"] * 1e3 for log in logs for r in log[1:])
          for k, logs in timed.items()}
    checks = {
        "off_equals_no_mesh": off_equal, "on_step1_grads_equal_ref": grads_equal,
        "on_step1_err_equal_ref": err_equal,
        "on_err_within_half_step": worst <= 0.5 + 2**-15,
        "losses_finite": all(math.isfinite(x) for v in losses.values() for x in v),
        "loss_falls": all(statistics.mean(v[-4:]) < statistics.mean(v[:4])
                          for v in losses.values()),
        "on_timed_runs_equal_on": all([r["loss"] for r in log] == losses["on"]
                                      for log in timed["on"]),
        "restart_bit_equal": restart_equal,
        "err_leaves_pod_shaped": err_shapes == [[1] + list(t.shape) for t in leaves],
        "collectives_as_predicted": got == predicted}
    emit({"phase": phase, "step": "dist", "world": {"backend": backend, "ranks": 1,
                                                     "mesh": [[1, 1], ["pod", "data"]],
                                                     "init_s": world_s},
          "config": cfg.name, "params": n_elems, "leaves": n_leaves, "batch": TRAIN_BATCH,
          "seq": TRAIN_SEQ, "steps": DIST_STEPS, "remat": ctx.ex.remat,
          "compute_dtype": str(tc.compute_dtype), "deterministic_algorithms": True,
          "step_ms_median": ms, "on_minus_off_ms": ms["on"] - ms["off"],
          "off_minus_no_mesh_ms": ms["off"] - ms["no_mesh"],
          "off": step_stats([r["time_s"] for log in timed["off"] for r in log[1:]], flops),
          "on": step_stats([r["time_s"] for log in timed["on"] for r in log[1:]], flops),
          "step_ms": {k: [[r["time_s"] * 1e3 for r in log] for log in logs]
                      for k, logs in timed.items()},
          "profiled_step": profiles, "losses": losses,
          "max_err_over_step": worst, "collectives": got, "collective_stats": stats,
          "computed_reason": "n_2 / n_16: the same records' ring-model bytes over groups of "
                             "that size (one card holds one rank)",
          "timing_reason": "the first step of each run untimed (allocator warm-up)",
          "checks": checks, "seconds": time.perf_counter() - t_phase,
          "nvidia_smi": smi_line()})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{phase}: failed checks {failed}")
    return {"step_ms": ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--phases",
        default="device,autotune,pack_kernel,kernel,serve,paged_serve,mla_serve,phi3_serve,"
                "minitron_serve,mixtral_serve,vlm_serve,rwkv_serve,hybrid_serve,encdec_serve,"
                "serve_lut,tl1_kernel,tl1_serve,moe_kernel,moe_serve,bmm_kernel,bmm_serve,paper,"
                "onehot,train,audit,dist",
    )
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build
    from repro_torch.kernels.lut_affine import ops as lut_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    built = build.build(force=True)
    ptxas = {name: ptxas_report(log) for name, log in build.BUILD_LOG.items()}
    dynamic_smem = {
        "binary_matmul": {tile: build.load("binary_matmul").binary_matmul_smem_bytes(i)
                          for i, tile in enumerate(("decode", "prefill"))},
        "lut_tl1": build.load("lut_tl1").lut_tl1_smem_bytes(),
        # the main path's n = 3 planes, 32 entries
        "lut_affine": {regime: lut_ops._lib().lut_affine_smem_bytes(i, 3, 32)
                       for i, regime in enumerate(lut_ops.REGIMES)},
    }
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "tf32": {"matmul": False, "cudnn": False},
          "build_seconds": build.BUILD_SECONDS, "libraries": {k: str(v) for k, v in built.items()},
          "ptxas": ptxas, "dynamic_smem_bytes": dynamic_smem,
          "lut_affine_sass_loops": sass_loops(built["lut_affine"])})
    def run(name, fn, *a):
        """Phase ``name`` if asked for, its seconds emitted after it."""
        if name not in phases:
            return None
        t0 = time.perf_counter()
        out = fn(*a)
        emit({"phase": name, "step": "seconds", "seconds": time.perf_counter() - t0})
        return out

    run("autotune", autotune_phase, args.iters)
    torch.cuda.empty_cache()
    pkern = run("pack_kernel", pack_kernel_phase, args.iters)
    kern = run("kernel", kernel_phase, args.iters, 4 * 32)
    srv = run("serve", serve_phase, LAYERS, REQUESTS, MAX_NEW)
    # the paged engine serves the serve phase's converted tables (26 GiB)
    psrv = run("paged_serve", paged_serve_phase, srv and srv.pop("model"), LAYERS, MAX_NEW)
    if srv is not None:
        srv.pop("model", None)
    torch.cuda.empty_cache()
    mla = run("mla_serve", mla_serve_phase, MLA_LAYERS, REQUESTS, MAX_NEW, args.iters)
    phi3 = run("phi3_serve", family_serve_phase, "phi3_serve", "phi3_medium_14b", REQUESTS,
               MAX_NEW, args.iters)
    mini = run("minitron_serve", family_serve_phase, "minitron_serve", "minitron_4b",
               REQUESTS, MAX_NEW, args.iters)
    mix = run("mixtral_serve", mixtral_serve_phase, REQUESTS, MAX_NEW, args.iters)
    vlm = run("vlm_serve", vlm_serve_phase, REQUESTS, MAX_NEW, args.iters)
    vlm_gen = vlm and {"launches": vlm["generate_launches"]}
    rwkv = run("rwkv_serve", rwkv_serve_phase, args.iters)
    hyb = run("hybrid_serve", hybrid_serve_phase, args.iters)
    enc = run("encdec_serve", encdec_serve_phase, args.iters)
    slut = run("serve_lut", serve_lut_phase)
    tkern = run("tl1_kernel", tl1_kernel_phase, args.iters, 4 * 32)
    tsrv = run("tl1_serve", tl1_serve_phase, TL1_LAYERS, REQUESTS, MAX_NEW)
    torch.cuda.empty_cache()
    mkern = run("moe_kernel", moe_kernel_phase, args.iters, SLOTS * BUCKET)
    msrv = run("moe_serve", moe_serve_phase, REQUESTS, MAX_NEW)
    torch.cuda.empty_cache()
    bkern = run("bmm_kernel", bmm_kernel_phase, args.iters, SLOTS * BUCKET)
    bsrv = run("bmm_serve", bmm_serve_phase, BMM_LAYERS, REQUESTS, MAX_NEW)
    torch.cuda.empty_cache()
    paper = run("paper", paper_phase, args.iters)
    torch.cuda.empty_cache()
    run("onehot", onehot_phase, args.iters)
    torch.cuda.empty_cache()
    train = run("train", train_phase)
    torch.cuda.empty_cache()
    run("audit", audit_phase)
    torch.cuda.empty_cache()
    run("dist", dist_phase)
    rows = []
    for k, s, path, names in ((kern, srv, "serve", ("lut_affine", "lut_affine_grouped")),
                              (tkern, tsrv, "tl1_serve", ("lut_tl1", "lut_tl1_grouped")),
                              (mkern, msrv, "moe_serve", ("lut_affine_experts",)),
                              (bkern, bsrv, "bmm_serve", ("binary_matmul",))):
        if k is None or s is None:
            continue
        for name in names:
            m = k["main"][name]
            # lut_affine and lut_tl1 also run the paper networks, the weight
            # cell's kernels the paged engine, the MLA, phi3, minitron, mixtral,
            # VLM (the VLM cell's engine and its generate() with the image
            # prefix), RWKV, hybrid and enc-dec cells and the serve_lut
            # example, the experts kernel the mixtral cell
            by_path = {path: s["launches"][name]}
            for other, o in (("paged_serve", psrv), ("mla_serve", mla), ("phi3_serve", phi3),
                             ("minitron_serve", mini), ("mixtral_serve", mix),
                             ("vlm_serve", vlm), ("vlm_generate", vlm_gen),
                             ("rwkv_serve", rwkv), ("hybrid_generate", hyb),
                             ("encdec_generate", enc), ("serve_lut", slut),
                             ("paper", paper), ("train_serve", train)):
                if o is not None and o["launches"][name]:
                    by_path[other] = o["launches"][name]
            rows.append({
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": sum(by_path.values()),
                **({"launches_by_path": by_path} if len(by_path) > 1 else {}),
                "max_abs_err": k["worst"][name], "ms": m["kernel_ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": "/".join(sorted(m["bound_by"])),
                "library_ms": m.get("library_ms"),
                **({"library_reason": LIBRARY_REASONS[name]}
                   if m.get("library_ms") is None else {}),
                **({"prefill_ms": m["prefill_ms"], "prefill_bound_ms": m["prefill_bound_ms"]}
                   if "prefill_ms" in m else {}),
            })
    # the packing kernel runs on every weight-table and binary path; its times
    # are one binary-cell decode layer's 7 packs (layer_ms and layer_bound_ms:
    # each cell's layer)
    paths = {name: s for name, s in (("serve", srv), ("paged_serve", psrv), ("mla_serve", mla),
                                     ("phi3_serve", phi3), ("minitron_serve", mini),
                                     ("mixtral_serve", mix), ("vlm_serve", vlm),
                                     ("vlm_generate", vlm_gen), ("rwkv_serve", rwkv),
                                     ("hybrid_generate", hyb), ("encdec_generate", enc),
                                     ("serve_lut", slut), ("moe_serve", msrv),
                                     ("bmm_serve", bsrv), ("paper", paper),
                                     ("train_serve", train))
             if s is not None}
    if pkern is not None and paths:
        m = pkern["layers"]["binary"]
        by_path = {name: s["launches"]["bitplane_pack"] for name, s in paths.items()}
        rows.append({
            "name": "bitplane_pack", "route": "cuda", "source": SOURCES["bitplane_pack"],
            "replaces": REPLACES["bitplane_pack"], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": pkern["worst"]["bitplane_pack"],
            "ms": m["kernel_ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": "/".join(sorted(m["bound_by"])), "library_ms": None,
            "library_reason": LIBRARY_REASONS["bitplane_pack"],
            "prefill_ms": m["prefill_ms"], "prefill_bound_ms": m["prefill_bound_ms"],
            "layer_ms": {cell: c["kernel_ms"] for cell, c in pkern["layers"].items()},
            "layer_bound_ms": {cell: c["bound_ms"] for cell, c in pkern["layers"].items()},
        })
    if rows:
        emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
