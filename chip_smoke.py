#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bee2bee_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py
(``python3 chip_smoke.py --ring-repro N`` runs only the build and the ring
check's reproduction, ``ring_repro``; ``--node-profile N`` only the build
and phase 9's second node N times, ``node_profile_rounds``; ``--only
quant`` only the build, the int8-weight GEMM phases and the int8-weight
slices; ``--only adapters`` only the build and the adapter phase over
bf16 and int8 weights; ``--only migrate`` only the build and the migration
phase over a random init; ``--only checkpoint`` only the build and the
checkpoint phase; ``--only qwen`` only the build, the GEMM's f32 form,
the G = 7 ragged cases, the qwen forwards, the served qwen slices, the f32
int8-weight phase and the qwen checkpoints; ``--only gemma`` only the
build, the G = 8 and G = 1 ragged cases and their timings, the gemma
forwards, the served gemma slices and the gemma checkpoints; ``--only
gpt2`` the same for starcoder-15b's G = 48 and gpt2's head_dim 64, with
distilgpt2, gpt2 drafted by distilgpt2 and starcoder-15b served; ``--only
phi3`` the same for phi-3-mini's head_dim 96, with the GEMM at its shapes,
phi-3-mini served and its checkpoint; ``--only moe`` the build and the
MoE stages below. Those print no result line.) The line before the card's gives every stage's
seconds (``stage seconds:``).

Phases (each prints its numbers on lines of their own; any failure raises
and the script exits non-zero):

1. Device and build: the card's name and power limit, then the CUDA
   kernels built from csrc/ with nvcc (one process per source, all at
   once); ptxas's registers and spills of every instantiation, and a
   failure if a head_dim-96 or head_dim-256 instantiation the dispatch
   names (tile, f32 tile, both decode kernels and their merges, flash tile
   and f32 tile kernels) spills.
2. Ragged paged attention vs plain version at llama-3-8b's attention
   shapes (H=32, Hkv=8, hd=128, block size 16) in bf16, through the
   dispatching wrapper: decode (the split-K decode kernel) at ragged
   offsets across block boundaries with a dead row, null table tails,
   B=1 at a 2048-token context (MB 128), B=8 at the slice's mixed lengths
   41-1565 (MB 128), window 64 + softcap 50 + score scale 1/sqrt(256)
   with offsets where the window cuts pages, block sizes 8 and 32,
   head_dim 64, and a row at offset -1 beside a dead row; then verify
   chunks (one with a dead row) and prefill chunks, T in {5, 16, 17, 300,
   512 @0, 512 @1000, 2048 @0}, window + softcap + scale at T=5 and T=64,
   block sizes 8 and 32 (the tile kernel); then f32 (the f32 split-K
   decode kernel below T_MIN_F32, over an int8 pool T_MIN_F32_INT8, the
   tile kernel's 3xTF32 form from it on): decode with a dead row, at
   offset -1, at head_dim 64, B=1 at a 2048-token context, block sizes 8
   and 32, window + softcap + scale; verify T=3, T=4 and T=5, prefill T in
   {5, 17, 300, 512 @1000, 2048 @0}, window + softcap + scale at T=5 and
   T=64, block sizes 8 and 32, head_dim 64; then head_dim 256 at
   gemma-2-9b's heads (16/8, window 4096, softcap 50, scale 1/16) in bf16
   (the decode and tile kernels' head_dim-256 forms) and f32 (the f32
   decode kernel below T_MIN_F32_HD256, over an int8 pool
   T_MIN_F32_INT8_HD256, the f32 tile form from it on): decode with
   window cuts, at offset -1 beside a dead row and null tails, B=8 ctx
   1024, block sizes 8 and 32; verify
   T=5 with a dead row, chunks of 17 and 300 cut by the window, prefill
   T=512 @1000, T=100 at block sizes 8 and 32; the row kernel is forced
   as well on the decode and T=17 cases in both types (those it served
   at head_dim 256 before). Each
   case checks that exactly the kernel the dispatch rule names launched,
   once, and each decode case that a second call gives the same bytes.
   Tolerance: max abs error <= 2e-2 against the plain version run in f32
   on the same bf16 inputs (bf16 output rounding is ~4e-3 at these
   magnitudes; the decode and tile kernels also round P to bf16, as the
   JAX kernel does; the f32 decode kernel computes in IEEE f32, so 1e-6
   is what to expect there), 1e-4 in f32. Then times, each beside the
   plain version, SDPA over the gathered view in q's type (the library
   yardstick, never used by the port; the backend it ran is printed once)
   and the bound (f32 tile form: three TF32 products at the TF32 peak,
   with the CUDA-core FFMA bound beside it; f32 decode kernel: the FFMA
   products at the f32 CUDA-core peak): the decode kernel at B=8 over a
   1024-token context and at B=1 over 2048 (with its split plan), the row
   and the tile kernel forced at the same decode inputs, the f32 decode
   kernel at the same two shapes (its plan; the f32 tile form and the row
   kernel forced beside it), the tile kernel and its f32 form at a
   512-token prefill chunk at offset 1000; at gemma heads (window 4096
   and scale 1/16; no softcap, which SDPA cannot apply) the head_dim-256
   decode form at B=8 ctx 1024 and tile form at T=512 @1000, each with the
   other kernels that take the inputs forced beside it (the row kernel
   among them), and the same in f32 (the f32 decode kernel, the f32 tile
   form and the row kernel); the crossovers over T at llama-3-8b's and at
   gemma heads: bf16, the row and the tile kernel; f32, the f32 decode
   kernel and the f32 tile form (the dispatch's T_MIN_F32 and its kin);
   then the decode sweep, 32 launches back to back over a 32-layer copy of
   the pool, in ms per launch.
3. The same cases for the int8-pool form: random int8 pages, random
   per-(kv head, block) scales, and a null block of +-127 under a scale
   of 1e3 that no reader may touch. Tolerance 2e-2 in bf16 and 1e-4 in
   f32 against the plain version on the same inputs. Times as in phase
   2, SDPA over the host-dequantized gathered view, the bound in int8
   bytes plus the scales.
4. Flash attention vs plain version (contiguous K/V, llama-3-8b heads):
   causal T=S=2048, decode B=8 T=1 S=2048 with ragged offsets and one
   empty row (offset -1), T=512 at offset 1000 over S=2048, non-causal
   T=S=256 in bf16 (the tile kernel); T=64 S=256 at per-row offsets,
   causal T=S=2048, the decode case, non-causal T=S=256 and head_dim 64
   in f32 (the f32 tile kernel); head_dim 256 at gemma heads in bf16 (the
   tile kernel's head_dim-256 form: T=64 S=256 at per-row offsets, causal
   T=S=2048, the decode case, T=100 S=300 @200, non-causal T=S=256) and
   f32 (the f32 tile kernel: T=64 S=256, causal T=S=2048, the decode
   case, non-causal T=S=256); the row kernel, which the rule no longer
   names, forced on the two T=64 S=256 cases at gemma heads. Tolerance
   2e-2 / 1e-4. Times of causal
   T=S=2048 through the tile kernel (bf16), the f32 tile kernel and the
   row kernel forced (f32), and at gemma heads the head_dim-256 tile form
   (bf16) and the f32 tile kernel, each with the row kernel forced beside
   it; each beside the plain version, SDPA(is_causal=True) and the bound.
   No serving path calls this op.
5. A whole forward at llama-3-8b width, 2 layers: a 300-token prefill and
   8 greedy decode steps through the kernels and through the plain
   version (asked for explicitly, here only), in f32 over an f32 pool and
   over an int8 pool (each forward through the kernels the rule names:
   the f32 tile form for the prefill, the f32 decode kernel for the decode
   steps; logits within 2e-3, greedy tokens equal;
   the int8-vs-f32 pool logit gap printed for information; each forward's
   device busy time under torch.profiler), then in bf16 over a bf16 pool
   and an int8 pool, whose 300-token prefill goes through the tile kernel
   and whose 8 decode steps go through the decode kernel: logits within
   the gap between the plain bf16 and the plain f32 forward (the kernels
   may not add more error than bf16 itself carries). Then the same bf16
   forward, over a bf16 and an int8 pool, at gemma-2-9b's attention
   geometry on the llama architecture (d 3584, 16/8 heads at head_dim
   256, window 4096 every 2 layers, softcap 50): it must launch only the
   head_dim-256 tile form (the prefill) and decode form (the steps), meet
   the same bf16 criterion and give the plain forward's greedy tokens.
   Then the qwen families at full width, 2 layers, random f32 from the
   seed with the q/k/v biases drawn N(0, 0.25) and the q/k norm scales 1 +
   N(0, 0.01) (the JAX init's zeros and ones would prove nothing): qwen3-8b
   with yarn (factor 4 over 32,768 positions, its model card's) and
   qwen2-7b (28 query heads over 4 kv heads, G = 7), each from its
   published config.json cut to 2 layers: the same f32 checks over an f32
   and an int8 pool (logits within 2e-3, greedy tokens equal, n_layers
   launches a forward of the kernel the rule names for the chunk, the pool
   and G) and bf16 checks over a bf16 and an int8 pool. Phases 2-3 hold
   the kernels at qwen2-7b's heads too (G = 7: decode, T = 4, a verify
   chunk of T = 5, prefill chunks of 300 and 512 tokens, bf16 and f32),
   and at gemma-2b's (8 query heads over one kv head, G = 8) and gemma-7b's
   (16 over 16, G = 1) at head_dim 256: decode with a dead row and null
   tails and cut by gemma-3's 1024-key window, chunks of 4, 16 and 17, the
   verify chunk of T = 5 (plain and with window, softcap and scale),
   prefill chunks of 300 (window-cut) and 512, bf16 and f32, each through
   the kernel the rule names for its G (at G = 8 decode_f32 holds T <= 4,
   the f32 tile form the verify chunk); timed: the verify shape at G = 8
   (bf16 and f32) and decode and the verify shape at G = 1.
   Then the gemma family at full width from its presets (gemma-2b, G = 8;
   gemma-7b, G = 1; gemma-2-9b: post-norms, both softcaps, a 4096-key
   window on every second layer; gemma-3-4b: q/k norms, 1024-key windows
   on 5 layers of 6 and the dual rope), 2 layers each but 6 for gemma-3-4b
   (2 would run no global layer), random f32 from the seed with every norm
   scale 1 + N(0, 0.01): a 1,100-token prefill (past gemma-3's window) and
   8 greedy decode steps, f32 over an f32 and an int8 pool (logits within
   2e-3, greedy tokens equal, n_layers launches a forward of the kernel the
   rule names for the chunk, the pool and G; over the int8 pool past 2
   layers, where int8 rounding flips grow with depth, every attention call
   of the plain forward is held to the kernel on the same inputs within
   1e-4 and the logits at the first 2 layers within 2e-3), bf16 over a bf16 and an int8
   pool (only the head_dim-256 tile and decode forms; the bf16 head rounds
   each logit, so the kernels' logits are held to the plain bf16 forward's
   in the relative Frobenius norm within that forward's relative gap to
   the plain f32 forward, and element by element within its largest gap
   plus one bf16 ulp of the largest logit; greedy tokens equal). Phases
   2-3 hold the kernels at starcoder-15b's heads (48 query heads over one
   kv head, G = 48: every f32 chunk through the f32 tile form) and gpt2's
   (head_dim 64) too, timed at decode, the verify shape and prefill; then
   the gpt2 block at gpt2's and starcoder-15b's widths, 2 layers, biases
   N(0, 0.25), layernorm scales 1 + N(0, 0.01) and biases N(0, 0.1): a
   600-token prefill (inside gpt2's 1,024 learned positions) and 8 steps,
   f32 over an f32 and an int8 pool (within 2e-3, tokens equal, launches
   exact), bf16 over a bf16 and an int8 pool (the relative rule above,
   tokens equal). After the gemma slices distilgpt2 (bf16; int8 weights
   over an int8 pool), gpt2 in f32 drafted by distilgpt2 and starcoder-15b
   (40 layers) are served with phase 6's checks, and the checkpoint phase
   writes and loads gpt2 (Conv1D) and gpt_bigcode (multi_query)
   checkpoints. Phases 2-4 hold every kernel at phi-3-mini's heads too (32
   query heads over 32 kv heads at head_dim 96, G = 1, its 2,047-key
   window): decode at a 1024-token context, with a dead row and null
   tails, and cut by the window at a 3,000-token context; block sizes 8 and
   32; the verify chunk of T = 5 (plain, window-cut, and with window,
   softcap and scale); chunks of 16, 17 and 32; prefill T = 512 at 1000 and
   window-cut at 2488; bf16 and f32 over both pools; flash at head_dim 96
   (T=64 S=256 at per-row offsets, causal T=S=2048, the decode case,
   non-causal T=S=256) in bf16 and f32; timed: decode, the verify shape,
   the 512-token chunk, decode and the chunk past the window, and in f32
   the decode step, the verify shape and the chunk, with the f32
   crossover over T at those heads. Then phi-3-mini's forward at full
   width, 2 layers, norm scales perturbed: a 2,300-token prefill past the
   window and 8 steps, checked as the gpt2 block's. The int8-weight GEMM,
   bf16 and f32 forms, at phi-3-mini's projections (wq|wk|wv and
   w_up|w_gate grouped, wo, w_down; K = 3072) at every M of the GEMM
   phase, after its f32 form. After the gpt2 slices phi-3-mini at full
   depth (32 layers) and its 4,096 positions is served in bf16 and with
   int8 weights over an int8 pool on prompts of 41 to 3,000 tokens (three
   past the window) with phase 6's checks, and the checkpoint phase writes
   and loads a phi3 checkpoint (fused qkv_proj and gate_up_proj).
   Mixture of experts (``phase_moe_*``): after the GEMM phases the grouped
   expert GEMM (csrc/moe_expert_gemm.cu) against its plain version at
   qwen3-30b-a3b's (D 2048, 128 experts of 768, 8 a token) and
   mixtral-8x7b's (D 4096, 8 experts of 14,336, 2 a token) shapes, 8, 40
   and 2,048 tokens, every form (bf16 and int8 experts under bf16 x, f32
   and int8 experts under f32 x; 2^-6 / 1e-4 of the largest |output|, one
   launch a call, two calls bit-equal), each layer's two launches timed
   beside the bound, the plain version and torch._grouped_mm (bf16), plus
   tied logits (JAX's top-k) and a routed capacity that drops (JAX's keep
   mask); the MoE forwards at full width, 2 layers, a 1,100-token prefill
   and 8 steps, checked as the gpt2 block's (the plain forward's experts
   through the plain version; mixtral also in f32 over int8 experts); after
   the phi-3 slices qwen3-30b-a3b (48 layers, bf16) served with phase 6's
   checks, the expert GEMM twice a layer of every replayed forward, and
   one n-gram verify step replayed = eager; mixtral-8x7b (32 layers) with
   int8 weights from the quantize-as-drawn init (its peak device memory
   within 1.05 x the int8 model + its largest dense tensor) served the
   same way; the checkpoint phase writes and loads both families at 2
   layers.
6. The slice: CUDAService("llama-3-8b"), 32 layers, bf16, random init
   from a seed, answers 8 concurrent execute calls and one
   execute_stream. Every decode step is a replay of a captured CUDA
   graph of the scheduler's decode step, which adds back the launch and
   forward counts of its capture: the decode kernel's launches plus the
   tile kernel's must equal n_layers x the engine's forward calls, the
   forwards the prefill chunks plus the replayed decode steps (> 0), the
   decode kernel's n_layers x the replayed steps, the tile kernel's
   n_layers x the prefill-chunk forwards (both > 0), and the row
   kernel's 0; the only eager decode forwards are those of the graphs'
   warm-up and capture. Prints the captures (by key, with their
   seconds), the replays and the readback ring's windows, host syncs and
   stalls. Then the ring: 2 greedy requests of 320 tokens with overlap on
   and off (equal tokens, fewer stalls than syncs with it on, a stall at
   every sync with it off). Then one decode chunk (32 steps, B=8 at ctx
   about 1024, over random pages) run eagerly and by replay from the same
   state: greedy tokens, cur, offsets and the pool's bytes outside the
   null block equal bit for bit; two replays of a graph with a row at
   temperature 1 from one state: greedy rows equal, the sampled row's
   draws different. Every prefill chunk and first token the slice serves
   is a replay of the prefill and first-token roots' graphs too: the
   tile launches equal n_layers x the prefill replays, the only eager
   prefill forwards are the captures' warm-up and capture, one
   first-token replay per request. Then a prefill chunk run eagerly and
   by replay from the same random pool: a miss (1,000 tokens at bucket
   1024) and a hit (104 new tokens at bucket 128 from offset 1000, after
   a CoW copy, floored there): last logits and the pool's bytes (and
   scales) outside the null block equal bit for bit, n_layers tile
   launches a replay (in every slice, phases 6-8). Then a breakdown of a
   decode step (the bare forward,
   the scheduler's step eager and graph-replayed) and a prefill chunk:
   host wall, device busy, idle share and the attention kernels' ms per
   launch inside the step (the decode kernel's two CUDA kernels summed).
7. The int8 slice: the same parameters served by an engine with
   cache_dtype="int8" inside CUDAService, the same requests and the same
   launch, graph and replay checks on the int8 counters (the bf16 pool's
   stay 0; the replay check compares the scales too); pool bytes beside
   the bf16 pool's.
8. The f32 slice: the same weights cast to f32 (the bf16 copy freed),
   served by CUDAService("llama-3-8b") with EngineConfig(dtype="float32")
   over an int8 pool and then an f32 pool, the same 8 execute calls and
   one execute_stream (no ring check). On each pool every decode step is
   a graph replay; the kernels the rule names for f32 queries (the f32
   decode kernel for the decode steps, the f32 tile form for the prefill
   chunks) launch n_layers x the forward calls between them, the decode
   kernel n_layers x the replayed steps; the row kernel's counters stay
   0. Over the int8 pool one decode chunk replayed and run eagerly from
   one state gives bit-equal tokens, cur, offsets, pages and scales.
   Prints, beside the card's name and power limit, TTFT, decode tok/s,
   peak memory and pool bytes, and the replayed B=8 ctx-1024 step's host
   wall, device busy, idle share and attention ms per launch.
   Economics, in each slice of phases 6-8, over its traffic: the HBM
   ledger's ``weights`` and ``kv_pool`` equal the tensors' storage bytes
   (the pool also its geometry's), 0 < headroom < 1 (the device's used
   memory from ``mem_get_info``), ``engine.compiles{root="decode"}``
   equals the scheduler's graph captures with no retrace storm, MFU x
   peak over the meter's window equals the FLOPs model over the
   dispatches recorded in it within 10%, the goodput fraction is in
   (0, 1].
   The prefix cache, between phases 7 and 8 over the same bf16 weights
   (bf16 and int8 pools, ``prefix_cache_entries`` 16 and the slices'
   config: 3,089 blocks, 2,048 of them pin room) and in phase 8 over the
   f32 weights (f32 pool): 8 conversations of 985-1019 byte tokens. Turn
   1 sends them at once (8 misses); turn 2 resends each with its 64-token
   reply and 40 new tokens (8 hits), then one exact repeat (a hit at
   n - 1). Checks: the hits, tokens saved and CoW copies the traffic
   implies; each hit's first chunk at offset = its match, floored there,
   at the bucket of the remaining length, n_layers launches of the tile
   kernel the rule names; the slices' launch identities; the shared
   donor blocks' bytes (and scales) bit-equal before and after the
   borrowers' prefill and decode; each CoW target's pages and scales
   equal to its donor's at the copy. The same turn 2 on a cache-off
   engine: bf16 and int8 pools, a hit's first-token logits no further from
   the f32 forward's (cache off) than twice the cache-off run's of the
   same pool, prompt by prompt; f32, the hits' greedy tokens equal the
   cache-off engine's. Then one admission into a pool of one row and 40
   blocks that must evict a pinned entry under pressure (each pool).
   Prints hit, miss and cache-off TTFT (median and range of each burst)
   with the card's name and power limit; each burst runs with every
   prefill and first-token graph it replays captured before it (the
   captures printed apart).
   Speculative decoding, model tier (after the bf16 prefix phase): the
   bf16 weights serve 8 prompts without n-gram repeats (64 greedy tokens
   each, concurrently, K=4) with llama-3-8b itself as the drafter at the
   engine's seed (weight-identical; a second 16 GB beside the target):
   the n-gram tier fails its probe at its first miss and rows escalate;
   acceptance, agreement with the spec-off engine and the spec-off logit
   gap at each row's first divergence (bf16 near-ties) are printed; the
   draft and prime roots are captured once each; the tile kernel
   launches n_layers x (verify + prefill replays). Then one verify step
   (B=8 ctx 1024, K=4, drafts whose first token is the row's greedy next
   token) run eagerly and by replay over a bf16 and an int8 pool: tokens,
   accepted counts, offsets and pool bytes equal bit for bit.
   Speculative decoding, n-gram tier (after the f32 prefix phase): f32
   weights over an f32 pool, 8 periodic prompts, 64 greedy tokens each,
   K=4: the tokens equal the spec-off engine's, 8 x 64; every verify
   replay launches the f32 decode kernel (T = 5) n_layers times.
9. The node (serve-cuda's path): the port's run_p2p_node boots a mesh
   node with its aiohttp gateway on free loopback ports and
   CUDAService("llama-3-8b") from the port's NodeConfig defaults (bf16
   pool, random init from seed 0), loaded in an executor while the
   gateway already answers. One greedy prompt of about 300 bytes (32 new
   tokens) goes to the service once cold, then through the gateway's
   /chat, svc.execute, the gateway's streamed /v1/chat/completions, the
   service's execute_stream and, from a second node that joins through
   the first one's join link, a mesh gen_request (stdlib urllib, no HTTP
   client package): the six texts must be equal, /providers must list
   llama-3-8b with backend "cuda", /metrics must carry the engine.*
   names, decode + tile launches must equal n_layers x forward calls
   (both > 0, every other counter 0), the decode launches n_layers x the
   replayed decode steps (> 0), and the node must stop in time and
   take its engine thread down. Prints the packages the node may lack,
   the boot and the service's load seconds, the event loop's longest
   stall during the load, and TTFT and tok/s through the gateway against
   the direct call (medians of 3 alternating pairs), with the card's name
   and power limit. Then a second node, booted with
   ``BEE2BEE_PREFIX_CACHE=8`` (read by ``load_config`` as ``serve-cuda``
   reads it): the prompt once (a miss) and again (an exact-repeat hit,
   counted, the reference text: a hit recomputes the last prompt position
   at another chunk width, so at a bf16 near-tie its greedy text can
   leave the miss's, which is why the route checks above run without the
   cache); a ``POST /debug/profile`` of 1 s while streams of the prompt
   run back to back (their texts equal the hit's), listed and fetched by
   ``GET``, its chrome trace naming the decode kernel, the longest gap
   of the streams' events under the node's queue-wait SLO (4,096 ms),
   and, sent once the trace's export starts, a stream needing a prefill
   key not yet captured, whose first token comes before the export ends
   and whose longest gap is under the SLO; the profiler's windows,
   export and the gaps on one clock, its start, stop and export seconds
   and the trace's kernel events printed; ``/metrics``
   samples of ``engine.mfu``, ``engine.goodput_tokens_per_s``,
   ``engine.hbm_bytes``, ``engine.hbm_headroom_frac`` and
   ``engine.compiles``; and a second turn (the first's transcript, its
   reply and a new user line) that counts one hit over the whole
   first-turn prompt.
The int8-weight GEMM (after phase 4): csrc/int8_weight_gemm.cu against
   its plain version (the JAX core.matmul formula). The decode kernel
   (kernel A) at llama-3-8b's four projection shapes (4096 x 4096, 4096 x
   1024, 4096 x 14336, 14336 x 4096) and every M from 1 to 64 (tiles of 8
   to 64 rows, wgmma widths summed where not a power of two): within 2^-6
   of the largest |output| (two bf16 ulps: the plain version rounds three
   times, the kernel once), one launch a call, the same bytes twice; the
   grouped launches (wq|wk|wv, w_up|w_gate) one launch each within the
   same tolerance, timed beside their launches apart, their bound and
   cuBLAS bf16 over the concatenated dequantized weights. Times at M = 8
   (w_up also at 1, 40 and 64), beside the bound, the plain version, cuBLAS
   bf16 at the dequantized weight and torch._weight_int8pack_mm. Then both
   bf16 kernels at every launch of every family served with int8 weights
   (llama-3-8b and mixtral-8x7b's attention, qwen2-7b, gemma-3-4b,
   phi-3-mini, distilgpt2; the grouped weights in one launch): the decode
   kernel at M in {1, 7, 8, 24, 40, 57, 64} (llama's at every M above), the
   prefill kernel (kernel B, tiles of 128 and 256 rows) at M in {65, 128,
   600 (a partial last tile), 1024, 2048}, each within 2^-6, one launch a
   call of its own counter (``launches`` or ``prefill_launches``; the
   dequantize counter reads 0), the same bytes twice; llama's launches
   timed at M = 2048 (w_up|w_gate at every prefill M) beside the bound
   (operations), the plain version, cuBLAS bf16 and
   torch._weight_int8pack_mm. Phase 1 fails if an instantiation of the
   GEMM kernel spills. Then the decode kernel's f32 form (2xTF32 on
   mma.sync, f32 x and y) at llama-3-8b's four shapes and qwen2-7b's and
   qwen3-8b's (3584 x 3584, 3584 x 512, 3584 x 18944, 18944 x 3584, 4096 x
   12288, 12288 x 4096), M as above: within 1e-4 of the largest |output|
   of the plain f32 version (cuBLAS's full-f32 product), one launch a call
   (``f32_launches``), the same bytes twice; the grouped launches at each
   model's shapes one launch each; the f32 M > 64 route (the dequantize
   route, what is left of it: an f32 scratch, its bytes equal to the HBM
   ledger's ``int8_dequant_scratch``) equal to the plain version; times at
   M = 8 (w_up at 1, 40 and 64 too) beside the bound (two TF32 products),
   the plain version, cuBLAS f32 over the dense f32 weight and
   torch._weight_int8pack_mm with f32 activations.
The gemma slices (after the qwen slices): gemma-2-9b at full width and
   depth (42 layers, 9.24 B parameters, bf16, norm scales perturbed) over
   a bf16 pool (its 4096-token window cannot bind at max_seq_len 2048), and
   gemma-3-4b at full width and depth (34 layers) with its weights
   quantized to int8 on the card, over an int8 pool (its 1024-token window
   binds on the longest prompts), each with phase 6's traffic and launch,
   graph and replay checks (the head_dim-256 forms n_layers x the forwards,
   the GEMM 4 x n_layers a replay), a decode chunk and a prefill chunk
   replayed = eager bit for bit and the replayed B=8 step's breakdown.
The qwen slices (after the int8-weight adapter phase): qwen3-8b at full
   width and depth (36 layers, 8.19 B parameters, bf16, biases and norms
   perturbed as above) over a bf16 pool, and qwen2-7b at full width and
   depth (28 layers) with int8 weights over an int8 pool (G = 7
   through the decode and tile kernels and the GEMM), each with phase 6's
   traffic and launch, graph and replay checks, a decode chunk and a
   prefill chunk replayed = eager bit for bit and the replayed B=8 step's
   breakdown.
int8 weights beside f32 activations (after the qwen slices): llama-3-8b
   at full depth, random in f32 and quantized on the card, over an int8
   pool, the same traffic and checks (the GEMM's f32 form 4 x n_layers a
   replayed decode step or narrow prefill chunk); n-gram spec decoding over
   the same weights and an f32 pool (tokens equal the spec-off engine's,
   the f32 form in every decode and verify replay, a verify step replayed =
   eager bit for bit); logits no further from the f32 forward over q * s
   than twice the bf16 int8-weight forward's distance, and at 2 layers
   the plain f32 forward's greedy tokens.
Adapters over the bf16 weights (after phase 7): an engine with 4 adapter
   slots loads four random adapters (rank 16, all seven targets) from the
   main thread; a mixed batch of 8 rows (2 base, 2 per adapter) against
   an all-base batch of the same width, each admitted in one burst: base
   rows' tokens equal, each adapter's rows differ; each adapter row's
   served first-token logits no further from its merge_lora-merged f32
   forward than twice the merged bf16 forward's distance; a hot swap (a
   fifth adapter evicting the cold one, a refresh of an idle one) while
   streamed rows on two adapters decode: their tokens equal a run
   without it, the stacks keep their storage, decode chunks ran after
   each write; the adapter-flagged decode, prefill and first-token keys
   captured once each; the replayed B=8 decode step with rows on slots
   [0, 0, 1, 1, 2, 2, 3, 3] against the all-base step (device busy, top
   kernels); with the prefix cache on, an adapter prompt sent twice hits
   0 times (a base prompt twice: once).
The int8-weight slice (after the n-gram spec phase, its weights freed):
   CUDAService("llama-3-8b") with quantize="int8", random from the seed
   and quantized on the card as it loads, phase 6's traffic and checks
   over a bf16 and an int8 pool (no ring check), plus: the int8-weight
   GEMM launched 4 x n_layers times (wq|wk|wv and w_up|w_gate grouped) a
   replayed decode step or prefill chunk of at most 64 tokens, the
   dequantize route 4 x n_layers times a wider prefill chunk, both > 0; a decode chunk and a prefill chunk
   replayed = eager bit for bit; the breakdown at B=8 and B=1 (the GEMM
   kernels' share of busy); the logits of a 300-token prefill and 4
   greedy steps no further from the f32 forward over the dequantized
   weights q * s than twice the bf16 forward's distance; the ledger's
   weights at most 0.58x the same weights in bf16. Then the adapter phase
   over these int8 weights.
Live migration (after the n-gram spec phase, over its f32 weights, then
   the same cast back to bf16): two in-process nodes, A and B, on free
   loopback ports (websockets, no permessage-deflate), each serving
   llama-3-8b through CUDAService on an engine over the one shared
   parameter dict (phase 6's config). First the host's costs of one 8 MiB
   frame (encode, sha256, and deflate at the websockets library's
   settings). Then: (1) f32 over f32 pools: phase 6's 8 prompts as
   concurrent greedy streams of 128 tokens on A, served once unmigrated
   (the twin) and once drained onto B (``begin_drain``) when every stream
   holds 32 tokens: the summary 8 migrated, 0 failed; B 8 imports, 0
   re-prefills; every stream's tokens and text equal the twin's; each
   import's blocks on B, read on B's scheduler thread right after the
   scatter, bit-equal to what arrived and to what A exported; the
   window's launches n_layers x each engine's replays (decode_f32 and
   the f32 tile form), B 0 prefill replays, each of B's decode graphs
   adding n_layers decode_f32 launches a replay, every other counter 0;
   A holds 0 blocks after, its thread alive. (4) the same engines as a
   prefill-role A and a decode-role B: every row handed off after its
   first token (8 handoffs, A 0 decode replays), tokens equal a B-only
   run's, TTFT at A printed. (5) A with a pool of 341 blocks: the rows it
   cannot grow migrate to B, no typed error, every stream 128 tokens.
   (2) bf16 over bf16 pools, then over int8 pools: the drain as in (1),
   pages and scales bit-equal, 0 re-prefills, every stream 128 tokens,
   each row's agreement with its twin printed; one row of about 990
   prompt tokens drained alone onto an idle B equals its twin token for
   token, then the same row through the re-prefill rung
   (``force_reprefill``): both rungs' walls at ctx about 1024. (3) an
   int8-pool A drained onto a bf16-pool B: refused typed at the KV rung
   (signatures differ), 8 re-prefills, B's tile launches n_layers x its
   prefill replays. Each drain prints per row the gather, the bytes, the
   rung's wall and the import, and per run the encode + sha256, send and
   verify + join seconds, the pause and the wall, with the card's name
   and power limit; the int8 / bf16 bytes ratio.
The checkpoint phase (after phase 9): llama-3.1-8b at the widths of
   meta-llama/Llama-3.1-8B's config.json (d 4096, d_ff 14336, 32/8 heads,
   vocab 128256, rope theta 5e5 with the llama3 scaling, untied head) cut
   to 2 layers, random bf16 from the seed (2.97 GB), written by the port's
   ``export_hf`` as three safetensors files with that config.json and no
   tokenizer files, in a directory under build/ the phase removes. (a)
   ``InferenceEngine("auto", checkpoint_path=...)``: every weight bit-equal
   to the same arrays carried in by ``params_from_numpy``; phase 6's 8
   prompts as one burst of greedy requests x 64 tokens: tokens equal and
   first-token logits bit-equal to that engine's, decode + tile launches
   n_layers x forwards; the load's read, host-to-device and on-card (cast
   + transpose) seconds and the device peak. (b) the llama3 frequencies on
   the card within 1e-6 relative of the float64 formula; a 128-token f32
   prefill (the f32 tile form) and 4 decode steps (``decode_f32``) of the
   loaded weights within 2e-3 of the plain CPU forward. (c) ``save_native``
   -> ``load_native`` bit-equal, every piece <= 4 MiB. (d) two nodes in this
   process through ``run_p2p_node`` over one in-memory DHT: P serves the
   checkpoint with ``publish_weights``, J boots with ``from_mesh`` and no
   checkpoint (and republishes): the pieces (count, largest <= 4 MiB,
   bytes), publish seconds, fetch seconds and MB/s, verify + assemble
   seconds; J's weights bit-equal to P's and its manifest equal; one greedy
   prompt through each gateway's ``/chat``, equal texts; J's
   ``/providers`` lists the model on backend cuda. (e) the same directory
   with ``quantize="int8"``: the device's peak during the load within 1.05
   x (the packed model + its largest dense tensor), the packed weights
   bit-equal to the in-memory int8 engine's (a)'s weights quantized on the
   card, equal greedy tokens, the int8-weight GEMM's launches 4 x n_layers
   x (replayed decode steps + prefill replays of <= 64 tokens). (f) HF-named
   qwen2-7b and qwen3-8b checkpoints (full width, 2 layers, random bf16,
   biases and norms perturbed, their published config.json cut to 2
   layers), and the same for gemma-2-9b (model_type gemma2: its four
   block norms under gemma-2's names, stored less one) and gemma-3-4b
   (gemma3_text, with its q/k norms), config.json from the presets' values:
   loaded by ``InferenceEngine("auto", ...)`` bit-equal to
   ``params_from_numpy``'s tree, phase 6's prompts decoded to the same
   greedy tokens and bit-equal first-token logits, each decode step and
   prefill chunk through the kernel the rule names.
10. The kernel table as one JSON line (the head_dim-256 forms' launches
   from phase 5's gemma-geometry and gemma forwards, the gemma slices and
   the gemma checkpoints, their f32 forms' from the gemma forwards, and
   rows of their own at G = 8 and G = 1 with gemma-2b's and gemma-7b's
   forward launches; the bf16 decode and tile
   kernels' from phases 6, 7, 9, the prefix phase over the same pool, the
   model-tier spec phase, the migration phase's bf16 drains and the
   checkpoint phase; the f32 decode kernel's and the f32 tile forms' from
   phase 8, its prefix phase, the n-gram spec phase, the migration phase's
   f32 runs, phase 5's f32 forwards and the checkpoint phase's f32 check;
   the int8-weight GEMM's from the int8-weight slices, their adapter phase
   and the checkpoint phase's int8 load; phase 2 times the tile kernel and the f32 decode
   kernel at the verify shape, B=8 T=5 ctx 1024; the qwen phases' and the
   f32 int8-weight phase's launches added to the rows of the forms they
   counted; the GEMM's f32 form a row of its own; the expert GEMM a row a
   form, its launches from the MoE forwards, slices, verify step and
   checkpoints, timed at a B = 8 decode step), then the result line.

Exits non-zero, printing no result, when no CUDA card is present or
when the package is not beside this script. Each phase's start goes to
stderr with the seconds since launch; a run still going after 1080 s
dumps every thread's stack to stderr and exits 1. The nodes keep their
state under build/bee2bee_home unless BEE2BEE_TPU_HOME names another
directory.
"""

from __future__ import annotations

import contextlib
import faulthandler
import functools
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
TF32_FLOPS_PER_S = 494.7e12  # H100 SXM dense TF32 tensor-core peak
# f32-accurate products on the tensor cores take three TF32 products
# (3xTF32): the f32 bound counts the flops three times at the TF32 peak
TF32_PRODUCTS = 3
KERNEL_TOL = 2e-2
F32_TOL = 1e-4
FORWARD_TOL = 2e-3
SEED = 0
# a run still going after this many seconds dumps every thread's stack to
# stderr and exits 1 (the smoke is given 1200 s; it takes about 330)
WATCHDOG_S = 1080
SPIN_CYCLES = 200_000  # ~0.1 ms at the H100's 1.98 GHz boost clock


def log(msg: str) -> None:
    print(msg, flush=True)


_T0 = time.perf_counter()
# (stage name, its start in seconds since _T0), in order
_STAGES: list = []


def stage(name: str) -> None:
    """Marks a phase's start on stderr with the seconds since the start,
    so the end of stderr names the phase a stopped run was in."""
    t = time.perf_counter() - _T0
    _STAGES.append((name, t))
    print(f"chip_smoke: {t:.1f} s: {name}", file=sys.stderr, flush=True)


def stage_seconds() -> str:
    """Each stage's seconds (to the next stage's start, the last to now)
    and the whole run's, as one line."""
    now = time.perf_counter() - _T0
    ends = [t for _, t in _STAGES[1:]] + [now]
    parts = [f"{name} {end - t:.1f}" for (name, t), end in zip(_STAGES, ends)]
    return f"stage seconds: {'; '.join(parts)}; total {now:.1f}"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_time_ms(fn, reps: int = 30, flush: torch.Tensor | None = None,
                 spin: int = SPIN_CYCLES) -> float:
    """Median of ``reps`` single-launch CUDA-event timings, after a warm-up;
    ``flush`` (a buffer larger than L2) is rewritten before each launch so
    every launch reads its inputs from device memory, as a layer of a real
    forward does. The card spins ``spin`` cycles (~0.1 ms by default)
    before each start event, so the host has queued the launches by then:
    the time excludes the host's launch latency, which would otherwise
    count whenever the card drains its queue first."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------ phase 1


def phase_device_and_build():
    from bee2bee_tpu_torch.ops import _build

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, cuda {torch.version.cuda})")
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    libs = _build.build()
    build_s = time.perf_counter() - t0
    log(f"build: {len(libs)} kernel source(s) in {build_s:.1f} s; each nvcc (s) "
        f"{ {k: round(v, 1) for k, v in _build.build_seconds.items()} }")
    for source, path in libs.items():
        log_path = path.with_suffix(".log")
        report = log_path.read_text() if log_path.exists() else ""
        spills = [ln.strip() for ln in report.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes")]
        regs = [ln.strip() for ln in report.splitlines() if "registers" in ln]
        log(f"build: {source}: {len(regs)} kernels; ptxas spill lines "
            f"{sorted(set(spills)) or 'none'}")
        # every instantiation's registers and spills; the head_dim-96 and
        # head_dim-256 forms the dispatch names must not spill
        for name, line in ptxas_entries(report):
            hd = re.split("[,>]", name.split("<")[1])[0]
            log(f"build: {source}: {name}: {line}")
            if (hd in NO_SPILL_HEAD_DIMS and name.startswith(NO_SPILL_FORMS)) or \
                    name.startswith((GEMM_KERNEL, MOE_KERNEL)):
                check(" 0 bytes spill stores, 0 bytes spill loads" in line,
                      f"{source}: {name} spills: {line}")
    return card, build_s


# the kernels whose head_dim-96 and head_dim-256 instantiations the
# dispatch names, and those head_dims: none of them may spill
NO_SPILL_HEAD_DIMS = ("96", "256")
NO_SPILL_FORMS = ("ragged_prefill_kernel", "ragged_prefill_f32_kernel",
               "ragged_decode_kernel", "ragged_decode_merge", "ragged_decode_f32_kernel",
               "ragged_decode_f32_merge", "flash_tile_kernel", "flash_tile_f32_kernel")


def ptxas_entries(report: str):
    """(kernel, "registers; spills") for each entry function of a ptxas -v
    report, the kernel named by its mangled name's tail."""
    entries, name, spill = [], None, ""
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            base = re.search(r"\d+((?:ragged|flash|int8|moe)_\w+?)[IE]", mangled)
            args = re.findall(r"L[ib](\d+)E", mangled)
            xt = re.search(r"Lb\dE(f|13__nv_bfloat16)E", mangled)  # the GEMM's x type
            if xt:
                args.append("f32" if xt.group(1) == "f" else "bf16")
            # the expert GEMM's kernels: tile height, then x's and/or the
            # experts' types (a substitution repeats the type before it)
            mt = re.search(r"moe_expert_gemm_kernel\w*?I((?:Li\d+E)*)"
                           r"((?:f|a|13__nv_bfloat16|S\d*_)+)E", mangled)
            if mt:
                args = re.findall(r"Li(\d+)E", mt.group(1))
                for tok in re.findall(r"f|a|13__nv_bfloat16|S\d*_", mt.group(2)):
                    args.append(MOE_TYPES[tok] if tok in MOE_TYPES else args[-1])
            name = f"{base.group(1) if base else mangled[-48:]}<{','.join(args)}>"
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "registers" in ln and name:
            entries.append((name, f"{ln.split(':', 1)[-1].strip()}; {spill}"))
            name = None
    return entries


# ------------------------------------------------------------ phase 2


def make_case(gen, offs, T, H=32, Hkv=8, hd=128, BS=16, extra_tables=0,
              dead=(), dtype=torch.bfloat16):
    """A pool + per-row tables covering offs[b] + T positions (null-block
    tails of ``extra_tables`` entries; rows in ``dead`` get an all-null
    table), with q, on the card."""
    B = len(offs)
    need = [-(-(o + T) // BS) for o in offs]
    MB = max(need) + extra_tables
    tables = torch.zeros((B, MB), dtype=torch.int32)
    nxt = 1
    for b in range(B):
        if b in dead:
            continue
        for i in range(need[b]):
            tables[b, i] = nxt
            nxt += 1
    NB = nxt + 1
    dev = "cuda"
    kp = torch.randn((Hkv, NB, BS, hd), generator=gen, device=dev).to(dtype)
    vp = torch.randn((Hkv, NB, BS, hd), generator=gen, device=dev).to(dtype)
    # the null block holds garbage by design: make it loud
    kp[:, 0] = 1e4
    vp[:, 0] = -1e4
    q = torch.randn((B, T, H, hd), generator=gen, device=dev).to(dtype)
    off = torch.tensor(offs, dtype=torch.int32, device=dev)
    return q, kp, vp, tables.to(dev), off


def attention_work(offs, T, H, Hkv, hd, BS, window, elem_bytes, MB,
                   kv_bytes=None, scale_bytes=0):
    """(bytes, flops) the function needs on these inputs: q read once, the
    visible K/V pages of every (row, kv head) read once (``kv_bytes`` an
    element, plus ``scale_bytes`` per page of an int8 pool), the output
    written once; 4*hd flops per visible (query, key) pair."""
    pages = 0
    pairs = 0
    for off in offs:
        for t in range(T):
            pos = off + t
            lo = max(0, pos - window + 1) if window > 0 else 0
            pairs += min(pos, MB * BS - 1) - lo + 1
        hi = min((off + T - 1) // BS, MB - 1)
        lo_page = max(0, off - window + 1) // BS if window > 0 else 0
        pages += hi - lo_page + 1
    B = len(offs)
    qo = 2 * B * T * H * hd * elem_bytes
    kv_bytes = elem_bytes if kv_bytes is None else kv_bytes
    kv = 2 * pages * Hkv * (BS * hd * kv_bytes + scale_bytes)
    tables = B * MB * 4 + B * 4
    return qo + kv + tables, 4 * hd * pairs * H


WINDOW_KW = dict(window=64, logit_softcap=50.0, sm_scale=1.0 / math.sqrt(256))
# the prompts' token counts in the slice, less one: the positions of their
# first decode step
SLICE_OFFSETS = [40, 120, 260, 400, 640, 900, 1200, 1564]
RAGGED_CASES = [
    # the decode kernel
    ("decode ragged + dead row", dict(
        offs=[0, 15, 16, 17, 500, 1023, 2047, 300], T=1, dead=(7,)), {}),
    ("decode pow2 null tails", dict(
        offs=[3, 40, 100, 255], T=1, extra_tables=9), {}),
    ("decode B=1 ctx 2048", dict(offs=[2047], T=1), {}),
    ("decode B=8 slice lengths MB 128", dict(
        offs=SLICE_OFFSETS, T=1, extra_tables=30), {}),
    ("decode window+softcap+scale", dict(
        offs=[5, 70, 129, 1000, 71, 1500], T=1), WINDOW_KW),
    ("decode BS=8 + null tails", dict(offs=[3, 40, 100, 255], T=1, BS=8,
                                      extra_tables=9), {}),
    ("decode BS=32", dict(offs=[3, 40, 100, 1000], T=1, BS=32, extra_tables=3), {}),
    ("decode hd=64", dict(offs=[3, 40, 100, 1000], T=1, hd=64), {}),
    ("decode offset -1 + dead row", dict(offs=[-1, 300, 57, 1000], T=1, dead=(1,)),
     {}),
    # the tile kernel: verify and prefill chunks
    ("verify T=5 + dead row", dict(offs=[10, 31, 64, 700, 300], T=5, dead=(4,)), {}),
    ("window+softcap+scale T=5", dict(offs=[5, 70, 129, 1000], T=5), WINDOW_KW),
    ("prefill T=16", dict(offs=[0, 40], T=16), {}),
    ("prefill T=17", dict(offs=[5, 33], T=17), {}),
    ("window+softcap+scale T=64", dict(offs=[5, 70, 129, 1000], T=64), WINDOW_KW),
    ("prefill T=300", dict(offs=[0], T=300), {}),
    ("prefill T=512 @0", dict(offs=[0], T=512), {}),
    ("prefill T=512 @1000", dict(offs=[1000], T=512), {}),
    ("prefill T=2048 @0", dict(offs=[0], T=2048), {}),
    ("BS=8 T=100 + null tails", dict(offs=[3, 77], T=100, BS=8, extra_tables=4), {}),
    ("BS=32 T=100", dict(offs=[3, 77], T=100, BS=32), {}),
]
F32 = dict(dtype=torch.float32)
# f32: the f32 decode kernel (decode and the chunks shorter than the f32
# tile form's crossover), the f32 tile form (3xTF32) from the crossover on
F32_RAGGED_CASES = [
    ("f32 decode + dead row", dict(offs=[0, 17, 300, 1023], T=1, dead=(2,), **F32), {}),
    ("f32 decode offset -1 + dead row", dict(offs=[-1, 300, 57, 1000], T=1, dead=(1,),
                                             **F32), {}),
    ("f32 decode hd=64", dict(offs=[3, 40, 100, 1000], T=1, hd=64, **F32), {}),
    ("f32 decode B=1 ctx 2048", dict(offs=[2047], T=1, **F32), {}),
    ("f32 decode BS=8 + null tails", dict(offs=[3, 40, 100, 255], T=1, BS=8,
                                          extra_tables=9, **F32), {}),
    ("f32 decode BS=32", dict(offs=[3, 40, 100, 1000], T=1, BS=32, extra_tables=3,
                              **F32), {}),
    ("f32 decode window+softcap+scale", dict(offs=[5, 70, 129, 1000, 71, 1500], T=1,
                                             **F32), WINDOW_KW),
    ("f32 verify T=3", dict(offs=[7, 300, 1023], T=3, **F32), {}),
    ("f32 verify T=4", dict(offs=[7, 300, 1023], T=4, **F32), {}),
    ("f32 verify T=5", dict(offs=[7, 300, 1023], T=5, **F32), {}),
    ("f32 window+softcap+scale T=5", dict(offs=[5, 70, 129, 1000], T=5, **F32),
     WINDOW_KW),
    ("f32 prefill T=5 + dead row", dict(offs=[10, 31, 64, 700, 300], T=5, dead=(4,),
                                        **F32), {}),
    ("f32 prefill T=17", dict(offs=[5, 33], T=17, **F32), {}),
    ("f32 window+softcap+scale T=64", dict(offs=[5, 70, 129, 1000], T=64, **F32),
     WINDOW_KW),
    ("f32 prefill T=300", dict(offs=[0], T=300, **F32), {}),
    ("f32 prefill T=512 @1000", dict(offs=[1000], T=512, **F32), {}),
    ("f32 prefill T=2048 @0", dict(offs=[0], T=2048, **F32), {}),
    ("f32 BS=8 T=100 + null tails", dict(offs=[3, 77], T=100, BS=8, extra_tables=4,
                                         **F32), {}),
    ("f32 BS=32 T=100", dict(offs=[3, 77], T=100, BS=32, **F32), {}),
    ("f32 prefill hd=64 T=40", dict(offs=[3, 100], T=40, hd=64, **F32), {}),
]
# gemma-2-9b's attention (models/config.py): 16 heads over 8 kv heads at
# head_dim 256, a 4096-key window, softcap 50, score scale 1/sqrt(256): in
# bf16 the decode and tile kernels' head_dim-256 forms, in f32 the f32
# decode kernel below T_MIN_F32_HD256 (T_MIN_F32_INT8_HD256), the f32 tile
# form from it on
GEMMA = dict(H=16, Hkv=8, hd=256)
GEMMA_KW = dict(window=4096, logit_softcap=50.0, sm_scale=1.0 / math.sqrt(256))
HD256_RAGGED_CASES = [
    (f"hd256 {name} {str(dt)[6:]}", dict(geo, dtype=dt, **GEMMA), GEMMA_KW)
    for dt in (torch.bfloat16, torch.float32)
    for name, geo in (
        ("decode window-cut", dict(offs=[0, 700, 4500, 5000], T=1)),
        ("decode offset -1 + dead row + null tails", dict(
            offs=[-1, 300, 57, 1000], T=1, dead=(1,), extra_tables=5)),
        ("decode B=8 ctx 1024", dict(offs=[1023] * 8, T=1)),
        ("decode BS=8", dict(offs=[3, 40, 100, 1000], T=1, BS=8)),
        ("decode BS=32 + null tails", dict(offs=[3, 40, 100, 1000], T=1, BS=32,
                                           extra_tables=3)),
        ("verify T=5 + dead row", dict(offs=[10, 31, 64, 700, 300], T=5, dead=(4,))),
        ("chunk T=17 window-cut", dict(offs=[5, 4200], T=17)),
        ("prefill T=300 window-cut", dict(offs=[4000], T=300)),
        ("prefill T=512 @1000", dict(offs=[1000], T=512)),
        ("BS=8 T=100 + null tails", dict(offs=[3, 77], T=100, BS=8, extra_tables=4)),
        ("BS=32 T=100", dict(offs=[3, 77], T=100, BS=32)),
    )
]
# qwen2-7b's heads: 28 query heads over 4 kv heads, G = 7 (every other
# served model has G = 4 or 2): the decode kernel's 16-row blocks hold 7
# heads and zero the rest, the tile kernel's 64-row blocks cut the (t, g)
# rows mid-position, decode_f32 takes G * T <= 32 (T <= 4) and the f32
# tile form the verify chunk of T = 5
QWEN2 = dict(H=28, Hkv=4, hd=128)
QWEN2_RAGGED_CASES = [
    (f"qwen2 G=7 {name} {str(dt)[6:]}", dict(geo, dtype=dt, **QWEN2), {})
    for dt in (torch.bfloat16, torch.float32)
    for name, geo in (
        ("decode + dead row + null tails", dict(offs=[0, 17, 300, 1023, 2047], T=1,
                                                dead=(2,), extra_tables=5)),
        ("chunk T=4", dict(offs=[7, 300, 1023], T=4)),
        ("verify T=5 + dead row", dict(offs=[10, 31, 64, 700, 300], T=5, dead=(4,))),
        ("prefill T=300", dict(offs=[0, 45], T=300)),
        ("prefill T=512 @1000", dict(offs=[1000], T=512)),
    )
]
# gemma-2b's heads (8 query heads over ONE kv head: G = 8) and gemma-7b's
# (16 over 16: G = 1), both at head_dim 256, with gemma-3's 1024-key window,
# a softcap and the score scale: at G = 8 decode_f32 holds 8 T <= 32 rows
# (T <= 4) and the verify chunk of T = 5 goes to the f32 tile form; at G = 1
# decode_f32 takes every f32 chunk below T_MIN_F32_HD256 (T = 16 its last)
GEMMA_2B = dict(H=8, Hkv=1, hd=256)
GEMMA_7B = dict(H=16, Hkv=16, hd=256)
GEMMA3_KW = dict(window=1024, logit_softcap=50.0, sm_scale=1.0 / math.sqrt(256))
GEMMA_G_RAGGED_CASES = [
    (f"G={G} {name} {str(dt)[6:]}", dict(geo, dtype=dt, **heads), kw)
    for G, heads in ((8, GEMMA_2B), (1, GEMMA_7B))
    for dt in (torch.bfloat16, torch.float32)
    for name, geo, kw in (
        ("decode + dead row + null tails", dict(offs=[0, 17, 300, 1023, 2047], T=1,
                                                dead=(2,), extra_tables=5), {}),
        ("decode window-cut", dict(offs=[5, 1030, 2000, 1500], T=1), GEMMA3_KW),
        ("chunk T=4", dict(offs=[7, 300, 1023], T=4), {}),
        ("verify T=5 + dead row", dict(offs=[10, 31, 64, 700, 300], T=5, dead=(4,)), {}),
        ("verify T=5 window+softcap+scale", dict(offs=[5, 1030, 2000], T=5), GEMMA3_KW),
        ("chunk T=16", dict(offs=[3, 1100], T=16), {}),
        ("chunk T=17 window-cut", dict(offs=[5, 1200], T=17), GEMMA3_KW),
        ("prefill T=300 window-cut", dict(offs=[900], T=300), GEMMA3_KW),
        ("prefill T=512 @1000", dict(offs=[1000], T=512), {}),
    )
]
# starcoder-15b's heads (48 query heads over ONE kv head: G = 48, hd 128)
# and gpt2's (12 over 12 at head_dim 64: G = 1): at G = 48 the decode
# kernel splits a kv head's 48 query heads into three 16-row blocks, the
# tile kernel folds 48 T rows into 64-row blocks, and every f32 chunk (T =
# 1 too: 48 rows exceed decode_f32's 32) goes to the f32 tile form; at hd
# 64 decode_f32 takes the f32 chunks below T_MIN_F32
STARCODER = dict(H=48, Hkv=1, hd=128)
GPT2 = dict(H=12, Hkv=12, hd=64)
GPT2_RAGGED_CASES = [
    (f"{geo_tag} {name} {str(dt)[6:]}", dict(geo, dtype=dt, **heads), {})
    for geo_tag, heads in (("G=48", STARCODER), ("hd64 G=1", GPT2))
    for dt in (torch.bfloat16, torch.float32)
    for name, geo in (
        ("decode + dead row + null tails", dict(offs=[0, 17, 300, 1023, 2047], T=1,
                                                dead=(2,), extra_tables=5)),
        ("chunk T=4", dict(offs=[7, 300, 1023], T=4)),
        ("verify T=5 + dead row", dict(offs=[10, 31, 64, 700, 300], T=5, dead=(4,))),
        ("chunk T=16", dict(offs=[3, 1100], T=16)),
        ("prefill T=300", dict(offs=[0, 45], T=300)),
        ("prefill T=512 @1000", dict(offs=[1000], T=512)),
    )
]
# phi-3-mini's heads (32 query heads over 32 kv heads at head_dim 96: G =
# 1) with its 2,047-key window on every layer: the decode and tile
# kernels' head_dim-96 forms (Q in registers over rows of 12 16-byte
# chunks), decode_f32 below the f32 crossover at head_dim 96 and the f32
# tile form from it on. The window binds only past 2,047 keys, so the
# window-cut cases sit at a 3,000-token context
PHI3 = dict(H=32, Hkv=32, hd=96)
PHI3_KW = dict(window=2047)
PHI3_RAGGED_CASES = [
    (f"hd96 {name} {str(dt)[6:]}", dict(geo, dtype=dt, **PHI3), kw)
    for dt in (torch.bfloat16, torch.float32)
    for name, geo, kw in (
        ("decode B=8 ctx 1024", dict(offs=[1023] * 8, T=1), PHI3_KW),
        ("decode + dead row + null tails", dict(offs=[0, 17, 300, 1023, 2047], T=1,
                                                dead=(2,), extra_tables=5), PHI3_KW),
        ("decode window-cut ctx 3000", dict(offs=[2999, 2500, 2047, 2046, 100], T=1),
         PHI3_KW),
        ("decode BS=8", dict(offs=[3, 40, 100, 1000], T=1, BS=8), {}),
        ("decode BS=32 + null tails", dict(offs=[3, 40, 100, 1000], T=1, BS=32,
                                           extra_tables=3), {}),
        ("verify T=5 + dead row", dict(offs=[10, 31, 64, 700, 300], T=5, dead=(4,)),
         PHI3_KW),
        ("verify T=5 window-cut ctx 3000", dict(offs=[2995, 2100, 2046], T=5), PHI3_KW),
        ("window+softcap+scale T=5", dict(offs=[5, 70, 129, 1000], T=5), WINDOW_KW),
        ("chunk T=16", dict(offs=[3, 1100], T=16), PHI3_KW),
        ("chunk T=17 window-cut", dict(offs=[5, 2200], T=17), PHI3_KW),
        ("chunk T=32", dict(offs=[7, 900], T=32), PHI3_KW),
        ("prefill T=512 @1000", dict(offs=[1000], T=512), PHI3_KW),
        ("prefill T=512 window-cut ctx 3000", dict(offs=[2488], T=512), PHI3_KW),
        ("BS=8 T=100 + null tails", dict(offs=[3, 77], T=100, BS=8, extra_tables=4), {}),
    )
]
# the cases the row kernel served at head_dim 256 before its head_dim-256
# forms existed: there it is forced as well, in bf16 and f32, so that its
# error is held against the plain version in both types
ROW_FORCED_CASES = {f"hd256 {name} {dt}" for dt in ("bfloat16", "float32")
                    for name in ("decode window-cut", "chunk T=17 window-cut")}
# the timed hd-256 calls keep gemma's window and score scale but not its
# cap: SDPA, the yardstick, cannot cap scores (the cases above keep it)
GEMMA_TIMED_KW = dict(window=4096, sm_scale=1.0 / math.sqrt(256))


def int8_pools(gen, NB, Hkv=8, BS=16, hd=128):
    """Random int8 pages and per-(kv head, block) scales in [0.005, 0.02]
    (values up to ~2.5 in magnitude), with a loud null block: +-127
    under a scale of 1e3, so any read of it shows in the result."""
    def pages():
        return torch.randint(-127, 128, (Hkv, NB, BS, hd), generator=gen,
                             device="cuda", dtype=torch.int32).to(torch.int8)

    def scales():
        return 0.005 + 0.015 * torch.rand((Hkv, NB), generator=gen, device="cuda")

    kq, vq, ks, vs = pages(), pages(), scales(), scales()
    kq[:, 0] = 127
    vq[:, 0] = -127
    ks[:, 0] = 1e3
    vs[:, 0] = 1e3
    return kq, vq, ks, vs


def split_plan(q, kp, tb, kernel: str = "decode") -> str:
    """The split plan of a decode kernel (``kernel``: "decode",
    "decode_hd256" or "decode_f32") for these inputs, as printed."""
    from bee2bee_tpu_torch.ops.ragged import _sm_count, decode_f32_splits, decode_splits

    plan = decode_f32_splits if kernel == "decode_f32" else decode_splits
    splits, pages = plan(q.shape[0], kp.shape[0], tb.shape[1], kp.shape[2],
                         _sm_count(q.device.index))
    return f"{splits} splits x {pages} pages"


def bounds(nbytes: int, flops: int, dtype, kernel: str = "") -> dict:
    """The least time the card could take: max(bytes at the HBM rate, flops
    at the peak of the products the kernel does). f32: three TF32 products
    at the TF32 tensor-core peak (f32-accurate work on the tensor cores),
    the CUDA-core f32 time (one FFMA product) kept beside it; the f32
    decode kernel (``kernel`` "decode_f32") and cuBLAS's full-f32 product
    (``kernel`` "ffma") do FFMA products, so their bound is that FFMA time;
    the int8-weight GEMM's f32 form (``kernel`` "2xtf32") two TF32
    products."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if dtype == torch.bfloat16:
        t_ops, peak = flops / BF16_FLOPS_PER_S * 1e3, "bf16 989 TFLOP/s"
    elif kernel in ("decode_f32", "ffma"):
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        peak = f"f32 FFMA at {F32_FLOPS_PER_S / 1e12} TFLOP/s"
    elif kernel == "2xtf32":  # the int8-weight GEMM's f32 form: x split in two
        t_ops = 2 * flops / TF32_FLOPS_PER_S * 1e3
        peak = f"2xTF32 at {TF32_FLOPS_PER_S / 1e12} TFLOP/s"
    else:
        t_ops = TF32_PRODUCTS * flops / TF32_FLOPS_PER_S * 1e3
        peak = f"{TF32_PRODUCTS}xTF32 at {TF32_FLOPS_PER_S / 1e12} TFLOP/s"
    bound_ms = max(t_bytes, t_ops)
    out = dict(bound_ms=bound_ms, bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, flops=flops)
    text = (f"bound {bound_ms:.4f} ms ({out['bound_by']}: {nbytes} B -> "
            f"{t_bytes:.4f} ms, {flops} flop, {peak} -> {t_ops:.4f} ms)")
    if dtype == torch.float32 and kernel not in ("decode_f32", "ffma"):
        out["ffma_bound_ms"] = max(t_bytes, flops / F32_FLOPS_PER_S * 1e3)
        text += f", FFMA bound {out['ffma_bound_ms']:.4f} ms (f32 at 67 TFLOP/s)"
    out["text"] = text
    return out


_SDPA_SEEN: set = set()


def log_sdpa_backend(label: str, fn, tries: int = 3) -> None:
    """Once per label: the CUDA kernels one SDPA call runs, under
    torch.profiler, which name the backend PyTorch chose (a capture that
    saw no kernel is taken again, up to ``tries`` times)."""
    if label in _SDPA_SEEN:
        return
    _SDPA_SEEN.add(label)
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names: list = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted({e.key[:72] for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA})
        if names:
            break
    log(f"sdpa backend ({label}): kernels {names}")


def time_ragged(label, q, kp, vp, tb, off, offs, T, flush, scales=None, window=0,
                sm_scale=None):
    """The kernel's time beside the plain version's, SDPA's over the
    gathered (for an int8 pool: dequantized) view in q's type with the
    same mask and score scale, and the bound (at the peak rate of q's
    type; f32: the 3xTF32 and the FFMA bounds)."""
    from bee2bee_tpu_torch.ops.ragged import (
        ragged_paged_attention, ragged_paged_attention_ref, ragged_kernel,
    )

    H, hd = q.shape[2], q.shape[3]
    Hkv, _, BS, _ = kp.shape
    MB = tb.shape[1]
    kw = {} if scales is None else dict(k_scale=scales[0], v_scale=scales[1])
    kw.update(window=window, sm_scale=sm_scale)
    ms = cuda_time_ms(lambda: ragged_paged_attention(q, kp, vp, tb, off, **kw),
                      flush=flush)
    plain_ms = cuda_time_ms(
        lambda: ragged_paged_attention_ref(q, kp, vp, tb, off, **kw), flush=flush
    )
    # library yardstick: SDPA over the pre-gathered view with an explicit
    # mask (the gather and any dequantization are not timed)
    B = len(offs)
    S = MB * BS
    G = H // Hkv

    def gathered(pool, scale):  # [B, H, S, hd], kv heads repeated per group
        g = pool[:, tb.long()]
        if scale is not None:
            g = (g.float() * scale[:, tb.long()][..., None, None]).to(q.dtype)
        g = g.reshape(Hkv, B, S, hd).transpose(0, 1)
        return g.repeat_interleave(G, dim=1).contiguous()

    kg = gathered(kp, None if scales is None else scales[0])
    vg = gathered(vp, None if scales is None else scales[1])
    qs = q.transpose(1, 2).contiguous()  # [B, H, T, hd]
    qpos = off.long()[:, None] + torch.arange(T, device="cuda")[None, :]
    kpos = torch.arange(S, device="cuda")[None, None, :]
    mask = kpos <= qpos[:, :, None]
    if window:
        mask = mask & (kpos > qpos[:, :, None] - window)
    mask = mask[:, None]  # [B, 1, T, S]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_time_ms(
        lambda: sdpa(qs, kg, vg, attn_mask=mask, scale=sm_scale), flush=flush
    )
    log_sdpa_backend(f"ragged, {q.dtype}, hd {hd}, mask",
                     lambda: sdpa(qs, kg, vg, attn_mask=mask, scale=sm_scale))
    kv_bytes = kp.element_size()
    nbytes, flops = attention_work(offs, T, H, Hkv, hd, BS, window, q.element_size(),
                                   MB, kv_bytes=kv_bytes,
                                   scale_bytes=0 if scales is None else 4)
    kernel = ragged_kernel(q.dtype, T, hd, scales is not None, G)
    b = bounds(nbytes, flops, q.dtype, kernel)
    plan = f", plan {split_plan(q, kp, tb, kernel)}" if kernel.startswith("decode") else ""
    log(f"timing {label} B={B} T={T} ctx={offs[0] + T} H={H}/{Hkv} hd={hd} "
        f"({q.dtype}{plan}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
        f"{library_ms:.4f} ms, {b['text']}, share of bound {b['bound_ms'] / ms:.3f}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                **{k: v for k, v in b.items() if k != "text"})


def time_decode_sweep(label, q, kp, vp, tb, off, scales=None, layers=32):
    """ms per launch of ``layers`` launches back to back, one for each
    layer slice of a ``layers``-deep copy of the pool, as a decode step
    issues them (without the projections in between)."""
    from bee2bee_tpu_torch.ops.ragged import ragged_paged_attention

    def stack(t):
        return None if t is None else t.unsqueeze(0).repeat(layers, *([1] * t.dim()))

    k, v = stack(kp), stack(vp)
    ks, vs = (None, None) if scales is None else (stack(scales[0]), stack(scales[1]))

    def sweep():
        for i in range(layers):
            kw = {} if ks is None else dict(k_scale=ks[i], v_scale=vs[i])
            ragged_paged_attention(q, k[i], v[i], tb, off, **kw)

    # a spin long enough for the host to queue all the launches (about
    # 0.06 ms of host time each) before the card starts on them
    ms = cuda_time_ms(sweep, spin=SPIN_CYCLES * layers) / layers
    log(f"timing {label} sweep: {layers} launches back to back over a "
        f"{layers}-layer pool, {ms:.4f} ms per launch")
    return ms


# read_counts()'s name of each ragged kernel's counter over the pool in q's
# type; the int8 pool form's carries an "_int8" suffix
RAGGED_COUNTERS = {"row": "ragged", "tile": "ragged_prefill",
                   "tile_hd256": "ragged_prefill_hd256",
                   "tile_f32": "ragged_prefill_f32", "decode": "ragged_decode",
                   "decode_hd256": "ragged_decode_hd256",
                   "decode_f32": "ragged_decode_f32"}


def ragged_counter(q, Hkv: int, int8: bool) -> str:
    """The launch counter the dispatch rule names for these queries over
    ``Hkv`` kv heads."""
    from bee2bee_tpu_torch.ops.ragged import ragged_kernel

    kernel = ragged_kernel(q.dtype, q.shape[1], q.shape[3], int8, q.shape[2] // Hkv)
    return RAGGED_COUNTERS[kernel] + ("_int8" if int8 else "")


def check_one_launch(label: str, counter: str) -> None:
    counts = read_counts()
    check(counts[counter] == 1 and sum(counts.values()) == 1,
          f"{label}: expected one {counter} launch, counted {counts}")


def time_crossover(label, gen, flush, int8, dtype=torch.bfloat16, heads=None):
    """Two kernels of q's type forced at the same inputs over T, at
    llama-3-8b's heads or ``heads`` (GEMMA: the head_dim-256 forms). bf16:
    the row kernel and the tile kernel (where the tile kernel starts to
    win, the dispatch's T_MIN; and the row kernel at the timed prefill
    chunk). f32: the f32 decode kernel, at each T whose G * T rows it
    holds, and the f32 tile form (where the tile form starts to win, the
    dispatch's T_MIN_F32 and its kin)."""
    from bee2bee_tpu_torch.ops.ragged import (
        DECODE_F32_MAX_ROWS, _launch_kernel, row_offsets,
    )

    heads = heads or {}
    hd = heads.get("hd", 128)
    if dtype == torch.float32:
        first, tile = "decode_f32", "tile_f32"
        shapes = ((8, 1000, (1, 2, 3, 4, 5, 6, 8, 12, 16, 32)),)
    else:
        first, tile = "row", "tile_hd256" if hd == 256 else "tile"
        shapes = ((8, 1000, (1, 2, 4, 8, 16, 32)), (1, 48, (2, 8, 16)), (1, 1000, (512,)))
    for B, off0, Ts in shapes:
        for T in Ts:
            q, kp, vp, tb, off = make_case(gen, offs=[off0] * B, T=T, dtype=dtype,
                                           **heads)
            scales = (None, None)
            if int8:
                kp, vp, *scales = int8_pools(gen, kp.shape[1], Hkv=kp.shape[0], hd=hd)
            rows = row_offsets(off, B, q.device)

            def run(kernel):
                return _launch_kernel(q, kp, vp, tb, rows, 0, 1.0 / math.sqrt(hd),
                                      0.0, *scales, kernel=kernel)

            kernels = (first, tile)
            if first == "decode_f32" and q.shape[2] // kp.shape[0] * T > DECODE_F32_MAX_ROWS:
                kernels = (tile,)
            ms = {k: cuda_time_ms(lambda: run(k), flush=flush) for k in kernels}
            log(f"crossover {label} B={B} T={T} ctx={off0 + T} H={q.shape[2]}/"
                f"{kp.shape[0]} hd={hd} ({dtype}): "
                + ", ".join(f"{k} kernel {t:.4f} ms" for k, t in ms.items()))


def forced_kernels(q, Hkv: int) -> tuple:
    """The ragged kernels that take these queries over ``Hkv`` kv heads:
    bf16, the decode kernel (T = 1), the tile kernel and the row kernel,
    the first two in their head_dim-256 forms where hd is 256; f32, the f32
    decode kernel (where it holds the G * T rows), the f32 tile form and
    the row kernel."""
    from bee2bee_tpu_torch.ops.ragged import DECODE_F32_MAX_ROWS

    T, hd = q.shape[1], q.shape[3]
    sfx = "_hd256" if hd == 256 else ""
    if q.dtype == torch.bfloat16:
        return (("decode" + sfx,) if T == 1 else ()) + ("tile" + sfx, "row")
    fits = q.shape[2] // Hkv * T <= DECODE_F32_MAX_ROWS
    return (("decode_f32",) if fits else ()) + ("tile_f32", "row")


def time_forced(label, q, kp, vp, tb, off, flush, scales=None, window=0,
                sm_scale=None):
    """Each kernel that takes these queries (``forced_kernels``) forced at
    the same inputs."""
    from bee2bee_tpu_torch.ops.ragged import _launch_kernel, row_offsets

    rows = row_offsets(off, q.shape[0], q.device)
    sc = (None, None) if scales is None else scales
    scale = sm_scale or 1.0 / math.sqrt(q.shape[3])
    ms = {k: cuda_time_ms(lambda: _launch_kernel(
        q, kp, vp, tb, rows, window, scale, 0.0, *sc, kernel=k),
        flush=flush) for k in forced_kernels(q, kp.shape[0])}
    plan = "".join(f" ({k} plan {split_plan(q, kp, tb, k)})" for k in ms
                   if k.startswith("decode"))
    log(f"forced {label} B={q.shape[0]} T={q.shape[1]} hd={q.shape[3]} ({q.dtype})"
        f"{plan}: " + ", ".join(f"{k} kernel {t:.4f} ms" for k, t in ms.items()))
    return ms


def ragged_cases_vs_plain(gen, cases, int8=False) -> dict:
    """Each case through the dispatching wrapper against the plain version,
    the kernel the rule names launched once (a decode case: a second call
    the same bytes). Returns the max abs error per kernel."""
    from bee2bee_tpu_torch.ops.ragged import (
        _launch_kernel, ragged_paged_attention, ragged_paged_attention_ref, row_offsets,
    )

    tag = "int8 kernel vs plain" if int8 else "kernel vs plain"
    errs = {k: 0.0 for k in RAGGED_COUNTERS}
    for label, geo, kw in cases:
        q, kp, vp, tb, off = make_case(gen, **geo)
        if int8:
            kp, vp, ks, vs = int8_pools(gen, kp.shape[1], Hkv=kp.shape[0],
                                        BS=kp.shape[2], hd=kp.shape[3])
            kw = dict(kw, k_scale=ks, v_scale=vs)
        counter = ragged_counter(q, kp.shape[0], int8)
        reset_counts()
        got = ragged_paged_attention(q, kp, vp, tb, off, **kw)
        torch.cuda.synchronize()
        check_one_launch(f"{tag}: {label}", counter)
        if int8:  # the plain version dequantizes and rounds to q's type
            want = ragged_paged_attention_ref(q, kp, vp, tb, off, **kw).float()
        else:
            want = ragged_paged_attention_ref(
                q.float(), kp.float(), vp.float(), tb, off, **kw)
        tol = KERNEL_TOL if q.dtype == torch.bfloat16 else F32_TOL
        check(bool(torch.isfinite(got).all()), f"{tag}: {label}: non-finite output")
        err = (got.float() - want).abs().max().item()
        log(f"{tag}: {label} ({q.dtype}, {counter} kernel): max abs err "
            f"{err:.3e} (tol {tol})")
        check(err <= tol, f"{tag}: {label}: max abs err {err} > {tol}")
        if "offset -1" in label:
            check(not bool(got[0].any()), f"{tag}: {label}: the row at -1 is not 0")
        if counter.startswith("ragged_decode"):
            # the split-K merges run in a fixed order: a second call repeats
            # the first bit for bit
            again = ragged_paged_attention(q, kp, vp, tb, off, **kw)
            check(torch.equal(got, again), f"{tag}: {label}: a second call differs")
        kernel = next(k for k, c in RAGGED_COUNTERS.items()
                      if counter in (c, c + "_int8"))
        errs[kernel] = max(errs[kernel], err)
        if label in ROW_FORCED_CASES:
            forced = _launch_kernel(
                q, kp, vp, tb, row_offsets(off, q.shape[0], q.device), kw["window"],
                kw["sm_scale"], kw["logit_softcap"], kw.get("k_scale"), kw.get("v_scale"),
                kernel="row")
            err = (forced.float() - want).abs().max().item()
            log(f"{tag}: {label} (row kernel forced): max abs err {err:.3e} (tol {tol})")
            check(err <= tol, f"{tag}: {label}: row kernel forced: max abs err {err} > {tol}")
            errs["row"] = max(errs["row"], err)
    return errs


# the timed ragged shapes (label, offsets, T, q's type, heads, forced):
# llama-3-8b's heads, then gemma-2-9b's (window and score scale, no cap:
# GEMMA_TIMED_KW), gemma-2b's and gemma-7b's; the forced timings put every
# kernel that takes the inputs beside the one the rule names
RAGGED_TIMED = (
    ("decode", [1023] * 8, 1, torch.bfloat16, {}, True),
    ("decode_b1", [2047], 1, torch.bfloat16, {}, True),
    ("decode_f32", [1023] * 8, 1, torch.float32, {}, True),
    ("decode_f32_b1", [2047], 1, torch.float32, {}, True),
    ("prefill", [1000], 512, torch.bfloat16, {}, False),
    ("prefill_f32", [1000], 512, torch.float32, {}, False),
    # the speculative verify shape: B=8, T=K+1=5 over a 1024 context
    ("verify", [1023] * 8, 5, torch.bfloat16, {}, False),
    ("verify_f32", [1023] * 8, 5, torch.float32, {}, False),
    ("decode_hd256", [1023] * 8, 1, torch.bfloat16, GEMMA, True),
    ("prefill_hd256", [1000], 512, torch.bfloat16, GEMMA, True),
    ("decode_hd256_f32", [1023] * 8, 1, torch.float32, GEMMA, True),
    ("prefill_hd256_f32", [1000], 512, torch.float32, GEMMA, True),
    # gemma-2b's G = 8 at the verify shape (the tile form in bf16, the
    # f32 tile form in f32: 40 rows exceed decode_f32's 32) and
    # gemma-7b's G = 1 at decode and at the verify shape (decode_f32)
    ("verify_g8", [1023] * 8, 5, torch.bfloat16, GEMMA_2B, True),
    ("verify_g8_f32", [1023] * 8, 5, torch.float32, GEMMA_2B, True),
    ("decode_g1", [1023] * 8, 1, torch.bfloat16, GEMMA_7B, False),
    ("verify_g1_f32", [1023] * 8, 5, torch.float32, GEMMA_7B, False),
    # starcoder-15b's G = 48 at decode and the verify shape (the decode and
    # tile kernels), and its f32 decode step (48 rows: the f32 tile form);
    # gpt2's hd 64 at decode, a prefill chunk inside its 1,024 positions,
    # its f32 spec verify (decode_f32) and f32 prefill (the f32 tile form)
    ("decode_g48", [1023] * 8, 1, torch.bfloat16, STARCODER, False),
    ("verify_g48", [1023] * 8, 5, torch.bfloat16, STARCODER, False),
    ("decode_g48_f32", [1023] * 8, 1, torch.float32, STARCODER, False),
    ("decode_hd64", [1023] * 8, 1, torch.bfloat16, GPT2, False),
    ("prefill_hd64", [500], 512, torch.bfloat16, GPT2, False),
    ("verify_hd64_f32", [1023] * 8, 5, torch.float32, GPT2, False),
    ("prefill_hd64_f32", [500], 512, torch.float32, GPT2, False),
    # phi-3-mini's hd 96 at G = 1 under its 2,047-key window: decode and the
    # verify shape at a 1024-token context, a 512-token chunk at 1000, decode
    # and a 512-token chunk past the window at a 3,000-token context; in f32
    # the decode step (decode_f32), the verify shape and the chunk
    ("decode_hd96", [1023] * 8, 1, torch.bfloat16, PHI3, True),
    ("verify_hd96", [1023] * 8, 5, torch.bfloat16, PHI3, False),
    ("prefill_hd96", [1000], 512, torch.bfloat16, PHI3, False),
    ("decode_window_hd96", [2999] * 8, 1, torch.bfloat16, PHI3, False),
    ("prefill_window_hd96", [2488], 512, torch.bfloat16, PHI3, False),
    ("decode_hd96_f32", [1023] * 8, 1, torch.float32, PHI3, True),
    ("verify_hd96_f32", [1023] * 8, 5, torch.float32, PHI3, False),
    ("prefill_hd96_f32", [1000], 512, torch.float32, PHI3, False))
# gemma-2b's and gemma-7b's timed shapes (``--only gemma``)
GEMMA_G_TIMED = tuple(s for s in RAGGED_TIMED if s[4] in (GEMMA_2B, GEMMA_7B))
# starcoder-15b's and gpt2's (``--only gpt2``)
GPT2_TIMED = tuple(s for s in RAGGED_TIMED if s[4] in (STARCODER, GPT2))
# phi-3-mini's (``--only phi3``)
PHI3_TIMED = tuple(s for s in RAGGED_TIMED if s[4] == PHI3)


def time_ragged_shapes(gen, flush, int8: bool, shapes=RAGGED_TIMED) -> dict:
    """Each of ``shapes`` timed (``time_ragged``), over the pool in q's type
    or an int8 pool, with the forced kernels beside it where asked; the
    decode sweep at the llama decode shape. Returns the timings by label."""
    timings = {}
    label0 = "int8 " if int8 else ""
    for label, offs, T, dtype, heads, forced in shapes:
        q, kp, vp, tb, off = make_case(gen, offs=offs, T=T, dtype=dtype, **heads)
        scales = None
        if int8:
            kp, vp, *scales = int8_pools(gen, kp.shape[1], Hkv=kp.shape[0],
                                         hd=kp.shape[3])
        kw = {256: GEMMA_TIMED_KW, 96: PHI3_KW}.get(heads.get("hd"), {})
        timings[label] = time_ragged(f"{label0}{label} ({ragged_counter(q, kp.shape[0], int8)} "
                                     f"kernel)", q, kp, vp, tb, off, offs, T, flush,
                                     scales=scales, **kw)
        if forced:
            timings[label]["forced"] = time_forced(f"{label0}{label}", q, kp, vp, tb,
                                                   off, flush, scales=scales, **kw)
        if label == "decode":
            time_decode_sweep(f"{label0}{label}", q, kp, vp, tb, off, scales=scales)
    return timings


def phase_ragged_vs_plain(flush, int8=False):
    """Phase 2 (the pool in q's type) or phase 3 (int8 pool): each case, in
    bf16 and f32 and at head_dim 256, through the dispatching wrapper
    against the plain version, the kernel the rule names launched once;
    then the timings. Returns (max abs error per kernel, timings)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + int8)
    errs = ragged_cases_vs_plain(gen, RAGGED_CASES + F32_RAGGED_CASES + HD256_RAGGED_CASES
                                 + QWEN2_RAGGED_CASES + GEMMA_G_RAGGED_CASES
                                 + GPT2_RAGGED_CASES, int8)
    # the head_dim-96 forms' errors apart, for their rows of the kernel table
    errs.update((f"{k}_hd96", v) for k, v in
                ragged_cases_vs_plain(gen, PHI3_RAGGED_CASES, int8).items())
    timings = time_ragged_shapes(gen, flush, int8)
    label0 = "int8 " if int8 else ""
    time_crossover(f"{label0}pool".strip(), gen, flush, int8)
    time_crossover(f"{label0}pool".strip(), gen, flush, int8, dtype=torch.float32)
    time_crossover(f"{label0}pool".strip(), gen, flush, int8, heads=GEMMA)
    time_crossover(f"{label0}pool".strip(), gen, flush, int8, dtype=torch.float32,
                   heads=GEMMA)
    time_crossover(f"{label0}pool".strip(), gen, flush, int8, dtype=torch.float32,
                   heads=PHI3)
    return errs, timings


# ------------------------------------------------------------ phase 4


def time_flash(label, q, k, v, flush, kernel=None):
    """Causal flash attention's time (the kernel the rule names, or
    ``kernel`` forced) beside the plain version's, SDPA(is_causal)'s in q's
    type and the bound (f32: the 3xTF32 and the FFMA bounds)."""
    from bee2bee_tpu_torch.ops.flash import (
        _launch_kernel, flash_attention_ref, flash_kernel,
    )

    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    kernel = kernel or flash_kernel(q.dtype, hd)
    off = torch.zeros(B, dtype=torch.int32, device="cuda")
    scale = 1.0 / math.sqrt(hd)
    ms = cuda_time_ms(lambda: _launch_kernel(q, k, v, off, True, scale, kernel=kernel),
                      flush=flush)
    plain_ms = cuda_time_ms(lambda: flash_attention_ref(q, k, v), flush=flush)
    qs = q.transpose(1, 2).contiguous()  # [B, H, T, hd]
    ks = k.transpose(1, 2).repeat_interleave(H // Hkv, dim=1).contiguous()
    vs = v.transpose(1, 2).repeat_interleave(H // Hkv, dim=1).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_time_ms(lambda: sdpa(qs, ks, vs, is_causal=True), flush=flush)
    log_sdpa_backend(f"flash, {q.dtype}, hd {hd}, is_causal",
                     lambda: sdpa(qs, ks, vs, is_causal=True))
    # q, k, v read once, the output written once; 4*hd flops per visible
    # (query, key) pair of each head
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * hd * H * B * (T * (T + 1) // 2)
    b = bounds(nbytes, flops, q.dtype)
    log(f"timing flash {label} causal B={B} T=S={T} H={H}/{Hkv} hd={hd} ({q.dtype}, "
        f"{kernel} kernel): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa(is_causal) {library_ms:.4f} ms, {b['text']}, share of bound "
        f"{b['bound_ms'] / ms:.3f}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                **{k: v for k, v in b.items() if k != "text"})


# read_counts()'s name of each flash kernel's counter
FLASH_COUNTERS = {"row": "flash", "tile": "flash_tile", "tile_hd256": "flash_tile_hd256",
                  "tile_f32": "flash_tile_f32"}


def phase_flash_vs_plain(flush):
    from bee2bee_tpu_torch.ops.flash import (
        _launch_kernel, flash_attention, flash_attention_ref, flash_kernel,
    )
    from bee2bee_tpu_torch.ops.ragged import row_offsets

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)

    def qkv(B, T, S, dtype=torch.bfloat16, H=32, Hkv=8, hd=128):
        return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                     for shape in ((B, T, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))

    def offsets(offs):
        return torch.tensor(offs, dtype=torch.int32, device="cuda")

    f32 = torch.float32
    cases = [
        ("causal T=S=2048", qkv(1, 2048, 2048), dict(offset=None)),
        ("decode B=8 T=1 S=2048 ragged + empty row", qkv(8, 1, 2048), dict(
            offset=offsets([0, 1, 31, 32, 700, 1500, 2047, -1]))),
        ("T=512 @1000 S=2048", qkv(1, 512, 2048), dict(offset=1000)),
        ("non-causal T=S=256", qkv(2, 256, 256), dict(causal=False)),
        ("f32 T=64 S=256 @[10,150]", qkv(2, 64, 256, f32), dict(
            offset=offsets([10, 150]))),
        ("f32 causal T=S=2048", qkv(1, 2048, 2048, f32), dict(offset=None)),
        ("f32 decode B=8 T=1 S=2048 ragged + empty row", qkv(8, 1, 2048, f32), dict(
            offset=offsets([0, 1, 31, 32, 700, 1500, 2047, -1]))),
        ("f32 non-causal T=S=256", qkv(2, 256, 256, f32), dict(causal=False)),
        ("f32 hd=64 T=100 S=300 @200", qkv(2, 100, 300, f32, hd=64), dict(offset=200)),
        ("hd256 gemma bf16 T=64 S=256 @[10,150]", qkv(2, 64, 256, **GEMMA), dict(
            offset=offsets([10, 150]))),
        ("hd256 gemma bf16 causal T=S=2048", qkv(1, 2048, 2048, **GEMMA),
         dict(offset=None)),
        ("hd256 gemma bf16 decode B=8 T=1 S=2048 ragged + empty row",
         qkv(8, 1, 2048, **GEMMA), dict(
             offset=offsets([0, 1, 31, 32, 700, 1500, 2047, -1]))),
        ("hd256 gemma bf16 T=100 S=300 @200", qkv(2, 100, 300, **GEMMA),
         dict(offset=200)),
        ("hd256 gemma bf16 non-causal T=S=256", qkv(2, 256, 256, **GEMMA),
         dict(causal=False)),
        ("hd256 gemma f32 T=64 S=256 @[10,150]", qkv(2, 64, 256, f32, **GEMMA), dict(
            offset=offsets([10, 150]))),
        ("hd256 gemma f32 causal T=S=2048", qkv(1, 2048, 2048, f32, **GEMMA),
         dict(offset=None)),
        ("hd256 gemma f32 decode B=8 T=1 S=2048 ragged + empty row",
         qkv(8, 1, 2048, f32, **GEMMA), dict(
             offset=offsets([0, 1, 31, 32, 700, 1500, 2047, -1]))),
        ("hd256 gemma f32 non-causal T=S=256", qkv(2, 256, 256, f32, **GEMMA),
         dict(causal=False)),
    ] + [  # phi-3-mini's heads: head_dim 96, G = 1
        (f"hd96 phi3 {str(dt)[6:]} {name}", qkv(*shape, dt, **PHI3), kw)
        for dt in (torch.bfloat16, f32)
        for name, shape, kw in (
            ("T=64 S=256 @[10,150]", (2, 64, 256), dict(offset=offsets([10, 150]))),
            ("causal T=S=2048", (1, 2048, 2048), dict(offset=None)),
            ("decode B=8 T=1 S=2048 ragged + empty row", (8, 1, 2048),
             dict(offset=offsets([0, 1, 31, 32, 700, 1500, 2047, -1]))),
            ("non-causal T=S=256", (2, 256, 256), dict(causal=False)))
    ]
    # the max abs error per kernel; the head_dim-96 cases' apart
    errs = {k: 0.0 for k in FLASH_COUNTERS}
    errs.update((f"{k}_hd96", 0.0) for k in ("tile", "tile_f32"))
    for label, (q, k, v), kw in cases:
        kernel = flash_kernel(q.dtype, q.shape[3])
        counter = FLASH_COUNTERS[kernel]
        reset_counts()
        got = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        check_one_launch(f"flash {label}", counter)
        want = flash_attention_ref(q, k, v, **kw)
        tol = KERNEL_TOL if q.dtype == torch.bfloat16 else F32_TOL
        check(bool(torch.isfinite(got).all()), f"flash {label}: non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        log(f"flash vs plain: {label} ({q.dtype}, {counter} kernel): max abs err "
            f"{err:.3e} (tol {tol})")
        check(err <= tol, f"flash {label}: max abs err {err} > {tol}")
        if "empty row" in label:
            check(not bool(got[7].any()), "flash: the empty row is not 0")
        key = f"{kernel}_hd96" if label.startswith("hd96") else kernel
        errs[key] = max(errs[key], err)
        if label.endswith("T=64 S=256 @[10,150]") and label.startswith("hd256"):
            # the row kernel, which the rule no longer names, forced where it
            # served head_dim 256 before
            forced = _launch_kernel(q, k, v, row_offsets(kw["offset"], q.shape[0], q.device),
                                    True, 1.0 / math.sqrt(q.shape[3]), kernel="row")
            err = (forced.float() - want.float()).abs().max().item()
            log(f"flash vs plain: {label} (row kernel forced): max abs err {err:.3e} "
                f"(tol {tol})")
            check(err <= tol, f"flash {label}: row kernel forced: max abs err {err} > {tol}")
            errs["row"] = max(errs["row"], err)

    q, k, v = cases[0][1]
    timings = {"tile": time_flash("tile kernel", q, k, v, flush)}
    q, k, v = cases[5][1]
    timings["tile_f32"] = time_flash("f32 tile kernel", q, k, v, flush)
    timings["row_f32_hd128"] = time_flash("row kernel forced", q, k, v, flush,
                                          kernel="row")
    # gemma heads: the tile kernel's head_dim-256 form (bf16) and the f32
    # tile kernel, each with the row kernel forced beside it
    by_label = {label: qkv_ for label, qkv_, _ in cases}
    q, k, v = by_label["hd256 gemma bf16 causal T=S=2048"]
    timings["tile_hd256"] = time_flash("tile kernel hd256 gemma", q, k, v, flush)
    timings["row_hd256"] = time_flash("row kernel forced hd256 gemma", q, k, v, flush,
                                      kernel="row")
    q, k, v = by_label["hd256 gemma f32 causal T=S=2048"]
    timings["tile_f32_hd256"] = time_flash("f32 tile kernel hd256 gemma", q, k, v, flush)
    timings["row_hd256_f32"] = time_flash("row kernel forced hd256 gemma", q, k, v,
                                          flush, kernel="row")
    # phi-3-mini's heads: the tile kernel's head_dim-96 form and the f32 tile
    # kernel at head_dim 96
    q, k, v = by_label["hd96 phi3 bfloat16 causal T=S=2048"]
    timings["tile_hd96"] = time_flash("tile kernel hd96 phi3", q, k, v, flush)
    q, k, v = by_label["hd96 phi3 float32 causal T=S=2048"]
    timings["tile_f32_hd96"] = time_flash("f32 tile kernel hd96 phi3", q, k, v, flush)
    return errs, timings


# ------------------------------------------------------------ phase 5


# ------------------------------------------------------------ int8-weight GEMM


# llama-3-8b's projections (K, N) and the token counts the roots give them:
# decode (1, 8 rows), the verify chunk at the spec shape (8 x (K+1)) and a
# prefill chunk of the 64-token bucket; with 16, 24, 32 and 48, M holds
# every instantiation the kernel's dispatch picks (1 and 2 token tiles
# staged, 3, 4, 5, 7 and 8 tiles)
GEMM_SHAPES = (("wq", 4096, 4096), ("wk", 4096, 1024), ("w_up", 4096, 14336),
               ("w_down", 14336, 4096))
# every token count the decode kernel takes (1..64: its tile is 8 *
# ceil(M / 8) rows, a wgmma of that width or two or three summed)
GEMM_MS = tuple(range(1, 65))
# the token counts w_up is timed at (every shape at 8)
GEMM_TIMED_MS = (1, 8, 40, 64)
# kernel vs plain version (both on the same bf16 x and int8 weight): the
# kernel rounds once (f32 sum x f32 scale -> bf16), the plain version, the
# JAX formula, rounds the dot, the scale and their product to bf16: each a
# half ulp at most, so they part by at most 2 ulps of an output, and an
# ulp of |y| is at most 2^-7 |y| (bf16 keeps 8 bits): the tolerance is
# 2^-6 of the largest |output|
GEMM_REL_TOL = 2.0 ** -6
# a layer's int8-weight GEMM launches: wq|wk|wv and w_up|w_gate grouped,
# wo and w_down alone
GEMM_LAUNCHES_PER_LAYER = 4


def gemm_launches_per_layer(cfg) -> int:
    """A layer's int8-weight GEMM launches: an MoE layer's experts take the
    expert GEMM, leaving wq|wk|wv and wo."""
    return 2 if cfg.is_moe else GEMM_LAUNCHES_PER_LAYER


def gemm_counts() -> dict:
    from bee2bee_tpu_torch.ops.int8_gemm import int8_weight_matmul

    return {"int8_gemm": int8_weight_matmul.launches,
            "int8_gemm_f32": int8_weight_matmul.f32_launches,
            "int8_gemm_prefill": int8_weight_matmul.prefill_launches,
            "int8_gemm_dequant": int8_weight_matmul.dequant_launches}


def reset_gemm_counts() -> None:
    from bee2bee_tpu_torch.ops.int8_gemm import LAUNCH_COUNTERS, int8_weight_matmul

    for name in LAUNCH_COUNTERS:
        setattr(int8_weight_matmul, name, 0)


def int8_weight(gen, K: int, N: int) -> tuple:
    """A random bf16 [K, N] weight (the init's scale), quantized on the card:
    (weight dict {"q", "s"}, its dense bf16 twin q*s)."""
    from bee2bee_tpu_torch.models.quant import quantize_weight_torch

    w = torch.randn((K, N), generator=gen, device="cuda", dtype=torch.bfloat16)
    w.mul_(1.0 / math.sqrt(K))
    qw = quantize_weight_torch(w)
    dense = (qw["q"].float() * qw["s"]).to(torch.bfloat16)
    return qw, dense


def pack_mm_ms(x, ws, flush, reps: int = 30) -> tuple:
    """``torch._weight_int8pack_mm`` (PyTorch's own int8-weight product, a
    library yardstick the port never calls) over the weights ``ws``
    concatenated on N, at x's inputs: (ms, "<ms> ms (max abs err vs plain
    ...)"), or (None, why it did not run: no CUDA kernel for x's type in
    this torch)."""
    from bee2bee_tpu_torch.ops.int8_gemm import int8_weight_matmul_ref

    try:
        w_nk = torch.cat([w["q"].t() for w in ws]).contiguous()  # [N, K] int8
        s = torch.cat([w["s"] for w in ws]).to(x.dtype)
        y = torch._weight_int8pack_mm(x, w_nk, s)
        ref = torch.cat([int8_weight_matmul_ref(x, w["q"], w["s"]) for w in ws], dim=1)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        ms = cuda_time_ms(lambda: torch._weight_int8pack_mm(x, w_nk, s), flush=flush,
                          reps=reps)
        return ms, f"{ms:.4f} ms (max abs err vs plain {err:.3e})"
    except Exception as e:  # noqa: BLE001 — the op may have no kernel for x's type
        return None, (f"n/a ({type(e).__name__}: {str(e).splitlines()[0][:120]}; torch "
                      f"{torch.__version__})")


def phase_int8_gemm(flush) -> dict:
    """The int8-weight GEMM's decode kernel (csrc/int8_weight_gemm.cu,
    kernel A) against its plain version at llama-3-8b's four projection
    shapes and every M in GEMM_MS (1..64), one launch a call, the same
    bytes twice. Times at M = 8 (and w_up at 1, 40 and 64), median of 30
    with L2 flushed, beside the bound (bytes: the int8 weight, its f32
    scales, x and y once), the plain version, cuBLAS bf16
    ``torch.matmul`` at the dequantized weight (what the bf16 engine pays)
    and ``torch._weight_int8pack_mm`` (PyTorch's own int8-weight op, the
    library yardstick) where the card's torch has a CUDA kernel for it.
    The grouped launches at M = 8. Returns {"err", "timing"} for the
    kernels line (w_up at M = 8)."""
    from bee2bee_tpu_torch.ops.int8_gemm import (
        gemm_plan, int8_weight_matmul, int8_weight_matmul_ref, _sm_count,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    worst = 0.0
    out = {}
    for name, K, N in GEMM_SHAPES:
        w, dense = int8_weight(gen, K, N)
        for M in GEMM_MS:
            plan = gemm_plan(M, K, (N,), _sm_count(0))
            x = torch.randn((M, K), generator=gen, device="cuda", dtype=torch.bfloat16)
            before = int8_weight_matmul.launches
            y = int8_weight_matmul(x, w)
            y2 = int8_weight_matmul(x, w)
            torch.cuda.synchronize()
            launched = int8_weight_matmul.launches - before
            ref = int8_weight_matmul_ref(x, w["q"], w["s"])
            err = (y.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            rel = err / scale
            worst = max(worst, rel)
            timed = (M == 8) or (name == "w_up" and M in GEMM_TIMED_MS)
            if timed or M % 8 == 0:
                exact = (x.float() @ dense.float())  # the f32 product of the same operands
                err_f32 = (y.float() - exact).abs().max().item()
                log(f"int8 GEMM {name} [{K}, {N}] M={M} (plan: tile {plan[0]} rows, "
                    f"{plan[1]} K splits): max abs err vs plain {err:.3e}, relative "
                    f"{rel:.3e} (tol {GEMM_REL_TOL:.3e} of max |y| {scale:.3f}); vs the "
                    f"f32 product {err_f32:.3e}; launches {launched}; same bytes twice "
                    f"{torch.equal(y, y2)}")
            check(bool(torch.isfinite(y).all()), f"int8 GEMM {name} M={M}: non-finite")
            check(rel <= GEMM_REL_TOL, f"int8 GEMM {name} M={M}: relative error {rel}")
            check(launched == 2, f"int8 GEMM {name} M={M}: {launched} launches for 2 calls")
            check(torch.equal(y, y2), f"int8 GEMM {name} M={M}: two calls differ")
            if not timed:
                continue
            nbytes = K * N + 4 * N + 2 * M * K + 2 * M * N
            bnd = bounds(nbytes, 2 * M * K * N, torch.bfloat16)
            ms = cuda_time_ms(lambda: int8_weight_matmul(x, w), flush=flush)
            plain_ms = cuda_time_ms(lambda: int8_weight_matmul_ref(x, w["q"], w["s"]),
                                    flush=flush)
            cublas_ms = cuda_time_ms(lambda: torch.matmul(x, dense), flush=flush)
            library_ms, lib = pack_mm_ms(x, [w], flush)
            log(f"int8 GEMM {name} [{K}, {N}] M={M}: kernel {ms:.4f} ms, "
                f"{bnd['text']} -> {bnd['bound_ms'] / ms:.3f} of bound; plain "
                f"{plain_ms:.4f} ms; cuBLAS bf16 matmul at the dequantized weight "
                f"{cublas_ms:.4f} ms; torch._weight_int8pack_mm {lib}")
            out[(name, M)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd["bound_ms"],
                                  bound_by=bnd["bound_by"], library_ms=library_ms,
                                  cublas_ms=cublas_ms, err=err)
        del w, dense
    # the grouped launch (wq|wk|wv, w_up|w_gate at M = 8): one launch, each
    # output within the tolerance of its plain version
    from bee2bee_tpu_torch.ops.int8_gemm import int8_weight_matmul_group

    for label, K, Ns in (("wq|wk|wv", 4096, (4096, 1024, 1024)),
                         ("w_up|w_gate", 4096, (14336, 14336))):
        pairs = [int8_weight(gen, K, N) for N in Ns]
        ws = [w for w, _ in pairs]
        # what the bf16 engine pays: one cuBLAS product over the
        # concatenated dequantized weights
        dense = torch.cat([d for _, d in pairs], dim=1)
        del pairs
        x = torch.randn((8, K), generator=gen, device="cuda", dtype=torch.bfloat16)
        before = int8_weight_matmul.launches
        ys = int8_weight_matmul_group(x, ws)
        torch.cuda.synchronize()
        launched = int8_weight_matmul.launches - before
        rels = []
        for y, w in zip(ys, ws):
            ref = int8_weight_matmul_ref(x, w["q"], w["s"]).float()
            rels.append((y.float() - ref).abs().max().item() / ref.abs().max().item())
        ms = cuda_time_ms(lambda: int8_weight_matmul_group(x, ws), flush=flush)
        apart = cuda_time_ms(lambda: [int8_weight_matmul(x, w) for w in ws], flush=flush)
        cublas_ms = cuda_time_ms(lambda: torch.matmul(x, dense), flush=flush)
        Nt = sum(Ns)
        bnd = bounds(K * Nt + 4 * Nt + 2 * 8 * K + 2 * 8 * Nt, 2 * 8 * K * Nt, torch.bfloat16)
        lib = pack_mm_ms(x, ws, flush)[1]
        log(f"int8 GEMM grouped {label} M=8: relative errors vs plain "
            f"{[f'{r:.3e}' for r in rels]} (tol {GEMM_REL_TOL:.3e}); launches {launched}; "
            f"{ms:.4f} ms against {apart:.4f} ms for the {len(ws)} launches apart; "
            f"{bnd['text']} -> {bnd['bound_ms'] / ms:.3f} of bound; cuBLAS bf16 matmul at "
            f"the concatenated dequantized [{K}, {Nt}] weight {cublas_ms:.4f} ms; "
            f"torch._weight_int8pack_mm over the concatenated int8 weight {lib}")
        check(launched == 1, f"int8 GEMM grouped {label}: {launched} launches")
        check(max(rels) <= GEMM_REL_TOL, f"int8 GEMM grouped {label}: errors {rels}")
        worst = max(worst, *rels)
        del ws, dense
    torch.cuda.empty_cache()
    log(f"int8 GEMM: worst relative error {worst:.3e} (tol {GEMM_REL_TOL:.3e})")
    return {"err": out[("w_up", 8)]["err"], "timing": out[("w_up", 8)], "all": out}


# the prefill kernel's token counts (a partial last tile at 600) and the
# projections of every family served with int8 weights, each launch as the
# engine makes it (K, the widths of its weights): llama-3-8b's (mixtral-8x7b's
# attention is the same), qwen2-7b's, gemma-3-4b's, phi-3-mini's and
# distilgpt2's (a gelu MLP: w_up alone)
GEMM_PREFILL_MS = (65, 128, 600, 1024, 2048)
GEMM_FAMILY_LAUNCHES = (
    ("llama-3-8b", (("wq|wk|wv", 4096, (4096, 1024, 1024)), ("wo", 4096, (4096,)),
                    ("w_up|w_gate", 4096, (14336, 14336)), ("w_down", 14336, (4096,)))),
    ("qwen2-7b", (("wq|wk|wv", 3584, (3584, 512, 512)), ("wo", 3584, (3584,)),
                  ("w_up|w_gate", 3584, (18944, 18944)), ("w_down", 18944, (3584,)))),
    ("gemma-3-4b", (("wq|wk|wv", 2304, (2048, 1024, 1024)), ("wo", 2048, (2304,)),
                    ("w_up|w_gate", 2304, (9216, 9216)), ("w_down", 9216, (2304,)))),
    ("phi-3-mini", (("wq|wk|wv", 3072, (3072, 3072, 3072)), ("wo", 3072, (3072,)),
                    ("w_up|w_gate", 3072, (8192, 8192)), ("w_down", 8192, (3072,)))),
    ("distilgpt2", (("wq|wk|wv", 768, (768, 768, 768)), ("wo", 768, (768,)),
                    ("w_up", 768, (3072,)), ("w_down", 3072, (768,)))),
)
# the decode kernel's token counts at the other families' shapes (llama's
# run every M in GEMM_MS)
GEMM_FAMILY_MS = (1, 7, 8, 24, 40, 57, 64)


def phase_int8_gemm_families(flush) -> dict:
    """Both bf16 kernels at every launch of every family served with int8
    weights (GEMM_FAMILY_LAUNCHES, the grouped weights in one launch): the
    decode kernel at GEMM_FAMILY_MS, the prefill kernel (kernel B) at
    GEMM_PREFILL_MS. Each case: every output within GEMM_REL_TOL of the
    largest |output| of its plain version, one launch a call of the
    route's counter (``int8_gemm`` or ``int8_gemm_prefill``; the dequantize
    counter reads 0), the same bytes twice. Times at llama-3-8b's w_up|w_gate
    and each launch at M = 2,048 (and w_up|w_gate at every prefill M),
    median of 10 with L2 flushed, beside the bound (2MKN at the bf16 peak;
    bytes the weights, scales, x and y once), the plain version, cuBLAS
    bf16 over the concatenated dequantized weight and
    ``torch._weight_int8pack_mm`` over the concatenated int8 weight.
    Returns {"err", "timing", "all"} (llama's w_up|w_gate at M = 2,048)."""
    from bee2bee_tpu_torch.ops.int8_gemm import int8_weight_matmul_group, int8_weight_matmul_ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 21)
    worst, out, n_cases = 0.0, {}, 0
    for family, launches in GEMM_FAMILY_LAUNCHES:
        for label, K, Ns in launches:
            pairs = [int8_weight(gen, K, N) for N in Ns]
            ws = [w for w, _ in pairs]
            dense = torch.cat([d for _, d in pairs], dim=1)
            del pairs
            Nt = sum(Ns)
            ms_list = GEMM_PREFILL_MS + (GEMM_FAMILY_MS if family != "llama-3-8b" else ())
            for M in ms_list:
                x = torch.randn((M, K), generator=gen, device="cuda", dtype=torch.bfloat16)
                counter = "int8_gemm" if M <= 64 else "int8_gemm_prefill"
                before = gemm_counts()
                ys = int8_weight_matmul_group(x, ws)
                ys2 = int8_weight_matmul_group(x, ws)
                torch.cuda.synchronize()
                after = gemm_counts()
                launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
                rels = []
                for y, w in zip(ys, ws):
                    ref = int8_weight_matmul_ref(x, w["q"], w["s"]).float()
                    rels.append((y.float() - ref).abs().max().item() / ref.abs().max().item())
                worst = max(worst, *rels)
                n_cases += 1
                same = all(torch.equal(a, b) for a, b in zip(ys, ys2))
                check(all(bool(torch.isfinite(y).all()) for y in ys),
                      f"int8 GEMM {family} {label} M={M}: non-finite values")
                check(max(rels) <= GEMM_REL_TOL, f"int8 GEMM {family} {label} M={M}: {rels}")
                check(launched == {counter: 2},
                      f"int8 GEMM {family} {label} M={M}: launches {launched} for 2 calls")
                check(same, f"int8 GEMM {family} {label} M={M}: two calls differ")
                timed = M == 2048 and family == "llama-3-8b" or (
                    family == "llama-3-8b" and label == "w_up|w_gate" and M > 64)
                if not (timed or M in (8, 2048)):
                    continue
                line = (f"int8 GEMM {family} {label} [{K}, {Nt}] M={M}: relative errors vs "
                        f"plain {[f'{r:.3e}' for r in rels]} (tol {GEMM_REL_TOL:.3e}); "
                        f"launches {launched}; same bytes twice {same}")
                if timed:
                    bnd = bounds(K * Nt + 4 * Nt + 2 * M * K + 2 * M * Nt, 2 * M * K * Nt,
                                 torch.bfloat16)
                    ms = cuda_time_ms(lambda: int8_weight_matmul_group(x, ws), flush=flush,
                                      reps=10)
                    plain_ms = cuda_time_ms(
                        lambda: [int8_weight_matmul_ref(x, w["q"], w["s"]) for w in ws],
                        flush=flush, reps=10)
                    cublas_ms = cuda_time_ms(lambda: torch.matmul(x, dense), flush=flush,
                                             reps=10)
                    # PyTorch's op takes about a quarter of a second a call here
                    library_ms, lib = pack_mm_ms(x, ws, flush, reps=3)
                    line += (f"; kernel {ms:.4f} ms, {bnd['text']} -> "
                             f"{bnd['bound_ms'] / ms:.3f} of bound; plain {plain_ms:.4f} ms; "
                             f"cuBLAS bf16 at the concatenated dequantized weight "
                             f"{cublas_ms:.4f} ms; torch._weight_int8pack_mm {lib}")
                    out[(family, label, M)] = dict(
                        ms=ms, plain_ms=plain_ms, bound_ms=bnd["bound_ms"],
                        bound_by=bnd["bound_by"], library_ms=library_ms, cublas_ms=cublas_ms,
                        err=max(rels))
                log(line)
            del ws, dense
        torch.cuda.empty_cache()
    log(f"int8 GEMM families: {n_cases} cases (decode kernel at {GEMM_FAMILY_MS}, prefill "
        f"kernel at {GEMM_PREFILL_MS}), worst relative error {worst:.3e} (tol "
        f"{GEMM_REL_TOL:.3e})")
    key = ("llama-3-8b", "w_up|w_gate", 2048)
    return {"err": out[key]["err"], "timing": out[key], "all": out}


# the GEMM's f32 form (f32 engines with int8 weights): llama-3-8b's four
# projection shapes, qwen2-7b's four and qwen3-8b's two new ones
GEMM_F32_SHAPES = (
    ("llama wq/wo", 4096, 4096), ("llama wk/wv", 4096, 1024),
    ("llama w_up", 4096, 14336), ("llama w_down", 14336, 4096),
    ("qwen2 wq/wo", 3584, 3584), ("qwen2 wk/wv", 3584, 512),
    ("qwen2 w_up", 3584, 18944), ("qwen2 w_down", 18944, 3584),
    ("qwen3 w_up", 4096, 12288), ("qwen3 w_down", 12288, 4096),
)
GEMM_F32_GROUPS = (
    ("llama wq|wk|wv", 4096, (4096, 1024, 1024)), ("llama w_up|w_gate", 4096, (14336, 14336)),
    ("qwen2 wq|wk|wv", 3584, (3584, 512, 512)), ("qwen2 w_up|w_gate", 3584, (18944, 18944)),
    ("qwen3 w_up|w_gate", 4096, (12288, 12288)),
)
# 2xTF32 keeps about 22 of x's 24 bits and the weight exactly; the sums run
# in another order than cuBLAS's f32 product: 1e-4 of the largest |output|
GEMM_F32_REL_TOL = 1e-4


def int8_weight_f32(gen, K: int, N: int) -> tuple:
    """A random f32 [K, N] weight (the init's scale), quantized on the card:
    (weight dict {"q", "s"}, its dense f32 twin q*s)."""
    from bee2bee_tpu_torch.models.quant import quantize_weight_torch

    w = torch.randn((K, N), generator=gen, device="cuda", dtype=torch.float32)
    w.mul_(1.0 / math.sqrt(K))
    qw = quantize_weight_torch(w)
    del w
    dense = qw["q"].float() * qw["s"]
    return qw, dense


def phase_int8_gemm_f32(flush) -> dict:
    """The int8-weight GEMM's f32 form (2xTF32, csrc/int8_weight_gemm.cu)
    against its plain version (the JAX formula in f32, cuBLAS's full-f32
    product) at GEMM_F32_SHAPES and M in GEMM_MS: within GEMM_F32_REL_TOL
    of the largest |output|, one launch a call (counted in
    ``f32_launches``), the same bytes twice; the grouped launches one
    launch each; the M > 64 route (an f32 scratch, cuBLAS f32) at w_up M =
    2048 equal to the plain version, its scratch's bytes equal to the HBM
    ledger's ``int8_dequant_scratch`` for that weight. Times at M =
    8 (llama's w_up also at 1, 40 and 64), medians of 30 with L2 flushed,
    beside the bound (bytes K*N + 4N + 4MK + 4MN; two TF32 products), the
    plain version, cuBLAS f32 over the dense f32 weight and
    ``torch._weight_int8pack_mm`` with f32 activations where it takes
    them. Returns {"err", "timing", "all"} (llama's w_up at M = 8)."""
    from bee2bee_tpu_torch.models.quant import dequant_scratch_bytes
    from bee2bee_tpu_torch.ops.int8_gemm import (
        gemm_plan, int8_weight_matmul, int8_weight_matmul_group, int8_weight_matmul_ref,
        _sm_count,
    )

    check(not torch.backends.cuda.matmul.allow_tf32,
          "int8 GEMM f32: the plain version must run cuBLAS's full-f32 product")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 9)
    worst = 0.0
    out = {}
    for name, K, N in GEMM_F32_SHAPES:
        w, dense = int8_weight_f32(gen, K, N)
        for M in GEMM_MS:
            plan = gemm_plan(M, K, (N,), _sm_count(0))
            x = torch.randn((M, K), generator=gen, device="cuda", dtype=torch.float32)
            before = gemm_counts()
            y = int8_weight_matmul(x, w)
            y2 = int8_weight_matmul(x, w)
            torch.cuda.synchronize()
            after = gemm_counts()
            launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            ref = int8_weight_matmul_ref(x, w["q"], w["s"])
            err = (y - ref).abs().max().item()
            scale = ref.abs().max().item()
            rel = err / scale
            worst = max(worst, rel)
            if M % 8 == 0 or M == 1:
                log(f"int8 GEMM f32 {name} [{K}, {N}] M={M} (plan: tile {plan[0]} rows, "
                    f"{plan[1]} K splits): max abs err vs plain {err:.3e}, relative "
                    f"{rel:.3e} (tol {GEMM_F32_REL_TOL:.0e} of max |y| {scale:.3f}); launches "
                    f"{launched}; same bytes twice {torch.equal(y, y2)}")
            check(y.dtype == torch.float32 and bool(torch.isfinite(y).all()),
                  f"int8 GEMM f32 {name} M={M}: {y.dtype}, non-finite values")
            check(rel <= GEMM_F32_REL_TOL, f"int8 GEMM f32 {name} M={M}: relative error {rel}")
            check(launched == {"int8_gemm_f32": 2},
                  f"int8 GEMM f32 {name} M={M}: launches {launched} for 2 calls")
            check(torch.equal(y, y2), f"int8 GEMM f32 {name} M={M}: two calls differ")
            if not (M == 8 or (name == "llama w_up" and M in GEMM_TIMED_MS)):
                continue
            bnd = bounds(K * N + 4 * N + 4 * M * K + 4 * M * N, 2 * M * K * N,
                         torch.float32, "2xtf32")
            ms = cuda_time_ms(lambda: int8_weight_matmul(x, w), flush=flush)
            plain_ms = cuda_time_ms(lambda: int8_weight_matmul_ref(x, w["q"], w["s"]),
                                    flush=flush)
            cublas_ms = cuda_time_ms(lambda: torch.matmul(x, dense), flush=flush)
            library_ms, lib = pack_mm_ms(x, [w], flush)
            log(f"int8 GEMM f32 {name} [{K}, {N}] M={M}: kernel {ms:.4f} ms, "
                f"{bnd['text']} -> {bnd['bound_ms'] / ms:.3f} of bound; plain "
                f"{plain_ms:.4f} ms; cuBLAS f32 at the dense f32 weight {cublas_ms:.4f} ms; "
                f"torch._weight_int8pack_mm with f32 activations {lib}")
            out[(name, M)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd["bound_ms"],
                                  bound_by=bnd["bound_by"], library_ms=library_ms,
                                  cublas_ms=cublas_ms, err=err)
        del w, dense
    for label, K, Ns in GEMM_F32_GROUPS:
        pairs = [int8_weight_f32(gen, K, N) for N in Ns]
        ws = [w for w, _ in pairs]
        dense = torch.cat([d for _, d in pairs], dim=1)
        del pairs
        x = torch.randn((8, K), generator=gen, device="cuda", dtype=torch.float32)
        before = gemm_counts()["int8_gemm_f32"]
        ys = int8_weight_matmul_group(x, ws)
        torch.cuda.synchronize()
        launched = gemm_counts()["int8_gemm_f32"] - before
        rels = []
        for y, w in zip(ys, ws):
            ref = int8_weight_matmul_ref(x, w["q"], w["s"])
            rels.append((y - ref).abs().max().item() / ref.abs().max().item())
        ms = cuda_time_ms(lambda: int8_weight_matmul_group(x, ws), flush=flush)
        apart = cuda_time_ms(lambda: [int8_weight_matmul(x, w) for w in ws], flush=flush)
        cublas_ms = cuda_time_ms(lambda: torch.matmul(x, dense), flush=flush)
        Nt = sum(Ns)
        bnd = bounds(K * Nt + 4 * Nt + 4 * 8 * K + 4 * 8 * Nt, 2 * 8 * K * Nt,
                     torch.float32, "2xtf32")
        log(f"int8 GEMM f32 grouped {label} M=8: relative errors vs plain "
            f"{[f'{r:.3e}' for r in rels]} (tol {GEMM_F32_REL_TOL:.0e}); launches "
            f"{launched}; {ms:.4f} ms against {apart:.4f} ms for the {len(ws)} launches "
            f"apart; {bnd['text']} -> {bnd['bound_ms'] / ms:.3f} of bound; cuBLAS f32 at "
            f"the concatenated dense [{K}, {Nt}] weight {cublas_ms:.4f} ms; "
            f"torch._weight_int8pack_mm with f32 activations over the concatenated int8 "
            f"weight {pack_mm_ms(x, ws, flush)[1]}")
        check(launched == 1, f"int8 GEMM f32 grouped {label}: {launched} launches")
        check(max(rels) <= GEMM_F32_REL_TOL, f"int8 GEMM f32 grouped {label}: {rels}")
        worst = max(worst, *rels)
        del ws, dense
    # the M > 64 route in f32: the weight dequantized into an f32 scratch,
    # cuBLAS f32, then the scale (the JAX formula); what is left of the
    # dequantize route, counted apart
    name, K, N = GEMM_F32_SHAPES[2]
    w, dense = int8_weight_f32(gen, K, N)
    x = torch.randn((2048, K), generator=gen, device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = gemm_counts()
    y = int8_weight_matmul(x, w)
    torch.cuda.synchronize()
    after = gemm_counts()
    scratch = torch.cuda.max_memory_allocated() - held - y.numel() * 4
    ref = int8_weight_matmul_ref(x, w["q"], w["s"])
    err = (y - ref).abs().max().item()
    ms = cuda_time_ms(lambda: int8_weight_matmul(x, w), flush=flush, reps=10)
    cublas_ms = cuda_time_ms(lambda: torch.matmul(x, dense), flush=flush, reps=10)
    bnd = bounds(K * N + 4 * N + 4 * 2048 * K + 4 * 2048 * N, 2 * 2048 * K * N,
                 torch.float32, "ffma")
    log(f"int8 GEMM f32 {name} M=2048 (the dequantize + cuBLAS f32 route): max abs err "
        f"vs plain {err:.3e}; launches {after['int8_gemm_f32'] - before['int8_gemm_f32']} "
        f"kernel, {after['int8_gemm_dequant'] - before['int8_gemm_dequant']} dequant; "
        f"scratch {scratch} B beside the output (the f32 weight {4 * K * N} B); "
        f"{ms:.4f} ms, {bnd['text']} -> {bnd['bound_ms'] / ms:.3f} of bound; cuBLAS f32 at "
        f"an f32 weight {cublas_ms:.4f} ms; torch._weight_int8pack_mm "
        f"{pack_mm_ms(x, [w], flush, reps=10)[1]}")
    check(after["int8_gemm_dequant"] - before["int8_gemm_dequant"] == 1
          and after["int8_gemm_f32"] == before["int8_gemm_f32"],
          f"int8 GEMM f32 M=2048: launches {before} -> {after}")
    check(err == 0.0, f"int8 GEMM f32 M=2048: the dequant route differs from plain by {err}")
    # the HBM ledger's int8_dequant_scratch for this weight is the scratch
    # measured here
    ledgered = dequant_scratch_bytes({"layers": [{"mlp": {"w_up": w}}]}, torch.float32)
    check(scratch == ledgered,
          f"int8 GEMM f32 M=2048: scratch {scratch} B, the ledger's {ledgered} B")
    del w, dense, x, y, ref
    torch.cuda.empty_cache()
    log(f"int8 GEMM f32: worst relative error {worst:.3e} (tol {GEMM_F32_REL_TOL:.0e})")
    key = ("llama w_up", 8)
    return {"err": out[key]["err"], "timing": out[key], "all": out}


def gemma_attention_config():
    """gemma-2-9b's attention geometry (models/config.py) on the llama
    architecture the port runs, 2 layers: d_model 3584, 16 heads over 8 kv
    heads at head_dim 256 (override), a 4096-key window on every second
    layer, scores capped at 50, score scale 1/sqrt(256); llama-3-8b's
    vocabulary, MLP and norms."""
    from bee2bee_tpu_torch.models.config import get_config

    return replace(get_config("llama-3-8b"), name="llama-gemma-2-9b-attention",
                   n_layers=2, d_model=3584, n_heads=16, n_kv_heads=8,
                   head_dim_override=256, sliding_window=4096, sliding_window_every=2,
                   attn_logit_softcap=50.0)


def forward_setup(cfg=None, n_prompt: int = 300):
    """Phase 5's model and inputs: ``cfg`` (default llama-3-8b at full
    width with 2 layers), f32 weights from SEED, an ``n_prompt``-token
    prompt and the block table for it and 8 greedy decode steps. Returns
    (cfg, params, run): run(attn_fn, pool_dtype, weights, layers, tokens)
    -> (prefill logits, stacked step logits, greedy tokens), ``layers`` the
    depth to cut the model to (default all), ``tokens`` the decode steps'
    inputs (default each step's greedy token: teacher forcing when given)."""
    from bee2bee_tpu_torch.models import core
    from bee2bee_tpu_torch.models.config import get_config
    from bee2bee_tpu_torch.models.params import init_params

    cfg = cfg or replace(get_config("llama-3-8b"), n_layers=2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = init_params(cfg, gen, "cuda", torch.float32)
    BS, n_steps = 16, 8
    nblocks = -(-(n_prompt + n_steps) // BS)
    MB = 1 << (nblocks - 1).bit_length()
    tables = torch.zeros((1, MB), dtype=torch.int32, device="cuda")
    tables[0, :nblocks] = torch.arange(1, nblocks + 1, dtype=torch.int32)
    ids = torch.randint(3, 259, (1, n_prompt), generator=gen, device="cuda")

    def run(attn_fn, pool_dtype=torch.float32, weights=params, layers=None, tokens=None):
        # ``layers``: the model cut to its first ``layers`` layers;
        # ``tokens``: the decode steps' inputs (default: each step's greedy)
        c = cfg if layers is None else replace(cfg, n_layers=layers)
        w = weights if layers is None else dict(weights, layers=weights["layers"][:layers])
        pool = core.init_paged_pool(c, nblocks + 1, BS, pool_dtype, "cuda")
        logits, _ = core.forward(w, c, ids, pool, 0, tables, attn_fn=attn_fn)
        steps = [logits[:, -1]]
        toks = []
        for i in range(n_steps):
            tok = (torch.argmax(steps[-1], dim=-1) if tokens is None
                   else torch.tensor([tokens[i]], device="cuda"))
            toks.append(int(tok))
            lg, _ = core.forward(w, c, tok[:, None], pool, n_prompt + i,
                                 tables, attn_fn=attn_fn)
            steps.append(lg[:, -1])
        return logits, torch.stack(steps), toks

    return cfg, params, run


def forward_device_ms(run, pool_dtype) -> tuple[float, float]:
    """(device busy ms, attention kernels' ms) of one of phase 5's forward
    runs through the kernels the package's dispatch names, under
    torch.profiler (after a warm-up run). It reads no launch counter, so it
    times another tree's package as well: put that tree first on sys.path
    and load this file by its path."""
    from torch.profiler import ProfilerActivity, profile

    from bee2bee_tpu_torch.ops.ragged import ragged_paged_attention

    run(ragged_paged_attention, pool_dtype)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(ragged_paged_attention, pool_dtype)
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(t for _, t in kernels) / 1e3
    attn = sum(t for k, t in kernels if any(n in k for n in ATTENTION_KERNELS)) / 1e3
    return busy, attn


def phase_forward_parity():
    from bee2bee_tpu_torch.ops.ragged import (
        ragged_kernel, ragged_paged_attention, ragged_paged_attention_ref,
    )

    cfg, params, run = forward_setup()
    n_prompt, n_steps = 300, 8
    f32_launches: dict = {}

    def check_f32_launches(tag, int8):
        # the prefill and each decode step through the kernel the rule
        # names for its chunk length and pool form, and no other
        want: dict = {}
        for T, n in ((n_prompt, 1), (1, n_steps)):
            kernel = ragged_kernel(torch.float32, T, cfg.head_dim, int8,
                                   cfg.n_heads // cfg.n_kv_heads)
            counter = RAGGED_COUNTERS[kernel] + ("_int8" if int8 else "")
            want[counter] = want.get(counter, 0) + cfg.n_layers * n
        got = {k: v for k, v in read_counts().items() if v}
        check(got == want, f"{tag}: launches {got}, expected {want}")
        log(f"{tag}: launches {got}")
        f32_launches.update(got)

    reset_counts()
    k_logits, k_steps, k_toks = run(ragged_paged_attention)
    torch.cuda.synchronize()
    check_f32_launches("forward f32 pool", False)
    p_logits, p_steps, p_toks = run(ragged_paged_attention_ref)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(k_logits).all() and torch.isfinite(k_steps).all()),
          "forward: non-finite logits")
    err_prefill = (k_logits - p_logits).abs().max().item()
    err_decode = (k_steps - p_steps).abs().max().item()
    log(f"forward 2x llama-3-8b width f32: prefill {n_prompt} logits max abs err "
        f"{err_prefill:.3e}, decode {n_steps} steps max abs err {err_decode:.3e} "
        f"(tol {FORWARD_TOL}); greedy kernel {k_toks} plain {p_toks}")
    check(max(err_prefill, err_decode) <= FORWARD_TOL,
          f"forward logits differ by {max(err_prefill, err_decode)}")
    check(k_toks == p_toks, f"greedy tokens differ: {k_toks} vs {p_toks}")

    # the same over an int8 pool: both quantize on write with the same
    # torch ops; the kernel reads the int8 pages with their scales
    reset_counts()
    q_logits, q_steps, q_toks = run(ragged_paged_attention, torch.int8)
    torch.cuda.synchronize()
    check_f32_launches("forward f32, int8 pool", True)
    qp_logits, qp_steps, qp_toks = run(ragged_paged_attention_ref, torch.int8)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(q_logits).all() and torch.isfinite(q_steps).all()),
          "int8 forward: non-finite logits")
    q_err = max((q_logits - qp_logits).abs().max().item(),
                (q_steps - qp_steps).abs().max().item())
    gap = max((q_logits - k_logits).abs().max().item(),
              (q_steps - k_steps).abs().max().item())
    log(f"forward 2x llama-3-8b width f32, int8 pool: logits max abs err "
        f"{q_err:.3e} (tol {FORWARD_TOL}); greedy kernel {q_toks} plain {qp_toks}; "
        f"int8-vs-f32 pool logit gap {gap:.3e} (for information), greedy "
        f"tokens {'equal' if q_toks == k_toks else 'differ'} to the f32 pool's")
    check(q_err <= FORWARD_TOL, f"int8 forward logits differ by {q_err}")
    check(q_toks == qp_toks, f"int8 greedy tokens differ: {q_toks} vs {qp_toks}")
    for pool_dtype in (torch.float32, torch.int8):
        busy, attn = forward_device_ms(run, pool_dtype)
        log(f"forward 2x llama-3-8b width f32, {str(pool_dtype)[6:]} pool: device busy "
            f"{busy:.3f} ms for the {n_prompt}-token prefill + {n_steps} decode steps, "
            f"attention kernels {attn:.3f} ms")

    # bf16, where the 300-token prefill goes through the tile kernel (P
    # rounded to bf16, other summation order). Tolerance: the kernels may
    # move the prefill logits no further from the plain bf16 forward than
    # bf16 itself moves the plain forward from the f32 one on the same
    # weights. Greedy tokens may part at bf16 near-ties and are printed.
    bparams = cast_tree(params, torch.bfloat16)
    for pool_dtype, f32_logits in ((torch.bfloat16, p_logits), (torch.int8, qp_logits)):
        tag = f"forward 2x llama-3-8b width bf16, {str(pool_dtype)[6:]} pool"
        tile = "ragged_prefill" + ("_int8" if pool_dtype == torch.int8 else "")
        dec = "ragged_decode" + ("_int8" if pool_dtype == torch.int8 else "")
        reset_counts()
        b_logits, _, b_toks = run(ragged_paged_attention, pool_dtype, bparams)
        torch.cuda.synchronize()
        counts = read_counts()
        check(counts[tile] == cfg.n_layers and counts[dec] == cfg.n_layers * n_steps
              and sum(counts.values()) == cfg.n_layers * (n_steps + 1),
              f"{tag}: launches {counts}: expected the prefill through {tile}, "
              f"the {n_steps} decode steps through {dec}")
        bp_logits, _, bp_toks = run(ragged_paged_attention_ref, pool_dtype, bparams)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(b_logits).all()), f"{tag}: non-finite logits")
        err = (b_logits - bp_logits).abs().max().item()
        tol = (bp_logits - f32_logits).abs().max().item()
        log(f"{tag}: prefill {n_prompt} logits max abs err {err:.3e} (tol {tol:.3e}, "
            f"the plain bf16 forward's gap to the plain f32 forward); launches "
            f"{counts}; greedy kernel {b_toks} plain {bp_toks}")
        check(err <= tol, f"{tag}: logits differ by {err} > {tol}")
    del params, bparams
    torch.cuda.empty_cache()
    return f32_launches


def phase_gemma_geometry_forward() -> dict:
    """Phase 5, head_dim 256: one bf16 forward (300-token prefill, 8 greedy
    decode steps) at gemma-2-9b's attention geometry, over a bf16 pool and
    an int8 pool. Each must launch only the head_dim-256 forms of the tile
    kernel (the prefill) and the decode kernel (the steps) of its pool,
    n_layers times a forward; its prefill logits stay within the plain
    bf16 forward's gap to the plain f32 forward, and its greedy tokens
    equal the plain bf16 forward's. Returns the launch counts per pool,
    zeroed just before and read just after each kernel forward."""
    from bee2bee_tpu_torch.ops.ragged import ragged_paged_attention, ragged_paged_attention_ref

    cfg, params, run = forward_setup(gemma_attention_config())
    n_steps = 8
    bparams = cast_tree(params, torch.bfloat16)
    launches = {}
    for pool_dtype in (torch.bfloat16, torch.int8):
        pool = str(pool_dtype)[6:]
        sfx = "_int8" if pool_dtype == torch.int8 else ""
        tag = f"forward 2x gemma-2-9b attention geometry bf16, {pool} pool"
        f32_logits, _, _ = run(ragged_paged_attention_ref,
                               torch.int8 if sfx else torch.float32)
        reset_counts()
        b_logits, _, b_toks = run(ragged_paged_attention, pool_dtype, bparams)
        torch.cuda.synchronize()
        counts = read_counts()
        launches[pool] = counts
        got = {k: v for k, v in counts.items() if v}
        want = {"ragged_prefill_hd256" + sfx: cfg.n_layers,
                "ragged_decode_hd256" + sfx: cfg.n_layers * n_steps}
        check(got == want, f"{tag}: launches {got}, expected {want}")
        bp_logits, _, bp_toks = run(ragged_paged_attention_ref, pool_dtype, bparams)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(b_logits).all()), f"{tag}: non-finite logits")
        err = (b_logits - bp_logits).abs().max().item()
        tol = (bp_logits - f32_logits).abs().max().item()
        log(f"{tag}: prefill 300 logits max abs err {err:.3e} (tol {tol:.3e}, the "
            f"plain bf16 forward's gap to the plain f32 forward); launches {got}; "
            f"greedy kernel {b_toks} plain {bp_toks}")
        check(err <= tol, f"{tag}: logits differ by {err} > {tol}")
        check(b_toks == bp_toks, f"{tag}: greedy tokens differ: {b_toks} vs {bp_toks}")
    del params, bparams
    torch.cuda.empty_cache()
    return launches


def cast_tree(tree, dtype, device=None):
    """A copy of a parameter tree (dicts, lists, tensors) with its floating
    tensors cast to ``dtype`` (and moved to ``device``); int8 weights are
    shared as they are."""
    from bee2bee_tpu_torch.models.quant import is_quantized

    if is_quantized(tree):
        return tree
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype, device) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree


# ------------------------------------------------------------ phases 6-8


# the port's attention kernels by (part of) name: the ragged kernels (the
# decode kernel's split walk and merge) and the flash kernels, f32 forms too
# the int8-weight GEMM kernel's name in a profile
GEMM_KERNEL = "int8_weight_gemm_kernel"
ATTENTION_KERNELS = ("attention_kernel", "ragged_prefill_kernel", "ragged_decode_",
                     "flash_tile_kernel", "ragged_prefill_f32_kernel",
                     "flash_tile_f32_kernel")


# calls a breakdown's profile averages over (its host wall: 10)
PROFILE_CALLS = 4


def device_profile(fn, calls: int, launches: int, tries: int = 3):
    """(device busy ms per call, attention kernels' ms per call, [(kernel,
    share of device time)] top 4, the int8-weight GEMM's and the expert
    GEMM's kernels' ms per call): the kernels' own device time under
    torch.profiler, summed. Only CUDA activity is recorded (every number
    here reads device events; the CPU ops' bookkeeping of an eager 32-layer
    forward cost seconds a capture), and only after a warm-up step of one
    call, which the profiler discards: a CUDA-only capture that starts
    recording with the calls can lose the first call's first kernels. A
    capture that saw fewer than ``launches`` launches of an attention
    kernel (it has lost some of the calls' kernels) is taken again, up to
    ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        seen = [e.count for e in events if any(n in e.key for n in ATTENTION_KERNELS)]
        if seen and min(seen) >= launches:
            break
        log(f"profile: attention kernel launches seen {seen}, expected {launches} "
            f"each; capture {attempt + 1} of {tries} lost kernels")
    check(bool(seen) and min(seen) >= launches,
          f"the profiler saw {seen} attention launches of {launches}")
    kernels = [(e.key, e.self_device_time_total) for e in events]
    busy_us = sum(t for _, t in kernels)
    check(busy_us > 0, "the profiler saw no device time")
    attn_us = sum(t for k, t in kernels if any(n in k for n in ATTENTION_KERNELS))
    gemm_us = sum(t for k, t in kernels if GEMM_KERNEL in k)
    moe_us = sum(t for k, t in kernels if MOE_KERNEL in k)
    top = sorted(kernels, key=lambda kt: -kt[1])[:4]
    return (busy_us / 1e3 / calls, attn_us / 1e3 / calls,
            [(k[:48], round(t / busy_us, 3)) for k, t in top], gemm_us / 1e3 / calls,
            moe_us / 1e3 / calls)


def step_breakdown(engine, card: str, B=8, ctx=1024, steps=10, prefill=2048, full=True,
                   chunk=False):
    """Where the serving forwards' time goes: a B-row decode step at
    context ``ctx`` and one ``prefill``-token prefill chunk. Host wall time
    (synchronised, profiler off, over ``steps`` calls) beside the device's
    busy time (kernel durations under torch.profiler, over up to
    PROFILE_CALLS calls); 1 - busy/wall is the device's idle share. The decode step three ways: the bare forward, the scheduler's
    decode step run eagerly (forward, greedy sampling, the in-place state
    updates) and the same step replayed from its captured CUDA graph, as
    the served path runs it; and replayed at batch 1 (phase 9's batch).
    Not ``full``: the B-row step replayed from its graph alone, and with
    ``chunk`` the prefill chunk after it."""
    from bee2bee_tpu_torch.models import core

    t_start = time.perf_counter()
    cfg = engine.model_cfg
    BS = engine.engine_cfg.kv_block_size
    nblocks = -(-max(ctx + steps, prefill) // BS)
    pool = core.init_paged_pool(cfg, 1 + B * nblocks, BS, engine.cache_dtype, "cuda")
    tables = (1 + torch.arange(B * nblocks, dtype=torch.int32, device="cuda")
              ).reshape(B, nblocks)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    tok = torch.randint(3, 259, (B, 1), generator=gen, device="cuda")
    off = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    ids = torch.randint(3, 259, (1, prefill), generator=gen, device="cuda")
    last = torch.tensor([prefill - 1], device="cuda")

    def decode():
        engine.forward(tok, pool, off, tables)

    def prefill_chunk():
        engine.forward(ids, pool, 0, tables[:1], logits_index=last)

    sch = engine.scheduler
    kv = engine.engine_cfg.cache_dtype
    if engine.engine_cfg.dtype != "bfloat16":
        kv = f"{engine.engine_cfg.dtype} queries, {kv}"
    steps_of = []
    for rows in (B, 1) if full else (B,):  # at batch 1 too: phase 9's traffic
        key, views, load = decode_state(engine, rows, ctx)
        graph = sch._graphs.get(key) or sch._capture(key)
        label = f"decode step B={rows} ctx={ctx}, scheduler step"
        if rows == B and full:
            steps_of.append((f"{label} eager ({kv} pool)",
                             functools.partial(sch._decode_step, views), steps, load))
        steps_of.append((f"{label} graph-replayed ({kv} pool)", graph.replay, steps,
                         load))
    if full:
        steps_of = [(f"decode step B={B} ctx={ctx} ({kv} pool)", decode, steps, None),
                    *steps_of]
    if full or chunk:
        steps_of.append((f"prefill chunk T={prefill} ({kv} pool)", prefill_chunk, 2, None))
    for label, fn, calls, load in steps_of:
        if load is not None:
            load()
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
        n = min(calls, PROFILE_CALLS)
        busy_ms, attn_ms, top, gemm_ms, moe_ms = device_profile(fn, n, cfg.n_layers * n)
        gemm = (f"; int8-weight GEMM kernels {gemm_ms:.3f} ms a call "
                f"({gemm_ms / busy_ms:.3f} of busy)" if gemm_ms else "")
        if moe_ms:
            gemm += (f"; expert GEMM kernels {moe_ms:.3f} ms a call ({moe_ms / busy_ms:.3f} "
                     f"of busy)")
        log(f"breakdown {label}: host wall {wall_ms:.3f} ms, device busy "
            f"{busy_ms:.3f} ms, device idle share {1 - busy_ms / wall_ms:.3f}; "
            f"attention kernels {attn_ms / cfg.n_layers:.4f} ms per launch "
            f"({attn_ms / busy_ms:.3f} of busy){gemm}; "
            f"top kernels by device time {top}; card {card}")
    weight_bytes = storage_bytes(engine.params)
    # the K and V pages a B-row step at ctx reads in every layer (an int8
    # page with its f32 scale)
    elem = engine.cache_dtype.itemsize
    kv_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * B * (
        ctx * cfg.head_dim * elem + (-(-ctx // BS) * 4 if elem == 1 else 0))
    log(f"breakdown: weights {weight_bytes} B -> "
        f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms per step at "
        f"{HBM_BYTES_PER_S / 1e12} TB/s; KV pages of the B={B} ctx={ctx} step "
        f"{kv_bytes} B -> {kv_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; the breakdown took "
        f"{time.perf_counter() - t_start:.1f} s")


def decode_state(engine, B=8, ctx=1024, sampled_row=None):
    """Put the idle scheduler into a B-row decode state at about ``ctx``
    tokens: bucket B, each row's table over its own pool blocks (the
    table width the scheduler would pick), offsets ctx - (ctx // 32) b, random
    tokens, greedy knobs (``sampled_row`` at temperature 1), the chunk's
    step index 0. Returns (the decode key, its views, a function that
    loads the offsets, tokens and step index again). The pool keeps its
    bytes; the scheduler thread must be idle (nothing queued or active)."""
    sch = engine.scheduler
    check(not sch.active and not sch._inflight and not sch._queue,
          "decode state: the scheduler is not idle")
    K = engine.engine_cfg.decode_chunk
    BS = engine.engine_cfg.kv_block_size
    nb = -(-(ctx + K) // BS)
    tw = sch._table_width(nb)
    sch._resize(B)
    key = (B, tw, False, False, False, sampled_row is not None)
    v = sch._views(key)
    tables = torch.zeros((B, tw), dtype=torch.int32)
    tables[:, :nb] = 1 + torch.arange(B * nb, dtype=torch.int32).reshape(B, nb)
    v.tables.copy_(tables)
    for i, neutral in enumerate((0.0, 1.0, 0.0, 1.0, 0.0, 0.0)):
        sch._d_knobs_f[i, :B] = neutral
    sch._d_top_k[:B] = 0
    if sampled_row is not None:
        sch._d_knobs_f[0, sampled_row] = 1.0
    sch._row_params_dirty = True  # the next dispatch stages its own knobs
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    cur = torch.randint(3, engine.model_cfg.vocab_size, (B,), generator=gen,
                        device="cuda")
    off = torch.tensor([ctx - ctx // 32 * b for b in range(B)], dtype=torch.int32,
                       device="cuda")

    def load():
        v.cur.copy_(cur)
        v.off.copy_(off)
        v.step.zero_()

    load()
    return key, v, load


def graph_vs_eager(engine, tag: str, ctx: int = 1024) -> None:
    """One decode chunk of the scheduler's decode step run eagerly and one
    by replays of its captured graph, from the same state (pool pages and
    an int8 pool's scales over random content, tokens, offsets, tables):
    the greedy tokens and the pool's bytes (and scales) must be equal bit
    for bit, except the null block 0, which the capture's warm-up writes
    and every reader masks. Then two replays of the sampled graph from the
    same state, a row at temperature 1: the greedy rows equal, the sampled
    row's draws different (the generator is registered with the graph, so
    each replay draws fresh noise)."""
    sch = engine.scheduler
    K = engine.engine_cfg.decode_chunk
    pool = sch._cache
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    if engine.kv_quantized:
        for name in ("k", "v"):
            pool[name].copy_(torch.randint(-127, 128, pool[name].shape, generator=gen,
                                           device="cuda", dtype=torch.int8))
            pool[name + "_scale"].copy_(
                torch.rand(pool[name + "_scale"].shape, generator=gen, device="cuda")
                * 0.02)
    else:
        for name in ("k", "v"):
            pool[name].normal_(generator=gen)
    saved = {name: t.clone() for name, t in pool.items()}

    def reload(load):
        for name, t in pool.items():
            t.copy_(saved[name])
        load()

    key, v, load = decode_state(engine, ctx=ctx)
    reload(load)
    for _ in range(K):
        sch._decode_step(v)
    torch.cuda.synchronize()
    # the pool's block axis is 2 in the pages and the scales alike
    eager = (v.toks.clone(), v.cur.clone(), v.off.clone(),
             {n: t[:, :, 1:].clone() for n, t in pool.items()})
    reload(load)
    sch._decode_chunk(key)
    torch.cuda.synchronize()
    same_pool = all(torch.equal(eager[3][n], t[:, :, 1:]) for n, t in pool.items())
    log(f"{tag} graph vs eager: one chunk of {K} steps at B=8 ctx {ctx} key {key}: "
        f"tokens equal {torch.equal(eager[0], v.toks)}, cur/offsets equal "
        f"{torch.equal(eager[1], v.cur) and torch.equal(eager[2], v.off)}, pool bytes "
        f"outside the null block equal {same_pool} ({sorted(pool)})")
    check(torch.equal(eager[0], v.toks), f"{tag}: replayed greedy tokens differ "
          "from the eager chunk's")
    check(torch.equal(eager[1], v.cur) and torch.equal(eager[2], v.off),
          f"{tag}: replayed cur/offsets differ from the eager chunk's")
    check(same_pool, f"{tag}: replayed pool bytes differ from the eager chunk's")
    del eager
    key_s, v_s, load_s = decode_state(engine, ctx=ctx, sampled_row=7)
    draws = []
    for _ in range(2):
        reload(load_s)
        sch._decode_chunk(key_s)
        draws.append(v_s.toks.clone())
    torch.cuda.synchronize()
    differ = int((draws[0][7] != draws[1][7]).sum())
    log(f"{tag} sampled replays (row 7 at temperature 1, key {key_s}): greedy rows "
        f"equal {torch.equal(draws[0][:7], draws[1][:7])}, row 7 differs at "
        f"{differ} of {K} steps")
    check(torch.equal(draws[0][:7], draws[1][:7]),
          f"{tag}: two replays from one state gave different greedy tokens")
    check(differ > 0, f"{tag}: two sampled replays drew the same tokens")
    reload(load)


def random_pool(engine, seed: int) -> dict:
    """Fill the scheduler's pool with random content (an int8 pool's pages
    and scales too); returns a copy to reload it from."""
    pool = engine.scheduler._cache
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    if engine.kv_quantized:
        for name in ("k", "v"):
            pool[name].copy_(torch.randint(-127, 128, pool[name].shape, generator=gen,
                                           device="cuda", dtype=torch.int8))
            pool[name + "_scale"].copy_(
                torch.rand(pool[name + "_scale"].shape, generator=gen, device="cuda")
                * 0.02)
    else:
        for name in ("k", "v"):
            pool[name].normal_(generator=gen)
    return {name: t.clone() for name, t in pool.items()}


def prefill_vs_eager(engine, tag: str) -> None:
    """A prefill chunk of the scheduler's prefill root run eagerly and by a
    replay of its captured graph, from the same state (random pool pages,
    an int8 pool's scales too): a miss (1,000 tokens at offset 0, floor
    0, bucket 1024; where max_seq_len is under 1,144, max_seq_len - 136
    tokens: gpt2's 888) and a hit (104 new tokens after it over the
    first's full blocks, its partial block copied first as a CoW hit
    does, floored there, bucket 128). The last logits and the pool's bytes
    (and scales) outside the null block must be equal bit for bit, and
    each replay must launch the tile kernel the rule names n_layers
    times. Prints the captures (by key, with their seconds)."""
    from bee2bee_tpu_torch.engine.scheduler import copy_block
    from bee2bee_tpu_torch.ops.ragged import ragged_kernel

    sch = engine.scheduler
    cfg = engine.model_cfg
    check(not sch.active and not sch._inflight and not sch._queue,
          f"{tag} prefill vs eager: the scheduler is not idle")
    pool = sch._cache
    saved = random_pool(engine, SEED + 3)
    G = cfg.n_heads // cfg.n_kv_heads
    kernel = RAGGED_COUNTERS[ragged_kernel(engine.dtype, 128, cfg.head_dim,
                                           engine.kv_quantized, G)]
    kernel += "_int8" if engine.kv_quantized else ""
    gen = np.random.default_rng(SEED)
    BS = engine.engine_cfg.kv_block_size
    miss = min(1000, engine.max_seq_len - 136)
    n = miss + 104
    prompt = gen.integers(3, cfg.vocab_size, size=n).tolist()
    full = miss // BS
    donor = np.arange(1, -(-miss // BS) + 1, dtype=np.int32)  # the miss's blocks
    # the hit's CoW copy of the miss's partial block + the blocks after it
    fresh = np.arange(100, 100 + -(-n // BS) - full, dtype=np.int32)
    hit_table = np.zeros(sch._table_width(-(-n // BS)), np.int32)
    hit_table[:full], hit_table[full:full + len(fresh)] = donor[:full], fresh
    miss_table = np.zeros(sch._table_width(len(donor)), np.int32)
    miss_table[:len(donor)] = donor
    cases = (("miss", prompt[:miss], 1024, 0, miss_table, 0, miss),
             ("hit", prompt[miss:], 128, miss, hit_table, miss, n))
    since = graph_stats(engine, tag)
    out = []
    for name, chunk, bucket, pos, table, floor, ceil in cases:
        for t, v in zip(pool.values(), saved.values()):
            t.copy_(v)
        if name == "hit":
            copy_block(pool, int(donor[full]), int(fresh[0]))
        before = {n: t.clone() for n, t in pool.items()}
        key = sch._stage_prefill(chunk, bucket, pos, table, floor, ceil)
        sch._prefill_step(sch._prefill_views(key))
        torch.cuda.synchronize()
        eager = (sch._p_logits.clone(), {n: t[:, :, 1:].clone() for n, t in pool.items()})
        for t, v in zip(pool.values(), before.values()):
            t.copy_(v)
        sch._stage_prefill(chunk, bucket, pos, table, floor, ceil)
        if ("prefill", key) not in sch._graphs:
            sch._capture(key, "prefill")
        c0 = read_counts()
        sch._run_root("prefill", key)
        c1 = read_counts()
        torch.cuda.synchronize()
        launched = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
        same_logits = torch.equal(eager[0], sch._p_logits)
        same_pool = all(torch.equal(eager[1][n], t[:, :, 1:]) for n, t in pool.items())
        out.append((name, key, same_logits, same_pool, launched))
        check(same_logits, f"{tag} prefill vs eager ({name}): replayed logits differ")
        check(same_pool, f"{tag} prefill vs eager ({name}): replayed pool bytes differ")
        check(launched == {kernel: cfg.n_layers},
              f"{tag} prefill vs eager ({name}): a replay launched {launched}")
        del eager, before
    graph_stats(engine, f"{tag} prefill vs eager", since)
    log(f"{tag} prefill graph vs eager: (case, key (bucket, table width), last logits "
        f"equal, pool bytes outside the null block equal ({sorted(pool)}), launches "
        f"per replay) {out}")
    for t, v in zip(pool.values(), saved.values()):
        t.copy_(v)


def verify_vs_eager(engine, tag: str, ctx: int = 1024) -> dict:
    """The verify step of the scheduler's spec_verify root run eagerly and
    by a replay of its captured graph, from the same decode state (B=8 at
    about ``ctx``, random pool, greedy rows): drafts whose first token is
    the row's greedy next token (from a draft-less eager verify) and the
    rest random, lengths 0..K. Tokens, accepted counts, offsets and the
    pool's bytes outside the null block must be equal bit for bit, a
    replay must launch the kernel the rule names n_layers times, and
    (pool in q's type) every drafting row accepts its first draft. Returns
    the accepted counts."""
    sch = engine.scheduler
    cfg = engine.model_cfg
    K = engine.engine_cfg.spec_tokens
    pool = sch._cache
    saved = random_pool(engine, SEED + 4)
    key, v, load = decode_state(engine, ctx=ctx)
    vkey = key + (K,)
    vv = sch._verify_views(vkey)

    def reload():
        for t, s_ in zip(pool.values(), saved.values()):
            t.copy_(s_)
        load()

    reload()
    vv.drafts.zero_()
    vv.lens.zero_()
    sch._verify_step(vv)
    first = vv.cur.clone()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    drafts = torch.randint(3, cfg.vocab_size, vv.drafts.shape, generator=gen, device="cuda")
    drafts[:, 0] = first
    lens = torch.tensor([b % (K + 1) for b in range(vv.lens.shape[0])], dtype=torch.int32,
                        device="cuda")

    def load_verify():
        reload()
        vv.drafts.copy_(drafts)
        vv.lens.copy_(lens)

    load_verify()
    sch._verify_step(vv)
    torch.cuda.synchronize()
    eager = (vv.cur.clone(), vv.acc.clone(), vv.off.clone(),
             {n: t[:, :, 1:].clone() for n, t in pool.items()})
    load_verify()
    if ("spec_verify", vkey) not in sch._graphs:
        sch._capture(vkey, "spec_verify")
    c0, g0, m0 = read_counts(), gemm_counts(), moe_counts()
    sch._run_root("spec_verify", vkey)
    c1, g1, m1 = read_counts(), gemm_counts(), moe_counts()
    torch.cuda.synchronize()
    launched = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
    gemm = {k: g1[k] - g0[k] for k in g1 if g1[k] != g0[k]}
    moe = {k: m1[k] - m0[k] for k in m1 if m1[k] != m0[k]}
    same = [torch.equal(a, b) for a, b in zip(eager[:3], (vv.cur, vv.acc, vv.off))]
    same_pool = all(torch.equal(eager[3][n], t[:, :, 1:]) for n, t in pool.items())
    acc = vv.acc.tolist()
    log(f"{tag} verify graph vs eager: B=8 ctx {ctx} K={K} key {vkey}, lengths "
        f"{lens.tolist()}, accepted {acc}: tokens, accepted, offsets equal {same}, pool "
        f"bytes outside the null block equal {same_pool}; launches per replay {launched}, "
        f"int8-weight GEMM {gemm}, expert GEMM {moe}")
    check(all(same) and same_pool, f"{tag}: the replayed verify step differs from the eager one")
    check(len(launched) == 1 and list(launched.values()) == [cfg.n_layers],
          f"{tag}: a verify replay launched {launched}")
    want_moe = {}
    if cfg.is_moe:
        want_moe = {moe_form(engine.dtype, quantized_experts(engine.params)):
                    MOE_LAUNCHES_PER_LAYER * cfg.n_layers}
    check(moe == want_moe, f"{tag}: a verify replay's expert GEMM launches {moe}, expected "
          f"{want_moe}")
    # position 0's logits see no later position of the chunk, so a first
    # draft equal to the draft-less verify's token is accepted; over an int8
    # pool the chunk's later writes can grow a page's scale and requantize
    # the keys position 0 reads, so there it is only printed
    if not engine.kv_quantized:
        check(all(a >= 1 for a, n in zip(acc, lens.tolist()) if n),
              f"{tag}: a row whose first draft is its greedy token accepted nothing: "
              f"{acc}")
    reload()
    return {"accepted": acc, "launched": launched, "gemm": gemm, "moe": moe}


def ring_check(engine, tag: str, new_tokens: int = 320, burst: bool = True) -> bool:
    """The readback ring on the card: two greedy requests long enough that
    a window is capped at max_inflight_chunks chunks, so a look-ahead
    window chains on the device's own cur and offsets while the host
    reads the one before; served with overlap on and again with it off,
    the bucket held at 8 so both runs replay the same graphs in the same
    order: the same tokens, and fewer stalls than host syncs with overlap
    on, a stall at every sync with it off. Each run logs its admissions
    (scheduler pass, row, bucket, start) and the roots it ran in order
    (root, key, steps). ``burst``: both requests are queued before the
    scheduler's next pass, so both runs admit them in one burst; without
    it (``--ring-repro``) they are sent one after the other, and a
    difference is logged, not failed. Returns whether the tokens agree."""
    from bee2bee_tpu_torch.engine.introspect import (
        _C_HOST_SYNCS, _C_SYNC_STALLS, device_gate,
    )

    sch = engine.scheduler
    check(not sch.active and not sch._inflight, f"{tag} ring: scheduler not idle")
    prompts = [" ".join(["paged", "ring", "window", "token"][i:] * 8) for i in range(2)]
    idle_s, overlap = sch._sticky_idle_s, sch._overlap
    sch._sticky_idle_s = float("inf")
    sch._resize(8)
    runs = {}
    # what the scheduler thread admits and runs, from wrappers of its own
    trace = {"passes": 0, "admits": [], "roots": []}
    real = {n: getattr(sch, n) for n in ("_pass", "_paged_prefill", "_run_root")}

    def counted_pass():
        trace["passes"] += 1
        return real["_pass"]()

    def paged_prefill(req, b, bucket, start, *args, **kw):
        trace["admits"].append((trace["passes"], b, bucket, start))
        return real["_paged_prefill"](req, b, bucket, start, *args, **kw)

    def run_root(root, key, times=1):
        roots = trace["roots"]
        if roots and roots[-1][:2] == [root, key]:
            roots[-1][2] += times
        else:
            roots.append([root, key, times])
        return real["_run_root"](root, key, times)

    sch._pass, sch._paged_prefill, sch._run_root = counted_pass, paged_prefill, run_root
    try:
        for sch._overlap in (True, False):
            s0, t0, w0 = _C_HOST_SYNCS.value(), _C_SYNC_STALLS.value(), sch.stats.windows
            trace.update(passes=0, admits=[], roots=[])
            out: list = [None] * len(prompts)

            def run(i):
                out[i] = engine.generate(prompts[i], max_new_tokens=new_tokens,
                                         temperature=0.0).token_ids

            threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
            t1 = time.perf_counter()
            if burst:
                # both requests queued before the scheduler's next pass, so
                # both runs admit them in one burst: the same rows, table
                # widths and split plans, hence the same bf16 rounding
                with device_gate.transition():
                    for t in threads:
                        t.start()
                    while len(sch._queue) < len(prompts):
                        time.sleep(0.001)
            else:
                for t in threads:
                    t.start()
            for t in threads:
                t.join(timeout=300)
            wall = time.perf_counter() - t1
            while sch._inflight:
                time.sleep(0.01)
            runs[sch._overlap] = (out, _C_HOST_SYNCS.value() - s0,
                                  _C_SYNC_STALLS.value() - t0, sch.stats.windows - w0)
            log(f"{tag} ring (overlap {'on' if sch._overlap else 'off'}, "
                f"{'one admission burst' if burst else 'sent one after the other'}): "
                f"2 greedy requests x {new_tokens} tokens in {wall:.3f} s; "
                f"{runs[sch._overlap][3]} windows, {runs[sch._overlap][1]:.0f} host "
                f"syncs, {runs[sch._overlap][2]:.0f} of them stalls; admissions "
                f"(pass, row, bucket, start) {trace['admits']}; roots in order (root, "
                f"key, steps) {[tuple(r) for r in trace['roots']]}")
    finally:
        sch._sticky_idle_s, sch._overlap = idle_s, overlap
        for n in real:
            delattr(sch, n)
    (on, syncs_on, stalls_on, _), (off, syncs_off, stalls_off, _) = runs[True], runs[False]
    check(all(len(t) == new_tokens for t in on),
          f"{tag} ring: a request stopped early ({[len(t) for t in on]} tokens), so "
          "the ring was not filled")
    first = [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
             for a, b in zip(on, off)]
    if not burst:
        log(f"{tag} ring: overlap on and off gave "
            f"{'the same tokens' if on == off else 'different tokens'}; the first "
            f"differing token of each request {first}")
        return on == off
    check(on == off, f"{tag} ring: overlap on and off gave different tokens (the "
          f"first differing token of each request {first})")
    check(stalls_on < syncs_on, f"{tag} ring: overlap on stalled {stalls_on} of "
          f"{syncs_on} syncs")
    check(stalls_off == syncs_off > 0, f"{tag} ring: overlap off stalled "
          f"{stalls_off} of {syncs_off} syncs")
    return True


def node_profile_rounds(card: str, rounds: int) -> int:
    """``--node-profile N``: the profiler's first start (CUPTI's bring-up,
    which the full run pays in its earlier phases), then phase 9's second
    node N times; each round's profile lines, and each failed check, are
    logged. Returns 1 when a round failed."""
    from bee2bee_tpu_torch.engine.introspect import get_profiler

    get_profiler().capture(0.05)
    log(f"node profile: the first start {get_profiler().last_timings}")
    failed = 0
    for i in range(rounds):
        t0 = time.perf_counter()
        try:
            phase_node_prefix(card)
            log(f"node profile: round {i} passed in {time.perf_counter() - t0:.1f} s")
        except AssertionError as e:
            failed += 1
            log(f"node profile: round {i} FAILED: {e}")
    log(f"card: {card}")
    return 1 if failed else 0


def ring_repro(card: str, rounds: int) -> None:
    """``--ring-repro N``: the bf16 slice's engine (random init from the
    seed), then N ring checks with the two requests sent one after the
    other (the traffic before the one-burst admission), each logging its
    admissions, roots and whether overlap on and off agree, then one ring
    check in one admission burst, which must agree."""
    svc, load_s = load_slice("bfloat16", None, "bfloat16")
    engine = svc.engine
    try:
        log(f"ring repro: {engine.model_cfg.name} loaded in {load_s:.2f} s; card {card}")
        agreed = [ring_check(engine, f"ring repro {i}", burst=False) for i in range(rounds)]
        log(f"ring repro: sent one after the other, overlap on and off agreed in "
            f"{sum(agreed)} of {rounds} rounds")
        ring_check(engine, "ring repro, one burst")
    finally:
        engine.close()


def graph_stats(engine, tag: str, since: dict | None = None) -> dict:
    """The scheduler's decode-graph and readback numbers now; with
    ``since`` (such a snapshot) print and return what moved since."""
    from bee2bee_tpu_torch.engine.introspect import _C_HOST_SYNCS, _C_SYNC_STALLS

    st = engine.scheduler.stats
    now = dict(windows=st.windows, host_syncs=_C_HOST_SYNCS.value(),
               stalls=_C_SYNC_STALLS.value(),
               roots={r: dict(g, keys=dict(g["keys"])) for r, g in st.root_graphs.items()},
               spec_steps=st.spec_steps)
    base = since or dict(windows=0, host_syncs=0.0, stalls=0.0, roots={}, spec_steps=0)

    def key_delta(now_keys, base_keys):
        return {k: (n - base_keys.get(k, (0, 0.0))[0],
                    round(t - base_keys.get(k, (0, 0.0))[1], 4))
                for k, (n, t) in now_keys.items() if n != base_keys.get(k, (0, 0.0))[0]}

    d = {k: now[k] - base[k] for k in now if k != "roots"}
    d["roots"] = {}
    for root in ("prefill", "first_token", "spec_verify", "decode"):
        g, g0 = now["roots"].get(root, {}), base["roots"].get(root, {})
        r = {k: g.get(k, 0) - g0.get(k, 0)
             for k in ("captures", "capture_s", "warmup_s", "setup_forwards", "replays")}
        r["keys"] = key_delta(g.get("keys", {}), g0.get("keys", {}))
        d["roots"][root] = r
    # the decode root's numbers at the top level
    d.update(d["roots"]["decode"])
    if since is not None:
        for root, label in (("prefill", "prefill graphs"),
                            ("first_token", "first-token graphs"),
                            ("spec_verify", "verify graphs")):
            r = d["roots"][root]
            if r["captures"] or r["replays"]:
                log(f"{tag}: {label}: {r['captures']} captures in {r['capture_s']:.3f} s, "
                    f"{r['warmup_s']:.3f} s of it warm-up ({r['setup_forwards']} eager "
                    f"forwards in warm-up and capture), {r['replays']} replays; "
                    f"captures by key: (captures, s) {r['keys']}")
        log(f"{tag}: decode graphs: {d['captures']} captures in "
            f"{d['capture_s']:.3f} s, {d['warmup_s']:.3f} s of it warm-up "
            f"({d['setup_forwards']} eager forwards in warm-up and capture), "
            f"{d['replays']} replays; captures by key (bucket, table "
            f"width, min_p, adapters, counts, sampled): (captures, s) "
            f"{d['keys']}; {d['windows']} windows, {d['host_syncs']:.0f} host syncs, "
            f"{d['stalls']:.0f} of them stalls")
        return d
    return now


def reset_counts():
    from bee2bee_tpu_torch.ops.flash import flash_attention
    from bee2bee_tpu_torch.ops.ragged import LAUNCH_COUNTERS, ragged_paged_attention

    for name in LAUNCH_COUNTERS:
        setattr(ragged_paged_attention, name, 0)
    flash_attention.launches = 0
    flash_attention.tile_launches = 0
    flash_attention.hd256_tile_launches = 0
    flash_attention.f32_tile_launches = 0
    reset_moe_counts()


def read_counts() -> dict:
    from bee2bee_tpu_torch.ops.flash import flash_attention
    from bee2bee_tpu_torch.ops.ragged import ragged_paged_attention

    return {
        "ragged": ragged_paged_attention.launches,
        "ragged_int8": ragged_paged_attention.int8_launches,
        "ragged_prefill": ragged_paged_attention.prefill_launches,
        "ragged_prefill_int8": ragged_paged_attention.int8_prefill_launches,
        "ragged_prefill_f32": ragged_paged_attention.f32_prefill_launches,
        "ragged_prefill_f32_int8": ragged_paged_attention.int8_f32_prefill_launches,
        "ragged_decode": ragged_paged_attention.decode_launches,
        "ragged_decode_int8": ragged_paged_attention.int8_decode_launches,
        "ragged_prefill_hd256": ragged_paged_attention.hd256_prefill_launches,
        "ragged_prefill_hd256_int8": ragged_paged_attention.int8_hd256_prefill_launches,
        "ragged_decode_hd256": ragged_paged_attention.hd256_decode_launches,
        "ragged_decode_hd256_int8": ragged_paged_attention.int8_hd256_decode_launches,
        "ragged_decode_f32": ragged_paged_attention.f32_decode_launches,
        "ragged_decode_f32_int8": ragged_paged_attention.int8_f32_decode_launches,
        "flash": flash_attention.launches,
        "flash_tile": flash_attention.tile_launches,
        "flash_tile_hd256": flash_attention.hd256_tile_launches,
        "flash_tile_f32": flash_attention.f32_tile_launches,
    }


def pool_bytes(engine) -> int:
    return sum(t.numel() * t.element_size()
               for t in engine.scheduler._cache.values())


def load_slice(cache_dtype="bfloat16", params=None, dtype="bfloat16", quantize="none",
               model="llama-3-8b", max_seq_len=2048):
    """CUDAService over ``model`` (llama-3-8b; a registry name or a
    ModelConfig) computing in ``dtype`` at ``max_seq_len`` positions: a
    random init from SEED (with ``quantize="int8"`` quantized on the card
    as it loads), or the given parameters (in ``dtype``; int8 ones already
    packed) shared with another engine (no second init)."""
    from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine
    from bee2bee_tpu_torch.services import CUDAService

    ecfg = EngineConfig(
        max_seq_len=max_seq_len, max_batch=8, kv_block_size=16, decode_chunk=32,
        rng_seed=SEED, dtype=dtype, cache_dtype=cache_dtype, quantize=quantize,
    )
    t0 = time.perf_counter()
    engine = None
    name = model if isinstance(model, str) else model.name
    if params is not None:
        engine = InferenceEngine(model, params=params, engine_config=ecfg)
    svc = CUDAService(name, max_new_tokens=64, engine=engine,
                      engine_config=ecfg).load_sync()
    torch.cuda.synchronize()
    return svc, time.perf_counter() - t0


def storage_bytes(tree) -> int:
    """Device bytes of a tensor tree, each storage once."""
    seen: dict = {}
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        else:
            seen[node.untyped_storage().data_ptr()] = node.untyped_storage().nbytes()
    return sum(seen.values())


def record_dispatches(engine) -> list:
    """(time, positions, ctx, scheduled) of every dispatch the scheduler
    books with the engine's goodput meter from now on."""
    meter = engine.introspect.meter
    book = meter.record_dispatch
    out: list = []

    def recorded(positions, ctx, scheduled):
        out.append((time.time(), positions, ctx, scheduled))
        book(positions, ctx, scheduled=scheduled)

    meter.record_dispatch = recorded
    return out


def check_economics(engine, tag: str, card: str, dispatches: list, wall: float) -> None:
    """The economics plane over one slice's traffic: the ledger's weights
    and KV pool equal their tensors' storage bytes (the pool also its
    geometry's), its int8 dequantize scratch that of the widest projection
    in the engine's dtype (int8 weights only), the device's headroom is in (0, 1); each root's compiles
    equal the scheduler's graph captures of it and nothing stormed;
    MFU x peak over the meter's window equals the FLOPs model over the
    dispatches recorded in that window (within 10%); goodput fraction in
    (0, 1]."""
    from bee2bee_tpu_torch.engine.introspect import FlopsModel
    from bee2bee_tpu_torch.metrics import get_registry

    cfg, ecfg = engine.model_cfg, engine.engine_cfg
    ic = engine.introspect
    snap = ic.refresh()
    now = time.time()
    hbm, comps = snap["hbm"], snap["hbm"]["components"]
    weights, pool = storage_bytes(engine.params), pool_bytes(engine)
    per = cfg.n_layers * cfg.n_kv_heads * engine.pool_blocks
    geometry = (2 * per * ecfg.kv_block_size * cfg.head_dim * engine.cache_dtype.itemsize
                + (2 * per * 4 if engine.kv_quantized else 0))
    check(comps.get("weights") == weights and comps.get("kv_pool") == pool == geometry,
          f"{tag}: ledger {comps} vs weights {weights} B, pool {pool} B "
          f"(geometry {geometry} B)")
    # int8 weights: the dequantize route's scratch at the widest projection,
    # its copy in f32: an f32 engine's prefill chunks wider than 64 tokens
    # take that route; a bf16 engine's run the prefill kernel and hold none
    # (an MoE model's experts take none either: the expert GEMM converts
    # them in registers)
    widest = max(0 if cfg.is_moe else cfg.d_model * cfg.d_ff,
                 cfg.d_model * cfg.n_heads * cfg.head_dim)
    scratch = (widest * 4 if ecfg.quantize == "int8" and engine.dtype == torch.float32
               else None)
    check(comps.get("int8_dequant_scratch") == scratch,
          f"{tag}: ledger's int8 dequantize scratch {comps.get('int8_dequant_scratch')} B, "
          f"expected {scratch} B")
    frac = hbm.get("headroom_frac")
    check(frac is not None and 0.0 < frac < 1.0
          and hbm["bytes_in_use"] >= hbm["accounted_bytes"],
          f"{tag}: HBM ledger {hbm}")
    compiles = snap["compiles"]
    st = engine.scheduler.stats
    captures = {root: g["captures"] for root, g in st.root_graphs.items()}
    check(compiles["decode"]["traces"] == captures["decode"] > 0
          and compiles["prefill"]["traces"] == captures["prefill"] > 0
          and all(compiles[root]["traces"] == n for root, n in captures.items())
          and compiles["cow_copy"]["traces"] == 0
          and not any(v["storms"] for v in compiles.values())
          and not ic.sentinel.storming()
          and not get_registry().get("engine.retrace_storms").total(),
          f"{tag}: compiles {compiles} vs {captures} graph captures")
    g = snap["goodput"]
    fm = FlopsModel(cfg)
    t0 = now - g["window_s"]
    in_window = sum(fm.flops(p, c) for t, p, c, _ in dispatches if t > t0)
    measured = g["mfu"] * snap["peak_flops"] * g["window_s"]
    check(in_window > 0 and abs(measured - in_window) <= 0.10 * in_window,
          f"{tag}: MFU x peak x window {measured:.4e} FLOPs, the FLOPs model over "
          f"the window's dispatches {in_window:.4e}")
    check(0.0 < g["goodput_fraction"] <= 1.0, f"{tag}: goodput {g}")
    total = sum(fm.flops(p, c) for _, p, c, _ in dispatches)
    log(f"{tag}: economics: ledger weights {comps['weights']} B, kv_pool "
        f"{comps['kv_pool']} B, workspace/other {comps.get('workspace_other')} B, "
        f"in use {hbm['bytes_in_use']} of {hbm['bytes_limit']} B, headroom "
        f"{frac}; compiles {compiles}; MFU {g['mfu']} over a {g['window_s']} s "
        f"window (peak {snap['peak_flops']:.4g}), the traffic's {total:.4e} model "
        f"FLOPs over its {wall:.3f} s wall = {total / wall / snap['peak_flops']:.4f} "
        f"of peak; goodput {g['goodput_tokens_per_s']} tok/s, fraction "
        f"{g['goodput_fraction']} ({g['useful_tokens_total']} useful of "
        f"{g['scheduled_tokens_total']} scheduled); card {card}")


SLICE_SIZES = (40, 120, 260, 400, 640, 900, 1200, 1500)


def slice_prompts(sizes=SLICE_SIZES) -> list:
    """Phase 6's prompts: one of each byte length in ``sizes`` (a token a
    byte, plus BOS)."""
    words = ("the paged pool maps every row onto blocks of sixteen tokens "
             "and the kernel reads them through the tables ").split()
    prompts = []
    for n in sizes:
        text, i = "", 0
        while len(text) < n:
            text += words[(i * 7 + n) % len(words)] + " "
            i += 1
        prompts.append(text[:n])
    return prompts


def phase_slice(card: str, cache_dtype="bfloat16", params=None, dtype="bfloat16",
                quantize="none", model="llama-3-8b", light=False, sizes=None,
                max_seq_len=2048):
    """Serve 8 concurrent requests and one stream; the counts are zeroed
    just before and read just after. The bf16 slices (phases 6-7 and the
    int8-weight slices) then run the ring check (not with int8 weights),
    the replayed-vs-eager chunk and the whole breakdown; the f32 slice
    (phase 8) the replayed-vs-eager chunk over the int8 pool and the
    replayed B=8 step's breakdown. With ``quantize="int8"`` the int8-weight
    GEMM's launches are held to the replays (``check_int8_gemm_launches``).
    ``model``: llama-3-8b, or another registry name or ModelConfig (the
    qwen slices); ``light`` runs the replayed-vs-eager decode and prefill
    chunks and the replayed B=8 step's breakdown, and nothing more (no
    ring check, no full breakdown, no logits). ``sizes``: the prompts'
    byte lengths (default ``slice_prompts``'; gpt2's 1,024 positions take
    shorter ones, phi-3's 4,096 longer ones, with ``max_seq_len``). The
    decode chunk replayed against eager and the
    breakdown's step run at a context of 1024, or of the engine's
    max_seq_len less two decode chunks where that is shorter.
    Returns (the launch counts, pool bytes, the engine's params)."""
    from bee2bee_tpu_torch.ops.ragged import ragged_kernel

    int8 = cache_dtype == "int8"
    bf16 = dtype == "bfloat16"
    qw = quantize == "int8"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    svc, load_s = load_slice(cache_dtype, params, dtype, quantize, model, max_seq_len)
    engine = svc.engine
    cfg = engine.model_cfg
    G = cfg.n_heads // cfg.n_kv_heads
    # the kernels the rule names for a decode step and for a prefill chunk
    # (every prefill bucket is 64 tokens or more)
    dec_kernel = ragged_kernel(engine.dtype, 1, cfg.head_dim, int8, G)
    tile_kernel = ragged_kernel(engine.dtype, 64, cfg.head_dim, int8, G)
    suffix = "_int8" if int8 else ""
    dec, tile = RAGGED_COUNTERS[dec_kernel] + suffix, RAGGED_COUNTERS[tile_kernel] + suffix
    tag = f"slice[{cache_dtype} pool]" if bf16 else f"slice[{dtype}, {cache_dtype} pool]"
    if qw:
        tag = (f"slice[int8 weights, {cache_dtype} pool]" if bf16 else
               f"slice[{dtype}, int8 weights, {cache_dtype} pool]")
    if cfg.name != "llama-3-8b":
        tag = f"{cfg.name} {tag}"
    log(f"{tag}: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
        f"loaded ({'shared params' if params is not None else 'random init'}, "
        f"seed {SEED}) in {load_s:.2f} s; {engine.info['n_params']} params")
    kv_meta = svc.get_metadata()["engine"]["kv"]
    check(kv_meta["cache_dtype"] == cache_dtype,
          f"{tag}: metadata kv {kv_meta} does not name the {cache_dtype} pool")
    try:
        prompts = slice_prompts(sizes or SLICE_SIZES)
        ctx = min(1024, engine.max_seq_len - 2 * engine.engine_cfg.decode_chunk)
        knobs = [dict(temperature=0.0)] * 6 + [
            dict(temperature=0.8, top_p=0.9),
            dict(temperature=0.0, repetition_penalty=1.2),
        ]
        results: list = [None] * len(prompts)
        errors: list = []

        def call(i):
            try:
                results[i] = svc.execute(
                    {"prompt": prompts[i], "max_new_tokens": 64, **knobs[i]}
                )
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append((i, repr(e)))

        # the chunk length of every forward the engine runs, to name the
        # kernel each one's attention must launch
        chunks: list = []
        forward = engine.forward

        def counted_forward(tokens, *args, **kw):
            chunks.append(tokens.shape[1])
            return forward(tokens, *args, **kw)

        engine.forward = counted_forward
        # every root run by key: the int8-weight GEMM's route follows the
        # prefill bucket (M = bucket)
        roots_run = record_roots(engine)
        dispatches = record_dispatches(engine)
        since = graph_stats(engine, tag)
        reset_counts()
        reset_gemm_counts()
        engine.forward_calls = 0
        t1 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t1
        check(not any(t.is_alive() for t in threads), "execute calls hung")
        check(not errors, f"execute failed: {errors}")
        stream = list(svc.execute_stream(
            {"prompt": prompts[3], "max_new_tokens": 64, "temperature": 0.0}
        ))
        torch.cuda.synchronize()
        counts = read_counts()
        gemm = gemm_counts()
        moe = moe_counts()
        forwards = engine.forward_calls
        engine.forward = forward
        peak = torch.cuda.max_memory_allocated()
        graphs = graph_stats(engine, tag, since)
        for i, r in enumerate(results):
            check(r is not None and isinstance(r.get("text"), str),
                  f"request {i}: no result")
            check(r["tokens"] > 0, f"request {i}: no tokens")
            log(f"{tag} request {i}: prompt {len(prompts[i])} B / "
                f"{r['prompt_tokens']} tok, {r['tokens']} new, ttft {r['ttft_ms']} ms, "
                f"{r['tokens_per_sec']} tok/s, finish {r['finish_reason']}, "
                f"knobs {knobs[i]}")
        lines = [json.loads(s) for s in stream]
        check(not any(ln.get("status") == "error" for ln in lines),
              f"execute_stream error: {lines}")
        check(lines and lines[-1].get("done") and lines[-1].get("tokens", 0) > 0,
              f"execute_stream ended without a done line: {lines[-1:]}")
        new_tokens = sum(r["tokens"] for r in results)
        # decode window: from the last first-token to the end of the burst
        decode_s = wall - max(r["ttft_ms"] for r in results) / 1e3
        nbytes = pool_bytes(engine)
        log(f"{tag} stream: {len(lines)} lines, {lines[-1]['tokens']} tokens")
        log(f"{tag}: 8 concurrent requests, {new_tokens} tokens in {wall:.3f} s "
            f"-> {new_tokens / wall:.2f} tok/s aggregate incl. prefill, "
            f"{new_tokens - len(results)} decode tokens in {decode_s:.3f} s after "
            f"the last first token -> {(new_tokens - len(results)) / decode_s:.2f} "
            f"decode tok/s; TTFT {min(r['ttft_ms'] for r in results)}-"
            f"{max(r['ttft_ms'] for r in results)} ms; peak memory "
            f"{peak} B; pool {nbytes} B "
            f"({engine.pool_blocks} blocks); card {card}")
        # every prefill chunk and decode step the path served is a graph
        # replay (one forward each, counted back by the replay); the eager
        # forwards are the captures' warm-up and capture steps
        roots = graphs["roots"]
        prefills = roots["prefill"]["replays"]
        eager_prefills = [T for T in chunks if T > 1]
        named = [ragged_kernel(engine.dtype, T, cfg.head_dim, int8, G) for T in eager_prefills]
        decodes = graphs["replays"]
        eager_decodes = sum(T == 1 for T in chunks)
        log(f"{tag}: kernel launches {counts}, forward calls {forwards} "
            f"({prefills} prefill chunks replayed from graphs, whose captures ran "
            f"through the {tile_kernel} kernel; {decodes} decode steps replayed from "
            f"graphs, whose captures ran through the {dec_kernel} kernel; "
            f"{len(eager_prefills)} prefill and {eager_decodes} decode forwards run "
            f"eagerly, all in warm-up and capture; {roots['first_token']['replays']} "
            f"first tokens replayed), n_layers {cfg.n_layers}")
        check(decodes > 0 and prefills > 0,
              f"{tag}: {decodes} decode and {prefills} prefill graph replays")
        check(eager_decodes == graphs["setup_forwards"],
              f"{tag}: {eager_decodes} eager decode forwards, "
              f"{graphs['setup_forwards']} of them in warm-up and capture")
        check(len(eager_prefills) == roots["prefill"]["setup_forwards"]
              and named.count(tile_kernel) == len(eager_prefills),
              f"{tag}: {len(eager_prefills)} eager prefill forwards, "
              f"{roots['prefill']['setup_forwards']} of them in warm-up and capture")
        check(roots["first_token"]["replays"] == len(results) + 1,
              f"{tag}: {roots['first_token']['replays']} first-token replays for "
              f"{len(results) + 1} requests")
        check(forwards == prefills + decodes,
              f"{tag}: {forwards} forwards != {prefills} prefill chunks + "
              f"{decodes} replayed decode steps")
        check(counts[dec] + counts[tile] == cfg.n_layers * forwards,
              f"{tag}: launches {counts[dec]} + {counts[tile]} != {cfg.n_layers} x "
              f"{forwards} forwards")
        check(counts[tile] > 0 and counts[tile] == cfg.n_layers * prefills,
              f"{tag}: tile launches {counts[tile]} != {cfg.n_layers} x {prefills} "
              f"prefill chunks")
        check(counts[dec] > 0 and counts[dec] == cfg.n_layers * decodes,
              f"{tag}: decode launches {counts[dec]} != {cfg.n_layers} x {decodes} "
              f"decode steps")
        others = {k: v for k, v in counts.items() if k not in (dec, tile) and v}
        check(not others, f"{tag}: other kernel forms launched: {others}")
        check_int8_gemm_launches(engine, tag, gemm, roots_run, qw)
        if qw:
            counts.update(gemm)
        check_moe_launches(engine, tag, moe, forwards)
        if cfg.is_moe:
            counts.update(moe)
        check_economics(engine, tag, card, dispatches, wall)
        if bf16 and not qw and not light:
            ring_check(engine, tag)
        if bf16 or int8:
            graph_vs_eager(engine, tag, ctx)
        prefill_vs_eager(engine, tag)
        step_breakdown(engine, card, ctx=ctx, full=bf16 and not light, chunk=cfg.is_moe)
        if light:
            return counts, nbytes, engine.params
        if qw and not int8:
            int8_weight_logits(engine, tag)
        return counts, nbytes, engine.params
    finally:
        engine.close()


def record_roots(engine) -> list:
    """(root, key, times) of every root the scheduler runs from now on."""
    sch = engine.scheduler
    run = sch._run_root
    out: list = []

    def recorded(root, key, times=1):
        out.append((root, key, times))
        return run(root, key, times)

    sch._run_root = recorded
    return out


def check_int8_gemm_launches(engine, tag: str, gemm: dict, roots_run: list,
                             quantized: bool) -> None:
    """With int8 weights every projection of a replayed forward goes
    through the int8-weight GEMM: 4 launches a layer (wq|wk|wv and
    w_up|w_gate grouped, wo, w_down), the decode kernel for a decode or
    verify step and a prefill chunk of at most CROSSOVER_M tokens (the
    bucket) in the engine's type (``int8_gemm_f32`` for f32); wider chunks
    the prefill kernel (bf16, ``int8_gemm_prefill``: a bf16 engine's
    dequantize counter reads 0) or the dequantize + cuBLAS route (f32). An
    MoE layer has no dense MLP: 2 launches a layer (its experts go through
    the expert GEMM). Dense weights launch neither."""
    from bee2bee_tpu_torch.ops.int8_gemm import CROSSOVER_M

    per = gemm_launches_per_layer(engine.model_cfg) * engine.model_cfg.n_layers
    narrow = sum(t for root, key, t in roots_run
                 if root in ("decode", "spec_verify")
                 or (root == "prefill" and key[0] <= CROSSOVER_M))
    wide = sum(t for root, key, t in roots_run
               if root == "prefill" and key[0] > CROSSOVER_M)
    f32 = engine.dtype == torch.float32
    form = "int8_gemm_f32" if f32 else "int8_gemm"
    wide_form = "int8_gemm_dequant" if f32 else "int8_gemm_prefill"
    want = {"int8_gemm": 0, "int8_gemm_f32": 0, "int8_gemm_prefill": 0,
            "int8_gemm_dequant": 0}
    if quantized:
        want.update({form: per * narrow, wide_form: per * wide})
    log(f"{tag}: int8-weight GEMM launches {gemm} ({narrow} replays of <= "
        f"{CROSSOVER_M} tokens, {wide} wider prefill replays; {per} launches a "
        f"forward)")
    check(gemm == want, f"{tag}: int8-weight GEMM launches {gemm}, expected {want}")
    if quantized:
        check(gemm[form] > 0 and gemm[wide_form] > 0,
              f"{tag}: both GEMM routes should have run: {gemm}")


def bf16_weight_bytes(params) -> int:
    """The bytes the same weights take dense in bf16 (an int8 weight
    counted as its [K, N] bf16 twin; the scales not at all)."""
    total = 0
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict) and "q" in node:
            total += 2 * node["q"].numel()
        elif isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, list):
            stack.extend(node)
        else:
            total += 2 * node.numel()
    return total


def logits_run(cfg, ids, new_steps: int = 4):
    """run(params, adapter=None) -> (prefill logits [T, V], step logits
    [new_steps, V], greedy tokens): a whole forward of ``ids`` through the
    kernels the rule names over a fresh pool in the weights' type, then
    greedy steps.
    ``adapter``: (stacks, slot id, scales) of an adapter pool; ``attn_fn``
    the attention op (default: the dispatching one)."""
    from bee2bee_tpu_torch.models import core

    n = len(ids)
    BS = 16
    nblocks = -(-(n + new_steps) // BS)
    MB = 1 << (nblocks - 1).bit_length()
    tables = torch.zeros((1, MB), dtype=torch.int32, device="cuda")
    tables[0, :nblocks] = torch.arange(1, nblocks + 1, dtype=torch.int32)
    tok_ids = torch.tensor([ids], device="cuda")

    def run(params, adapter=None, attn_fn=None):
        # the pool in the forward's type (the embedding's): bf16 or f32
        pool = core.init_paged_pool(cfg, nblocks + 1, BS, params["tok_embed"].dtype,
                                    "cuda")
        kw = {} if attn_fn is None else dict(attn_fn=attn_fn)
        if adapter is not None:
            stacks, slot, scales = adapter
            kw.update(adapters=stacks, adapter_scales=scales,
                      adapter_ids=torch.tensor([slot], device="cuda"))
        logits, _ = core.forward(params, cfg, tok_ids, pool, 0, tables, **kw)
        steps, toks = [], []
        last = logits[:, -1]
        for i in range(new_steps):
            tok = torch.argmax(last, dim=-1)
            toks.append(int(tok))
            lg, _ = core.forward(params, cfg, tok[:, None], pool, n + i, tables, **kw)
            last = lg[:, -1]
            steps.append(last)
        return logits[0], torch.cat(steps) if steps else None, toks

    return run


def _dense(node, dtype):
    from bee2bee_tpu_torch.models.quant import is_quantized

    if is_quantized(node):
        return (node["q"].float() * node["s"]).to(dtype)
    if isinstance(node, dict):
        return {k: _dense(v, dtype) for k, v in node.items()}
    if isinstance(node, list):
        return [_dense(v, dtype) for v in node]
    return node.to(dtype).clone()


def int8_weight_logits(engine, tag: str) -> None:
    """The int8-weight engine's forward (300-token prefill through the
    dequantize route, 4 greedy steps through the kernel) against the bf16
    forward over the dequantized weights q * s: its logits no further from
    that than that is from its f32 twin (phase 5's rule); greedy tokens
    printed."""
    cfg = engine.model_cfg
    gen = np.random.default_rng(SEED + 6)
    ids = gen.integers(3, 259, size=300).tolist()
    run = logits_run(cfg, ids)
    q_pre, q_steps, q_toks = run(engine.params)
    dense = _dense(engine.params, torch.bfloat16)
    b_pre, b_steps, b_toks = run(dense)
    del dense
    torch.cuda.empty_cache()
    dense = _dense(engine.params, torch.float32)
    f_pre, f_steps, f_toks = run(dense)
    del dense
    torch.cuda.empty_cache()
    check(bool(torch.isfinite(q_pre).all() and torch.isfinite(q_steps).all()),
          f"{tag}: non-finite logits")
    def dist(a, b):
        return max((a[0] - b[0]).abs().max().item(), (a[1] - b[1]).abs().max().item())

    # the int8-weight forward and the dense bf16 one are two bf16
    # computations of the same f32 function (weights q * s), rounding in
    # different places (the int8 path never rounds a weight): the int8
    # forward may sit no further from the f32 twin than twice the bf16
    # forward's distance from it (the prefix phase's rule)
    q, b, f = (q_pre, q_steps), (b_pre, b_steps), (f_pre, f_steps)
    err, gap, vs_bf16 = dist(q, f), dist(b, f), dist(q, b)
    log(f"{tag} logits: int8-weight forward (300-token prefill, 4 greedy steps) vs the "
        f"f32 forward over the dequantized weights: max abs {err:.4e} (tol {2 * gap:.4e}, "
        f"twice the bf16 forward's distance {gap:.4e}); vs that bf16 forward "
        f"{vs_bf16:.4e}; greedy int8 {q_toks} bf16 {b_toks} f32 {f_toks}")
    check(err <= 2 * gap, f"{tag}: int8-weight logits {err} from the f32 forward, beyond "
          f"twice the bf16 forward's {gap}")


def phase_int8_weights(card: str) -> dict:
    """The int8-weight slice: llama-3-8b random from SEED, quantized on the
    card as it loads (``quantize="int8"``), served over a bf16 pool and
    over an int8 pool (the same int8 weights), with phase 6's traffic and
    checks plus the int8-weight GEMM's launch identities, the logits
    against the dequantized bf16 forward, and the ledger's weights at most
    0.58x the bf16 engine's. Returns the launch counts (both pools summed)
    and the int8 params."""
    counts, _, params = phase_slice(card, "bfloat16", quantize="int8")
    int8_counts, _, _ = phase_slice(card, "int8", params=params, quantize="int8")
    weights = storage_bytes(params)
    dense = bf16_weight_bytes(params)
    ratio = weights / dense
    log(f"int8 weights: ledger weights {weights} B vs {dense} B for the same weights in "
        f"bf16 -> {ratio:.4f}x (packed int8 + f32 scales + the bf16 embedding and LM "
        f"head)")
    check(ratio <= 0.58, f"int8 weights take {ratio:.4f}x the bf16 weights' bytes")
    for k, v in int8_counts.items():
        counts[k] = counts.get(k, 0) + v
    return {"counts": counts, "params": params}


# ------------------------------------------------------------ qwen phases


# the published config.json of Qwen/Qwen2-7B and Qwen/Qwen3-8B, at the
# values of the repo's presets (models/config.py: max_position_embeddings
# is the preset's max_seq_len); ``family_config`` cuts the depth
QWEN2_CONFIG = {
    "architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2", "hidden_act": "silu",
    "hidden_size": 3584, "intermediate_size": 18944, "num_attention_heads": 28,
    "num_key_value_heads": 4, "num_hidden_layers": 28, "vocab_size": 152064,
    "max_position_embeddings": 32768, "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
    "tie_word_embeddings": False, "use_sliding_window": False, "sliding_window": 131072,
    "max_window_layers": 28, "bos_token_id": 151643, "eos_token_id": 151643,
    "torch_dtype": "bfloat16",
}
QWEN3_CONFIG = {
    "architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3", "hidden_act": "silu",
    "hidden_size": 4096, "intermediate_size": 12288, "num_attention_heads": 32,
    "num_key_value_heads": 8, "num_hidden_layers": 36, "head_dim": 128,
    "vocab_size": 151936, "max_position_embeddings": 40960, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-6, "tie_word_embeddings": False, "attention_bias": False,
    "use_sliding_window": False, "sliding_window": None, "max_window_layers": 36,
    "bos_token_id": 151643, "eos_token_id": 151645, "torch_dtype": "bfloat16",
}
# Qwen3-8B's model card: yarn over the original 32,768 positions, factor 4
QWEN3_YARN = {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 32768}
# google/gemma-2-9b's config.json and google/gemma-3-4b's text config
# (model_type gemma3_text), at the values of the repo's presets
# (models/config.py); gemma-3's local/global pattern as
# ``sliding_window_pattern`` (every 6th layer global), which keeps its
# period when ``family_config`` cuts the depth
GEMMA2_CONFIG = {
    "architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2",
    "hidden_act": "gelu_pytorch_tanh", "hidden_activation": "gelu_pytorch_tanh",
    "hidden_size": 3584, "intermediate_size": 14336, "num_attention_heads": 16,
    "num_key_value_heads": 8, "head_dim": 256, "num_hidden_layers": 42,
    "vocab_size": 256000, "max_position_embeddings": 8192, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-6, "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
    "query_pre_attn_scalar": 256, "sliding_window": 4096, "attention_bias": False,
    "tie_word_embeddings": True, "bos_token_id": 2, "eos_token_id": 1, "pad_token_id": 0,
    "torch_dtype": "float32",
}
GEMMA3_CONFIG = {
    "architectures": ["Gemma3ForCausalLM"], "model_type": "gemma3_text",
    "hidden_activation": "gelu_pytorch_tanh", "hidden_size": 2304,
    "intermediate_size": 9216, "num_attention_heads": 8, "num_key_value_heads": 4,
    "head_dim": 256, "num_hidden_layers": 34, "vocab_size": 262208,
    "max_position_embeddings": 131072, "rope_theta": 1000000.0,
    "rope_local_base_freq": 10000.0, "rope_scaling": {"rope_type": "linear", "factor": 8.0},
    "query_pre_attn_scalar": 256, "sliding_window": 1024, "sliding_window_pattern": 6,
    "rms_norm_eps": 1e-6, "attn_logit_softcapping": None, "final_logit_softcapping": None,
    "tie_word_embeddings": True, "bos_token_id": 2, "eos_token_id": 1, "pad_token_id": 0,
    "torch_dtype": "bfloat16",
}
# openai-community/gpt2's config.json (Conv1D layers, 1,024 learned
# positions) and bigcode/starcoderbase's (model_type gpt_bigcode,
# multi_query: 48 query heads over one kv head, 8,192 positions)
GPT2_CONFIG = {
    "architectures": ["GPT2LMHeadModel"], "model_type": "gpt2", "n_embd": 768,
    "n_layer": 12, "n_head": 12, "n_positions": 1024, "n_ctx": 1024, "vocab_size": 50257,
    "activation_function": "gelu_new", "layer_norm_epsilon": 1e-5, "bos_token_id": 50256,
    "eos_token_id": 50256,
}
STARCODER_CONFIG = {
    "architectures": ["GPTBigCodeForCausalLM"], "model_type": "gpt_bigcode", "n_embd": 6144,
    "n_layer": 40, "n_head": 48, "n_inner": 24576, "n_positions": 8192, "vocab_size": 49152,
    "multi_query": True, "activation_function": "gelu_pytorch_tanh",
    "layer_norm_epsilon": 1e-5, "bos_token_id": 0, "eos_token_id": 0,
    "torch_dtype": "float32",
}
# microsoft/Phi-3-mini-4k-instruct's config.json (model_type phi3: the
# llama branch behind fused qkv_proj / gate_up_proj tensors, a 2,047-token
# window on every layer, 4,096 positions, an untied head)
PHI3_CONFIG = {
    "architectures": ["Phi3ForCausalLM"], "model_type": "phi3", "attention_bias": False,
    "attention_dropout": 0.0, "embd_pdrop": 0.0, "resid_pdrop": 0.0, "hidden_act": "silu",
    "hidden_size": 3072, "intermediate_size": 8192, "num_attention_heads": 32,
    "num_key_value_heads": 32, "num_hidden_layers": 32, "vocab_size": 32064,
    "max_position_embeddings": 4096, "original_max_position_embeddings": 4096,
    "rms_norm_eps": 1e-5, "rope_scaling": None, "rope_theta": 10000.0,
    "sliding_window": 2047, "tie_word_embeddings": False, "initializer_range": 0.02,
    "bos_token_id": 1, "eos_token_id": 32000, "pad_token_id": 32000, "use_cache": True,
    "torch_dtype": "bfloat16",
}
# mistralai/Mixtral-8x7B-v0.1's config.json at the values of the repo's
# preset (models/config.py: rope theta 10,000 and 8,192 positions, where
# the published file has 1e6 and 32,768), and Qwen/Qwen3-30B-A3B's
# (qwen3_moe: 128 experts of width 768, 8 a token, norm_topk_prob, every
# layer sparse)
MIXTRAL_CONFIG = {
    "architectures": ["MixtralForCausalLM"], "model_type": "mixtral", "hidden_act": "silu",
    "hidden_size": 4096, "intermediate_size": 14336, "num_attention_heads": 32,
    "num_key_value_heads": 8, "num_hidden_layers": 32, "num_local_experts": 8,
    "num_experts_per_tok": 2, "vocab_size": 32000, "max_position_embeddings": 8192,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "sliding_window": None,
    "tie_word_embeddings": False, "router_aux_loss_coef": 0.02, "bos_token_id": 1,
    "eos_token_id": 2, "torch_dtype": "bfloat16",
}
QWEN3MOE_CONFIG = {
    "architectures": ["Qwen3MoeForCausalLM"], "model_type": "qwen3_moe", "hidden_act": "silu",
    "hidden_size": 2048, "intermediate_size": 6144, "moe_intermediate_size": 768,
    "num_attention_heads": 32, "num_key_value_heads": 4, "head_dim": 128,
    "num_hidden_layers": 48, "num_experts": 128, "num_experts_per_tok": 8,
    "norm_topk_prob": True, "decoder_sparse_step": 1, "mlp_only_layers": [],
    "vocab_size": 151936, "max_position_embeddings": 40960, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-6, "tie_word_embeddings": False, "attention_bias": False,
    "use_sliding_window": False, "sliding_window": None, "max_window_layers": 48,
    "router_aux_loss_coef": 0.001, "bos_token_id": 151643, "eos_token_id": 151645,
    "torch_dtype": "bfloat16",
}
HF_CONFIGS = {"qwen2-7b": QWEN2_CONFIG, "qwen3-8b": QWEN3_CONFIG,
              "gemma-2-9b": GEMMA2_CONFIG, "gemma-3-4b": GEMMA3_CONFIG,
              "gpt2": GPT2_CONFIG, "starcoder-15b": STARCODER_CONFIG,
              "phi-3-mini": PHI3_CONFIG, "mixtral-8x7b": MIXTRAL_CONFIG,
              "qwen3-30b-a3b": QWEN3MOE_CONFIG}
# the JAX init draws the biases as zeros and the norm scales as ones, which
# would prove nothing about either switch: every qwen and gemma check
# perturbs them
QWEN_BIAS_STD = 0.5
QWEN_NORM_STD = 0.1
# the gpt2 block's layernorm biases: N(0, 0.1)
LN_BIAS_STD = math.sqrt(0.1)


def family_config(which: str, layers: int, yarn: bool = False):
    """The published config.json of ``which`` (a key of HF_CONFIGS) cut to
    ``layers``, parsed as a checkpoint's is (``config_from_hf``); with
    ``yarn`` qwen3's model card's rope scaling. Checked against the repo's
    preset at that depth."""
    from bee2bee_tpu_torch.models.config import config_from_hf, get_config

    depth = "n_layer" if "n_layer" in HF_CONFIGS[which] else "num_hidden_layers"
    d = dict(HF_CONFIGS[which], **{depth: layers}, _name_or_path=f"{which}-{layers}layers")
    if yarn:
        d["rope_scaling"] = QWEN3_YARN
    cfg = config_from_hf(d)
    preset = replace(get_config(which), n_layers=layers, name=cfg.name,
                     rope_scaling=cfg.rope_scaling)
    check(cfg == preset, f"{which}: config.json parses to {cfg}, the preset is {preset}")
    check(not yarn or cfg.rope_scaling[0] == "yarn", f"{which}: no yarn in {cfg}")
    return cfg


def perturb_qwen(params, seed: int):
    """In place: every layer's q/k/v biases drawn N(0, QWEN_BIAS_STD^2) and
    q/k norm scales 1 + N(0, QWEN_NORM_STD^2), on their device and in
    their type. Returns params."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    for lp in params["layers"]:
        a = lp["attn"]
        for key in ("bq", "bk", "bv"):
            if key in a:
                a[key].copy_(torch.randn(a[key].shape, generator=gen, device="cuda")
                             * QWEN_BIAS_STD)
        for key in ("q_norm", "k_norm"):
            if key in a:
                a[key].copy_(1.0 + torch.randn(a[key].shape, generator=gen, device="cuda")
                             * QWEN_NORM_STD)
    return params


def family_params(cfg, dtype, seed: int):
    """A random init of ``cfg`` from ``seed`` on the card, biases and norms
    perturbed (``perturb_qwen``; gemma: ``perturb_norms``; the gpt2 block:
    ``perturb_gpt2``)."""
    from bee2bee_tpu_torch.models.params import init_params

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(cfg, gen, "cuda", dtype)
    if cfg.norm_plus_one:
        return perturb_norms(params, seed + 100)
    if cfg.pos_embedding == "learned":
        return perturb_gpt2(params, seed + 100)
    return perturb_qwen(params, seed + 100)


def perturb_gpt2(params, seed: int):
    """In place: the gpt2 block's biases (q/k/v/o, b_up, b_down) drawn N(0,
    QWEN_BIAS_STD^2), every layernorm scale 1 + N(0, QWEN_NORM_STD^2) and
    its bias N(0, LN_BIAS_STD^2), on their device and in their type: the
    init's zeros and ones would hide a dropped or swapped bias or norm.
    Returns params."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def draw(t, mean, std):
        t.copy_(mean + torch.randn(t.shape, generator=gen, device="cuda") * std)

    norms = [params["final_norm"]] + [lp[k] for lp in params["layers"] for k in ("ln1", "ln2")]
    for n in norms:
        draw(n["scale"], 1.0, QWEN_NORM_STD)
        draw(n["bias"], 0.0, LN_BIAS_STD)
    for lp in params["layers"]:
        for t in (*(lp["attn"][k] for k in ("bq", "bk", "bv", "bo")),
                  lp["mlp"]["b_up"], lp["mlp"]["b_down"]):
            draw(t, 0.0, QWEN_BIAS_STD)
    return params


def perturb_norms(params, seed: int):
    """In place: every norm scale (ln1, ln2, ln1_post, ln2_post, the q/k
    norms, the final norm) drawn 1 + N(0, QWEN_NORM_STD^2), on its device
    and in its type: an all-ones norm would hide a swapped or dropped one.
    Returns params."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    scales = [params["final_norm"]["scale"]]
    for lp in params["layers"]:
        scales += [lp[k]["scale"] for k in ("ln1", "ln2", "ln1_post", "ln2_post") if k in lp]
        scales += [lp["attn"][k] for k in ("q_norm", "k_norm") if k in lp["attn"]]
    for t in scales:
        t.copy_(1.0 + torch.randn(t.shape, generator=gen, device="cuda") * QWEN_NORM_STD)
    return params


def phase_qwen_forward() -> dict:
    """Phase 5 for the qwen families: qwen3-8b (head-wise q/k norms, yarn
    factor 4 over 32,768 positions) and qwen2-7b (q/k/v biases, 28 heads
    over 4 kv heads: G = 7) at full width and 2 layers, random f32 from
    SEED with the biases and norms perturbed: a 300-token prefill and 8
    greedy decode steps through the kernels against the plain version, in
    f32 over an f32 and an int8 pool (logits within FORWARD_TOL, greedy
    tokens equal, each forward through the kernel the rule names for its
    chunk, pool and G, n_layers times), then in bf16 over a bf16 and an
    int8 pool (prefill logits no further from the plain bf16 forward than
    that is from the plain f32 forward; the tile kernel for the prefill,
    the decode kernel for the steps). Returns the launch counts, summed."""
    from bee2bee_tpu_torch.ops.ragged import (
        ragged_kernel, ragged_paged_attention, ragged_paged_attention_ref,
    )

    n_prompt, n_steps = 300, 8
    launches: dict = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    for which, yarn in (("qwen3-8b", True), ("qwen2-7b", False)):
        cfg, params, run = forward_setup(family_config(which, 2, yarn))
        perturb_qwen(params, SEED + 7)
        G = cfg.n_heads // cfg.n_kv_heads
        label = f"forward 2x {which} width (G = {G}, rope_scaling {cfg.rope_scaling})"
        plain_f32 = {}
        for pool_dtype in (torch.float32, torch.int8):
            int8 = pool_dtype == torch.int8
            sfx = "_int8" if int8 else ""
            tag = f"{label} f32, {str(pool_dtype)[6:]} pool"
            want: dict = {}
            for T, n in ((n_prompt, 1), (1, n_steps)):
                c = RAGGED_COUNTERS[ragged_kernel(torch.float32, T, cfg.head_dim, int8, G)]
                want[c + sfx] = want.get(c + sfx, 0) + cfg.n_layers * n
            reset_counts()
            k_logits, k_steps, k_toks = run(ragged_paged_attention, pool_dtype)
            torch.cuda.synchronize()
            got = {k: v for k, v in read_counts().items() if v}
            p_logits, p_steps, p_toks = run(ragged_paged_attention_ref, pool_dtype)
            torch.cuda.synchronize()
            plain_f32[pool_dtype] = p_logits
            check(bool(torch.isfinite(k_logits).all() and torch.isfinite(k_steps).all()),
                  f"{tag}: non-finite logits")
            err = max((k_logits - p_logits).abs().max().item(),
                      (k_steps - p_steps).abs().max().item())
            log(f"{tag}: prefill {n_prompt} + {n_steps} decode steps, logits max abs err "
                f"{err:.3e} (tol {FORWARD_TOL}); launches {got} (expected {want}); greedy "
                f"kernel {k_toks} plain {p_toks}")
            check(got == want, f"{tag}: launches {got}, expected {want}")
            check(err <= FORWARD_TOL, f"{tag}: logits differ by {err}")
            check(k_toks == p_toks, f"{tag}: greedy tokens differ: {k_toks} vs {p_toks}")
            add(got)
        bparams = cast_tree(params, torch.bfloat16)
        for pool_dtype, f32_pool in ((torch.bfloat16, torch.float32), (torch.int8, torch.int8)):
            sfx = "_int8" if pool_dtype == torch.int8 else ""
            tag = f"{label} bf16, {str(pool_dtype)[6:]} pool"
            reset_counts()
            b_logits, _, b_toks = run(ragged_paged_attention, pool_dtype, bparams)
            torch.cuda.synchronize()
            got = {k: v for k, v in read_counts().items() if v}
            want = {"ragged_prefill" + sfx: cfg.n_layers,
                    "ragged_decode" + sfx: cfg.n_layers * n_steps}
            bp_logits, _, bp_toks = run(ragged_paged_attention_ref, pool_dtype, bparams)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(b_logits).all()), f"{tag}: non-finite logits")
            err = (b_logits - bp_logits).abs().max().item()
            tol = (bp_logits - plain_f32[f32_pool]).abs().max().item()
            log(f"{tag}: prefill {n_prompt} logits max abs err {err:.3e} (tol {tol:.3e}, "
                f"the plain bf16 forward's gap to the plain f32 forward); launches {got}; "
                f"greedy kernel {b_toks} plain {bp_toks}")
            check(got == want, f"{tag}: launches {got}, expected {want}")
            check(err <= tol, f"{tag}: logits differ by {err} > {tol}")
            add(got)
        del params, bparams, run
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def phase_qwen_served(card: str) -> dict:
    """qwen3-8b at full width and depth (36 layers), bf16 over a bf16 pool,
    and qwen2-7b at full width and depth (28 layers) with int8 weights
    over an int8 pool (G = 7 through the decode and tile kernels
    and the int8-weight GEMM, the biases added after the GEMM), each a
    random init from SEED with the biases and norms perturbed, serving
    phase 6's traffic with phase 6's checks (every decode step, prefill
    chunk and first token a graph replay, launch counts exact; the GEMM's
    4 x n_layers a replay) and a decode chunk and a prefill chunk replayed
    = eager bit for bit. Returns the launch counts per model."""
    from bee2bee_tpu_torch.models.config import get_config
    from bee2bee_tpu_torch.models.quant import quantize_params_

    out = {}
    cfg3 = get_config("qwen3-8b")
    t0 = time.perf_counter()
    params = family_params(cfg3, torch.bfloat16, SEED)
    torch.cuda.synchronize()
    n = sum(t.numel() for _, t in tree_leaves(params))
    log(f"qwen3-8b: {cfg3.n_layers} layers, {n} parameters ({storage_bytes(params)} B "
        f"bf16), q/k norm scales 1 + N(0, {QWEN_NORM_STD}^2), random from seed {SEED} "
        f"in {time.perf_counter() - t0:.2f} s")
    out["qwen3-8b"] = phase_slice(card, "bfloat16", params=params, model=cfg3,
                                  light=True)[0]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg2 = get_config("qwen2-7b")
    params = quantize_params_(family_params(cfg2, torch.bfloat16, SEED + 1))
    torch.cuda.synchronize()
    log(f"qwen2-7b: {cfg2.n_layers} layers, q/k/v biases N(0, {QWEN_BIAS_STD}^2), int8 "
        f"weights ({storage_bytes(params)} B)")
    out["qwen2-7b"] = phase_slice(card, "int8", params=params, quantize="int8",
                                  model=cfg2, light=True)[0]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ gemma phases


# each preset at full width; depth 2, but 6 for gemma-3-4b, whose first
# five layers of every six are local: 2 layers would run no global layer
# and no global rope. The prompt runs past gemma-3's 1024-token window.
GEMMA_FORWARD_DEPTHS = (("gemma-2b", 2), ("gemma-7b", 2), ("gemma-2-9b", 2),
                        ("gemma-3-4b", 6))
GEMMA_PROMPT = 1100


# an int8 pool amplifies float-rounding differences with depth: a K or V
# value that lands on a rounding boundary of its page's int8 grid flips one
# step, and each flip moves every later layer (gemma-3-4b, 6 layers: 0, 70,
# 769, 2218, 4168 and 5636 of 1,163,264 int8 values of K differ by layer
# between the kernel and the plain forward, and the plain forward with its
# attention output scaled by 1 + 1e-7 moves the logits 5.07e-3, more than
# the kernels' 4.83e-3)
GEMMA_INT8_DEEP = ("; over an int8 pool past 2 layers held instead per attention call "
                   "on the plain forward's inputs and end to end at the first 2 layers")


def gemma_int8_deep(tag: str, run, layers: int) -> None:
    """The f32 forward over an int8 pool of a model deeper than 2 layers:
    every attention call of the plain forward run through the kernel as
    well, on the same pool and inputs, within F32_TOL (the plain result
    carries on, so no int8 flip separates the two); then the model's first
    2 layers, kernel against plain, logits within FORWARD_TOL and greedy
    tokens equal."""
    from bee2bee_tpu_torch.ops.ragged import ragged_paged_attention, ragged_paged_attention_ref

    errs = []

    def shadow(q, kp, vp, *args, **kw):
        want = ragged_paged_attention_ref(q, kp, vp, *args, **kw)
        got = ragged_paged_attention(q, kp, vp, *args, **kw)
        errs.append((got - want).abs().max().item())
        return want

    run(shadow, torch.int8)
    torch.cuda.synchronize()
    log(f"{tag}: each of the {len(errs)} attention calls, kernel against the plain version "
        f"on the plain forward's pool and inputs: max abs err {max(errs):.3e} (tol {F32_TOL})")
    check(max(errs) <= F32_TOL, f"{tag}: an attention call differs by {max(errs)}")
    k_logits, k_steps, k_toks = run(ragged_paged_attention, torch.int8, layers=2)
    p_logits, p_steps, p_toks = run(ragged_paged_attention_ref, torch.int8, layers=2)
    torch.cuda.synchronize()
    err = max((k_logits - p_logits).abs().max().item(), (k_steps - p_steps).abs().max().item())
    log(f"{tag}, its first 2 of {layers} layers: logits max abs err {err:.3e} (tol "
        f"{FORWARD_TOL}); greedy kernel {k_toks} plain {p_toks}")
    check(err <= FORWARD_TOL, f"{tag}, 2 layers: logits differ by {err}")
    check(k_toks == p_toks, f"{tag}, 2 layers: greedy tokens differ: {k_toks} vs {p_toks}")


def phase_gemma_forward() -> dict:
    """Phase 5 for the gemma family: gemma-2b (one kv head: G = 8),
    gemma-7b (G = 1), gemma-2-9b (post-norms, both softcaps, a 4096-key
    window on every second layer) and gemma-3-4b (q/k norms, 1024-key
    windows on 5 layers of 6, the dual rope) at full width
    (GEMMA_FORWARD_DEPTHS), random f32 from SEED with every norm scale
    perturbed: a GEMMA_PROMPT-token prefill and 8 greedy decode steps
    through the kernels against the plain version, in f32 over an f32 and
    an int8 pool (logits within FORWARD_TOL, greedy tokens equal, each
    forward through the kernel the rule names for its chunk, pool and G,
    n_layers times; over an int8 pool past 2 layers ``gemma_int8_deep``
    holds the logits instead), then in bf16 over a bf16 and an int8 pool (the
    head_dim-256 tile form for the prefill and decode form for the steps
    and no other, n_layers times a forward; prefill logits no further from
    the plain bf16 forward, in the relative Frobenius norm, than that is
    from the plain f32 forward, and element by element within that
    forward's largest gap plus one bf16 ulp of the largest logit; greedy
    tokens equal the plain bf16 forward's). Returns the launch counts per
    preset."""
    from bee2bee_tpu_torch.models.config import get_config
    from bee2bee_tpu_torch.ops.ragged import (
        ragged_kernel, ragged_paged_attention, ragged_paged_attention_ref,
    )

    n_prompt, n_steps = GEMMA_PROMPT, 8
    out: dict = {}
    for which, layers in GEMMA_FORWARD_DEPTHS:
        cfg = replace(get_config(which), n_layers=layers, name=f"{which}-{layers}layers")
        cfg, params, run = forward_setup(cfg, n_prompt)
        perturb_norms(params, SEED + 7)
        G = cfg.n_heads // cfg.n_kv_heads
        local = [i for i in range(layers) if cfg.sliding_window
                 and i % cfg.sliding_window_every in cfg.sliding_window_residues]
        label = (f"forward {layers}x {which} width (G = {G}, window {cfg.sliding_window} on "
                 f"layers {local}, local rope theta {cfg.local_rope_theta}, rope_scaling "
                 f"{cfg.rope_scaling}, logit softcap {cfg.logits_softcap})")
        launches: dict = {}
        plain_f32 = {}
        for pool_dtype in (torch.float32, torch.int8):
            int8 = pool_dtype == torch.int8
            sfx = "_int8" if int8 else ""
            tag = f"{label} f32, {str(pool_dtype)[6:]} pool"
            want: dict = {}
            for T, n in ((n_prompt, 1), (1, n_steps)):
                c = RAGGED_COUNTERS[ragged_kernel(torch.float32, T, cfg.head_dim, int8, G)]
                want[c + sfx] = want.get(c + sfx, 0) + cfg.n_layers * n
            reset_counts()
            k_logits, k_steps, k_toks = run(ragged_paged_attention, pool_dtype)
            torch.cuda.synchronize()
            got = {k: v for k, v in read_counts().items() if v}
            p_logits, p_steps, p_toks = run(ragged_paged_attention_ref, pool_dtype)
            torch.cuda.synchronize()
            plain_f32[pool_dtype] = p_logits
            check(bool(torch.isfinite(k_logits).all() and torch.isfinite(k_steps).all()),
                  f"{tag}: non-finite logits")
            err = max((k_logits - p_logits).abs().max().item(),
                      (k_steps - p_steps).abs().max().item())
            log(f"{tag}: prefill {n_prompt} + {n_steps} decode steps, logits max abs err "
                f"{err:.3e} (tol {FORWARD_TOL}{GEMMA_INT8_DEEP if int8 and layers > 2 else ''}); "
                f"launches {got} (expected {want}); greedy kernel {k_toks} plain {p_toks}")
            check(got == want, f"{tag}: launches {got}, expected {want}")
            check(k_toks == p_toks, f"{tag}: greedy tokens differ: {k_toks} vs {p_toks}")
            if int8 and layers > 2:
                gemma_int8_deep(tag, run, layers)
            else:
                check(err <= FORWARD_TOL, f"{tag}: logits differ by {err}")
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
        bparams = cast_tree(params, torch.bfloat16)
        for pool_dtype, f32_pool in ((torch.bfloat16, torch.float32), (torch.int8, torch.int8)):
            sfx = "_int8" if pool_dtype == torch.int8 else ""
            tag = f"{label} bf16, {str(pool_dtype)[6:]} pool"
            reset_counts()
            b_logits, _, b_toks = run(ragged_paged_attention, pool_dtype, bparams)
            torch.cuda.synchronize()
            got = {k: v for k, v in read_counts().items() if v}
            want = {"ragged_prefill_hd256" + sfx: cfg.n_layers,
                    "ragged_decode_hd256" + sfx: cfg.n_layers * n_steps}
            bp_logits, _, bp_toks = run(ragged_paged_attention_ref, pool_dtype, bparams)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(b_logits).all()), f"{tag}: non-finite logits")
            f32_logits = plain_f32[f32_pool]
            # the bf16 head rounds each logit to bf16, so two bf16 forwards'
            # logits part in whole ulps (0.25 at gemma-7b's 47): the kernels'
            # distance is held in the norm, and element by element to the
            # bf16 gap plus one ulp of the largest logit
            rel = ((b_logits - bp_logits).norm() / bp_logits.norm()).item()
            rel_tol = ((bp_logits - f32_logits).norm() / f32_logits.norm()).item()
            err = (b_logits - bp_logits).abs().max().item()
            gap = (bp_logits - f32_logits).abs().max().item()
            ulp = 2.0 ** (math.floor(math.log2(bp_logits.abs().max().item())) - 7)
            log(f"{tag}: prefill {n_prompt} logits relative (Frobenius) err {rel:.3e} (tol "
                f"{rel_tol:.3e}, the plain bf16 forward's relative gap to the plain f32 "
                f"forward), max abs err {err:.3e} (tol {gap:.3e} + one bf16 ulp of the "
                f"largest logit, {ulp}); launches {got}; greedy kernel {b_toks} plain {bp_toks}")
            check(got == want, f"{tag}: launches {got}, expected {want}")
            check(rel <= rel_tol, f"{tag}: logits differ by {rel} > {rel_tol} (relative)")
            check(err <= gap + ulp, f"{tag}: logits differ by {err} > {gap} + {ulp}")
            check(b_toks == bp_toks, f"{tag}: greedy tokens differ: {b_toks} vs {bp_toks}")
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
        out[which] = launches
        del params, bparams, run, plain_f32
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_gemma_served(card: str) -> dict:
    """gemma-2-9b at full width and depth (42 layers), bf16 over a bf16
    pool, and gemma-3-4b at full width and depth (34 layers) with its
    weights quantized to int8 on the card, over an int8 pool (the GEMM at
    gemma-3's shapes, the int8 pool's head_dim-256 forms), each a random
    init from SEED with every norm scale perturbed, serving phase 6's
    traffic with phase 6's checks (every decode step, prefill chunk and
    first token a graph replay, launch counts exact; the GEMM's 4 x
    n_layers a replay) and a decode chunk and a prefill chunk replayed =
    eager bit for bit. Returns the launch counts per model."""
    from bee2bee_tpu_torch.models.config import get_config
    from bee2bee_tpu_torch.models.quant import quantize_params_

    out = {}
    cfg9 = get_config("gemma-2-9b")
    t0 = time.perf_counter()
    params = family_params(cfg9, torch.bfloat16, SEED)
    torch.cuda.synchronize()
    n = sum(t.numel() for _, t in tree_leaves(params))
    log(f"gemma-2-9b: {cfg9.n_layers} layers, {n} parameters ({storage_bytes(params)} B "
        f"bf16), norm scales 1 + N(0, {QWEN_NORM_STD}^2), random from seed {SEED} in "
        f"{time.perf_counter() - t0:.2f} s; its {cfg9.sliding_window}-token window cannot "
        f"bind at the slice's max_seq_len 2048 (the kernels get it on layers 0, 2, ...)")
    out["gemma-2-9b"] = phase_slice(card, "bfloat16", params=params, model=cfg9,
                                    light=True)[0]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg3 = get_config("gemma-3-4b")
    params = family_params(cfg3, torch.bfloat16, SEED + 1)
    n = sum(t.numel() for _, t in tree_leaves(params))
    params = quantize_params_(params)
    torch.cuda.synchronize()
    log(f"gemma-3-4b: {cfg3.n_layers} layers, {n} parameters, int8 weights quantized on "
        f"the card ({storage_bytes(params)} B); its {cfg3.sliding_window}-token window "
        f"binds on the prompts of 1,200 and 1,500 tokens (5 layers of every 6)")
    out["gemma-3-4b"] = phase_slice(card, "int8", params=params, quantize="int8",
                                    model=cfg3, light=True)[0]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ gpt2 phases


# gpt2's widths (distilgpt2's) and starcoder-15b's, 2 layers each; the
# prompt and 8 steps stay inside gpt2's 1,024 learned positions
GPT2_FORWARD = ("gpt2", "starcoder-15b")
GPT2_PROMPT = 600
# phase 6's prompt lengths cut so that each, with its 64 new tokens, fits
# gpt2's 1,024 positions untruncated
GPT2_SIZES = (40, 120, 260, 400, 520, 640, 760, 900)


def family_forward(label: str, cfg, n_prompt: int, perturb,
                   int8_experts: bool = False, int8_pool_per_call: bool = False) -> dict:
    """Phase 5 for one model at full width, ``cfg`` cut in depth: random f32
    from SEED, perturbed in place by ``perturb(params, seed)``; an
    ``n_prompt``-token prefill and 8 greedy decode steps through the kernels
    against the plain version, in f32 over an f32 and an int8 pool (logits
    within FORWARD_TOL, greedy tokens equal, each forward through the kernel
    the rule names for its chunk, pool and G, n_layers times), then in bf16
    over a bf16 and an int8 pool (the same launch rule; prefill logits no
    further from the plain bf16 forward, in the relative Frobenius norm,
    than that is from the plain f32 forward; greedy tokens equal the plain
    bf16 forward's). An MoE model's plain forward runs the expert product's
    plain version too, and each kernel forward launches the expert GEMM's
    form for its type twice a layer of every forward; ``int8_experts``:
    then the f32 forward over an f32 pool with the experts int8 (the f32
    x, int8 experts form) against its plain version.
    ``int8_pool_per_call`` (MOE_INT8_POOL_PER_CALL): over an int8 pool the
    2-layer f32 logits are held per call and at one layer instead
    (``moe_int8_pool_forward``), and the bf16 greedy tokens per call and
    teacher-forced instead (``moe_calls_on_plain_inputs``,
    ``moe_bf16_steps``). Returns the launch counts."""
    from bee2bee_tpu_torch.ops.ragged import (
        ragged_kernel, ragged_paged_attention, ragged_paged_attention_ref,
    )

    n_steps = 8
    cfg, params, run = forward_setup(cfg, n_prompt)
    perturb(params, SEED + 7)
    G = cfg.n_heads // cfg.n_kv_heads

    def named(dtype, int8):  # the launches the rule names for one forward run
        want: dict = {}
        for T, n in ((n_prompt, 1), (1, n_steps)):
            c = RAGGED_COUNTERS[ragged_kernel(dtype, T, cfg.head_dim, int8, G)]
            c += "_int8" if int8 else ""
            want[c] = want.get(c, 0) + cfg.n_layers * n
        return want

    def moe_named(dtype, int8_w=False):  # the expert GEMM's, every forward
        if not cfg.is_moe:
            return {}
        return {moe_form(dtype, int8_w): MOE_LAUNCHES_PER_LAYER * cfg.n_layers * (1 + n_steps)}

    def moe_got():
        return {k: v for k, v in moe_counts().items() if v}

    launches: dict = {}
    plain_f32 = {}
    for pool_dtype in (torch.float32, torch.int8):
        int8 = pool_dtype == torch.int8
        tag = f"{label} f32, {str(pool_dtype)[6:]} pool"
        want = named(torch.float32, int8)
        reset_counts()
        k_logits, k_steps, k_toks = run(ragged_paged_attention, pool_dtype)
        torch.cuda.synchronize()
        got = {k: v for k, v in read_counts().items() if v}
        got_moe = moe_got()
        with plain_experts():
            p_logits, p_steps, p_toks = run(ragged_paged_attention_ref, pool_dtype)
        torch.cuda.synchronize()
        plain_f32[pool_dtype] = p_logits
        check(bool(torch.isfinite(k_logits).all() and torch.isfinite(k_steps).all()),
              f"{tag}: non-finite logits")
        err = max((k_logits - p_logits).abs().max().item(),
                  (k_steps - p_steps).abs().max().item())
        log(f"{tag}: prefill {n_prompt} + {n_steps} decode steps, logits max abs err "
            f"{err:.3e} (tol {FORWARD_TOL}); launches {got} (expected {want}); greedy "
            f"kernel {k_toks} plain {p_toks}")
        check(got == want, f"{tag}: launches {got}, expected {want}")
        check(got_moe == moe_named(torch.float32),
              f"{tag}: expert GEMM launches {got_moe}, expected {moe_named(torch.float32)}")
        if int8 and int8_pool_per_call:
            # the int8 pool's rounding flips carry any 1e-6 difference of
            # layer 0 into layer 1's pages: held per call and at 1 layer
            # (``moe_int8_pool_forward``); the 2-layer gap is printed above
            moe_int8_pool_forward(tag, run, params)
        else:
            check(err <= FORWARD_TOL, f"{tag}: logits differ by {err}")
        check(k_toks == p_toks, f"{tag}: greedy tokens differ: {k_toks} vs {p_toks}")
        for k, v in {**got, **got_moe}.items():
            launches[k] = launches.get(k, 0) + v
    if int8_experts:
        launches.update(moe_int8_experts_forward(label, cfg, params, run, n_steps))
    bparams = cast_tree(params, torch.bfloat16)
    for pool_dtype, f32_pool in ((torch.bfloat16, torch.float32), (torch.int8, torch.int8)):
        tag = f"{label} bf16, {str(pool_dtype)[6:]} pool"
        want = named(torch.bfloat16, pool_dtype == torch.int8)
        reset_counts()
        b_logits, _, b_toks = run(ragged_paged_attention, pool_dtype, bparams)
        torch.cuda.synchronize()
        got = {k: v for k, v in read_counts().items() if v}
        got_moe = moe_got()
        with plain_experts():
            bp_logits, bp_steps, bp_toks = run(ragged_paged_attention_ref, pool_dtype, bparams)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(b_logits).all()), f"{tag}: non-finite logits")
        f32_logits = plain_f32[f32_pool]
        rel = ((b_logits - bp_logits).norm() / bp_logits.norm()).item()
        rel_tol = ((bp_logits - f32_logits).norm() / f32_logits.norm()).item()
        log(f"{tag}: prefill {n_prompt} logits relative (Frobenius) err {rel:.3e} (tol "
            f"{rel_tol:.3e}, the plain bf16 forward's relative gap to the plain f32 "
            f"forward), max abs err {(b_logits - bp_logits).abs().max().item():.3e}; "
            f"launches {got}; greedy kernel {b_toks} plain {bp_toks}")
        check(got == want, f"{tag}: launches {got}, expected {want}")
        check(got_moe == moe_named(torch.bfloat16),
              f"{tag}: expert GEMM launches {got_moe}, expected {moe_named(torch.bfloat16)}")
        check(rel <= rel_tol, f"{tag}: logits differ by {rel} > {rel_tol} (relative)")
        if pool_dtype == torch.int8 and int8_pool_per_call:
            moe_calls_on_plain_inputs(tag, run, bparams, KERNEL_TOL, MOE_REL_TOL)
            moe_bf16_steps(tag, run, bparams, params, pool_dtype, f32_pool, b_toks, bp_steps,
                           bp_toks)
        else:
            check(b_toks == bp_toks, f"{tag}: greedy tokens differ: {b_toks} vs {bp_toks}")
        for k, v in {**got, **got_moe}.items():
            launches[k] = launches.get(k, 0) + v
    del params, bparams, run, plain_f32
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_gpt2_forward() -> dict:
    """Phase 5 for the gpt2 block (``family_forward``): gpt2 (12 heads of
    64, G = 1) and starcoder-15b (48 heads of 128 over one kv head, G = 48)
    at full width and 2 layers, every bias, layernorm scale and layernorm
    bias perturbed, a GPT2_PROMPT-token prefill (at G = 48 the f32 tile form
    takes the f32 decode steps too). Returns the launch counts per model."""
    from bee2bee_tpu_torch.models.config import get_config

    out: dict = {}
    for which in GPT2_FORWARD:
        cfg = replace(get_config(which), n_layers=2, name=f"{which}-2layers")
        label = (f"forward 2x {which} width (G = {cfg.n_heads // cfg.n_kv_heads}, "
                 f"head_dim {cfg.head_dim})")
        out[which] = family_forward(label, cfg, GPT2_PROMPT, perturb_gpt2)
    return out


def phase_gpt2_spec(card: str) -> dict:
    """gpt2 (12 layers, hd 64) in f32 over an f32 pool with the model draft
    tier: distilgpt2 (the same 50,257-token vocabulary; random f32 from
    the drafter seed) drafting K = SPEC_K for 8 prompts without n-gram
    repeats, 64 greedy tokens each, concurrently. The tokens equal the
    spec-off engine's (8 x 64); every verify and decode replay launches
    ``decode_f32`` n_layers times (G T = 5 rows), every prefill replay the
    f32 tile form; the draft and prime roots are captured once each.
    Returns the launch counts."""
    from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine
    from bee2bee_tpu_torch.models.config import get_config

    tag = "gpt2 spec[model tier: distilgpt2, float32, float32 pool]"
    cfg = get_config("gpt2")
    params = family_params(cfg, torch.float32, SEED)

    def engine(**spec):
        ecfg = EngineConfig(max_seq_len=2048, max_batch=8, kv_block_size=16,
                            decode_chunk=32, rng_seed=SEED, dtype="float32",
                            cache_dtype="float32", **spec)
        return InferenceEngine(cfg, params=params, engine_config=ecfg)

    off = engine()
    prompts = spec_prompts(off.tokenizer, periodic=False)
    try:
        want, wall_off = spec_burst(off, prompts)
    finally:
        off.close()
    del off
    gc.collect()
    eng = engine(spec_tokens=SPEC_K, spec_probe_tokens=SPEC_K, drafter="distilgpt2")
    try:
        dm = eng.drafter_model
        since = graph_stats(eng, tag)
        reset_counts()
        got, wall = spec_burst(eng, prompts)
        torch.cuda.synchronize()
        counts = read_counts()
        n = spec_counts(eng, tag, since, counts)
        model = eng.scheduler.stats.spec_tiers.get("model", {"drafted": 0, "accepted": 0})
        equal = sum(a == b for a, b in zip(got, want))
        L = cfg.n_layers
        log(f"{tag}: drafter {dm.cfg.name} ({dm.cfg.n_layers} layers); 8 x {SPEC_NEW} greedy "
            f"tokens in {wall:.3f} s (spec off {wall_off:.3f} s); {equal} of 8 rows equal to "
            f"the spec-off engine's; model tier drafted {model['drafted']}, accepted "
            f"{model['accepted']}; draft root runs {dm.runs}, captures (n, s) "
            f"{dm.captures}; card {card}")
        check(equal == len(prompts) and all(len(t) == SPEC_NEW for t in got),
              f"{tag}: spec-on tokens differ from spec-off: "
              f"{[(a[:8], b[:8]) for a, b in zip(got, want) if a != b][:2]}")
        check(model["drafted"] > 0, f"{tag}: the model tier never drafted")
        check(dm.captures["draft"][0] == 1 and dm.captures["draft_prime"][0] == 1,
              f"{tag}: draft/prime captures {dm.captures}")
        check(counts["ragged_decode_f32"] == L * (n["verifies"] + n["decodes"])
              and counts["ragged_prefill_f32"] == L * n["prefills"],
              f"{tag}: launches {counts} vs {L} x ({n['verifies']} verify + {n['decodes']} "
              f"decode, {n['prefills']} prefill) replays")
        others = {k: v for k, v in counts.items()
                  if k not in ("ragged_decode_f32", "ragged_prefill_f32") and v}
        check(not others, f"{tag}: other kernel forms launched: {others}")
        return counts
    finally:
        eng.close()
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()


def phase_gpt2_served(card: str) -> dict:
    """distilgpt2 at full depth (6 layers, 12 heads of 64) in bf16 over a
    bf16 pool and with int8 weights over an int8 pool (the GEMM at K =
    768), gpt2 in f32 drafted by distilgpt2 (``phase_gpt2_spec``), and
    starcoder-15b at full width and depth (40 layers, G = 48, about 31 GB)
    in bf16 over a bf16 pool, each a random init from SEED with the biases
    and layernorms perturbed, serving phase 6's traffic (gpt2's prompts cut
    to GPT2_SIZES) with phase 6's checks (every decode step, prefill chunk
    and first token a graph replay, launch counts exact; with int8 weights
    the GEMM's 4 x n_layers a replay) and a decode chunk and a prefill
    chunk replayed = eager bit for bit. Returns the launch counts per
    run."""
    from bee2bee_tpu_torch.models.config import get_config
    from bee2bee_tpu_torch.models.quant import quantize_params_

    out = {}
    cfg = get_config("distilgpt2")
    for quantized in (False, True):
        params = family_params(cfg, torch.bfloat16, SEED + quantized)
        n = sum(t.numel() for _, t in tree_leaves(params))
        if quantized:
            params = quantize_params_(params)
        torch.cuda.synchronize()
        log(f"distilgpt2: {cfg.n_layers} layers, {n} parameters ({storage_bytes(params)} B"
            f"{', int8 layer weights' if quantized else ' bf16'}), biases N(0, "
            f"{QWEN_BIAS_STD ** 2:g}), layernorm scales 1 + N(0, {QWEN_NORM_STD ** 2:g}) and "
            f"biases N(0, {LN_BIAS_STD ** 2:g}), random from seed {SEED + quantized}")
        pool = "int8" if quantized else "bfloat16"
        out[f"distilgpt2 {pool}"] = phase_slice(
            card, pool, params=params, quantize="int8" if quantized else "none", model=cfg,
            light=True, sizes=GPT2_SIZES)[0]
        del params
        gc.collect()
        torch.cuda.empty_cache()
    out["gpt2 spec"] = phase_gpt2_spec(card)
    cfg = get_config("starcoder-15b")
    t0 = time.perf_counter()
    params = family_params(cfg, torch.bfloat16, SEED)
    torch.cuda.synchronize()
    n = sum(t.numel() for _, t in tree_leaves(params))
    log(f"starcoder-15b: {cfg.n_layers} layers, {cfg.n_heads} query heads over "
        f"{cfg.n_kv_heads} kv head (G = {cfg.n_heads // cfg.n_kv_heads}: 3 16-row blocks a "
        f"kv head in the decode kernel), {n} parameters ({storage_bytes(params)} B bf16), "
        f"random from seed {SEED} in {time.perf_counter() - t0:.2f} s")
    out["starcoder-15b"] = phase_slice(card, "bfloat16", params=params, model=cfg,
                                       light=True)[0]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phi-3 phases


# a prefill past phi-3's 2,047-key window (the window binds on its last 253
# positions); the served prompts: phase 6's shape from 41 to 3,000 tokens,
# three past the window, each with 64 new tokens inside 4,096 positions
PHI3_PROMPT = 2300
PHI3_SIZES = (40, 120, 400, 900, 1500, 2100, 2600, 2999)
# phi-3-mini's projections (K, the N of each weight of one launch), the
# grouped ones as the engine launches them: wq|wk|wv, wo, w_up|w_gate,
# w_down; K = 3072 = 96 x 32
PHI3_GEMM = (("wq|wk|wv", 3072, (3072, 3072, 3072)), ("wo", 3072, (3072,)),
             ("w_up|w_gate", 3072, (8192, 8192)), ("w_down", 8192, (3072,)))


def phase_phi3_forward() -> dict:
    """Phase 5 for phi-3-mini (``family_forward``): full width (32 heads of
    96 over 32 kv heads, d 3072, d_ff 8192, vocab 32064, untied), 2 layers,
    every norm scale perturbed, a PHI3_PROMPT-token prefill past its
    2,047-key window and 8 decode steps. Returns the launch counts."""
    from bee2bee_tpu_torch.models.config import get_config

    cfg = replace(get_config("phi-3-mini"), n_layers=2, name="phi-3-mini-2layers")
    label = (f"forward 2x phi-3-mini width (G = 1, head_dim {cfg.head_dim}, window "
             f"{cfg.sliding_window} on every layer)")
    return family_forward(label, cfg, PHI3_PROMPT, perturb_norms)


def phase_phi3_gemm(flush) -> dict:
    """The int8-weight GEMM, bf16 and f32 forms, at phi-3-mini's projections
    (PHI3_GEMM, each as the engine launches it, the grouped weights in one
    launch) and M in GEMM_MS: each output within GEMM_REL_TOL (bf16) or
    GEMM_F32_REL_TOL (f32) of the largest |output| of its plain version,
    one launch a call of the form in x's type, the same bytes twice. Times
    at M = 8 beside the bound, the plain version, cuBLAS in x's type over
    the concatenated dense weight and torch._weight_int8pack_mm. Returns the
    timings by (type, projection)."""
    from bee2bee_tpu_torch.ops.int8_gemm import int8_weight_matmul_group, int8_weight_matmul_ref

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        make, tol = (int8_weight_f32, GEMM_F32_REL_TOL) if f32 else (int8_weight, GEMM_REL_TOL)
        counter = "int8_gemm_f32" if f32 else "int8_gemm"
        name = str(dtype)[6:]
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + 11 + f32)
        worst = 0.0
        for label, K, Ns in PHI3_GEMM:
            pairs = [make(gen, K, N) for N in Ns]
            ws = [w for w, _ in pairs]
            dense = torch.cat([d for _, d in pairs], dim=1)
            del pairs
            Nt = sum(Ns)
            for M in GEMM_MS:
                x = torch.randn((M, K), generator=gen, device="cuda", dtype=dtype)
                before = gemm_counts()
                ys = int8_weight_matmul_group(x, ws)
                ys2 = int8_weight_matmul_group(x, ws)
                torch.cuda.synchronize()
                after = gemm_counts()
                launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
                rels = []
                for y, w in zip(ys, ws):
                    ref = int8_weight_matmul_ref(x, w["q"], w["s"]).float()
                    rels.append((y.float() - ref).abs().max().item() / ref.abs().max().item())
                worst = max(worst, *rels)
                same = all(torch.equal(a, b) for a, b in zip(ys, ys2))
                log(f"int8 GEMM phi-3 {name} {label} [{K}, {Nt}] M={M}: relative errors "
                    f"vs plain {[f'{r:.3e}' for r in rels]} (tol {tol:.3e}); launches "
                    f"{launched}; same bytes twice {same}")
                check(all(y.dtype == dtype and bool(torch.isfinite(y).all()) for y in ys),
                      f"int8 GEMM phi-3 {name} {label} M={M}: type or non-finite values")
                check(max(rels) <= tol, f"int8 GEMM phi-3 {name} {label} M={M}: {rels}")
                check(launched == {counter: 2},
                      f"int8 GEMM phi-3 {name} {label} M={M}: launches {launched} for 2 calls")
                check(same, f"int8 GEMM phi-3 {name} {label} M={M}: two calls differ")
                if M != 8:
                    continue
                e = x.element_size()
                bnd = bounds(K * Nt + 4 * Nt + e * M * K + e * M * Nt, 2 * M * K * Nt, dtype,
                             "2xtf32" if f32 else "")
                ms = cuda_time_ms(lambda: int8_weight_matmul_group(x, ws), flush=flush)
                plain_ms = cuda_time_ms(
                    lambda: [int8_weight_matmul_ref(x, w["q"], w["s"]) for w in ws],
                    flush=flush)
                cublas_ms = cuda_time_ms(lambda: torch.matmul(x, dense), flush=flush)
                library_ms, lib = pack_mm_ms(x, ws, flush)
                log(f"int8 GEMM phi-3 {name} {label} [{K}, {Nt}] M=8: kernel {ms:.4f} ms, "
                    f"{bnd['text']} -> {bnd['bound_ms'] / ms:.3f} of bound; plain "
                    f"{plain_ms:.4f} ms; cuBLAS {name} at the concatenated dense weight "
                    f"{cublas_ms:.4f} ms; torch._weight_int8pack_mm {lib}")
                out[(name, label)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd["bound_ms"],
                                          bound_by=bnd["bound_by"], library_ms=library_ms,
                                          cublas_ms=cublas_ms, err=max(rels))
            del ws, dense
        log(f"int8 GEMM phi-3 {name}: worst relative error {worst:.3e} (tol {tol:.3e})")
    torch.cuda.empty_cache()
    return out


def phase_phi3_served(card: str) -> dict:
    """phi-3-mini at full width and depth (32 layers, 3.82 B parameters) at
    its 4,096 positions, bf16 over a bf16 pool and with int8 weights over an
    int8 pool, each a random init from SEED with every norm scale perturbed,
    serving phase 6's traffic at PHI3_SIZES (prompts of 41 to 3,000 tokens,
    three past the 2,047-key window) with phase 6's checks (every decode
    step, prefill chunk and first token a graph replay, launch counts exact;
    the GEMM 4 x n_layers a replay with int8 weights), a decode chunk and a
    prefill chunk replayed = eager bit for bit and the replayed B=8 step's
    breakdown beside its weights' and KV pages' bound. Returns the launch
    counts per run."""
    from bee2bee_tpu_torch.models.config import get_config
    from bee2bee_tpu_torch.models.quant import quantize_params_

    cfg = get_config("phi-3-mini")
    out = {}
    for quantized in (False, True):
        t0 = time.perf_counter()
        params = perturb_norms(family_params(cfg, torch.bfloat16, SEED + quantized),
                               SEED + 100 + quantized)
        n = sum(t.numel() for _, t in tree_leaves(params))
        if quantized:
            params = quantize_params_(params)
        torch.cuda.synchronize()
        log(f"phi-3-mini: {cfg.n_layers} layers, {cfg.n_heads} heads of {cfg.head_dim} over "
            f"{cfg.n_kv_heads} kv heads, window {cfg.sliding_window}, {n} parameters "
            f"({storage_bytes(params)} B{', int8 layer weights' if quantized else ' bf16'}), "
            f"norm scales 1 + N(0, {QWEN_NORM_STD ** 2:g}), random from seed "
            f"{SEED + quantized} in {time.perf_counter() - t0:.2f} s; max_seq_len "
            f"{cfg.max_seq_len}, prompts of {PHI3_SIZES[0] + 1} to {PHI3_SIZES[-1] + 1} "
            f"tokens")
        pool = "int8" if quantized else "bfloat16"
        out[f"phi-3-mini {pool}"] = phase_slice(
            card, pool, params=params, quantize="int8" if quantized else "none", model=cfg,
            light=True, sizes=PHI3_SIZES, max_seq_len=cfg.max_seq_len)[0]
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_phi3_checkpoint(card: str) -> dict:
    """phi-3-mini's checkpoint alone (``checkpoint_family``: its published
    config.json cut to 2 layers, fused qkv_proj and gate_up_proj), in a
    directory under build/ removed after. Returns the launch counts."""
    import shutil

    workdir = Path(__file__).resolve().parent / "build" / "ckpt_phi3"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        return checkpoint_family(card, "phi-3-mini", workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def f32_int8_weight_logits(params, cfg, tag: str) -> None:
    """The f32 int8-weight forward (a 300-token prefill through the
    dequantize route in f32, 4 greedy steps through the GEMM's f32 form)
    no further from the f32 forward over the dense weights q * s than twice
    the bf16 int8-weight forward's distance from it; then at 2 layers, 8
    greedy steps: the tokens of the plain f32 forward over q * s (plain
    attention too), its logits within FORWARD_TOL."""
    from bee2bee_tpu_torch.ops.ragged import ragged_paged_attention_ref

    gen = np.random.default_rng(SEED + 8)
    ids = gen.integers(3, 259, size=300).tolist()
    run = logits_run(cfg, ids)
    q = run(params)
    b = run(cast_tree(params, torch.bfloat16))
    dense = _dense(params, torch.float32)
    f = run(dense)
    del dense
    torch.cuda.empty_cache()

    def dist(a, c):
        return max((a[0] - c[0]).abs().max().item(), (a[1] - c[1]).abs().max().item())

    check(bool(torch.isfinite(q[0]).all() and torch.isfinite(q[1]).all()),
          f"{tag}: non-finite logits")
    err, gap = dist(q, f), dist(b, f)
    log(f"{tag} logits: f32 int8-weight forward ({cfg.n_layers} layers, 300-token prefill, "
        f"4 greedy steps) vs the f32 forward over the dequantized weights: max abs "
        f"{err:.4e} (tol {2 * gap:.4e}, twice the bf16 int8-weight forward's distance "
        f"{gap:.4e}); greedy f32 int8 {q[2]} bf16 int8 {b[2]} f32 dense {f[2]}")
    check(err <= 2 * gap, f"{tag}: f32 int8-weight logits {err} from the f32 forward, "
          f"beyond twice the bf16 int8-weight forward's {gap}")
    cfg2 = replace(cfg, n_layers=2)
    two = dict(params, layers=params["layers"][:2])
    run2 = logits_run(cfg2, ids, new_steps=8)
    k = run2(two)
    p = run2(_dense(two, torch.float32), attn_fn=ragged_paged_attention_ref)
    err2 = dist(k, p)
    log(f"{tag} at 2 layers: 8 greedy steps, f32 int8-weight forward {k[2]}, plain f32 "
        f"forward over q * s {p[2]}; logits max abs {err2:.3e} (tol {FORWARD_TOL})")
    check(k[2] == p[2], f"{tag}: 2-layer greedy tokens differ: {k[2]} vs {p[2]}")
    check(err2 <= FORWARD_TOL, f"{tag}: 2-layer logits differ by {err2}")


def phase_f32_int8_weights(card: str) -> dict:
    """int8 weights beside f32 activations: llama-3-8b at full width and
    depth, random from SEED in f32 and quantized on the card as it loads,
    served over an int8 pool with phase 6's traffic and checks (the GEMM's
    f32 form 4 x n_layers a replayed decode step or narrow prefill chunk,
    the f32 dequantize route the wider chunks), a decode and a prefill
    chunk replayed = eager bit for bit; then n-gram speculative decoding
    on the same weights over an f32 pool (8 periodic prompts x 64 greedy
    tokens, K = 4):
    the spec-off engine's tokens, the GEMM's f32 form 4 x n_layers every
    decode and verify replay, a verify step replayed = eager bit for bit;
    then the logits (``f32_int8_weight_logits``). Returns the launch
    counts, summed."""
    tag = "f32 int8 weights"
    counts, _, params = phase_slice(card, "int8", dtype="float32", quantize="int8",
                                    light=True)
    total = dict(counts)

    def add(c):
        for k, v in c.items():
            total[k] = total.get(k, 0) + v

    # spec over an f32 pool: over an int8 pool a verify chunk's later
    # positions can requantize a page its first position reads, so the
    # tokens may leave the spec-off engine's (as in JAX)
    off = spec_engine(params, "float32", "float32", quantize="int8")
    prompts = spec_prompts(off.tokenizer, periodic=True)
    try:
        want, wall_off = spec_burst(off, prompts)
    finally:
        off.close()
    del off
    gc.collect()
    torch.cuda.empty_cache()
    engine = spec_engine(params, "float32", "float32", quantize="int8", spec_tokens=SPEC_K,
                         spec_min_match=1, spec_probe_tokens=1 << 20)
    stag = f"spec[ngram, {tag}, float32 pool]"
    try:
        roots_run = record_roots(engine)
        since = graph_stats(engine, stag)
        reset_counts()
        reset_gemm_counts()
        got, wall = spec_burst(engine, prompts)
        torch.cuda.synchronize()
        c = read_counts()
        gemm = gemm_counts()
        n = spec_counts(engine, stag, since, c)
        equal = sum(a == b for a, b in zip(got, want))
        log(f"{stag}: 8 x {SPEC_NEW} greedy tokens in {wall:.3f} s (spec off "
            f"{wall_off:.3f} s); {equal} of 8 rows equal to the spec-off engine's; card "
            f"{card}")
        check(equal == len(prompts), f"{stag}: spec-on tokens differ from spec-off")
        check(n["verifies"] > 0 and n["decodes"] > 0,
              f"{stag}: {n['verifies']} verify and {n['decodes']} decode replays")
        check_int8_gemm_launches(engine, stag, gemm, roots_run, True)
        c.update(gemm)
        add(c)
        v = verify_vs_eager(engine, stag)
        want_gemm = {"int8_gemm_f32": GEMM_LAUNCHES_PER_LAYER * engine.model_cfg.n_layers}
        check(v["gemm"] == want_gemm,
              f"{stag}: a verify replay's GEMM launches {v['gemm']}, expected {want_gemm}")
    finally:
        engine.close()
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    from bee2bee_tpu_torch.models.config import get_config

    f32_int8_weight_logits(params, get_config("llama-3-8b"), tag)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ------------------------------------------------------------ MoE phases


# the MoE presets' expert shapes: (model, d_model, d_ff, experts, experts a token)
MOE_SHAPES = (("qwen3-30b-a3b", 2048, 768, 128, 8), ("mixtral-8x7b", 4096, 14336, 8, 2))
# a case's tokens: a B = 8 decode step, a B = 8 verify step at K = 4, a
# 2,048-token prefill chunk
MOE_TOKENS = (8, 40, 2048)
# kernel vs plain version on the same inputs. bf16: the kernel rounds each
# output once (f32 sum, times the int8 scale, to bf16), the plain version's
# int8 formula rounds the product and the scaled product: 2 ulps at most,
# 2^-6 of the largest |output| (the int8-weight GEMM's rule). f32: FFMA sums
# in another order than cuBLAS's, 1e-4 of the largest |output|.
MOE_REL_TOL = 2.0 ** -6
MOE_F32_REL_TOL = 1e-4
# the expert GEMM's launch counters and their names here, by form: (x's
# type, int8 experts)
MOE_COUNTERS = {"launches": "moe", "int8_launches": "moe_int8", "f32_launches": "moe_f32",
                "int8_f32_launches": "moe_f32_int8"}
MOE_FORMS = ((torch.bfloat16, False), (torch.bfloat16, True), (torch.float32, False),
             (torch.float32, True))
# an MoE layer's expert GEMM launches: w_up|w_gate, then w_down
MOE_LAUNCHES_PER_LAYER = 2
MOE_KERNEL = "moe_expert_gemm_kernel"
# the bf16-x forms' tile heights that no MOE_TOKENS case picks
MOE_FORCED_ROWS = (32, 64)
# the skewed router: this logit bias toward expert 0, and against experts
# 1..MOE_SKEW_NONE
MOE_SKEW_BIAS = 8.0
MOE_SKEW_NONE = 2
# the expert GEMM's template types as they are mangled
MOE_TYPES = {"f": "f32", "13__nv_bfloat16": "bf16", "a": "int8"}


def profiled_kernels(fn, prefix: str, tries: int = 3) -> list:
    """The CUDA kernels whose names start with ``prefix`` that one call of
    ``fn`` ran, as torch.profiler names them (template arguments cut). As
    ``device_profile``: CUDA activity only, recorded after a discarded
    warm-up call, a capture that saw none of them taken again, up to
    ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile, schedule

    names = set()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        for e in prof.key_averages():
            m = re.search(rf"{prefix}\w*(?:<[^>]*>)?", e.key)
            if e.device_type == torch.autograd.DeviceType.CUDA and m:
                names.add(m.group(0))
        if names:
            break
    return sorted(names)


def moe_form(dtype, int8: bool) -> str:
    """The counter name of the expert GEMM's form for (x's type, int8
    experts)."""
    return ("moe_f32" if dtype == torch.float32 else "moe") + ("_int8" if int8 else "")


def moe_counts() -> dict:
    from bee2bee_tpu_torch.ops.moe import moe_expert_matmul

    return {short: getattr(moe_expert_matmul, n) for n, short in MOE_COUNTERS.items()}


def reset_moe_counts() -> None:
    from bee2bee_tpu_torch.ops.moe import moe_expert_matmul

    for n in MOE_COUNTERS:
        setattr(moe_expert_matmul, n, 0)


def moe_stack(gen, E: int, K: int, N: int, dtype, int8: bool):
    """A random [E, K, N] expert stack at the init's scale 1/sqrt(K) in
    ``dtype``, drawn one expert at a time, or its int8 form {"q", "s"}
    (quantized on the card)."""
    from bee2bee_tpu_torch.models.quant import quantize_weight_torch

    w = torch.empty((E, K, N), dtype=dtype, device="cuda")
    for e in range(E):
        w[e] = torch.randn((K, N), generator=gen, device="cuda", dtype=dtype).mul_(
            1.0 / math.sqrt(K))
    return quantize_weight_torch(w) if int8 else w


def moe_plan_experts(plan) -> torch.Tensor:
    """The expert of each assignment (token-major, slot-minor) a plan
    routed it to, E where it was dropped, on the host."""
    offsets = plan.offsets.cpu().long()
    return torch.searchsorted(offsets, plan.inv.cpu(), right=True) - 1


def moe_topk_reference(logits: torch.Tensor, k: int) -> torch.Tensor:
    """JAX's top-k on the host: experts by descending logit, the lower
    index first among equal logits ([N, k])."""
    lg = logits.cpu().double().numpy()
    order = np.lexsort((np.broadcast_to(np.arange(lg.shape[1]), lg.shape), -lg), axis=-1)
    return torch.from_numpy(order[:, :k].copy())


def moe_capacity_reference(experts: torch.Tensor, N: int, k: int, E: int, g: int,
                           C: int) -> torch.Tensor:
    """JAX ``_moe_routed``'s keep mask on the host: per group of g tokens a
    running count per expert in token-major, slot-minor order (one-hot
    cumsum), kept while under C. [N * k] bool."""
    oh = np.eye(E, dtype=np.int64)[experts.reshape(N, k).numpy()]  # [N, k, E]
    keep = np.zeros((N, k), dtype=bool)
    for g0 in range(0, N, g):
        ohf = oh[g0:g0 + g].reshape(-1, E)
        pos = ((np.cumsum(ohf, axis=0) - ohf) * ohf).sum(-1)
        keep[g0:g0 + g] = (pos < C).reshape(-1, k)
    return torch.from_numpy(keep.reshape(-1))


def moe_layer_bytes_flops(plan, D: int, F: int, ws, down, x) -> tuple[int, int]:
    """The bytes one MoE layer's two launches must move (each distinct
    expert's matrices and scales once, x's rows, h and both outputs once,
    the row indices) and the operations of the routed rows."""
    counts = (plan.offsets[1:] - plan.offsets[:-1]).cpu()
    n_e = int((counts > 0).sum())
    kept = int(plan.offsets[-1])
    e = x.element_size()

    def stack_bytes(w, K, N):
        if isinstance(w, dict):
            return n_e * (K * N + 4 * N)
        return n_e * K * N * w.element_size()

    nbytes = (sum(stack_bytes(w, D, F) for w in ws) + stack_bytes(down, F, D)
              + x.shape[0] * D * e + kept * F * e * (len(ws) + 1) + kept * D * e
              + 4 * plan.tok.shape[0])
    flops = 2 * kept * D * F * len(ws) + 2 * kept * F * D
    return nbytes, flops


def grouped_mm_ms(x, plan, ws, down, h, flush) -> tuple:
    """``torch._grouped_mm`` (PyTorch's grouped product, a yardstick the
    port never calls) over the same sorted rows: x gathered by the plan's
    tokens, each stack (an int8 stack's bytes as they lie), then h over
    w_down: (ms, text) or (None, why not: no such op or no kernel for these
    inputs in this torch, as the call says)."""
    def raw(w):
        return w["q"] if isinstance(w, dict) else w

    try:
        xs = x.index_select(0, plan.tok.long())
        offs = plan.offsets[1:].contiguous()
        kept = int(plan.offsets[-1])

        def run():
            return ([torch._grouped_mm(xs, raw(w), offs=offs) for w in ws]
                    + [torch._grouped_mm(h, raw(down), offs=offs)])

        out = run()
        torch.cuda.synchronize()
        ref = torch.cat([o[:kept].float() for o in out[:-1]], dim=1)
        ms = cuda_time_ms(run, flush=flush)
        return ms, (f"{ms:.4f} ms ({len(ws) + 1} calls over rows gathered ahead; finite "
                    f"{bool(torch.isfinite(ref).all())})")
    except Exception as e:  # noqa: BLE001 — the op may be absent or refuse these inputs
        return None, (f"n/a ({type(e).__name__}: {str(e).splitlines()[0][:120]}; torch "
                      f"{torch.__version__})")


def moe_case(label: str, x, logits, k: int, ws, down, form: str, tol: float,
             capacity=None, act=None, br=None) -> tuple[float, object, torch.Tensor]:
    """One layer's two launches (w_up|w_gate over x's rows, w_down over h)
    against the plain version on the same plan (tiles of ``br`` rows, by
    default the plan's rule): each kept row within ``tol`` of the largest
    |output| of the plain version, one launch a call of ``form``, the same
    bytes from two calls. Prints the CUDA kernels each call launched (the
    wrapper's routes). Returns (the worst relative error, the plan, h)."""
    import torch.nn.functional as F_

    from bee2bee_tpu_torch.ops.moe import moe_expert_matmul, moe_expert_matmul_ref, moe_plan

    plan = moe_plan(logits, k, capacity, br=br, dtype=x.dtype)
    moe_expert_matmul.routes.clear()
    before = moe_counts()
    ys = moe_expert_matmul(x, plan.tok, plan, ws)
    ys2 = moe_expert_matmul(x, plan.tok, plan, ws)
    h = (act or (lambda u, g: F_.silu(g) * u))(ys[0], ys[1] if len(ys) > 1 else None)
    yd = moe_expert_matmul(h, None, plan, [down])[0]
    yd2 = moe_expert_matmul(h, None, plan, [down])[0]
    torch.cuda.synchronize()
    after = moe_counts()
    launched = {n: after[n] - before[n] for n in after if after[n] != before[n]}
    refs = moe_expert_matmul_ref(x, plan.tok, plan, ws) + moe_expert_matmul_ref(
        h, None, plan, [down])
    kept = int(plan.offsets[-1])
    rels = []
    for y, ref in zip(ys + [yd], refs):
        r = ref[:kept].float()
        rels.append((y[:kept].float() - r).abs().max().item() / r.abs().max().item())
    same = all(torch.equal(a[:kept], b[:kept]) for a, b in zip(ys + [yd], ys2 + [yd2]))
    finite = all(bool(torch.isfinite(y[:kept]).all()) for y in ys + [yd])
    log(f"moe {label}: {plan.n_tokens} tokens x {k}, {kept} rows kept, tiles of {plan.br} "
        f"rows ({int(plan.tile_count)} of {plan.n_tiles} slots); relative errors vs plain "
        f"{[f'{r:.3e}' for r in rels]} (tol {tol:.3e}); launches {launched}; same bytes "
        f"twice {same}")
    log(f"moe {label}: kernels launched (calls each) {dict(moe_expert_matmul.routes)}")
    check(finite, f"moe {label}: non-finite outputs")
    check(max(rels) <= tol, f"moe {label}: errors {rels} > {tol}")
    check(launched == {form: 4}, f"moe {label}: launches {launched} for 4 calls of {form}")
    check(same, f"moe {label}: two calls differ")
    return max(rels), plan, h


def phase_moe_kernel(flush) -> dict:
    """The grouped expert GEMM (csrc/moe_expert_gemm.cu) at qwen3-30b-a3b's
    and mixtral-8x7b's expert shapes (MOE_SHAPES), MOE_TOKENS tokens, every
    form (bf16 and int8 experts under bf16 x, f32 and int8 experts under
    f32 x), router logits from x through a random router in x's type:
    ``moe_case``'s checks, then both launches timed (median of 30, L2
    flushed) beside their bound (the distinct experts' bytes, x, h and the
    outputs once; the routed products at the bf16 peak, or FFMA's for f32),
    the plain version and ``torch._grouped_mm`` over the same sorted rows
    (its time, or the error it gives for a form this torch has no kernel
    for); at the largest token count the CUDA kernels one
    call ran, as torch.profiler names them. The bf16-x forms' tile heights
    that no case's rule picks (MOE_FORCED_ROWS) are held against the plain
    version too. Then a skewed router (a bias sends most rows to one
    expert, none to MOE_SKEW_NONE others, one expert past the tallest
    tile), a plan with tied logits (the experts JAX's top-k picks) and a
    routed plan whose capacity drops assignments (JAX's keep mask, and the
    combine finite and within the tolerance). Returns {"err": worst error
    per form, "timing": {(form, model, tokens): ...}}."""
    from bee2bee_tpu_torch.ops import _build
    from bee2bee_tpu_torch.ops.moe import moe_combine, moe_expert_matmul_ref, routed_capacity

    log(f"moe kernel: csrc/moe_expert_gemm.cu nvcc "
        f"{_build.build_seconds.get('moe_expert_gemm.cu', 'n/a (a cached build)')} s")
    out = {"err": {}, "timing": {}}
    for model, D, F, E, k in MOE_SHAPES:
        for dtype, int8 in MOE_FORMS:
            form = moe_form(dtype, int8)
            f32 = dtype == torch.float32
            tol = MOE_F32_REL_TOL if f32 else MOE_REL_TOL
            gen = torch.Generator(device="cuda")
            gen.manual_seed(SEED + 31)
            router = torch.randn((D, E), generator=gen, device="cuda", dtype=dtype).mul_(
                1.0 / math.sqrt(D))
            ws = [moe_stack(gen, E, D, F, dtype, int8) for _ in range(2)]
            down = moe_stack(gen, E, F, D, dtype, int8)
            for N in MOE_TOKENS:
                x = torch.randn((N, D), generator=gen, device="cuda", dtype=dtype)
                logits = (x @ router).float()
                label = f"{model} {form} N={N}"
                err, plan, h = moe_case(label, x, logits, k, ws, down, form, tol)
                out["err"][form] = max(out["err"].get(form, 0.0), err)
                nbytes, flops = moe_layer_bytes_flops(plan, D, F, ws, down, x)
                bnd = bounds(nbytes, flops, dtype, "ffma" if f32 else "")
                from bee2bee_tpu_torch.ops.moe import moe_expert_matmul

                ms = cuda_time_ms(lambda: (moe_expert_matmul(x, plan.tok, plan, ws),
                                           moe_expert_matmul(h, None, plan, [down])),
                                  flush=flush)
                plain_ms = cuda_time_ms(
                    lambda: (moe_expert_matmul_ref(x, plan.tok, plan, ws),
                             moe_expert_matmul_ref(h, None, plan, [down])), flush=flush)
                # every form tries it: the f32 and int8 forms report the
                # call's own refusal where this torch has no kernel for them
                library_ms, lib = grouped_mm_ms(x, plan, ws, down, h, flush)
                n_e = int(((plan.offsets[1:] - plan.offsets[:-1]) > 0).sum())
                log(f"moe {label}: both launches {ms:.4f} ms, {bnd['text']} -> "
                    f"{bnd['bound_ms'] / ms:.3f} of bound ({n_e} of {E} experts hit); "
                    f"plain {plain_ms:.4f} ms; torch._grouped_mm {lib}")
                if N == MOE_TOKENS[-1]:
                    names = profiled_kernels(lambda: (
                        moe_expert_matmul(x, plan.tok, plan, ws),
                        moe_expert_matmul(h, None, plan, [down])), MOE_KERNEL)
                    log(f"moe {label}: CUDA kernels of both launches (torch.profiler) {names}")
                    check(bool(names), f"moe {label}: the profiler saw no expert GEMM kernel")
                    check(f32 or all("wgmma" in n or "gather" in n for n in names),
                          f"moe {label}: the bf16-x form ran {names}, not the wgmma kernel")
                out["timing"][(form, model, N)] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bnd["bound_ms"],
                    bound_by=bnd["bound_by"], library_ms=library_ms, experts_hit=n_e)
            N = MOE_TOKENS[-1]
            x = torch.randn((N, D), generator=gen, device="cuda", dtype=dtype)
            logits = (x @ router).float()
            if not f32:  # the tile heights no case's rule picks
                for br in MOE_FORCED_ROWS:
                    err, _, _ = moe_case(f"{model} {form} N={N} tiles of {br}", x, logits, k,
                                         ws, down, form, tol, br=br)
                    out["err"][form] = max(out["err"][form], err)
            # skewed routing: most rows to expert 0, none to experts 1..MOE_SKEW_NONE
            skew = logits.clone()
            skew[:, 0] += MOE_SKEW_BIAS
            skew[:, 1:1 + MOE_SKEW_NONE] -= MOE_SKEW_BIAS
            err, plan, _ = moe_case(f"{model} {form} N={N} skewed", x, skew, k, ws, down, form,
                                    tol)
            counts = (plan.offsets[1:] - plan.offsets[:-1]).tolist()
            log(f"moe {model} {form} skewed: rows per expert {counts[:8]}..., expert 0 "
                f"{counts[0]} of {int(plan.offsets[-1])} rows, {counts.count(0)} experts "
                f"none")
            check(counts[0] > plan.br and counts.count(0) >= MOE_SKEW_NONE,
                  f"moe {model} {form} skewed: rows per expert {counts}")
            out["err"][form] = max(out["err"][form], err)
            # tied logits: 4 levels over E experts, ties at the k-th place
            N = MOE_TOKENS[0]
            x = torch.randn((N, D), generator=gen, device="cuda", dtype=dtype)
            logits = torch.randint(0, 4, (N, E), generator=gen, device="cuda").float()
            err, plan, _ = moe_case(f"{model} {form} tied logits", x, logits, k, ws, down,
                                    form, tol)
            picked = moe_plan_experts(plan).reshape(N, k).sort(dim=-1).values
            want = moe_topk_reference(logits, k).sort(dim=-1).values
            log(f"moe {model} {form} tied logits: the plan's experts equal JAX's top-k "
                f"(lower index first on ties) {torch.equal(picked, want)}")
            check(torch.equal(picked, want), f"moe {model} {form}: tied logits routed "
                  f"to {picked.tolist()}, JAX picks {want.tolist()}")
            # a routed plan whose capacity drops assignments
            N = MOE_TOKENS[-1]
            x = torch.randn((N, D), generator=gen, device="cuda", dtype=dtype)
            logits = (x @ router).float()
            g, C = routed_capacity(N, k, E, 512, 0.5)
            err, plan, h = moe_case(f"{model} {form} routed g={g} C={C}", x, logits, k, ws,
                                    down, form, tol, capacity=(g, C))
            chosen = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :k]
            keep = moe_capacity_reference(chosen.cpu().reshape(-1), N, k, E, g, C)
            kept = int(plan.offsets[-1])
            check(torch.equal(plan.keep.cpu(), keep) and 0 < kept < N * k,
                  f"moe {model} {form}: the routed plan kept {kept} of {N * k}, the keep "
                  f"mask differs from JAX's")
            from bee2bee_tpu_torch.ops.moe import moe_expert_matmul

            y = moe_expert_matmul(h, None, plan, [down])[0]
            yr = moe_expert_matmul_ref(h, None, plan, [down])[0]
            comb, comb_ref = moe_combine(y, plan, dtype), moe_combine(yr, plan, dtype)
            rel = ((comb.float() - comb_ref.float()).abs().max()
                   / comb_ref.float().abs().max()).item()
            log(f"moe {model} {form} routed: {kept} of {N * k} assignments kept (JAX's keep "
                f"mask), combine finite {bool(torch.isfinite(comb).all())}, relative error "
                f"{rel:.3e}")
            check(bool(torch.isfinite(comb).all()) and rel <= 2 * tol,
                  f"moe {model} {form} routed: combine error {rel}")
            del ws, down, router, x, h, y, yr
            gc.collect()
            torch.cuda.empty_cache()
    log(f"moe kernel: worst relative error per form {out['err']}")
    return out


@contextlib.contextmanager
def plain_experts():
    """The forward's expert product through its plain version (the plain
    forward of phase 5 only): core's module-level name swapped for the
    while."""
    from bee2bee_tpu_torch.models import core
    from bee2bee_tpu_torch.ops.moe import moe_expert_matmul_ref

    kernel = core.moe_expert_matmul
    core.moe_expert_matmul = moe_expert_matmul_ref
    try:
        yield
    finally:
        core.moe_expert_matmul = kernel


def quantized_experts(params) -> bool:
    """Are an MoE model's expert stacks int8?"""
    from bee2bee_tpu_torch.models.quant import is_quantized

    return is_quantized(params["layers"][0]["moe"]["w_up"])


def check_moe_launches(engine, tag: str, moe: dict, forwards: int) -> None:
    """Every replayed forward of an MoE model launches the expert GEMM's
    form for (the engine's type, its experts' type) twice a layer; a dense
    model launches none."""
    cfg = engine.model_cfg
    want = {n: 0 for n in MOE_COUNTERS.values()}
    if cfg.is_moe:
        want[moe_form(engine.dtype, quantized_experts(engine.params))] = (
            MOE_LAUNCHES_PER_LAYER * cfg.n_layers * forwards)
        log(f"{tag}: expert GEMM launches {moe} ({MOE_LAUNCHES_PER_LAYER} x {cfg.n_layers} "
            f"layers x {forwards} forwards)")
    check(moe == want, f"{tag}: expert GEMM launches {moe}, expected {want}")


def moe_bf16_steps(tag: str, run, bparams, params, pool_dtype, f32_pool, b_toks, bp_steps,
                   bp_toks) -> None:
    """The decode steps of an MoE model's bf16 forward, by the relative
    rule: routing makes bf16 greedy tokens a coin flip between two bf16
    forwards (a 1-ulp difference of a router logit swaps an expert where
    the k-th and (k+1)-th logits tie in bf16; the plain bf16 forward sits
    9-10% from the plain f32 one in the relative norm, PERF.md §6), so
    each step is teacher-forced with the plain bf16 forward's greedy tokens:
    the kernel forward's step logits no further from the plain bf16 ones,
    in the relative (Frobenius) norm, than those are from the plain f32
    forward's on the same tokens, and the first greedy token (from the
    prefill logits) equal. The kernel forward's own greedy tokens are
    printed."""
    from bee2bee_tpu_torch.ops.ragged import ragged_paged_attention, ragged_paged_attention_ref

    _, kf_steps, _ = run(ragged_paged_attention, pool_dtype, bparams, tokens=bp_toks)
    with plain_experts():
        _, ff_steps, _ = run(ragged_paged_attention_ref, f32_pool, params, tokens=bp_toks)
    torch.cuda.synchronize()
    rel = ((kf_steps.float() - bp_steps.float()).norm() / bp_steps.float().norm()).item()
    rel_tol = ((bp_steps.float() - ff_steps).norm() / ff_steps.norm()).item()
    log(f"{tag}: the {len(bp_toks)} decode steps teacher-forced with the plain forward's "
        f"greedy tokens: step logits relative err {rel:.3e} (tol {rel_tol:.3e}, the plain bf16 "
        f"steps' relative gap to the plain f32 steps on the same tokens); greedy kernel "
        f"{b_toks} plain {bp_toks}, first equal {b_toks[:1] == bp_toks[:1]}")
    check(rel <= rel_tol, f"{tag}: step logits differ by {rel} > {rel_tol} (relative)")
    check(b_toks[:1] == bp_toks[:1], f"{tag}: first greedy token {b_toks[:1]} vs {bp_toks[:1]}")


def moe_calls_on_plain_inputs(tag: str, run, weights, attn_tol: float,
                              moe_tol: float) -> None:
    """Every attention call and every expert GEMM call of the plain 2-layer
    forward over an int8 pool (``weights``: the f32 or the bf16 tree) run
    through the kernel as well, on the same pool and inputs: attention
    within ``attn_tol`` (max abs), each expert product within ``moe_tol`` of
    its largest |output|. The plain result carries on, so no int8 rounding
    flip separates the two."""
    from bee2bee_tpu_torch.models import core
    from bee2bee_tpu_torch.ops.moe import moe_expert_matmul, moe_expert_matmul_ref
    from bee2bee_tpu_torch.ops.ragged import ragged_paged_attention, ragged_paged_attention_ref

    attn_errs, moe_errs = [], []

    def shadow_attn(q, kp, vp, *args, **kw):
        want = ragged_paged_attention_ref(q, kp, vp, *args, **kw)
        got = ragged_paged_attention(q, kp, vp, *args, **kw)
        attn_errs.append((got - want).abs().max().item())
        return want

    def shadow_moe(x, tok, plan, ws):
        want = moe_expert_matmul_ref(x, tok, plan, ws)
        got = moe_expert_matmul(x, tok, plan, ws)
        kept = int(plan.offsets[-1])
        for g, w in zip(got, want):
            moe_errs.append(((g[:kept] - w[:kept]).abs().max()
                             / w[:kept].abs().max()).item())
        return want

    core.moe_expert_matmul = shadow_moe
    try:
        run(shadow_attn, torch.int8, weights)
    finally:
        core.moe_expert_matmul = moe_expert_matmul
    torch.cuda.synchronize()
    log(f"{tag}: each of the {len(attn_errs)} attention calls and {len(moe_errs)} expert "
        f"products, kernel against the plain version on the plain forward's pool and inputs: "
        f"attention max abs err {max(attn_errs):.3e} (tol {attn_tol}), expert products max "
        f"relative err {max(moe_errs):.3e} (tol {moe_tol})")
    check(max(attn_errs) <= attn_tol, f"{tag}: an attention call differs by {max(attn_errs)}")
    check(max(moe_errs) <= moe_tol, f"{tag}: an expert product differs by {max(moe_errs)}")


def moe_int8_pool_forward(tag: str, run, weights) -> None:
    """An MoE model's f32 forward over an int8 pool. Over 2 layers the
    whole-forward logits measure the pool's rounding: a 1e-6 difference in
    layer 0's output (the attention kernel alone, or the expert GEMM alone,
    against its plain version) flips int8 roundings of layer 1's pages, and
    qwen3-30b-a3b's 2-layer logits then part by 2.0e-3 to 2.3e-3 either way
    (PERF.md §6). So, as ``gemma_int8_deep`` holds the deep gemma
    forwards: each call on the plain forward's inputs
    (``moe_calls_on_plain_inputs``: attention within F32_TOL, expert
    products within MOE_F32_REL_TOL); then the model's first layer, whose
    int8 pages both forwards write from the same embeddings, kernel against
    plain: logits within FORWARD_TOL, greedy tokens equal. The caller
    checks the 2-layer greedy tokens equal."""
    from bee2bee_tpu_torch.ops.ragged import ragged_paged_attention, ragged_paged_attention_ref

    moe_calls_on_plain_inputs(tag, run, weights, F32_TOL, MOE_F32_REL_TOL)
    k_logits, k_steps, k_toks = run(ragged_paged_attention, torch.int8, layers=1)
    with plain_experts():
        p_logits, p_steps, p_toks = run(ragged_paged_attention_ref, torch.int8, layers=1)
    torch.cuda.synchronize()
    err = max((k_logits - p_logits).abs().max().item(), (k_steps - p_steps).abs().max().item())
    log(f"{tag}, its first layer: logits max abs err {err:.3e} (tol {FORWARD_TOL}); greedy "
        f"kernel {k_toks} plain {p_toks}")
    check(err <= FORWARD_TOL, f"{tag}, 1 layer: logits differ by {err}")
    check(k_toks == p_toks, f"{tag}, 1 layer: greedy tokens differ: {k_toks} vs {p_toks}")


def moe_int8_experts_forward(label: str, cfg, params, run, n_steps: int) -> dict:
    """The f32 forward over an f32 pool with the experts quantized to int8
    (the expert GEMM's f32 x, int8 experts form) against its plain version:
    logits within FORWARD_TOL, greedy tokens equal, 2 launches a layer of
    every forward. Returns the launch counts."""
    from bee2bee_tpu_torch.models.quant import quantize_weight_torch
    from bee2bee_tpu_torch.ops.ragged import ragged_paged_attention, ragged_paged_attention_ref

    tag = f"{label} f32, int8 experts, float32 pool"
    qparams = dict(params, layers=[
        dict(lp, moe={k: (quantize_weight_torch(w) if k != "router" else w)
                      for k, w in lp["moe"].items()}) for lp in params["layers"]])
    reset_counts()
    k_logits, k_steps, k_toks = run(ragged_paged_attention, torch.float32, qparams)
    torch.cuda.synchronize()
    got = {k: v for k, v in moe_counts().items() if v}
    with plain_experts():
        p_logits, p_steps, p_toks = run(ragged_paged_attention_ref, torch.float32, qparams)
    torch.cuda.synchronize()
    err = max((k_logits - p_logits).abs().max().item(), (k_steps - p_steps).abs().max().item())
    want = {"moe_f32_int8": MOE_LAUNCHES_PER_LAYER * cfg.n_layers * (1 + n_steps)}
    log(f"{tag}: logits max abs err {err:.3e} (tol {FORWARD_TOL}); expert GEMM launches "
        f"{got} (expected {want}); greedy kernel {k_toks} plain {p_toks}")
    check(bool(torch.isfinite(k_logits).all()), f"{tag}: non-finite logits")
    check(got == want, f"{tag}: expert GEMM launches {got}, expected {want}")
    check(err <= FORWARD_TOL, f"{tag}: logits differ by {err}")
    check(k_toks == p_toks, f"{tag}: greedy tokens differ: {k_toks} vs {p_toks}")
    return got


# the MoE forwards' prompt (phase 5's rule at the gemma phases' length)
MOE_PROMPT = 1100
# the MoE forwards held per call over an int8 pool (``family_forward``'s
# ``int8_pool_per_call``): qwen3-30b-a3b's 2-layer f32 logits part by
# 2.319e-3 there (FORWARD_TOL 2e-3) and its bf16 greedy tokens at step 4,
# because a 1e-6 difference in layer 0 flips int8 roundings of layer 1's
# pages (PERF.md §6). Every other forward keeps the 2-layer rule and
# equal greedy tokens
MOE_INT8_POOL_PER_CALL = ("qwen3-30b-a3b",)


def phase_moe_forward() -> dict:
    """Phase 5 for the MoE presets (``family_forward``) at full width and 2
    layers: qwen3-30b-a3b (its q/k norms perturbed) and mixtral-8x7b (its
    norms perturbed, and the f32 run over int8 experts too), a
    MOE_PROMPT-token prefill and 8 decode steps. Returns the launch counts
    per model."""
    from bee2bee_tpu_torch.models.config import get_config

    out = {}
    for name, perturb in (("qwen3-30b-a3b", perturb_qwen), ("mixtral-8x7b", perturb_norms)):
        cfg = replace(get_config(name), n_layers=2, name=f"{name}-2layers")
        label = (f"forward 2x {name} width ({cfg.n_experts} experts of {cfg.d_ff}, "
                 f"{cfg.n_experts_per_tok} a token)")
        out[name] = family_forward(label, cfg, MOE_PROMPT, perturb,
                                   int8_experts=name == "mixtral-8x7b",
                                   int8_pool_per_call=name in MOE_INT8_POOL_PER_CALL)
    return out


def largest_dense_bytes(params) -> int:
    """The bytes of the largest floating tensor of a parameter tree."""
    return max(t.numel() * t.element_size() for _, t in tree_leaves(params)
               if t.is_floating_point())


def phase_moe_served(card: str) -> dict:
    """qwen3-30b-a3b at full width and depth (48 layers, 128 experts of
    768, 8 a token), bf16 over a bf16 pool, random from SEED with its q/k
    norms perturbed, serving phase 6's traffic with phase 6's checks (every
    root a graph replay, launch counts exact, the expert GEMM twice a layer
    of every replayed forward; a decode chunk and a prefill chunk replayed
    = eager bit for bit; the replayed B=8 step's breakdown), then one
    verify step of the n-gram tier (K = SPEC_K) replayed and run eagerly
    from one state; mixtral-8x7b (32 layers, 8 experts of 14,336, 2 a
    token) with int8 weights over a bf16 pool from the quantize-as-drawn
    random init (``init_params(quantize=True)``), whose peak device memory
    must stay within 1.05 x (the int8 model + its largest dense tensor),
    served the same way. Prints the device memory allocated before each.
    Returns the launch counts per run."""
    from bee2bee_tpu_torch.models.config import get_config
    from bee2bee_tpu_torch.models.params import init_params

    out = {}
    cfg = get_config("qwen3-30b-a3b")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"moe served: memory allocated before qwen3-30b-a3b {torch.cuda.memory_allocated()} B")
    t0 = time.perf_counter()
    params = family_params(cfg, torch.bfloat16, SEED)
    torch.cuda.synchronize()
    n = sum(t.numel() for _, t in tree_leaves(params))
    log(f"qwen3-30b-a3b: {cfg.n_layers} layers, {cfg.n_experts} experts of {cfg.d_ff}, {n} "
        f"parameters ({storage_bytes(params)} B bf16), q/k norm scales 1 + N(0, "
        f"{QWEN_NORM_STD}^2), random from seed {SEED} in {time.perf_counter() - t0:.2f} s")
    try:
        out["qwen3-30b-a3b"] = phase_slice(card, "bfloat16", params=params, model=cfg,
                                           light=True)[0]
        gc.collect()
        torch.cuda.empty_cache()
        out["qwen3-30b-a3b verify"] = moe_verify(params, cfg)
    finally:
        del params
        gc.collect()
        torch.cuda.empty_cache()
    cfg = get_config("mixtral-8x7b")
    base = torch.cuda.memory_allocated()
    log(f"moe served: memory allocated before mixtral-8x7b {base} B")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    params = init_params(cfg, gen, "cuda", torch.bfloat16, quantize=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    model, largest = storage_bytes(params), largest_dense_bytes(params)
    log(f"mixtral-8x7b: {cfg.n_layers} layers, {cfg.n_experts} experts of {cfg.d_ff}, int8 "
        f"weights drawn and quantized as drawn from seed {SEED + 1} in {init_s:.2f} s: "
        f"{model} B; peak {peak} B against 1.05 x (model + largest dense tensor {largest} B) = "
        f"{1.05 * (model + largest):.0f} B; card {card}")
    check(peak <= 1.05 * (model + largest), f"mixtral-8x7b int8 init: peak {peak} B")
    try:
        out["mixtral-8x7b int8"] = phase_slice(card, "bfloat16", params=params, quantize="int8",
                                               model=cfg, light=True)[0]
    finally:
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def moe_verify(params, cfg) -> dict:
    """One verify step of the n-gram tier (K = SPEC_K) over ``params``,
    replayed and run eagerly from one state (``verify_vs_eager``), on an
    engine that is closed and dropped before the return, so nothing holds
    the weights after. Returns the replay's launches."""
    engine = spec_engine(params, "bfloat16", "bfloat16", model=cfg, spec_tokens=SPEC_K)
    try:
        v = verify_vs_eager(engine, f"{cfg.name} spec[ngram, bfloat16 pool]")
        return {**v["launched"], **v["moe"]}
    finally:
        engine.close()


def phase_moe_checkpoints(card: str) -> dict:
    """The two MoE families' checkpoints (``checkpoint_family``: the
    published config.json cut to 2 layers, experts and routers under
    mixtral's and qwen3_moe's names), in a directory under build/ removed
    after. Returns the launch counts per model."""
    import shutil

    workdir = Path(__file__).resolve().parent / "build" / "ckpt_moe"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        return {name: checkpoint_family(card, name, workdir)
                for name in ("mixtral-8x7b", "qwen3-30b-a3b")}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def phase_moe(card: str, flush) -> dict:
    """Every MoE stage: the kernel cases, the forwards, the served slices
    and the checkpoints. Returns {"kernel", "forward", "served", "ckpt"}."""
    stage("moe kernel")
    kernel = phase_moe_kernel(flush)
    stage("moe forward parity")
    forward = phase_moe_forward()
    stage("moe served")
    served = phase_moe_served(card)
    stage("moe checkpoints")
    ckpt = phase_moe_checkpoints(card)
    return {"kernel": kernel, "forward": forward, "served": served, "ckpt": ckpt}


# ------------------------------------------------------------ adapter phase


ADAPTER_RANK = 16
ADAPTER_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# B's std: each target's delta about 0.2 of its projection (rank 16,
# scaling 1): enough to move greedy tokens on random weights
ADAPTER_B_STD = 0.05
ADAPTER_NEW = 48
# the mixed batch: 2 base rows, 2 per adapter
ADAPTER_ROWS = (None, None, "a1", "a1", "a2", "a2", "a3", "a3")
# the hot swap's streamed rows: 10 chunks of 32 tokens, one a pass
SWAP_NEW = 320


def random_adapter(cfg, seed: int):
    """An adapter at rank 16 over all seven targets, random from ``seed``,
    made on the card: A ~ N(0, 1/din), B ~ N(0, ADAPTER_B_STD^2)."""
    from bee2bee_tpu_torch.train.lora import LoraConfig, adapter_target_io

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    io = adapter_target_io(cfg)
    L, r = cfg.n_layers, ADAPTER_RANK
    adapters = {}
    for t in ADAPTER_TARGETS:
        din, dout = io[t]
        a = torch.randn((L, din, r), generator=gen, device="cuda") / math.sqrt(din)
        b = torch.randn((L, r, dout), generator=gen, device="cuda") * ADAPTER_B_STD
        adapters[t] = {"a": a, "b": b}
    return adapters, LoraConfig(rank=r, alpha=float(r), targets=ADAPTER_TARGETS)


def adapter_prompts(tokenizer) -> list:
    """8 prompts of 150-290 byte tokens, one a row."""
    words = ("adapters ride the same batch as the base model and each row "
             "gathers its own low rank factors in one replayed step ").split()
    out = []
    for r in range(8):
        text, i = "", 0
        n = 150 + 20 * r
        while len(text) < n:
            text += words[(i * 5 + r) % len(words)] + " "
            i += 1
        out.append(tokenizer.encode(text[:n]))
    return out


def adapter_engine(params, quantized: bool, prefix_entries: int = 0):
    from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine

    ecfg = EngineConfig(max_seq_len=2048, max_batch=8, kv_block_size=16, decode_chunk=32,
                        rng_seed=SEED, max_adapters=4,
                        quantize="int8" if quantized else "none",
                        prefix_cache_entries=prefix_entries)
    return InferenceEngine("llama-3-8b", params=params, engine_config=ecfg)


def adapter_burst(engine, prompts, rows, new_tokens=ADAPTER_NEW, on_first=None,
                  stream: bool = False):
    """Greedy requests, row i under adapter rows[i], queued together (one
    admission burst), ``stream``: through generate_stream (a window of one
    chunk: the scheduler's passes come a chunk apart); returns (token ids
    per row, wall s, end times)."""
    from bee2bee_tpu_torch.engine.introspect import device_gate

    out: list = [None] * len(prompts)
    ends: list = [0.0] * len(prompts)
    errors: list = []

    def call(i):
        try:
            if stream:
                for ev in engine.generate_stream(prompts[i], max_new_tokens=new_tokens,
                                                 temperature=0.0, adapter=rows[i]):
                    if ev.get("done"):
                        out[i] = ev["result"].token_ids
            else:
                out[i] = engine.generate(prompts[i], max_new_tokens=new_tokens,
                                         temperature=0.0, adapter=rows[i]).token_ids
            ends[i] = time.perf_counter()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append((i, repr(e)))

    sch = engine.scheduler
    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(prompts))]
    t0 = time.perf_counter()
    with device_gate.transition():
        for t in threads:
            t.start()
        while len(sch._queue) < len(prompts):
            time.sleep(0.001)
    if on_first is not None:
        on_first()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "adapters: generate calls hung")
    check(not errors, f"adapters: generate failed: {errors}")
    return out, wall, ends


def served_first_logits(engine) -> dict:
    """Wrap the scheduler's first-token sample: {row's prompt (tuple),
    adapter: the prefill root's last logits (f32 copy)}."""
    sch = engine.scheduler
    first = sch._first_token
    got: dict = {}

    def hooked(req, b):
        got[(tuple(req.ids), req.adapter)] = sch._p_logits[0].clone()
        return first(req, b)

    sch._first_token = hooked
    return got


def adapter_step_profile(engine, tag: str, card: str) -> None:
    """The replayed decode step at B=8 ctx 1024 with rows on slots [0, 0, 1,
    1, 2, 2, 3, 3] against the all-base step: host wall, device busy and
    the top kernels (where a grouped LoRA kernel would pay)."""
    sch = engine.scheduler
    key, v, load = decode_state(engine, B=8, ctx=1024)
    mixed = key[:3] + (True,) + key[4:]
    sch._d_aids[:8] = torch.tensor([0, 0, 1, 1, 2, 2, 3, 3], device="cuda")
    for label, k in (("all-base", key), ("mixed", mixed)):
        graph = sch._graphs.get(("decode", k)) or sch._capture(k)
        load()
        graph.replay()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            graph.replay()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 100.0
        busy, _, top, gemm, _ = device_profile(graph.replay, PROFILE_CALLS,
                                            PROFILE_CALLS * engine.model_cfg.n_layers)
        log(f"{tag}: replayed decode step B=8 ctx 1024, {label} rows (key {k}): host "
            f"wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
            f"{1 - busy / wall:.3f}; int8-weight GEMM {gemm:.3f} ms; top kernels {top}; "
            f"card {card}")
    sch._d_aids.zero_()
    sch._row_params_dirty = True


def phase_adapters(card: str, params, quantized: bool) -> dict:
    """Multi-LoRA serving over ``params`` (bf16, or int8 packed): an
    engine with 4 adapter slots loads three random adapters (rank 16, all
    seven targets) from the main thread (their device writes run on the
    scheduler thread). Checks: a mixed batch (2 base rows, 2 per adapter)
    against an all-base batch of the same width: base rows' tokens equal,
    each adapter's rows different; each adapter row's served first-token
    logits no further from a merge_lora-merged forward of that adapter
    (bf16) than that forward is from its f32 twin; a hot swap mid-
    generation (a fourth adapter evicting the cold one, a refresh of an
    idle one) leaves the running rows' tokens as a run without it; with the
    prefix cache on, adapter rows never hit; the adapter-flagged decode,
    prefill and first-token keys captured once each. Prints mixed vs
    all-base tok/s and the replayed mixed step's profile. Returns the
    launch counts of the mixed burst."""
    from bee2bee_tpu_torch.train.lora import merge_lora

    tag = f"adapters[{'int8' if quantized else 'bf16'} weights]"
    gc.collect()
    torch.cuda.empty_cache()
    engine = adapter_engine(params, quantized)
    cfg = engine.model_cfg
    try:
        pool = engine.adapter_pool
        made = {name: random_adapter(cfg, SEED + 100 + i)
                for i, name in enumerate(("cold", "a1", "a2", "a3", "a4", "a3b"))}
        # what a load gets: numpy factors, as from an .npz or a DHT fetch
        # (the device copies stay for the merged reference forwards)
        host = {name: ({t: {k: v.cpu().numpy() for k, v in ab.items()}
                        for t, ab in adapters.items()}, lcfg)
                for name, (adapters, lcfg) in made.items()}
        t0 = time.perf_counter()
        for name in ("cold", "a1", "a2", "a3"):
            engine.load_adapter(name, *host[name])
        load_s = time.perf_counter() - t0
        stacks, scales = pool.device_args()
        addrs = {t: (ab["a"].data_ptr(), ab["b"].data_ptr()) for t, ab in stacks.items()}
        log(f"{tag}: 4 adapters loaded in {load_s:.3f} s (rank {pool.rank}, targets "
            f"{pool.targets}); stacks {storage_bytes(stacks)} B; ledger adapter_pool "
            f"{engine.introspect.refresh()['hbm']['components'].get('adapter_pool')} B")
        prompts = adapter_prompts(engine.tokenizer)
        base_rows = (None,) * 8
        base_toks, base_wall, _ = adapter_burst(engine, prompts, base_rows)
        logits = served_first_logits(engine)
        reset_counts()
        reset_gemm_counts()
        mixed_toks, mixed_wall, _ = adapter_burst(engine, prompts, ADAPTER_ROWS)
        torch.cuda.synchronize()
        counts = {**read_counts(), **gemm_counts()}
        engine.scheduler._first_token = type(engine.scheduler)._first_token.__get__(
            engine.scheduler)
        n_tok = 8 * ADAPTER_NEW
        log(f"{tag}: all-base batch {n_tok} tokens in {base_wall:.3f} s -> "
            f"{n_tok / base_wall:.2f} tok/s; mixed batch (rows {ADAPTER_ROWS}) in "
            f"{mixed_wall:.3f} s -> {n_tok / mixed_wall:.2f} tok/s "
            f"({base_wall / mixed_wall:.3f}x); launches {counts}; card {card}")
        for i, name in enumerate(ADAPTER_ROWS):
            if name is None:
                check(mixed_toks[i] == base_toks[i],
                      f"{tag}: base row {i} differs in the mixed batch: {mixed_toks[i]} "
                      f"vs {base_toks[i]}")
        for name in ("a1", "a2", "a3"):
            rows = [i for i, n in enumerate(ADAPTER_ROWS) if n == name]
            check(any(mixed_toks[i] != base_toks[i] for i in rows),
                  f"{tag}: adapter {name} left its rows' greedy tokens unchanged")
        log(f"{tag}: base rows equal the all-base batch's; adapter rows' first "
            f"divergence from base at token "
            f"{[next((j for j, (x, y) in enumerate(zip(mixed_toks[i], base_toks[i])) if x != y), None) for i in range(2, 8)]}")
        # first-token logits against merge_lora-merged forwards, one adapter
        # at a time: bf16 (the merge's own cast), then f32 (in place on one
        # f32 copy, the delta added and taken off again)
        refs: dict = {}
        for name in ("a1", "a2", "a3"):
            i = ADAPTER_ROWS.index(name)
            run = logits_run(cfg, prompts[i], new_steps=0)
            base = params if not quantized else _dense(params, torch.bfloat16)
            merged = merge_lora(base, *made[name])
            refs[name] = [run(merged)[0][-1]]
            del merged, base
            gc.collect()
            torch.cuda.empty_cache()
        dense32 = _dense(params, torch.float32)
        for name in ("a1", "a2", "a3"):
            i = ADAPTER_ROWS.index(name)
            run = logits_run(cfg, prompts[i], new_steps=0)
            adapters, lcfg = made[name]
            for sign in (1.0, -1.0):
                for t, ab in adapters.items():
                    grp = "attn" if t in ("wq", "wk", "wv", "wo") else "mlp"
                    for li, lp in enumerate(dense32["layers"]):
                        lp[grp][t].add_((ab["a"][li] @ ab["b"][li]) * (sign * lcfg.scaling))
                if sign > 0:
                    refs[name].append(run(dense32)[0][-1])
        del dense32
        gc.collect()
        torch.cuda.empty_cache()
        for name in ("a1", "a2", "a3"):
            i = ADAPTER_ROWS.index(name)
            served = logits[(tuple(prompts[i]), name)]
            b16, f32 = refs[name]
            # served and the merged bf16 forward are two bf16 computations of
            # the merged f32 function: the served logits may sit no further
            # from it than twice the merged bf16 forward's distance (the
            # prefix phase's rule)
            err = (served - f32).abs().max().item()
            tol = 2.0 * (b16 - f32).abs().max().item()
            log(f"{tag}: adapter {name} first-token logits vs its merge_lora-merged "
                f"forward (f32): max abs {err:.4e} (tol {tol:.4e}: twice the merged "
                f"bf16 forward's distance from it); vs the merged bf16 forward "
                f"{(served - b16).abs().max().item():.4e}; argmax served "
                f"{int(served.argmax())} merged bf16 {int(b16.argmax())} f32 "
                f"{int(f32.argmax())}")
            check(err <= tol, f"{tag}: adapter {name} logits {err} > {tol}")
        # hot swap: rows on a1/a2 (and base) generate while a4 is loaded
        # (evicting the LRU idle adapter, "cold") and a3 is refreshed
        swap_rows = (None, "a1", "a2", None, "a1", "a2", None, "a1")
        # streamed rows: one chunk a pass, so the swap's device writes
        # (queued for the scheduler's next pass) land between two chunks of
        # the running rows
        ref_toks, _, _ = adapter_burst(engine, prompts, swap_rows, new_tokens=SWAP_NEW,
                                       stream=True)
        sch = engine.scheduler
        swapped: dict = {}

        def swap():
            t0 = time.perf_counter()
            while sch.stats.chunks == swapped.setdefault("c0", sch.stats.chunks):
                time.sleep(0.001)
            swapped["active"] = sch.active
            swapped["wait_s"] = time.perf_counter() - t0
            # each load's device writes run on the scheduler thread between
            # two passes; the chunk count read there after each says how
            # many chunks the rows had dispatched before it
            for name, made_as in (("a4", "a4"), ("a3", "a3b")):
                t1 = time.perf_counter()
                engine.load_adapter(name, *host[made_as])
                sch.run_on_device(lambda n=name: swapped.update({n: sch.stats.chunks}))
                swapped[name + "_s"] = time.perf_counter() - t1

        evictions = pool.evictions
        swap_toks, swap_wall, ends = adapter_burst(engine, prompts, swap_rows,
                                                   new_tokens=SWAP_NEW, stream=True,
                                                   on_first=swap)
        late = min(sch.stats.chunks - swapped[n] for n in ("a4", "a3"))
        stacks2, scales2 = pool.device_args()
        same_addrs = all((ab["a"].data_ptr(), ab["b"].data_ptr()) == addrs[t]
                         for t, ab in stacks2.items()) and scales2 is scales
        log(f"{tag}: hot swap with {swapped['active']} rows running (after "
            f"{swapped['wait_s']:.3f} s; loads {swapped['a4_s']:.3f} s and "
            f"{swapped['a3_s']:.3f} s, chunks dispatched by then {swapped['a4']}, "
            f"{swapped['a3']} of {sch.stats.chunks}; burst {swap_wall:.3f} s): resident "
            f"{pool.resident()}, evictions +{pool.evictions - evictions}, {late} decode "
            f"chunks ran after each write; the stacks kept their storage {same_addrs}; "
            f"running rows' tokens equal the no-swap run's "
            f"{swap_toks == ref_toks}")
        check(swapped["active"] > 0 and late > 0, f"{tag}: the swap missed the generation")
        check(pool.resident() == ["a1", "a2", "a3", "a4"]
              and pool.evictions - evictions == 1, f"{tag}: resident {pool.resident()}")
        check(same_addrs, f"{tag}: the adapter stacks moved")
        check(swap_toks == ref_toks, f"{tag}: the hot swap changed running rows' tokens")
        # the adapter-flagged keys of each root, captured once each
        flagged = {}
        for root, idx in (("decode", 3), ("prefill", 2), ("first_token", 3)):
            keys = sch.stats.root_graphs.get(root, {"keys": {}})["keys"]
            flagged[root] = {k: n for k, (n, _) in keys.items() if k[idx]}
            check(flagged[root] and all(n == 1 for n in flagged[root].values()),
                  f"{tag}: {root} adapter keys {flagged[root]}")
        log(f"{tag}: adapter-flagged keys captured once each: {flagged}")
        adapter_step_profile(engine, tag, card)
    finally:
        engine.close()
    # the prefix cache: an adapter row's prompt is never matched or pinned
    engine = adapter_engine(params, quantized, prefix_entries=16)
    try:
        engine.load_adapter("a1", *host["a1"])
        p = adapter_prompts(engine.tokenizer)[0]
        for adapter in ("a1", "a1"):
            engine.generate(p, max_new_tokens=8, temperature=0.0, adapter=adapter)
        hits_adapter = engine.scheduler.stats.prefix_hits
        for _ in range(2):
            engine.generate(p, max_new_tokens=8, temperature=0.0)
        hits_base = engine.scheduler.stats.prefix_hits - hits_adapter
        log(f"{tag}: prefix cache on: the same adapter prompt twice -> "
            f"{hits_adapter} hits; the base prompt twice -> {hits_base} hit")
        check(hits_adapter == 0 and hits_base == 1,
              f"{tag}: prefix hits adapter {hits_adapter}, base {hits_base}")
    finally:
        engine.close()
    del made, host
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_adapters_both(card: str) -> None:
    """``--only adapters``: the adapter phase over random bf16 weights, then
    over int8 weights (the int8-weight engine's own init)."""
    from bee2bee_tpu_torch.models.config import get_config
    from bee2bee_tpu_torch.models.params import init_params
    from bee2bee_tpu_torch.models.quant import quantize_params_

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = init_params(get_config("llama-3-8b"), gen, "cuda", torch.bfloat16)
    phase_adapters(card, params, quantized=False)
    params = quantize_params_(params)
    gc.collect()
    torch.cuda.empty_cache()
    phase_adapters(card, params, quantized=True)


# ------------------------------------------------------------ prefix phase


# the prefix phase's traffic: conversations of about 1,000 byte tokens, a
# 64-token reply, then 40 new tokens. Turn 1's histories have distinct
# lengths (a hit is told by its length), most not a multiple of the block
# size (a hit then copies one partial block)
PREFIX_LENGTHS = (1000, 1003, 990, 1011, 997, 1019, 985, 1008)
PREFIX_REPLY = 64
PREFIX_NEW = 40
# one entry per turn-1 prompt and one per turn-2 prompt: with one entry
# per conversation, each turn-2 pin would evict (LRU) the entry of a
# conversation not yet admitted, and the burst would hit once
PREFIX_ENTRIES = 2 * len(PREFIX_LENGTHS)


def prefix_histories(tokenizer) -> list:
    """The turn-1 prompts (token ids), one distinct history each."""
    words = ("the cache pins every prompt's blocks and a later turn that "
             "extends it reads them again through its own table ").split()
    out = []
    for c, n in enumerate(PREFIX_LENGTHS):
        text, i = f"conversation {c}: ", 0
        while len(text) < 2 * n:
            text += words[(i * (c + 3) + c) % len(words)] + " "
            i += 1
        ids = tokenizer.encode(text)[:n]
        check(len(ids) == n, f"prefix: history {c} has {len(ids)} tokens, not {n}")
        out.append(ids)
    return out


def prefix_engine(params, cache_dtype, dtype, entries, pool_blocks=None):
    from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine

    ecfg = EngineConfig(
        max_seq_len=2048, max_batch=8, kv_block_size=16, decode_chunk=32,
        rng_seed=SEED, dtype=dtype, cache_dtype=cache_dtype,
        prefix_cache_entries=entries, kv_pool_blocks=pool_blocks,
    )
    return InferenceEngine("llama-3-8b", params=params, engine_config=ecfg)


class PrefillWatch:
    """Wraps a scheduler's prefill chunk (a replay of the prefill root):
    for every chunk, its offset, its write floor and ceil (the prompt's
    length), its width, and the attention launches it added (host
    counters, read around the call: no sync; a capture's are put back);
    the last chunk's first-token logits by prompt length. Lengths
    identify the prompts of a burst (each distinct)."""

    def __init__(self, engine):
        self.sch = engine.scheduler
        self.chunks: list = []
        self.logits: dict = {}
        self._orig = self.sch._prefill_chunk
        self.sch._prefill_chunk = self._wrapped

    def _wrapped(self, chunk, bucket, pos, table, floor, ceil, aid=0):
        before = read_counts()
        out = self._orig(chunk, bucket, pos, table, floor, ceil, aid)
        after = read_counts()
        self.chunks.append(dict(
            offset=pos, floor=floor, n=ceil, T=bucket,
            launched={k: after[k] - before[k] for k in after if after[k] != before[k]},
        ))
        if pos + bucket >= ceil:  # the prompt's last chunk
            self.logits[ceil] = out.float().clone()
        return out

    def close(self):
        del self.sch._prefill_chunk


def warm_prefill_keys(engine, tag: str, prompts, starts) -> None:
    """Capture, before a timed burst, every prefill graph its admissions
    will replay (the chunk walk's keys: the bucket of the length left
    after the match, by the pow2 width of the blocks each chunk covers)
    and the greedy first-token graph, so the burst's TTFT holds no
    capture; prints the captures apart."""
    from bee2bee_tpu_torch.engine.paged import ceil_div, prefill_chunk_positions

    sch = engine.scheduler
    BS = engine.engine_cfg.kv_block_size
    C = engine.engine_cfg.prefill_chunk
    keys = set()
    for p, start in zip(prompts, starts):
        n = len(p)
        bucket = C if C is not None and n - start > C else engine._bucket_for(n - start)
        for pos in prefill_chunk_positions(n, start, bucket, engine.max_seq_len):
            keys.add(("prefill", (bucket, sch._table_width(ceil_div(min(pos + bucket, n), BS)),
                                  False)))
    keys.add(("first_token", (False, False, False, False)))
    todo = sorted(k for k in keys if k not in sch._graphs)
    t0 = time.perf_counter()
    for root, key in todo:
        sch._capture(key, root)
    log(f"{tag}: warmed {len(todo)} graphs before the burst in "
        f"{time.perf_counter() - t0:.3f} s: {todo}")


def burst(engine, prompts, new_tokens, together: bool = False):
    """Greedy requests, all at once (threads); returns (results, wall s).
    ``together``: every request is queued before the scheduler's next
    pass, so one admission burst takes them all (the same rows and table
    widths from run to run)."""
    from bee2bee_tpu_torch.engine.introspect import device_gate

    results: list = [None] * len(prompts)
    errors: list = []

    def call(i):
        try:
            results[i] = engine.generate(prompts[i], max_new_tokens=new_tokens,
                                         temperature=0.0)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append((i, repr(e)))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(prompts))]
    if together:
        sch = engine.scheduler
        with device_gate.transition():
            for t in threads:
                t.start()
            while len(sch._queue) < len(prompts):
                time.sleep(0.001)
    else:
        for t in threads:
            t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "prefix: generate calls hung")
    check(not errors, f"prefix: generate failed: {errors}")
    return results, wall


def ttft_summary(results) -> str:
    ms = sorted(r.ttft_s * 1e3 for r in results)
    return (f"median {statistics.median(ms):.1f} ms, range {ms[0]:.1f}-{ms[-1]:.1f} ms "
            f"over {len(ms)}")


def phase_prefix(card: str, params, cache_dtype: str, dtype="bfloat16",
                 prompts2=None) -> dict:
    """The prompt prefix cache on llama-3-8b at full width and depth, over
    the shared weights (see the module docstring). Turn 1: 8 concurrent
    misses; turn 2: each turn-1 prompt with its reply and 40 new tokens, 8
    concurrent hits; an exact repeat; the same turn 2 on a cache-off
    engine (the first-token logits and tokens a hit is held to). With
    ``prompts2`` (the f32 run, on the bf16 run's turn-2 prompts) turn 2 is
    those prompts. Returns the counts, the turn-2 prompts, and by prompt
    length the first-token logits and tokens of the hits and of the
    cache-off run."""
    from bee2bee_tpu_torch.engine import scheduler as sched_mod
    from bee2bee_tpu_torch.ops.ragged import ragged_kernel

    int8 = cache_dtype == "int8"
    tag = f"prefix[{dtype}, {cache_dtype} pool]"
    engine = prefix_engine(params, cache_dtype, dtype, PREFIX_ENTRIES)
    cfg = engine.model_cfg
    BS = engine.engine_cfg.kv_block_size
    G = cfg.n_heads // cfg.n_kv_heads
    suffix = "_int8" if int8 else ""
    log(f"{tag}: {cfg.name} {cfg.n_layers} layers, prefix_cache_entries "
        f"{PREFIX_ENTRIES}, pool {engine.pool_blocks} blocks ({pool_bytes(engine)} B)")
    turn1 = prefix_histories(engine.tokenizer)
    watch = PrefillWatch(engine)
    copies: list = []
    copy_block = sched_mod.copy_block

    def watched_copy(pool, src, dst):
        copy_block(pool, src, dst)
        # queued right behind the copy on the same stream: the target's
        # pages and scales against the donor's at the moment of the copy
        same = [(t[:, :, dst] == t[:, :, src]).all() for t in pool.values()]
        copies.append((src, dst, torch.stack(same)))

    sched_mod.copy_block = watched_copy
    out: dict = {}
    try:
        sch = engine.scheduler
        reset_counts()
        engine.forward_calls = 0
        since = graph_stats(engine, tag)
        warm_prefill_keys(engine, f"{tag}: turn 1", turn1, [0] * len(turn1))
        r1, wall1 = burst(engine, turn1, PREFIX_REPLY)
        entries = dict(sch._prefix_cache._entries)
        check(len(entries) == len(turn1) and all(tuple(p) in entries for p in turn1),
              f"{tag}: turn 1 pinned {len(entries)} entries")
        # the blocks turn 2 will share: each entry's full blocks
        shared = sorted({b for p in turn1 for b in entries[tuple(p)][:len(p) // BS]})
        idx = torch.tensor(shared, device="cuda")
        before = {k: t.index_select(2, idx).clone() for k, t in sch._cache.items()}
        if prompts2 is None:
            prompts2 = [p + r.token_ids + p[:PREFIX_NEW] for p, r in zip(turn1, r1)]
        check(len({len(p) for p in prompts2}) == len(prompts2),
              f"{tag}: turn-2 prompt lengths collide")
        st0 = (sch.stats.prefix_hits, sch.stats.prefix_tokens_saved,
               sch.stats.paged_blocks_copied)
        n_chunks = len(watch.chunks)
        repeat = prompts2[0]
        warm_prefill_keys(engine, f"{tag}: turn 2", prompts2 + [repeat],
                          [len(p) for p in turn1] + [len(repeat) - 1])
        r2, wall2 = burst(engine, prompts2, PREFIX_REPLY)
        hit_logits = {len(p): watch.logits[len(p)] for p in prompts2}
        n_chunks2 = len(watch.chunks)
        t1 = time.perf_counter()
        rr = engine.generate(repeat, max_new_tokens=PREFIX_REPLY, temperature=0.0)
        repeat_wall = time.perf_counter() - t1
        torch.cuda.synchronize()
        counts = read_counts()
        forwards = engine.forward_calls
        graphs = graph_stats(engine, tag, since)
        after = {k: t.index_select(2, idx) for k, t in sch._cache.items()}
        st = sch.stats
        starts = [len(p) for p in turn1] + [len(repeat) - 1]
        want = (len(starts), sum(starts), sum(s % BS != 0 for s in starts))
        got = (st.prefix_hits - st0[0], st.prefix_tokens_saved - st0[1],
               st.paged_blocks_copied - st0[2])
        check(st0 == (0, 0, 0) and got == want,
              f"{tag}: prefix hits, tokens saved, CoW copies {got} after {st0}, "
              f"the traffic implies {want}")
        # each hit's first chunk: at the match, floored there, at the bucket
        # of the remaining length, through the tile kernel, n_layers launches
        chunks2 = watch.chunks[n_chunks:n_chunks2]
        for p, start, chunks in zip(prompts2 + [repeat], starts,
                                    [chunks2] * len(prompts2) + [watch.chunks[n_chunks2:]]):
            first = [c for c in chunks if c["n"] == len(p)][0]
            bucket = engine._bucket_for(len(p) - start)
            kernel = RAGGED_COUNTERS[ragged_kernel(engine.dtype, bucket, cfg.head_dim,
                                                   int8, G)] + suffix
            check(first["offset"] == start and first["floor"] == start
                  and first["T"] == bucket and first["launched"] == {kernel: cfg.n_layers},
                  f"{tag}: the hit of the {len(p)}-token prompt ran {first}, "
                  f"expected offset {start}, bucket {bucket}, {cfg.n_layers} "
                  f"{kernel} launches")
        # every copy: the target's pages and scales equal the donor's
        same = torch.stack([s for _, _, s in copies]).cpu() if copies else None
        check(len(copies) == want[2] and bool(same.all()),
              f"{tag}: {len(copies)} CoW copies, target == donor per tensor "
              f"{same.tolist() if same is not None else None}")
        # the shared donor blocks, bit for bit, after the borrowers' prefill
        # and decode (their scales too over the int8 pool)
        for k in before:
            check(torch.equal(before[k], after[k]),
                  f"{tag}: shared donor blocks' {k} changed under the borrowers")
        log(f"{tag}: turn 1, 8 misses: TTFT {ttft_summary(r1)}; burst wall {wall1:.3f} s")
        log(f"{tag}: turn 2, 8 hits: TTFT {ttft_summary(r2)}; burst wall {wall2:.3f} s; "
            f"exact repeat (start n-1): TTFT {rr.ttft_s * 1e3:.1f} ms, wall "
            f"{repeat_wall:.3f} s; card {card}")
        log(f"{tag}: {got[0]} hits saved {got[1]} prompt tokens with {got[2]} CoW "
            f"copies; {len(shared)} shared donor blocks bit-equal before and after; "
            f"suffix buckets {sorted({engine._bucket_for(len(p) - s) for p, s in zip(prompts2, starts)})}; "
            f"launches {counts}, forwards {forwards}, graph replays {graphs['replays']}")
        # the launch identities of phases 6-8
        dec = [k for k in counts if k.startswith("ragged_decode") and counts[k]]
        tile = [k for k in counts if k.startswith("ragged_prefill") and counts[k]]
        others = {k: v for k, v in counts.items() if k not in dec + tile and v}
        n_dec, n_tile = sum(counts[k] for k in dec), sum(counts[k] for k in tile)
        check(len(dec) == 1 and len(tile) == 1 and not others
              and n_dec + n_tile == cfg.n_layers * forwards
              and n_dec == cfg.n_layers * graphs["replays"] > 0,
              f"{tag}: launches {counts} vs {cfg.n_layers} x {forwards} forwards, "
              f"{graphs['replays']} replays")
        out.update(counts=counts, prompts2=prompts2,
                   hit_logits=hit_logits,
                   tokens={len(p): r.token_ids for p, r in zip(prompts2, r2)},
                   ttft=dict(miss=[r.ttft_s for r in r1], hit=[r.ttft_s for r in r2]))
    finally:
        sched_mod.copy_block = copy_block
        watch.close()
        engine.close()
    del engine, before, after
    gc.collect()
    torch.cuda.empty_cache()
    # the same turn 2 without the cache: its tokens and first-token logits
    off = prefix_engine(params, cache_dtype, dtype, 0)
    watch = PrefillWatch(off)
    try:
        warm_prefill_keys(off, f"{tag}: cache off", prompts2, [0] * len(prompts2))
        r_off, wall_off = burst(off, prompts2, PREFIX_REPLY)
        log(f"{tag}: turn 2 cache off, 8 misses: TTFT {ttft_summary(r_off)}; burst "
            f"wall {wall_off:.3f} s; card {card}")
        out["off_logits"] = {len(p): watch.logits[len(p)] for p in prompts2}
        out["off_tokens"] = {len(p): r.token_ids for p, r in zip(prompts2, r_off)}
        out["ttft"]["off"] = [r.ttft_s for r in r_off]
    finally:
        watch.close()
        off.close()
    del off
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_prefix_pressure(card: str, params, cache_dtype: str) -> None:
    """One admission into a pool sized (kv_pool_blocks) so that it must
    evict a pinned entry: one row's blocks and 40 more. A 1,000-token
    prompt pins 63 blocks; a 1,900-token prompt then needs 119 with 107
    free, and the admission's precheck evicts the pin."""
    tag = f"prefix pressure[{cache_dtype} pool]"
    pool_blocks = 1 + -(-(2048 + 32) // 16) + 40  # the null block, one row, 40
    engine = prefix_engine(params, cache_dtype, "bfloat16", PREFIX_ENTRIES,
                           pool_blocks=pool_blocks)
    try:
        sch = engine.scheduler
        first, other = prefix_histories(engine.tokenizer)[:2]
        engine.generate(first, max_new_tokens=8, temperature=0.0)
        free = sch._alloc.free_count
        big = (other * 2)[:1900]  # shares no prefix with the pinned entry
        need = -(-len(big) // engine.engine_cfg.kv_block_size)
        check(need > free and tuple(first) in sch._prefix_cache._entries,
              f"{tag}: {need} blocks needed, {free} free: no pressure")
        r = engine.generate(big, max_new_tokens=8, temperature=0.0)
        keys = [len(k) for k in sch._prefix_cache._entries]
        check(r.new_tokens > 0 and keys == [len(big)] and sch.stats.paged_alloc_waits == 0,
              f"{tag}: after the admission the entries are {keys}, "
              f"{sch.stats.paged_alloc_waits} waits")
        log(f"{tag}: pool {pool_blocks} blocks; the {len(big)}-token admission needed "
            f"{need} blocks with {free} free and evicted the pinned {len(first)}-token "
            f"entry; card {card}")
    finally:
        engine.close()
    del engine
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------ spec phases


SPEC_K = 4
SPEC_NEW = 64


def spec_prompts(tokenizer, periodic: bool) -> list:
    """8 prompts of 200 token ids: a period-5..12 walk (the JAX spec test's
    periodic prompt, one period per row), or a period-499 walk (no n-gram
    repeats, the JAX drafter test's), one offset per row."""
    out = []
    for r in range(8):
        if periodic:
            period = [5 + (r * 31 + j * 7) % 997 for j in range(5 + r)]
            out.append((period * (200 // len(period) + 1))[:200])
        else:
            out.append([1 + (r * 53 + j * 97) % 499 for j in range(200)])
    return out


def spec_engine(params, dtype, cache_dtype, model="llama-3-8b", **spec):
    from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine

    ecfg = EngineConfig(max_seq_len=2048, max_batch=8, kv_block_size=16, decode_chunk=32,
                        rng_seed=SEED, dtype=dtype, cache_dtype=cache_dtype, **spec)
    return InferenceEngine(model, params=params, engine_config=ecfg)


def spec_burst(engine, prompts) -> tuple[list, float]:
    results, wall = burst(engine, prompts, SPEC_NEW, together=True)
    return [r.token_ids for r in results], wall


def spec_counts(engine, tag: str, since: dict, counts: dict) -> dict:
    """The spec run's graph and launch accounting: every forward is a
    replay (prefill, decode, verify), verify launches are n_layers x the
    verify replays through one kernel, the eager forwards all in warm-up
    and capture."""
    cfg = engine.model_cfg
    g = graph_stats(engine, tag, since)
    roots = g["roots"]
    verifies = roots["spec_verify"]["replays"]
    prefills = roots["prefill"]["replays"]
    decodes = g["replays"]
    st = engine.scheduler.stats
    log(f"{tag}: {g['spec_steps']} spec steps ({verifies} verify replays), "
        f"{prefills} prefill and {decodes} decode replays; drafted {st.spec_drafted}, "
        f"accepted {st.spec_accepted} (acceptance {st.spec_acceptance:.4f}), tiers "
        f"{st.spec_tiers}; launches {counts}")
    check(verifies == g["spec_steps"] > 0 and st.spec_drafted > 0,
          f"{tag}: {verifies} verify replays, {g['spec_steps']} spec steps, "
          f"{st.spec_drafted} drafted")
    return dict(verifies=verifies, prefills=prefills, decodes=decodes)


def phase_spec_ngram(card: str, params) -> dict:
    """Speculative decoding, n-gram tier, in f32 over an f32 pool, K=4: 8
    periodic prompts, 64 greedy tokens each, concurrently; the tokens
    must equal the spec-off engine's (8 x 64), every verify replay must
    launch the f32 decode kernel n_layers times (T = K+1 = 5 < T_MIN_F32),
    and drafts must have been proposed. Returns the counts."""
    from bee2bee_tpu_torch.ops.ragged import ragged_kernel

    tag = "spec[ngram, float32, float32 pool]"
    off = spec_engine(params, "float32", "float32")
    prompts = spec_prompts(off.tokenizer, periodic=True)
    try:
        want, wall_off = spec_burst(off, prompts)
    finally:
        off.close()
    del off
    gc.collect()
    torch.cuda.empty_cache()
    # the probe never retires the n-gram tier: every row is offered to it
    # for all 64 tokens
    engine = spec_engine(params, "float32", "float32", spec_tokens=SPEC_K,
                         spec_min_match=1, spec_probe_tokens=1 << 20)
    cfg = engine.model_cfg
    try:
        since = graph_stats(engine, tag)
        reset_counts()
        got, wall = spec_burst(engine, prompts)
        torch.cuda.synchronize()
        counts = read_counts()
        n = spec_counts(engine, tag, since, counts)
        G = cfg.n_heads // cfg.n_kv_heads
        kernel = RAGGED_COUNTERS[ragged_kernel(torch.float32, SPEC_K + 1, cfg.head_dim,
                                               False, G)]
        equal = sum(a == b for a, b in zip(got, want))
        log(f"{tag}: 8 x {SPEC_NEW} greedy tokens in {wall:.3f} s (spec off "
            f"{wall_off:.3f} s); {equal} of 8 rows equal to the spec-off engine's; the "
            f"verify shape's kernel {kernel}; card {card}")
        check(equal == len(prompts) and all(len(t) == SPEC_NEW for t in got),
              f"{tag}: spec-on tokens differ from spec-off: "
              f"{[(a[:8], b[:8]) for a, b in zip(got, want) if a != b][:2]}")
        check(kernel == "ragged_decode_f32"
              and counts["ragged_decode_f32"] == cfg.n_layers * (n["verifies"] + n["decodes"])
              and counts["ragged_prefill_f32"] == cfg.n_layers * n["prefills"],
              f"{tag}: launches {counts} vs {cfg.n_layers} x ({n['verifies']} verify + "
              f"{n['decodes']} decode, {n['prefills']} prefill) replays")
        others = {k: v for k, v in counts.items()
                  if k not in ("ragged_decode_f32", "ragged_prefill_f32") and v}
        check(not others, f"{tag}: other kernel forms launched: {others}")
        return counts
    finally:
        engine.close()
        del engine
        gc.collect()
        torch.cuda.empty_cache()


def phase_spec_model(card: str, params) -> dict:
    """Speculative decoding, model tier, bf16 over a bf16 pool, K=4: the
    drafter is llama-3-8b itself at the engine's seed (weight-identical
    to the target, a second 16 GB beside it), 8 prompts without n-gram
    repeats, 64 greedy tokens each, concurrently; the n-gram tier fails
    its probe at its first miss (K tokens: a miss costs a 32-token decode
    chunk) and rows escalate. Reports acceptance, agreement
    with the spec-off engine and, where a row diverges, the spec-off
    logit gap between the two tokens at the first divergence (a bf16
    near-tie); the draft and prime roots are captured once each; verify
    launches through the tile kernel n_layers x the verify replays. Then
    the verify step replayed vs eager over a bf16 and an int8 pool.
    Returns the counts (the bf16 run's)."""
    tag = "spec[model, bfloat16 pool]"
    off = spec_engine(params, "bfloat16", "bfloat16")
    prompts = spec_prompts(off.tokenizer, periodic=False)
    watch = PrefillWatch(off)
    try:
        want, wall_off = spec_burst(off, prompts)
        t0 = time.perf_counter()
        engine = spec_engine(params, "bfloat16", "bfloat16", spec_tokens=SPEC_K,
                             spec_probe_tokens=SPEC_K, drafter="llama-3-8b")
        load_s = time.perf_counter() - t0
        cfg = engine.model_cfg
        try:
            dm = engine.drafter_model
            since = graph_stats(engine, tag)
            reset_counts()
            got, wall = spec_burst(engine, prompts)
            torch.cuda.synchronize()
            counts = read_counts()
            n = spec_counts(engine, tag, since, counts)
            agree = []
            for p, a, b in zip(prompts, got, want):
                d = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
                gap = None
                if d is not None:
                    # the spec-off engine's logits at the divergence
                    off.generate(p + b[:d], max_new_tokens=1, temperature=0.0)
                    lg = watch.logits[len(p) + d][0]
                    gap = round((lg[b[d]] - lg[a[d]]).item(), 4)
                agree.append((len(a) if d is None else d, gap))
            st = engine.scheduler.stats
            model = st.spec_tiers.get("model", {"drafted": 0, "accepted": 0})
            log(f"{tag}: drafter {dm.cfg.name} loaded beside the target in {load_s:.2f} s "
                f"(seed {engine.engine_cfg.drafter_seed}); 8 x {SPEC_NEW} greedy tokens in "
                f"{wall:.3f} s (spec off {wall_off:.3f} s); model tier drafted "
                f"{model['drafted']}, accepted {model['accepted']}; draft root runs "
                f"{dm.runs}, captures (n, s) {dm.captures}; per row (tokens equal to "
                f"spec-off before the first divergence, spec-off logit gap there) "
                f"{agree}; card {card}")
            check(model["drafted"] > 0, f"{tag}: the model tier never drafted")
            check(dm.captures["draft"][0] == 1 and dm.captures["draft_prime"][0] == 1,
                  f"{tag}: draft/prime captures {dm.captures}")
            check(counts["ragged_prefill"] == cfg.n_layers * (n["verifies"] + n["prefills"])
                  and counts["ragged_decode"] == cfg.n_layers * n["decodes"],
                  f"{tag}: launches {counts} vs {cfg.n_layers} x ({n['verifies']} verify + "
                  f"{n['prefills']} prefill, {n['decodes']} decode) replays")
            verify_vs_eager(engine, tag)
        finally:
            engine.close()
    finally:
        watch.close()
        off.close()
    del engine, off
    gc.collect()
    torch.cuda.empty_cache()
    int8 = spec_engine(params, "bfloat16", "int8", spec_tokens=SPEC_K)
    try:
        verify_vs_eager(int8, "spec[int8 pool]")
    finally:
        int8.close()
    del int8
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def check_prefix_logits(tag: str, run: dict, f32_off: dict) -> None:
    """A hit's first-token logits are as close to the f32 forward's (cache
    off) as the cache-off run's of the same pool are: no further than
    twice that distance, prompt by prompt. The hit and the cache-off run
    are two computations of one f32 result in the pool's precision (other
    chunk widths, so other GEMM shapes; the reply's K/V from decode
    steps), each its own rounding history; a hit that read a wrong block,
    a stale copy or a zeroed scale lands orders of magnitude outside. The
    direct distance |hit - cache off| is printed beside, with the bf16
    forward's distance to the f32 one (PERF.md §2's bf16 yardstick): two
    rounding histories can be up to twice one history's distance apart
    (triangle inequality), so that yardstick alone is not a bound here."""
    gaps = []
    for n, hit in run["hit_logits"].items():
        off, ref = run["off_logits"][n], f32_off[n]
        d_hit = (hit - ref).abs().max().item()
        d_off = (off - ref).abs().max().item()
        gaps.append((n, round((hit - off).abs().max().item(), 4), round(d_hit, 4),
                     round(d_off, 4)))
        check(d_hit <= 2 * d_off, f"{tag}: the {n}-token hit's logits are {d_hit} from "
              f"the f32 forward's, the cache-off run's {d_off}")
    log(f"{tag}: first-token logits, (prompt tokens, |hit - cache off|, "
        f"|hit - f32|, |cache off - f32|): {gaps}")


# ------------------------------------------------------------ phase 9


# the node's packages that the card's machine may lack: the node picks the
# loopback transport without websockets, reports 0 cpu/ram without psutil,
# and cannot run its aiohttp gateway without aiohttp
NODE_PACKAGES = ("aiohttp", "websockets", "click", "psutil", "httpx", "ml_dtypes")
NODE_NEW_TOKENS = 32
NODE_ROUNDS = 3
NODE_BOOT_TIMEOUT_S = 600
NODE_PREFIX_ENTRIES = 8
NODE_PROFILE_S = 1.0
# the node's queue-wait SLO (health.py, engine.queue_wait_ms): a stream beside a
# profile must not stall this long
NODE_QUEUE_SLO_MS = 4096
# the economics gauges and counters /metrics must carry
NODE_ECONOMICS = ("bee2bee_engine_mfu", "bee2bee_engine_goodput_tokens_per_s",
                  "bee2bee_engine_hbm_bytes", "bee2bee_engine_hbm_headroom_frac",
                  "bee2bee_engine_compiles_total")
NODE_STOP_TIMEOUT_S = 60


def node_prompt() -> str:
    """One user turn of about 300 bytes; every route turns it into the same
    "user: ...\nassistant:" prompt (the gateway's /v1 messages too)."""
    words = ("a mesh node on the card answers the gateway the stream and its "
             "peers with the same greedy tokens from one engine ").split()
    text, i = "", 0
    while len(text) < 294:
        text += words[(i * 5 + 3) % len(words)] + " "
        i += 1
    return "user: " + text[:294].strip()


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def http_json(method: str, url: str, body=None, timeout: float = 600):
    """(status, parsed JSON or text) of one request over stdlib urllib."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read().decode()
        kind = r.headers.get("Content-Type", "")
        return r.status, (json.loads(raw) if "json" in kind else raw)


def http_sse_text(url: str, body, timeout: float = 600, gaps: list | None = None):
    """Stream an OpenAI chat completion: (joined deltas, s to the first
    delta, s to the end, events) on the client's clock. With ``gaps``, each
    event's (time, seconds from the request or the event before) is
    appended there."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    t0 = last = time.perf_counter()
    first, parts, events = None, [], 0
    with urllib.request.urlopen(req, timeout=timeout) as r:
        check(r.status == 200, f"node: stream answered {r.status}")
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                break
            event = json.loads(line[len("data: "):])
            check("error" not in event, f"node: stream error {event}")
            events += 1
            if gaps is not None:
                now = time.perf_counter()
                gaps.append((now, now - last))
                last = now
            delta = event["choices"][0].get("delta", {}).get("content")
            if delta:
                if first is None:
                    first = time.perf_counter() - t0
                parts.append(delta)
    return "".join(parts), first, time.perf_counter() - t0, events


def direct_stream_text(svc, params):
    """The service's own stream: (joined text, s to the first visible text,
    s to the end, lines) on the caller's clock."""
    t0 = time.perf_counter()
    first, parts, lines = None, [], 0
    for raw in svc.execute_stream(params):
        line = json.loads(raw)
        check(line.get("status") != "error", f"node: execute_stream error {line}")
        lines += 1
        if line.get("text"):
            if first is None:
                first = time.perf_counter() - t0
            parts.append(line["text"])
    check(first is not None, "node: execute_stream carried no text")
    return "".join(parts), first, time.perf_counter() - t0, lines


def http_bytes(url: str, timeout: float = 120):
    """(status, body bytes) of a GET."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def phase_node_prefix(card: str) -> None:
    """Phase 9, second node: serve-cuda's path with
    ``BEE2BEE_PREFIX_CACHE=8`` read by ``load_config`` as ``serve-cuda``
    reads it. One greedy request of the node prompt (a miss) and one more
    (an exact-repeat hit, the reference text: a hit recomputes the last
    prompt position in another chunk width, so at a bf16 near-tie its
    greedy text can leave the miss's); then a device profile (``POST
    /debug/profile``) while streams of the prompt run back to back (each
    text equal to the reference) and, once the trace's export starts, a
    stream of a longer prompt that needs a prefill key not yet captured
    (its capture runs beside the export: the scheduler takes
    ``graph_capture_lock`` and starts each new key's capture before the
    export ends, not held behind it; the stream's longest gap, the first
    token's wait included, under the queue-wait SLO), listed and fetched
    through ``GET``, its
    chrome trace naming the decode kernel; ``/metrics`` samples of the
    economics names; and a second turn extending the first, admitted as
    one hit over the whole first-turn prompt."""
    import asyncio
    import io
    import zipfile

    from bee2bee_tpu_torch.config import load_config
    from bee2bee_tpu_torch.meshnet.runtime import run_p2p_node

    os.environ["BEE2BEE_PREFIX_CACHE"] = str(NODE_PREFIX_ENTRIES)
    try:
        cfg = replace(load_config(), host="127.0.0.1", port=free_port(),
                      api_port=free_port(), bootstrap_url="")
    finally:
        del os.environ["BEE2BEE_PREFIX_CACHE"]
    check(cfg.prefix_cache_entries == NODE_PREFIX_ENTRIES,
          f"node+prefix: BEE2BEE_PREFIX_CACHE gave {cfg.prefix_cache_entries} entries")
    base = f"http://127.0.0.1:{cfg.api_port}"
    prompt = node_prompt()
    ask = {"prompt": prompt, "model": "llama-3-8b", "max_new_tokens": NODE_NEW_TOKENS,
           "temperature": 0.0}
    body = {"model": "llama-3-8b", "stream": True, "temperature": 0.0,
            "max_tokens": NODE_NEW_TOKENS,
            "messages": [{"role": "user", "content": prompt[len("user: "):]}]}
    holder: dict = {}

    async def drive():
        loop = asyncio.get_running_loop()
        ready, stop = asyncio.Event(), asyncio.Event()
        booted: list = []

        async def post_start(node):
            booted.append(node)

        task = asyncio.create_task(run_p2p_node(
            backend="cuda", model="llama-3-8b", cfg=cfg, serve_api=True,
            registry_sync=False, ready_event=ready, shutdown_event=stop,
            post_start=post_start,
        ))
        try:
            await asyncio.wait_for(ready.wait(), NODE_BOOT_TIMEOUT_S)
            engine = booted[0].local_services["cuda"].engine
            holder["engine"] = engine
            st = engine.scheduler.stats
            check(engine.engine_cfg.prefix_cache_entries == NODE_PREFIX_ENTRIES,
                  f"node+prefix: the engine runs {engine.engine_cfg.prefix_cache_entries} entries")
            turn1 = []
            for _ in range(2):  # the miss, then the reference hit
                status, r = await loop.run_in_executor(None, http_json, "POST",
                                                       base + "/chat", ask)
                check(status == 200 and r.get("tokens"), f"node+prefix: /chat {status} {r}")
                turn1.append(r)
            miss, hit = turn1
            check((st.prefix_hits, st.prefix_tokens_saved)
                  == (1, hit["prompt_tokens"] - 1),
                  f"node+prefix: the repeat counted {st.prefix_hits} hits, "
                  f"{st.prefix_tokens_saved} tokens saved")
            from bee2bee_tpu_torch.engine.introspect import get_profiler

            # the profiler's windows and export on this clock, from
            # wrappers of its own
            profiler = get_profiler()
            exporting, spans = threading.Event(), {"windows": [], "export": []}
            real = {n: getattr(profiler, n) for n in ("_window", "_export")}

            def window(*args):
                t = time.perf_counter()
                try:
                    return real["_window"](*args)
                finally:
                    spans["windows"].append((t, time.perf_counter()))

            def export(*args):
                t = time.perf_counter()
                exporting.set()
                try:
                    return real["_export"](*args)
                finally:
                    spans["export"] = [t, time.perf_counter()]

            # a prompt of no shared block and a bucket no earlier request used
            words = prompt[len("user: "):].split()
            long_body = dict(body, messages=[{"role": "user", "content": " ".join(
                (words[::-1] + words[1::2]) * 2)}])
            new_key: dict = {}

            def new_key_stream():
                exporting.wait(300)
                keys = dict(st.root_graphs.get("prefill", {}).get("keys", {}))
                new_key["sent"] = time.perf_counter()
                new_key["gaps"] = []
                http_sse_text(base + "/v1/chat/completions", long_body, 600, new_key["gaps"])
                new_key["keys"] = sorted(set(st.root_graphs["prefill"]["keys"]) - set(keys))

            # each capture's root, key and span (from the lock taken to the
            # graph made) on the same clock
            scheduler, captures = engine.scheduler, []
            real_capture = scheduler._capture_locked

            def capture_locked(key, root="decode"):
                t = time.perf_counter()
                try:
                    return real_capture(key, root)
                finally:
                    captures.append((root, key, t, time.perf_counter()))

            profiler._window, profiler._export = window, export
            scheduler._capture_locked = capture_locked
            try:
                t0 = time.perf_counter()
                profile = loop.run_in_executor(None, http_json, "POST",
                                               base + "/debug/profile",
                                               {"duration_s": NODE_PROFILE_S}, 300)
                beside = loop.run_in_executor(None, new_key_stream)
                streamed, gaps = [], []
                while not profile.done():
                    got, *_ = await loop.run_in_executor(
                        None, http_sse_text, base + "/v1/chat/completions", body, 600, gaps)
                    streamed.append(got)
                status, header = await profile
                profile_s = time.perf_counter() - t0
                await beside
            finally:
                for n in real:
                    delattr(profiler, n)
                del scheduler._capture_locked

            def since(t):
                return round(t - t0, 3)

            end, gap = max(gaps, key=lambda g: g[1])
            gap_ms = gap * 1e3
            t_export, t_exported = spans["export"]
            new_end, new_gap = max(new_key["gaps"], key=lambda g: g[1])
            new_first = new_key["gaps"][0][0]
            new_caps = [(key, a, b) for root, key, a, b in captures
                        if root == "prefill" and key in new_key["keys"]]
            log(f"node+prefix: on the client's clock from the POST (s): the profiler's "
                f"windows {[(since(a), since(b)) for a, b in spans['windows']]}, its "
                f"export ({since(t_export)}, {since(t_exported)}); the streams' longest "
                f"gap {gap_ms:.1f} ms ending at {since(end)}; a stream needing the new "
                f"prefill keys {new_key['keys']} sent at {since(new_key['sent'])} (the "
                f"export's start), their captures (lock taken, graph made) "
                f"{[(key, since(a), since(b)) for key, a, b in new_caps]}, "
                f"its first token at {since(new_first)} "
                f"({'inside' if new_first < t_exported else 'after'} the export), its "
                f"longest gap {new_gap * 1e3:.1f} ms ending at {since(new_end)}; the "
                f"queue-wait SLO {NODE_QUEUE_SLO_MS} ms")
            check(gap_ms < NODE_QUEUE_SLO_MS,
                  f"node+prefix: the longest stream gap beside the profile is {gap_ms:.1f} "
                  f"ms, over the queue-wait SLO of {NODE_QUEUE_SLO_MS} ms")
            # beside the export: every new key's capture took the lock and
            # started before the export ended (how long a capture takes
            # against how long the export takes is no part of the claim)
            check(new_key["keys"] and {key for key, _, _ in new_caps} == set(new_key["keys"])
                  and all(a < t_exported for _, a, _ in new_caps)
                  and new_gap * 1e3 < NODE_QUEUE_SLO_MS,
                  f"node+prefix: the stream needing new prefill keys was not captured "
                  f"inside the export, or waited over the SLO (line above)")
            check(status == 200 and str(header.get("id", "")).startswith("prof-"),
                  f"node+prefix: POST /debug/profile answered {status} {header}")
            check(streamed and all(s == hit["text"] for s in streamed),
                  f"node+prefix: {len(streamed)} streams during the profile, texts "
                  f"{streamed[:3]} against {hit['text']!r}")
            status, listing = await loop.run_in_executor(None, http_json, "GET",
                                                         base + "/debug/profile")
            check(status == 200 and listing["active"] is None
                  and header["id"] in [p["id"] for p in listing["profiles"]],
                  f"node+prefix: GET /debug/profile listed {listing}")
            status, blob = await loop.run_in_executor(
                None, http_bytes, f"{base}/debug/profile?id={header['id']}")
            check(status == 200, f"node+prefix: GET /debug/profile?id= answered {status}")
            zf = zipfile.ZipFile(io.BytesIO(blob))
            # the chrome trace's device kernels: calls and microseconds by name
            kernels: dict = {}
            for ev in json.loads(zf.read("trace.json"))["traceEvents"]:
                if ev.get("cat") == "kernel":
                    calls, us = kernels.get(ev["name"], (0, 0.0))
                    kernels[ev["name"]] = (calls + 1, us + float(ev.get("dur", 0.0)))
            events = sum(calls for calls, _ in kernels.values())
            top = sorted(kernels.items(), key=lambda kv: -kv[1][1])
            decode = [(k[:40], v) for k, v in top if "ragged_decode" in k]
            check(bool(decode),
                  f"node+prefix: the profile's trace names no decode kernel: {top[:6]}")
            steps = {k: v if isinstance(v, list) else round(v, 3)
                     for k, v in get_profiler().last_timings.items()}
            log(f"node+prefix: /debug/profile {NODE_PROFILE_S} s capture {header} in "
                f"{profile_s:.2f} s beside {len(streamed)} streams (texts equal to the "
                f"hit's; the longest stream gap {gap_ms:.1f} ms against the queue-wait "
                f"SLO of {NODE_QUEUE_SLO_MS} ms); profiler start, stop, export s {steps}; the zip {len(blob)} B holds {zf.namelist()}, {events} kernel events; its top kernels "
                f"(calls, us) {[(k[:40], v) for k, v in top[:4]]}; decode kernels "
                f"{decode}; card {card}")
            status, prom = await loop.run_in_executor(None, http_bytes, base + "/metrics")
            lines = [ln for ln in prom.decode().splitlines()
                     if ln.startswith(NODE_ECONOMICS)]
            missing = [n for n in NODE_ECONOMICS
                       if not any(re.match(rf"{n}[{{ ]", ln) for ln in lines)]
            check(status == 200 and not missing,
                  f"node+prefix: /metrics has no sample of {missing}")
            log(f"node+prefix: /metrics economics {lines}")
            # turn 2: the first turn's transcript, its reply and a new line
            before = (st.prefix_hits, st.prefix_tokens_saved)
            turn2 = dict(ask, prompt=f"{prompt}\nassistant: {hit['text']}\nuser: and "
                                     "what does the second turn reuse?")
            status, r2 = await loop.run_in_executor(None, http_json, "POST",
                                                    base + "/chat", turn2)
            got = (st.prefix_hits - before[0], st.prefix_tokens_saved - before[1])
            check(status == 200 and got == (1, hit["prompt_tokens"]),
                  f"node+prefix: the second turn counted (hits, tokens saved) {got}, "
                  f"expected (1, {hit['prompt_tokens']}): {status} {r2}")
            log(f"node+prefix: the miss ttft {miss['ttft_ms']} ms, the repeat (a hit at "
                f"n - 1) {hit['ttft_ms']} ms, texts {'equal' if miss['text'] == hit['text'] else 'different'}; "
                f"the second turn of {r2.get('prompt_tokens')} prompt tokens admitted as "
                f"one hit over the first turn's {hit['prompt_tokens']}, ttft "
                f"{r2.get('ttft_ms')} ms; card {card}")
        finally:
            stop.set()
            node_obj = await asyncio.wait_for(task, NODE_STOP_TIMEOUT_S)
            check(node_obj._stopped, "node+prefix: not stopped")

    asyncio.run(drive())
    engine = holder.pop("engine", None)
    if engine is not None:
        thread = engine.scheduler._thread
        engine.close()
        check(not thread.is_alive(), "node+prefix: the engine's thread outlived the node")
    del engine
    gc.collect()
    torch.cuda.empty_cache()


def phase_node(card: str) -> dict:
    """Phase 9: serve-cuda's path in this process (see the module
    docstring). The counts are zeroed once the node is ready and read
    after the last request. Returns the counts."""
    import asyncio
    import importlib.util

    from bee2bee_tpu_torch.config import NodeConfig
    from bee2bee_tpu_torch.meshnet.node import P2PNode
    from bee2bee_tpu_torch.meshnet.runtime import run_p2p_node
    from bee2bee_tpu_torch.metrics import get_registry

    have = {name: importlib.util.find_spec(name) is not None for name in NODE_PACKAGES}
    log(f"node: packages {have}")
    serve_api = have["aiohttp"]
    if not serve_api:
        log("gateway: not run (aiohttp absent on this machine)")
    cfg = NodeConfig(host="127.0.0.1", port=free_port(), api_port=free_port(),
                     bootstrap_url="")
    base = f"http://127.0.0.1:{cfg.api_port}"
    prompt = node_prompt()
    ask = {"max_new_tokens": NODE_NEW_TOKENS, "temperature": 0.0}
    out: dict = {}

    async def drive():
        loop = asyncio.get_running_loop()
        ready, stop = asyncio.Event(), asyncio.Event()
        booted: list = []

        async def post_start(node):
            booted.append(node)

        async def heartbeat(gaps):
            # the event loop's longest stall while the service loads (from
            # the gateway's first answer on: the load follows the gateway's
            # start): the 16 GB init runs in an executor, so the loop ticks
            last = time.perf_counter()
            while not ready.is_set():
                await asyncio.sleep(0.01)
                now = time.perf_counter()
                gaps.append(now - last)
                last = now

        gaps: list = []
        beat = None
        t0 = time.perf_counter()
        task = asyncio.create_task(run_p2p_node(
            backend="cuda", model="llama-3-8b", cfg=cfg, serve_api=serve_api,
            registry_sync=False, ready_event=ready, shutdown_event=stop,
            post_start=post_start,
        ))
        client = P2PNode(host="127.0.0.1", port=0)
        try:
            # the gateway starts before the load: time its first answer
            answered = None
            while serve_api and answered is None and not ready.is_set():
                check(not task.done(), "node: boot failed before ready")
                try:
                    t1 = time.perf_counter()
                    status, _ = await loop.run_in_executor(
                        None, http_json, "GET", base + "/", None, 5)
                    answered = (status, time.perf_counter() - t1, ready.is_set())
                    beat = asyncio.create_task(heartbeat(gaps))
                except OSError:
                    await asyncio.sleep(0.05)
            await asyncio.wait_for(ready.wait(), NODE_BOOT_TIMEOUT_S)
            boot_s = time.perf_counter() - t0
            if serve_api and answered is None:  # the load beat the first answer
                t1 = time.perf_counter()
                status, _ = await loop.run_in_executor(None, http_json, "GET", base + "/")
                answered = (status, time.perf_counter() - t1, True)
            if beat is not None:
                await beat
            node = booted[0]
            svc = node.local_services["cuda"]
            engine = svc.engine
            stall = (f"{max(gaps) * 1e3:.1f} ms over {len(gaps)} 10 ms ticks" if gaps
                     else "not measured")
            log(f"node: booted in {boot_s:.2f} s (the service's load in an executor "
                f"inside it); the event loop's longest stall from the gateway's first "
                f"answer to ready: {stall}")
            if serve_api:
                check(answered is not None and answered[0] == 200,
                      f"node: the gateway's GET / answered {answered}")
                t1 = time.perf_counter()
                status, _ = await loop.run_in_executor(None, http_json, "GET", base + "/")
                log(f"node: the gateway's first GET / {answered[1] * 1e3:.1f} ms "
                    f"({'after' if answered[2] else 'during'} the load), the next "
                    f"{(time.perf_counter() - t1) * 1e3:.1f} ms")
            since = graph_stats(engine, "node")
            reset_counts()
            engine.forward_calls = 0
            # the node's first request pays its engine's first-use costs:
            # it goes straight to the service and is timed on its own
            t1 = time.perf_counter()
            cold = await loop.run_in_executor(None, svc.execute, {"prompt": prompt, **ask})
            log(f"node: first request (direct, cold) {cold['tokens']} tokens in "
                f"{(time.perf_counter() - t1) * 1e3:.1f} ms (engine ttft "
                f"{cold['ttft_ms']} ms)")
            texts = {"cold": cold["text"]}
            # the decode at batch 1 is host-bound, and the host's clock
            # varies from request to request: the gateway's /chat and the
            # direct call take turns, NODE_ROUNDS times each
            runs: dict = {"gateway": [], "direct": []}
            for i in range(NODE_ROUNDS):
                if serve_api:
                    t1 = time.perf_counter()
                    status, chat = await loop.run_in_executor(
                        None, http_json, "POST", base + "/chat",
                        {"prompt": prompt, "model": "llama-3-8b", **ask})
                    check(status == 200 and isinstance(chat.get("text"), str),
                          f"node: /chat answered {status} {chat}")
                    runs["gateway"].append((time.perf_counter() - t1, chat))
                    texts[f"gateway{i}"] = chat["text"]
                t1 = time.perf_counter()
                direct = await loop.run_in_executor(
                    None, svc.execute, {"prompt": prompt, **ask})
                runs["direct"].append((time.perf_counter() - t1, direct))
                texts[f"direct{i}"] = direct["text"]
            streams = {}
            if serve_api:
                body = {"model": "llama-3-8b", "stream": True, "temperature": 0.0,
                        "max_tokens": NODE_NEW_TOKENS,
                        "messages": [{"role": "user", "content": prompt[len("user: "):]}]}
                texts["stream"], *streams["gateway"] = await loop.run_in_executor(
                    None, http_sse_text, base + "/v1/chat/completions", body)
            texts["direct_stream"], *streams["direct"] = await loop.run_in_executor(
                None, direct_stream_text, svc, {"prompt": prompt, **ask})
            for path, rows in runs.items():
                if not rows:
                    continue
                walls = [w * 1e3 for w, _ in rows]
                ttfts = [r["ttft_ms"] for _, r in rows]
                rates = [r["tokens_per_sec"] for _, r in rows]
                first, end, events = streams[path]
                summary = dict(wall_ms=statistics.median(walls), ttft_ms=statistics.median(ttfts),
                               tok_s=statistics.median(rates), first_ms=first * 1e3,
                               end_ms=end * 1e3, tokens=rows[0][1]["tokens"])
                out[path] = summary
                log(f"node: {path}: {summary['tokens']} tokens, client wall {walls} ms, "
                    f"engine ttft {ttfts} ms, engine tok/s {rates}; its stream: first "
                    f"visible text {first * 1e3:.1f} ms, end {end * 1e3:.1f} ms, "
                    f"{events} events (client clock)")
            await client.start()
            link = node.join_link()
            check(await client.connect_bootstrap(link), f"node: join through {link} failed")
            for _ in range(200):
                if client.list_providers("llama-3-8b"):
                    break
                await asyncio.sleep(0.05)
            provs = client.list_providers("llama-3-8b")
            check([p["provider_id"] for p in provs] == [node.peer_id]
                  and provs[0].get("backend") == "cuda",
                  f"node: the joined peer sees providers {provs}")
            t1 = time.perf_counter()
            mesh = await client.request_generation(
                node.peer_id, prompt, model="llama-3-8b", **ask)
            mesh_s = time.perf_counter() - t1
            texts["mesh"] = mesh["text"]
            log(f"node: mesh gen_request {mesh['tokens']} tokens in {mesh_s * 1e3:.1f} ms")
            torch.cuda.synchronize()
            counts = read_counts()
            forwards = engine.forward_calls
            out["graphs"] = graph_stats(engine, "node", since)
            if serve_api:
                status, listed = await loop.run_in_executor(
                    None, http_json, "GET", base + "/providers")
                mine = [p for p in listed["providers"] if "llama-3-8b" in p.get("models", [])]
                check(status == 200 and len(mine) == 1 and mine[0].get("backend") == "cuda",
                      f"node: /providers lists {listed}")
                status, prom = await loop.run_in_executor(
                    None, http_json, "GET", base + "/metrics")
                status_j, snap = await loop.run_in_executor(
                    None, http_json, "GET", base + "/metrics?format=json")
                engine_names = {n for n in get_registry().snapshot() if n.startswith("engine.")}
                missing = engine_names - set(snap["metrics"])
                check(status == status_j == 200 and engine_names and not missing
                      and "bee2bee_engine_ttft_ms" in prom,
                      f"node: /metrics lacks {sorted(missing)}")
                log(f"node: /providers lists llama-3-8b with backend cuda; /metrics "
                    f"carries {len(engine_names)} engine.* names")
            log(f"node: texts {json.dumps(texts)[:600]}")
            check(len(set(texts.values())) == 1 and texts["cold"],
                  f"node: the routes' texts differ: {texts}")
            out.update(counts=counts, forwards=forwards, engine=engine, boot_s=boot_s)
        finally:
            await client.stop()
            stop.set()
            t1 = time.perf_counter()
            node_obj = await asyncio.wait_for(task, NODE_STOP_TIMEOUT_S)
            out["stop_s"] = time.perf_counter() - t1
            check(node_obj._stopped, "node: not stopped")

    # time the service's load where run_p2p_node runs it (in an executor)
    from bee2bee_tpu_torch.services.cuda import CUDAService

    load_sync = CUDAService.load_sync

    def timed_load(svc):
        t1 = time.perf_counter()
        svc = load_sync(svc)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t1
        return svc

    CUDAService.load_sync = timed_load
    try:
        asyncio.run(drive())
    finally:
        CUDAService.load_sync = load_sync
    log(f"node: the service's load {out['load_s']:.2f} s of the {out['boot_s']:.2f} s boot")
    engine = out.pop("engine")
    cfg_m = engine.model_cfg
    thread = engine.scheduler._thread
    engine.close()
    check(not thread.is_alive(), "node: the engine's scheduler thread outlived the node")
    counts, forwards = out["counts"], out["forwards"]
    log(f"node: stopped in {out['stop_s']:.2f} s; kernel launches {counts}, forward "
        f"calls {forwards}, n_layers {cfg_m.n_layers}")
    dec, tile = counts["ragged_decode"], counts["ragged_prefill"]
    check(dec > 0 and tile > 0 and dec + tile == cfg_m.n_layers * forwards,
          f"node: decode {dec} + tile {tile} launches != {cfg_m.n_layers} x {forwards}")
    replays = out["graphs"]["replays"]
    check(replays > 0 and dec == cfg_m.n_layers * replays,
          f"node: decode launches {dec} != {cfg_m.n_layers} x {replays} replayed "
          f"decode steps")
    others = {k: v for k, v in counts.items()
              if k not in ("ragged_decode", "ragged_prefill") and v}
    check(not others, f"node: other kernel forms launched: {others}")
    if "gateway" in out:
        g, d = out["gateway"], out["direct"]
        log(f"node: medians of {NODE_ROUNDS}, through the gateway vs direct: TTFT "
            f"{g['ttft_ms']} vs {d['ttft_ms']} ms (engine clock), {g['tok_s']} vs "
            f"{d['tok_s']} tok/s (engine clock), {g['tokens']} tokens in "
            f"{g['wall_ms']:.1f} vs {d['wall_ms']:.1f} ms (client clock); first visible "
            f"text of a stream {g['first_ms']:.1f} vs {d['first_ms']:.1f} ms; card {card}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------------------ migration

MIGRATE_NEW = 128  # new tokens each stream asks for
MIGRATE_AT = 32  # tokens every stream holds when the drain starts
# the single-row rungs' prompt: about 990 tokens, so the row moves at ctx
# about 1024
MIGRATE_SOLO_BYTES = 990
# A's pool in the pool-pressure check: the null block and 340 blocks, which
# admit the 8 prompts (322 blocks) but cannot grow them all by 128 tokens
MIGRATE_PRESSURE_BLOCKS = 341


def migrate_engine(params, dtype: str, cache_dtype: str, **over):
    """An engine of the migration phase: phase 6's config over the shared
    parameters (nothing on this path writes them)."""
    from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine

    ecfg = EngineConfig(max_seq_len=2048, max_batch=8, kv_block_size=16, decode_chunk=32,
                        rng_seed=SEED, dtype=dtype, cache_dtype=cache_dtype, **over)
    return InferenceEngine("llama-3-8b", params=params, engine_config=ecfg)


def engine_kernels(engine) -> tuple[str, str, str]:
    """(decode counter, tile counter, the decode kernel's launch attribute)
    the dispatch rule names for ``engine``'s decode steps and prefill
    chunks (every bucket is 64 tokens or more)."""
    from bee2bee_tpu_torch.ops.ragged import _COUNTERS, ragged_kernel

    cfg = engine.model_cfg
    G, q = cfg.n_heads // cfg.n_kv_heads, engine.kv_quantized
    suffix = "_int8" if q else ""
    dec = ragged_kernel(engine.dtype, 1, cfg.head_dim, q, G)
    tile = ragged_kernel(engine.dtype, 64, cfg.head_dim, q, G)
    return (RAGGED_COUNTERS[dec] + suffix, RAGGED_COUNTERS[tile] + suffix,
            ("int8_" if q else "") + _COUNTERS[dec])


def bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes, so that equality is bit equality (NaN included)."""
    return t.contiguous().view(torch.uint8)


class DrainProbe:
    """The numbers of one migration run: per row (keyed by prompt length)
    the source's gather, the bytes, each rung's start, the target's import
    and, right after each KV import, the target's blocks held bit for bit
    to what arrived and to what the source exported (read on the target's
    scheduler thread); per run the encode-and-hash, send and verify-and-join
    seconds. ``close()`` takes the wraps off."""

    def __init__(self, a, b, node_a, node_b):
        from bee2bee_tpu_torch.engine.paged import ceil_div

        self.rows: dict = {}
        self.bad: list = []
        self.encode_ms = self.send_ms = self.verify_ms = 0.0
        self.frame_bytes = 0
        self._undo: list = []
        self._current = None
        sa, sb = a.scheduler, b.scheduler
        snapshot_row, paged_import = sa._snapshot_row, sb._paged_import
        mgr, tgt = node_a.migration, node_b.migration
        encode, send, once = mgr._encode_chunks, mgr._send_chunk, mgr._migrate_once
        blocks = tgt.handle_blocks

        def row(req) -> dict:
            return self.rows.setdefault(len(req.ids), {"rungs": []})

        def snapshotted(b, req):
            t0 = time.perf_counter()
            snap = snapshot_row(b, req)
            kv = snap.get("_kv") or {}
            row(req).update(gather_ms=(time.perf_counter() - t0) * 1e3, ctx=snap["offset"],
                            kv=kv, bytes=sum(t.numel() * t.element_size()
                                             for t in kv.values()))
            return snap

        def imported(req, b, st):
            t0 = time.perf_counter()
            paged_import(req, b, st)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            r = row(req)
            r.update(import_ms=(t1 - t0) * 1e3, t_import=t1,
                     rung="kv" if st.get("kv") is not None else "reprefill")
            if st.get("kv") is not None:
                nb = ceil_div(st["offset"], sb._block_size)
                idx = torch.tensor(sb._row_blocks[b][:nb], device=sb._device)
                for name, t in sb._cache.items():
                    held = bits(t.index_select(2, idx).cpu())
                    if not (torch.equal(held, bits(st["kv"][name]))
                            and torch.equal(held, bits(r["kv"][name]))):
                        self.bad.append((len(req.ids), name))

        def encoded(rid, kv):
            t0 = time.perf_counter()
            frames = encode(rid, kv)
            self.encode_ms += (time.perf_counter() - t0) * 1e3
            self.frame_bytes += sum(len(f) for f in frames)
            return frames

        async def sent(ws, frame, seq):
            t0 = time.perf_counter()
            await send(ws, frame, seq)
            self.send_ms += (time.perf_counter() - t0) * 1e3

        async def rung(req, svc, snap, kv, *args, **kw):
            row(req)["rungs"].append(("kv" if kv is not None else "reprefill",
                                      time.perf_counter()))
            return await once(req, svc, snap, kv, *args, **kw)

        async def verified(ws, data):
            t0 = time.perf_counter()
            await blocks(ws, data)
            self.verify_ms += (time.perf_counter() - t0) * 1e3

        for obj, name, fn in ((sa, "_snapshot_row", snapshotted),
                              (sb, "_paged_import", imported),
                              (mgr, "_encode_chunks", encoded), (mgr, "_send_chunk", sent),
                              (mgr, "_migrate_once", rung), (tgt, "handle_blocks", verified)):
            setattr(obj, name, fn)
            self._undo.append(functools.partial(delattr, obj, name))

    def close(self):
        while self._undo:
            self._undo.pop()()

    def report(self, tag: str, card: str, t0: float, wall: float,
               start: str = "the drain's start") -> dict:
        """Print the run's numbers (the pause from ``t0``, ``start``);
        returns the rows' summary, their block tensors dropped."""
        rows = {k: r for k, r in self.rows.items() if "t_import" in r}
        for r in self.rows.values():
            r.pop("kv", None)
        out = {"rows": len(rows), "bytes": sum(r.get("bytes", 0) for r in rows.values()),
               "pause_ms": (max(r["t_import"] for r in rows.values()) - t0) * 1e3
               if rows else 0.0}
        for k in sorted(rows):
            r = rows[k]
            rung_ms = (r["t_import"] - r["rungs"][-1][1]) * 1e3 if r["rungs"] else 0.0
            log(f"{tag}: row of {k} prompt tokens at ctx {r.get('ctx')}: "
                f"{r.get('bytes', 0)} B gathered in {r.get('gather_ms', 0.0):.2f} ms; "
                f"rungs {[n for n, _ in r['rungs']]}, the last ({r['rung']}) "
                f"{rung_ms:.2f} ms from its start to the import's end; import on the "
                f"target {r['import_ms']:.2f} ms (scatter or re-prefill, synchronized)")
            r["rung_ms"] = rung_ms
        log(f"{tag}: {len(rows)} rows moved, {out['bytes']} B of blocks ({self.frame_bytes} B "
            f"of frames); encode + sha256 {self.encode_ms:.1f} ms, send "
            f"{self.send_ms:.1f} ms, verify + join at the target {self.verify_ms:.1f} ms; "
            f"pause {out['pause_ms']:.1f} ms from {start} to the last import"
            + (f", drain wall {wall * 1e3:.1f} ms (to the last migrated stream's end)"
               if wall else "") + f"; card {card}")
        out["rows_detail"] = rows
        return out


@contextlib.asynccontextmanager
async def migrate_mesh(engines, roles=(None, None)):
    """Two in-process nodes on free loopback ports serving ``engines`` (A,
    B) through CUDAService; B joins A, both announce and gossip. On exit
    the nodes stop and the engines' schedulers are unhooked."""
    import asyncio
    from concurrent.futures import ThreadPoolExecutor

    from bee2bee_tpu_torch.meshnet.node import P2PNode
    from bee2bee_tpu_torch.services import CUDAService

    # every stream blocks an executor thread, and the drain and the import
    # pumps take more
    asyncio.get_running_loop().set_default_executor(ThreadPoolExecutor(64))
    nodes = []
    try:
        for eng, role in zip(engines, roles):
            node = P2PNode(host="127.0.0.1", port=free_port(), disagg_role=role)
            node.ping_interval_s = 0.1
            await node.start()
            node.add_service(CUDAService("llama-3-8b", max_new_tokens=MIGRATE_NEW,
                                         engine=eng))
            nodes.append(node)
        a, b = nodes
        check(await b.connect_bootstrap(a.addr), "migrate: B could not join A")
        await settle(lambda: a.peers and b.peers)
        for node in nodes:
            await node.announce_service(node.local_services["cuda"])
        for node in nodes:
            await node.gossip_telemetry()
        check(await settle(lambda: all(len(x.health.fresh()) == 1 for x in nodes)),
              "migrate: the nodes never saw each other's digests")
        yield nodes
    finally:
        for node in nodes:
            try:
                await node.stop()
            except Exception:  # noqa: BLE001 — the phase's own error wins
                pass
        for eng in engines:
            sch = eng._scheduler
            if sch is not None:
                sch.migrate_cb = None
                sch.handoff_after_prefill = False


async def settle(cond, timeout: float = 30.0) -> bool:
    import asyncio

    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if cond():
            return True
        await asyncio.sleep(0.02)
    return cond()


async def run_streams(node, engine, prompts, drain=None):
    """``prompts`` as concurrent greedy streams of MIGRATE_NEW tokens through
    ``node``'s own serving path; with ``drain`` (a coroutine function) it
    is awaited once every stream holds MIGRATE_AT tokens. Returns (results
    in prompt order, the source's Request objects by prompt length, the
    drain's return, the drain's start, its wall seconds)."""
    import asyncio

    sch = engine.scheduler
    reqs: dict = {}

    def recorded(req):
        reqs[len(req.ids)] = req
        return type(sch).submit(sch, req)

    sch.submit = recorded
    try:
        tasks = [asyncio.create_task(node.request_generation(
            node.peer_id, p, model="llama-3-8b", max_new_tokens=MIGRATE_NEW,
            temperature=0.0, stream=True, on_chunk=lambda _piece: None)) for p in prompts]
        summary, t0, wall = None, 0.0, 0.0
        if drain is not None:
            while not (len(reqs) == len(prompts)
                       and all(len(r.out_ids) >= MIGRATE_AT for r in reqs.values())):
                check(not any(t.done() for t in tasks),
                      "migrate: a stream ended before the drain")
                await asyncio.sleep(0.005)
            t0 = time.perf_counter()
            summary = await drain()
            wall = time.perf_counter() - t0
        results = await asyncio.gather(*tasks)
    finally:
        del sch.submit
    return results, reqs, summary, t0, wall


def migrate_launches(tag: str, counts: dict, deltas: list) -> None:
    """The launches of a migration run against its engines' replays: each
    engine's decode kernel n_layers x its replayed decode steps, its tile
    kernel n_layers x its prefill replays (two engines with one pool type
    share the counters), every other counter 0."""
    want = {k: 0 for k in counts}
    for engine, d in deltas:
        dec, tile, _ = engine_kernels(engine)
        L = engine.model_cfg.n_layers
        want[dec] += L * d["replays"]
        want[tile] += L * d["roots"]["prefill"]["replays"]
    check(counts == want, f"{tag}: launches {counts} != {want} (n_layers x replays)")


def check_decode_graphs(tag: str, engine) -> None:
    """Each of ``engine``'s decode graphs adds n_layers launches of the
    decode kernel the rule names and one forward a replay, nothing else."""
    _, _, attr = engine_kernels(engine)
    L = engine.model_cfg.n_layers
    for (root, key), g in engine.scheduler._graphs.items():
        if root == "decode":
            got = {name: d for _h, name, d in g.deltas}
            check(got == {attr: L, "forward_calls": 1},
                  f"{tag}: decode graph {key} adds {got} a replay")


def agreement(a: list, b: list) -> int:
    """The length of the common prefix of two token lists."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def migrate_drain(card: str, tag: str, a, b, exact: bool, reprefill: bool = False) -> dict:
    """Check 1 / 2 / 3: phase 6's prompts as 8 concurrent greedy streams on
    A, served once unmigrated (the twin) and once drained onto B after
    MIGRATE_AT tokens. KV rung (``reprefill`` False): every row migrates
    with its blocks, bit-equal on B right after the import, no re-prefill;
    re-prefill rung: every row is refused typed at the KV rung and
    re-prefilled on B. ``exact``: the tokens and texts equal the twin's,
    else each row's agreement is printed. Returns the probe's summary."""
    import asyncio

    prompts = slice_prompts()
    sa, sb = a.scheduler, b.scheduler
    out: dict = {}

    async def drive():
        async with migrate_mesh([a, b]) as (na, nb):
            twin, twin_reqs, *_ = await run_streams(na, a, prompts)
            probe = DrainProbe(a, b, na, nb)
            st0 = (sb.stats.migrated_in, sb.stats.import_reprefills)
            since_a, since_b = graph_stats(a, tag), graph_stats(b, tag)
            reset_counts()
            try:
                results, reqs, summary, t0, wall = await run_streams(
                    na, a, prompts, drain=na.begin_drain)
                torch.cuda.synchronize()
                counts = read_counts()
            finally:
                probe.close()
            da, db = graph_stats(a, tag + " A", since_a), graph_stats(b, tag + " B", since_b)
            n = len(prompts)
            log(f"{tag}: drain summary {summary}")
            key = "reprefilled" if reprefill else "migrated"
            check(summary[key] == n and summary["failed"] == 0,
                  f"{tag}: drain summary {summary}")
            moved = (sb.stats.migrated_in - st0[0], sb.stats.import_reprefills - st0[1])
            check(moved == (n, n if reprefill else 0),
                  f"{tag}: B imported {moved[0]} rows, {moved[1]} of them re-prefilled")
            kv_rows = [r for r in probe.rows.values() if r.get("rung") == "kv"]
            check(not probe.bad and len(kv_rows) == (0 if reprefill else n),
                  f"{tag}: {len(kv_rows)} KV imports, blocks differing from the "
                  f"export: {probe.bad}")
            for i, (r, t) in enumerate(zip(results, twin)):
                check(r.get("tokens") == MIGRATE_NEW and t.get("tokens") == MIGRATE_NEW,
                      f"{tag}: stream {i}: {r.get('tokens')} tokens (twin "
                      f"{t.get('tokens')})")
            agree = {k: agreement(reqs[k].out_ids, twin_reqs[k].out_ids) for k in reqs}
            log(f"{tag}: tokens agreeing with the unmigrated twin, by prompt length: "
                f"{agree} of {MIGRATE_NEW}")
            if exact:
                check(all(v == MIGRATE_NEW for v in agree.values())
                      and [r["text"] for r in results] == [t["text"] for t in twin],
                      f"{tag}: migrated streams differ from the unmigrated twin")
            migrate_launches(tag, counts, [(a, da), (b, db)])
            check(db["replays"] > 0, f"{tag}: B replayed no decode step")
            if not reprefill:
                check(db["roots"]["prefill"]["replays"] == 0,
                      f"{tag}: B ran {db['roots']['prefill']['replays']} prefill chunks")
            else:
                check(db["roots"]["prefill"]["replays"] > 0, f"{tag}: B re-prefilled nothing")
            check_decode_graphs(tag, b)
            dec_b, tile_b, _ = engine_kernels(b)
            L = b.model_cfg.n_layers
            log(f"{tag}: launches {dict((k, v) for k, v in counts.items() if v)}: B's "
                f"{db['replays']} replayed decode steps x {L} = {db['replays'] * L} {dec_b}, "
                f"its {db['roots']['prefill']['replays']} prefill replays x {L} {tile_b}; "
                f"A's {da['replays']} decode steps and {da['roots']['prefill']['replays']} "
                f"prefill chunks")
            check(sa.stats.paged_blocks_in_use == 0 and sa._thread.is_alive(),
                  f"{tag}: A holds {sa.stats.paged_blocks_in_use} blocks after the drain "
                  f"(alive: {sa._thread.is_alive()})")
            out.update(probe.report(tag, card, t0, wall), counts=counts)

    asyncio.run(drive())
    return out


def migrate_solo(card: str, tag: str, a, b) -> dict:
    """One bf16 row of about 990 prompt tokens drained alone onto an idle
    B: its tokens equal its unmigrated twin's (one row on A, the same
    bucket, widths and graphs on B). Then the same row through the
    re-prefill rung (the KV rung skipped, ``force_reprefill``) twice: the
    first run captures B's prefill key, the second is timed. Returns both
    rungs' walls at ctx about 1024."""
    import asyncio

    prompt = slice_prompts((MIGRATE_SOLO_BYTES,))
    a.scheduler._sticky_idle_s = b.scheduler._sticky_idle_s = 0.0  # bucket 1 each
    out: dict = {}

    async def drive():
        async with migrate_mesh([a, b]) as (na, nb):
            twin, twin_reqs, *_ = await run_streams(na, a, prompt)
            for rung in ("kv", "reprefill", "reprefill"):
                na.end_drain()
                na.migration.force_reprefill = rung == "reprefill"
                probe = DrainProbe(a, b, na, nb)
                try:
                    results, reqs, summary, t0, wall = await run_streams(
                        na, a, prompt, drain=na.begin_drain)
                finally:
                    probe.close()
                key = "migrated" if rung == "kv" else "reprefilled"
                check(summary[key] == 1 and summary["failed"] == 0,
                      f"{tag} [{rung} rung]: drain summary {summary}")
                check(not probe.bad, f"{tag}: blocks differing from the export: {probe.bad}")
                (k, req), = reqs.items()
                agree = agreement(req.out_ids, twin_reqs[k].out_ids)
                log(f"{tag} [{rung} rung]: {agree} of {MIGRATE_NEW} tokens agree with the "
                    f"unmigrated twin")
                if rung == "kv":
                    check(agree == MIGRATE_NEW and results[0]["text"] == twin[0]["text"],
                          f"{tag}: the row migrated alone left its twin at token {agree}")
                rep = probe.report(f"{tag} [{rung} rung]", card, t0, wall)
                r = rep["rows_detail"][k]
                out[rung] = {"ctx": r["ctx"], "rung_ms": r["rung_ms"],
                             "gather_ms": r["gather_ms"], "import_ms": r["import_ms"]}
            na.migration.force_reprefill = False
    asyncio.run(drive())
    kv, rp = out["kv"], out["reprefill"]
    log(f"{tag}: one row at ctx {kv['ctx']}: KV rung {kv['gather_ms'] + kv['rung_ms']:.2f} ms "
        f"(gather {kv['gather_ms']:.2f} ms + export to import's end {kv['rung_ms']:.2f} ms, "
        f"scatter {kv['import_ms']:.2f} ms), re-prefill rung {rp['rung_ms']:.2f} ms "
        f"(the prefill on B {rp['import_ms']:.2f} ms); card {card}")
    return out


def migrate_disagg(card: str, tag: str, a, b) -> None:
    """Check 4: A is the prefill role, B the decode role. The 8 streams sent
    to A are each handed off after their first token: A replays no decode
    step, B decodes them all, and the tokens equal a B-only run's. Prints
    TTFT at A."""
    import asyncio

    prompts = slice_prompts()
    sa = a.scheduler

    async def drive():
        async with migrate_mesh([a, b], roles=("prefill", "decode")) as (na, nb):
            check(sa.handoff_after_prefill, f"{tag}: the prefill role did not hand off")
            twin, twin_reqs, *_ = await run_streams(nb, b, prompts)
            h0 = sa.stats.prefill_handoffs
            probe = DrainProbe(a, b, na, nb)
            since_a, since_b = graph_stats(a, tag), graph_stats(b, tag)
            reset_counts()
            t0 = time.perf_counter()
            try:
                results, reqs, *_ = await run_streams(na, a, prompts)
                torch.cuda.synchronize()
                counts = read_counts()
            finally:
                probe.close()
            da, db = graph_stats(a, tag + " A", since_a), graph_stats(b, tag + " B", since_b)
            handoffs = sa.stats.prefill_handoffs - h0
            check(handoffs == len(prompts), f"{tag}: {handoffs} handoffs")
            check(da["replays"] == 0, f"{tag}: A replayed {da['replays']} decode steps")
            check(not probe.bad, f"{tag}: blocks differing from the export: {probe.bad}")
            migrate_launches(tag, counts, [(a, da), (b, db)])
            check_decode_graphs(tag, b)
            agree = {k: agreement(reqs[k].out_ids, twin_reqs[k].out_ids) for k in reqs}
            log(f"{tag}: tokens agreeing with the B-only run, by prompt length: {agree} "
                f"of {MIGRATE_NEW}")
            check(all(v == MIGRATE_NEW for v in agree.values())
                  and [r["text"] for r in results] == [t["text"] for t in twin],
                  f"{tag}: handed-off streams differ from the B-only run")
            ttft = sorted(r["timing"]["ttft_ms"] for r in results)
            twin_ttft = sorted(t["timing"]["ttft_ms"] for t in twin)
            log(f"{tag}: {handoffs} rows handed off after prefill; TTFT at A "
                f"{ttft[0]}-{ttft[-1]} ms (the B-only run's {twin_ttft[0]}-{twin_ttft[-1]} ms); "
                f"A's decode launches 0, B's {counts[engine_kernels(b)[0]]}")
            probe.report(tag, card, t0, 0.0, start="the burst's start")
            out["counts"] = counts

    out: dict = {}
    asyncio.run(drive())
    return out["counts"]


def migrate_pressure(card: str, tag: str, a, b) -> None:
    """Check 5: A's pool (MIGRATE_PRESSURE_BLOCKS) admits the 8 prompts but
    cannot grow them all by MIGRATE_NEW tokens: the rows it cannot grow
    migrate to B (KV rung) and every stream finishes, with no typed
    error."""
    import asyncio

    prompts = slice_prompts()
    sa, sb = a.scheduler, b.scheduler

    async def drive():
        async with migrate_mesh([a, b]) as (na, nb):
            out0, in0 = sa.stats.migrated_out, sb.stats.migrated_in
            probe = DrainProbe(a, b, na, nb)
            since_a, since_b = graph_stats(a, tag), graph_stats(b, tag)
            reset_counts()
            t0 = time.perf_counter()
            try:
                results, reqs, *_ = await run_streams(na, a, prompts)
                torch.cuda.synchronize()
                counts = read_counts()
            finally:
                probe.close()
            da, db = graph_stats(a, tag + " A", since_a), graph_stats(b, tag + " B", since_b)
            migrate_launches(tag, counts, [(a, da), (b, db)])
            out["counts"] = counts
            moved = sa.stats.migrated_out - out0
            errors = [h for h in sa.stats.history if h.get("error")]
            check(moved > 0 and sb.stats.migrated_in - in0 == moved,
                  f"{tag}: {moved} rows left A, {sb.stats.migrated_in - in0} reached B")
            check(not errors, f"{tag}: typed errors {errors}")
            check(all(r.get("tokens") == MIGRATE_NEW for r in results),
                  f"{tag}: tokens {[r.get('tokens') for r in results]}")
            check(not probe.bad, f"{tag}: blocks differing from the export: {probe.bad}")
            log(f"{tag}: A's pool of {a.pool_blocks} blocks: {moved} of {len(prompts)} rows "
                f"migrated under pool pressure (prompt lengths "
                f"{sorted(k for k, r in probe.rows.items() if 't_import' in r)}), 0 typed "
                f"errors, every stream {MIGRATE_NEW} tokens")
            probe.report(tag, card, t0, 0.0, start="the burst's start")

    out: dict = {}
    asyncio.run(drive())
    return out["counts"]


def migrate_host_rates(card: str) -> None:
    """The host's per-byte costs of one 8 MiB KV_BLOCKS frame of llama-3-8b
    bf16 pages (4 blocks of k and v, random normal): the frame encode, the
    sha256 of its pieces, and what permessage-deflate at the websockets
    library's settings (zlib level 6, raw window 15, memLevel 5) would
    cost, which the port's transport no longer negotiates."""
    import hashlib
    import zlib

    from bee2bee_tpu_torch import protocol

    pages = torch.randn((32, 8, 4, 16, 128), dtype=torch.bfloat16)
    kv = {"k": pages, "v": pages.clone()}
    t0 = time.perf_counter()
    frame = protocol.encode_binary({"type": "kv_blocks"}, kv)
    t1 = time.perf_counter()
    for t in kv.values():
        hashlib.sha256(protocol.tensor_bytes(t)[2]).hexdigest()
    t2 = time.perf_counter()
    z = zlib.compressobj(6, zlib.DEFLATED, -15, 5)
    packed = z.compress(frame) + z.flush(zlib.Z_SYNC_FLUSH)
    t3 = time.perf_counter()
    mib = len(frame) / 2**20
    log(f"migrate: host, one {len(frame)} B frame of bf16 pages: encode "
        f"{(t1 - t0) * 1e3:.1f} ms, sha256 {(t2 - t1) * 1e3:.1f} ms "
        f"({mib / (t2 - t1):.0f} MiB/s), deflate {(t3 - t2) * 1e3:.1f} ms "
        f"({mib / (t3 - t2):.1f} MiB/s, to {len(packed) / len(frame):.3f} of the bytes); "
        f"card {card}")


def phase_migrate(card: str, params) -> dict:
    """The migration phase: checks 1, 4 and 5 over ``params`` (f32, shared
    by every engine), then 2 and 3 over the same weights cast to bf16.
    Returns the launches of its runs, summed (the single-row runs left
    out)."""
    total: dict = {}
    migrate_host_rates(card)

    def add(counts):
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n

    a, b = (migrate_engine(params, "float32", "float32") for _ in range(2))
    small = None
    try:
        add(migrate_drain(card, "migrate[f32, f32 pool]", a, b, exact=True)["counts"])
        add(migrate_disagg(card, "migrate[disagg, f32, f32 pool]", a, b))
        a.close()
        small = migrate_engine(params, "float32", "float32",
                               kv_pool_blocks=MIGRATE_PRESSURE_BLOCKS)
        add(migrate_pressure(card, "migrate[pool pressure, f32, f32 pool]", small, b))
    finally:
        for eng in (a, b, small):
            if eng is not None:
                eng.close()
    params = cast_tree(params, torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    a, b = (migrate_engine(params, "bfloat16", "bfloat16") for _ in range(2))
    a8 = b8 = None
    try:
        bf16 = migrate_drain(card, "migrate[bf16, bf16 pool]", a, b, exact=False)
        add(bf16["counts"])
        migrate_solo(card, "migrate[bf16, bf16 pool, one row]", a, b)
        a.close()
        a8, b8 = (migrate_engine(params, "bfloat16", "int8") for _ in range(2))
        int8 = migrate_drain(card, "migrate[bf16, int8 pool]", a8, b8, exact=False)
        add(int8["counts"])
        b8.close()
        log(f"migrate: bytes shipped int8 {int8['bytes']} B / bf16 {bf16['bytes']} B = "
            f"{int8['bytes'] / bf16['bytes']:.4f}; card {card}")
        add(migrate_drain(card, "migrate[int8 pool -> bf16 pool, re-prefill rung]", a8, b,
                          exact=False, reprefill=True)["counts"])
    finally:
        for eng in (a, b, a8, b8):
            if eng is not None:
                eng.close()
    return total


# ------------------------------------------------------------ checkpoint phase


CKPT_NAME = "llama-3.1-8b-2layers"
# meta-llama/Llama-3.1-8B's config.json at its published widths, with one
# cut: num_hidden_layers 32 -> 2, so the phase fits the smoke's time
LLAMA31_CONFIG = {
    "_name_or_path": CKPT_NAME, "architectures": ["LlamaForCausalLM"],
    "model_type": "llama", "hidden_size": 4096, "intermediate_size": 14336,
    "num_attention_heads": 32, "num_key_value_heads": 8, "num_hidden_layers": 2,
    "head_dim": 128, "vocab_size": 128256, "max_position_embeddings": 131072,
    "rope_theta": 500000.0,
    "rope_scaling": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
    "rms_norm_eps": 1e-5, "tie_word_embeddings": False, "hidden_act": "silu",
    "attention_bias": False, "mlp_bias": False, "bos_token_id": 128000,
    "eos_token_id": 128001, "torch_dtype": "bfloat16",
}
CKPT_SHARD_BYTES = 1_500_000_000  # three safetensors files at these widths
CKPT_NEW = 64
CKPT_F32_TOKENS = 128
ROPE_REL_TOL = 1e-6
INT8_LOAD_SLACK = 1.05


def tree_leaves(tree, prefix=""):
    """(path, tensor) of every leaf of a parameter tree, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def same_bits(a, b) -> list:
    """The paths where two parameter trees differ (names, shapes, dtypes
    or bits); [] when they are bit-equal."""
    la, lb = dict(tree_leaves(a)), dict(tree_leaves(b))
    if la.keys() != lb.keys():
        return sorted(set(la) ^ set(lb))
    return [k for k in la if la[k].dtype != lb[k].dtype or la[k].shape != lb[k].shape
            or not torch.equal(bits(la[k]), bits(lb[k].to(la[k].device)))]


def checkpoint_engine(quantize="none", checkpoint=None, params=None, cfg=None):
    from bee2bee_tpu_torch.engine import EngineConfig, InferenceEngine

    ecfg = EngineConfig(max_seq_len=2048, max_batch=8, kv_block_size=16, decode_chunk=32,
                        rng_seed=SEED, dtype="bfloat16", cache_dtype="bfloat16",
                        quantize=quantize)
    if checkpoint is not None:
        return InferenceEngine("auto", checkpoint_path=str(checkpoint), engine_config=ecfg)
    return InferenceEngine(cfg, params=params, engine_config=ecfg)


def checkpoint_burst(engine, tag: str, prompts):
    """Phase 6's prompts as 8 concurrent greedy requests of CKPT_NEW tokens
    in one admission burst: (token ids, first-token logits by prompt,
    launch counts). The decode + tile launches are n_layers x the engine's
    forward calls, both > 0."""
    from bee2bee_tpu_torch.ops.ragged import ragged_kernel

    first = served_first_logits(engine)
    reset_counts()
    engine.forward_calls = 0
    results, wall = burst(engine, prompts, CKPT_NEW, together=True)
    torch.cuda.synchronize()
    counts = read_counts()
    del engine.scheduler._first_token
    cfg = engine.model_cfg
    L = cfg.n_layers
    # the kernels the rule names for a decode step and a prefill chunk (every
    # prefill bucket is 64 tokens or more) of this model over a bf16 pool
    dec, tile = (RAGGED_COUNTERS[ragged_kernel(engine.dtype, T, cfg.head_dim, False,
                                               cfg.n_heads // cfg.n_kv_heads)]
                 for T in (1, 64))
    used = {k: v for k, v in counts.items() if v}
    check(set(used) == {dec, tile} and counts[dec] + counts[tile] == L * engine.forward_calls,
          f"{tag}: launches {used} against {engine.forward_calls} forwards x {L} layers")
    check_moe_launches(engine, tag, moe_counts(), engine.forward_calls)
    if cfg.is_moe:
        counts.update(moe_counts())
    log(f"{tag}: 8 greedy requests x {CKPT_NEW} tokens in {wall:.2f} s; launches {used} = "
        f"{L} layers x {engine.forward_calls} forwards")
    return [r.token_ids for r in results], {k[0]: v for k, v in first.items()}, counts


def rope_check(cfg, card: str) -> None:
    """The llama3-scaled frequency vector on the card against the float64
    formula (transformers' _compute_llama3_parameters)."""
    from bee2bee_tpu_torch.models import core

    got = core.rope_freqs(cfg, "cuda").double().cpu().numpy()
    rot = cfg.rotary_dim
    base = 1.0 / (cfg.rope_theta ** (np.arange(0, rot, 2, dtype=np.float64) / rot))
    _, factor, lo, hi, orig = cfg.rope_scaling
    wavelen = 2 * math.pi / base
    smooth = (orig / wavelen - lo) / (hi - lo)
    want = np.where(wavelen > orig / lo, base / factor,
                    np.where(wavelen < orig / hi, base,
                             (1 - smooth) * base / factor + smooth * base))
    rel = float(np.max(np.abs(got - want) / want))
    bands = (int(np.sum(wavelen < orig / hi)), int(np.sum(wavelen > orig / lo)))
    log(f"checkpoint[rope]: llama3-scaled frequencies on the card vs the float64 formula: "
        f"max relative error {rel:.3e} (tol {ROPE_REL_TOL:g}); {rot // 2} frequencies, "
        f"{bands[0]} kept, {bands[1]} divided by {factor}, the rest smoothed; card {card}")
    check(rel <= ROPE_REL_TOL, f"rope: relative error {rel} over {ROPE_REL_TOL}")


def teacher_forced(params, cfg, ids, toks, device):
    """f32 logits of a prefill of ``ids`` [T, V] and of one decode step per
    token of ``toks`` [len(toks), V] over a fresh f32 pool on ``device``."""
    from bee2bee_tpu_torch.models import core

    n, BS = len(ids), 16
    nblocks = -(-(n + len(toks)) // BS)
    tables = torch.zeros((1, 1 << (nblocks - 1).bit_length()), dtype=torch.int32,
                         device=device)
    tables[0, :nblocks] = torch.arange(1, nblocks + 1, dtype=torch.int32)
    pool = core.init_paged_pool(cfg, nblocks + 1, BS, torch.float32, device)
    pre, _ = core.forward(params, cfg, torch.tensor([ids], device=device), pool, 0, tables)
    steps = []
    for i, t in enumerate(toks):
        lg, _ = core.forward(params, cfg, torch.tensor([[t]], device=device), pool, n + i,
                             tables)
        steps.append(lg[0, -1])
    return pre[0], torch.stack(steps)


def checkpoint_f32_logits(engine, card: str) -> dict:
    """The loaded weights in f32: a CKPT_F32_TOKENS-token prefill (the f32
    tile form) and 4 decode steps (decode_f32) through the kernels against
    the plain CPU forward, FORWARD_TOL (phase 5's rule). Returns the
    launches."""
    cfg = engine.model_cfg
    L = cfg.n_layers
    p32 = cast_tree(engine.params, torch.float32)
    ids = np.random.default_rng(SEED + 14).integers(3, 259, size=CKPT_F32_TOKENS).tolist()
    toks = np.random.default_rng(SEED + 15).integers(3, 259, size=4).tolist()
    reset_counts()
    pre, steps = teacher_forced(p32, cfg, ids, toks, "cuda")
    torch.cuda.synchronize()
    counts = {k: v for k, v in read_counts().items() if v}
    check(counts == {"ragged_prefill_f32": L, "ragged_decode_f32": 4 * L},
          f"checkpoint[f32]: launches {counts}")
    cpu = cast_tree(p32, torch.float32, "cpu")
    del p32
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpre, csteps = teacher_forced(cpu, cfg, ids, toks, "cpu")
    cpu_s = time.perf_counter() - t0
    err = max((pre.cpu() - cpre).abs().max().item(), (steps.cpu() - csteps).abs().max().item())
    ok = bool(torch.isfinite(pre).all() and torch.isfinite(steps).all())
    log(f"checkpoint[f32]: {CKPT_F32_TOKENS}-token prefill + 4 decode steps of the loaded "
        f"llama-3.1 weights in f32 through the kernels ({counts}) vs the plain CPU forward "
        f"({cpu_s:.1f} s): max abs logit error {err:.3e} (tol {FORWARD_TOL:g}); card {card}")
    check(ok and err <= FORWARD_TOL, f"checkpoint[f32]: logits {err} from the CPU forward")
    return counts


def checkpoint_native(engine, workdir: Path, card: str) -> None:
    """save_native -> load_native of the loaded weights: bit-equal, every
    piece within the frame budget."""
    from bee2bee_tpu_torch.models.loader import load_native, save_native
    from bee2bee_tpu_torch.pieces import DEFAULT_PIECE_SIZE

    path = workdir / "native"
    t0 = time.perf_counter()
    manifest = save_native(engine.params, engine.model_cfg, path)
    t1 = time.perf_counter()
    back = load_native(path, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    diff = same_bits(engine.params, back)
    largest = max(p.nbytes for p in manifest.pieces)
    log(f"checkpoint[native]: save_native {t1 - t0:.2f} s ({len(manifest.pieces)} pieces, "
        f"{manifest.total_bytes} B, largest {largest} B), load_native {t2 - t1:.2f} s; "
        f"bit-equal: {not diff}; card {card}")
    check(not diff and largest <= DEFAULT_PIECE_SIZE,
          f"checkpoint[native]: differs at {diff[:5]}, largest piece {largest} B")
    del back
    import shutil

    shutil.rmtree(path)


def checkpoint_mesh(cfg, ckpt: Path, card: str) -> dict:
    """Node P serves the checkpoint with --publish-weights; node J boots
    with --from-mesh and no checkpoint (and publishes too: a joined peer
    reseeds). J's weights bit-equal P's, equal greedy text through both
    gateways' /chat, J's /providers lists the model on backend cuda.
    Returns the launches of the two /chat calls."""
    import asyncio

    from bee2bee_tpu_torch.config import NodeConfig
    from bee2bee_tpu_torch.dht import DHTNode
    from bee2bee_tpu_torch.meshnet import weights
    from bee2bee_tpu_torch.meshnet.runtime import run_p2p_node
    from bee2bee_tpu_torch.pieces import DEFAULT_PIECE_SIZE

    published: list = []
    fetched: dict = {}
    publish, serve = weights.publish_model_weights, weights.serve_model_from_mesh

    async def timed_publish(node, *args, **kw):
        t0 = time.perf_counter()
        manifest = await publish(node, *args, **kw)
        published.append((node.peer_id, time.perf_counter() - t0, manifest))
        return manifest

    ask = {"prompt": node_prompt(), "model": CKPT_NAME, "max_new_tokens": NODE_NEW_TOKENS,
           "temperature": 0.0}
    out: dict = {}

    async def drive():
        loop = asyncio.get_running_loop()
        dht = DHTNode()
        await dht.start()
        stop = asyncio.Event()
        tasks, nodes, done = [], [], []

        async def booted(node):
            nodes.append(node)

        async def boot(**kw):
            ready = asyncio.Event()
            ncfg = NodeConfig(host="127.0.0.1", port=free_port(), api_port=free_port(),
                              bootstrap_url="")
            t0 = time.perf_counter()
            task = asyncio.create_task(run_p2p_node(
                backend="cuda", cfg=ncfg, registry_sync=False, ready_event=ready,
                shutdown_event=stop, dht=dht, publish_weights=True, post_start=booted,
                **kw))
            tasks.append(task)
            while not ready.is_set():
                if task.done():
                    task.result()  # the boot's own error
                    raise AssertionError("checkpoint[mesh]: a node stopped before ready")
                await asyncio.sleep(0.05)
            return nodes[-1], f"http://127.0.0.1:{ncfg.api_port}", time.perf_counter() - t0

        try:
            p, p_url, p_s = await boot(model="auto", checkpoint_path=str(ckpt))
            j, j_url, j_s = await boot(model=cfg, from_mesh=True)
            pe, je = (n.local_services["cuda"].engine for n in (p, j))
            diff = same_bits(pe.params, je.params)
            (_, pub_s, manifest), (_, re_s, remanifest) = published
            largest = max(x.nbytes for x in manifest.pieces)
            mb = fetched["bytes"] / 1e6
            log(f"checkpoint[mesh]: P booted from the checkpoint in {p_s:.2f} s and "
                f"published {len(manifest.pieces)} pieces ({manifest.total_bytes} B, largest "
                f"{largest} B <= {DEFAULT_PIECE_SIZE} B; "
                f"{sum(x.shard_count > 1 for x in manifest.pieces)} of them shards) in "
                f"{pub_s:.2f} s (flatten + split + sha256 + announce); J booted from the mesh "
                f"in {j_s:.2f} s: fetch {fetched['fetch_s']:.2f} s ({mb / fetched['fetch_s']:.1f} "
                f"MB/s), verify + assemble {fetched['assemble_s']:.2f} s; J republished in "
                f"{re_s:.2f} s; card {card}")
            check(largest <= DEFAULT_PIECE_SIZE, f"checkpoint[mesh]: a piece of {largest} B")
            check(not diff, f"checkpoint[mesh]: J's weights differ from P's at {diff[:5]}")
            check(remanifest.to_json() == manifest.to_json(),
                  "checkpoint[mesh]: J's republished manifest differs from P's")
            reset_counts()
            pe.forward_calls = je.forward_calls = 0
            texts = {}
            for name, url in (("P", p_url), ("J", j_url)):
                status, chat = await loop.run_in_executor(None, http_json, "POST",
                                                          url + "/chat", ask)
                check(status == 200 and chat.get("text"),
                      f"checkpoint[mesh]: {name}'s /chat answered {status} {chat}")
                texts[name] = chat["text"]
            torch.cuda.synchronize()
            counts = read_counts()
            L = cfg.n_layers
            check(counts["ragged_decode"] + counts["ragged_prefill"]
                  == L * (pe.forward_calls + je.forward_calls) and je.forward_calls > 0,
                  f"checkpoint[mesh]: launches {counts}, forwards P {pe.forward_calls} "
                  f"J {je.forward_calls}")
            status, listed = await loop.run_in_executor(None, http_json, "GET",
                                                        j_url + "/providers")
            mine = [x for x in listed["providers"] if x.get("local")
                    and CKPT_NAME in x.get("models", []) and x.get("backend") == "cuda"]
            check(status == 200 and len(mine) == 1, f"checkpoint[mesh]: J's /providers "
                  f"{listed}")
            log(f"checkpoint[mesh]: J's weights bit-equal P's; /chat text through P and J "
                f"equal: {texts['P'] == texts['J']} ({len(texts['J'])} chars); J's "
                f"/providers lists {CKPT_NAME} on backend cuda")
            check(texts["P"] == texts["J"], f"checkpoint[mesh]: texts differ: {texts}")
            out.update(counts=counts, pieces=len(manifest.pieces))
        finally:
            stop.set()
            done += await asyncio.gather(*tasks, return_exceptions=True)
            await dht.stop()
            for n in nodes:
                for svc in n.local_services.values():
                    if getattr(svc, "engine", None) is not None:
                        svc.engine.close()
        errs = [d for d in done if isinstance(d, BaseException)]
        check(not errs, f"checkpoint[mesh]: a node failed: {errs}")

    weights.publish_model_weights = timed_publish
    weights.serve_model_from_mesh = functools.partial(serve, stats=fetched)
    try:
        asyncio.run(drive())
    finally:
        weights.publish_model_weights, weights.serve_model_from_mesh = publish, serve
    return out["counts"]


def checkpoint_int8(engine, ckpt: Path, prompts, card: str) -> dict:
    """The checkpoint with quantize="int8": the device's peak during the
    load within the packed model + its largest dense tensor + 5%; its
    packed weights bit-equal to quantizing the loaded bf16 weights on the
    card (the in-memory int8 engine); equal greedy tokens; the GEMM
    launched 4 x n_layers a replayed decode step or prefill chunk of at
    most 64 tokens. Returns the launches of the int8 engine's burst."""
    cfg = engine.model_cfg
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q = checkpoint_engine("int8", checkpoint=ckpt)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    resident = storage_bytes(q.params)
    largest = max(t.numel() * t.element_size() for _, t in tree_leaves(engine.params))
    bound = INT8_LOAD_SLACK * (resident + largest)
    m = checkpoint_engine("int8", params=engine.params, cfg=cfg)
    try:
        diff = same_bits(q.params, m.params)
        log(f"checkpoint[int8]: loaded and quantized tensor by tensor in {load_s:.2f} s "
            f"({q.load_stats}); device peak during the load {peak} B against the bound "
            f"{bound:.0f} B ({INT8_LOAD_SLACK} x (packed model {resident} B + largest dense "
            f"tensor {largest} B)); packed weights bit-equal to the in-memory int8 "
            f"engine's: {not diff}; card {card}")
        check(peak <= bound, f"checkpoint[int8]: load peak {peak} B over {bound:.0f} B")
        check(not diff, f"checkpoint[int8]: packed weights differ at {diff[:5]}")
        roots_run = record_roots(q)
        reset_gemm_counts()
        got, _, counts = checkpoint_burst(q, "checkpoint[int8]", prompts)
        gemm = gemm_counts()
        check_int8_gemm_launches(q, "checkpoint[int8]", gemm, roots_run, True)
        want, _, _ = checkpoint_burst(m, "checkpoint[int8, in memory]", prompts)
        check(got == want, "checkpoint[int8]: greedy tokens differ from the in-memory "
              "int8 engine's")
        log("checkpoint[int8]: greedy tokens equal the in-memory int8 engine's, 8 x "
            f"{CKPT_NEW}")
        return {**counts, **gemm}
    finally:
        q.close()
        m.close()


# each family's tensors beyond llama's in a 2-layer checkpoint, by the end
# of their HF names: qwen2's q/k/v biases, the q/k norms of qwen3 and
# gemma-3, gemma-2/3's pre- and post-feedforward norms
# each family's tensors beyond llama's in a 2-layer checkpoint: qwen2's
# q/k/v biases, qwen3's q/k norms, gemma's extra norms; the gpt2 block's
# biases (6 a layer and ln_f's) and its position table; phi-3's fused
# qkv_proj and gate_up_proj (2 a layer)
CKPT_EXTRAS = {"qwen2-7b": 6, "qwen3-8b": 4, "gemma-2-9b": 4, "gemma-3-4b": 8,
               "gpt2": 14, "starcoder-15b": 14, "phi-3-mini": 4,
               # a router and 3 tensors an expert a layer (qwen3: + its q/k norms)
               "mixtral-8x7b": 2 * (1 + 3 * 8), "qwen3-30b-a3b": 2 * (2 + 1 + 3 * 128)}
# the families whose checkpoint launches count in rows of their own in the
# kernel table (phi-3's head_dim-96 forms; the MoE families', whose expert
# GEMM launches join its rows), not in the head_dim-128 rows
CKPT_APART = ("phi-3-mini", "mixtral-8x7b", "qwen3-30b-a3b")


def fuse_phi3(state: dict) -> dict:
    """A llama-named state in Phi-3's layout: q|k|v fused into qkv_proj and
    gate|up into gate_up_proj on the out dim (the loader's inverse)."""
    fused = {}
    for k, v in state.items():
        if ".self_attn.q_proj." in k:
            base = k.replace("q_proj", "{}")
            fused[base.format("qkv_proj")] = torch.cat(
                [state[base.format(n)] for n in ("q_proj", "k_proj", "v_proj")])
        elif ".mlp.gate_proj." in k:
            fused[k.replace("gate_proj", "gate_up_proj")] = torch.cat(
                [v, state[k.replace("gate_proj", "up_proj")]])
        elif not any(n in k for n in (".k_proj.", ".v_proj.", ".up_proj.")):
            fused[k] = v
    return fused


def checkpoint_family(card: str, which: str, workdir: Path) -> dict:
    """An HF-named checkpoint of ``which`` (a key of CKPT_EXTRAS) at full
    width and 2 layers, random bf16 from SEED with the biases and norms
    perturbed, written as one safetensors file (the converter's inverse:
    q/k/v biases, q/k norms and gemma's four block norms under their HF
    names, gemma's norms less one; gpt2's Conv1D and gpt-bigcode's
    multi-query Linear layouts) beside the published config.json cut to
    2 layers: ``InferenceEngine("auto", ...)`` loads it bit-equal to
    ``params_from_numpy``'s tree and decodes phase 6's prompts to the same
    greedy tokens and first-token logits. Returns the launch counts."""
    from bee2bee_tpu_torch.models import export
    from bee2bee_tpu_torch.models.params import params_from_numpy, params_to_numpy

    tag = f"checkpoint[{which}]"
    model_type = HF_CONFIGS[which]["model_type"]
    exporter = {"gpt2": export._export_gpt2_state,
                "gpt_bigcode": export._export_bigcode_state}.get(model_type,
                                                                 export._export_llama_state)
    cfg = family_config(which, 2)
    t0 = time.perf_counter()
    tree = params_to_numpy(family_params(cfg, torch.bfloat16, SEED + 2))
    ref_params = params_from_numpy(tree, cfg, "cuda", torch.bfloat16)
    del tree
    ckpt = workdir / which
    ckpt.mkdir()
    state = exporter(ref_params, cfg, torch.bfloat16)
    if model_type == "phi3":
        state = fuse_phi3(state)
    extra = sorted(k for k in state if k.endswith("feedforward_layernorm.weight") or (
        ".self_attn." in k and k.endswith(("_proj.bias", "_norm.weight"))) or (
        cfg.pos_embedding == "learned" and k.endswith((".bias", "wpe.weight"))) or
        k.endswith(("qkv_proj.weight", "gate_up_proj.weight")) or ".experts." in k or
        k.endswith("gate.weight"))
    export.write_safetensors(ckpt / "model.safetensors", state, metadata={"format": "pt"})
    del state
    depth = "n_layer" if "n_layer" in HF_CONFIGS[which] else "num_hidden_layers"
    (ckpt / "config.json").write_text(json.dumps(
        dict(HF_CONFIGS[which], **{depth: 2}, _name_or_path=cfg.name), indent=2))
    nbytes = (ckpt / "model.safetensors").stat().st_size
    log(f"{tag}: {cfg.name} ({model_type}) random bf16 from seed "
        f"{SEED + 2}, written in {time.perf_counter() - t0:.2f} s, {nbytes} B; its family's "
        f"tensors {extra[:4]}... ({len(extra)} tensors)")
    check(len(extra) == CKPT_EXTRAS[which], f"{tag}: the checkpoint's family tensors {extra}")
    engine = ref = None
    try:
        t0 = time.perf_counter()
        engine = checkpoint_engine(checkpoint=ckpt)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        check(engine.model_cfg == cfg, f"{tag}: the engine resolved {engine.model_cfg}")
        diff = same_bits(engine.params, ref_params)
        log(f"{tag}: InferenceEngine('auto', checkpoint_path=...) in {load_s:.2f} s; "
            f"weights bit-equal to params_from_numpy's: {not diff}; card {card}")
        check(not diff, f"{tag}: loaded weights differ at {diff[:5]}")
        ref = checkpoint_engine(params=ref_params, cfg=cfg)
        prompts = slice_prompts(GPT2_SIZES if cfg.max_seq_len <= 1024 else SLICE_SIZES)
        got, got_first, counts = checkpoint_burst(engine, tag, prompts)
        want, want_first, _ = checkpoint_burst(ref, f"{tag} params_from_numpy", prompts)
        same_first = got_first.keys() == want_first.keys() and all(
            torch.equal(bits(got_first[k]), bits(want_first[k])) for k in want_first)
        log(f"{tag}: greedy tokens equal {got == want} ({len(got)} x {CKPT_NEW}), "
            f"first-token logits bit-equal {same_first}")
        check(got == want and same_first, f"{tag}: greedy tokens or first-token logits "
              "differ from the params_from_numpy engine's")
        return counts
    finally:
        for eng in (engine, ref):
            if eng is not None:
                eng.close()
        del ref_params
        gc.collect()
        torch.cuda.empty_cache()


def phase_checkpoint(card: str) -> dict:
    """llama-3.1-8b (2 layers, published widths, random bf16 from SEED)
    written as an HF checkpoint and served from it: (a) load, (b) rope and
    f32 logits, (c) native round trip, (d) mesh publish and join, (e) int8
    from the checkpoint; then (f) HF-named qwen2-7b, qwen3-8b, gemma-2-9b,
    gemma-3-4b, gpt2 (Conv1D), starcoder-15b (gpt_bigcode, multi_query),
    phi-3-mini, mixtral-8x7b and qwen3-30b-a3b checkpoints
    (``checkpoint_family``). Returns the launch counts of the phase, summed
    (CKPT_APART's families' apart, under their names)."""
    import shutil
    import tempfile

    from bee2bee_tpu_torch.models.config import config_from_hf, get_config
    from bee2bee_tpu_torch.models.export import export_hf
    from bee2bee_tpu_torch.models.params import (
        init_params, params_from_numpy, params_to_numpy)

    t_phase = time.perf_counter()
    cfg = config_from_hf(LLAMA31_CONFIG)
    check(cfg == replace(get_config("llama-3.1-8b"), n_layers=2, name=CKPT_NAME),
          f"checkpoint: config.json parses to {cfg}")
    total: dict = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    workdir = Path(tempfile.mkdtemp(prefix="ckpt_", dir=build))
    engine = ref = None
    try:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        t0 = time.perf_counter()
        tree = params_to_numpy(init_params(cfg, gen, "cuda", torch.bfloat16))
        ref_params = params_from_numpy(tree, cfg, "cuda", torch.bfloat16)
        del tree
        ckpt = workdir / "hf"
        export_hf(ref_params, cfg, ckpt, dtype="bfloat16", max_shard_bytes=CKPT_SHARD_BYTES)
        (ckpt / "config.json").write_text(json.dumps(LLAMA31_CONFIG, indent=2))
        files = sorted(f.name for f in ckpt.iterdir())
        nbytes = sum(f.stat().st_size for f in ckpt.glob("*.safetensors"))
        log(f"checkpoint: {CKPT_NAME} random bf16 from seed {SEED}, written in "
            f"{time.perf_counter() - t0:.2f} s: {files}, {nbytes} B")
        check(len(list(ckpt.glob("*.safetensors"))) >= 2, "checkpoint: one shard only")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = checkpoint_engine(checkpoint=ckpt)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        st = engine.load_stats
        check(engine.model_cfg == cfg, f"checkpoint: the engine resolved {engine.model_cfg}")
        diff = same_bits(engine.params, ref_params)
        log(f"checkpoint[load]: InferenceEngine('auto', checkpoint_path=...) in {load_s:.2f} "
            f"s: read {st['read_s']:.2f} s, host-to-device {st['h2d_s']:.2f} s, cast + "
            f"transpose on the card {st['device_s']:.2f} s, {st['bytes']} B; device peak "
            f"{peak} B above the {base} B already held; weights bit-equal to "
            f"params_from_numpy's: {not diff}; card {card}")
        check(not diff, f"checkpoint: loaded weights differ at {diff[:5]}")
        ref = checkpoint_engine(params=ref_params, cfg=cfg)
        prompts = slice_prompts()
        got, got_first, counts = checkpoint_burst(engine, "checkpoint[load]", prompts)
        add(counts)
        want, want_first, _ = checkpoint_burst(ref, "checkpoint[params_from_numpy]", prompts)
        same_first = all(torch.equal(bits(got_first[k]), bits(want_first[k]))
                         for k in want_first) and got_first.keys() == want_first.keys()
        check(got == want and same_first, "checkpoint: greedy tokens or first-token logits "
              "differ from the params_from_numpy engine's")
        log(f"checkpoint[load]: greedy tokens equal ({len(got)} x {CKPT_NEW}) and the "
            f"{len(got_first)} first-token logits bit-equal to the params_from_numpy engine's")
        ref.close()
        ref = None
        del ref_params
        gc.collect()
        torch.cuda.empty_cache()
        rope_check(cfg, card)
        add(checkpoint_f32_logits(engine, card))
        checkpoint_native(engine, workdir, card)
        add(checkpoint_mesh(cfg, ckpt, card))
        add(checkpoint_int8(engine, ckpt, prompts, card))
        engine.close()
        engine = None
        for which in CKPT_EXTRAS:
            counts = checkpoint_family(card, which, workdir)
            if which in CKPT_APART:  # counted in its own rows of the kernel table
                total[which] = counts
            else:
                add(counts)
    finally:
        for eng in (engine, ref):
            if eng is not None:
                eng.close()
        shutil.rmtree(workdir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"checkpoint: phase wall {time.perf_counter() - t_phase:.1f} s; launches "
        f"{ {k: v for k, v in total.items() if v} }; card {card}")
    return total


def run_only(card: str, which: str) -> int:
    """``--only quant``: the int8-weight GEMM phases (bf16, the families'
    shapes, the f32 form, phi-3's shapes) and the int8-weight slices; ``--only adapters``: the adapter phase over bf16 and int8
    weights; ``--only migrate``, ``checkpoint``, ``qwen``, ``gemma`` and
    ``gpt2``: those phases (``gemma``: the G = 8 and G = 1 ragged cases and
    timings, the gemma forwards, the served gemma slices and the gemma
    checkpoints; ``gpt2``: the same for starcoder-15b's G = 48 and gpt2's
    head_dim 64, with distilgpt2, gpt2 drafted by distilgpt2 and
    starcoder-15b served); ``phi3``: phi-3-mini's head_dim-96 ragged cases,
    timings and f32 crossover, the flash phase (its head_dim-96 cases
    among them), the GEMM at phi-3's shapes, the phi-3 forwards, phi-3-mini
    served (bf16; int8 weights over an int8 pool) and its checkpoint;
    ``moe``: the expert GEMM's cases and timings at qwen3-30b-a3b's and
    mixtral-8x7b's shapes, their forwards, qwen3-30b-a3b (bf16) and
    mixtral-8x7b (int8 weights) served, a verify step, their checkpoints.
    For iterating on a slice's phases; prints no result line."""
    if which == "quant":
        flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        phase_int8_gemm(flush)
        phase_int8_gemm_families(flush)
        phase_int8_gemm_f32(flush)
        phase_phi3_gemm(flush)
        del flush
        torch.cuda.empty_cache()
        phase_int8_weights(card)
    elif which == "adapters":
        phase_adapters_both(card)
    elif which == "checkpoint":
        phase_checkpoint(card)
    elif which == "qwen":
        flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        phase_int8_gemm_f32(flush)
        del flush
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        for int8 in (False, True):
            ragged_cases_vs_plain(gen, QWEN2_RAGGED_CASES, int8)
        phase_qwen_forward()
        phase_qwen_served(card)
        phase_f32_int8_weights(card)
        workdir = Path(__file__).resolve().parent / "build" / "ckpt_qwen"
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
        workdir.mkdir(parents=True)
        try:
            for which_model in ("qwen2-7b", "qwen3-8b"):
                checkpoint_family(card, which_model, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    elif which == "gemma":
        flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        for int8 in (False, True):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(SEED + int8)
            ragged_cases_vs_plain(gen, GEMMA_G_RAGGED_CASES, int8)
            time_ragged_shapes(gen, flush, int8, GEMMA_G_TIMED)
        del flush
        torch.cuda.empty_cache()
        phase_gemma_forward()
        phase_gemma_served(card)
        workdir = Path(__file__).resolve().parent / "build" / "ckpt_gemma"
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
        workdir.mkdir(parents=True)
        try:
            for which_model in ("gemma-2-9b", "gemma-3-4b"):
                checkpoint_family(card, which_model, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    elif which == "gpt2":
        flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        for int8 in (False, True):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(SEED + int8)
            ragged_cases_vs_plain(gen, GPT2_RAGGED_CASES, int8)
            time_ragged_shapes(gen, flush, int8, GPT2_TIMED)
        del flush
        torch.cuda.empty_cache()
        stage("gpt2 forward parity")
        phase_gpt2_forward()
        stage("gpt2 served")
        phase_gpt2_served(card)
        stage("gpt2 checkpoints")
        workdir = Path(__file__).resolve().parent / "build" / "ckpt_gpt2"
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
        workdir.mkdir(parents=True)
        try:
            for which_model in ("gpt2", "starcoder-15b"):
                checkpoint_family(card, which_model, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    elif which == "phi3":
        flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        stage("phi3 ragged vs plain")
        for int8 in (False, True):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(SEED + int8)
            ragged_cases_vs_plain(gen, PHI3_RAGGED_CASES, int8)
            time_ragged_shapes(gen, flush, int8, PHI3_TIMED)
            time_crossover("int8 pool" if int8 else "pool", gen, flush, int8,
                           dtype=torch.float32, heads=PHI3)
        stage("flash vs plain")
        phase_flash_vs_plain(flush)
        stage("int8-weight GEMM at phi-3's shapes")
        phase_phi3_gemm(flush)
        del flush
        torch.cuda.empty_cache()
        stage("phi3 forward parity")
        phase_phi3_forward()
        stage("phi3 served")
        phase_phi3_served(card)
        stage("phi3 checkpoint")
        phase_phi3_checkpoint(card)
    elif which == "moe":
        flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        phase_moe(card, flush)
    elif which == "migrate":
        # phase 6's random bf16 init from the seed, cast to f32 as phase 8 does
        engine = migrate_engine(None, "bfloat16", "bfloat16")
        params = cast_tree(engine.params, torch.float32)
        engine.close()
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        phase_migrate(card, params)
    else:
        raise SystemExit(f"--only: quant, adapters, migrate, checkpoint, qwen, gemma, gpt2, "
                         f"phi3 or moe, not {which!r}")
    log(stage_seconds())
    log(f"card: {card}")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    if not (here / "bee2bee_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: bee2bee_tpu_torch/ not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(here))
    # the nodes' state (identity, incidents, profiles) stays in the checkout
    os.environ.setdefault("BEE2BEE_TPU_HOME", str(here / "build" / "bee2bee_home"))
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    stage("device and build")
    card, _ = phase_device_and_build()
    if len(sys.argv) == 3 and sys.argv[1] == "--ring-repro":
        ring_repro(card, int(sys.argv[2]))
        log(f"card: {card}")
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--node-profile":
        return node_profile_rounds(card, int(sys.argv[2]))
    only = sys.argv[2] if len(sys.argv) == 3 and sys.argv[1] == "--only" else None
    if only is not None:
        return run_only(card, only)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    stage("ragged vs plain")
    errs, timings = phase_ragged_vs_plain(flush)
    int8_errs, int8_timings = phase_ragged_vs_plain(flush, int8=True)
    stage("flash vs plain")
    flash_errs, flash_timings = phase_flash_vs_plain(flush)
    stage("int8-weight GEMM")
    gemm = phase_int8_gemm(flush)
    stage("int8-weight GEMM, prefill kernel and the families' shapes")
    gemm_prefill = phase_int8_gemm_families(flush)
    stage("int8-weight GEMM, f32 form")
    gemm_f32 = phase_int8_gemm_f32(flush)
    stage("int8-weight GEMM at phi-3's shapes")
    phase_phi3_gemm(flush)
    stage("moe kernel")
    moe_kernel = phase_moe_kernel(flush)
    del flush
    stage("forward parity")
    fwd_counts = phase_forward_parity()
    geometry_counts = phase_gemma_geometry_forward()
    stage("qwen forward parity")
    qwen_fwd = phase_qwen_forward()
    stage("gemma forward parity")
    gemma_fwd = phase_gemma_forward()
    stage("gpt2 forward parity")
    gpt2_fwd = phase_gpt2_forward()
    stage("phi3 forward parity")
    phi3_fwd = phase_phi3_forward()
    stage("moe forward parity")
    moe_fwd = phase_moe_forward()
    stage("slice")
    counts, bf16_pool, params = phase_slice(card)
    int8_counts, int8_pool = phase_slice(card, "int8", params=params)[:2]
    ratio = int8_pool / bf16_pool
    log(f"pool bytes: int8 {int8_pool} B vs bf16 {bf16_pool} B -> {ratio:.4f}x "
        f"(scales included)")
    check(ratio <= 0.502, f"int8 pool is {ratio:.4f}x the bf16 pool's bytes")
    # multi-LoRA serving over the same bf16 weights
    stage("adapters, bf16 weights")
    adapter_counts = phase_adapters(card, params, quantized=False)
    # the prefix cache over the same bf16 weights, bf16 and int8 pools
    stage("prefix")
    prefix = {pool: phase_prefix(card, params, pool) for pool in ("bfloat16", "int8")}
    for pool in ("bfloat16", "int8"):
        phase_prefix_pressure(card, params, pool)
    stage("spec, model tier")
    spec_model = phase_spec_model(card, params)
    # phase 8: the same weights cast to f32 (the bf16 copy freed first: the
    # node phase loads its own), over an int8 pool and then an f32 pool
    gc.collect()
    params = cast_tree(params, torch.float32)
    gc.collect()
    torch.cuda.empty_cache()
    stage("f32 slice")
    f32_counts = {pool: phase_slice(card, pool, params=params, dtype="float32")[0]
                  for pool in ("int8", "float32")}
    # the prefix cache in f32 (f32 pool) on the bf16 run's turn-2 prompts:
    # a hit's greedy tokens equal the cache-off engine's, and the cache-off
    # first-token logits are the f32 side of the bf16 logits rule
    stage("f32 prefix")
    prefix_f32 = phase_prefix(card, params, "float32", dtype="float32",
                              prompts2=prefix["bfloat16"]["prompts2"])
    diverged = {n: (toks, prefix_f32["off_tokens"][n])
                for n, toks in prefix_f32["tokens"].items()
                if toks != prefix_f32["off_tokens"][n]}
    check(not diverged, f"prefix[float32]: turn-2 hits' greedy tokens differ from the "
          f"cache-off engine's: {diverged}")
    log(f"prefix[float32]: the 8 hits' greedy tokens ({PREFIX_REPLY} each) equal the "
        f"cache-off engine's, token for token")
    for pool in ("bfloat16", "int8"):
        check_prefix_logits(f"prefix[{pool} pool]", prefix[pool], prefix_f32["off_logits"])
    stage("spec, n-gram tier")
    spec_ngram = phase_spec_ngram(card, params)
    # live migration between two nodes on the card: the f32 weights, then
    # the same cast back to bf16
    stage("migration")
    migrated = phase_migrate(card, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # int8 weights: a fresh random init quantized as it loads, served over a
    # bf16 and an int8 pool, then multi-LoRA serving over them
    stage("int8-weight slice")
    int8w = phase_int8_weights(card)
    stage("adapters, int8 weights")
    adapter_counts_int8 = phase_adapters(card, int8w.pop("params"), quantized=True)
    gc.collect()
    torch.cuda.empty_cache()
    # qwen3-8b (bf16, full depth) and qwen2-7b (int8 weights and pool, G = 7)
    # served; then int8 weights beside f32 activations
    stage("qwen served")
    qwen = phase_qwen_served(card)
    # gemma-2-9b (bf16, full depth) and gemma-3-4b (int8 weights and pool)
    # served: the head_dim-256 forms on a served path
    stage("gemma served")
    gemma = phase_gemma_served(card)
    # distilgpt2 (bf16; int8 weights over an int8 pool), gpt2 in f32 drafted
    # by distilgpt2, starcoder-15b (bf16, 40 layers, G = 48)
    stage("gpt2 served")
    gpt2 = phase_gpt2_served(card)
    # phi-3-mini (32 layers, hd 96, G = 1) at its 4,096 positions: bf16, then
    # int8 weights over an int8 pool
    stage("phi3 served")
    phi3 = phase_phi3_served(card)
    # qwen3-30b-a3b (bf16, 48 layers, 128 experts) and mixtral-8x7b (int8
    # weights from the quantize-as-drawn init) served, then their checkpoints
    stage("moe served")
    moe_served = phase_moe_served(card)
    stage("f32 int8 weights")
    f32w = phase_f32_int8_weights(card)
    stage("node")
    node_counts = phase_node(card)
    stage("node with the prefix cache")
    phase_node_prefix(card)
    # llama-3.1 from an HF checkpoint: load, rope, native pieces, the mesh
    # join and int8 from the checkpoint
    stage("checkpoint")
    ckpt_counts = phase_checkpoint(card)
    stage("kernel table")

    # the prefix phases' launches join the main path's
    for name, n in prefix["bfloat16"]["counts"].items():
        counts[name] += n
    for name, n in prefix["int8"]["counts"].items():
        int8_counts[name] += n
    for name, n in prefix_f32["counts"].items():
        f32_counts["float32"][name] += n
    # and the speculative phases' (bf16 model tier, f32 n-gram tier)
    for name, n in spec_model.items():
        counts[name] += n
    for name, n in spec_ngram.items():
        f32_counts["float32"][name] += n
    # and the migration phase's, each where its kernel's row reads it
    for name, n in migrated.items():
        dest = (f32_counts["float32"] if "_f32" in name
                else int8_counts if name.endswith("_int8") else counts)
        dest[name] += n
    # the qwen phases', the f32 int8-weight phase's, the gemma slices' and the
    # gemma-geometry forward's launches, added to the row of each kernel form
    # they counted
    more: dict = {}
    # the MoE forwards', slices', verify step's and checkpoints' launches
    moe_runs = (*moe_fwd.values(), *moe_served.values(),
                *(ckpt_counts.get(m, {}) for m in ("mixtral-8x7b", "qwen3-30b-a3b")))
    for c in (qwen_fwd, *qwen.values(), f32w, *gemma.values(), *geometry_counts.values(),
              *moe_runs):
        for name, n in c.items():
            more[name] = more.get(name, 0) + n
    # the gemma forwards' launches: the bf16 head_dim-256 forms join the main
    # path's, the f32 ones (head_dim 256, counted with the head_dim-128
    # forms' counters) go to the head_dim-256 f32 rows
    gemma_f32: dict = {}
    for c in gemma_fwd.values():
        for name, n in c.items():
            dest = gemma_f32 if "_f32" in name else more
            dest[name] = dest.get(name, 0) + n

    def hd256(name):  # a head_dim-256 form's launches on the main path
        return more.get(name, 0) + ckpt_counts.get(name, 0)

    def g48(name):  # starcoder-15b's forwards and served slice
        return gpt2_fwd["starcoder-15b"].get(name, 0) + gpt2["starcoder-15b"].get(name, 0)

    def hd64(name):  # gpt2's forwards, distilgpt2's slices, gpt2's spec run
        return gpt2_fwd["gpt2"].get(name, 0) + sum(
            c.get(name, 0) for m, c in gpt2.items() if m != "starcoder-15b")

    def hd96(name):  # phi-3-mini's forwards, served slices and checkpoint
        return (phi3_fwd.get(name, 0) + sum(c.get(name, 0) for c in phi3.values())
                + ckpt_counts.get("phi-3-mini", {}).get(name, 0))

    def row(name, source, replaces, n, err, t):
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": n,
            "max_abs_err": err,
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        }

    def forced_row(t):  # a timing with the row kernel's forced time as ms
        return dict(t, ms=t["forced"]["row"])

    ragged_src = "bee2bee_tpu_torch/csrc/ragged_attention.cu"
    prefill_src = "bee2bee_tpu_torch/csrc/ragged_prefill_attention.cu"
    decode_src = "bee2bee_tpu_torch/csrc/ragged_decode_attention.cu"
    decode_f32_src = "bee2bee_tpu_torch/csrc/ragged_decode_attention_f32.cu"
    f32_int8, f32_f32 = f32_counts["int8"], f32_counts["float32"]
    flash_src = "bee2bee_tpu_torch/csrc/flash_attention.cu"
    kernels = [
        row("ragged_decode_attention", decode_src, "bee2bee_tpu/ops/ragged.py:84",
            counts["ragged_decode"] + node_counts["ragged_decode"]
            + ckpt_counts.get("ragged_decode", 0) + more.get("ragged_decode", 0),
            errs["decode"],
            timings["decode"]),
        row("ragged_decode_attention_int8", decode_src,
            "bee2bee_tpu/ops/ragged.py:107",
            int8_counts["ragged_decode_int8"] + more.get("ragged_decode_int8", 0),
            int8_errs["decode"], int8_timings["decode"]),
        # the row kernel, forced in bf16 at gemma-2-9b's heads at the decode
        # shape (beside the same inputs' plain, SDPA and bound), and flash's
        # forced at causal T=S=2048 there
        row("ragged_paged_attention", ragged_src, "bee2bee_tpu/ops/ragged.py:84",
            counts["ragged"], errs["row"], forced_row(timings["decode_hd256"])),
        row("ragged_paged_attention_int8", ragged_src,
            "bee2bee_tpu/ops/ragged.py:107", int8_counts["ragged_int8"],
            int8_errs["row"], forced_row(int8_timings["decode_hd256"])),
        row("flash_attention", flash_src, "bee2bee_tpu/ops/flash.py:46",
            counts["flash"] + int8_counts["flash"], flash_errs["row"],
            flash_timings["row_hd256"]),
        # the head_dim-256 forms: launches from the gemma forwards, the
        # served gemma slices (gemma-2-9b over a bf16 pool, gemma-3-4b over
        # an int8 pool) and the gemma checkpoints; times at gemma-2-9b's
        # heads, decode B=8 ctx 1024, prefill T=512 @1000 and flash causal
        # T=S=2048
        row("ragged_prefill_attention_hd256", prefill_src,
            "bee2bee_tpu/ops/ragged.py:84", hd256("ragged_prefill_hd256"),
            errs["tile_hd256"], timings["prefill_hd256"]),
        row("ragged_prefill_attention_hd256_int8", prefill_src,
            "bee2bee_tpu/ops/ragged.py:107", hd256("ragged_prefill_hd256_int8"),
            int8_errs["tile_hd256"], int8_timings["prefill_hd256"]),
        row("ragged_decode_attention_hd256", decode_src, "bee2bee_tpu/ops/ragged.py:84",
            hd256("ragged_decode_hd256"), errs["decode_hd256"],
            timings["decode_hd256"]),
        row("ragged_decode_attention_hd256_int8", decode_src,
            "bee2bee_tpu/ops/ragged.py:107", hd256("ragged_decode_hd256_int8"),
            int8_errs["decode_hd256"], int8_timings["decode_hd256"]),
        # the same forms at gemma-2b's G = 8 (the verify shape, B=8 T=5 ctx
        # 1028) and gemma-7b's G = 1 (decode B=8 ctx 1024): launches those
        # of that preset's forward (phase 5)
        row("ragged_prefill_attention_hd256_g8", prefill_src,
            "bee2bee_tpu/ops/ragged.py:84",
            gemma_fwd["gemma-2b"].get("ragged_prefill_hd256", 0), errs["tile_hd256"],
            timings["verify_g8"]),
        row("ragged_prefill_attention_hd256_g8_int8", prefill_src,
            "bee2bee_tpu/ops/ragged.py:107",
            gemma_fwd["gemma-2b"].get("ragged_prefill_hd256_int8", 0),
            int8_errs["tile_hd256"], int8_timings["verify_g8"]),
        row("ragged_decode_attention_hd256_g1", decode_src, "bee2bee_tpu/ops/ragged.py:84",
            gemma_fwd["gemma-7b"].get("ragged_decode_hd256", 0), errs["decode_hd256"],
            timings["decode_g1"]),
        row("ragged_decode_attention_hd256_g1_int8", decode_src,
            "bee2bee_tpu/ops/ragged.py:107",
            gemma_fwd["gemma-7b"].get("ragged_decode_hd256_int8", 0),
            int8_errs["decode_hd256"], int8_timings["decode_g1"]),
        row("flash_attention_tile_hd256", flash_src, "bee2bee_tpu/ops/flash.py:46",
            counts["flash_tile_hd256"] + int8_counts["flash_tile_hd256"],
            flash_errs["tile_hd256"], flash_timings["tile_hd256"]),
        row("ragged_prefill_attention", prefill_src, "bee2bee_tpu/ops/ragged.py:84",
            counts["ragged_prefill"] + node_counts["ragged_prefill"]
            + ckpt_counts.get("ragged_prefill", 0) + more.get("ragged_prefill", 0),
            errs["tile"],
            timings["prefill"]),
        row("ragged_prefill_attention_int8", prefill_src,
            "bee2bee_tpu/ops/ragged.py:107",
            int8_counts["ragged_prefill_int8"] + more.get("ragged_prefill_int8", 0),
            int8_errs["tile"], int8_timings["prefill"]),
        row("flash_attention_tile", flash_src, "bee2bee_tpu/ops/flash.py:46",
            counts["flash_tile"] + int8_counts["flash_tile"], flash_errs["tile"],
            flash_timings["tile"]),
        # the f32 tile forms (3xTF32), timed at the prefill chunk and causal
        # T=S=2048; bound: three TF32 products at the TF32 peak; the ragged
        # forms' launches from the f32 slice's prefill chunks (phase 8)
        row("ragged_prefill_attention_f32", prefill_src, "bee2bee_tpu/ops/ragged.py:84",
            f32_f32["ragged_prefill_f32"] + ckpt_counts.get("ragged_prefill_f32", 0)
            + more.get("ragged_prefill_f32", 0), errs["tile_f32"], timings["prefill_f32"]),
        row("ragged_prefill_attention_f32_int8", prefill_src,
            "bee2bee_tpu/ops/ragged.py:107",
            f32_int8["ragged_prefill_f32_int8"] + more.get("ragged_prefill_f32_int8", 0),
            int8_errs["tile_f32"], int8_timings["prefill_f32"]),
        row("flash_attention_tile_f32", flash_src, "bee2bee_tpu/ops/flash.py:46",
            counts["flash_tile_f32"] + int8_counts["flash_tile_f32"],
            flash_errs["tile_f32"], flash_timings["tile_f32"]),
        # the f32 decode kernel: launches from the f32 slice (phase 8) and
        # phase 5's f32 forwards at llama-3-8b's heads, times at decode B=8
        # ctx 1024 (llama-3-8b's and gemma-2-9b's heads); bound: the bytes
        # or the FFMA products at the f32 CUDA-core peak
        row("ragged_decode_attention_f32", decode_f32_src, "bee2bee_tpu/ops/ragged.py:84",
            f32_f32["ragged_decode_f32"] + fwd_counts.get("ragged_decode_f32", 0)
            + ckpt_counts.get("ragged_decode_f32", 0) + more.get("ragged_decode_f32", 0),
            errs["decode_f32"], timings["decode_f32"]),
        row("ragged_decode_attention_f32_int8", decode_f32_src,
            "bee2bee_tpu/ops/ragged.py:107",
            f32_int8["ragged_decode_f32_int8"] + fwd_counts.get("ragged_decode_f32_int8", 0)
            + more.get("ragged_decode_f32_int8", 0),
            int8_errs["decode_f32"], int8_timings["decode_f32"]),
        # the f32 forms at head_dim 256: launches from the gemma forwards'
        # f32 runs (phase 5); times at gemma-2-9b's heads (decode B=8 ctx
        # 1024, prefill T=512 @1000), at gemma-2b's G = 8 the verify shape
        # through the f32 tile form (40 rows) and at gemma-7b's G = 1 the
        # verify shape through decode_f32
        row("ragged_decode_attention_f32_hd256", decode_f32_src,
            "bee2bee_tpu/ops/ragged.py:84", gemma_f32.get("ragged_decode_f32", 0),
            errs["decode_f32"], timings["decode_hd256_f32"]),
        row("ragged_decode_attention_f32_hd256_int8", decode_f32_src,
            "bee2bee_tpu/ops/ragged.py:107", gemma_f32.get("ragged_decode_f32_int8", 0),
            int8_errs["decode_f32"], int8_timings["decode_hd256_f32"]),
        row("ragged_prefill_attention_f32_hd256", prefill_src,
            "bee2bee_tpu/ops/ragged.py:84", gemma_f32.get("ragged_prefill_f32", 0),
            errs["tile_f32"], timings["prefill_hd256_f32"]),
        row("ragged_prefill_attention_f32_hd256_int8", prefill_src,
            "bee2bee_tpu/ops/ragged.py:107", gemma_f32.get("ragged_prefill_f32_int8", 0),
            int8_errs["tile_f32"], int8_timings["prefill_hd256_f32"]),
        row("ragged_prefill_attention_f32_hd256_g8", prefill_src,
            "bee2bee_tpu/ops/ragged.py:84",
            gemma_fwd["gemma-2b"].get("ragged_prefill_f32", 0), errs["tile_f32"],
            timings["verify_g8_f32"]),
        row("ragged_prefill_attention_f32_hd256_g8_int8", prefill_src,
            "bee2bee_tpu/ops/ragged.py:107",
            gemma_fwd["gemma-2b"].get("ragged_prefill_f32_int8", 0), int8_errs["tile_f32"],
            int8_timings["verify_g8_f32"]),
        row("ragged_decode_attention_f32_hd256_g1", decode_f32_src,
            "bee2bee_tpu/ops/ragged.py:84",
            gemma_fwd["gemma-7b"].get("ragged_decode_f32", 0), errs["decode_f32"],
            timings["verify_g1_f32"]),
        row("ragged_decode_attention_f32_hd256_g1_int8", decode_f32_src,
            "bee2bee_tpu/ops/ragged.py:107",
            gemma_fwd["gemma-7b"].get("ragged_decode_f32_int8", 0), int8_errs["decode_f32"],
            int8_timings["verify_g1_f32"]),
        # starcoder-15b's G = 48 (48 query heads over one kv head, hd 128):
        # launches from its forwards (phase 5) and its served slice; times
        # at decode B=8 ctx 1024, the verify shape and (f32: 48 rows, the
        # f32 tile form) the f32 decode step
        row("ragged_decode_attention_g48", decode_src, "bee2bee_tpu/ops/ragged.py:84",
            g48("ragged_decode"), errs["decode"], timings["decode_g48"]),
        row("ragged_decode_attention_g48_int8", decode_src, "bee2bee_tpu/ops/ragged.py:107",
            g48("ragged_decode_int8"), int8_errs["decode"], int8_timings["decode_g48"]),
        row("ragged_prefill_attention_g48", prefill_src, "bee2bee_tpu/ops/ragged.py:84",
            g48("ragged_prefill"), errs["tile"], timings["verify_g48"]),
        row("ragged_prefill_attention_g48_int8", prefill_src,
            "bee2bee_tpu/ops/ragged.py:107", g48("ragged_prefill_int8"), int8_errs["tile"],
            int8_timings["verify_g48"]),
        row("ragged_prefill_attention_f32_g48", prefill_src, "bee2bee_tpu/ops/ragged.py:84",
            g48("ragged_prefill_f32"), errs["tile_f32"], timings["decode_g48_f32"]),
        row("ragged_prefill_attention_f32_g48_int8", prefill_src,
            "bee2bee_tpu/ops/ragged.py:107", g48("ragged_prefill_f32_int8"),
            int8_errs["tile_f32"], int8_timings["decode_g48_f32"]),
        # gpt2's head_dim 64 (G = 1): launches from gpt2's forwards (phase
        # 5), distilgpt2's served slices (bf16; int8 weights over an int8
        # pool) and gpt2's f32 spec run; times at decode B=8 ctx 1024, a
        # 512-token prefill chunk at 500, the f32 verify shape (decode_f32)
        # and the f32 prefill chunk
        row("ragged_decode_attention_hd64", decode_src, "bee2bee_tpu/ops/ragged.py:84",
            hd64("ragged_decode"), errs["decode"], timings["decode_hd64"]),
        row("ragged_decode_attention_hd64_int8", decode_src, "bee2bee_tpu/ops/ragged.py:107",
            hd64("ragged_decode_int8"), int8_errs["decode"], int8_timings["decode_hd64"]),
        row("ragged_prefill_attention_hd64", prefill_src, "bee2bee_tpu/ops/ragged.py:84",
            hd64("ragged_prefill"), errs["tile"], timings["prefill_hd64"]),
        row("ragged_prefill_attention_hd64_int8", prefill_src,
            "bee2bee_tpu/ops/ragged.py:107", hd64("ragged_prefill_int8"), int8_errs["tile"],
            int8_timings["prefill_hd64"]),
        row("ragged_decode_attention_f32_hd64", decode_f32_src,
            "bee2bee_tpu/ops/ragged.py:84", hd64("ragged_decode_f32"), errs["decode_f32"],
            timings["verify_hd64_f32"]),
        row("ragged_decode_attention_f32_hd64_int8", decode_f32_src,
            "bee2bee_tpu/ops/ragged.py:107", hd64("ragged_decode_f32_int8"),
            int8_errs["decode_f32"], int8_timings["verify_hd64_f32"]),
        row("ragged_prefill_attention_f32_hd64", prefill_src, "bee2bee_tpu/ops/ragged.py:84",
            hd64("ragged_prefill_f32"), errs["tile_f32"], timings["prefill_hd64_f32"]),
        row("ragged_prefill_attention_f32_hd64_int8", prefill_src,
            "bee2bee_tpu/ops/ragged.py:107", hd64("ragged_prefill_f32_int8"),
            int8_errs["tile_f32"], int8_timings["prefill_hd64_f32"]),
        # phi-3-mini's head_dim 96 (G = 1, window 2,047): launches from its
        # forwards (phase 5), its served slices (bf16; int8 weights over an
        # int8 pool) and its checkpoint; errors over the head_dim-96 cases;
        # times at decode B=8 ctx 1024, a 512-token chunk at 1000, the f32
        # decode step (decode_f32) and the f32 chunk; flash at causal T=S=2048
        row("ragged_decode_attention_hd96", decode_src, "bee2bee_tpu/ops/ragged.py:84",
            hd96("ragged_decode"), errs["decode_hd96"], timings["decode_hd96"]),
        row("ragged_decode_attention_hd96_int8", decode_src, "bee2bee_tpu/ops/ragged.py:107",
            hd96("ragged_decode_int8"), int8_errs["decode_hd96"],
            int8_timings["decode_hd96"]),
        row("ragged_prefill_attention_hd96", prefill_src, "bee2bee_tpu/ops/ragged.py:84",
            hd96("ragged_prefill"), errs["tile_hd96"], timings["prefill_hd96"]),
        row("ragged_prefill_attention_hd96_int8", prefill_src,
            "bee2bee_tpu/ops/ragged.py:107", hd96("ragged_prefill_int8"),
            int8_errs["tile_hd96"], int8_timings["prefill_hd96"]),
        row("ragged_decode_attention_f32_hd96", decode_f32_src,
            "bee2bee_tpu/ops/ragged.py:84", hd96("ragged_decode_f32"),
            errs["decode_f32_hd96"], timings["decode_hd96_f32"]),
        row("ragged_decode_attention_f32_hd96_int8", decode_f32_src,
            "bee2bee_tpu/ops/ragged.py:107", hd96("ragged_decode_f32_int8"),
            int8_errs["decode_f32_hd96"], int8_timings["decode_hd96_f32"]),
        row("ragged_prefill_attention_f32_hd96", prefill_src, "bee2bee_tpu/ops/ragged.py:84",
            hd96("ragged_prefill_f32"), errs["tile_f32_hd96"], timings["prefill_hd96_f32"]),
        row("ragged_prefill_attention_f32_hd96_int8", prefill_src,
            "bee2bee_tpu/ops/ragged.py:107", hd96("ragged_prefill_f32_int8"),
            int8_errs["tile_f32_hd96"], int8_timings["prefill_hd96_f32"]),
        row("flash_attention_tile_hd96", flash_src, "bee2bee_tpu/ops/flash.py:46",
            counts["flash_tile"] + int8_counts["flash_tile"], flash_errs["tile_hd96"],
            flash_timings["tile_hd96"]),
        row("flash_attention_tile_f32_hd96", flash_src, "bee2bee_tpu/ops/flash.py:46",
            counts["flash_tile_f32"] + int8_counts["flash_tile_f32"],
            flash_errs["tile_f32_hd96"], flash_timings["tile_f32_hd96"]),
    ]
    # the int8-weight GEMM: launches from the int8-weight slices (both
    # pools) and the int8-weight adapter phase's mixed burst; times at w_up
    # (4096 x 14336), M = 8 (the decode kernel) and w_up|w_gate, M = 2,048
    # (the prefill kernel)
    gemm_src = "bee2bee_tpu_torch/csrc/int8_weight_gemm.cu"

    def gemm_launches(name):
        return (int8w["counts"][name] + adapter_counts_int8[name] + ckpt_counts.get(name, 0)
                + more.get(name, 0) + gpt2["distilgpt2 int8"][name])

    kernels.append(row(
        "int8_weight_gemm", gemm_src, "bee2bee_tpu/models/core.py:408",
        gemm_launches("int8_gemm"), gemm["err"], gemm["timing"]))
    kernels.append(row(
        "int8_weight_gemm_prefill", gemm_src, "bee2bee_tpu/models/core.py:408",
        gemm_launches("int8_gemm_prefill"), gemm_prefill["err"], gemm_prefill["timing"]))
    # its f32 form (2xTF32): launches from the f32 int8-weight phase (serving
    # and spec); times at llama-3-8b's w_up, M = 8, f32 activations
    kernels.append(row(
        "int8_weight_gemm_f32", gemm_src, "bee2bee_tpu/models/core.py:408",
        more.get("int8_gemm_f32", 0), gemm_f32["err"], gemm_f32["timing"]))
    # the grouped expert GEMM, each form: launches from the MoE forwards,
    # served slices, verify step and checkpoints; times at a B = 8 decode
    # step's 8 tokens (bf16 forms and f32 at qwen3-30b-a3b's experts, the int8
    # forms at mixtral-8x7b's, as each is served)
    moe_src = "bee2bee_tpu_torch/csrc/moe_expert_gemm.cu"
    for form, model in (("moe", "qwen3-30b-a3b"), ("moe_int8", "mixtral-8x7b"),
                        ("moe_f32", "qwen3-30b-a3b"), ("moe_f32_int8", "mixtral-8x7b")):
        kernels.append(row(
            form.replace("moe", "moe_expert_gemm"), moe_src, "bee2bee_tpu/models/core.py:543",
            sum(c.get(form, 0) for c in moe_runs), moe_kernel["err"][form],
            moe_kernel["timing"][(form, model, 8)]))
    log("kernels: moe_expert_gemm and its forms replace no Pallas kernel: the XLA einsums "
        "of the JAX _moe (bee2bee_tpu/models/core.py:543); bf16 x runs the warp-specialised "
        "wgmma kernel (TMA-fed weight ring, x rows gathered in sorted order first, K split "
        "and reduced for mixtral's w_down at decode), f32 x the FFMA kernel, each call one "
        "counted launch whatever CUDA kernels it issues; the bf16 form's library_ms is "
        "torch._grouped_mm over the same sorted rows; launches by run "
        f"{ {i: {k: v for k, v in c.items() if k.startswith('moe') and v} for i, c in enumerate(moe_runs)} }")
    log("kernels: int8_weight_gemm (decode kernel, bf16), its f32 form and "
        "int8_weight_gemm_prefill (prefill kernel, bf16 chunks over 64 tokens) replace no "
        "Pallas kernel: the XLA-fused int8 product of the JAX core.matmul "
        "(bee2bee_tpu/models/core.py:408); their library_ms is torch._weight_int8pack_mm "
        "at the same inputs (null where the card's torch has no CUDA kernel for it)")
    log(f"kernels: gemma launches: forward parity "
        f"{ {m: {k: v for k, v in c.items() if v} for m, c in gemma_fwd.items()} } (bf16 "
        f"forms added to the head_dim-256 rows, f32 ones to the f32 head_dim-256 rows, each "
        f"G row its preset's), served "
        f"{ {m: {k: v for k, v in c.items() if v} for m, c in gemma.items()} }")
    log(f"kernels: qwen launches (added to the rows above): forward parity "
        f"{ {k: v for k, v in qwen_fwd.items() if v} }, served "
        f"{ {m: {k: v for k, v in c.items() if v} for m, c in qwen.items()} }; f32 int8 "
        f"weights { {k: v for k, v in f32w.items() if v} }")
    log(f"kernels: gpt2 launches (the G = 48 and head_dim-64 rows): forward parity "
        f"{ {m: {k: v for k, v in c.items() if v} for m, c in gpt2_fwd.items()} }, served "
        f"{ {m: {k: v for k, v in c.items() if v} for m, c in gpt2.items()} }; their "
        f"checkpoints' launches are in the checkpoint phase's (the rows above)")
    log(f"kernels: phi-3 launches (the head_dim-96 rows): forward parity "
        f"{ {k: v for k, v in phi3_fwd.items() if v} }, served "
        f"{ {m: {k: v for k, v in c.items() if v} for m, c in phi3.items()} }, checkpoint "
        f"{ {k: v for k, v in ckpt_counts.get('phi-3-mini', {}).items() if v} }")
    log(f"kernels: adapter phase launches (mixed bursts): bf16 weights "
        f"{ {k: v for k, v in adapter_counts.items() if v} }, int8 weights "
        f"{ {k: v for k, v in adapter_counts_int8.items() if v} }")
    log("kernels: the flash kernels have 0 launches on the main path: no "
        "serving path calls flash_attention (the engines attend through the "
        "ragged op); the ragged row kernel has 0 there too: the rule names it "
        "for no query type the kernels take (it is forced, and timed, at "
        "gemma-2-9b's heads). The f32 decode kernel and the f32 tile forms "
        "serve the f32 slice (phase 8: decode and prefill at head_dim 128, over "
        "an int8 and an f32 pool) and phase 5's f32 forwards; the head_dim-256 "
        "forms serve gemma-2-9b (bf16 pool) and gemma-3-4b (int8 pool), and "
        "their f32 forms run in the gemma forwards (phase 5), on no served "
        "path. All are held against the plain version and timed above")
    log(stage_seconds())
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
