"""Drive repro_torch's GRLE decision and training paths, the paper's
baselines (DROO, DROOE) and dynamic fleets, its LM serving paths (dense
GQA, RWKV-6, and the rest of the model zoo: Zamba2, DeepSeek-MoE,
DeepSeek-V2, Whisper; StableLM-3B, InternLM2-20B and Chameleon-34B at
full width), its serving engines and their throughput benchmark
(serve-bench), its experiment sweep, its population training, its
profiler and cost hooks, LM training, the paper's multi-exit VGG-16
pipeline, the long-context window decode, the one-card dry run, the
examples and the fleet, member and cell axes over the cards (one rank a
card) on the NVIDIA GPUs of one machine and check them.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU, nvcc and
PyTorch built for CUDA; it needs no JAX and no network. Phases, in
order, each fatal on failure:

1. the card's name and power limit (nvidia-smi); TF32 off for matmuls
   and convolutions, so the plain versions run in full float32;
2. build every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc per
   source, all started together) and print the build time and each
   kernel instance's registers, spills and static shared memory; fail if
   ptxas warns that it serialized a kernel's wgmma (C7514, C7518), which
   costs speed and no correctness;
3. hold each actor kernel against its plain PyTorch version on the card,
   at the main path's shapes and inputs for B in {1, 64, 1024} fleets: max
   abs error <= 1e-5; per launch (layer and side) print the tile from
   kernels/gcn_agg.py::plan (G graphs and C columns a block, K split,
   weight stages), blocks per SM and shared memory from the kernel's own
   layout, kernel time (CUDA-graph replay, so host launch overhead is
   excluded) beside the first design's (FIRST_DESIGN_US), plain time and
   the bound; per slot the sums; first the launch floor, the graph-replay
   time of a one-element in-place add;
4. golden replay: ``tests/data/torch_port_golden.npz`` (a JAX run with
   its draws) through the port's driver on the card — every decision
   matches, or differs only at a recorded near-tie (margin <= 1e-5);
5. the decision path: GRLE on fig5_baseline at full width (M=14, N=2,
   L=5, hidden (128, 64), edge 64, 143 candidates), 64 fleets, 200 slots
   on the port's own generator, random weights from seed 0; the launch
   counts must read exactly 4 per slot for gcn_agg and 1 for edge_score;
6. the attention kernels against their plain versions: flash_attention at
   Llama-3.2-1B's prefill shape [4, 2048, 32 heads, 8 kv heads, 64] and
   on tests/test_kernels.py's grid (window 64 included); decode_attention
   at [B in {1, 64}, 32, 8, 64, S=4096] with lengths from numpy seed 0 in
   [1, S] and all equal to S, at the serve shape [8, 32, 8, 64, 256], and
   on tests/test_kernels.py's grid; every shape in f32 and bf16, with the
   tolerances there (f32 2e-5, bf16 2e-2; the f32 checks hold the
   arithmetic tightly at the main path's shapes too; in bf16 the flash
   kernel's tensor cores round P to bf16, which the tests show stays
   within the bf16 gate); every bf16 flash shape also against
   ref.flash_attention_bf16_emulation, the kernel's own rounding in plain
   PyTorch: what its bf16 output store (half an ulp) leaves of the error,
   over 1 + the largest |value| of its row, within FLASH_EMU_TOL, which at
   the prefill shape must reject three faulty versions of the emulation
   (a key tile lost for long rows, one warpgroup's last rescale skipped,
   O rounded to bf16 after every tile); at the main path's shapes in bf16, kernel,
   plain and library times (scaled_dot_product_attention, the yardstick
   only) and the bound, and decode's split count per shape; then decode at B=1
   against 4096 rows with every split count forced (1..8), f32 and bf16,
   a random length and the full one, checked and (bf16) timed (a
   sequence of length 0 gets the mean of its V rows, as from the
   reference; tests/test_torch_cuda.py holds that at every split count);
7. LM golden replay: ``tests/data/torch_lm_golden.npz`` (reduced Llama,
   f32, JAX outputs) through the port's prefill and serve steps on the
   card: prefill logits, prefill cache and every exit's serve logits
   within 1e-4;
8. prefill at full width: llama3_2_1b, bf16, random weights from seed 0,
   B=4, S=2048; exactly 16 flash_attention and 0 decode_attention
   launches;
9. serve at full width: greedy decoding as EdgeServingEngine._decode does
   it, B=8 prompts of 16..64 tokens (numpy seed 0), 32 new tokens, a
   256-row cache, at each exit (4, 8, 12, 16); decode_attention launches
   = exit x steps; then one serve_step per exit at B=64 against a
   4096-row cache from a prefill (pos = 4095);
10. consistency at full width: a 256-token prefill at B=2 against the
   same tokens teacher-forced through serve_step: last logits and every
   layer's K/V within relative L2 2e-2 (bf16);
11. ssm_scan against its plain version: tests/test_kernels.py's grid in
   both semantics (Mamba without a bonus, RWKV with one) and RWKV-6-7B's
   prefill shape [4, 2048, 64, 64, 64], chunk 128, RWKV semantics, in f32
   and bf16, unit-normal q, k, v; each with the fast log decay -exp(0.5 N)
   of the tests and a slow one -exp(0.5 N - 5) with a nonzero initial
   state, so the carried state matters; y and the final state within f32
   1e-4 / bf16 3e-2 of 1 + the largest |value| of their (sequence, head)
   (float32 rounding scales with the sums a recurrence adds, and |y|
   reaches ~400 at slow decays); at the prefill shape in f32 the same
   tolerance must reject the plain version with the initial state
   dropped, the decays one token late or the bonus dropped; every bf16
   shape also against ref.ssm_scan_bf16_emulation, the tensor-core
   kernel's own rounding in plain PyTorch (ref.ssm_emu_err: y beyond its
   bf16 output rounding within ref.SSM_EMU_TOL, the state within
   ref.SSM_EMU_STATE_TOL, of 1 + the largest |value| of the sequence and
   head), which at the prefill shape must reject three faults planted in
   the emulation (the last off-diagonal sub-block dropped for the last
   sub-block's rows, the carried-state read skipped in the last chunk,
   k_out's lo half dropped); the bf16 and f32 kernels' shared memory and
   blocks per SM at the prefill shape (bf16 must fit two); in bf16
   kernel time (CUDA-graph replay) beside the first design's, plain time
   (CUDA events around one eager call: the plain version is a 2048-step
   loop) and the bound (the recurrence's 5 dk dv operations per token and
   head);
12. RWKV golden replay: ``tests/data/torch_rwkv_golden.npz`` (reduced
   RWKV-6, f32, JAX outputs) through the port on the card: prefill logits
   and state and every exit's serve logits within 1e-4;
13. prefill at full width: rwkv6_7b (Llama's params freed first), bf16,
   random weights from seed 0, B=4, S=2048; exactly 32 ssm_scan launches
   and no attention launch;
14. serve at full width: greedy decoding as in phase 9, B=8 prompts of
   16..64 tokens, 32 new tokens, at each exit (8, 16, 24, 32); no kernel
   launch (decode runs the plain recurrence step) and no state past the
   exit written; then one serve_step per exit at B=64 from the state of a
   256-token prefill;
15. consistency at full width: a 256-token prefill at B=2 against the
   same tokens teacher-forced through serve_step, relative L2 of the last
   logits and every layer's wkv, shift_tm and shift_cm: in bf16 all
   printed and layer 0's (same inputs on both paths) within 2e-2; then on
   the same weights in float32, all within 2e-3, once with the init's
   decays and once with w0 uniform in [-6, 0] (slow decays, so the state
   carried across prefill's two chunks matters); in bf16 the drift grows
   with depth to ~0.1-0.2, in the JAX reference too (tools/rwkv_drift.py);
16. training, the actor kernels' gradients: at the training minibatch
   (64 graphs of a fresh slot, full width, the option side's transposed
   adjacency view), every input's gradient of each of the five actor
   launches (the kernel's forward, the hand-written backward) against
   PyTorch's autograd of the plain version, for a random cotangent,
   within rtol 2e-4 / atol 1e-4 (tests/test_kernels.py's);
17. training golden replay: ``tests/data/torch_port_train_golden.npz`` (a
   JAX ``train=True`` run, B=4, T=64, 5 train steps, with its draws and
   each step's replay rows) through the port's driver: decisions equal,
   or a flip only at a recorded near-tie (<= 1e-5), after which the
   comparison stops (fatal before the first train step); each loss
   within 1e-5 relative; the final params and Adam moments within
   TRAIN_PARAM_TOL (nu: TRAIN_NU_TOL);
18. the training path at full width on the port's own generator: B=64,
   T=200, ring 128, minibatch 64, a step every 10 slots: 20 finite
   losses, exactly 880 gcn_agg and 220 edge_score launches, slot ms
   beside the decision path's (episodes in the order decision, training,
   training, decision), and one train step split into forward, backward
   and Adam: ms by CUDA events and CUDA launches of each;
19. the compiled episode, ``RolloutDriver.run(mode="scan")`` (one CUDA
   graph a slot; phases 4, 5, 17 and 18 pass ``mode="loop"``, whose
   launches the wrappers count, which they cannot for a graph's replays):
   (1) the decision golden in scan mode, 128/128 as in phase 4; (2) the
   training golden in scan mode as in phase 17, then against the loop on
   the same draws: decisions and rewards bit for bit, the largest loss
   and param differences printed; (3) B=64, T=200, fig5_baseline on the
   port's own generator (registered with the graphs), without and with
   training (ring 128, minibatch 64, a step every 10 slots): slot ms of
   episodes in the order loop, scan, scan, loop; from the profiler's
   device records of a scan episode exactly 800 gcn_agg and 200
   edge_score launches (880 and 220 with training), each cudaGraphLaunch
   carrying its own slot's (4 and 1, 8 and 2 on a train step), one
   cudaGraphLaunch a slot and the busy share; whether scan equals loop bit for bit on one
   seed (else both runs' ssp and avg_accuracy); (4) B=1024, T=50 without
   training, slot ms of loop and scan; (5) B=64, T=200 with training and
   ``telemetry=True``: scan's counters and histogram counts equal the
   loop's bit for bit and its loss EMA within 1e-5 relative, the counters
   agree with the trace, and telemetry on and off give the same
   decisions, rewards and params; scan slot ms with telemetry on and off;
20. serving golden replay: ``tests/data/torch_serve_golden.npz`` (a JAX
   ``EdgeServingEngine`` run, reduced Qwen in f32, 12 slots of explicit
   and arrival-driven requests with decoding and one train step, with its
   draws) through the port's engine with the draws injected: every slot's
   assignments and generated tokens equal, rewards within 1e-5 and the
   loss within 1e-5 relative, the final params within TRAIN_PARAM_TOL;
21. serving at full width: Llama-3.2-1B (bf16, random weights from seed
   0) behind ``EdgeServingEngine`` (replicas fast-pod 1.0 and slow-pod
   0.5, 8 batch slots, a 256-row cache, GRLE with ring 32, minibatch 8, a
   train step every 5 slots), 10 slots of 8 requests (prompts of 16..64
   tokens, 16 new) with decoding: launches exactly gcn_agg 4 and
   edge_score 1 per slot plus as many per train step, decode_attention
   exit x (longest prompt + 16) per exit group; finite losses; slot ms
   with and without decoding; the telemetry summary; the five actor
   launches of this engine (M=8, O=8; its workload's tasks, its live
   state, its trained params) at B=1 and the minibatch B=8, forward (TOL)
   and every input's gradient (GRAD_RTOL/GRAD_ATOL) against the plain
   versions, and decode_attention at each exit group's batch size, at
   the first and the longest position's lengths, against its plain
   version (ATTN_TOL). Then ``ContinuousServingEngine`` (batch 32, no LM:
   its rates are the scheduling plane's, the agent and the env step)
   drains a ``make_trace`` of 64 users over 200 dyn_bursty slots: the
   counter law exact, steps/s, requests/s, gcn_agg 4 per step and per
   train step, and its actor launches (M=32) checked as the sync
   engine's; and for 50 steps
   of that trace the async engine's assignments equal a sync engine's
   from the same seed, params within TRAIN_PARAM_TOL. The sync engine
   also serves one request longer than its cache (a 250-token prompt, 40
   new tokens: decoded over the wrapped cache, as the reference does),
   with exit x 290 decode_attention launches, and holds that group's
   decode_attention at S=256 with every length at S against its plain
   version (ATTN_TOL). Each serving phase prints its wall seconds;
22. dynamic and baseline golden replay: ``tests/data/
   torch_port_dyn_golden.npz`` (three JAX ``train=True`` runs, B=4,
   T=64, ring 32, minibatch 8, a step every 5 slots: DROO on fig8_csi,
   DROOE on dyn_bursty with the workload's raw uniforms injected, GRLE on
   dyn_markov_channel with one sampled scenario per fleet), each first
   teacher-forced (every decision the run's or at a recorded near-tie,
   the env and learner then following the run's decisions: every loss
   within TRAIN_LOSS_RTOL, the final params and moments within
   TRAIN_PARAM_TOL), then through the port's driver in loop and in scan
   mode, held as phase 17 holds its run up to the first near-tie flip
   (DROO's critic meets exact ties, and there the driver's run leaves the
   golden one), loop and scan bitwise equal;
23. the paper's four methods at full width: GRLE, GRL, DROOE and DROO on
   fig5_baseline's structure (M=14, N=2, L=5, ring 128, minibatch 64,
   omega 10), B=64, T=200, train=True, scan mode, seed 0, on fig8_csi,
   dyn_bursty and a domain-randomized fleet (one ScenarioSpace("fig5_
   baseline", "fig8_csi") draw per fleet): ssp, avg_accuracy, slot ms,
   the first run's warm-up and capture seconds, the GRLE/GRL and
   GRLE/DROOE accuracy ratios (printed, not gated); from the profiler's
   device records exactly 880 gcn_agg and 220 edge_score launches per
   GCN run and none per MLP run; per scenario one greedy_decision on a
   fresh slot and GRLE's q_best over the oracle's value (Fig 4's
   normalization); the phase's wall seconds;
24. the paper's results grid through ``repro_torch.sweep``: ``run_sweep``
   on a store under ``build/`` over fig5_baseline, fig6_capacity,
   fig7_jitter, fig8_csi, dyn_poisson, dyn_churn, dyn_markov_channel,
   dyn_bursty and four ``SweepSpec.from_space("fig5_baseline",
   "fig8_csi", 4)`` draws, the four methods, seeds 0 and 1, at the
   ``SweepSpec`` defaults (M=14, T=300, B=1, ring 128, minibatch 64,
   omega 10), telemetry on: 96 cells in 6 packs (iid 32, poisson 12,
   mmpp 4, per actor family). Fatal: a ``CompileTracker`` reads one
   episode built and two graphs captured per pack; ``run_cell`` on every
   seed-0 cell of the iid GCN pack and the poisson MLP pack gives its
   packed row bit for bit (every field, the telemetry too); the
   profiler's device records over one GRLE cell's replays inside its
   pack count 4 x (T + train steps) gcn_agg and T + train steps
   edge_score, over one DROO cell none; one stored cell of the iid GCN
   pack deleted, a rerun runs that pack alone and rewrites the file byte
   for byte, every other file untouched, and a third run executes
   nothing; every GCN cell's final loss finite. Prints per pack its
   cells, wall seconds, first cell's seconds (build and capture
   included), capture seconds and ms a slot per cell after it; packed
   and sequential cells/s; the report's markdown and the telemetry table
   (not gated: random initial weights and 24 train steps reproduce no
   paper ratio); the phase's wall seconds;
25. population golden replay: ``tests/data/torch_pop_golden.npz`` (a JAX
   ``PopulationTrainer`` run: GRLE, P=4 members with sampled lr /
   explore_gain / exit_tau, B=2, T=15, M=5, 2 generations, PBT every
   generation, with every draw: hyperparameter uniforms, curriculum
   regions and offsets, each member's tasks, Gumbel exploration noise and
   replay rows, PBT's coin and jitters) through the port's trainer on the
   card: every decision equal, or a flip only at a recorded near-tie (<=
   1e-5: critic, actor or exploration-noise margin), after which the
   comparison stops; per member avg_reward / ssp / avg_accuracy within
   1e-5; PBT's src, copied and ranks exact; hypers and the curriculum
   state within 1e-6; region visits and telemetry counters equal; the
   final params within TRAIN_PARAM_TOL;
26. population training at the paper's width: ``PopulationTrainer`` with
   GRLE (M=14, N=2, L=5, hidden (128, 64), edge 64), the fig5_baseline..
   fig8_csi curriculum in 6 regions, P=16 members of 1 fleet, 80 slots,
   ring 64, minibatch 16, omega 5 (``launch/pop.py``'s defaults at M=14),
   3 generations, then ``evaluate`` at t in {0.8, 0.9, 1.0}. Fatal: a
   ``CompileTracker`` reads one episode built and two graphs captured for
   the training driver over all 48 member-episodes, one and one for the
   evaluation driver; the profiler's device records over one
   member-episode count 4 x (80 + 13 train steps) ``gcn_agg`` and 80 + 13
   ``edge_score``; generation 0, ``save_population``,
   ``restore_population`` into a fresh trainer and generation 1 equal two
   uninterrupted generations bit for bit on every leaf; every member's
   final loss finite; a DROOE population (P=4, one generation) launches
   no actor kernel. Prints each generation's wall seconds and report,
   member-slots/s, ms a slot per member, the first generation's build and
   capture seconds, the evaluation's seconds and rewards;
27. observability: ``python -m repro_torch.launch.profile --devices 14
   --episodes 2 --slots 80 --trace`` on the card: its run log holds manifest,
   episode, episode, compile, the compile event one episode and two
   graphs, and its trace file ``gcn_agg`` kernel records and the
   ``obs/<phase>`` spans; ``obs.cost.hot_program_costs(quick=True)`` on
   the card and on the CPU give equal FLOPs per program (the cost table is
   printed);
28. the zoo's new kernel shapes against their plain versions, each in
   f32 and bf16 (ATTN_TOL; bf16 flash also against its emulation within
   FLASH_EMU_TOL): flash_attention at Zamba2's shared block [4, 2048, 32,
   32, 80] causal and at Whisper's encoder [4, 1500, 16, 16, 64] without
   the mask; decode_attention at [8, 32, 32, 80, S=256] with random
   lengths and at Whisper's cross-attention [8, 16, 16, 64, S=1500] with
   every length 1500; ssm_scan in bf16 with Mamba-2's read-out (no
   bonus, one decay per head) at [4, 2048, 80, 64, 64] chunk 128, fast
   decays and slow ones from a nonzero state, y and state within SSM_TOL
   and within ref.SSM_EMU_TOL / SSM_EMU_STATE_TOL of the emulation; in
   bf16 kernel, plain and library (scaled_dot_product_attention) times
   and the bound;
29. zoo golden replay: ``tests/data/torch_lm_zoo_golden.npz`` (reduced
   Zamba2, DeepSeek-MoE, DeepSeek-V2 and Whisper, f32, JAX outputs)
   through the port on the card: prefill logits and every exit's serve
   logits within 1e-4 of 1 + |ref|, layer 0's MoE expert choices and kept
   slots equal;
30. the zoo at full width in bf16, random weights from seed 0, one model
   at a time: Zamba2-2.7B (prefill B=4, S=2048), DeepSeek-MoE-16B (B=4,
   S=2048), Whisper-medium (the encoder over 4 x 1500 frames, the
   decoder's dense pass over S=448) and DeepSeek-V2-236B with its depth
   cut to 4 layers (B=1, S=2048): prefill ms and prompt tokens/s; greedy
   decoding of 8 requests (prompts of 16..24 tokens, 8 new, a 256-row
   cache; Whisper against its encoder's output) at every exit, ms a step
   and tokens/s; the hand kernels' launches of each call exactly as
   ``zoo_launches`` counts them; a 128-token prefill at B=2 against the
   same tokens teacher-forced through serve_step (the MoE models with the
   capacity raised so that no slot drops on either path), relative L2 of
   the last logits and the first and last layer's caches (and the shared
   block's) printed, within CONSIST_TOL: in bf16 at layer 0 (Whisper: the
   logits; deeper, bf16 drifts: the scan kernel's bf16 products, MoE
   routers flipping near-tied experts); in float32, on fresh weights at
   full width (DeepSeek-MoE cut to 14 layers, DeepSeek-V2 to 2, so the
   float32 weights fit), every one;
31. the slice's main path: ``python -m repro_torch.launch.serve --arch
   zamba2_2_7b --slots 10 --decode`` in-process (launch/serve.py's engine
   and requests): every slot's assignments and ms; launches exactly
   gcn_agg 4 and edge_score 1 a decision plus as many a train step,
   decode_attention (shared-block applications below the exit) x 12
   positions per exit group, each nonzero; the actor launches (M=4) and
   decode_attention (d=80) at the engine's shapes against their plain
   versions; slot ms without decoding;
33. the differentiable flash route: ``ops.flash_attention`` on inputs
   that require grad (Llama's training shape [8, 256, 32, 8, 64] in bf16
   and f32, a window of 128, Whisper's maskless encoder over 1500
   frames): one launch, its output the kernel's bit for bit, q/k/v
   gradients within ATTN_TOL of autograd through the plain version, and a
   control (the softmax scale dropped from the backward) that the gate
   must reject; the forward and backward ms at the training shape;
34. the training golden: ``tests/data/torch_train_golden.npz`` (reduced
   Llama with exits and remat, DeepSeek-MoE, Whisper, RWKV-6 and Zamba2
   with remat and 8-row chunks; two f32 AdamW steps each) replayed: the first step's gradients within 1e-4 of each
   leaf's max, losses and per-exit CE within 1e-5, params by the Adam
   rule (near-ties counted);
35. path A, LM training: ``python -m repro_torch.launch.train --arch
   llama3_2_1b --steps 20 --batch 8 --seq 256`` in-process (full width and
   depth, bf16, remat, four exits): finite losses, step ms, tokens/s,
   peak memory, and 2 x 16 flash launches a step (the wrapper over the
   run, the profiler over one more step, up to three windows until one
   reads them: it drops device records); then three AdamW steps on one
   batch, whose loss must fall at every step;
36. path B, the paper's pipeline: the golden's VGG run replayed; then
   examples/torch_vgg_offloading.py's stages at VGG-16's full width:
   300 + 300 training steps at batch 64 (steps/s), ``profile_exits`` on
   the card (five rows), GRLE over 300 slots on that profile with the
   profiler's gcn_agg/edge_score kernels (4 and 1 per actor forward);
   ssp and avg_accuracy printed;
37. the differentiable scan: ``ops.ssm_scan`` on inputs that require
   grad at the SSM configs' training shapes (Zamba2's [8, 256, 80, 64,
   64] without the bonus, RWKV-6's [8, 256, 64, 64, 64] with it, chunk
   128), bf16 and f32, with and without an initial state: one launch, y
   and state the kernel's bit for bit, held against the sequential plain
   version (f32 1e-4 of 1 + the largest |value|; bf16 against the
   kernel's emulation, its planted faults rejected); the chunked VJP's
   gradients against autograd of the sequential version in f32 at B=2
   within 1e-4 of each leaf's max, and a control (one chunk's decays
   perturbed) that the gate must reject; the kernel's us and the
   backward's ms a call;
38. the SSM configs trained at full width in bf16 (B=8, S=256, remat,
   four exits): Zamba2-2.7B through ``python -m repro_torch.launch.train
   --arch zamba2_2_7b`` in-process, RWKV-6-7B with its depth cut to
   RWKV_TRAIN_LAYERS of 32 layers: finite losses, step ms, tokens/s, peak
   memory, the step's parts, the busy share, ``ssm_scan`` launches a step
   2 x the layers and flash 9 (Zamba2's shared block), by the wrappers
   and by the profiler; then three AdamW steps on one batch, whose loss
   must fall at every step;
39. the long-context window decode: Llama-3.2-1B under
   ``launch/specs.py::arch_for_shape(..., INPUT_SHAPES["long_500k"])`` (an
   8192-row window), B=1, random weights from seed 0. In float32: a
   prefill of 8000 tokens (its ring), then 400 teacher-forced serve_step
   calls across position 8192 (the ring wraps at step 192), and a prefill
   of 10000 tokens (the ring rolled by 1808), then 64 steps: every step's
   logits within CONSIST_TOL (relative L2) of the dense windowed prefill
   of the same tokens (flash with the window), the ring rows of layers 0
   and 15 within CONSIST_TOL of that prefill's; exactly 16 flash launches
   a prefill and 16 decode_attention a step. The same runs in bf16 with
   layer 0's ring gated (the last logits' relative L2 printed). In both
   dtypes flash_attention on layer 0's inputs over 10000 tokens with the
   window and decode_attention on a full 8192-row ring against their
   plain versions (ATTN_TOL; bf16 flash also against its emulation within
   FLASH_EMU_TOL; bf16 times beside the plain, library and bound times).
   In bf16 the params, the init_cache ring over 524288 positions and
   int32 tokens and positions are built as the dry run counts them (the
   bytes they request from the caching allocator and memory_allocated's
   growth kept); a prefill of 10000 tokens timed
   (exactly 16 flash launches), then 32 steps at each exit (4, 8, 12,
   16) timed, decode_attention exit x 32 by the wrapper, and exit x 4 by
   the profiler over 4 more steps;
40. the one-card dry run: ``python -m repro_torch.launch dryrun --sweep``
   in-process: 40 ok records, each printed with its roofline time on the
   H100 (max(flops / 989e12, bytes / 3.35e12)); llama3_2_1b x long_500k's
   argument_size_in_bytes equal to the bytes phase 39's tensors requested,
   and their memory_allocated growth within the allocator's rounding (512
   B a tensor, and a cached block of up to 1 MiB more that it does not
   split for a tensor above 1 MiB); its roofline beside the measured ms a
   step at exit 16;
41. (run right after phase 2, where the allocator is cleanest) the three
   dense configs never run elsewhere at full width: first flash_attention
   at [4, 2048, 48 | 64, 8, 128] causal and decode_attention at [8, 48 |
   64, 8, 128, S=256] (InternLM2's and Chameleon's GQA; StableLM's shapes
   are phase 28's) against their plain versions as in phase 28, bf16
   times; then Chameleon-34B, InternLM2-20B and StableLM-3B one at a
   time, bf16, random weights from seed 0: DecoderLM.init's peak
   allocation at most 2 x launch/analysis.py's _param_count + 2 GB, both
   printed (StableLM's params also equal bit for bit to the old init's
   stacked draws); a prefill at B=4, S=2048 with exactly n_layers flash
   launches and its peak memory; greedy decoding as in phase 9 at every
   exit, prompts of 16..24 tokens, 8 new ones (decode_attention exit x
   steps);
   prefill against teacher-forced decode over 2 x 128 tokens, every
   layer's K and V printed, layer 0 within 2e-2; then in float32 at full
   width with the depth cut to 4 layers, every layer and the logits
   within 2e-3;
42. the six examples ported from the reference in-process at their
   defaults (examples/torch_quickstart.py, torch_scenario_fleet.py,
   torch_sweep_paper_figures.py, torch_pop_curriculum.py's compare,
   torch_edge_serving.py --decode, torch_train_100m.py --steps 30),
   each with its wall time and rate and its wrappers' launches gated (see
   examples_phase), the population's margin printed and its sign not
   gated, the 100M trainer's one-batch loss falling and its checkpoint
   read back equal;
44. the continuous engine against JAX on the card:
   ``tests/data/torch_serve_async_golden.npz`` (a JAX
   ``ContinuousServingEngine`` at the serve-bench's --quick shape: 32
   slots, the bench's agent knobs, its warm-up and main traces (64 users,
   arrivals on a grid 8x the engine's slot, slack 600 s) and the main
   stream's next 512 requests, 26 steps, two train steps, with its draws)
   through the port's continuous engine with the draws injected: every
   step's decision equal, or a flip only at a recorded near-tie (<= 1e-5,
   critic or actor margin, phase 17's rule), after which the comparison
   stops (fatal before the first train step); every step report's
   admitted, expired and served rids, hits, slots, replicas and exits
   equal, served latencies within 1e-6 relative; counts, tokens served,
   the bench row's fields and the final params (TRAIN_PARAM_TOL) equal;
   exactly gcn_agg 4 and edge_score 1 a decision and a train step;
45. the slice's main path: ``python -m repro_torch.launch serve-bench`` at
   its defaults in-process (launch/__main__.py's main; the rows' file and
   the run-history store in a temporary directory): the 4-slot sync loop
   against the 64-slot continuous engine on one MMPP trace of 1200
   requests (128 users): both rows with the reference's keys, stamped with
   the card's name and power limit, 1200 requests each, the bench's own
   assertions (every request served; continuous beats sync on
   requests/s) and the same read from the rows; over each timed window
   (and each warm-up) exactly gcn_agg 4 and edge_score 1 a decision and a
   train step and no other kernel; both rows, the speed-up, ms a step and
   a slot printed; each engine's five actor launches (M=4 and M=64, O=4)
   against their plain versions at B=1 and the minibatch (TOL, and every
   gradient within GRAD_RTOL/GRAD_ATOL), and timed at B=1 beside the plain
   time and the bound;
46. the fleet, member and cell axes over the cards: one rank a card
   (``torch.cuda.device_count()`` processes, NCCL, ``repro_torch.sharding.
   ranks.RankPool``, rank r on cuda:r, the kernels of phase 2 loaded, not
   rebuilt), each on a ``fleet`` ``DeviceMesh`` over the group, against
   this process's unsharded runs (``fleet_run``, ``fleet_check``): (a)
   ``RolloutDriver.run_sharded`` on GRLE fig5_baseline at full width (M=14,
   ring 128, minibatch 64, omega 10), B=64, 40 slots with training, scan
   then loop: the decisions, the trace, the replay ring, the params and
   the whole final carry bit for bit on every rank, the metrics equal,
   scan equal to loop, exactly gcn_agg 4 and edge_score 1 a slot and a
   train step a rank (the wrappers' counts in loop mode; in scan mode the
   profiler's, with 2 cudaGraphLaunch a slot sharded and 1 unsharded);
   (b) one population generation, P = 4 x world members at POP_FULL's
   width (M=14), 20 slots: the report, the agents and the [P] metrics
   bit for bit; (c) one sweep pack of world + 1 fig5
   GRLE cells (3 on one card: padded to the rank count with world > 1),
   30 slots: the rows equal to ``run_cell``'s. On one card two gloo
   ranks sharing it run the same and are held to the same. The ranks
   start once this process's timed runs are done. Prints the world size
   (and on one card that the law across ranks is held by the CPU tests),
   slot ms sharded and unsharded and the graph launches a slot (2
   sharded: the fleets' half and the learner's, the all-gather between
   them outside the graphs; 1 unsharded);
43. (last) one ``{"zoo_kernel_shapes": [...]}`` line (phase 28's timed shapes),
   one ``{"dense_kernel_shapes": [...]}`` line (phase 41's), one
   ``{"kernels": [...]}`` line (launches of phases 18, 30, 31, 35, 36,
   38, 39, 41, 42, 45 and 46 and the LM prefills and decodes), the card line
   again, and last ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no GPU is available.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels.cost import (  # noqa: E402
    decode_cost, edge_score_cost, flash_cost, gcn_agg_cost, ssm_cost)
from repro_torch.obs.profile import PHASE_SPANS  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_golden.npz")
TRAIN_GOLDEN = os.path.join(ROOT, "tests", "data",
                            "torch_port_train_golden.npz")
LM_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_lm_golden.npz")
RWKV_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_rwkv_golden.npz")
TOL = 1e-5            # max abs error, kernel vs plain, float32
NEAR_TIE = 1e-5       # golden: a flipped decision must sit at such a margin
N_FLEETS, N_SLOTS, SEED = 64, 200, 0
# training: tests/test_kernels.py's tolerance for the actor kernels'
# gradients; each golden train step's loss, relative; the golden run's
# final params and Adam moments (rtol, atol): tests/test_policy.py's rtol,
# atol ~5x the largest abs errors the card read (params 3.725e-8, mu
# 2.235e-8, nu 2.619e-10; NVIDIA H100 80GB HBM3, 700 W; PERF.md §6)
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-4
TRAIN_LOSS_RTOL = 1e-5
TRAIN_PARAM_TOL = (1e-4, 2e-7)
TRAIN_NU_TOL = (1e-4, 2e-9)
# attention: tests/test_kernels.py's tolerances; LM golden; consistency
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LM_GOLDEN_TOL = 1e-4
# bf16 flash_attention against its emulation, beyond the output's bf16
# rounding (flash_emu_err): what remains are P's bf16 roundings that the
# kernel's ex2.approx and summation order tip the other way, each moving a
# short row by up to 2^-8 of a key's weight; ~2x the largest reading on the
# card, well under the faults of FLASH_FAULTS
FLASH_EMU_TOL = 1e-3
# torch.profiler (torch 2.11, CUDA 12.8, H100) can lose the device records
# of the last milliseconds of work in its window, even after a synchronize:
# a scan episode whose window closed at once showed 872 of its 880 gcn_agg
# launches, the last slots' records missing (tools/torch_profiler_window.py
# measures it). Every profiled window here stays open this long after its
# work's closing synchronize.
PROFILER_TAIL_S = 0.2
# ptxas' warnings that it serialized a kernel's wgmma instructions
WGMMA_SERIALIZED = ("C7514", "C7518")
CONSIST_TOL = 2e-2
# RWKV-6 in bf16 drifts far more than that over its 32 layers, in the JAX
# reference too (tools/rwkv_drift.py); its full-depth consistency is held in
# float32, 10x tighter than the bf16 limit, and in bf16 at layer 0 only,
# whose inputs both paths share
CONSIST_F32_TOL = 2e-3
# the LM path: Llama-3.2-1B at full width
LM_ARCH = "llama3_2_1b"
PREFILL_B, PREFILL_S = 4, 2048
SERVE_B, SERVE_NEW, SERVE_CACHE, PROMPT_LENS = 8, 32, 256, (16, 64)
LONG_B, LONG_S = 64, 4096
CONSIST_B, CONSIST_P = 2, 256
# the SSM path: RWKV-6-7B at full width; tests/test_kernels.py's ssm grid
# (B, T, H, dk, dv, chunk) and tolerances, taken of 1 + the largest |value|
# of each (sequence, head) (scan_err)
SSM_ARCH = "rwkv6_7b"
SSM_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
SSM_GRID = ((2, 64, 2, 8, 16, 16), (1, 128, 4, 16, 16, 32),
            (2, 32, 1, 64, 32, 32))
SSM_PREFILL = (PREFILL_B, PREFILL_S, 64, 64, 64, 128)
SSM_LONG_B, SSM_LONG_P = 64, 256
# the bf16 scan's time at SSM_PREFILL in its first design (f32 products on
# the CUDA cores, one block per SM; PERF.md §6 row 5), beside the current
SSM_FIRST_DESIGN_US = 2338.39
STATE_FIELDS = ("wkv", "shift_tm", "shift_cm")
# the actor kernels at B fleets: a live scheduler, the smoke's fleets, a
# sweep or population evaluation
ACTOR_BATCHES = (1, N_FLEETS, 1024)
# device us per launch of the first design (one block per graph, weights
# read through L1/L2), by launch and B: tools/torch_actor_kernels.py on
# that tree, NVIDIA H100 80GB HBM3 at 700 W, the mean of two runs in one
# call (PERF.md §6)
FIRST_DESIGN_US = {
    "gcn_agg": {
        "layer1/device": {1: 7.10, 64: 7.33, 1024: 17.50},
        "layer1/option": {1: 6.20, 64: 6.40, 1024: 13.77},
        "layer2/device": {1: 44.42, 64: 49.00, 1024: 103.53},
        "layer2/option": {1: 24.10, 64: 25.67, 1024: 65.92}},
    "edge_score": {"edge": {1: 11.47, 64: 12.01, 1024: 40.48}},
}
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, non-tensor-core float32
# FLOP/s and dense bf16 FLOP/s; a bound takes the rate of its inputs' type
# (peak_for), whatever units the kernel itself computes on
PEAK_BYTES, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12
TASK_FIELDS = ("size_bits", "deadline_s", "rate_true", "rate_est", "capacity",
               "cmp_true", "cmp_est", "connect", "active")
# serving: the golden run's engine (tools/make_torch_port_golden.py's
# SERVE_* constants), and the full-width engines: ring 32, minibatch 8, a
# train step every 5 slots, so training falls inside the phase
SERVE_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_serve_golden.npz")
SERVE_ARCH, SERVE_REPLICAS = "qwen1_5_0_5b", (("a", 1.0), ("b", 0.7))
SERVE_AGENT_KW = dict(buffer_size=32, batch_size=8, train_every=5,
                      n_candidates=8)
ENGINE_AGENT_KW = dict(buffer_size=32, batch_size=8, train_every=5)
# 10 decoding slots (cut from 30, then 12, to keep the script inside its
# time limit): the ninth takes the phase's train step
ENGINE_B, ENGINE_SLOTS, ENGINE_NEW = 8, 10, 16
ASYNC_B, ASYNC_USERS, ASYNC_SLOTS, EQUIV_STEPS = 32, 64, 200, 50
# a request longer than the engine's cache: decoded over the wrapped cache
WRAP_PROMPT, WRAP_NEW = 250, 40
# the serving benchmark (repro_torch.launch.serve_bench): its golden run
# at the --quick shape (tools/make_torch_port_golden.py's BENCH_*; the
# file holds its knobs), the rows' keys (benchmarks/serve_throughput.py's,
# without its stamps) and the full mode's requests; served latencies are
# float32 on another device than the golden run's, so they are held to a
# relative tolerance, not to their 9 printed digits
SERVE_ASYNC_GOLDEN = os.path.join(ROOT, "tests", "data",
                                  "torch_serve_async_golden.npz")
BENCH_SYNC_KEYS = {"name", "derived", "wall_s", "requests_per_s",
                   "tokens_per_s", "n_requests", "n_tokens",
                   "deadline_hit_rate", "latency_p50_s", "latency_p99_s"}
BENCH_CONT_KEYS = BENCH_SYNC_KEYS | {"queue_depth_p99", "vs_sync_speedup"}
BENCH_REQUESTS = 1200
ASYNC_LATENCY_RTOL = 1e-6
# dynamic and baseline golden runs (tools/make_torch_port_golden.py's DYN_*)
DYN_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_dyn_golden.npz")
DYN_RUNS = ("droo_fig8", "drooe_bursty", "grle_space")
DYN_KW = dict(replay_capacity=32, batch_size=8, train_every=5)
# the paper's four methods (§VI-C) and phase 23's scenarios
METHODS = ("grle", "grl", "drooe", "droo")
SPACE = ("fig5_baseline", "fig8_csi")
# phase 24's grid: the paper's figures and the dynamic scenarios, with
# four space draws, at the SweepSpec defaults; its store lives under build/
SWEEP_SCENARIOS = ("fig5_baseline", "fig6_capacity", "fig7_jitter",
                   "fig8_csi", "dyn_poisson", "dyn_churn",
                   "dyn_markov_channel", "dyn_bursty")
SWEEP_DRAWS, SWEEP_SEEDS = 4, (0, 1)
SWEEP_STORE = os.path.join(ROOT, "build", "chip_smoke_sweep")
POP_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_pop_golden.npz")
# tools/make_torch_port_golden.py::POP, the golden run's configuration
POP_GOLDEN_CONFIG = dict(method="grle", space=("fig5_baseline", "fig8_csi"),
                         n_devices=5, members=4, fleets=2, slots=15,
                         regions=4, generations=2, seed=0, replay=16,
                         batch=4, train_every=5)
POP_METRIC_TOL = 1e-5    # avg_reward / ssp / avg_accuracy per member
POP_HYPER_TOL = 1e-6     # hypers and the curriculum state
# the population at the paper's width: the CLI's defaults at M=14
POP_FULL = dict(POP_GOLDEN_CONFIG, n_devices=14, members=16, fleets=1,
                slots=80, regions=6, replay=64, batch=16, train_every=5)
POP_GENERATIONS = 3
POP_EVAL_POINTS = (0.8, 0.9, 1.0)
# phase 46, the fleet axis over the cards: (a) the paper's learner at full
# width (fig5_baseline, M=14, ring 128, minibatch 64, omega 10) on B=64
# fleets for 40 slots; (b) one generation of P = 4 x world members at
# POP_FULL's width for FLEET_POP_SLOTS slots; (c) one pack of world + 1
# fig5 GRLE cells (3 on one card), padded to the rank count
FLEET_B, FLEET_T = 64, 40
FLEET_POP_SLOTS = 20
FLEET_CELL_SLOTS = 30
# a rank's wait for its group and its collectives, and the parent's wait
# for each rank's answer (on one card two gloo ranks share it as well:
# gloo's all-gather, broadcast and object gather carry CUDA tensors of two
# processes on one card, as one try on an H100 showed; NCCL refuses two
# ranks a card)
FLEET_TIMEOUT_S = 240
# the rest of the model zoo: its golden run (tools/make_torch_lm_golden.py
# zoo) and its models at full width, bf16, random weights from seed 0:
# (arch, prefill batch, prompt length, layers kept). DeepSeek-V2-236B's
# ~4.05 B params a layer do not fit the card's 80 GB at its 60 layers, so
# its depth is cut to 4 at full width (~17.3 B params, ~34.5 GB)
ZOO_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_lm_zoo_golden.npz")
ZOO_MODELS = (("zamba2_2_7b", PREFILL_B, PREFILL_S, None),
              ("deepseek_moe_16b", PREFILL_B, PREFILL_S, None),
              ("whisper_medium", PREFILL_B, 448, None),
              ("deepseek_v2_236b", 1, PREFILL_S, 4))
# the zoo's decode runs (and phase 41's): prompts of 16..24 tokens (cut
# from 16..32 for phase 46's time), 8 new tokens a request; its
# consistency runs over 128 tokens (one chunk of Zamba2's scan: the
# carried state across chunks is held by phases 28 and 29); both cut so
# that the whole script stays well inside its time limit
ZOO_PROMPT_LENS, ZOO_NEW, ZOO_CONSIST_P = (16, 24), 8, 128
# the MoE models' consistency runs with the capacity factor raised until
# no slot drops: a decode step routes all B tokens as one group, a prefill
# each row as its own, so with drops the two compute different functions
# (the reference's own decode-vs-dense test raises it for the same reason)
ZOO_CONSIST_CF = 64.0
# In bf16 prefill and decode drift apart with depth (NVIDIA H100 80GB HBM3,
# 700 W: Zamba2's last logits at 0.94 relative L2 after 54 layers,
# DeepSeek-MoE's 8.9e-2, DeepSeek-V2's 5.0e-2; layer 0 within 1.4e-4; PERF.md
# §6): the bf16 scan kernel rounds its products to bf16, and an MoE router
# flips near-tied experts between the two paths. So, as for RWKV-6, bf16 is
# gated where both paths share their inputs (layer 0; Whisper's logits, its
# decoder having no prefill cache), and every layer and the logits within
# CONSIST_TOL in float32, on fresh float32 weights at full width, the depth
# cut where the float32 weights would not fit beside the activations. In
# float32 Zamba2's 54 random layers still grow a 1.5e-6 difference at layer
# 0 to 2.8e-3 at the last (the MoE models: 3.4e-6), so RWKV-6's 2e-3 float32
# limit (CONSIST_F32_TOL) does not apply here
ZOO_F32_LAYERS = {"zamba2_2_7b": None, "deepseek_moe_16b": 14,
                  "whisper_medium": None, "deepseek_v2_236b": 2}
# the kernels' new shapes: Zamba2's shared block (d = 80, causal) and
# Whisper's encoder (S = 1500, no mask) at the prefill batch; decode at
# d = 80 (32 heads over 32) and Whisper's cross-attention (every length
# 1500); Zamba2's Mamba-2 scan (B, T, H, dk, dv, chunk)
ZAMBA_ATTN = (PREFILL_B, PREFILL_S, 32, 32, 80)
WHISPER_ENC = (PREFILL_B, 1500, 16, 16, 64)
ZAMBA_DECODE = (SERVE_B, 32, 32, 80, SERVE_CACHE)
WHISPER_CROSS = (SERVE_B, 16, 16, 64, 1500)
MAMBA_SCAN = (PREFILL_B, PREFILL_S, 80, 64, 64, 128)
# the slice's main path: the serving CLI's arguments
ZOO_SERVE_ARGS = ("--arch", "zamba2_2_7b", "--slots", "10", "--decode")


def phase(n, title):
    print(f"\n== phase {n}: {title}", flush=True)


def ptxas_report(log):
    """(kernel, registers, spill stores/loads, static smem bytes) of each
    entry function in nvcc's -Xptxas -v output, names demangled by
    c++filt where the machine has it."""
    rows, fn, spills = [], None, "?"
    for line in log.splitlines():
        if "Function properties for" in line:
            fn, spills = line.split("Function properties for")[1].strip(), "?"
        elif "spill stores" in line:
            parts = line.replace(",", "").split()
            spills = f"{parts[parts.index('spill') - 2]}/" \
                f"{parts[parts.index('loads') - 3]}"
        elif "Used" in line and "registers" in line and fn:
            words = line.replace(",", "").split()
            regs = words[words.index("registers") - 1]
            smem = (words[words.index("smem") - 2]
                    if "smem" in words else "0")
            rows.append([fn, regs, spills, smem])
            fn = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(
            r[0] for r in rows), capture_output=True, text=True,
            timeout=60, check=True).stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                n = n.replace("(anonymous namespace)::", "")
                r[0] = n.split("(")[0].removeprefix("void ")
    except (OSError, subprocess.SubprocessError):
        pass
    return rows


def card_line() -> str:
    from repro_torch.obs.log import card_line as first_card
    return first_card()


# ----------------------------------------------------------------- timing
def graph_ms(fn, *, inner=20, reps=10) -> float:
    """Device time of one ``fn()`` call: ``inner`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * inner)


def eager_ms(fn, *, n=200) -> float:
    """Wall time of one eager ``fn()`` call, host launch path included."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def bound(nbytes, flops, peak_flops=PEAK_F32):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def flash_emu_err(got, emu):
    """The bf16 flash kernel's error against its emulation beyond the
    bf16 rounding of its output (half an ulp, <= 2^-8 |emu|), over 1 + the
    largest |emu| of its row (query, head): f32 summation order and
    ex2.approx are all that should remain."""
    g, e = got.float(), emu.float()
    excess = ((g - e).abs() - 2.0 ** -8 * e.abs()).clamp(min=0)
    return float((excess.amax(-1) / (1 + e.abs().amax(-1))).max())


FLASH_FAULTS = ("a key tile lost for long rows",
                "the second warpgroup's last rescale skipped",
                "O rounded to bf16 after every tile")


def flash_fault(q, k, v, fault, tile=64):
    """ref.flash_attention_bf16_emulation (causal, no window) with one
    fault of FLASH_FAULTS planted, as the kernel could have it: query rows
    in the second half of S drop the key tile just before their 128-row
    block; or the second half's rows of each block's second 64 (the second
    warpgroup) skip the rescale of O on their last tile; or O is kept in
    bf16 between tiles. Float32 out, as the emulation's."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qf = q.float().reshape(b, s, kvh, h // kvh, d)
    kf, vf = k.float(), v.float()
    scale = 1.4426950408889634 / math.sqrt(d)
    pos = torch.arange(s, device=q.device)
    block = pos // 128 * 128
    late = pos >= s // 2
    m = torch.full((b, kvh, h // kvh, s), -math.inf, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(m.shape + (d,), device=q.device)
    for k0 in range(0, s, tile):
        kp = pos[k0:k0 + tile]
        sc = torch.einsum("bqkgd,bskd->bkgqs", qf,
                          kf[:, k0:k0 + tile]) * scale
        ok = kp[None, :] <= pos[:, None]
        if fault == FLASH_FAULTS[0]:
            ok &= ~(late & (block - tile == k0))[:, None]
        sc = torch.where(ok, sc, -math.inf)
        mx = torch.maximum(m, sc.amax(-1))
        mu = torch.where(mx == -math.inf, 0.0, mx)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(sc - mu[..., None])
        l = l * alpha + p.sum(-1)
        rescale = alpha
        if fault == FLASH_FAULTS[1]:
            skip = late & (pos % 128 >= 64) & (pos // tile * tile == k0)
            rescale = torch.where(skip, 1.0, alpha)
        acc = acc * rescale[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.bfloat16().float(), vf[:, k0:k0 + tile])
        if fault == FLASH_FAULTS[2]:
            acc = acc.bfloat16().float()
        m = mx
    out = acc / l.clamp(min=1e-38)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


def peak_for(dtype):
    return PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


# -------------------------------------------------------------- LM phases
def attention_phase(dev):
    """Phase 6: both attention kernels against their plain versions; at
    the main path's shapes also kernel, plain and library times and the
    bound. Returns the summary fields of each kernel."""
    from repro_torch.kernels import decode_attention as decode_mod
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def normal(dtype, *shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def check(kernel, label, dtype, got, want):
        """|kernel - plain| <= tol + tol * |plain| elementwise, as
        np.testing.assert_allclose(rtol=tol, atol=tol)."""
        diff = (got.float() - want.float()).abs()
        tol = ATTN_TOL[dtype]
        err = float(diff.max())
        print(f"  {kernel:16s} {label:44s} {str(dtype)[6:]:8s} max_abs_err "
              f"{err:.3e}", flush=True)
        if not bool((diff <= tol + tol * want.float().abs()).all()):
            raise SystemExit(f"{kernel} {label} {dtype}: kernel differs from "
                             f"plain by more than {tol} (rtol and atol); max "
                             f"abs error {err}")
        return err

    def check_emulation(label, got, emu):
        err = flash_emu_err(got, emu)
        print(f"  {'flash_attention':16s} {label:44s} {'bfloat16':8s} vs "
              f"emulation {err:.3e} beyond the output's rounding", flush=True)
        if err > FLASH_EMU_TOL:
            raise SystemExit(f"flash_attention {label} bf16: kernel differs "
                             f"from its emulation by {err} beyond the "
                             f"output's rounding (limit {FLASH_EMU_TOL})")
        return err

    def flash_controls(q, k, v, emu, plain):
        """The emulation check must reject each planted fault; whether the
        2e-2 gate against plain would is printed beside it."""
        tol = ATTN_TOL[torch.bfloat16]
        for fault in FLASH_FAULTS:
            bad = flash_fault(q, k, v, fault).bfloat16()
            err = flash_emu_err(bad, emu)
            gate = bool(((bad.float() - plain.float()).abs()
                         <= tol + tol * plain.float().abs()).all())
            print(f"  control: {fault}: {err:.3e} beyond the output's "
                  f"rounding (limit {FLASH_EMU_TOL}); the 2e-2 gate "
                  f"{'accepts' if gate else 'rejects'} it", flush=True)
            if err <= FLASH_EMU_TOL:
                raise SystemExit(f"flash_attention: the emulation check "
                                 f"accepts a planted fault ({fault})")

    def library_ms(library, inner, reps):
        """The yardstick's time; None (and why) if it cannot run here."""
        try:
            return graph_ms(library, inner=inner, reps=reps)
        except (RuntimeError, ValueError, TypeError) as exc:
            print(f"  library call not timed: {type(exc).__name__}: "
                  f"{str(exc).splitlines()[0] if str(exc) else ''}")
            return None

    def timed(kernel, label, fn, plain, library, cost, dtype, inner, reps):
        ms = graph_ms(fn, inner=inner, reps=reps)
        plain_ms = graph_ms(plain, inner=inner, reps=reps)
        lib_ms = library_ms(library, inner, reps)
        b_ms, b_by = bound(*cost, peak_flops=peak_for(dtype))
        lib = "n/a" if lib_ms is None else f"{lib_ms * 1e3:9.2f} us"
        print(f"  {kernel:16s} {label:44s} kernel {ms * 1e3:9.2f} us  plain "
              f"{plain_ms * 1e3:9.2f} us  library {lib}  "
              f"bound {b_ms * 1e3:8.2f} us ({b_by}, {cost[0] / 1e6:.1f} MB, "
              f"{cost[1] / 1e9:.2f} GFLOP)", flush=True)
        return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=b_ms, bound_by=b_by)

    out = {}
    # flash_attention: the prefill shape in bf16 (timed) and f32, then
    # tests/test_kernels.py's grid
    grid = [(PREFILL_B, PREFILL_S, 32, 8, 64, None, dt)
            for dt in (torch.bfloat16, torch.float32)] + [
        (b, s, h, kvh, d, win, dt) for dt in (torch.float32, torch.bfloat16)
        for b, s, h, kvh, d, win in ((1, 128, 2, 2, 32, None),
                                     (2, 128, 4, 2, 64, None),
                                     (1, 256, 8, 2, 32, 64),
                                     (2, 64, 4, 1, 128, None),
                                     (1, 200, 8, 2, 64, 64),
                                     (1, 200, 4, 2, 128, None))]
    errs, emu_errs = [], []
    for i, (b, s, h, kvh, d, win, dt) in enumerate(grid):
        q, k, v = normal(dt, b, s, h, d), normal(dt, b, s, kvh, d), \
            normal(dt, b, s, kvh, d)
        label = f"[{b}, {s}, {h}, {kvh}, {d}] window {win}"
        got = flash_mod.flash_attention(q, k, v, window=win)
        torch.cuda.synchronize()
        plain = ref.flash_attention_ref(q, k, v, window=win)
        err = check("flash_attention", label, dt, got, plain)
        if i < 2:
            errs.append(err)
        if dt == torch.bfloat16:
            emu = ref.flash_attention_bf16_emulation(q, k, v, window=win)
            emu_errs.append(check_emulation(label, got, emu))
            if i == 0:
                flash_controls(q, k, v, emu, plain)
            del emu
        del plain
        if i == 0:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            out["flash_attention"] = timed(
                "flash_attention", label,
                lambda: flash_mod.flash_attention(q, k, v),
                lambda: ref.flash_attention_ref(q, k, v),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True),
                flash_cost(q, k, None), dt, inner=5, reps=4)
    out["flash_attention"]["max_abs_err"] = max(errs)
    print(f"  flash_attention bf16 vs its emulation, largest error beyond "
          f"the output's rounding: {max(emu_errs):.3e} (limit "
          f"{FLASH_EMU_TOL})")

    # decode_attention: the main path's shapes in bf16 (timed) and f32,
    # then the test grid; one draw of lengths serves both dtypes
    lens_rng = np.random.default_rng(SEED)
    errs = []
    main_dts = (torch.bfloat16, torch.float32)
    # (B, H, KVH, d, S, dtypes, lengths, at a main-path shape)
    cases = [(bb, 32, 8, 64, LONG_S, main_dts, lens, True)
             for bb in (1, LONG_B) for lens in ("random", "full")]
    cases += [(SERVE_B, 32, 8, 64, SERVE_CACHE, main_dts, "random", True)]
    cases += [(b, h, kvh, d, s, (dt,), "random", False)
              for dt in (torch.float32, torch.bfloat16)
              for b, h, kvh, d, s in ((2, 4, 2, 32, 256), (3, 8, 2, 64, 512),
                                      (1, 2, 2, 128, 128))]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, h, kvh, d, s, dts, kind, main_shape in cases:
        lens = (np.full(b, s) if kind == "full"
                else lens_rng.integers(1, s + 1, size=b))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        label = f"[{b}, {h}, {kvh}, {d}, S={s}] lengths {kind}"
        if main_shape:
            n = decode_mod.n_splits(b, kvh, s, sms)
            print(f"  decode_attention {label}: n_splits {n}, "
                  f"{decode_mod.n_warps(b * kvh * n, sms)} warps per block, "
                  f"{sms} SMs, lengths sum {int(lens.sum())}")
        for dt in dts:
            q, k, v = normal(dt, b, h, d), normal(dt, b, s, kvh, d), \
                normal(dt, b, s, kvh, d)
            got = decode_mod.decode_attention(q, k, v, lengths)
            torch.cuda.synchronize()
            err = check("decode_attention", label, dt, got,
                        ref.decode_attention_ref(q, k, v, lengths))
            if main_shape:
                errs.append(err)
            if not main_shape or dt != torch.bfloat16:
                continue
            mask = (torch.arange(s, device=dev)[None, :]
                    < lengths[:, None])[:, None, None, :]
            q4, kt, vt = (q[:, :, None, :], k.transpose(1, 2),
                          v.transpose(1, 2))
            stats = timed(
                "decode_attention", label,
                lambda: decode_mod.decode_attention(q, k, v, lengths),
                lambda: ref.decode_attention_ref(q, k, v, lengths),
                lambda: F.scaled_dot_product_attention(
                    q4, kt, vt, attn_mask=mask, enable_gqa=True),
                decode_cost(q, k, lengths), dt, inner=20, reps=10)
            if b == LONG_B and kind == "full":
                out["decode_attention"] = stats

    # decode_attention at B=1 against 4096 rows, every split count forced
    lens = (int(lens_rng.integers(1, LONG_S + 1)), LONG_S)
    for dt in main_dts:
        q, k, v = normal(dt, 1, 32, 64), normal(dt, 1, LONG_S, 8, 64), \
            normal(dt, 1, LONG_S, 8, 64)
        for n in range(1, decode_mod.MAX_SPLITS + 1):
            for ln in lens:
                lengths = torch.tensor([ln], dtype=torch.int32, device=dev)
                got = decode_mod.decode_attention(q, k, v, lengths, splits=n)
                torch.cuda.synchronize()
                errs.append(check(
                    "decode_attention", f"[1, 32, 8, 64, S={LONG_S}] length "
                    f"{ln}, splits {n}", dt, got,
                    ref.decode_attention_ref(q, k, v, lengths)))
            if dt == torch.bfloat16:
                ms = graph_ms(lambda: decode_mod.decode_attention(
                    q, k, v, lengths, splits=n), inner=20, reps=10)
                print(f"  decode_attention B=1 S={LONG_S} full, splits {n}: "
                      f"kernel {ms * 1e3:9.2f} us", flush=True)
    out["decode_attention"]["max_abs_err"] = max(errs)
    return out


def lm_golden_phase(dev):
    """Phase 7: the reduced-Llama JAX run through the port on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.core.bridge import lm_params_from_numpy, lm_params_numpy
    from repro_torch.models import DecoderLM
    from repro_torch.train import make_prefill_step, make_serve_step

    with np.load(LM_GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    cfg = get_arch(str(gold["arch"])).reduced(
        **{k.split("/")[1]: int(gold[k]) for k in gold
           if k.startswith("reduced/")})
    params = lm_params_from_numpy(lm_params_numpy(cfg, int(gold["seed"])),
                                  cfg, dev)
    toks = torch.tensor(gold["tokens"], device=dev)
    b, t = toks.shape
    n = int(gold["prefill_len"])

    def err(got, key):
        want = torch.tensor(gold[key], device=dev)
        return float(((got.float() - want).abs() / (1 + want.abs())).max())

    logits, cache = make_prefill_step(cfg)(params, {"tokens": toks[:, :n]})
    errs = {"prefill/logits": err(logits, "prefill/logits"),
            "prefill/k": err(cache["layers"].k, "prefill/k"),
            "prefill/v": err(cache["layers"].v, "prefill/v")}
    for e in (int(x) for x in gold["exits"]):
        step = make_serve_step(cfg, exit_layer=e)
        c = DecoderLM.init_cache(cfg, b, t, device=dev)
        got = []
        for i in range(t):
            lg, c = step(params, c, toks[:, i],
                         torch.full((b,), i, dtype=torch.int64, device=dev))
            got.append(lg)
        errs[f"serve/logits_{e}"] = err(torch.stack(got), f"serve/logits_{e}")
    for k, v in errs.items():
        print(f"  {k:18s} max |d| / (1 + |ref|) {v:.3e}")
    worst = max(errs.values())
    if not worst <= LM_GOLDEN_TOL:
        raise SystemExit(f"LM golden: error {worst} above {LM_GOLDEN_TOL}")
    return worst


def lm_model(dev, arch=LM_ARCH):
    from repro_torch.configs import get_arch
    from repro_torch.models import DecoderLM

    cfg = get_arch(arch)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = DecoderLM.init(gen, cfg, device=dev)
    n = sum(x.numel() for x in _leaves(params))
    heads = (f"{cfg.n_heads} heads over {cfg.n_kv_heads} kv heads x "
             f"{cfg.head_dim}" if cfg.n_heads else
             f"{cfg.d_model // cfg.ssm_head_dim} {cfg.ssm_kind} heads x "
             f"{cfg.ssm_head_dim}, chunk {cfg.ssm_chunk}")
    print(f"{cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {heads}, exits "
          f"{cfg.exit_layers}, {cfg.dtype}; {n / 1e9:.3f} B params "
          f"(random, torch.Generator seed {SEED})", flush=True)
    return cfg, params, gen


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def prefill_phase(dev, cfg, params, gen):
    """Phase 8: one full-width prefill, its launches counted -> (flash
    launches, ms)."""
    from repro_torch.kernels import ops
    from repro_torch.train import make_prefill_step

    prefill = make_prefill_step(cfg)
    toks = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), generator=gen,
                         device=dev)
    prefill(params, {"tokens": toks[:, :256]})      # warm-up: cuBLAS, attrs
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"B={PREFILL_B} S={PREFILL_S}: {wall * 1e3:.3f} ms, "
          f"{PREFILL_B * PREFILL_S / wall:.1f} prompt tokens/s; launches "
          f"{counts}")
    if (counts["flash_attention"] != cfg.n_layers
            or counts["decode_attention"] or counts["ssm_scan"]):
        raise SystemExit(f"{cfg.arch_id} prefill launches {counts}: "
                         f"expected flash_attention {cfg.n_layers}, "
                         f"decode_attention 0")
    kv = (cfg.n_layers, PREFILL_B, PREFILL_S, cfg.n_kv_heads, cfg.head_dim)
    if (tuple(logits.shape) != (PREFILL_B, cfg.vocab)
            or not bool(torch.isfinite(logits).all())
            or tuple(cache["layers"].k.shape) != kv
            or not bool(torch.isfinite(cache["layers"].k).all())):
        raise SystemExit(f"{cfg.arch_id} prefill output malformed")
    return counts["flash_attention"], wall * 1e3


def greedy_decode(params, step, cache, prompt_mat, lens, max_new):
    """EdgeServingEngine._decode's loop: teacher-force each prompt, then
    feed back the argmax; returns each request's ``max_new`` outputs and
    the number of steps."""
    b, total = prompt_mat.shape
    dev = prompt_mat.device
    lens_d = torch.tensor(lens, device=dev)
    cur = prompt_mat[:, 0]
    toks = []
    for pos in range(total):
        logits, cache = step(params, cache, cur,
                             torch.full((b,), pos, dtype=torch.int64,
                                        device=dev))
        nxt = torch.argmax(logits, -1)
        toks.append(nxt)
        if pos + 1 < total:
            cur = torch.where(pos + 1 < lens_d, prompt_mat[:, pos + 1], nxt)
    gen = torch.stack(toks, 1).cpu().numpy()
    return [gen[i, lens[i] - 1: lens[i] - 1 + max_new]
            for i in range(b)], total


def greedy_exits(dev, cfg, params, prompt_lens=PROMPT_LENS,
                 max_new=SERVE_NEW) -> tuple:
    """Greedy decoding of SERVE_B prompts of ``prompt_lens`` tokens (numpy
    seed SEED), ``max_new`` new tokens each, against a SERVE_CACHE-row cache
    at every exit: decode_attention launches exactly exit x steps, no
    flash launch, no cache row past the exit written. Returns (the decode
    launches, {exit: ms a step})."""
    from repro_torch.kernels import ops
    from repro_torch.models import DecoderLM
    from repro_torch.train import make_serve_step

    rng = np.random.default_rng(SEED)
    lens = rng.integers(prompt_lens[0], prompt_lens[1] + 1, size=SERVE_B)
    total = int(lens.max()) + max_new
    mat = np.zeros((SERVE_B, total), np.int64)
    for i, n in enumerate(lens):
        mat[i, :n] = rng.integers(0, cfg.vocab, size=n)
    prompt_mat = torch.tensor(mat, device=dev)
    print(f"B={SERVE_B} prompts of {sorted(lens.tolist())} tokens, "
          f"max_new {max_new}, cache {SERVE_CACHE} rows, {total} steps")
    warm = DecoderLM.init_cache(cfg, SERVE_B, SERVE_CACHE, device=dev)
    greedy_decode(params, make_serve_step(cfg), warm, prompt_mat[:, :3],
                  lens.clip(max=3), 0)
    del warm
    decode_launches, rows = 0, {}
    for e in cfg.exit_layers:
        step = make_serve_step(cfg, exit_layer=e)
        cache = DecoderLM.init_cache(cfg, SERVE_B, SERVE_CACHE, device=dev)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        outs, steps = greedy_decode(params, step, cache, prompt_mat, lens,
                                    max_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        decode_launches += counts["decode_attention"]
        rows[e] = wall / steps * 1e3
        print(f"  exit {e:2d}: {wall / steps * 1e3:8.3f} ms/step, "
              f"{SERVE_B * max_new / wall:9.1f} generated tokens/s, "
              f"launches {counts}", flush=True)
        if (counts["decode_attention"] != e * steps
                or counts["flash_attention"]):
            raise SystemExit(f"{cfg.arch_id} exit {e}: launches {counts}, "
                             f"expected decode_attention {e * steps}")
        if any(len(o) != max_new or o.min() < 0 or o.max() >= cfg.vocab
               for o in outs):
            raise SystemExit(f"{cfg.arch_id} exit {e}: generated tokens "
                             f"malformed")
        if cache["layers"].k[e:].any():
            raise SystemExit(f"{cfg.arch_id} exit {e}: a layer past the exit "
                             f"wrote the cache")
        del cache
    return decode_launches, rows


def serve_phase(dev, cfg, params, gen):
    """Phase 9: greedy decoding at every exit, launches counted; then one
    serve_step per exit at B=64 against a 4096-row cache."""
    from repro_torch.models import DecoderLM
    from repro_torch.train import make_prefill_step, make_serve_step

    decode_launches, _ = greedy_exits(dev, cfg, params)

    # one serve_step against a 4096-row cache filled by a prefill
    prefill = make_prefill_step(cfg)
    cache = DecoderLM.init_cache(cfg, LONG_B, LONG_S, device=dev)
    toks = torch.randint(0, cfg.vocab, (LONG_B, LONG_S), generator=gen,
                         device=dev)
    chunk = 16
    for i in range(0, LONG_B, chunk):
        _, c = prefill(params, {"tokens": toks[i:i + chunk]})
        cache["layers"].k[:, i:i + chunk] = c["layers"].k
        cache["layers"].v[:, i:i + chunk] = c["layers"].v
        del c
    pos = torch.full((LONG_B,), LONG_S - 1, dtype=torch.int64, device=dev)
    for e in cfg.exit_layers:
        step = make_serve_step(cfg, exit_layer=e)
        step(params, cache, toks[:, -1], pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            logits, _ = step(params, cache, toks[:, -1], pos)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        if not bool(torch.isfinite(logits).all()):
            raise SystemExit(f"B={LONG_B} exit {e}: logits not finite")
        print(f"  B={LONG_B} cache {LONG_S} exit {e:2d}: {ms:8.3f} ms/step, "
              f"{LONG_B / ms * 1e3:9.1f} tokens/s")
    del cache
    torch.cuda.empty_cache()
    return decode_launches


def decode_vs_prefill(dev, cfg, params, gen, n_tokens) -> dict:
    """A CONSIST_B x ``n_tokens`` prefill against the same tokens
    teacher-forced through serve_step: relative L2 of the last logits and
    of every layer's K and V (``k[i]``, ``v[i]``), printed and returned."""
    from repro_torch.models import DecoderLM
    from repro_torch.train import make_prefill_step, make_serve_step

    toks = torch.randint(0, cfg.vocab, (CONSIST_B, n_tokens), generator=gen,
                         device=dev)
    logits_p, cache_p = make_prefill_step(cfg)(params, {"tokens": toks})
    step = make_serve_step(cfg)
    cache_d = DecoderLM.init_cache(cfg, CONSIST_B, n_tokens, device=dev)
    for t in range(n_tokens):
        logits_d, cache_d = step(params, cache_d, toks[:, t],
                                 torch.full((CONSIST_B,), t,
                                            dtype=torch.int64, device=dev))
    errs = {"logits": rel_l2(logits_d, logits_p)}
    for i in range(cfg.n_layers):
        errs[f"k[{i}]"] = rel_l2(cache_d["layers"].k[i], cache_p["layers"].k[i])
        errs[f"v[{i}]"] = rel_l2(cache_d["layers"].v[i], cache_p["layers"].v[i])
    print(f"relative L2, decode vs prefill ({cfg.dtype}, {cfg.n_layers} "
          f"layers, {CONSIST_B} x {n_tokens} tokens): " + ", ".join(
              f"{k} {v:.2e}" for k, v in errs.items()), flush=True)
    return errs


def consistency_phase(dev, cfg, params, gen):
    """Phase 10: prefill against teacher-forced decode on the same tokens."""
    errs = decode_vs_prefill(dev, cfg, params, gen, CONSIST_P)
    worst = max(errs.values())
    if not worst <= CONSIST_TOL:
        raise SystemExit(f"consistency: relative L2 {worst} above "
                         f"{CONSIST_TOL}")
    return worst


# ------------------------------------------------------------- SSM phases
def scan_err(got, want, state=False):
    """Max over elements of |got - want| / (1 + the largest |want| of the
    same (sequence, head)), for y [B,T,H,dv] or a state [B,H,dk,dv]. The
    float32 rounding of a recurrence's output scales with the sums it is
    made of, so with the largest outputs of its (sequence, head), not with
    each element's own size."""
    got, want = got.float(), want.float()
    scale = 1 + want.abs().amax(dim=(2, 3) if state else (1, 3),
                                keepdim=True)
    return float(((got - want).abs() / scale).max())
def event_ms(fn, *, reps=3) -> float:
    """Device time of one eager ``fn()`` between CUDA events, host launch
    path included (for the plain scan, a loop too long to capture)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_emulation(label, y, st, emu_y, emu_s):
    """The bf16 scan kernel against its emulation, y beyond its output
    rounding and the state; returns both readings."""
    from repro_torch.kernels import ref

    excess = ref.ssm_emu_excess(y, emu_y)
    err_y = float(excess.max())
    err_s = ref.ssm_emu_err(st, emu_s, state=True)
    # how sparse the y error is: rounding flips touch a few rows
    sparse = ", ".join(f"{int((excess > th).sum())} above {th}"
                       for th in (1e-4, 1e-3))
    print(f"  ssm_scan {label:46s} bfloat16 vs emulation: y {err_y:.3e} "
          f"beyond its rounding (limit {ref.SSM_EMU_TOL}; of "
          f"{excess.numel()} elements {sparse}), state {err_s:.3e} "
          f"(limit {ref.SSM_EMU_STATE_TOL})", flush=True)
    if err_y > ref.SSM_EMU_TOL or err_s > ref.SSM_EMU_STATE_TOL:
        raise SystemExit(f"ssm_scan {label} bf16: kernel differs from its "
                         f"emulation by y {err_y}, state {err_s}")
    return err_y, err_s


def emulation_controls(q, k, v, log_w, u, s0, c, emu_y, emu_s, want_y):
    """The scan's emulation check must reject each planted fault; whether
    the 3e-2 gate against plain would is printed beside it."""
    from repro_torch.kernels import ref

    for fault in ref.SSM_EMU_FAULTS:
        bad_y, bad_s = ref.ssm_scan_bf16_emulation(
            q, k, v, log_w, bonus_u=u, chunk=c, initial_state=s0,
            fault=fault)
        err_y = ref.ssm_emu_err(bad_y.bfloat16(), emu_y)
        err_s = ref.ssm_emu_err(bad_s, emu_s, state=True)
        gate = scan_err(bad_y, want_y) <= SSM_TOL[torch.bfloat16]
        print(f"  control: {fault}: y {err_y:.3e}, state {err_s:.3e} "
              f"(limits {ref.SSM_EMU_TOL}, {ref.SSM_EMU_STATE_TOL}); the "
              f"3e-2 gate {'accepts' if gate else 'rejects'} it",
              flush=True)
        if err_y <= ref.SSM_EMU_TOL and err_s <= ref.SSM_EMU_STATE_TOL:
            raise SystemExit(f"ssm_scan: the emulation check accepts a "
                             f"planted fault ({fault})")


def ssm_scan_phase(dev):
    """Phase 11: ssm_scan against its plain version, y and final state;
    at the prefill shape in f32 with slow decays, that the tolerance
    rejects three wrong answers; in bf16 kernel and plain times and the
    bound. Returns the kernel's summary fields."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ssm_mod

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def normal(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + shift

    def check(label, dtype, got, want, tol, state=False):
        err = scan_err(got, want, state)
        if not err <= tol:
            raise SystemExit(f"ssm_scan {label} {dtype}: kernel differs from "
                             f"plain by {err} of 1 + its (sequence, head)'s "
                             f"largest |value|, above {tol}")
        return err

    _, _, _, dk, dv, c = SSM_PREFILL
    info = {dt: ssm_mod.kernel_info(dk, dv, c, dt)
            for dt in (torch.bfloat16, torch.float32)}
    for dt, kinfo in info.items():
        print(f"  ssm_scan dk={dk} dv={dv} chunk {c} {str(dt)[6:]:8s} shared "
              f"memory {kinfo['smem_bytes']} bytes a block, "
              f"{kinfo['blocks_per_sm']} blocks per SM")
    if info[torch.bfloat16]["blocks_per_sm"] < 2:
        raise SystemExit("ssm_scan: the bf16 kernel no longer fits two "
                         "blocks per SM at the prefill shape")

    cases = [(shape, dt, rwkv, slow) for dt in (torch.float32, torch.bfloat16)
             for shape in SSM_GRID for rwkv in (False, True)
             for slow in (False, True)]
    cases += [(SSM_PREFILL, dt, True, slow)
              for dt in (torch.bfloat16, torch.float32) for slow in (False, True)]
    out, errs, emu_errs = None, [], []
    for (b, t, h, dk, dv, c), dt, rwkv, slow in cases:
        main_shape = (b, t, h, dk, dv, c) == SSM_PREFILL
        q = normal(b, t, h, dk).to(dt)
        k = normal(b, t, h, dk).to(dt)
        v = normal(b, t, h, dv).to(dt)
        log_w = -torch.exp(normal(b, t, h, dk, scale=0.5,
                                  shift=-5.0 if slow else 0.0))
        u = normal(h, dk, scale=0.2) if rwkv else None
        s0 = normal(b, h, dk, dv) if slow else None
        y, st = ssm_mod.ssm_scan(q, k, v, log_w, u, chunk=c, initial_state=s0)
        torch.cuda.synchronize()
        want_y, want_s = ref.ssm_scan_ref(q, k, v, log_w, bonus_u=u,
                                          initial_state=s0)
        label = (f"[{b}, {t}, {h}, {dk}, {dv}] chunk {c} "
                 f"{'rwkv' if rwkv else 'mamba'} {'slow' if slow else 'fast'}")
        err_y = check(label + " y", dt, y, want_y, SSM_TOL[dt])
        err_s = check(label + " state", dt, st, want_s, SSM_TOL[torch.float32],
                      state=True)
        print(f"  ssm_scan {label:46s} {str(dt)[6:]:8s} err y {err_y:.3e} "
              f"state {err_s:.3e} (max |y| "
              f"{float(want_y.float().abs().max()):.1f}, max abs error "
              f"{float((y.float() - want_y.float()).abs().max()):.3e})",
              flush=True)
        if main_shape:
            errs.append(float((y.float() - want_y.float()).abs().max()))
        if dt == torch.bfloat16:
            emu_y, emu_s = ref.ssm_scan_bf16_emulation(
                q, k, v, log_w, bonus_u=u, chunk=c, initial_state=s0)
            emu_errs.append(check_emulation(label, y, st, emu_y, emu_s))
            if main_shape and slow:
                emulation_controls(q, k, v, log_w, u, s0, c, emu_y, emu_s,
                                   want_y)
            del emu_y, emu_s
        if main_shape and dt == torch.float32 and slow:
            # the tolerance must still reject a kernel that drops the
            # initial state, applies each decay one token late or drops
            # RWKV's bonus
            late = torch.cat([log_w[:, :1], log_w[:, :-1]], dim=1)
            for what, w_c, u_c, s0_c in (
                    ("initial state dropped", log_w, u, None),
                    ("decays one token late", late, u, s0),
                    ("bonus dropped", log_w, torch.zeros_like(u), s0)):
                wrong, _ = ref.ssm_scan_ref(q, k, v, w_c, bonus_u=u_c,
                                            initial_state=s0_c)
                e = scan_err(wrong, want_y)
                print(f"  control: plain with the {what}: err y {e:.3e} "
                      f"(tolerance {SSM_TOL[dt]})")
                if not e > SSM_TOL[dt]:
                    raise SystemExit(f"ssm_scan: the tolerance accepts the "
                                     f"plain version with the {what}")
                del wrong
        if main_shape and dt == torch.bfloat16 and not slow:
            ms = graph_ms(lambda: ssm_mod.ssm_scan(q, k, v, log_w, u, chunk=c),
                          inner=5, reps=4)
            plain_ms = event_ms(lambda: ref.ssm_scan_ref(q, k, v, log_w,
                                                         bonus_u=u))
            cost = ssm_cost(q, v, log_w, u, None)
            b_ms, b_by = bound(*cost, peak_for(dt))
            print(f"  ssm_scan {label:46s} kernel {ms * 1e3:9.2f} us "
                  f"(first design {SSM_FIRST_DESIGN_US} us)  plain "
                  f"{plain_ms * 1e3:9.2f} us (eager)  library n/a  bound "
                  f"{b_ms * 1e3:8.2f} us ({b_by}, {cost[0] / 1e6:.1f} MB, "
                  f"{cost[1] / 1e9:.2f} GFLOP); "
                  f"{info[dt]['smem_bytes']} bytes of shared memory a "
                  f"block, {info[dt]['blocks_per_sm']} blocks per SM",
                  flush=True)
            out = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                       bound_ms=b_ms, bound_by=b_by)
        del q, k, v, log_w, y, st, want_y, want_s
    print(f"  ssm_scan bf16 vs its emulation, largest readings: y "
          f"{max(e[0] for e in emu_errs):.3e} beyond its rounding (limit "
          f"{ref.SSM_EMU_TOL}), state {max(e[1] for e in emu_errs):.3e} "
          f"(limit {ref.SSM_EMU_STATE_TOL})")
    out["max_abs_err"] = max(errs)
    return out


def rwkv_golden_phase(dev):
    """Phase 12: the reduced-RWKV JAX run through the port on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.core.bridge import lm_params_from_numpy, lm_params_numpy
    from repro_torch.models import DecoderLM
    from repro_torch.train import make_prefill_step, make_serve_step

    with np.load(RWKV_GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    cfg = get_arch(str(gold["arch"])).reduced(
        **{k.split("/")[1]: int(gold[k]) for k in gold
           if k.startswith("reduced/")})
    params = lm_params_from_numpy(lm_params_numpy(cfg, int(gold["seed"])),
                                  cfg, dev)
    toks = torch.tensor(gold["tokens"], device=dev)
    b, n = toks.shape[0], int(gold["serve_len"])

    def err(got, key):
        want = torch.tensor(gold[key], device=dev)
        return float(((got.float() - want).abs() / (1 + want.abs())).max())

    logits, cache = make_prefill_step(cfg)(params, {"tokens": toks})
    errs = {"prefill/logits": err(logits, "prefill/logits")}
    errs.update({f"prefill/{f}": err(getattr(cache["layers"], f),
                                     f"prefill/{f}") for f in STATE_FIELDS})
    for e in (int(x) for x in gold["exits"]):
        step = make_serve_step(cfg, exit_layer=e)
        c = DecoderLM.init_cache(cfg, b, n, device=dev)
        got = []
        for i in range(n):
            lg, c = step(params, c, toks[:, i],
                         torch.full((b,), i, dtype=torch.int64, device=dev))
            got.append(lg)
        errs[f"serve/logits_{e}"] = err(torch.stack(got), f"serve/logits_{e}")
    for k, v in errs.items():
        print(f"  {k:18s} max |d| / (1 + |ref|) {v:.3e}")
    worst = max(errs.values())
    if not worst <= LM_GOLDEN_TOL:
        raise SystemExit(f"RWKV golden: error {worst} above {LM_GOLDEN_TOL}")
    return worst


def rwkv_prefill_phase(dev, cfg, params, gen):
    """Phase 13: one full-width RWKV-6 prefill, its launches counted."""
    from repro_torch.kernels import ops
    from repro_torch.train import make_prefill_step

    prefill = make_prefill_step(cfg)
    toks = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), generator=gen,
                         device=dev)
    prefill(params, {"tokens": toks[:, :256]})      # warm-up: cuBLAS, attrs
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"B={PREFILL_B} S={PREFILL_S}: {wall * 1e3:.3f} ms, "
          f"{PREFILL_B * PREFILL_S / wall:.1f} prompt tokens/s; launches "
          f"{counts}")
    if counts["ssm_scan"] != cfg.n_layers or any(
            n for k, n in counts.items() if k != "ssm_scan"):
        raise SystemExit(f"prefill launches {counts}: expected ssm_scan "
                         f"{cfg.n_layers} and nothing else")
    h = cfg.d_model // cfg.ssm_head_dim
    st = cache["layers"]
    if (tuple(logits.shape) != (PREFILL_B, cfg.vocab)
            or not bool(torch.isfinite(logits).all())
            or tuple(st.wkv.shape) != (cfg.n_layers, PREFILL_B, h,
                                       cfg.ssm_head_dim, cfg.ssm_head_dim)
            or tuple(st.shift_tm.shape) != (cfg.n_layers, PREFILL_B,
                                            cfg.d_model)
            or not all(bool(torch.isfinite(x).all()) for x in st)):
        raise SystemExit("RWKV prefill output malformed")
    return counts["ssm_scan"]


def rwkv_serve_phase(dev, cfg, params, gen):
    """Phase 14: greedy decoding at every exit, launches counted; then one
    serve_step per exit at B=64 from a prefilled state."""
    from repro_torch.kernels import ops
    from repro_torch.models import DecoderLM
    from repro_torch.train import make_prefill_step, make_serve_step

    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, size=SERVE_B)
    total = int(lens.max()) + SERVE_NEW
    mat = np.zeros((SERVE_B, total), np.int64)
    for i, n in enumerate(lens):
        mat[i, :n] = rng.integers(0, cfg.vocab, size=n)
    prompt_mat = torch.tensor(mat, device=dev)
    print(f"B={SERVE_B} prompts of {sorted(lens.tolist())} tokens, "
          f"max_new {SERVE_NEW}, {total} steps")
    warm = DecoderLM.init_cache(cfg, SERVE_B, total, device=dev)
    greedy_decode(params, make_serve_step(cfg), warm, prompt_mat[:, :3],
                  lens.clip(max=3), 0)
    del warm
    launches = 0
    for e in cfg.exit_layers:
        step = make_serve_step(cfg, exit_layer=e)
        cache = DecoderLM.init_cache(cfg, SERVE_B, total, device=dev)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        outs, steps = greedy_decode(params, step, cache, prompt_mat, lens,
                                    SERVE_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        launches += counts["ssm_scan"]
        print(f"  exit {e:2d}: {wall / steps * 1e3:8.3f} ms/step, "
              f"{SERVE_B * SERVE_NEW / wall:9.1f} generated tokens/s, "
              f"launches {counts}", flush=True)
        if any(counts.values()):
            raise SystemExit(f"exit {e}: launches {counts}, expected none "
                             f"(decode runs the plain recurrence step)")
        if any(len(o) != SERVE_NEW or o.min() < 0 or o.max() >= cfg.vocab
               for o in outs):
            raise SystemExit(f"exit {e}: generated tokens malformed")
        if any(bool(x[e:].any()) for x in cache["layers"]):
            raise SystemExit(f"exit {e}: a layer past the exit wrote its state")
        if not all(bool(x[:e].any()) for x in cache["layers"]):
            raise SystemExit(f"exit {e}: a layer up to the exit kept a zero "
                             f"state")
        del cache

    # one serve_step per exit from the state of a 256-token prefill
    toks = torch.randint(0, cfg.vocab, (SSM_LONG_B, SSM_LONG_P),
                         generator=gen, device=dev)
    _, filled = make_prefill_step(cfg)(params, {"tokens": toks})
    pos = torch.full((SSM_LONG_B,), SSM_LONG_P, dtype=torch.int64, device=dev)
    nxt = toks[:, -1]
    for e in cfg.exit_layers:
        step = make_serve_step(cfg, exit_layer=e)
        cache = {"layers": type(filled["layers"])(
            *(x.clone() for x in filled["layers"]))}
        step(params, cache, nxt, pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            logits, _ = step(params, cache, nxt, pos)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        if not bool(torch.isfinite(logits).all()):
            raise SystemExit(f"B={SSM_LONG_B} exit {e}: logits not finite")
        print(f"  B={SSM_LONG_B} after a {SSM_LONG_P}-token prefill, exit "
              f"{e:2d}: {ms:8.3f} ms/step, {SSM_LONG_B / ms * 1e3:9.1f} "
              f"tokens/s")
        del cache
    del filled
    torch.cuda.empty_cache()
    return launches


def rwkv_drift(dev, cfg, params, toks):
    """Relative L2 between a prefill of ``toks`` and the same tokens
    teacher-forced through serve_step: last logits and every layer's
    wkv, shift_tm and shift_cm."""
    from repro_torch.models import DecoderLM
    from repro_torch.train import make_prefill_step, make_serve_step

    b, n = toks.shape
    logits_p, cache_p = make_prefill_step(cfg)(params, {"tokens": toks})
    step = make_serve_step(cfg)
    cache_d = DecoderLM.init_cache(cfg, b, n, device=dev)
    for t in range(n):
        logits_d, cache_d = step(params, cache_d, toks[:, t],
                                 torch.full((b,), t, dtype=torch.int64,
                                            device=dev))
    errs = {"logits": rel_l2(logits_d, logits_p)}
    for f in STATE_FIELDS:
        for i in range(cfg.n_layers):
            errs[f"{f}[{i}]"] = rel_l2(getattr(cache_d["layers"], f)[i],
                                       getattr(cache_p["layers"], f)[i])
    return errs


def rwkv_consistency_phase(dev, cfg, params, gen):
    """Phase 15: prefill against teacher-forced decode on the same tokens,
    in bf16 (layer 0 gated), then on the same weights cast to float32
    (every layer gated), then in float32 with slow decays."""
    toks = torch.randint(0, cfg.vocab, (CONSIST_B, CONSIST_P), generator=gen,
                         device=dev)
    errs = rwkv_drift(dev, cfg, params, toks)
    print("bf16, relative L2, decode vs prefill: " + ", ".join(
        f"{k} {v:.2e}" for k, v in errs.items()))
    first = max(errs[f"{f}[0]"] for f in STATE_FIELDS)
    if not first <= CONSIST_TOL:
        raise SystemExit(f"RWKV consistency (bf16): layer 0's state differs "
                         f"by relative L2 {first}, above {CONSIST_TOL}")
    for leaves in _dicts(params):          # in place: the bf16 copy goes
        for k, x in leaves.items():
            if not isinstance(x, dict):
                leaves[k] = x.float()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    worst = 0.0
    for decays in ("init", "slow"):
        if decays == "slow":
            # w0 uniform in [-6, 0], as lm_params_numpy draws it: the
            # init's zero w0 decays the state by ~e^-1 a step, these by
            # down to ~0.9975, so the state that prefill carries from its
            # first chunk into its second matters
            w0 = params["blocks"]["core"]["w0"]
            w0.copy_(-6.0 * torch.rand(w0.shape, generator=gen, device=dev))
        errs = rwkv_drift(dev, cfg32, params, toks)
        print(f"f32, {decays} decays, relative L2, decode vs prefill: "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        worst = max(worst, *errs.values())
        if not worst <= CONSIST_F32_TOL:
            raise SystemExit(f"RWKV consistency (f32, {decays} decays): "
                             f"relative L2 {worst} above {CONSIST_F32_TOL}")
    return worst


def _dicts(tree):
    """Every dict of a nested param tree, the tree itself included."""
    yield tree
    for v in tree.values():
        if isinstance(v, dict):
            yield from _dicts(v)

# ------------------------------------------------------------ actor kernels
def actor_cases(env, params, gen, b, *, workload=None, state=None):
    """The five actor launches of one slot at B = b fleets, on inputs of
    the main path (a fresh slot's graph; layer 2 on layer 1's plain
    output): (kernel, launch, args, wrapper, plain version, (bytes, flops)).
    A serving engine's path passes its ``workload`` (the slot's tasks come
    from its arrival process) and its live MECState, which every graph
    shares."""
    from repro_torch.core import gcn
    from repro_torch.core.graph import build_graph
    from repro_torch.kernels import edge_score as edge_mod
    from repro_torch.kernels import gcn_agg as gcn_mod
    from repro_torch.kernels import ref
    if workload is None:
        tasks = env.sample_slot(gen, (b,))
    else:
        _, tasks = workload.sample(workload.init(gen, batch=(b,)), gen)
    state = (env.reset((b,)) if state is None else
             type(state)(*(x.expand((b,) + x.shape) for x in state)))
    g = build_graph(env.observe(state, tasks), env.N, env.L)
    adj, adj_t = g.adj, g.adj.transpose(-1, -2)
    split = gcn._split
    fs, fo = g.device_feat.shape[-1], g.option_feat.shape[-1]
    l1d = (adj, g.device_feat, g.option_feat, *split(params["dev1"], fs))
    l1o = (adj_t, g.option_feat, g.device_feat, *split(params["opt1"], fo))
    h_dev, h_opt = ref.gcn_agg_ref(*l1d), ref.gcn_agg_ref(*l1o)
    l2d = (adj, h_dev, h_opt, *split(params["dev2"], h_dev.shape[-1]))
    l2o = (adj_t, h_opt, h_dev, *split(params["opt2"], h_opt.shape[-1]))
    h_dev2, h_opt2 = ref.gcn_agg_ref(*l2d), ref.gcn_agg_ref(*l2o)
    e_args = (h_dev2, h_opt2, adj, params["edge_src"]["w"],
              params["edge_src"]["b"], params["edge_dst"]["w"],
              params["edge_feat"]["w"][0], params["edge_out"]["w"][:, 0],
              params["edge_out"]["b"])
    cases = [("gcn_agg", name, args, gcn_mod.gcn_agg, ref.gcn_agg_ref,
              gcn_agg_cost(*args))
             for name, args in (("layer1/device", l1d),
                                ("layer1/option", l1o),
                                ("layer2/device", l2d),
                                ("layer2/option", l2o))]
    cases.append(("edge_score", "edge", e_args, edge_mod.edge_score,
                  ref.edge_score_ref, edge_score_cost(*e_args)))
    return cases


def actor_info(kernel, args, dev) -> str:
    """The launch's tile (G graphs a block, C columns, K split, weight
    stages), blocks per SM and shared memory per block, from the kernel's
    own layout."""
    from repro_torch.kernels import edge_score as edge_mod
    from repro_torch.kernels import gcn_agg as gcn_mod
    if kernel == "gcn_agg":
        adj, hs, hn, ws = args[:4]
        b, m, o = adj.shape
        i = gcn_mod.kernel_info(b, m, o, hs.shape[-1], hn.shape[-1],
                                ws.shape[-1], dev)
        tile = (f"G={i['graphs']} C={i['cols']:3d} ks={i['k_split']} "
                f"stages={i['stages']}")
    else:
        hs, hd, ef, ws = args[:4]
        b, m, o = ef.shape
        i = edge_mod.kernel_info(b, m, o, *ws.shape, dev)
        tile = f"G={i['graphs']} C={ws.shape[1]:3d} ks=1 stages=1"
    return (f"{tile} blocks/SM {i['blocks_per_sm']} smem "
            f"{i['smem_bytes']:6d} B")


def launch_floor_ms(dev) -> float:
    """Device time of the smallest launch: a one-element in-place add, by
    CUDA-graph replay as the kernels are timed."""
    x = torch.zeros(1, device=dev)
    return graph_ms(lambda: x.add_(1.0))


# --------------------------------------------------------------- training
def tree_of(data: dict, prefix: str) -> dict:
    """The nested ``{layer: ... {leaf: array}}`` tree a golden file stores
    under ``prefix/``."""
    tree = {}
    for k in data:
        if k.startswith(prefix + "/"):
            *heads, leaf = k[len(prefix) + 1:].split("/")
            node = tree
            for h in heads:
                node = node.setdefault(h, {})
            node[leaf] = data[k]
    return tree


def close_excess(got, want, rtol, atol) -> float:
    """max(|got - want| - (atol + rtol |want|)): <= 0 when within."""
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def grad_err(dev, kernel, name, args, plain, gen, label) -> float:
    """Every input's gradient of one actor launch against autograd of its
    plain version: the kernel's forward with the hand-written backward
    against PyTorch's own differentiation of ref.*_ref, for one random
    cotangent. Fatal beyond GRAD_RTOL/GRAD_ATOL; returns the largest
    error."""
    from repro_torch.kernels import ops
    op = getattr(ops, kernel)
    xs = [a.detach().clone().requires_grad_() for a in args]
    ys = [a.detach().clone().requires_grad_() for a in args]
    if kernel == "gcn_agg" and not args[0].is_contiguous():
        # the option side's transposed adjacency view, as in the path
        xs[0] = args[0].detach().transpose(-1, -2).clone() \
            .requires_grad_().transpose(-1, -2)
    before = ops.launch_counts()[kernel]
    out = op(*xs)
    cot = torch.randn(out.shape, generator=gen, device=dev)
    got = torch.autograd.grad((out * cot).sum(), xs)
    want = torch.autograd.grad((plain(*ys) * cot).sum(), ys)
    torch.cuda.synchronize()
    if ops.launch_counts()[kernel] != before + 1:
        raise SystemExit(f"grad {kernel} {name}: the kernel did not run")
    errs = [(float((g - w).abs().max()),
             close_excess(g, w, GRAD_RTOL, GRAD_ATOL))
            for g, w in zip(got, want)]
    print(f"  {kernel:10s} {name:14s} {label} max abs grad error per input "
          f"{[f'{e:.2e}' for e, _ in errs]}", flush=True)
    for i, (e, excess) in enumerate(errs):
        if not excess <= 0:
            raise SystemExit(f"grad {kernel} {name} {label} input {i}: max "
                             f"abs error {e}, beyond rtol {GRAD_RTOL} atol "
                             f"{GRAD_ATOL}")
    return max(e for e, _ in errs)


def grad_phase(dev, env, params, gen):
    """(a) Every input's gradient of each actor kernel, at the training
    minibatch (64 graphs of a fresh slot, full width), against autograd of
    its plain version (grad_err). Returns the largest error."""
    return max(grad_err(dev, kernel, name, args, plain, gen, f"B={N_FLEETS}")
               for kernel, name, args, _, plain, _ in actor_cases(
                   env, params, gen, N_FLEETS))


def golden_phase(dev, mode):
    """tests/data/torch_port_golden.npz (a JAX run with its draws) through
    the port's driver in ``mode``: every decision matches, or differs only
    at a recorded near-tie; q_est within 1e-5 relative."""
    from repro_torch.core import agent_def, agent_state_from_params
    from repro_torch.mec import MECEnv, SlotTasks, make_scenario
    from repro_torch.rollout import RolloutDriver, SlotDraws
    with np.load(GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    tree = tree_of(gold, "params")
    g_env = MECEnv(make_scenario(str(gold["scenario"])), device=dev)
    g_def = agent_def("grle", g_env, device=dev)
    st = agent_state_from_params(g_def, tree, gold["exit_mask"])
    t_gold, b_gold = gold["rand_cands"].shape[:2]
    draws = SlotDraws(
        SlotTasks(*(torch.tensor(gold[f"tasks/{f}"], device=dev)
                    for f in TASK_FIELDS)),
        torch.tensor(gold["rand_cands"].astype(np.int64), device=dev))
    _, trace = RolloutDriver(g_def, b_gold, train=False, device=dev).run(
        SEED, t_gold, mode=mode, agent_state=st, draws=draws)
    dec = trace.decisions.cpu().numpy()
    same = (dec == gold["trace/decisions"]).all(-1)
    dq = np.abs(trace.q_est.cpu().numpy() - gold["trace/q_est"])
    print(f"mode={mode}: decisions matching: {int(same.sum())}/{same.size} "
          f"slot-fleets; max |dq| {float(dq.max()):.3e}; "
          f"max |dreward| {float(np.abs(trace.reward.cpu().numpy() - gold['trace/reward']).max()):.3e}")
    for t, b in np.argwhere(~same):
        margin = min(gold["q_margin"][t, b], gold["xhat_margin"][t, b])
        print(f"  slot {t} fleet {b}: q margin {gold['q_margin'][t, b]:.3e}, "
              f"x_hat margin {gold['xhat_margin'][t, b]:.3e}")
        if margin > NEAR_TIE:
            raise SystemExit(f"golden ({mode}): decision differs at slot {t} "
                             f"fleet {b}, not at a near-tie")
    if not (dq[same] <= 1e-5 * np.abs(gold["trace/q_est"][same])).all():
        raise SystemExit(f"golden ({mode}): q_est differs by more than 1e-5 "
                         f"relative")


def train_golden_phase(dev, mode="loop"):
    """(b) tests/data/torch_port_train_golden.npz (a JAX train=True run
    with its draws and minibatch rows) through the port's driver in
    ``mode``. Returns the run's (carry, trace)."""
    from repro_torch.core import agent_def, agent_state_from_params
    from repro_torch.mec import MECEnv, SlotTasks, make_scenario
    from repro_torch.rollout import RolloutDriver, SlotDraws
    with np.load(TRAIN_GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    env = MECEnv(make_scenario(str(gold["scenario"])), device=dev)
    t_gold, b_gold = gold["rand_cands"].shape[:2]
    drv = RolloutDriver(agent_def("grle", env, device=dev), b_gold,
                        train=True, device=dev)
    st = agent_state_from_params(drv.adef, tree_of(gold, "init_params"),
                                 gold["exit_mask"])
    draws = SlotDraws(
        SlotTasks(*(torch.tensor(gold[f"tasks/{f}"], device=dev)
                    for f in TASK_FIELDS)),
        torch.tensor(gold["rand_cands"].astype(np.int64), device=dev),
        torch.tensor(gold["replay_take"], device=dev))
    carry, trace = drv.run(SEED, t_gold, mode=mode, agent_state=st,
                           draws=draws)
    check_train_replay(gold, carry, trace, mode, "train golden")
    return carry, trace


def check_train_replay(gold, carry, trace, mode, label, forced=False):
    """Phase 17's gate on a replayed ``train=True`` golden run: decisions
    equal, or a flip only at a recorded near-tie (<= NEAR_TIE), after
    which the comparison stops (fatal before the first train step, unless
    ``forced``: a teacher-forced replay of the run, ``forced_replay``,
    already held every train step); each loss before it within
    TRAIN_LOSS_RTOL; without a flip, the final params and Adam moments
    within TRAIN_PARAM_TOL (nu: TRAIN_NU_TOL). Returns the slots
    compared."""
    from repro_torch.nn.pytree import flatten_dict
    t_gold = gold["rand_cands"].shape[0]
    dec = trace.decisions.cpu().numpy()
    same = (dec == gold["trace/decisions"]).all(-1)
    first_train = int(gold["train_slots"][0]) - 1       # slot index
    flipped = np.flatnonzero(~same.all(-1))
    stop = int(flipped[0]) if flipped.size else t_gold
    for t, b in np.argwhere(~same[:stop + 1]):
        margin = min(gold["q_margin"][t, b], gold["xhat_margin"][t, b])
        print(f"  slot {t} fleet {b}: q margin {gold['q_margin'][t, b]:.3e},"
              f" x_hat margin {gold['xhat_margin'][t, b]:.3e}")
        if margin > NEAR_TIE:
            raise SystemExit(f"{label}: decision differs at slot {t} "
                             f"fleet {b}, not at a near-tie")
    if stop <= first_train and not forced:
        raise SystemExit(f"{label}: a decision flipped at slot {stop}, "
                         f"before the first train step (slot index "
                         f"{first_train})")
    print(f"mode={mode}: decisions matching: {int(same[:stop].sum())}/"
          f"{same[:stop].size} slot-fleets before slot {stop}" + (
              "" if stop == t_gold else
              f"; a near-tie flip at slot {stop}: the comparison stops"))
    loss, want = trace.loss.cpu().numpy()[:stop], gold["trace/loss"][:stop]
    if not (np.isnan(loss) == np.isnan(want)).all():
        raise SystemExit(f"{label}: train steps at other slots")
    ok = ~np.isnan(want)
    rel = np.abs(loss[ok] / want[ok] - 1)
    print(f"train steps compared: {int(ok.sum())}, losses "
          f"{np.round(loss[ok], 6).tolist()}, max relative error "
          f"{float(rel.max(initial=0.0)):.3e}")
    if not (rel <= TRAIN_LOSS_RTOL).all():
        raise SystemExit(f"{label}: loss beyond {TRAIN_LOSS_RTOL}")
    if stop < t_gold:
        print("final params and moments not compared (the run left the "
              "golden one at the flip)")
        return stop
    check_final_state(gold, carry.agent_state, label)
    return stop


def check_final_state(gold, fin, label):
    """A replay's final params and Adam moments against the golden run's,
    within TRAIN_PARAM_TOL (nu: TRAIN_NU_TOL), and its Adam step."""
    from repro_torch.nn.pytree import flatten_dict
    for name, got, tol in (("params", fin.params, TRAIN_PARAM_TOL),
                           ("mu", fin.opt_state["mu"], TRAIN_PARAM_TOL),
                           ("nu", fin.opt_state["nu"], TRAIN_NU_TOL)):
        want_t = flatten_dict(tree_of(gold, f"final/{name}"))
        got_t = flatten_dict(got)
        if set(got_t) != set(want_t):
            raise SystemExit(f"{label}: final {name} leaves differ")
        pairs = [(got_t[k].cpu(), torch.tensor(w))
                 for k, w in want_t.items()]
        err = max(float((g - w).abs().max()) for g, w in pairs)
        rel = max(float(((g - w).abs() / w.abs().clamp_min(1e-30)).max())
                  for g, w in pairs)
        excess = max(close_excess(g, w, *tol) for g, w in pairs)
        print(f"final {name}: max abs error {err:.3e}, max relative "
              f"{rel:.3e} (tolerance rtol {tol[0]} atol {tol[1]})")
        if not excess <= 0:
            raise SystemExit(f"{label}: final {name} beyond rtol "
                             f"{tol[0]} atol {tol[1]}")
    if int(fin.opt_state["step"]) != int(gold["final/opt_step"]):
        raise SystemExit(f"{label}: Adam step count differs")


# the records prof.events() leaves out (torch.autograd.profiler_util.
# _filter_name); none of them is a kernel
_UNPARSED = frozenset({
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new",
    "profiler::_record_function_exit", "aten::is_leaf", "aten::output_nr",
    "aten::_version"})


class Record(NamedTuple):
    name: str
    on_device: bool     # a CUDA kernel, copy or span, not a host call
    start_ns: int
    us: float
    corr: int           # a kernel's and its launch's correlation id


def profiler_records(prof) -> list:
    """A closed torch.profiler window's records, read from the profiler's
    raw results with the names, device types, times and ids that
    ``prof.events()`` gives them: ``prof.events()`` builds an event tree at
    ~70 µs a record, most of the time a window of ~10^5 kernels takes. The
    tree also drops a host op nested in one of the same name; the readers
    here count device records and cudaGraphLaunch calls, which it keeps."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if (e.name() in _UNPARSED
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        out.append(Record(e.name(), e.device_type() == cuda, e.start_ns(),
                          (e.end_ns() - e.start_ns()) / 1e3,
                          e.correlation_id()))
    return out


def cuda_launches(fn) -> int:
    """CUDA kernels (and copies) one ``fn()`` runs, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILER_TAIL_S)
    return sum(1 for r in profiler_records(prof) if r.on_device)


def train_step_parts(adef, state, gen, reps=20):
    """(c) One train step split as AgentDef.train_step runs it: forward
    (minibatch draw and the Eq-16 loss through the kernels), backward
    (autograd through the hand-written rules) and Adam; ms of each by
    CUDA events (mean of ``reps``) and CUDA launches of each."""
    from repro_torch.core.devreplay import replay_sample
    from repro_torch.nn.pytree import flatten_dict, unflatten_dict
    from repro_torch.optim import apply_updates
    box = {}

    def fwd():
        graphs, dec = replay_sample(state.replay, adef.batch_size,
                                    generator=gen)
        flat = flatten_dict(state.params)
        box["paths"] = list(flat)
        box["leaves"] = [p.detach().requires_grad_() for p in flat.values()]
        box["loss"] = adef.loss(unflatten_dict(dict(zip(flat,
                                                        box["leaves"]))),
                                graphs, dec, state.exit_mask)

    def bwd():
        box["grads"] = torch.autograd.grad(box["loss"], box["leaves"])

    def opt():
        grads = unflatten_dict(dict(zip(box["paths"], box["grads"])))
        updates, _ = adef.opt.update(grads, state.opt_state)
        apply_updates(state.params, updates)

    parts = (("forward", fwd), ("backward", bwd), ("adam", opt))
    for _ in range(3):
        for _, fn in parts:
            fn()
    torch.cuda.synchronize()
    ms = {k: 0.0 for k, _ in parts}
    for _ in range(reps):
        for name, fn in parts:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            ms[name] += start.elapsed_time(end) / reps
    launches = {name: cuda_launches(fn) for name, fn in parts}
    whole = event_ms(lambda: adef.train_step(state, generator=gen),
                     reps=reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        adef.train_step(state, generator=gen)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    return ms, launches, whole, wall, cuda_launches(
        lambda: adef.train_step(state, generator=gen))


def episode_s(drv, seed=SEED, mode="loop", n_slots=N_SLOTS):
    """Wall seconds of one ``n_slots`` episode in ``mode``, ending in a
    synchronize, and its (carry, trace)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = drv.run(seed, n_slots, mode=mode)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def train_path_phase(dev, adef):
    """(c) The training path at full width on the port's own generator:
    B=64 fleets, T=200 slots, replay 128, minibatch 64, a train step every
    10 slots: 20 steps; slot ms beside the decision path's, episodes in
    the order decision, training, training, decision (host time drifts
    within a call). Returns the launch counts of the first training
    episode."""
    from repro_torch.kernels import ops
    from repro_torch.rollout import RolloutDriver
    drv = RolloutDriver(adef, N_FLEETS, train=True, device=dev)
    plain = RolloutDriver(adef, N_FLEETS, train=False, device=dev)
    drv.run(SEED + 1, 20, mode="loop")      # warm-up: a train step too
    walls = {"decision": [episode_s(plain)[0]]}
    ops.reset_launch_counts()
    wall, (carry, trace) = episode_s(drv)
    counts = ops.launch_counts()
    walls["training"] = [wall, episode_s(drv)[0]]
    walls["decision"].append(episode_s(plain)[0])
    loss = trace.loss.cpu().numpy()
    m = drv.metrics(carry)
    trained = np.flatnonzero(~np.isnan(loss)) + 1
    n_train = N_SLOTS // adef.train_every
    print(f"B={N_FLEETS} T={N_SLOTS} replay {drv.replay_capacity} "
          f"minibatch {drv.batch_size} every {drv.train_every} slots")
    print(f"train steps {len(trained)} at slots {trained.tolist()}")
    print(f"losses {np.round(loss[trained - 1], 6).tolist()}")
    print(f"ssp {m['ssp']:.6f}  avg_accuracy {m['avg_accuracy']:.6f}  "
          f"final_loss {m['final_loss']:.6f}  train_steps "
          f"{int(m['train_steps'])}")
    slot_ms = {k: [w / N_SLOTS * 1e3 for w in v] for k, v in walls.items()}
    mean = {k: sum(v) / len(v) for k, v in slot_ms.items()}
    print(f"slot ms, episodes in the order decision, training, training, "
          f"decision: {slot_ms['decision'][0]:.3f}, "
          f"{slot_ms['training'][0]:.3f}, {slot_ms['training'][1]:.3f}, "
          f"{slot_ms['decision'][1]:.3f}; with training {mean['training']:.3f}"
          f" ms, without {mean['decision']:.3f} ms: "
          f"{mean['training'] - mean['decision']:+.3f} ms a slot")
    print(f"launches {counts}")
    want = {"gcn_agg": 4 * (N_SLOTS + n_train),
            "edge_score": N_SLOTS + n_train, "flash_attention": 0,
            "decode_attention": 0, "ssm_scan": 0}
    if (trained.tolist() != list(range(adef.train_every, N_SLOTS + 1,
                                       adef.train_every))
            or not np.isfinite(loss[trained - 1]).all()
            or int(m["train_steps"]) != n_train
            or not np.isfinite(m["final_loss"])):
        raise SystemExit(f"training path: expected {n_train} finite train "
                         f"steps, got {len(trained)}")
    if counts != want:
        raise SystemExit(f"training path: launch counts {counts}, "
                         f"expected {want}")
    ms, launches, whole, wall_ms, whole_launches = train_step_parts(
        drv.adef, carry.agent_state, torch.Generator(device=dev)
        .manual_seed(SEED))
    for name in ms:
        print(f"train step {name:8s}: {ms[name]:.3f} ms (CUDA events), "
              f"{launches[name]} CUDA launches")
    print(f"train step whole: {whole:.3f} ms (CUDA events), {wall_ms:.3f} ms "
          f"host wall, {whole_launches} CUDA launches; per slot over "
          f"{adef.train_every} slots: {whole / adef.train_every:.3f} ms")
    return counts


# ------------------------------------------------- the compiled episode
# the driver's phase spans (obs.profile.phase), which the profiler also
# records on the device: not kernels
SPANS = PHASE_SPANS


def profiled_episode(drv, mode, n_slots=N_SLOTS, seed=SEED, **run_kw):
    """One episode under torch.profiler, whose window stays open
    ``PROFILER_TAIL_S`` after it: (carry, trace), the device records of
    the two actor kernels, the same per cudaGraphLaunch in launch order
    ([gcn_agg, edge_score] a launch, by the launch's correlation id), CUDA
    kernels (and copies) in all, cudaGraphLaunch calls, and the busy share
    (device time over the wall time of the episode, which ends in a
    synchronize)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = drv.run(seed, n_slots, mode=mode, **run_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PROFILER_TAIL_S)
    records = profiler_records(prof)
    launches = sorted((r.start_ns, r.corr) for r in records
                      if r.name == "cudaGraphLaunch")
    slot_of = {corr: i for i, (_, corr) in enumerate(launches)}
    per_launch = [[0, 0] for _ in launches]
    ours = {"gcn_agg": 0, "edge_score": 0}
    busy_us, kernels = 0.0, 0
    for r in records:
        if not r.on_device or r.name in SPANS:
            continue
        kernels += 1
        busy_us += r.us
        for j, k in enumerate(ours):
            if f"{k}_kernel" in r.name:
                ours[k] += 1
                if r.corr in slot_of:
                    per_launch[slot_of[r.corr]][j] += 1
    return (out, ours, per_launch, kernels, len(launches),
            busy_us / (wall * 1e6))


def same_run(a, b) -> bool:
    """Two (carry, trace) pairs equal bit for bit (NaN equal to NaN)."""
    from repro_torch.nn.pytree import tree_tensors
    xs, ys = tree_tensors(a), tree_tensors(b)
    return len(xs) == len(ys) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and bool(((x == y) | (x != x) & (y != y)).all())
        for x, y in zip(xs, ys))


def max_diff(xs, ys) -> float:
    return max((float((x.float() - y.float()).abs().nan_to_num().max())
                for x, y in zip(xs, ys) if x.numel()), default=0.0)


def interleaved(drv, n_slots=N_SLOTS):
    """Slot ms of episodes in the order loop, scan, scan, loop on one seed
    (host time drifts within a call); the first of each mode's runs."""
    drv.run(SEED + 1, 3, mode="loop")                  # warm-up
    drv.run(SEED, n_slots, mode="scan")                # capture
    ms, runs = {"loop": [], "scan": []}, {}
    for mode in ("loop", "scan", "scan", "loop"):
        wall, out = episode_s(drv, mode=mode, n_slots=n_slots)
        ms[mode].append(wall / n_slots * 1e3)
        runs.setdefault(mode, out)
    return ms, runs


def compiled_episode_phase(dev, adef):
    """19. RolloutDriver.run(mode="scan"): the golden runs, the full-width
    episodes against the loop, launch and graph counts from the profiler,
    B=1024, and the telemetry registry. Returns {B=64 train: slot ms}."""
    from repro_torch.kernels import ops
    from repro_torch.nn.pytree import flatten_dict
    from repro_torch.rollout import RolloutDriver
    print("(1) decision golden, scan")
    golden_phase(dev, "scan")

    print("(2) training golden, scan, and the loop on the same draws")
    s_carry, s_trace = train_golden_phase(dev, "scan")
    l_carry, l_trace = train_golden_phase(dev, "loop")
    if not (torch.equal(s_trace.decisions, l_trace.decisions)
            and torch.equal(s_trace.reward, l_trace.reward)):
        raise SystemExit("train golden: scan and loop differ in decisions or "
                         "rewards")
    ok = ~torch.isnan(l_trace.loss)
    p_s = list(flatten_dict(s_carry.params).values())
    p_l = list(flatten_dict(l_carry.params).values())
    print(f"scan vs loop: decisions and rewards bitwise equal; max |dloss| "
          f"{max_diff([s_trace.loss[ok]], [l_trace.loss[ok]]):.3e}, max "
          f"|dparam| {max_diff(p_s, p_l):.3e}")

    print(f"(3) full width, own generator: B={N_FLEETS} T={N_SLOTS} "
          f"fig5_baseline")
    slot = {}
    for train in (False, True):
        drv = RolloutDriver(adef, N_FLEETS, train=train, device=dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        drv.run(SEED, N_SLOTS, mode="scan")
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        captured = ops.launch_counts()
        ms, runs = interleaved(drv)
        ops.reset_launch_counts()
        (carry, trace), ours, per_launch, kernels, graphs, busy = (
            profiled_episode(drv, "scan"))
        replayed = ops.launch_counts()
        n_train = N_SLOTS // adef.train_every if train else 0
        want = {"gcn_agg": 4 * (N_SLOTS + n_train),
                "edge_score": N_SLOTS + n_train}
        due = [train and (t + 1) % adef.train_every == 0
               for t in range(N_SLOTS)]
        off = {t: got for t, got in enumerate(per_launch)
               if got != ([8, 2] if due[t] else [4, 1])}
        equal = same_run(runs["loop"], runs["scan"])
        slot[train] = ms
        print(f"train={train}: slot ms, episodes loop, scan, scan, loop: "
              f"{ms['loop'][0]:.3f}, {ms['scan'][0]:.3f}, {ms['scan'][1]:.3f},"
              f" {ms['loop'][1]:.3f}; first scan episode (warm-up and capture"
              f" included) {first_s:.3f} s, wrapper calls in it {captured}")
        print(f"  profiled scan episode: actor kernels on the device {ours} "
              f"(expected {want}), {kernels / N_SLOTS:.2f} CUDA kernels and "
              f"{graphs / N_SLOTS:.2f} cudaGraphLaunch a slot, busy share "
              f"{busy:.1%}; wrapper calls {replayed}")
        print(f"  scan equals loop bit for bit on one seed: {equal}")
        if not equal:
            for mode, (c, _) in runs.items():
                m = drv.metrics(c)
                print(f"  {mode}: ssp {m['ssp']:.6f} avg_accuracy "
                      f"{m['avg_accuracy']:.6f}")
        if ours != want or off:
            raise SystemExit(f"scan train={train}: actor kernels on the "
                             f"device {ours}, expected {want}; graph "
                             f"launches whose [gcn_agg, edge_score] differ "
                             f"from their slot's [4, 1] or, training, "
                             f"[8, 2]: {dict(list(off.items())[:12])} "
                             f"({len(off)} of {len(per_launch)})")
        if captured["gcn_agg"] == 0 or captured["edge_score"] == 0:
            raise SystemExit(f"scan train={train}: the capture called no "
                             f"actor kernel ({captured})")
        if graphs != N_SLOTS:
            raise SystemExit(f"scan train={train}: {graphs} graph launches "
                             f"for {N_SLOTS} slots")
        m = drv.metrics(carry)
        if (not torch.isfinite(trace.reward).all()
                or int(m["train_steps"]) != n_train
                or not 0.0 < m["ssp"] <= 1.0):
            raise SystemExit(f"scan train={train}: output malformed")

    big, big_t = 1024, 50
    print(f"(4) large batch: B={big} T={big_t}, train=False")
    drv = RolloutDriver(adef, big, train=False, device=dev)
    ms, runs = interleaved(drv, big_t)
    print(f"slot ms, episodes loop, scan, scan, loop: {ms['loop'][0]:.3f}, "
          f"{ms['scan'][0]:.3f}, {ms['scan'][1]:.3f}, {ms['loop'][1]:.3f}; "
          f"scan equals loop bit for bit: "
          f"{same_run(runs['loop'], runs['scan'])}")
    del drv, runs

    print(f"(5) telemetry: B={N_FLEETS} T={N_SLOTS}, train=True")
    tel = RolloutDriver(adef, N_FLEETS, train=True, telemetry=True,
                        device=dev)
    off = RolloutDriver(adef, N_FLEETS, train=True, device=dev)
    c_loop, _ = tel.run(SEED, N_SLOTS, mode="loop")
    c_scan, t_scan = tel.run(SEED, N_SLOTS, mode="scan")
    c_off, t_off = off.run(SEED, N_SLOTS, mode="scan")
    a, b = c_scan.telemetry, c_loop.telemetry
    for name in a.counters:
        if not torch.equal(a.counters[name], b.counters[name]):
            raise SystemExit(f"telemetry: counter {name} differs, scan "
                             f"{float(a.counters[name])} loop "
                             f"{float(b.counters[name])}")
    for name in a.hists:
        if not torch.equal(a.hists[name].counts, b.hists[name].counts):
            raise SystemExit(f"telemetry: histogram {name} differs")
    ema_rel = abs(float(a.loss_ema) / float(b.loss_ema) - 1)
    if not ema_rel <= 1e-5:
        raise SystemExit(f"telemetry: loss_ema differs by {ema_rel:.3e}")
    c = {k: float(v) for k, v in a.counters.items()}
    active = t_scan.active > 0.5
    checks = {
        "slots": c["slots"] == N_SLOTS,
        "tasks": c["tasks"] == float(active.sum()),
        "success": c["success"] == float((t_scan.success & active).sum()),
        "train_steps": c["train_steps"]
        == float((~torch.isnan(t_scan.loss)).sum()),
        "reward": abs(c["reward"] / float(t_scan.reward.double().sum())
                      - 1) <= 1e-5,
        "hists": all(float(a.hists[n].counts.sum()) == c["tasks"]
                     for n in ("exit", "server", "latency"))}
    on_off = (torch.equal(t_scan.decisions, t_off.decisions)
              and torch.equal(t_scan.reward, t_off.reward)
              and all(torch.equal(x, y) for x, y in zip(
                  flatten_dict(c_scan.params).values(),
                  flatten_dict(c_off.params).values())))
    print(f"scan vs loop: counters and histogram counts bitwise equal, "
          f"loss_ema relative difference {ema_rel:.3e}; counters vs trace "
          f"{checks}; telemetry on vs off: same decisions, rewards and "
          f"params {on_off}")
    print(f"counters {c}")
    walls = {"on": [], "off": []}
    for name in ("on", "off", "off", "on"):
        wall, _ = episode_s(tel if name == "on" else off, mode="scan")
        walls[name].append(wall / N_SLOTS * 1e3)
    print(f"scan slot ms with telemetry on, off, off, on: {walls['on'][0]:.3f}"
          f", {walls['off'][0]:.3f}, {walls['off'][1]:.3f}, "
          f"{walls['on'][1]:.3f}")
    if not all(checks.values()) or not on_off:
        raise SystemExit("telemetry: counters disagree with the trace, or "
                         "the registry perturbed the run")
    return slot



# ------------------------------------- dynamic fleets and the baselines
def dyn_golden_phase(dev):
    """22. tests/data/torch_port_dyn_golden.npz: each run (its initial
    params, draws, minibatch rows and per-fleet scenarios) through the
    port's driver in loop and scan mode, held by check_train_replay."""
    from repro_torch.core import agent_def, agent_state_from_params
    from repro_torch.mec import (MECEnv, ScenarioParams, SlotTasks,
                                 SlotUniforms, make_scenario)
    from repro_torch.rollout import (InitDraws, RolloutDriver, SlotDraws,
                                     WorkloadDraws)
    with np.load(DYN_GOLDEN) as z:
        everything = {k: z[k] for k in z.files}

    def t(x, dtype=None):
        return torch.tensor(x, dtype=dtype, device=dev)

    for run in DYN_RUNS:
        gold = {k[len(run) + 1:]: v for k, v in everything.items()
                if k.startswith(run + "/")}
        method, scenario = str(gold["method"]), str(gold["scenario"])
        sp = (ScenarioParams(*(t(gold[f"sp/{f}"])
                               for f in ScenarioParams._fields))
              if "sp/task_kb" in gold else None)
        rand = t(gold["rand_cands"].astype(np.int64))
        take = t(gold["replay_take"])
        if "init/rate" in gold:
            wl = WorkloadDraws(
                *(t(gold[f"wl/{f}"]) for f in WorkloadDraws._fields[:-1]),
                SlotUniforms(*(t(gold[f"wl/slot/{f}"])
                               for f in SlotUniforms._fields)))
            draws = SlotDraws(None, rand, take,
                              init=InitDraws(t(gold["init/rate"]),
                                             t(gold["init/capacity"])),
                              workload=wl)
        else:
            draws = SlotDraws(SlotTasks(*(t(gold[f"tasks/{f}"])
                                          for f in TASK_FIELDS)), rand, take)
        env = MECEnv(make_scenario(scenario), device=dev)
        t_gold, b_gold = gold["rand_cands"].shape[:2]
        drv = RolloutDriver(agent_def(method, env, device=dev), b_gold,
                            train=True, per_fleet_scenarios=sp is not None,
                            device=dev, **DYN_KW)
        st = agent_state_from_params(drv.adef, tree_of(gold, "init_params"),
                                     gold["exit_mask"])
        print(f"{run}: {method} on {scenario} ({env.cfg.workload}"
              + (", one scenario per fleet" if sp is not None else "")
              + f"), B={b_gold} T={t_gold}")
        forced_replay(gold, drv, st, draws, sp, f"dyn golden {run}")
        traces = {}
        for mode in ("loop", "scan"):
            carry, trace = drv.run(SEED, t_gold, mode=mode, agent_state=st,
                                   draws=draws, sp=sp)
            check_train_replay(gold, carry, trace, mode, f"dyn golden {run}",
                               forced=True)
            traces[mode] = trace
        same = (torch.equal(traces["loop"].decisions,
                            traces["scan"].decisions)
                and torch.equal(traces["loop"].reward, traces["scan"].reward))
        print(f"  scan vs loop: decisions and rewards bitwise equal {same}")
        if not same:
            raise SystemExit(f"dyn golden {run}: scan and loop differ")


def forced_replay(gold, drv, state, draws, sp, label):
    """The golden run teacher-forced: each slot the port decides from its
    own learner on the run's draws, and must make the run's decision or
    differ only at a recorded near-tie (<= NEAR_TIE); then the env and
    the learner take the run's decision (as ``RolloutDriver._slot`` does
    with its own), so a tie cannot move the rest of the run. Every loss
    within TRAIN_LOSS_RTOL, the final params and Adam moments as
    check_final_state holds them. Critic ties (symmetric assignments
    whose Q differs only by summation order) are common for DROO, whose
    driver replay stops at the first; this holds its training whole."""
    from repro_torch.mec import SlotTasks
    from repro_torch.rollout.driver import _at
    adef, env, b = drv.adef, drv.env, drv.n_fleets
    want = torch.tensor(gold["trace/decisions"], device=state.step.device)
    t_gold = want.shape[0]
    env_state = env.reset((b,))
    wl = None
    if draws.init is not None:
        wl = drv.workload.init(None, sp, draws=draws.init)
    agent = adef.episode_state(state)
    losses, flips, n_train = [], 0, 0
    for t in range(t_gold):
        if draws.tasks is not None:
            tasks = SlotTasks(*(x[t] for x in draws.tasks))
        else:
            wl, tasks = drv.workload.sample(wl, None, sp,
                                            draws=_at(draws.workload, t))
        dec, _, graphs = adef.decide(agent, env_state, tasks,
                                     rand_cands=draws.rand_cands[t], sp=sp)
        for f in np.flatnonzero((dec != want[t]).any(-1).cpu().numpy()):
            margin = min(gold["q_margin"][t, f], gold["xhat_margin"][t, f])
            flips += 1
            if margin > NEAR_TIE:
                raise SystemExit(f"{label} (forced): decision differs at "
                                 f"slot {t} fleet {f}, margin {margin:.3e}")
        take = None
        if adef.train_due(agent, b):
            take = draws.replay_take[n_train]
            n_train += 1
        env_state, _ = env.step(env_state, tasks, want[t], sp)
        agent, loss = adef.absorb(agent, graphs, want[t], take=take)
        losses.append(float(loss))
    loss, gold_loss = np.asarray(losses), gold["trace/loss"]
    if not (np.isnan(loss) == np.isnan(gold_loss)).all():
        raise SystemExit(f"{label} (forced): train steps at other slots")
    ok = ~np.isnan(gold_loss)
    rel = float(np.abs(loss[ok] / gold_loss[ok] - 1).max())
    print(f"  teacher-forced: {flips} decisions differ, each at a recorded "
          f"near-tie; {int(ok.sum())} train steps, max loss relative error "
          f"{rel:.3e}")
    if not rel <= TRAIN_LOSS_RTOL:
        raise SystemExit(f"{label} (forced): loss beyond {TRAIN_LOSS_RTOL}")
    check_final_state(gold, agent, f"{label} (forced)")


def methods_phase(dev):
    """23. GRLE, GRL, DROOE and DROO at full width on fig8_csi, dyn_bursty
    and a domain-randomized fleet: B=64, T=200, train=True, scan mode on
    the port's generator from seed 0. Per run the §VI-D metrics, slot ms
    of a second run, the first run's seconds (warm-up and capture
    included) and, from the profiler, the actor kernels' device launches
    (fatal: 880 / 220 for the GCN methods, none for the MLP ones); per
    scenario the accuracy ratios and GRLE's q_best over the greedy
    oracle's on a fresh slot."""
    from repro_torch.core import agent_def
    from repro_torch.mec import (MECEnv, ScenarioParams, make_scenario,
                                 scenario_space)
    from repro_torch.rollout import RolloutDriver
    t0 = time.perf_counter()
    n_train = N_SLOTS // 10
    gen = torch.Generator(device=dev).manual_seed(SEED)
    fleets = {
        "fig8_csi": ("fig8_csi", None),
        "dyn_bursty": ("dyn_bursty", None),
        "space": ("fig5_baseline", scenario_space(
            *SPACE, device=dev).sample_batch(gen, N_FLEETS)),
    }
    for label, (scenario, sp) in fleets.items():
        env = MECEnv(make_scenario(scenario), device=dev)
        acc, grle_state = {}, None
        print(f"{label}: {scenario} structure ({env.cfg.workload})"
              + (f", one {SPACE[0]}..{SPACE[1]} draw per fleet"
                 if sp is not None else "")
              + f", B={N_FLEETS} T={N_SLOTS}")
        for method in METHODS:
            adef = agent_def(method, env, device=dev)
            drv = RolloutDriver(adef, N_FLEETS, train=True,
                                per_fleet_scenarios=sp is not None,
                                device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            drv.run(SEED, N_SLOTS, sp=sp)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            carry, trace = drv.run(SEED, N_SLOTS, sp=sp)
            torch.cuda.synchronize()
            slot_ms = (time.perf_counter() - t1) / N_SLOTS * 1e3
            (_, p_trace), ours, _, kernels, graphs, busy = profiled_episode(
                drv, "scan", sp=sp)
            m = drv.metrics(carry)
            gcn = adef.actor == "gcn"
            want = ({"gcn_agg": 4 * (N_SLOTS + n_train),
                     "edge_score": N_SLOTS + n_train} if gcn
                    else {"gcn_agg": 0, "edge_score": 0})
            acc[method] = m["avg_accuracy"]
            print(f"  {method:5s}: ssp {m['ssp']:.6f} avg_accuracy "
                  f"{m['avg_accuracy']:.6f} final_loss {m['final_loss']:.6f}"
                  f"; slot {slot_ms:.3f} ms; first run {first_s:.3f} s "
                  f"(warm-up and capture included); profiled: actor kernels"
                  f" {ours}, {kernels / N_SLOTS:.2f} CUDA kernels and "
                  f"{graphs / N_SLOTS:.2f} graph launches a slot, busy "
                  f"{busy:.1%}", flush=True)
            if ours != want or graphs != N_SLOTS:
                raise SystemExit(f"methods {label} {method}: actor kernels "
                                 f"{ours}, expected {want}; {graphs} graph "
                                 f"launches for {N_SLOTS} slots")
            if (int(m["train_steps"]) != n_train
                    or not math.isfinite(m["final_loss"])
                    or not 0.0 < m["ssp"] <= 1.0
                    or not torch.isfinite(trace.reward).all()
                    or not torch.equal(p_trace.decisions, trace.decisions)):
                raise SystemExit(f"methods {label} {method}: output "
                                 f"malformed or runs of one seed differ")
            if method == "grle":
                grle_state = (adef, carry.agent_state)
        print(f"  accuracy ratios: GRLE/GRL {acc['grle'] / acc['grl']:.4f}, "
              f"GRLE/DROOE {acc['grle'] / acc['drooe']:.4f}, GRLE/DROO "
              f"{acc['grle'] / acc['droo']:.4f}")
        # Fig 4's normalization on one fresh slot of one network
        adef, state = grle_state
        sp0 = None if sp is None else ScenarioParams(*(x[0] for x in sp))
        g1 = torch.Generator(device=dev).manual_seed(SEED + 1)
        tasks = (env.sample_slot(g1, (), sp0) if env.cfg.workload == "iid"
                 else drv.workload.sample(drv.workload.init(g1, sp0), g1,
                                          sp0)[1])
        mec = env.reset()
        _, q_best, _ = adef.decide(state, mec, tasks, generator=g1, sp=sp0)
        oracle = env.greedy_decision(mec, tasks, sp=sp0)
        q_oracle = env.evaluate(mec, tasks, oracle[None], sp0)[0]
        print(f"  GRLE q_best {float(q_best):.6f} / greedy oracle "
              f"{float(q_oracle):.6f} = {float(q_best / q_oracle):.4f} "
              f"(M={env.M}, {int(tasks.active.sum())} active)")
    print(f"phase 23 wall {time.perf_counter() - t0:.2f} s")


# ------------------------------------------------------------- the sweep
RAN = re.compile(r"\[sweep\] (.+): ran (\d+) cells in ([\d.]+) s \(first "
                 r"([\d.]+) s with its build(?:, then ([\d.]+) ms a slot "
                 r"per cell)?\)")


# the CUDA symbols of a wrapper's kernels, where they are not <name>_kernel
KERNEL_SYMBOLS = {"ssm_scan": ("ssm_scan_kernel", "ssm_scan_bf16_kernel")}
# profiled_call(lead=True)'s markers: torch.cuda._sleep's kernel
LEAD_MARKER, LEAD_MARKERS = "spin_kernel", 128


def profiled_call(fn, names=("gcn_agg", "edge_score"), *, busy=None,
                  lead=False):
    """``fn()`` under torch.profiler, the window open ``PROFILER_TAIL_S``
    after its closing synchronize: (result, {name: device records of the
    kernel ``<name>_kernel`` or ``KERNEL_SYMBOLS[name]``}, cudaGraphLaunch
    calls). With ``lead``, the window also stays open ``PROFILER_TAIL_S``
    and runs ``LEAD_MARKERS`` marker kernels (``spin_kernel``, left out of
    every count) before ``fn()``: a window can lose the device records of
    the work it starts with. A ``busy`` dict
    gets ``wall_ms`` (``fn()`` to its synchronize, host clock),
    ``device_ms`` (the device records' summed time, the driver's spans
    left out), ``kernels`` (those records: CUDA kernels and copies) and
    ``by_name`` ({kernel: device ms})."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if lead:
            time.sleep(PROFILER_TAIL_S)
            for _ in range(LEAD_MARKERS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PROFILER_TAIL_S)
    ours = {k: 0 for k in names}
    graphs, by_name = 0, {}
    n_kernels = 0
    for r in profiler_records(prof):
        if r.name == "cudaGraphLaunch":
            graphs += 1
        elif r.on_device and LEAD_MARKER not in r.name:
            for k in ours:
                ours[k] += any(sym in r.name for sym in
                               KERNEL_SYMBOLS.get(k, (f"{k}_kernel",)))
            if r.name not in SPANS:
                n_kernels += 1
                by_name[r.name] = by_name.get(r.name, 0.0) + r.us / 1e3
    if busy is not None:
        busy.update(wall_ms=wall * 1e3, device_ms=sum(by_name.values()),
                    kernels=n_kernels, by_name=by_name)
    return out, ours, graphs


def profiled_until(fn, want: dict, label: str):
    """``fn()`` under ``profiled_call(lead=True)`` until a window reads the
    kernel counts ``want`` exactly, at most PROFILE_TRIES windows: the
    profiler drops device records of a window (the same step reads a
    different total from window to window; in the whole script windows
    read ~50 fewer, a scan's among them, and phase 35's read 31 of its 32
    flash kernels once), so a count it reads can only be low, and no
    window may read more. Returns (the last window's ``busy`` dict, its
    reading as printed, every window's reading)."""
    windows = []
    for _ in range(PROFILE_TRIES):
        busy = {}
        _, prof, _ = profiled_call(fn, tuple(want), busy=busy, lead=True)
        windows.append(f"{prof} of {busy['kernels']}")
        if any(prof[k] > n for k, n in want.items()):
            raise SystemExit(f"{label}: the profiler saw {prof} kernels, "
                             f"more than {want}")
        if prof == want:
            return busy, prof, windows
    raise SystemExit(f"{label}: no profiler window saw {want} kernels: "
                     f"{windows}")


def sweep_phase(dev):
    """24. ``run_sweep`` over the paper's figures, the dynamic scenarios
    and four space draws, four methods, two seeds, at the SweepSpec
    defaults (see the module docstring): captures per pack, sequential
    rows equal to packed ones, launches per cell, resume, finite losses;
    per-pack walls and cells/s packed against sequential."""
    import shutil
    from repro_torch.obs import CompileTracker
    from repro_torch.sweep import (PackProgram, SweepSpec, SweepStore,
                                   build_report, format_markdown,
                                   format_telemetry, pack_cells, run_cell,
                                   run_sweep)
    from repro_torch.sweep.packer import cell_config
    t0 = time.perf_counter()
    spec = SweepSpec(scenarios=SWEEP_SCENARIOS + SweepSpec.from_space(
        *SPACE, SWEEP_DRAWS).scenarios, seeds=SWEEP_SEEDS)
    cells = spec.expand()
    packs = pack_cells(cells)
    kind = {p.label(): (p.family, cell_config(p.cells[0]).workload)
            for p in packs}
    pack_of = {kind[p.label()]: p for p in packs}
    print(f"{len(spec.scenarios)} scenarios x {len(spec.methods)} methods x "
          f"{len(spec.seeds)} seeds = {len(cells)} cells, M={spec.n_devices}"
          f" T={spec.n_slots} B={spec.n_fleets} ring {spec.replay_capacity} "
          f"minibatch {spec.batch_size} omega {spec.train_every}; "
          f"{len(packs)} packs: "
          + ", ".join(f"{f}/{w} {len(p.cells)}"
                      for p, (f, w) in zip(packs, kind.values())))
    if len(cells) != 96 or sorted(len(p.cells) for p in packs) != [
            4, 4, 12, 12, 32, 32]:
        raise SystemExit("sweep: the grid does not pack as 32 + 12 + 4 per "
                         "actor family")
    shutil.rmtree(SWEEP_STORE, ignore_errors=True)
    store = SweepStore(SWEEP_STORE)
    logs = []

    def log(msg):
        logs.append(msg)
        print(msg, flush=True)

    try:
        # the packed grid
        with CompileTracker() as ct:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rows = run_sweep(spec, store=store, log=log, telemetry=True,
                             device=dev)
            packed_s = time.perf_counter() - t1
        built = ct.by_label()
        print(f"packed: {len(rows)} cells in {packed_s:.3f} s, "
              f"{len(rows) / packed_s:.3f} cells/s; {ct.summary()}")
        print("pack | cells | wall s | first cell s (build + capture) | "
              "capture s | ms a slot per cell after it")
        for msg in logs:
            m = RAN.search(msg)
            if m:
                label, n, wall, first, ms = m.groups()
                print(f"  {label} | {n} | {wall} | {first} | "
                      f"{built[label]['seconds']:.4f} | {ms}")
        for p in packs:
            got = built.get(p.label(), {})
            if (got.get("episodes"), got.get("graphs")) != (1, 2):
                raise SystemExit(f"sweep {p.label()}: {got}, expected one "
                                 f"episode built and two graphs captured")
        if (ct.n_backend_compiles, ct.n_graphs_captured) != (6, 12):
            raise SystemExit(f"sweep: {ct.summary()}, expected 6 episodes "
                             f"and 12 graphs")
        row_of = dict(zip(cells, rows))
        for c, r in row_of.items():
            if r["backend"] != f"torch-{dev.type}" or (
                    r["method"] in ("grle", "grl")
                    and (r["final_loss"] is None
                         or not math.isfinite(r["final_loss"]))) or (
                    r["train_steps"] != 24 or not 0.0 < r["ssp"] <= 1.0):
                raise SystemExit(f"sweep {c.label()}: row malformed: "
                                 f"{ {k: r[k] for k in ('backend', 'ssp', 'train_steps', 'final_loss')} }")

        # sequential rows equal packed ones
        seq = [c for key in (("gcn", "iid"), ("mlp", "poisson"))
               for c in pack_of[key].cells if c.seed == 0]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for c in seq:
            r = run_cell(c, telemetry=True, device=dev)
            if r != row_of[c]:
                diff = sorted(k for k in r if r[k] != row_of[c].get(k))
                raise SystemExit(f"sweep {c.label()}: run_cell differs from "
                                 f"its packed row in {diff}")
        seq_s = time.perf_counter() - t1
        print(f"sequential: run_cell on {len(seq)} cells (seed 0 of the iid "
              f"GCN and poisson MLP packs) in {seq_s:.3f} s, "
              f"{len(seq) / seq_s:.3f} cells/s, every row equal to its "
              f"packed row bit for bit; packed/sequential cells/s "
              f"{(len(rows) / packed_s) / (len(seq) / seq_s):.3f}")

        # launches over one cell's replays inside its pack
        for key, method in ((("gcn", "iid"), "grle"), (("mlp", "iid"),
                                                      "droo")):
            pack = pack_of[key]
            prog = PackProgram(pack, telemetry=True, device=dev)
            prog.run_one(0)                        # builds and captures
            i = next(j for j, c in enumerate(pack.cells)
                     if c.method == method and c.scenario == "fig8_csi")
            row, ours, graphs = profiled_call(lambda: prog.run_one(i))
            c = pack.cells[i]
            n = c.n_slots + row["train_steps"]
            want = ({"gcn_agg": 4 * n, "edge_score": n} if method == "grle"
                    else {"gcn_agg": 0, "edge_score": 0})
            print(f"  {c.label()} replayed inside {pack.label()}: actor "
                  f"kernels {ours} (expected {want}), {graphs} graph "
                  f"launches, row equal to the packed one: "
                  f"{row == row_of[c]}")
            if ours != want or graphs != c.n_slots or row != row_of[c]:
                raise SystemExit(f"sweep {c.label()}: launches {ours}, "
                                 f"expected {want}; {graphs} graph launches;"
                                 f" or its row differs from the packed one")
            del prog

        # resume: one cell of the iid GCN pack lost
        files = sorted(os.listdir(SWEEP_STORE))
        before = {f: (open(os.path.join(SWEEP_STORE, f), "rb").read(),
                      os.stat(os.path.join(SWEEP_STORE, f)).st_mtime_ns)
                  for f in files}
        gcn_iid = pack_of[("gcn", "iid")]
        victim = gcn_iid.cells[5]
        os.unlink(store.path(victim))
        logs.clear()
        t1 = time.perf_counter()
        resumed = run_sweep(spec, store=store, log=log, telemetry=True,
                            device=dev)
        resume_s = time.perf_counter() - t1
        after = {f: (open(os.path.join(SWEEP_STORE, f), "rb").read(),
                     os.stat(os.path.join(SWEEP_STORE, f)).st_mtime_ns)
                 for f in sorted(os.listdir(SWEEP_STORE))}
        name = os.path.basename(store.path(victim))
        ran = [m for m in logs if ": running" in m]
        if (len(ran) != 1 or gcn_iid.label() not in ran[0]
                or set(after) != set(before)
                or after[name][0] != before[name][0]
                or any(after[f] != before[f] for f in before if f != name)
                or resumed != rows):
            raise SystemExit(f"sweep resume: ran {ran}; the rewritten file "
                             f"or another one differs")
        with CompileTracker() as ct:
            logs.clear()
            run_sweep(spec, store=store, log=log, device=dev)
        if ct.n_backend_compiles or any(": running" in m for m in logs):
            raise SystemExit("sweep: a fully cached run executed a pack")
        print(f"resume: {victim.label()} deleted; the rerun ran "
              f"{gcn_iid.label()} alone in {resume_s:.3f} s and rewrote "
              f"{name} byte for byte, {len(before) - 1} other files "
              f"untouched; a third run executed nothing")
        report = build_report(rows)
        print(format_markdown(report))
        print(format_telemetry(rows))
    finally:
        shutil.rmtree(SWEEP_STORE, ignore_errors=True)
    print(f"phase 24 wall {time.perf_counter() - t0:.2f} s")


# ------------------------------------------------------------- serving
def inject_serve_draws(eng, data, n_steps):
    """A golden serve run's draws into ``eng``, one ServeDraws a
    scheduling step: the tasks, the exploration candidates and, on a
    train step, the replay rows."""
    from repro_torch.mec import SlotTasks
    from repro_torch.serve import ServeDraws
    takes = dict(zip(data["train_steps"].tolist(), data["replay_take"]))
    eng.inject_draws(
        ServeDraws(SlotTasks(*(torch.tensor(data[f"tasks/{f}"][t])
                               for f in TASK_FIELDS)),
                   torch.tensor(data["rand_cands"][t].astype(np.int64)),
                   None if t not in takes else torch.tensor(takes[t]))
        for t in range(n_steps))


def serve_engine_from(data, dev):
    """The port's EdgeServingEngine as tests/data/torch_serve_golden.npz
    records the JAX one: reduced Qwen in f32 with lm_params_numpy weights,
    the run's initial agent params and exit mask, the exit table from the
    stored roofline figures, and every draw of the run injected."""
    from repro_torch.configs import get_arch
    from repro_torch.core import agent_state_from_params
    from repro_torch.core.bridge import lm_params_from_numpy, lm_params_numpy
    from repro_torch.serve import EdgeServingEngine, Replica
    cfg = get_arch(SERVE_ARCH, reduced=True)
    eng = EdgeServingEngine(
        cfg, [Replica(n, s) for n, s in SERVE_REPLICAS],
        scheduler=str(data["scheduler"]), batch_slots=len(
            data["assign_replica"][0]), seed=int(data["seed"]),
        workload="mmpp", scenario="dyn_bursty", agent_kw=SERVE_AGENT_KW,
        profile_kw={k: float(data[f"profile/{k}"])
                    for k in ("peak_flops", "hbm_bw")}, device=dev)
    eng.params = lm_params_from_numpy(
        lm_params_numpy(cfg, int(data["lm_seed"])), cfg, dev)
    eng.set_agent_state(agent_state_from_params(
        eng.agent_def, tree_of(data, "init_params"), data["exit_mask"]))
    inject_serve_draws(eng, data, len(data["schedule"]))
    return eng


def serve_golden_phase(dev):
    """20. tests/data/torch_serve_golden.npz (a JAX EdgeServingEngine run
    with its draws: 12 slots, explicit and arrival-driven requests,
    decoding, one train step) through the port's engine on the card:
    assignments and generated tokens equal, rewards and losses within
    1e-5 relative, final params within TRAIN_PARAM_TOL."""
    from repro_torch.kernels import ops
    with np.load(SERVE_GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    eng = serve_engine_from(gold, dev)
    names = [n for n, _ in SERVE_REPLICAS]
    ops.reset_launch_counts()
    same_assign = same_text = 0
    reward_err = loss_err = 0.0
    for i, n in enumerate(gold["schedule"].tolist()):
        reqs = None if n < 0 else [eng.make_request() for _ in range(n)]
        count = int(eng.agent_state.loss_count)
        assignments, info = eng.serve_slot(reqs, decode=True)
        want = [(names[r], int(e)) for r, e in zip(
            gold["assign_replica"][i], gold["assign_exit"][i]) if r >= 0]
        texts = [list(map(int, gold["texts"][i, j]))
                 for j in range(len(want))]
        same_assign += assignments == want
        same_text += (info["texts"] or []) == texts
        reward_err = max(reward_err, abs(info["reward"] - gold["reward"][i])
                         / max(abs(gold["reward"][i]), 1e-6))
        if int(eng.agent_state.loss_count) > count:
            loss = float(eng.agent_state.last_loss)
            loss_err = max(loss_err, abs(loss - gold["loss"][i])
                           / abs(gold["loss"][i]))
        elif np.isfinite(gold["loss"][i]):
            raise SystemExit(f"serve golden: slot {i} took no train step")
    excess, diff = -math.inf, 0.0
    for layer, leaves in tree_of(gold, "final/params").items():
        for name, want in leaves.items():
            got = eng.agent_state.params[layer][name]
            w = torch.tensor(want, device=dev)
            excess = max(excess, close_excess(got, w, *TRAIN_PARAM_TOL))
            diff = max(diff, float((got - w).abs().max()))
    t = len(gold["schedule"])
    print(f"slots with equal assignments {same_assign}/{t}, equal generated "
          f"tokens {same_text}/{t}; max reward error {reward_err:.3e} "
          f"(relative), loss {loss_err:.3e}; final params max |diff| "
          f"{diff:.3e}; launches {ops.launch_counts()}")
    if (same_assign != t or same_text != t or not reward_err <= 1e-5
            or not loss_err <= TRAIN_LOSS_RTOL or not excess <= 0):
        raise SystemExit("serve golden: the port's engine differs from the "
                         "JAX run")


def serve_actor_check(dev, eng, label, *, timed=False):
    """The five actor launches of ``eng``'s path (its env: M = its batch
    slots, O = N*L; its workload's tasks, its live MECState and its agent
    params) at B=1 (a decision) and at the training minibatch, each
    wrapper against its plain version (TOL) and each gradient against
    autograd of the plain version (grad_err). Fatal on any difference;
    returns each kernel's largest forward error. ``timed``: each B=1 case
    also timed, kernel and plain by CUDA-graph replay beside its bound,
    and each kernel's sums for a decision printed."""
    adef = eng.agent_def
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = {"gcn_agg": 0.0, "edge_score": 0.0}
    shape = f"{label} M={eng.env.M} O={eng.env.N * eng.env.L}"
    sums = {}
    for b in (1, adef.batch_size):
        for kernel, name, args, fn, plain, cost in actor_cases(
                eng.env, eng.agent_state.params, gen, b,
                workload=eng._workload, state=eng.mec_state):
            err = float((fn(*args) - plain(*args)).abs().max())
            torch.cuda.synchronize()
            times = ""
            if timed and b == 1:
                ms = graph_ms(lambda: fn(*args))
                plain_ms = graph_ms(lambda: plain(*args))
                times = (f", kernel {ms * 1e3:8.2f} us, plain "
                         f"{plain_ms * 1e3:8.2f} us, bound "
                         f"{bound(*cost)[0] * 1e3:6.3f} us")
                s = sums.setdefault(kernel, [0.0, 0.0, 0, 0])
                for i, v in enumerate((ms * 1e3, plain_ms * 1e3, *cost)):
                    s[i] += v
            print(f"  {kernel:10s} {name:14s} {shape} B={b} max_abs_err "
                  f"{err:.3e}{times}", flush=True)
            if not err <= TOL:
                raise SystemExit(f"serve {label} {kernel} {name} B={b}: max "
                                 f"abs error {err} above {TOL}")
            worst[kernel] = max(worst[kernel], err)
            grad_err(dev, kernel, name, args, plain, gen, f"{label} B={b}")
    for kernel, (us, plain_us, nbytes, flops) in sums.items():
        print(f"  {kernel:10s} per decision {shape}: kernel {us:.2f} us, "
              f"plain {plain_us:.2f} us, bound "
              f"{bound(nbytes, flops)[0] * 1e3:.3f} us", flush=True)
    return worst


def serve_decode_check(dev, cfg, groups):
    """decode_attention at each exit group's shape of the sync path
    (``groups``: batch size -> positions a group's _decode ran), against
    its plain version on random cache contents, at the first and the last
    position's lengths (at most SERVE_CACHE: a longer run wraps the cache
    and attends every row); ATTN_TOL, fatal."""
    from repro_torch.kernels import decode_attention as decode_mod
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dtype, tol = cfg.torch_dtype, ATTN_TOL[cfg.torch_dtype]
    for b, total in sorted(groups.items()):
        kv = (b, SERVE_CACHE, cfg.n_kv_heads, cfg.head_dim)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((b, cfg.n_heads, cfg.head_dim), kv, kv))
        for n in (1, min(total, SERVE_CACHE)):
            lengths = torch.full((b,), n, dtype=torch.int32, device=dev)
            got = decode_mod.decode_attention(q, k, v, lengths).float()
            want = ref.decode_attention_ref(q, k, v, lengths).float()
            err = float((got - want).abs().max())
            print(f"  decode_attention B={b} S={SERVE_CACHE} length {n} "
                  f"max_abs_err {err:.3e}", flush=True)
            if not bool(((got - want).abs() <= tol + tol * want.abs()).all()):
                raise SystemExit(f"serve decode_attention B={b} length {n}: "
                                 f"kernel differs from plain by more than "
                                 f"{tol} (rtol and atol); max abs error {err}")


def serve_path_phase(dev):
    """21. Serving at full width: Llama-3.2-1B (bf16, random weights from
    seed 0) behind EdgeServingEngine, GRLE choosing replica and exit for
    ENGINE_B requests a slot and training online; then the async engine
    draining a dyn_bursty trace, and async against sync on the port's
    generator."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.nn.pytree import flatten_dict
    from repro_torch.serve import (ContinuousServingEngine,
                                   EdgeServingEngine, Replica, Request,
                                   make_trace)
    cfg = get_arch(LM_ARCH)
    replicas = [Replica("fast-pod", 1.0), Replica("slow-pod", 0.5)]
    t0 = time.perf_counter()
    eng = EdgeServingEngine(cfg, replicas, scheduler="grle",
                            batch_slots=ENGINE_B, cache_len=SERVE_CACHE,
                            seed=SEED, agent_kw=ENGINE_AGENT_KW, device=dev)
    torch.cuda.synchronize()
    print(f"{cfg.arch_id} at full width, {cfg.dtype}, exits "
          f"{cfg.exit_layers}; replicas {[(r.name, r.speed) for r in replicas]}"
          f"; exit table ms {np.round(eng.exit_times * 1e3, 4).tolist()}, "
          f"deadline {eng.env.cfg.deadline_s * 1e3:.3f} ms; engine built in "
          f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED)

    def requests():
        lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1,
                            size=ENGINE_B)
        return [Request(tokens=rng.integers(0, cfg.vocab, int(n)).astype(
                    np.int32), deadline_s=eng.env.cfg.deadline_s,
                        max_new=ENGINE_NEW) for n in lens]

    eng.serve_slot(requests()[:2], decode=True)       # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    want = {"gcn_agg": 0, "edge_score": 0, "flash_attention": 0,
            "decode_attention": 0, "ssm_scan": 0}
    walls, losses, exits, shapes = [], [], {}, {}
    for _ in range(ENGINE_SLOTS):
        reqs = requests()
        due = eng.agent_def.train_due(eng.agent_state, 1)
        t0 = time.perf_counter()
        assignments, info = eng.serve_slot(reqs, decode=True)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        want["gcn_agg"] += 4 + 4 * due
        want["edge_score"] += 1 + due
        groups = {}
        for r, (_, e) in zip(reqs, assignments):
            groups.setdefault(e, []).append(len(r.tokens))
            exits[e] = exits.get(e, 0) + 1
        want["decode_attention"] += sum(e * (max(n) + ENGINE_NEW)
                                        for e, n in groups.items())
        for n in groups.values():      # decode batch -> longest positions
            shapes[len(n)] = max(shapes.get(len(n), 0), max(n) + ENGINE_NEW)
        if due:
            losses.append(float(eng.agent_state.last_loss))
        if any(len(t) != ENGINE_NEW or min(t) < 0 or max(t) >= cfg.vocab
               for t in info["texts"]):
            raise SystemExit("serve path: generated tokens malformed")
    counts = ops.launch_counts()
    print(f"{ENGINE_SLOTS} slots x {ENGINE_B} requests (prompts "
          f"{PROMPT_LENS[0]}..{PROMPT_LENS[1]} tokens, {ENGINE_NEW} new), "
          f"decode=True: slot ms mean {np.mean(walls) * 1e3:.3f}, median "
          f"{np.median(walls) * 1e3:.3f}, min {min(walls) * 1e3:.3f}, max "
          f"{max(walls) * 1e3:.3f}; exits chosen {dict(sorted(exits.items()))}"
          f"; {len(losses)} train steps, losses "
          f"{[round(x, 6) for x in losses]}")
    print(f"launches {counts}, expected {want}")
    if counts != want:
        raise SystemExit(f"serve path launches {counts}, expected {want}")
    if not losses or not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"serve path: losses {losses}")
    serve_actor_check(dev, eng, "sync")
    serve_decode_check(dev, cfg, shapes)
    walls = []
    for _ in range(ENGINE_SLOTS):
        reqs = requests()
        t0 = time.perf_counter()
        eng.serve_slot(reqs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"{ENGINE_SLOTS} slots, decode=False: slot ms mean "
          f"{np.mean(walls) * 1e3:.3f}, median {np.median(walls) * 1e3:.3f}")
    snap = eng.telemetry_snapshot()
    print(f"telemetry summary {json.dumps(snap['summary'])}")
    print(f"metrics {eng.metrics.summary()}; transfers {snap['transfers']}")

    # one request longer than the cache, decoded over the wrapped cache
    long = Request(tokens=rng.integers(0, cfg.vocab, WRAP_PROMPT).astype(
        np.int32), deadline_s=eng.env.cfg.deadline_s, max_new=WRAP_NEW)
    total = WRAP_PROMPT + WRAP_NEW
    due = eng.agent_def.train_due(eng.agent_state, 1)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ((_, e),), info = eng.serve_slot([long], decode=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = {"gcn_agg": 4 + 4 * due, "edge_score": 1 + due,
            "flash_attention": 0, "decode_attention": e * total,
            "ssm_scan": 0}
    text = info["texts"][0]
    print(f"a {WRAP_PROMPT}-token prompt with {WRAP_NEW} new tokens "
          f"({total} positions, cache {SERVE_CACHE} rows) at exit {e}: "
          f"{wall * 1e3:.3f} ms, launches {counts}, expected {want}")
    if counts != want:
        raise SystemExit(f"wrapped request: launches {counts}, expected "
                         f"{want}")
    if len(text) != WRAP_NEW or min(text) < 0 or max(text) >= cfg.vocab:
        raise SystemExit("wrapped request: generated tokens malformed")
    serve_decode_check(dev, cfg, {1: total})
    del eng
    torch.cuda.empty_cache()

    # the async engine draining a bursty trace
    kw = dict(scheduler="grle", batch_slots=ASYNC_B, seed=SEED,
              scenario="dyn_bursty", agent_kw=ENGINE_AGENT_KW, device=dev)
    asy = ContinuousServingEngine(cfg, replicas, **kw)
    slot = float(asy.env.cfg.slot_s)
    trace = make_trace(n_users=ASYNC_USERS, n_slots=ASYNC_SLOTS, slot_s=slot,
                       scenario="dyn_bursty", seed=SEED)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    reports = asy.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    c, steps = asy.counts, len(reports)
    n_train = int(asy.agent_state.loss_count)
    law = c["admitted"] == c["served"] + c["expired"] + asy.in_flight
    print(f"async, scheduling plane only (agent and env step, no LM): "
          f"{len(trace)} requests from {ASYNC_USERS} users over "
          f"{ASYNC_SLOTS} slots of {slot * 1e3:.3f} ms, batch {ASYNC_B}: "
          f"{steps} steps in {wall:.3f} s, {steps / wall:.1f} steps/s, "
          f"{c['served'] / wall:.1f} requests/s; counts {c}, in flight "
          f"{asy.in_flight}; {n_train} train steps; launches {counts}")
    snap = asy.telemetry_snapshot()
    print(f"async telemetry summary {json.dumps(snap['summary'])}")
    if (not law or asy.in_flight or c["admitted"] != len(trace)
            or counts["gcn_agg"] != 4 * steps + 4 * n_train
            or counts["edge_score"] != steps + n_train or n_train < 1):
        raise SystemExit(f"async: counter law or launches wrong: counts {c}"
                         f", launches {counts}, {steps} steps, {n_train} "
                         f"train steps")
    serve_actor_check(dev, asy, "async")

    # async against sync on the port's own generator
    asy = ContinuousServingEngine(cfg, replicas, **kw)
    syn = EdgeServingEngine(cfg, replicas, workload="mmpp",
                            init_model=False, **kw)
    reports = asy.run(trace, max_steps=EQUIV_STEPS)
    same = 0
    for rep in reports:
        reqs = [syn.make_request() for _ in rep["assignments"]]
        assignments, _ = syn.serve_slot(reqs)
        same += [(a["replica"], a["exit"])
                 for a in rep["assignments"]] == assignments
    pa = flatten_dict(asy.agent_state.params)
    ps = flatten_dict(syn.agent_state.params)
    diff = max(float((pa[k] - ps[k]).abs().max()) for k in pa)
    excess = max(close_excess(pa[k], ps[k], *TRAIN_PARAM_TOL) for k in pa)
    print(f"async vs sync, {len(reports)} steps: equal assignments "
          f"{same}/{len(reports)}, {int(asy.agent_state.loss_count)} train "
          f"steps, params max |diff| {diff:.3e}")
    if same != len(reports) or not excess <= 0:
        raise SystemExit("async and sync engines disagree")


# ------------------------------------------------- the serving benchmark
def stored_trace(data, name):
    """A golden file's trace ``name`` (``trace/<name>/<field>`` columns)
    as the JAX engine received it."""
    from repro_torch.serve import ServeRequest
    prefix = f"trace/{name}/"
    cols = {k[len(prefix):]: data[k].tolist() for k in data
            if k.startswith(prefix)}
    return [ServeRequest(**dict(zip(cols, vals)))
            for vals in zip(*cols.values())]


def async_golden_replay(gold, dev):
    """The port's ContinuousServingEngine as a continuous-serving golden
    file records the JAX one (its knobs, initial agent params and exit
    mask, the exit table from the stored roofline figures, every draw
    injected), run over the file's traces in order: (engine, {run: step
    reports}, each step's decision, the main run's row fields by
    serve_bench.continuous_fields)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import agent_state_from_params
    from repro_torch.launch.serve_bench import continuous_fields
    from repro_torch.serve import ContinuousServingEngine, Replica
    eng = ContinuousServingEngine(
        get_arch(SERVE_ARCH, reduced=True),
        [Replica(n, s) for n, s in SERVE_REPLICAS],
        scheduler=str(gold["scheduler"]),
        batch_slots=int(gold["batch_slots"]), seed=int(gold["seed"]),
        workload="mmpp", scenario="dyn_bursty",
        agent_kw=json.loads(str(gold["agent_kw"])), init_model=False,
        profile_kw={k: float(gold[f"profile/{k}"])
                    for k in ("peak_flops", "hbm_bw")}, device=dev)
    eng.set_agent_state(agent_state_from_params(
        eng.agent_def, tree_of(gold, "init_params"), gold["exit_mask"]))
    inject_serve_draws(eng, gold, len(gold["decisions"]))
    decisions, price = [], eng._price_slot

    def priced(active):
        out = price(active)
        decisions.append(out[1])
        return out

    eng._price_slot = priced
    reports, row = {}, None
    for name in gold["runs"].tolist():
        served, tokens = eng.counts["served"], eng.tokens_served
        reports[name] = eng.run(stored_trace(gold, name))
        if name == "main":
            row = continuous_fields(eng, served, tokens)
    return eng, reports, decisions, row


def report_diff(got, want) -> tuple:
    """One step report against the golden's: (what differs, the largest
    relative latency difference). Everything but the served latencies
    must be equal; those within ASYNC_LATENCY_RTOL."""
    bad, worst = [], 0.0
    for k in want:
        if k != "served" and got.get(k) != want[k]:
            bad.append(k)
    if len(got["served"]) != len(want["served"]):
        return bad + ["served"], worst
    for g, w in zip(got["served"], want["served"]):
        if {k: v for k, v in g.items() if k != "latency_s"} != \
                {k: v for k, v in w.items() if k != "latency_s"}:
            bad.append(f"served rid {w['rid']}")
        elif (g["latency_s"] is None) != (w["latency_s"] is None):
            bad.append(f"served rid {w['rid']} latency")
        elif w["latency_s"] is not None:
            rel = abs(g["latency_s"] - w["latency_s"]) / abs(w["latency_s"])
            worst = max(worst, rel)
            if not rel <= ASYNC_LATENCY_RTOL:
                bad.append(f"served rid {w['rid']} latency {rel:.3e}")
    return bad, worst


def serve_async_golden_phase(dev):
    """44. tests/data/torch_serve_async_golden.npz (a JAX
    ContinuousServingEngine at the serve-bench's --quick shape over its
    warm-up and main traces and the main stream's next 512 requests, with
    its draws) through the port's continuous engine on the card with the
    draws injected: every step's decision equal, or a flip only at a
    recorded near-tie (<= NEAR_TIE), after which the comparison stops
    (fatal before the first train step); the step reports equal, served
    latencies within ASYNC_LATENCY_RTOL; without a flip the counts, tokens
    served, the bench row's fields and the final params (TRAIN_PARAM_TOL)
    too; gcn_agg 4 and edge_score 1 a decision and a train step. Returns
    the launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.nn.pytree import flatten_dict
    gold = load_npz(SERVE_ASYNC_GOLDEN)
    n_steps = len(gold["decisions"])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng, reports, decisions, row = async_golden_replay(gold, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    got = [r for name in gold["runs"].tolist() for r in reports[name]]
    want = [r for name in gold["runs"].tolist()
            for r in json.loads(str(gold[f"reports/{name}"]))]
    n_train = int(eng.agent_state.loss_count)
    per_run = ", ".join(f"{n} {int(gold['steps/' + n])}"
                        for n in gold["runs"].tolist())
    print(f"{len(got)} steps ({per_run}) at batch {eng.batch_slots} in "
          f"{wall:.3f} s with the engine's build, {n_train} train steps; "
          f"launches {counts}")
    if len(got) != n_steps or len(decisions) != n_steps:
        raise SystemExit(f"serve async golden: {len(got)} steps, the "
                         f"golden run took {n_steps}")
    same = (np.stack(decisions) == gold["decisions"]).all(-1)
    flipped = np.flatnonzero(~same)
    stop = int(flipped[0]) if flipped.size else n_steps
    if flipped.size:
        margin = min(gold["q_margin"][stop], gold["xhat_margin"][stop])
        print(f"  step {stop}: q margin {gold['q_margin'][stop]:.3e}, x_hat "
              f"margin {gold['xhat_margin'][stop]:.3e}")
        if margin > NEAR_TIE:
            raise SystemExit(f"serve async golden: decision differs at step "
                             f"{stop}, not at a near-tie")
        if stop <= int(gold["train_steps"][0]):
            raise SystemExit(f"serve async golden: a decision flipped at "
                             f"step {stop}, before the first train step")
    worst = 0.0
    for t in range(stop):
        bad, rel = report_diff(got[t], want[t])
        worst = max(worst, rel)
        if bad:
            raise SystemExit(f"serve async golden: step {t} differs in "
                             f"{bad}")
    print(f"decisions equal {int(same[:stop].sum())}/{stop} steps" + (
        "" if stop == n_steps else f"; a near-tie flip at step {stop}: the "
        "comparison stops") + f"; step reports equal, served latencies "
        f"within {worst:.3e} relative (gate {ASYNC_LATENCY_RTOL})")
    want_counts = {"gcn_agg": 4 * (n_steps + n_train),
                   "edge_score": n_steps + n_train, "flash_attention": 0,
                   "decode_attention": 0, "ssm_scan": 0}
    if counts != want_counts:
        raise SystemExit(f"serve async golden: launches {counts}, expected "
                         f"{want_counts}")
    if stop < n_steps:
        print("counts, tokens, row and final params not compared (the run "
              "left the golden one at the flip)")
        return counts
    want_c = {k: int(gold[f"counts/{k}"]) for k in eng.counts}
    want_row = {k[4:]: gold[k].item() for k in gold if k.startswith("row/")}
    row_bad = [k for k in want_row.keys() | row.keys() if k not in row
               or k not in want_row or not (
                   row[k] == want_row[k]
                   if k not in ("latency_p50_s", "latency_p99_s")
                   else abs(row[k] - want_row[k])
                   <= ASYNC_LATENCY_RTOL * want_row[k])]
    print(f"counts {eng.counts} (golden {want_c}), tokens served "
          f"{eng.tokens_served} (golden {int(gold['tokens_served'])}), "
          f"train steps {n_train} (golden {int(gold['train_steps_taken'])})"
          f"; the bench row's fields {row} (golden {want_row})")
    if (eng.counts != want_c or eng.in_flight
            or eng.tokens_served != int(gold["tokens_served"])
            or n_train != int(gold["train_steps_taken"]) or row_bad):
        raise SystemExit(f"serve async golden: counts, tokens, train steps "
                         f"or row fields {row_bad} differ")
    excess, diff = -math.inf, 0.0
    want_p = flatten_dict(tree_of(gold, "final/params"))
    got_p = flatten_dict(eng.agent_state.params)
    for k, w in want_p.items():
        w = torch.tensor(w, device=dev)
        excess = max(excess, close_excess(got_p[k], w, *TRAIN_PARAM_TOL))
        diff = max(diff, float((got_p[k] - w).abs().max()))
    print(f"final params max |diff| {diff:.3e} (rtol {TRAIN_PARAM_TOL[0]} "
          f"atol {TRAIN_PARAM_TOL[1]})")
    if set(got_p) != set(want_p) or not excess <= 0:
        raise SystemExit("serve async golden: final params differ")
    return counts


def serve_bench_phase(dev):
    """45. ``python -m repro_torch.launch serve-bench`` at its defaults,
    in-process, its rows and history in a temporary directory: both rows
    with the reference's keys, 1200 requests each in the rows and by
    each engine's own count of what it served, the bench's own
    assertions (every request served, continuous beats sync on
    requests/s; an AssertionError is fatal) and the same two read from the
    rows; over each timed window exactly gcn_agg 4 and edge_score 1 a
    decision and a train step, and no other kernel; then each engine's
    five actor launches against their plain versions and timed at B=1
    (serve_actor_check). Returns the main windows' launch counts and each
    actor kernel's largest forward error."""
    import tempfile
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_bench
    from repro_torch.obs import HistoryStore
    launcher = __import__("repro_torch.launch.__main__",
                          fromlist=["main"])
    windows = []

    def served(eng, kind):
        """The engine's own count of requests served: the continuous
        engine's counter; the sync engine's tasks priced (its telemetry
        counts one for each request it was handed)."""
        if kind == "continuous":
            return eng.counts["served"]
        return int(eng.telemetry_snapshot()["summary"]["tasks"])

    def counted(run, kind):
        def wrapped(eng, trace):
            step0 = eng.agent_state.host_step
            train0 = int(eng.agent_state.loss_count)
            served0 = served(eng, kind)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            wall = run(eng, trace)
            windows.append(dict(
                kind=kind, engine=eng, requests=len(trace), wall=wall,
                counts=ops.launch_counts(),
                decisions=eng.agent_state.host_step - step0,
                train=int(eng.agent_state.loss_count) - train0,
                served=served(eng, kind) - served0))
            return wall
        return wrapped

    saved = (serve_bench._run_sync, serve_bench._run_continuous,
             os.environ.get("REPRO_HISTORY"))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "bench.json")
        os.environ["REPRO_HISTORY"] = os.path.join(tmp, "history")
        serve_bench._run_sync = counted(saved[0], "sync")
        serve_bench._run_continuous = counted(saved[1], "continuous")
        try:
            t0 = time.perf_counter()
            launcher.main(["serve-bench", "--out", out])
            wall = time.perf_counter() - t0
        finally:
            serve_bench._run_sync, serve_bench._run_continuous = saved[:2]
            if saved[2] is None:
                os.environ.pop("REPRO_HISTORY")
            else:
                os.environ["REPRO_HISTORY"] = saved[2]
        with open(out) as f:
            rows = json.load(f)
        recs = HistoryStore(os.path.join(tmp, "history")).records(
            kind="bench")
    print(f"serve-bench ran in {wall:.2f} s (engines, traces, warm-up and "
          f"both timed windows)")
    for row in rows:
        print(json.dumps(row))
    names = ["serve_sync_slots4", "serve_continuous_slots64"]
    if [r["name"] for r in rows] != names or [r["name"] for r in recs] \
            != names:
        raise SystemExit(f"serve-bench rows {[r['name'] for r in rows]}, "
                         f"history {[r['name'] for r in recs]}")
    sync, cont = rows
    missing = [(r["name"], sorted(keys - set(r)))
               for r, keys in ((sync, BENCH_SYNC_KEYS),
                               (cont, BENCH_CONT_KEYS)) if keys - set(r)]
    if missing:
        raise SystemExit(f"serve-bench rows lack keys {missing}")
    if (sync["backend"] != "cuda" or not sync.get("device_name")
            or not sync.get("power_limit")):
        raise SystemExit(f"serve-bench rows not stamped with the card: "
                         f"{sync}")
    if len(windows) != 4:
        raise SystemExit(f"serve-bench ran {len(windows)} windows, not 4")
    main_sync, main_cont = windows[2], windows[3]
    # the sync row's n_requests is the trace's length, as the reference
    # has it; the engines' own counts show what each served
    if (sync["n_requests"], cont["n_requests"], main_sync["served"],
            main_cont["served"]) != (BENCH_REQUESTS,) * 4:
        raise SystemExit(f"serve-bench rows give {sync['n_requests']} / "
                         f"{cont['n_requests']} requests, the engines "
                         f"served {main_sync['served']} / "
                         f"{main_cont['served']}, not {BENCH_REQUESTS}")
    if not cont["requests_per_s"] > sync["requests_per_s"]:
        raise SystemExit(f"serve-bench: continuous {cont['requests_per_s']} "
                         f"req/s does not beat sync {sync['requests_per_s']}")
    for w in windows:
        n = w["decisions"] + w["train"]
        want = {"gcn_agg": 4 * n, "edge_score": n, "flash_attention": 0,
                "decode_attention": 0, "ssm_scan": 0}
        each = w["wall"] / w["decisions"] * 1e3
        print(f"  {w['kind']:10s} {w['requests']:5d} requests, "
              f"{w['served']} served: {w['decisions']} decisions "
              f"({each:.3f} ms each), {w['train']} train steps, launches "
              f"{w['counts']}")
        if w["counts"] != want:
            raise SystemExit(f"serve-bench {w['kind']} window: launches "
                             f"{w['counts']}, expected {want}")
    print(f"speed-up x{cont['requests_per_s'] / sync['requests_per_s']:.2f} "
          f"(row: x{cont['vs_sync_speedup']}); continuous: "
          f"{main_cont['decisions']} steps, "
          f"{main_cont['wall'] / main_cont['decisions'] * 1e3:.3f} ms a "
          f"step; sync: {main_sync['wall'] / main_sync['decisions'] * 1e3:.3f}"
          f" ms a slot; {card_line()}")
    err = {"gcn_agg": 0.0, "edge_score": 0.0}
    for w in (main_sync, main_cont):
        label = f"bench {w['kind']}"
        for k, e in serve_actor_check(dev, w["engine"], label,
                                      timed=True).items():
            err[k] = max(err[k], e)
    launches = {k: main_sync["counts"][k] + main_cont["counts"][k]
                for k in ("gcn_agg", "edge_score")}
    return launches, err


# ------------------------------------------------------------------ the zoo
def normal_on(gen, dtype, *shape, scale=1.0, shift=0.0):
    """N(shift, scale) from ``gen`` on its device, cast to ``dtype``."""
    return (torch.randn(shape, generator=gen, device=gen.device) * scale
            + shift).to(dtype)


def attn_check(kernel, label, dtype, got, want):
    """A kernel's output against its plain version within ATTN_TOL (atol
    and rtol); returns the max abs error."""
    diff = (got.float() - want.float()).abs()
    tol = ATTN_TOL[dtype]
    err = float(diff.max())
    print(f"  {kernel:16s} {label:40s} {str(dtype)[6:]:8s} max_abs_err "
          f"{err:.3e}", flush=True)
    if not bool((diff <= tol + tol * want.float().abs()).all()):
        raise SystemExit(f"{kernel} {label} {dtype}: kernel differs from "
                         f"plain by more than {tol} (rtol and atol)")
    return err


def timed_row(kernel, label, fn, plain, library, cost, dtype, inner, reps,
              plain_ms=None):
    """Kernel, plain and library times (CUDA-graph replay) and the bound of
    one call, printed; the row of a timed shape."""
    ms = graph_ms(fn, inner=inner, reps=reps)
    if plain_ms is None:
        plain_ms = graph_ms(plain, inner=inner, reps=reps)
    lib_ms = None if library is None else graph_ms(library, inner=inner,
                                                   reps=reps)
    b_ms, b_by = bound(*cost, peak_flops=peak_for(dtype))
    lib = "n/a" if lib_ms is None else f"{lib_ms * 1e3:9.2f} us"
    print(f"  {kernel:16s} {label:40s} kernel {ms * 1e3:9.2f} us  plain "
          f"{plain_ms * 1e3:9.2f} us  library {lib}  bound "
          f"{b_ms * 1e3:8.2f} us ({b_by}, {cost[0] / 1e6:.1f} MB, "
          f"{cost[1] / 1e9:.2f} GFLOP)", flush=True)
    return dict(name=kernel, shape=label, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)


def attention_rows(dev, gen, flash_cases, decode_cases) -> list:
    """flash_attention at ``flash_cases`` (((B, S, H, KVH, d), causal))
    and decode_attention at ``decode_cases`` (((B, H, KVH, d, S), lengths
    "random" from numpy seed SEED in [1, S] or "full")), each in bf16 and
    float32 on N(0, 1) inputs from ``gen``, against their plain versions
    (ATTN_TOL) and, flash in bf16, its emulation (FLASH_EMU_TOL); in bf16
    kernel, plain and library times and the bound. Returns one row per
    shape (its bf16 times, the larger of its two errors)."""
    from repro_torch.kernels import decode_attention as decode_mod
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ref

    rows = []
    for (b, s, h, kvh, d), causal in flash_cases:
        label = f"[{b}, {s}, {h}, {kvh}, {d}] {'causal' if causal else 'no mask'}"
        row, errs = None, []
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (normal_on(gen, dt, b, s, h, d),
                       normal_on(gen, dt, b, s, kvh, d),
                       normal_on(gen, dt, b, s, kvh, d))
            got = flash_mod.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            plain = ref.flash_attention_ref(q, k, v, causal=causal)
            errs.append(attn_check("flash_attention", label, dt, got, plain))
            del plain
            if dt != torch.bfloat16:
                continue
            emu = ref.flash_attention_bf16_emulation(q, k, v, causal=causal)
            e = flash_emu_err(got, emu)
            del emu
            print(f"  {'flash_attention':16s} {label:40s} bfloat16 vs "
                  f"emulation {e:.3e} beyond the output's rounding", flush=True)
            if e > FLASH_EMU_TOL:
                raise SystemExit(f"flash_attention {label}: kernel differs "
                                 f"from its emulation by {e} (limit "
                                 f"{FLASH_EMU_TOL})")
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            row = timed_row(
                "flash_attention", label,
                lambda: flash_mod.flash_attention(q, k, v, causal=causal),
                lambda: ref.flash_attention_ref(q, k, v, causal=causal),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True),
                flash_cost(q, k, None, causal), dt, inner=5, reps=4)
            del qt, kt, vt
        rows.append(dict(row, max_abs_err=max(errs)))
        del q, k, v, got

    lens_rng = np.random.default_rng(SEED)
    for (b, h, kvh, d, s), kind in decode_cases:
        lens = (np.full(b, s) if kind == "full"
                else lens_rng.integers(1, s + 1, size=b))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        label = f"[{b}, {h}, {kvh}, {d}, S={s}] lengths {kind}"
        row, errs = None, []
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (normal_on(gen, dt, b, h, d),
                       normal_on(gen, dt, b, s, kvh, d),
                       normal_on(gen, dt, b, s, kvh, d))
            got = decode_mod.decode_attention(q, k, v, lengths)
            torch.cuda.synchronize()
            errs.append(attn_check("decode_attention", label, dt, got,
                                   ref.decode_attention_ref(q, k, v,
                                                            lengths)))
            if dt != torch.bfloat16:
                continue
            mask = (torch.arange(s, device=dev)[None, :]
                    < lengths[:, None])[:, None, None, :]
            q4, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
            row = timed_row(
                "decode_attention", label,
                lambda: decode_mod.decode_attention(q, k, v, lengths),
                lambda: ref.decode_attention_ref(q, k, v, lengths),
                lambda: F.scaled_dot_product_attention(
                    q4, kt, vt, attn_mask=mask, enable_gqa=True),
                decode_cost(q, k, lengths), dt, inner=20, reps=10)
        rows.append(dict(row, max_abs_err=max(errs)))
    return rows


def zoo_kernels_phase(dev):
    """Phase 28: flash_attention, decode_attention and ssm_scan at the
    zoo's new shapes against their plain versions (ATTN_TOL, SSM_TOL) and,
    in bf16, their emulations (FLASH_EMU_TOL; ref.SSM_EMU_TOL and
    SSM_EMU_STATE_TOL); in bf16 kernel (CUDA-graph replay), plain and
    library times and the bound. Returns one row per timed shape."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ssm_mod

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def normal(dtype, *shape, scale=1.0, shift=0.0):
        return normal_on(gen, dtype, *shape, scale=scale, shift=shift)

    rows = attention_rows(dev, gen, ((ZAMBA_ATTN, True), (WHISPER_ENC, False)),
                          ((ZAMBA_DECODE, "random"), (WHISPER_CROSS, "full")))

    # ssm_scan with Mamba-2's read-out (no bonus) at Zamba2's prefill
    # shape: one decay per head, as Mamba-2's dt a; fast decays, then slow
    # ones from a nonzero state
    b, t, h, dk, dv, c = MAMBA_SCAN
    dt = torch.bfloat16
    for slow in (False, True):
        q, k, v = normal(dt, b, t, h, dk), normal(dt, b, t, h, dk), \
            normal(dt, b, t, h, dv)
        log_w = -torch.exp(normal(torch.float32, b, t, h, 1, scale=0.5,
                                  shift=-5.0 if slow else 0.0))
        log_w = log_w.expand(b, t, h, dk).contiguous()
        s0 = normal(torch.float32, b, h, dk, dv) if slow else None
        label = (f"[{b}, {t}, {h}, {dk}, {dv}] chunk {c} mamba "
                 f"{'slow' if slow else 'fast'}")
        y, st = ssm_mod.ssm_scan(q, k, v, log_w, None, chunk=c,
                                 initial_state=s0)
        torch.cuda.synchronize()
        want_y, want_s = ref.ssm_scan_ref(q, k, v, log_w, initial_state=s0)
        err_y, err_s = scan_err(y, want_y), scan_err(st, want_s, True)
        emu_y, emu_s = ref.ssm_scan_bf16_emulation(
            q, k, v, log_w, chunk=c, initial_state=s0)
        emu_err_y = ref.ssm_emu_err(y, emu_y)
        emu_err_s = ref.ssm_emu_err(st, emu_s, state=True)
        abs_err = float((y.float() - want_y.float()).abs().max())
        print(f"  ssm_scan {label:44s} bfloat16 err y {err_y:.3e} state "
              f"{err_s:.3e} (limits {SSM_TOL[dt]}, {SSM_TOL[torch.float32]});"
              f" vs emulation y {emu_err_y:.3e} state {emu_err_s:.3e} "
              f"(limits {ref.SSM_EMU_TOL}, {ref.SSM_EMU_STATE_TOL}); max abs "
              f"error {abs_err:.3e}", flush=True)
        if (not err_y <= SSM_TOL[dt] or not err_s <= SSM_TOL[torch.float32]
                or not emu_err_y <= ref.SSM_EMU_TOL
                or not emu_err_s <= ref.SSM_EMU_STATE_TOL):
            raise SystemExit(f"ssm_scan {label}: kernel differs from plain or "
                             f"its emulation beyond the limits")
        del emu_y, emu_s, want_s
        if not slow:
            plain_ms = event_ms(lambda: ref.ssm_scan_ref(q, k, v, log_w))
            rows.append(dict(timed_row(
                "ssm_scan", label,
                lambda: ssm_mod.ssm_scan(q, k, v, log_w, None, chunk=c),
                None, None, ssm_cost(q, v, log_w, None, None), dt, inner=5,
                reps=4, plain_ms=plain_ms), max_abs_err=abs_err))
        del q, k, v, log_w, y, st, want_y
    torch.cuda.empty_cache()
    return rows


def _first(tree):
    """Layer 0 of a stacked param dict."""
    if isinstance(tree, dict):
        return {k: _first(v) for k, v in tree.items()}
    return tree[0]


def zoo_golden_phase(dev):
    """Phase 29: the reduced zoo's JAX runs (tests/data/
    torch_lm_zoo_golden.npz, f32) through the port on the card: prefill
    logits and every exit's serve logits within LM_GOLDEN_TOL of 1 + |ref|,
    layer 0's MoE expert choices and kept slots equal."""
    from repro_torch.configs import get_arch
    from repro_torch.core.bridge import lm_params_from_numpy, lm_params_numpy
    from repro_torch.kernels import ops
    from repro_torch.models import EncDecLM, model_for
    from repro_torch.models.ffn import MoEFFN
    from repro_torch.nn import Embedding
    from repro_torch.train import make_prefill_step, make_serve_step

    with np.load(ZOO_GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    reduced = {k.split("/")[1]: int(gold[k]) for k in gold
               if k.startswith("reduced/")}
    errs = {}

    def err(got, key):
        want = torch.tensor(gold[key], device=dev)
        return float(((got.float() - want).abs() / (1 + want.abs())).max())

    for arch in (str(a) for a in gold["archs"]):
        cfg = get_arch(arch).reduced(**reduced)
        model = model_for(cfg)
        params = lm_params_from_numpy(
            lm_params_numpy(cfg, int(gold["seed"])), cfg, dev)
        toks = torch.tensor(gold[f"{arch}/tokens"], device=dev)
        b = toks.shape[0]
        batch, audio = {"tokens": toks}, None
        if cfg.enc_layers:
            audio = torch.tensor(np.random.default_rng(
                int(gold["audio_seed"])).standard_normal(
                (b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32),
                device=dev)
            batch["audio"] = audio
        ops.reset_launch_counts()
        out = make_prefill_step(cfg)(params, batch)
        counts = ops.launch_counts()
        errs[f"{arch}/prefill/logits"] = err(
            out if cfg.enc_layers else out[0], f"{arch}/prefill/logits")
        line = f"  {arch}: prefill launches {counts}"
        if cfg.is_moe:
            x = Embedding.apply(params["embed"], toks)
            _, idx, _, _, _, keep = MoEFFN.route(
                _first(params["blocks"]["ffn"]), cfg, x)
            want_idx = torch.tensor(gold[f"{arch}/experts"], device=dev)
            want_keep = torch.tensor(gold[f"{arch}/keep"], device=dev)
            same = int((idx == want_idx).all(-1).sum())
            line += (f"; layer 0's expert choices equal for {same}/"
                     f"{idx.shape[0] * idx.shape[1]} tokens, kept slots "
                     f"{int((keep == want_keep).sum())}/{keep.numel()}")
            if not (torch.equal(idx, want_idx.to(idx.dtype))
                    and torch.equal(keep, want_keep)):
                raise SystemExit(f"zoo golden {arch}: MoE routing differs")
        print(line, flush=True)
        n = int(gold["serve_len"])
        for e in (int(x) for x in gold[f"{arch}/exits"]):
            step = make_serve_step(cfg, exit_layer=e)
            c = model.init_cache(cfg, b, n, device=dev)
            if cfg.enc_layers:
                c["enc_out"] = EncDecLM.encode(params, cfg, audio)
            got = []
            for i in range(n):
                lg, c = step(params, c, toks[:, i],
                             torch.full((b,), i, dtype=torch.int64,
                                        device=dev))
                got.append(lg)
            errs[f"{arch}/serve/logits_{e}"] = err(
                torch.stack(got), f"{arch}/serve/logits_{e}")
        del params
    for k, v in errs.items():
        print(f"  {k:36s} max |d| / (1 + |ref|) {v:.3e}")
    worst = max(errs.values())
    if not worst <= LM_GOLDEN_TOL:
        raise SystemExit(f"zoo golden: error {worst} above {LM_GOLDEN_TOL}")
    return worst


def zoo_launches(cfg, *, prefill: bool, exit_layer=None) -> dict:
    """The hand kernels' launches of one prefill, or of one serve_step at
    ``exit_layer``: flash_attention per GQA layer (Zamba2: per shared-block
    application; Whisper: per encoder and decoder layer), ssm_scan per
    Mamba-2 layer in prefill; decode_attention per GQA layer that runs
    (Whisper: self- and cross-attention); MLA none."""
    from repro_torch.models.blocks import block_kind
    from repro_torch.models.lm import n_shared_applications

    kind, gqa = block_kind(cfg), cfg.attn_kind == "gqa"
    e = exit_layer or cfg.n_layers
    if prefill:
        flash = {"mamba2": n_shared_applications(cfg),
                 "encdec": cfg.enc_layers + cfg.n_layers,
                 "attn": cfg.n_layers if gqa else 0}[kind]
        return {"flash_attention": flash, "decode_attention": 0,
                "ssm_scan": cfg.n_layers if kind == "mamba2" else 0}
    every = cfg.shared_attn_every
    dec = {"mamba2": e // every if every else 0, "encdec": 2 * e,
           "attn": e if gqa else 0}[kind]
    return {"flash_attention": 0, "decode_attention": dec, "ssm_scan": 0}


def zoo_model_phase(dev, arch, batch, seq, layers):
    """Phase 30, one model: full width in bf16 (random weights from seed
    0, its depth cut to ``layers`` if given): a prefill of [batch, seq]
    tokens (Whisper: the encoder over [batch, 1500] frames, then the
    decoder's dense pass), greedy decoding of SERVE_B requests at each exit
    against a SERVE_CACHE-row cache, and prefill against teacher-forced
    decode (zoo_consistency) within CONSIST_TOL in bf16 at layer 0
    (Whisper: its logits) and in float32 on fresh weights (ZOO_F32_LAYERS)
    at every layer; the hand kernels' launches exactly as zoo_launches
    counts them. Returns (launch totals, a summary row)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import EncDecLM, model_for
    from repro_torch.train import make_prefill_step, make_serve_step

    t_phase = time.perf_counter()
    cfg = get_arch(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers, exit_layers=())
    model = model_for(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = model.init(gen, cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"{cfg.arch_id}: {cfg.n_layers} layers"
          f"{f' (of {get_arch(arch).n_layers}: depth cut)' if layers else ''}"
          f", d_model {cfg.d_model}, exits {cfg.exit_layers}, {cfg.dtype}; "
          f"{n_params / 1e9:.3f} B params ({n_params * 2 / 1e9:.1f} GB), "
          f"drawn in {time.perf_counter() - t0:.2f} s; memory allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB", flush=True)
    totals = {"flash_attention": 0, "decode_attention": 0, "ssm_scan": 0}
    row = {"arch": cfg.arch_id, "layers": cfg.n_layers,
           "params_b": n_params / 1e9}

    def audio(b):
        return torch.randn((b, cfg.n_audio_frames, cfg.d_model),
                           generator=gen, device=dev).to(cfg.torch_dtype)

    # prefill
    prefill = make_prefill_step(cfg)
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                         device=dev)
    inputs = {"tokens": toks}
    if cfg.enc_layers:
        inputs["audio"] = audio(batch)
    prefill(params, dict(inputs, tokens=toks[:, :128]))      # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = prefill(params, inputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    logits = out if cfg.enc_layers else out[0]
    want = zoo_launches(cfg, prefill=True)
    print(f"  prefill B={batch} S={seq}"
          f"{f' (encoder over {cfg.n_audio_frames} frames)' if cfg.enc_layers else ''}"
          f": {wall * 1e3:.3f} ms, {batch * seq / wall:.1f} prompt tokens/s;"
          f" launches {counts}, expected {want}", flush=True)
    if {k: counts[k] for k in want} != want or counts["gcn_agg"] \
            or counts["edge_score"]:
        raise SystemExit(f"{arch} prefill: launches {counts}, expected "
                         f"{want}")
    if (tuple(logits.shape) != (batch, cfg.vocab)
            or not bool(torch.isfinite(logits).all())):
        raise SystemExit(f"{arch} prefill: logits malformed")
    for k in totals:
        totals[k] += counts[k]
    row.update(prefill_ms=wall * 1e3, prompt_tok_s=batch * seq / wall)
    del out, logits
    torch.cuda.empty_cache()

    # greedy decoding at every exit
    rng = np.random.default_rng(SEED)
    lens = rng.integers(ZOO_PROMPT_LENS[0], ZOO_PROMPT_LENS[1] + 1,
                        size=SERVE_B)
    total = int(lens.max()) + ZOO_NEW
    mat = np.zeros((SERVE_B, total), np.int64)
    for i, n in enumerate(lens):
        mat[i, :n] = rng.integers(0, cfg.vocab, size=n)
    prompt_mat = torch.tensor(mat, device=dev)
    enc_out = (EncDecLM.encode(params, cfg, audio(SERVE_B))
               if cfg.enc_layers else None)

    def fresh_cache(b, rows, enc=None):
        cache = model.init_cache(cfg, b, rows, device=dev)
        if enc is not None:
            cache["enc_out"].copy_(enc)
        return cache

    greedy_decode(params, make_serve_step(cfg), fresh_cache(
        SERVE_B, SERVE_CACHE, enc_out), prompt_mat[:, :3], lens.clip(max=3),
        0)                                                     # warm-up
    row["decode_ms"] = {}
    for e in cfg.exit_layers:
        step = make_serve_step(cfg, exit_layer=e)
        cache = fresh_cache(SERVE_B, SERVE_CACHE, enc_out)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        outs, steps = greedy_decode(params, step, cache, prompt_mat, lens,
                                    ZOO_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        want = {k: v * steps
                for k, v in zoo_launches(cfg, prefill=False,
                                         exit_layer=e).items()}
        print(f"  exit {e:2d}: {wall / steps * 1e3:8.3f} ms/step, "
              f"{SERVE_B * ZOO_NEW / wall:9.1f} generated tokens/s "
              f"({steps} steps), launches {counts}", flush=True)
        if {k: counts[k] for k in want} != want:
            raise SystemExit(f"{arch} exit {e}: launches {counts}, expected "
                             f"{want}")
        if any(len(o) != ZOO_NEW or o.min() < 0 or o.max() >= cfg.vocab
               for o in outs):
            raise SystemExit(f"{arch} exit {e}: generated tokens malformed")
        if any(bool(f[e:].any()) for f in cache["layers"]):
            raise SystemExit(f"{arch} exit {e}: a layer past the exit wrote "
                             f"its cache")
        for k in totals:
            totals[k] += counts[k]
        row["decode_ms"][e] = wall / steps * 1e3
        del cache
    row["gen_tok_s_last_exit"] = SERVE_B * ZOO_NEW / wall

    # prefill against teacher-forced decode on the same tokens: bf16, then
    # float32 on fresh weights
    errs = zoo_consistency(dev, cfg, model, params, gen)
    gated = {k: v for k, v in errs.items()
             if (k == "logits" and cfg.enc_layers)
             or (k.startswith("layers.") and k.endswith("[0]"))}
    worst = max(gated.values())
    if not worst <= CONSIST_TOL:
        raise SystemExit(f"{arch} consistency (bf16, {sorted(gated)}): "
                         f"relative L2 {worst} above {CONSIST_TOL}")
    row["consistency_bf16"] = errs
    del params
    torch.cuda.empty_cache()
    f32_layers = ZOO_F32_LAYERS[arch]
    cfg32 = dataclasses.replace(
        cfg, dtype="float32",
        **({"n_layers": f32_layers, "exit_layers": ()} if f32_layers else {}))
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), cfg32,
                        device=dev)
    errs = zoo_consistency(dev, cfg32, model, params, gen)
    worst = max(errs.values())
    if not worst <= CONSIST_TOL:
        raise SystemExit(f"{arch} consistency (float32): relative L2 "
                         f"{worst} above {CONSIST_TOL}")
    row["consistency_f32"] = errs
    del params
    torch.cuda.empty_cache()
    print(f"  {arch} wall {time.perf_counter() - t_phase:.2f} s", flush=True)
    return totals, row


def zoo_consistency(dev, cfg, model, params, gen) -> dict:
    """A ZOO_CONSIST_P-token prefill at B = CONSIST_B against the same
    tokens teacher-forced through serve_step (the MoE models with the capacity
    raised to ZOO_CONSIST_CF): relative L2 of the last logits and of the
    first and last layer's caches (and the shared block's first and last
    application's), printed; returned by name (``layers.k[0]``, ...)."""
    from repro_torch.models import DecoderLM, EncDecLM
    from repro_torch.train import make_prefill_step, make_serve_step

    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=ZOO_CONSIST_CF)
    toks = torch.randint(0, cfg.vocab, (CONSIST_B, ZOO_CONSIST_P),
                         generator=gen, device=dev)
    cache_p, enc = None, None
    if cfg.enc_layers:
        audio = torch.randn((CONSIST_B, cfg.n_audio_frames, cfg.d_model),
                            generator=gen, device=dev).to(cfg.torch_dtype)
        enc = EncDecLM.encode(params, cfg, audio)
        hiddens, _ = EncDecLM._decode_dense(params["decoder"], cfg, toks, enc)
        logits_p = DecoderLM.logits(params["decoder"],
                                    hiddens[cfg.n_layers][:, -1])
    else:
        logits_p, cache_p = make_prefill_step(cfg)(params, {"tokens": toks})
    step = make_serve_step(cfg)
    cache_d = model.init_cache(cfg, CONSIST_B, ZOO_CONSIST_P, device=dev)
    if enc is not None:
        cache_d["enc_out"].copy_(enc)
    for t in range(ZOO_CONSIST_P):
        logits_d, cache_d = step(params, cache_d, toks[:, t],
                                 torch.full((CONSIST_B,), t,
                                            dtype=torch.int64, device=dev))
    errs = {"logits": rel_l2(logits_d, logits_p)}
    for part in ("layers", "shared"):
        if cache_p is None or part not in cache_p:
            continue
        for f, got, want in zip(cache_p[part]._fields, cache_d[part],
                                cache_p[part]):
            for i in sorted({0, got.shape[0] - 1}):
                errs[f"{part}.{f}[{i}]"] = rel_l2(got[i], want[i])
    print(f"  relative L2, decode vs prefill ({cfg.dtype}, {cfg.n_layers} "
          f"layers, {CONSIST_B} x {ZOO_CONSIST_P} tokens"
          f"{f', capacity factor {ZOO_CONSIST_CF}' if cfg.is_moe else ''}): "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()), flush=True)
    return errs



def zoo_serve_phase(dev):
    """Phase 31, the slice's main path: ``python -m repro_torch.launch.serve
    --arch zamba2_2_7b --slots 10 --decode`` in-process (its engine and
    requests, launch/serve.py's make_engine and slot_requests): Zamba2-2.7B
    at full width behind EdgeServingEngine, GRLE choosing replica and exit
    for 4 requests a slot. Launches exactly: gcn_agg 4 and edge_score 1 a
    decision plus 4 and 1 a train step; decode_attention, per exit group,
    (shared-block applications below its exit) x (positions it decodes).
    Then the actor launches and decode_attention at the engine's shapes
    against their plain versions, and the slots again without decoding."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as cli

    args = cli.parse_args(list(ZOO_SERVE_ARGS))
    t0 = time.perf_counter()
    eng = cli.make_engine(args)
    torch.cuda.synchronize()
    cfg = eng.cfg
    every = cfg.shared_attn_every
    print(f"python -m repro_torch.launch.serve {' '.join(ZOO_SERVE_ARGS)}: "
          f"{cfg.arch_id}, {cfg.dtype}, exits {cfg.exit_layers}, shared block"
          f" every {every} layers; exit table ms "
          f"{np.round(eng.exit_times * 1e3, 4).tolist()}; engine built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(args.seed)
    positions = cli.PROMPT_LEN + cli.MAX_NEW
    ops.reset_launch_counts()
    want = {"gcn_agg": 0, "edge_score": 0, "flash_attention": 0,
            "decode_attention": 0, "ssm_scan": 0}
    walls, shapes = [], {}
    for slot in range(args.slots):
        reqs = cli.slot_requests(rng, cfg.vocab, args.batch)
        due = eng.agent_def.train_due(eng.agent_state, 1)
        t0 = time.perf_counter()
        assignments, info = eng.serve_slot(reqs, decode=args.decode)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        want["gcn_agg"] += 4 + 4 * due
        want["edge_score"] += 1 + due
        groups = {}
        for _, e in assignments:
            groups[e] = groups.get(e, 0) + 1
        for e, n in groups.items():
            want["decode_attention"] += e // every * positions
            shapes[n] = positions
        line = ", ".join(f"{r}@exit{e}" for r, e in assignments)
        print(f"slot {slot:3d} reward {info['reward']:.3f}  [{line}]  "
              f"{walls[-1] * 1e3:.1f} ms", flush=True)
        if any(len(t) != cli.MAX_NEW or min(t) < 0 or max(t) >= cfg.vocab
               for t in info["texts"]):
            raise SystemExit("zoo serve: generated tokens malformed")
    counts = ops.launch_counts()
    print(f"summary: {eng.metrics.summary()}")
    print(f"decode=True: slot ms mean {np.mean(walls) * 1e3:.3f}, median "
          f"{np.median(walls) * 1e3:.3f}, min {min(walls) * 1e3:.3f}, max "
          f"{max(walls) * 1e3:.3f}; launches {counts}, expected {want}")
    if (counts != want or not counts["gcn_agg"] or not counts["edge_score"]
            or not counts["decode_attention"]):
        raise SystemExit(f"zoo serve launches {counts}, expected {want}")
    serve_actor_check(dev, eng, "zamba2")
    serve_decode_check(dev, cfg, shapes)
    walls = []
    for _ in range(args.slots):
        reqs = cli.slot_requests(rng, cfg.vocab, args.batch)
        t0 = time.perf_counter()
        eng.serve_slot(reqs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"decode=False: slot ms mean {np.mean(walls) * 1e3:.3f}, median "
          f"{np.median(walls) * 1e3:.3f}")
    del eng
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------------------------ phases
# --------------------------------------------------------------- population
def pop_trainer(dev, data=None, **kw):
    """The port's ``PopulationTrainer`` of ``tests/data/
    torch_pop_golden.npz`` (its ``POP`` config), or with ``kw`` another
    one on fig5_baseline..fig8_csi."""
    from repro_torch.core import agent_def
    from repro_torch.mec import MECEnv, make_scenario
    from repro_torch.mec.scenarios import scenario_space
    from repro_torch.pop import Curriculum, PopulationTrainer
    c = dict(POP_GOLDEN_CONFIG, **kw)
    env = MECEnv(make_scenario(c["space"][0], n_devices=c["n_devices"]),
                 device=dev)
    adef = agent_def(c["method"], env, device=dev)
    space = scenario_space(*c["space"], n_devices=c["n_devices"], device=dev)
    tr = PopulationTrainer(
        adef, Curriculum(space.lo, space.hi, n_regions=c["regions"]),
        n_members=c["members"], n_fleets=c["fleets"], n_slots=c["slots"],
        seed=c["seed"], replay_capacity=c["replay"], batch_size=c["batch"],
        train_every=c["train_every"], telemetry=c.get("telemetry", True))
    return tr, space


def pop_golden_draws(gold, g, dev):
    """Generation ``g``'s draws of the population golden file, as the
    trainer takes them."""
    from repro_torch.mec import SlotTasks
    from repro_torch.pop.pbt import PBTDraws
    from repro_torch.pop.trainer import GenerationDraws
    from repro_torch.rollout import SlotDraws

    def t(x, dtype=None):
        return torch.tensor(np.asarray(x), device=dev, dtype=dtype)

    pre = f"gen{g}"
    members = [SlotDraws(
        SlotTasks(*(t(gold[f"{pre}/m{i}/tasks/{f}"])
                    for f in SlotTasks._fields)), None,
        t(gold[f"{pre}/m{i}/replay_take"], torch.int64),
        gumbel=t(gold[f"{pre}/m{i}/gumbel"]))
        for i in range(POP_GOLDEN_CONFIG["members"])]
    return GenerationDraws(
        region=t(gold[f"{pre}/region"]), offset=t(gold[f"{pre}/offset"]),
        members=members, pbt=PBTDraws(*(t(gold[f"{pre}/pbt/{k}"])
                                        for k in ("up", "gain", "tau"))))


def pop_golden_phase(dev):
    """25. ``tests/data/torch_pop_golden.npz`` (a JAX ``PopulationTrainer``
    run with its draws) through the port's trainer on the card."""
    from repro_torch.nn.pytree import flatten_dict
    from repro_torch.obs.telemetry import telemetry_host
    from repro_torch.pop import MemberHypers
    t0 = time.perf_counter()
    with np.load(POP_GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    c = POP_GOLDEN_CONFIG
    tr, _ = pop_trainer(dev)
    ts = tr.init_state()
    init = tree_of(gold, "init/params")
    params = {layer: {leaf: torch.tensor(init[layer][leaf], device=dev)
                      for leaf in leaves}
              for layer, leaves in ts.pop.agents.params.items()}
    hyp = MemberHypers(*(torch.tensor(gold[f"init/hypers/{f}"], device=dev)
                         for f in MemberHypers._fields))
    ts = ts._replace(pop=ts.pop._replace(
        agents=ts.pop.agents._replace(params=params), hypers=hyp))
    print(f"P={c['members']} B={c['fleets']} T={c['slots']} M="
          f"{c['n_devices']} regions {c['regions']}, {c['generations']} "
          f"generations, PBT every generation")
    for g in range(c["generations"]):
        pre = f"gen{g}"
        ts, rep, det = tr.generation(ts, draws=pop_golden_draws(gold, g, dev),
                                     detail=True)
        for i, trace in enumerate(det.traces):
            dec = trace.decisions.cpu().numpy()
            diff = np.argwhere((dec != gold[f"{pre}/m{i}/decisions"])
                               .any(-1))
            for t, b in diff:
                margin = min(float(gold[f"{pre}/m{i}/{k}"][t, b])
                             for k in ("q_margin", "xhat_margin"))
                margin = min(margin, float(gold[f"{pre}/m{i}/cand_margin"]
                                           [t, b]))
                print(f"  gen {g} member {i} slot {t} fleet {b}: margin "
                      f"{margin:.3e}")
                if margin > NEAR_TIE:
                    raise SystemExit(f"pop golden: gen {g} member {i} "
                                     f"decision differs at slot {t}, not at "
                                     f"a near-tie")
            if diff.size:
                print(f"pop golden: a near-tie flip in gen {g} member {i}: "
                      f"the comparison stops")
                return
        errs = {k: float(np.abs(det.metrics[k].cpu().numpy()
                                - gold[f"{pre}/mets/{k}"]).max())
                for k in ("avg_reward", "ssp", "avg_accuracy")}
        stats = {k: getattr(det.stats, k).cpu().numpy()
                 for k in ("src", "copied", "ranks")}
        hyp_err = max(float(np.abs(getattr(ts.pop.hypers, f).cpu().numpy()
                                   - gold[f"{pre}/hypers/{f}"]).max())
                      for f in MemberHypers._fields)
        cur_err = max(float(np.abs(getattr(ts.cur, f).cpu().numpy()
                                   - gold[f"{pre}/cur/{f}"]).max())
                      for f in ("score", "visits"))
        print(f"gen {g}: decisions {c['members']} x {c['slots']} x "
              f"{c['fleets']} equal; metric errors {errs}; src "
              f"{stats['src'].tolist()} ranks {stats['ranks'].tolist()}; "
              f"hypers error {hyp_err:.3e}; curriculum error {cur_err:.3e}; "
              f"region visits {rep['region_visits']}")
        if (max(errs.values()) > POP_METRIC_TOL
                or any((stats[k] != gold[f"{pre}/stats/{k}"]).any()
                       for k in stats)
                or hyp_err > POP_HYPER_TOL or cur_err > POP_HYPER_TOL
                or rep["region_visits"]
                != gold[f"{pre}/report/region_visits"].tolist()):
            raise SystemExit(f"pop golden: generation {g} differs")
    want = flatten_dict(tree_of(gold, "final/params"))
    got = flatten_dict(ts.pop.agents.params)
    excess = max(close_excess(got[k].cpu(), torch.tensor(w),
                              *TRAIN_PARAM_TOL) for k, w in want.items())
    err = max(float((got[k].cpu() - torch.tensor(w)).abs().max())
              for k, w in want.items())
    counters = telemetry_host(tr.telemetry)["counters"]
    print(f"final params: max abs error {err:.3e} (rtol "
          f"{TRAIN_PARAM_TOL[0]} atol {TRAIN_PARAM_TOL[1]}); telemetry "
          f"{counters}")
    if not excess <= 0 or any(counters[k] != float(gold[f"telemetry/{k}"])
                              for k in counters):
        raise SystemExit("pop golden: final params or telemetry differ")
    print(f"phase 25 wall {time.perf_counter() - t0:.2f} s")


def same_leaves(a, b) -> bool:
    """Every tensor of two trees equal bit for bit (NaN equal to NaN)."""
    from repro_torch.nn.pytree import tree_tensors
    xs, ys = tree_tensors(a), tree_tensors(b)
    return len(xs) == len(ys) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and bool(((x == y) | (x != x) & (y != y)).all())
        for x, y in zip(xs, ys))


def pop_phase(dev):
    """26. ``PopulationTrainer`` at the paper's width: builds, launches per
    member-episode, resume, losses, DROOE; generation times."""
    from repro_torch.mec.scenarios import interpolate_params
    from repro_torch.obs import CompileTracker
    from repro_torch.pop.population import (exit_mask_from_tau, hypers_row,
                                            member_seed, member_state)
    from repro_torch.train import restore_population, save_population
    t_phase = time.perf_counter()
    c = POP_FULL
    tr, space = pop_trainer(dev, **c)
    drv = tr.driver.drv
    print(f"GRLE M={c['n_devices']} N=2 L=5 hidden {drv.adef.hidden}, "
          f"{c['space'][0]}..{c['space'][1]} in {c['regions']} regions, "
          f"P={c['members']} x {c['fleets']} fleet x {c['slots']} slots, "
          f"ring {c['replay']} minibatch {c['batch']} omega "
          f"{c['train_every']}, {POP_GENERATIONS} generations")
    ckpt = os.path.join(ROOT, "build", "chip_smoke_pop.ckpt")
    states, walls = [], []
    with CompileTracker() as ct:
        ts = tr.init_state()
        for g in range(POP_GENERATIONS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ts, rep = tr.generation(ts)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            states.append(ts)
            m = rep["metrics"]
            print(f"  gen {g}: {walls[-1]:.4f} s, reward mean "
                  f"{m['mean_reward']:.4f} best {m['best_reward']:.4f} "
                  f"(member {rep['best_member']}) ssp {m['mean_ssp']:.4f} "
                  f"accuracy {m['mean_accuracy']:.4f} exploits "
                  f"{int(m['exploits'])} regions {rep['region_visits']}",
                  flush=True)
            if g == 0:
                save_population(ckpt, ts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evals = []
        for i, t in enumerate(POP_EVAL_POINTS):
            mets = tr.evaluate(ts.pop, (c["seed"], i),
                               interpolate_params(space.lo, space.hi, t))
            evals.append(float(mets["avg_reward"].mean()))
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
    built = ct.by_label()
    n_ep = c["members"] * POP_GENERATIONS
    print(f"CompileTracker: {ct.summary()}; by label {built}")
    if ((built.get("pop_episode", {}).get("episodes"),
         built.get("pop_episode", {}).get("graphs")) != (1, 2)
            or (built.get("pop_eval", {}).get("episodes"),
                built.get("pop_eval", {}).get("graphs")) != (1, 1)):
        raise SystemExit(f"pop: {built}, expected one episode and two "
                         f"graphs for pop_episode over {n_ep} "
                         f"member-episodes, one and one for pop_eval")
    slots = c["members"] * c["slots"]
    for g, w in enumerate(walls):
        print(f"  gen {g}: {w:.4f} s, {slots / w:.1f} member-slots/s, "
              f"{w / slots * 1e3:.4f} ms a slot per member")
    print(f"first generation's build and capture: "
          f"{built['pop_episode']['seconds']:.4f} s; evaluation at t = "
          f"{list(POP_EVAL_POINTS)}: {eval_s:.4f} s (its build and capture "
          f"{built['pop_eval']['seconds']:.4f} s), mean rewards "
          f"{[round(e, 6) for e in evals]}")

    # launches over one member-episode's replays
    pop = ts.pop
    agent = member_state(pop.agents, 0)._replace(
        exit_mask=exit_mask_from_tau(tr.adef, pop.hypers.exit_tau[0]))
    sp = interpolate_params(space.lo, space.hi, 0.5)
    plan, _ = drv._schedule(drv.adef.episode_state(agent), c["slots"])
    n_train = sum(due for due, _, _ in plan)
    (_, _), ours, graphs = profiled_call(lambda: drv.run(
        member_seed((c["seed"], 9), 0), c["slots"], agent_state=agent,
        sp=sp, hypers=hypers_row(pop.hypers, 0)))
    n = c["slots"] + n_train
    want = {"gcn_agg": 4 * n, "edge_score": n}
    print(f"one member-episode: actor kernels {ours} (expected {want}: "
          f"{c['slots']} slots + {n_train} train steps), {graphs} graph "
          f"launches")
    if ours != want or graphs != c["slots"] or drv.episodes_built != 1:
        raise SystemExit(f"pop: launches {ours}, expected {want}")

    # resume: generation 0, checkpoint, restore into a fresh trainer, one
    # more generation == two uninterrupted ones
    fresh, _ = pop_trainer(dev, **c)
    restored = restore_population(ckpt, like=fresh.init_state())
    if not same_leaves(restored, states[0]):
        raise SystemExit("pop: the restored checkpoint differs from the "
                         "state it saved")
    resumed, _ = fresh.generation(restored)
    if not same_leaves(resumed, states[1]):
        raise SystemExit("pop: a resumed generation differs from the "
                         "uninterrupted run")
    print("resume: generation 0, save_population, restore_population into a "
          "fresh trainer, generation 1: every leaf equal to the "
          "uninterrupted run's bit for bit")
    del fresh, restored, resumed

    loss = ts.pop.agents.last_loss.cpu().numpy()
    print(f"final losses {np.round(loss, 6).tolist()}")
    if not np.isfinite(loss).all():
        raise SystemExit("pop: a member's final loss is not finite")

    # DROOE: the MLP actor launches no actor kernel
    droo, _ = pop_trainer(dev, **dict(c, method="drooe", members=4))
    (_, rep), ours, _ = profiled_call(
        lambda: droo.generation(droo.init_state()))
    print(f"DROOE P=4, one generation: actor kernels {ours}, reward mean "
          f"{rep['metrics']['mean_reward']:.4f}")
    if ours != {"gcn_agg": 0, "edge_score": 0}:
        raise SystemExit(f"pop DROOE: launches {ours}, expected none")
    print(f"phase 26 wall {time.perf_counter() - t_phase:.2f} s")


# phase 27's profiled episodes: 80 slots each, cut from the CLI's 200 to
# keep the script inside its time limit (reading the trace was most of
# the phase)
PROFILE_CLI_SLOTS = 80


def obs_phase(dev):
    """27. The profile CLI's trace and run log; hot program costs, card and
    CPU."""
    import shutil
    from repro_torch.obs import hot_program_costs, read_events
    t0 = time.perf_counter()
    out = os.path.join(ROOT, "build", "chip_smoke_profile")
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.profile", "--devices",
           "14", "--episodes", "2", "--slots", str(PROFILE_CLI_SLOTS),
           "--trace", "--out", out]
    p = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=600)
    print(p.stdout.strip())
    if p.returncode:
        print(p.stderr[-4000:])
        raise SystemExit(f"profile CLI exited {p.returncode}")
    events = read_events(os.path.join(out, "events.jsonl"))
    kinds = [e["event"] for e in events]
    compile_ev = events[-1]
    with open(os.path.join(out, "trace", "trace.json")) as f:
        trace = json.load(f)["traceEvents"]
    kernels = sum(1 for e in trace if e.get("cat") == "kernel"
                  and "gcn_agg_kernel" in e.get("name", ""))
    spans = sorted({e["name"] for e in trace
                    if str(e.get("name", "")).startswith("obs/")})
    print(f"run log events {kinds}; compile "
          f"{compile_ev.get('n_backend_compiles')} episodes, "
          f"{compile_ev.get('n_graphs_captured')} graphs; trace "
          f"{len(trace)} events, {kernels} gcn_agg kernel records, spans "
          f"{spans}")
    if (kinds != ["manifest", "episode", "episode", "compile"]
            or (compile_ev.get("n_backend_compiles"),
                compile_ev.get("n_graphs_captured")) != (1, 2)
            or not kernels or not spans):
        raise SystemExit("profile CLI: run log or trace malformed")
    shutil.rmtree(out, ignore_errors=True)

    card = hot_program_costs(quick=True, device=dev)
    cpu = hot_program_costs(quick=True, device="cpu")
    print("program | flops card | flops cpu | bytes card | bytes cpu | "
          "intensity | argument bytes | output bytes | temp bytes (card)")
    for name in card:
        a, b = card[name], cpu[name]
        print(f"  {name} | {a['flops']:.0f} | {b['flops']:.0f} | "
              f"{a['bytes_accessed']:.0f} | {b['bytes_accessed']:.0f} | "
              f"{a['arithmetic_intensity']} | {a['argument_bytes']} | "
              f"{a['output_bytes']} | {a['temp_bytes']}  ({a['derived']})")
        if a["flops"] != b["flops"] or not a["flops"] > 0:
            raise SystemExit(f"cost {name}: flops on the card {a['flops']} "
                             f"!= on the CPU {b['flops']}")
    print(f"phase 27 wall {time.perf_counter() - t0:.2f} s")


LM_TRAIN_GOLDEN = os.path.join(ROOT, "tests", "data",
                               "torch_train_golden.npz")
# the LM train step's gates (tests/test_torch_train_lm.py): losses and
# per-exit CE relative, gradients against 1e-4 of the leaf's max |g|,
# params after Adam steps by TRAIN_PARAM_TOL, an entry off it only where
# some step's reference gradient sat within GRAD_TIE of 0 (Adam's first
# steps move an entry by ~lr whatever its gradient's size, so a gradient
# within rounding of 0 can flip its step): a near-tie, counted
TRAIN_LM_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
GRAD_TIE = 1e-4


def load_npz(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def adam_rule(got, want, grads, grad_max, *, rtol=TRAIN_PARAM_TOL[0],
              atol=TRAIN_PARAM_TOL[1]):
    """(entries off rtol/atol of ``want`` outside near-ties, near-ties):
    a near-tie is an entry off it where some step's reference gradient
    (``grads`` with their leaves' ``grad_max``) is within GRAD_TIE of its
    leaf's max |g| of 0."""
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    tie = np.zeros_like(bad)
    for g, m in zip(grads, grad_max):
        tie |= np.abs(g) <= GRAD_TIE * m
    return int((bad & ~tie).sum()), int((bad & tie).sum())


def _golden_leaves(gold, prefix, tree, kind):
    """``{path: (port values at the stored indices, the stored values)}``
    of a flat port tree against ``<prefix>/<kind>/<path>``."""
    from repro_torch.nn.pytree import flatten_dict

    out = {}
    for path, x in flatten_dict(tree).items():
        idx = gold[f"{prefix}/idx/{path}"]
        got = x.detach().float().reshape(-1)[torch.as_tensor(
            idx, device=x.device)].cpu().numpy()
        out[path] = (got, gold[f"{prefix}/{kind}/{path}"])
    return out


def _step_grads(gold, prefix, path, n_steps):
    keys = [(f"{prefix}/grads/{t}/{path}", f"{prefix}/grad_max/{t}/{path}")
            for t in range(n_steps)]
    keys = [(g, m) for g, m in keys if g in gold]
    return [gold[g] for g, _ in keys], [float(gold[m]) for _, m in keys]


def lm_train_replay(dev, gold, arch) -> dict:
    """Replay the golden's ``arch`` run (tools/make_torch_train_golden.py)
    through the port on ``dev``: the first step's gradients (sampled
    entries) within TRAIN_GRAD_TOL of the leaf's max |g|, each step's loss,
    per-exit
    CE and moe_aux within TRAIN_LM_RTOL, and the final params by
    ``adam_rule``. Returns {"loss_err", "grad_err", "ties", "params"};
    raises SystemExit on a failure."""
    from repro_torch.configs import get_arch
    from repro_torch.core.bridge import lm_params_from_numpy, lm_params_numpy
    from repro_torch.optim import adamw, linear_warmup_cosine
    from repro_torch.train.steps import (make_loss_fn, make_train_state,
                                         make_train_step)

    kw = {"exit_layers": tuple(int(e) for e in gold[f"{arch}/exit_layers"]),
          "remat": bool(gold[f"{arch}/remat"])}
    if f"{arch}/ssm_chunk" in gold:
        kw["ssm_chunk"] = int(gold[f"{arch}/ssm_chunk"])
    cfg = get_arch(arch).reduced(**kw)
    lr, warm, decay = (float(x) for x in gold["lm_schedule"])
    opt = adamw(linear_warmup_cosine(lr, int(warm), int(decay)),
                weight_decay=float(gold["lm_weight_decay"]))
    params = lm_params_from_numpy(
        lm_params_numpy(cfg, int(gold["lm_seed"])), cfg, dev)
    state, opt = make_train_state(cfg, None, opt, params=params)
    step, loss_fn = make_train_step(cfg, opt), make_loss_fn(cfg)
    n_steps = gold[f"{arch}/loss"].shape[0]
    loss_err = grad_err = 0.0
    for t in range(n_steps):
        batch = {k: torch.as_tensor(gold[f"{arch}/{k}"][t], device=dev)
                 for k in ("tokens", "labels", "audio")
                 if f"{arch}/{k}" in gold}
        batch["tokens"] = batch["tokens"].long()
        batch["labels"] = batch["labels"].long()
        if t == 0:
            grad_err = _grad_check(gold, arch, loss_fn, state.params, batch)
        state, metrics = step(state, batch)
        for k, v in metrics.items():
            if f"{arch}/{k}" not in gold or k == "moe_dropped":
                continue
            want = float(gold[f"{arch}/{k}"][t])
            err = abs(float(v) - want) / max(abs(want), 1e-30)
            if want == 0.0:
                err = abs(float(v))
            loss_err = max(loss_err, err)
            if not err <= TRAIN_LM_RTOL:
                raise SystemExit(f"{arch} step {t} {k}: {float(v)} vs the "
                                 f"reference's {want}")
        if float(metrics["moe_dropped"]) != float(
                gold[f"{arch}/moe_dropped"][t]):
            raise SystemExit(f"{arch} step {t}: moe_dropped "
                             f"{float(metrics['moe_dropped'])} vs "
                             f"{float(gold[f'{arch}/moe_dropped'][t])}")
    ties = n_param = 0
    for path, (got, want) in _golden_leaves(gold, arch, state.params,
                                            "params").items():
        bad, tie = adam_rule(got, want,
                             *_step_grads(gold, arch, path, n_steps))
        if bad:
            raise SystemExit(f"{arch} params {path}: {bad} entries off the "
                             f"reference outside near-ties")
        ties += tie
        n_param += got.size
    return {"loss_err": loss_err, "grad_err": grad_err, "ties": ties,
            "params": n_param}


def _grad_check(gold, arch, loss_fn, params, batch) -> float:
    """The port's gradients at the initial params (the reference's too)
    against step 0's: the largest error over the leaves, each over its
    leaf's max |g|; raises above TRAIN_GRAD_TOL. (Later steps start from
    params that Adam's near-ties have already moved, so their gradients
    are not gated.)"""
    leaves = _flat_requires_grad(params)
    with torch.enable_grad():
        loss, _ = loss_fn(_unflat(leaves), batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    worst = 0.0
    for path, (got, want) in _golden_leaves(
            gold, arch, _unflat(dict(zip(leaves, grads))),
            "grads/0").items():
        m = float(gold[f"{arch}/grad_max/0/{path}"])
        err = float(np.abs(got - want).max()) / max(m, 1e-30)
        worst = max(worst, err)
        if not err <= TRAIN_GRAD_TOL:
            raise SystemExit(f"{arch} grad {path}: error {err:.3e} of the "
                             f"leaf's max |g|")
    return worst


def _flat_requires_grad(tree) -> dict:
    from repro_torch.nn.pytree import flatten_dict

    return {k: v.detach().requires_grad_()
            for k, v in flatten_dict(tree).items()}


def _unflat(flat):
    from repro_torch.nn.pytree import unflatten_dict

    return unflatten_dict(flat)


def vgg_train_replay(dev, gold) -> dict:
    """Replay the golden's VGG run through ``train_vgg_ee`` on ``dev``:
    both stages' losses within TRAIN_LM_RTOL, the final params by
    ``adam_rule``. Returns {"loss_err", "ties", "params"}."""
    from repro_torch.core.bridge import vgg_params_from_numpy, vgg_params_numpy
    from repro_torch.vgg import train_vgg_ee

    width, steps = float(gold["vgg_width"]), int(gold["vgg_steps"])
    params = vgg_params_from_numpy(
        vgg_params_numpy(width, int(gold["vgg_seed"])), dev,
        width_mult=width)
    batches = [(torch.as_tensor(x, device=dev),
                torch.as_tensor(y, device=dev).long())
               for x, y in zip(gold["vgg/images"], gold["vgg/labels"])]
    params, hist = train_vgg_ee(width_mult=width, steps_main=steps,
                                steps_exits=steps, lr=float(gold["vgg_lr"]),
                                device=dev, params=params, batches=batches)
    loss_err = 0.0
    for k in ("main_loss", "exit_loss"):
        got, want = np.array(hist[k]), gold[f"vgg/{k}"].astype(np.float64)
        err = float(np.max(np.abs(got - want) / np.abs(want)))
        loss_err = max(loss_err, err)
        if not err <= TRAIN_LM_RTOL:
            raise SystemExit(f"vgg {k}: {got} vs the reference's {want}")
    ties = n_param = 0
    for path, (got, want) in _golden_leaves(gold, "vgg", params,
                                            "params").items():
        bad, tie = adam_rule(got, want,
                             *_step_grads(gold, "vgg", path, 2 * steps))
        if bad:
            raise SystemExit(f"vgg params {path}: {bad} entries off the "
                             f"reference outside near-ties")
        ties += tie
        n_param += got.size
    return {"loss_err": loss_err, "ties": ties, "params": n_param}


# phase 33: the flash Function's shapes (label, (B, S, H, KVH, d), causal,
# window, dtypes): Llama-3.2-1B's training step, a window, Whisper's encoder
FLASH_GRAD_SHAPES = (
    ("llama3_2_1b train", (8, 256, 32, 8, 64), True, None,
     (torch.bfloat16, torch.float32)),
    ("window 128", (2, 512, 8, 2, 64), True, 128,
     (torch.bfloat16, torch.float32)),
    ("whisper encoder", (4, 1500, 16, 16, 64), False, None,
     (torch.bfloat16,)))
# phase 35: path A, as python -m repro_torch.launch.train runs it
TRAIN_ARGS = ("--arch", "llama3_2_1b", "--steps", "20", "--batch", "8",
              "--seq", "256", "--log-every", "5")
# and its checks that training lowers the loss: steps on one batch, and
# the same CLI at the reduced width (vocabulary 512), where 200 steps of
# TokenStream's batches have a bigram table to learn
FIXED_STEPS, FIXED_LR = 3, 3e-4
REDUCED_TRAIN_ARGS = ("--arch", "llama3_2_1b", "--reduced", "--steps", "200",
                      "--batch", "8", "--seq", "256", "--log-every", "50")
HELD_OUT = 4     # batches of the stream past the run, for its loss
# phase 36: path B, examples/torch_vgg_offloading.py at VGG-16's width
VGG_STEPS, VGG_SLOTS = 300, 300


def train_step_split(cfg, state, batch, reps=3) -> dict:
    """Median host ms of each part of one LM train step, as
    ``make_train_step``'s ``on_part`` hook marks them (a synchronize at
    each mark): the forward (the multi-exit loss, remat'd layers and
    checkpointed CE chunks), the backward (``torch.autograd.grad``, which
    recomputes them), and AdamW's update with ``apply_updates``."""
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step

    marks = []

    def on_part(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    step = make_train_step(cfg, adamw(3e-4), on_part=on_part)
    parts = {"forward": [], "backward": [], "optimizer": []}
    for _ in range(reps):
        torch.cuda.synchronize()
        marks[:] = [("start", time.perf_counter())]
        new, _ = step(state, batch)
        for (_, a), (name, b) in zip(marks, marks[1:]):
            parts[name].append((b - a) * 1e3)
        del new
    return {k: sorted(v)[len(v) // 2] for k, v in parts.items()}


def event_pair_ms(fn) -> float:
    """Device-clock ms of one ``fn()`` between two CUDA events (host
    launches included where the card waits for them)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def flash_grads(fn, q, k, v, dout, **kw):
    """(out, dq, dk, dv) of ``fn(q, k, v, **kw)`` by autograd, on leaf
    copies of q, k, v."""
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = fn(*leaves, **kw)
    return (out, *torch.autograd.grad(out, leaves, dout))


def flash_function_phase(dev) -> dict:
    """Phase 33: ``ops.flash_attention`` with inputs that require grad,
    as the training step calls it: one kernel launch whose output equals
    the kernel's bit for bit and lies within ATTN_TOL of the plain
    version's (in bf16 also within FLASH_EMU_TOL of the kernel's
    emulation), and q/k/v gradients within ATTN_TOL of autograd through
    the plain version; a control with the softmax scale dropped from the
    backward must fail that gate. Forward and backward ms at Llama's
    training shape. Returns {"max_abs_err"}: the forward's largest
    absolute error against the plain version (the backward is the plain
    version's own VJP, so its error says nothing of the kernel)."""
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    for label, (b, s, h, kvh, d), causal, window, dtypes in FLASH_GRAD_SHAPES:
        for dtype in dtypes:
            def normal(*shape):
                return torch.randn(shape, generator=gen, device=dev).to(dtype)

            q, k, v = normal(b, s, h, d), normal(b, s, kvh, d), \
                normal(b, s, kvh, d)
            dout = normal(b, s, h, d)
            kw = dict(causal=causal, window=window)
            before = flash_mod.launches
            out, *got = flash_grads(ops.flash_attention, q, k, v, dout, **kw)
            torch.cuda.synchronize()
            launched = flash_mod.launches - before
            kernel_out = flash_mod.flash_attention(q, k, v, **kw)
            if launched != 1 or not torch.equal(out, kernel_out):
                raise SystemExit(f"flash Function {label} {dtype}: {launched} "
                                 f"launches, forward equal to the kernel's "
                                 f"{torch.equal(out, kernel_out)}")
            plain, *want = flash_grads(ref.flash_attention_ref, q, k, v,
                                       dout, **kw)
            tol = ATTN_TOL[dtype]

            def excess(gs, ws):
                return max(float(((g.float() - w.float()).abs()
                                  - tol - tol * w.float().abs()).max())
                           for g, w in zip(gs, ws))

            # the forward: the kernel's output against the plain version's
            # (and, in bf16, against the kernel's emulation)
            out, plain = out.detach(), plain.detach()
            fwd_err = float((out.float() - plain.float()).abs().max())
            emu = "" if dtype != torch.bfloat16 else flash_emu_err(
                out, ref.flash_attention_bf16_emulation(q, k, v, **kw))
            err = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(got, want))
            # the control: dq, dk, dv of attention without the 1/sqrt(d)
            _, *wrong = flash_grads(
                lambda q_, k_, v_, **a: ref.flash_attention_ref(
                    q_ * math.sqrt(d), k_, v_, **a), q, k, v, dout, **kw)
            print(f"  flash Function {label:18s} {str(dtype)[6:]:8s} "
                  f"[{b}, {s}, {h}, {kvh}, {d}] forward == kernel, forward "
                  f"max_abs_err {fwd_err:.3e} vs plain"
                  + (f", {emu:.3e} vs emulation beyond rounding"
                     if emu != "" else "")
                  + f"; grads max_abs_err {err:.3e} (tol {tol}), control "
                  f"excess {excess(wrong, want):.3e} > 0", flush=True)
            if excess([out], [plain]) > 0:
                raise SystemExit(f"flash Function {label} {dtype}: forward "
                                 f"off the plain version's by more than "
                                 f"{tol} (max abs {fwd_err})")
            if emu != "" and emu > FLASH_EMU_TOL:
                raise SystemExit(f"flash Function {label}: forward off the "
                                 f"kernel's emulation by {emu} (limit "
                                 f"{FLASH_EMU_TOL})")
            if excess(got, want) > 0:
                raise SystemExit(f"flash Function {label} {dtype}: gradients "
                                 f"off the plain version's (max abs {err})")
            if not excess(wrong, want) > 0:
                raise SystemExit(f"flash Function {label} {dtype}: the gate "
                                 f"passed a backward without the softmax scale")
            worst = max(worst, fwd_err)
            if label.startswith("llama") and dtype == torch.bfloat16:
                leaves = [x.detach().requires_grad_() for x in (q, k, v)]
                kernel_ms = graph_ms(
                    lambda: flash_mod.flash_attention(q, k, v, **kw))
                call_ms = eager_ms(lambda: ops.flash_attention(*leaves, **kw),
                                   n=50)
                o = ops.flash_attention(*leaves, **kw)
                bwd = sum(event_pair_ms(lambda: torch.autograd.grad(
                    o, leaves, dout, retain_graph=True))
                    for _ in range(10)) / 10
                print(f"  flash Function at the training shape: the "
                      f"kernel {kernel_ms * 1e3:.2f} us (graph replay), the "
                      f"forward call {call_ms:.4f} ms (eager, host "
                      f"included), the backward {bwd:.4f} ms (the plain "
                      f"version's VJP in float32, CUDA events)", flush=True)
            del q, k, v, dout, out, got, plain, want, wrong, kernel_out
    torch.cuda.empty_cache()
    return {"max_abs_err": worst}


def lm_train_golden_phase(dev) -> None:
    """Phase 34: the training golden's LM runs replayed on the card."""
    gold = load_npz(LM_TRAIN_GOLDEN)
    for arch in (str(a) for a in gold["lm_archs"]):
        out = lm_train_replay(dev, gold, arch)
        print(f"  {arch:18s} loss/CE rel err {out['loss_err']:.3e}  grads "
              f"{out['grad_err']:.3e} of the leaf max  params by the Adam "
              f"rule, near-ties {out['ties']} of {out['params']} sampled",
              flush=True)


def fixed_batch_losses(cfg, state, batch) -> list:
    """The loss of ``batch`` at each of FIXED_STEPS train steps on it with
    a fresh ``adamw(FIXED_LR)``, then after the last: a batch the model
    trains on must lose loss at every step."""
    from repro_torch.optim import adamw
    from repro_torch.train.steps import (TrainState, make_loss_fn,
                                         make_train_step)

    opt = adamw(FIXED_LR)
    state = TrainState(state.params, opt.init(state.params), state.step)
    step = make_train_step(cfg, opt)
    losses = []
    for _ in range(FIXED_STEPS):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    with torch.no_grad():
        losses.append(float(make_loss_fn(cfg)(state.params, batch)[0]))
    del state
    return losses


def held_out_losses(cfg, args, out) -> tuple:
    """The mean loss of HELD_OUT batches that the run did not train on
    (the stream's next ones) at the run's initial params (drawn again from
    ``--seed``, as ``launch.train`` draws them) and at its final params:
    whether the run's loss moved beyond one batch's noise."""
    from repro_torch.models.lm import model_for
    from repro_torch.train.steps import make_loss_fn

    batches = [out["next_batch"]() for _ in range(HELD_OUT)]
    dev = out["state"].step.device
    init = model_for(cfg).init(
        torch.Generator(device=dev).manual_seed(args.seed), cfg, device=dev)
    loss_fn = make_loss_fn(cfg)
    with torch.no_grad():
        got = tuple(sum(float(loss_fn(p, b)[0]) for b in batches) / HELD_OUT
                    for p in (init, out["state"].params))
    del init, batches
    return got


def reduced_train_losses() -> list:
    """``launch.train`` with REDUCED_TRAIN_ARGS: every step's loss."""
    from repro_torch.launch import train as cli

    out = cli.train(cli.parse_args(list(REDUCED_TRAIN_ARGS)),
                    log=lambda line: print("  reduced " + line, flush=True))
    return out["losses"]


def lm_train_phase(dev) -> dict:
    """Phase 35, path A: ``python -m repro_torch.launch.train`` with
    TRAIN_ARGS in-process (Llama-3.2-1B at full width and depth, bf16,
    remat, its four exits, AdamW under linear_warmup_cosine on
    TokenStream): every loss finite; step ms (median after the first),
    tokens/s, peak memory; flash launches (the wrapper's count over the
    run, and by the profiler over one more step: one per layer forward
    plus one per layer recomputed by remat); the step's parts; the loss
    of held-out batches at the initial and final params; then
    ``fixed_batch_losses`` from the trained params, falling at every
    step; then the same CLI at the reduced width, whose last loss must
    lie below its first. Returns the wrapper's launch counts of the
    full-width run."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as cli

    args = cli.parse_args(list(TRAIN_ARGS))
    cfg = get_arch(args.arch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = cli.train(args, log=lambda line: print("  " + line, flush=True))
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    losses = out["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"path A losses {losses}: not finite")
    per_step = 2 * cfg.n_layers if cfg.remat else cfg.n_layers
    if counts["flash_attention"] != per_step * args.steps:
        raise SystemExit(f"path A: {counts['flash_attention']} flash "
                         f"launches, expected {per_step} a step")
    step_ms = sorted(out["step_s"][1:])[len(out["step_s"][1:]) // 2] * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batch = out["next_batch"]()
    busy, prof, windows = profiled_until(
        lambda: out["step_fn"](out["state"], batch),
        {"flash_attention": per_step}, "path A")
    top = sorted(busy["by_name"].items(), key=lambda kv: -kv[1])[:6]
    split = train_step_split(cfg, out["state"], batch)
    print(f"  {args.arch} B={args.batch} S={args.seq} steps {args.steps}: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; step {step_ms:.2f} ms "
          f"(median after the first; first {out['step_s'][0] * 1e3:.1f} "
          f"ms), {args.batch * args.seq / step_ms * 1e3:.0f} tokens/s, "
          f"peak memory {peak_gb:.2f} GB, wall {wall:.2f} s (init "
          f"included)", flush=True)
    print(f"  flash launches: {counts['flash_attention']} in the run "
          f"({per_step} a step); one more step by the profiler: "
          f"{prof['flash_attention']} flash kernels of {busy['kernels']} "
          f"CUDA kernels and copies (windows: {'; '.join(windows)}), "
          f"device {busy['device_ms']:.2f} of "
          f"{busy['wall_ms']:.2f} ms (busy share "
          f"{busy['device_ms'] / busy['wall_ms']:.1%}); top kernels "
          + "; ".join(f"{n[:48]} {ms:.2f} ms" for n, ms in top), flush=True)
    print(f"  the step apart (median of 3, host ms to a synchronize): "
          f"forward {split['forward']:.2f}, backward {split['backward']:.2f} "
          f"(remat and CE recomputed), AdamW {split['optimizer']:.2f}",
          flush=True)
    before, after = held_out_losses(cfg, args, out)
    print(f"  {HELD_OUT} held-out batches: mean loss {before:.6f} at the "
          f"initial params, {after:.6f} after the run ({after - before:+.6f})",
          flush=True)
    fixed = fixed_batch_losses(cfg, out["state"], out["next_batch"]())
    print(f"  {FIXED_STEPS} AdamW steps (lr {FIXED_LR}) on one batch from "
          f"the trained params: loss {' -> '.join(f'{x:.4f}' for x in fixed)}",
          flush=True)
    if not all(math.isfinite(x) for x in fixed) or not all(
            b < a for a, b in zip(fixed, fixed[1:])):
        raise SystemExit(f"path A: the loss of a batch trained on did not "
                         f"fall at every step: {fixed}")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    reduced = reduced_train_losses()
    print(f"  reduced width, {len(reduced)} steps: loss {reduced[0]:.4f} -> "
          f"{reduced[-1]:.4f}", flush=True)
    if not all(math.isfinite(x) for x in reduced) \
            or not reduced[-1] < reduced[0]:
        raise SystemExit(f"path A at the reduced width: the last loss "
                         f"{reduced[-1]} is not below the first {reduced[0]}")
    return counts


def load_example(name):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def vgg_path_phase(dev) -> dict:
    """Phase 36, path B: the VGG golden replay (convolutions without
    TF32); then examples/torch_vgg_offloading.py's three stages in-process
    at VGG-16's full width: two-stage training (VGG_STEPS + VGG_STEPS
    steps, batch 64; steps/s), ``profile_exits`` on the card (five rows:
    accuracy, measured and roofline ms), and GRLE over VGG_SLOTS slots on
    the measured profile in the example's scan mode, with the profiler's
    gcn_agg/edge_score kernels (4 and 1 per decision and per train step,
    warm-up included) and one graph launch a slot. Returns the profiler's
    launches."""
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    out = vgg_train_replay(dev, load_npz(LM_TRAIN_GOLDEN))
    print(f"  VGG golden: loss rel err {out['loss_err']:.3e}, params by the "
          f"Adam rule, near-ties {out['ties']} of {out['params']} sampled "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    ex = load_example("torch_vgg_offloading")
    args = ex.parse_args(["--slots", str(VGG_SLOTS)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, hist = ex.train_stage(args, steps=VGG_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    losses = hist["main_loss"] + hist["exit_loss"]
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit("path B: a VGG loss is not finite")
    print(f"  VGG-16 width {args.width_mult} batch {args.batch}: "
          f"{2 * VGG_STEPS} steps in {train_s:.2f} s, "
          f"{2 * VGG_STEPS / train_s:.1f} steps/s; main loss "
          f"{hist['main_loss'][0]:.3f} -> {hist['main_loss'][-1]:.3f}, exit "
          f"loss {hist['exit_loss'][0]:.3f} -> {hist['exit_loss'][-1]:.3f}",
          flush=True)
    rows = ex.profile_stage(params, args)
    if len(rows) != 5 or not all(r["ms"] > 0 and 0 <= r["accuracy"] <= 1
                                 for r in rows):
        raise SystemExit(f"path B: profile rows {rows}")
    for r in rows:
        print(f"  exit {r['exit']:2d}: acc {r['accuracy']:.4f}  measured "
              f"{r['ms']:.4f} ms  roofline {r['roofline_ms']:.4f} ms  "
              f"{r['gflops']:.4f} GFLOPs", flush=True)
    print(json.dumps({"vgg_profile": rows}))
    ops.reset_launch_counts()
    busy = {}
    (drv, carry, _), prof, graphs = profiled_call(
        lambda: ex.offload_stage(rows, args), busy=busy)
    wrappers = ops.launch_counts()
    m = drv.metrics(carry)
    # the scan episode: one eager warm-up slot of each kind before the
    # capture (the training kind with its train step), then one graph
    # launch a slot; the wrappers count the warm-up and the capture
    warm = drv.graphs_captured + (m["train_steps"] > 0)
    decisions = VGG_SLOTS + int(m["train_steps"])
    print(f"  GRLE {VGG_SLOTS} slots (scan) on the measured profile: ssp "
          f"{m['ssp']:.6f} avg_accuracy {m['avg_accuracy']:.6f} train steps "
          f"{int(m['train_steps'])}; profiler gcn_agg {prof['gcn_agg']} "
          f"edge_score {prof['edge_score']} ({warm} warm-up actor forwards "
          f"included), {graphs} graph launches, wrapper calls {wrappers}, "
          f"busy share {busy['device_ms'] / busy['wall_ms']:.1%} (capture "
          f"included)", flush=True)
    if (prof["gcn_agg"] != 4 * (decisions + warm)
            or prof["edge_score"] != decisions + warm
            or graphs != VGG_SLOTS or drv.graphs_captured != 2
            or wrappers["gcn_agg"] == 0 or wrappers["edge_score"] == 0
            or not 0.0 < m["ssp"] <= 1.0):
        raise SystemExit(f"path B: GRLE launches {prof}, {graphs} graph "
                         f"launches and {drv.graphs_captured} graphs for "
                         f"{decisions} actor forwards and {warm} warm-up "
                         f"ones, wrapper calls {wrappers}, ssp {m['ssp']}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return prof


# phase 37: the scan Function at the SSM configs' training shapes (label,
# (B, T, H, dk, dv), RWKV's bonus), chunk 128, in bf16 and float32, with
# and without an initial state; its gradients against autograd of the
# sequential plain version at SSM_GRAD_B sequences, where that T-step
# graph fits
SSM_FN_SHAPES = (("zamba2_2_7b train", (8, 256, 80, 64, 64), False),
                 ("rwkv6_7b train", (8, 256, 64, 64, 64), True))
SSM_FN_CHUNK = 128
SSM_GRAD_B = 2
SSM_GRAD_TOL = 1e-4      # of each leaf's max |g|
# phase 38: the SSM configs trained at full width, bf16, B=8, S=256,
# remat: Zamba2-2.7B at its full depth through the launch.train CLI, and
# RWKV-6-7B at full width with its depth cut to RWKV_TRAIN_LAYERS of 32
# layers, through make_train_step: all 32 would need ~180 GB at the ~24 B
# a param Llama-3.2-1B's step peaked at; 11 peaked at 70.79 GB alone but
# ran out of memory after the script's earlier phases (fragmentation), so
# 10 (NVIDIA H100 80GB HBM3, 700 W)
SSM_TRAIN_STEPS = 4
PROFILE_TRIES = 3
ZAMBA_TRAIN_ARGS = ("--arch", "zamba2_2_7b", "--steps", str(SSM_TRAIN_STEPS),
                    "--batch", "8", "--seq", "256", "--log-every", "1")
RWKV_TRAIN_ARGS = ("--arch", "rwkv6_7b", "--steps", str(SSM_TRAIN_STEPS),
                   "--batch", "8", "--seq", "256", "--log-every", "1")
RWKV_TRAIN_LAYERS = 10


def scan_grads(fn, xs, dy, ds):
    """(y, state, gradients of <y, dy> + <state, ds> with respect to the
    present inputs) of ``fn(q, k, v, log_w, u, s0)``, by autograd on leaf
    copies of ``xs``."""
    leaves = [None if x is None else x.detach().clone().requires_grad_()
              for x in xs]
    y, st = fn(*leaves)
    loss = (y.float() * dy).sum() + (st * ds).sum()
    return y, st, torch.autograd.grad(loss, [x for x in leaves
                                             if x is not None])


def grad_excess(got, want) -> float:
    """The largest |g - w| over its leaf's max |w|, beyond the rounding
    of a bf16 gradient (2^-8 |w|; none for a float32 one)."""
    out = 0.0
    for g, w in zip(got, want):
        rnd = 2.0 ** -8 * w.abs() if g.dtype == torch.bfloat16 else 0.0
        err = ((g.float() - w.float()).abs() - rnd).clamp(min=0)
        out = max(out, float(err.max()) / max(float(w.abs().max()), 1e-30))
    return out


def ssm_function_phase(dev) -> dict:
    """Phase 37: ``ops.ssm_scan`` on inputs that require grad, as the
    RWKV-6 and Mamba-2 blocks call it in training, at SSM_FN_SHAPES: one
    kernel launch whose y and state equal the kernel's bit for bit, held
    against the sequential plain version (SSM_TOL of 1 + the (sequence,
    head)'s largest |value|; bf16 also against the kernel's emulation
    within SSM_EMU_TOL / SSM_EMU_STATE_TOL, its planted faults rejected); the chunked VJP's gradients (cotangents on y and on the
    state) within SSM_GRAD_TOL of each leaf's max of autograd through the
    sequential plain version in float32 at SSM_GRAD_B sequences, and a
    control, the reference gradients with one chunk's decays perturbed,
    that must fail that gate; the kernel forward's us (beside the plain
    version's and the bound) and the backward's ms a call at each
    training shape in bf16. Returns {"max_abs_err": the
    forward's largest absolute error against the plain version, "rows"}."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssm_scan as ssm_mod

    gen = torch.Generator(device=dev).manual_seed(SEED)
    c = SSM_FN_CHUNK
    worst, rows = 0.0, []
    for label, (b, t, h, dk, dv), rwkv in SSM_FN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for init in (False, True):
                def normal(*shape, scale=1.0, shift=0.0):
                    return torch.randn(shape, generator=gen, device=dev) \
                        * scale + shift

                q, k = normal(b, t, h, dk).to(dtype), \
                    normal(b, t, h, dk).to(dtype)
                v = normal(b, t, h, dv).to(dtype)
                log_w = -torch.exp(normal(b, t, h, dk, scale=0.5,
                                          shift=-5.0 if init else 0.0))
                u = normal(h, dk, scale=0.2) if rwkv else None
                s0 = normal(b, h, dk, dv) if init else None
                xs = (q, k, v, log_w, u, s0)
                dy, ds = normal(b, t, h, dv), normal(b, h, dk, dv)
                tag = (f"{label} {str(dtype)[6:]} "
                       f"{'slow, initial state' if init else 'fast'}")
                before = ssm_mod.launches
                y, st, got = scan_grads(
                    lambda *a: ops.ssm_scan(*a[:5], chunk=c,
                                            initial_state=a[5]),
                    xs, dy, ds)
                torch.cuda.synchronize()
                launched = ssm_mod.launches - before
                ky, ks = ssm_mod.ssm_scan(q, k, v, log_w, u, chunk=c,
                                          initial_state=s0)
                if launched != 1 or not (torch.equal(y, ky)
                                         and torch.equal(st, ks)):
                    raise SystemExit(f"scan Function {tag}: {launched} "
                                     f"launches, forward equal to the "
                                     f"kernel's {torch.equal(y, ky)}, state "
                                     f"{torch.equal(st, ks)}")
                y, st = y.detach(), st.detach()
                want_y, want_s = ref.ssm_scan_ref(q, k, v, log_w, bonus_u=u,
                                                  initial_state=s0)
                fwd = float((y.float() - want_y.float()).abs().max())
                err_y, err_s = scan_err(y, want_y), scan_err(st, want_s,
                                                             True)
                line = (f"  scan Function {tag:38s} forward == kernel; max "
                        f"abs error {fwd:.3e}, y {err_y:.3e} / state "
                        f"{err_s:.3e} of 1 + max |value| vs plain")
                if dtype == torch.float32:
                    print(line + f" (limit {SSM_TOL[dtype]})", flush=True)
                    if not (err_y <= SSM_TOL[dtype]
                            and err_s <= SSM_TOL[dtype]):
                        raise SystemExit(f"scan Function {tag}: forward off "
                                         f"the plain version")
                else:
                    print(line + f" (limit {SSM_TOL[dtype]})", flush=True)
                    if not err_y <= SSM_TOL[dtype]:
                        raise SystemExit(f"scan Function {tag}: forward off "
                                         f"the plain version")
                    emu_y, emu_s = ref.ssm_scan_bf16_emulation(
                        q, k, v, log_w, bonus_u=u, chunk=c,
                        initial_state=s0)
                    check_emulation(tag, y, st, emu_y, emu_s)
                    if init:
                        emulation_controls(q, k, v, log_w, u, s0, c, emu_y,
                                           emu_s, want_y)
                    del emu_y, emu_s
                worst = max(worst, fwd)
                del want_y, want_s, got, ky, ks
                # the backward against the sequential version's autograd,
                # in float32 on the same inputs and cotangents (dy as the
                # Function's y receives it, in y's dtype)
                sub = [None if x is None else x[:SSM_GRAD_B] if x.dim() == 4
                       else x for x in xs]
                dyc = dy[:SSM_GRAD_B].to(dtype).float()
                dsc = ds[:SSM_GRAD_B]
                _, _, got = scan_grads(
                    lambda *a: ops.ssm_scan(*a[:5], chunk=c,
                                            initial_state=a[5]),
                    sub, dyc, dsc)
                f32 = [None if x is None else x.float() for x in sub]

                def seq(*a):
                    return ref.ssm_scan_ref(*a[:4], bonus_u=a[4],
                                            initial_state=a[5])

                _, _, want = scan_grads(seq, f32, dyc, dsc)
                err = grad_excess(got, want)
                wrong_w = f32[3].clone()
                wrong_w[:, c:2 * c] *= 1.05
                _, _, wrong = scan_grads(seq, f32[:3] + [wrong_w] + f32[4:],
                                         dyc, dsc)
                control = grad_excess(got, wrong)
                print(f"  scan Function {tag:38s} grads at B={SSM_GRAD_B}: "
                      f"{err:.3e} of the leaf max beyond their rounding "
                      f"(limit {SSM_GRAD_TOL}); control (one chunk's decays "
                      f"x1.05) {control:.3e}", flush=True)
                if not err <= SSM_GRAD_TOL:
                    raise SystemExit(f"scan Function {tag}: gradients off "
                                     f"the sequential version's by {err}")
                if not control > SSM_GRAD_TOL:
                    raise SystemExit(f"scan Function {tag}: the gradient "
                                     f"gate accepts one chunk's decays "
                                     f"perturbed")
                row = {"case": tag, "fwd_max_abs_err": fwd,
                       "grad_err": err, "control": control}
                if dtype == torch.bfloat16 and not init:
                    leaves = [None if x is None else
                              x.detach().clone().requires_grad_()
                              for x in xs]
                    present = [x for x in leaves if x is not None]
                    kernel_us = graph_ms(lambda: ssm_mod.ssm_scan(
                        q, k, v, log_w, u, chunk=c), inner=5, reps=4) * 1e3
                    plain_us = event_ms(lambda: ref.ssm_scan_ref(
                        q, k, v, log_w, bonus_u=u)) * 1e3
                    b_ms, b_by = bound(*ssm_cost(q, v, log_w, u, None),
                                       peak_for(dtype))
                    oy, ost = ops.ssm_scan(*leaves[:5], chunk=c)

                    def backward():
                        return torch.autograd.grad(
                            (oy, ost), present, (dy.to(oy.dtype), ds),
                            retain_graph=True)

                    backward()      # warm: the allocator's blocks
                    bwd = sum(event_pair_ms(backward) for _ in range(5)) / 5
                    print(f"  scan Function {tag:38s} the kernel "
                          f"{kernel_us:.2f} us (graph replay; plain "
                          f"{plain_us:.2f} us eager, bound {b_ms * 1e3:.2f} "
                          f"us, {b_by}), the backward {bwd:.4f} ms a call "
                          f"(the plain chunked VJP in float32, CUDA events)",
                          flush=True)
                    row.update(kernel_us=kernel_us, plain_us=plain_us,
                               bound_us=b_ms * 1e3, bound_by=b_by,
                               bwd_ms=bwd)
                    del oy, ost, leaves, present
                rows.append(row)
                del xs, q, k, v, log_w, u, s0, dy, ds, got, want, wrong, sub
                torch.cuda.empty_cache()
    print(json.dumps({"ssm_function": rows}))
    return {"max_abs_err": worst, "rows": rows}


def ssm_train_report(label, cfg, args, out, wall) -> dict:
    """Phase 38's checks and readings of one SSM config's run ``out``
    (``launch.train.train``'s): every loss finite; step ms (median after
    the first), tokens/s, the peak memory of the run; ``ssm_scan``
    launches a step (two a layer under remat: the forward and its
    recompute) and flash launches (one a shared-block application), by
    the wrappers over the run and by the profiler over one more step (a
    window that reads them exactly, of at most PROFILE_TRIES), both
    exact, with the busy share and the top kernels; the step's
    parts through ``make_train_step``'s hook; then ``fixed_batch_losses``
    from the trained params, each lower. Returns (the wrappers' launches,
    the readings)."""
    from repro_torch.kernels import ops
    from repro_torch.models.lm import n_shared_applications
    from repro_torch.train.steps import TrainState

    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = out["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"{label}: losses {losses}: not finite")
    # remat recomputes each layer's forward; Zamba2's shared block is not
    # remat'd (nor is it in the reference's forward_train)
    want = {"ssm_scan": (2 if cfg.remat else 1) * cfg.n_layers,
            "flash_attention": n_shared_applications(cfg)}
    for name, n in want.items():
        if counts[name] != n * args.steps:
            raise SystemExit(f"{label}: {counts[name]} {name} launches in "
                             f"{args.steps} steps, expected {n} a step")
    step_ms = sorted(out["step_s"][1:])[len(out["step_s"][1:]) // 2] * 1e3
    batch = out["next_batch"]()
    busy, prof, windows = profiled_until(
        lambda: out["step_fn"](out["state"], batch), want, label)
    top = sorted(busy["by_name"].items(), key=lambda kv: -kv[1])[:6]
    split = train_step_split(cfg, out["state"], batch, reps=2)
    print(f"  {label} B={args.batch} S={args.seq} steps {args.steps}: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; step {step_ms:.2f} ms "
          f"(median after the first; first {out['step_s'][0] * 1e3:.1f} ms), "
          f"{args.batch * args.seq / step_ms * 1e3:.0f} tokens/s, peak memory "
          f"{peak_gb:.2f} GB, wall {wall:.2f} s (init included)", flush=True)
    print(f"  {label} launches a step: ssm_scan {want['ssm_scan']}, flash "
          f"{want['flash_attention']} (wrappers over the run: {counts}); one "
          f"more step by the profiler: {prof} of {busy['kernels']} CUDA "
          f"kernels and copies (windows: {'; '.join(windows)}), device "
          f"{busy['device_ms']:.2f} of "
          f"{busy['wall_ms']:.2f} ms (busy share "
          f"{busy['device_ms'] / busy['wall_ms']:.1%}); top kernels "
          + "; ".join(f"{n[:48]} {ms:.2f} ms" for n, ms in top), flush=True)
    print(f"  {label} the step apart (median of 2, host ms to a "
          f"synchronize): forward {split['forward']:.2f}, backward "
          f"{split['backward']:.2f} (remat, the scan's chunked VJP, CE "
          f"recomputed), AdamW {split['optimizer']:.2f}", flush=True)
    state = out.pop("state")
    params, step = state.params, state.step
    del state
    gc.collect()
    torch.cuda.empty_cache()
    fixed = fixed_batch_losses(cfg, TrainState(params, None, step), batch)
    print(f"  {label} {FIXED_STEPS} AdamW steps (lr {FIXED_LR}) on one batch "
          f"from the trained params: loss "
          f"{' -> '.join(f'{x:.4f}' for x in fixed)}", flush=True)
    if not all(math.isfinite(x) for x in fixed) or not all(
            b < a for a, b in zip(fixed, fixed[1:])):
        raise SystemExit(f"{label}: the loss of a batch trained on did not "
                         f"fall at every step: {fixed}")
    return counts, {"model": label, "step_ms": step_ms,
                    "tokens_per_s": args.batch * args.seq / step_ms * 1e3,
                    "peak_gb": peak_gb, "split_ms": split,
                    "busy_share": busy["device_ms"] / busy["wall_ms"],
                    "kernels_a_step": busy["kernels"],
                    "launches_a_step": want, "losses": losses,
                    "fixed_batch": fixed}


def ssm_train_phase(dev) -> dict:
    """Phase 38: Zamba2-2.7B at full width and depth through
    ``python -m repro_torch.launch.train`` (ZAMBA_TRAIN_ARGS, in-process),
    then RWKV-6-7B at full width with its depth cut to RWKV_TRAIN_LAYERS
    (``dataclasses.replace(cfg, n_layers=..., exit_layers=())``: its four
    exits at that depth) through the same ``train`` on a cut config; each
    read by ``ssm_train_report``. Returns the wrappers' launches over both
    runs."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as cli

    totals = {"ssm_scan": 0, "flash_attention": 0}
    rows = []
    for label, argv, cut in (
            ("zamba2_2_7b", ZAMBA_TRAIN_ARGS, None),
            (f"rwkv6_7b cut to {RWKV_TRAIN_LAYERS} of 32 layers",
             RWKV_TRAIN_ARGS, RWKV_TRAIN_LAYERS)):
        args = cli.parse_args(list(argv))
        cfg = get_arch(args.arch, reduced=args.reduced)
        if cut is not None:
            cfg = dataclasses.replace(cfg, n_layers=cut, exit_layers=())
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = cli.train(args, cfg=cfg,
                        log=lambda line: print(f"  {label} {line}",
                                               flush=True))
        counts, row = ssm_train_report(label, cfg, args, out,
                                       time.perf_counter() - t0)
        for k in totals:
            totals[k] += counts[k]
        rows.append(row)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"ssm_training": rows}))
    return totals


# the long-context window decode (phase 39): Llama-3.2-1B under
# launch/specs.py::arch_for_shape(..., INPUT_SHAPES["long_500k"]) (a window
# of 8192 rows), B = 1, random weights from seed 0; (prefill length,
# teacher-forced decode steps): (a) 8000 tokens, the ring wrapping at step
# 8192 - 8000 = 192; (b) 10000 tokens, the prefill ring rolled by 10000 %
# 8192 = 1808. WINDOW_EXIT_STEPS decode steps a timed exit, from the
# prefill of WINDOW_RUNS[1]; the layers whose ring rows are gated in f32
WINDOW_RUNS = ((8000, 400), (10000, 64))
WINDOW_EXIT_STEPS = 32
# steps a profiled window holds (the profiler's post-processing of a
# window's ~2500 kernels a step costs seconds)
WINDOW_PROFILED_STEPS = 4
WINDOW_RING_LAYERS = (0, 15)
# the caching allocator rounds every block up to a multiple of this, and
# hands a tensor above 1 MiB a cached block whole, without splitting it,
# when the rest would be at most this (its kSmallSize): memory_allocated
# then counts the rest too (the whole script read +1 MiB on one tensor)
ALLOC_ROUND = 512
ALLOC_UNSPLIT = 1 << 20
# phase 40's dry run: its records (under build/, which .gitignore lists)
DRYRUN_OUT = os.path.join(ROOT, "build", "chip_smoke_dryrun.jsonl")


def alloc_bytes():
    """(allocated, requested) bytes of the caching allocator now: what
    ``memory_allocated`` reads, and what the tensors asked for."""
    st = torch.cuda.memory_stats()
    return st["allocated_bytes.all.current"], st["requested_bytes.all.current"]


def window_cfg(dtype):
    from repro_torch.configs import get_arch
    from repro_torch.launch.specs import arch_for_shape
    from repro_torch.models import INPUT_SHAPES

    cfg = arch_for_shape(get_arch(LM_ARCH), INPUT_SHAPES["long_500k"])
    return dataclasses.replace(cfg, dtype=dtype)


def counted(fn, want: dict, label: str) -> dict:
    """``fn()`` with the wrappers' launch counts set to 0 just before and
    read just after; they must equal ``want`` (other kernels: 0)."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    expect = {k: want.get(k, 0) for k in counts}
    if counts != expect:
        raise SystemExit(f"{label}: launches {counts}, expected {expect}")
    return counts


def window_run(dev, cfg, params, gen, prefill_len, steps, launches):
    """One teacher-forced window run: a prefill of ``prefill_len`` tokens
    (its ring), then ``steps`` serve_step calls at the last exit, against
    the dense windowed prefill of all prefill_len + steps tokens (flash,
    window 8192). Returns the largest and the last step's relative L2 of
    the logits and the relative L2 of each WINDOW_RING_LAYERS layer's ring
    against the dense prefill's; adds the launches to ``launches``."""
    from repro_torch.models import DecoderLM
    from repro_torch.train import make_serve_step

    s, n = prefill_len, prefill_len + steps
    toks = torch.randint(0, cfg.vocab, (1, n), generator=gen, device=dev)
    out = {}

    def dense():
        h, out["dense"], _ = DecoderLM.prefill(params, cfg, toks)
        out["want"] = DecoderLM.logits(params, h[:, s:])[0].float()

    def ring():
        _, out["cache"], _ = DecoderLM.prefill(params, cfg, toks[:, :s])

    def decode():
        step, cache = make_serve_step(cfg), out["cache"]
        errs = []
        for t in range(steps):
            pos = torch.full((1,), s + t, dtype=torch.int64, device=dev)
            logits, cache = step(params, cache, toks[:, s + t], pos)
            want = out["want"][t]
            errs.append(torch.linalg.vector_norm(logits[0].float() - want)
                        / torch.linalg.vector_norm(want))
        out["errs"] = torch.stack(errs).cpu()

    for fn, want in ((dense, {"flash_attention": cfg.n_layers}),
                     (ring, {"flash_attention": cfg.n_layers}),
                     (decode, {"decode_attention": cfg.n_layers * steps})):
        counted(fn, want, f"window run S={s}")
        for k, v in want.items():
            launches[k] += v
    errs = out["errs"]
    res = {"logits_max": float(errs.max()), "logits_last": float(errs[-1]),
           "worst_step": int(errs.argmax())}
    for i in WINDOW_RING_LAYERS:
        for f in ("k", "v"):
            res[f"{f}[{i}]"] = rel_l2(getattr(out["cache"]["layers"], f)[i],
                                      getattr(out["dense"]["layers"], f)[i])
    return res


def window_kernel_checks(dev, cfg, params, gen):
    """The window path's two kernels at its own shapes against their plain
    versions (ATTN_TOL; bf16 flash also against its emulation within
    FLASH_EMU_TOL): flash_attention on layer 0's q/k/v over 10000 tokens
    with the 8192-row window, the plain version query-chunked (the port's
    ``sdpa``, float32 softmax: ref.flash_attention_ref's [S, S] logits
    would take ~13 GB a copy at this S); decode_attention on layer 0's
    query at position 10063 against a full 8192-row ring. In bf16 the
    kernels' times beside the plain, library and bound times. Returns each
    kernel's error by name."""
    from repro_torch.kernels import decode_attention as decode_mod
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ref
    from repro_torch.models.attention import GQAAttention, sdpa
    from repro_torch.nn import Embedding, RMSNorm

    dt, w = cfg.torch_dtype, cfg.window
    s, steps = WINDOW_RUNS[1]
    toks = torch.randint(0, cfg.vocab, (1, s + steps), generator=gen,
                         device=dev)
    layer0 = {k: v[0] for k, v in params["blocks"]["ln1"].items()}
    attn0 = {k: {n: t[0] for n, t in v.items()}
             for k, v in params["blocks"]["attn"].items()}
    h = RMSNorm.apply(layer0, Embedding.apply(params["embed"], toks),
                      eps=cfg.norm_eps)
    positions = torch.arange(s + steps, device=dev)[None]
    q, k, v = GQAAttention._qkv(attn0, cfg, h, positions)
    tol = ATTN_TOL[dt]

    def check(label, got, want):
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        print(f"  {label} {str(dt)[6:]}: max_abs_err {err:.3e}", flush=True)
        if not bool((diff <= tol + tol * want.float().abs()).all()):
            raise SystemExit(f"{label} {dt}: kernel differs from plain by "
                             f"more than {tol}; max abs error {err}")
        return err

    fq, fk, fv = q[:, :s], k[:, :s], v[:, :s]
    pos = positions[:, :s]
    got = flash_mod.flash_attention(fq, fk, fv, window=w)
    torch.cuda.synchronize()
    plain = lambda: sdpa(fq, fk, fv, pos, pos,  # noqa: E731
                         scale=1.0 / math.sqrt(cfg.head_dim), window=w)
    heads = f"{cfg.n_heads}, {cfg.n_kv_heads}, {cfg.head_dim}"
    flash_label = f"flash_attention [1, {s}, {heads}] window {w}"
    decode_label = f"decode_attention [1, {heads}, S={w}] the ring"
    errs = {"flash_attention": check(flash_label, got, plain())}
    if dt == torch.bfloat16:
        emu = ref.flash_attention_bf16_emulation(fq, fk, fv, window=w)
        e = flash_emu_err(got, emu)
        print(f"  {flash_label} bfloat16 vs emulation {e:.3e} beyond the "
              f"output's rounding (limit {FLASH_EMU_TOL})", flush=True)
        if e > FLASH_EMU_TOL:
            raise SystemExit(f"{flash_label}: kernel differs from its "
                             f"emulation by {e} (limit {FLASH_EMU_TOL})")
        del emu
    # the ring as serve_step leaves it after position s + steps - 1: rows
    # p % w for the last w positions, the last query's row written
    last = s + steps - 1
    slots = torch.arange(last - w + 1, last + 1, device=dev) % w
    rk = torch.empty_like(k[:, :w])
    rv = torch.empty_like(v[:, :w])
    rk[:, slots], rv[:, slots] = k[:, last - w + 1:], v[:, last - w + 1:]
    dq = q[:, last].contiguous()
    lengths = torch.full((1,), w, dtype=torch.int32, device=dev)
    got = decode_mod.decode_attention(dq, rk, rv, lengths)
    torch.cuda.synchronize()
    errs["decode_attention"] = check(
        decode_label, got, ref.decode_attention_ref(dq, rk, rv, lengths))
    if dt != torch.bfloat16:
        return errs
    mask = torch.ones((1, 1, 1, w), dtype=torch.bool, device=dev)
    qt, kt, vt = (x.transpose(1, 2) for x in (fq, fk, fv))
    q4, rkt, rvt = dq[:, :, None, :], rk.transpose(1, 2), rv.transpose(1, 2)
    win_mask = ((pos[0, :, None] >= pos[0, None, :])
                & (pos[0, :, None] - pos[0, None, :] < w))
    for label, fn, plain_fn, lib, cost, inner in (
            (flash_label,
             lambda: flash_mod.flash_attention(fq, fk, fv, window=w), plain,
             lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, attn_mask=win_mask, enable_gqa=True),
             flash_cost(fq, fk, w), 2),
            (decode_label,
             lambda: decode_mod.decode_attention(dq, rk, rv, lengths),
             lambda: ref.decode_attention_ref(dq, rk, rv, lengths),
             lambda: F.scaled_dot_product_attention(
                 q4, rkt, rvt, attn_mask=mask, enable_gqa=True),
             decode_cost(dq, rk, lengths), 20)):
        ms = graph_ms(fn, inner=inner, reps=4)
        plain_ms = graph_ms(plain_fn, inner=1, reps=2)
        try:
            lib_ms = f"{graph_ms(lib, inner=inner, reps=4) * 1e3:.2f} us"
        except (RuntimeError, ValueError, TypeError) as exc:
            lib_ms = f"n/a ({type(exc).__name__})"
        b_ms, b_by = bound(*cost, peak_flops=peak_for(dt))
        print(f"  {label}: kernel {ms * 1e3:.2f} us, plain "
              f"{plain_ms * 1e3:.2f} us, library {lib_ms}, bound "
              f"{b_ms * 1e3:.2f} us ({b_by})", flush=True)
    return errs


def window_phase(dev) -> dict:
    """Phase 39: the long-context window decode at full width (Llama-3.2-1B,
    window 8192, B = 1). In float32: WINDOW_RUNS through prefill and
    serve_step, every step's logits within CONSIST_TOL (relative L2) of the
    dense windowed prefill of the same tokens across the ring's wrap, the
    ring rows of layers WINDOW_RING_LAYERS within CONSIST_TOL of the dense
    prefill's; the two kernels against their plain versions. In bf16 the
    same runs, layer 0's ring gated (deeper, bf16 drifts; the last logits'
    relative L2 printed), the kernels again with times; params, the
    init_cache ring and int32 tokens and positions built as the dry run
    lays them out, the bytes they requested and memory_allocated's growth
    kept for phase 40; a prefill
    of WINDOW_RUNS[1][0] tokens (flash_attention = layers) timed, then
    WINDOW_EXIT_STEPS steps at each exit timed (every exit before any
    profiling) with decode_attention = exit a step by the wrappers, then
    WINDOW_PROFILED_STEPS steps at each exit by the profiler (up to
    PROFILE_TRIES windows until one reads them). Returns the launches of
    the runs driven (kernel checks left out), each kernel's largest error at
    the window's shapes, the bf16 ms a step by exit, the bytes requested,
    the memory growth, and the count of tensors built (and of those above
    1 MiB)."""
    from repro_torch.models import DecoderLM
    from repro_torch.train import make_serve_step

    t_phase = time.perf_counter()
    out = {"flash_attention": 0, "decode_attention": 0,
           "max_abs_err": {"flash_attention": 0.0, "decode_attention": 0.0}}
    for dtype in ("float32", "bfloat16"):
        cfg = window_cfg(dtype)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        gc.collect()
        torch.cuda.empty_cache()
        base = alloc_bytes()
        params = DecoderLM.init(gen, cfg, device=dev)
        if dtype == "bfloat16":
            # what the dry run's decode record counts: the params, the
            # init_cache ring over long_500k's 524288 positions, int32
            # tokens and positions [1]
            cache = DecoderLM.init_cache(cfg, 1, 524288, device=dev)
            tok_buf = torch.zeros((1,), dtype=torch.int32, device=dev)
            pos_buf = torch.zeros((1,), dtype=torch.int32, device=dev)
            torch.cuda.synchronize()
            out["growth"], out["requested"] = (
                a - b for a, b in zip(alloc_bytes(), base))
            built = [*_leaves(params), *cache["layers"], tok_buf, pos_buf]
            out["n_tensors"] = len(built)
            out["n_large"] = sum(t.numel() * t.element_size() > ALLOC_UNSPLIT
                                 for t in built)
            print(f"{cfg.arch_id} bf16: window {cfg.window}, ring "
                  f"{tuple(cache['layers'].k.shape)}; params, ring, tokens "
                  f"and positions: {out['n_tensors']} tensors "
                  f"({out['n_large']} above 1 MiB), requested "
                  f"{out['requested']} B, memory_allocated grew "
                  f"{out['growth']} B", flush=True)
        for s, steps in WINDOW_RUNS:
            r = window_run(dev, cfg, params, gen, s, steps, out)
            rings = {k: v for k, v in r.items() if "[" in k}
            print(f"  S={s} + {steps} steps (wrap at step "
                  f"{max(0, cfg.window - s)}): logits relative L2 largest "
                  f"{r['logits_max']:.3e} (step {r['worst_step']}), last "
                  f"{r['logits_last']:.3e}; ring vs dense "
                  + ", ".join(f"{k} {v:.3e}" for k, v in rings.items()),
                  flush=True)
            gated = dict(rings, logits=r["logits_max"]) \
                if dtype == "float32" else {k: rings[k] for k in
                                            ("k[0]", "v[0]")}
            worst = max(gated.values())
            if not worst <= CONSIST_TOL:
                raise SystemExit(f"window {dtype} S={s}: relative L2 {worst} "
                                 f"above {CONSIST_TOL} ({gated})")
        print(f"  {dtype} runs done {time.perf_counter() - t_phase:.2f} s "
              f"into the phase", flush=True)
        for k, e in window_kernel_checks(dev, cfg, params, gen).items():
            out["max_abs_err"][k] = max(out["max_abs_err"][k], e)
        print(f"  {dtype} kernel checks done "
              f"{time.perf_counter() - t_phase:.2f} s into the phase",
              flush=True)
        if dtype == "float32":
            del params
            continue
        # timed: the prefill, then each exit from its ring, with the
        # tensors built above
        s = WINDOW_RUNS[1][0]
        toks = torch.randint(0, cfg.vocab, (1, s + WINDOW_EXIT_STEPS),
                             generator=gen, device=dev)
        res = {}

        def prefill():
            res["t0"] = time.perf_counter()
            _, res["ring"], _ = DecoderLM.prefill(params, cfg, toks[:, :s])
            torch.cuda.synchronize()
            res["ms"] = (time.perf_counter() - res["t0"]) * 1e3

        counts = counted(prefill, {"flash_attention": cfg.n_layers},
                         "window prefill")
        out["flash_attention"] += counts["flash_attention"]
        cache["layers"].k.copy_(res["ring"]["layers"].k)
        cache["layers"].v.copy_(res["ring"]["layers"].v)
        del res["ring"]
        print(f"  prefill S={s}: {res['ms']:.3f} ms, launches {counts}",
              flush=True)

        def decode(step, steps=WINDOW_EXIT_STEPS):
            for t in range(steps):
                tok_buf.copy_(toks[:, s + t])
                pos_buf.fill_(s + t)
                step(params, cache, tok_buf, pos_buf)

        steps = {e: make_serve_step(cfg, exit_layer=e)
                 for e in cfg.exit_layers}
        decode(steps[cfg.exit_layers[0]])       # warm-up
        gc.collect()
        out["ms"] = {}
        for e, step in steps.items():
            want = {"decode_attention": e * WINDOW_EXIT_STEPS}
            t0 = time.perf_counter()
            counts = counted(lambda: decode(step), want, f"window exit {e}")
            out["ms"][e] = (time.perf_counter() - t0) / WINDOW_EXIT_STEPS * 1e3
            out["decode_attention"] += counts["decode_attention"]
        print(f"  timed runs: {sum(out['ms'].values()) * WINDOW_EXIT_STEPS / 1e3:.2f} s"
              f" ({time.perf_counter() - t_phase:.2f} s into the phase)",
              flush=True)
        for e, step in steps.items():
            busy, _, windows = profiled_until(
                lambda: decode(step, WINDOW_PROFILED_STEPS),
                {"decode_attention": e * WINDOW_PROFILED_STEPS},
                f"window exit {e}")
            ms = out["ms"][e]
            print(f"  exit {e:2d}: {ms:.3f} ms/step ({1e3 / ms:.1f} tokens/s)"
                  f"; decode_attention {e * WINDOW_EXIT_STEPS} in "
                  f"{WINDOW_EXIT_STEPS} steps by the wrapper, "
                  f"{windows[-1]} kernels in {WINDOW_PROFILED_STEPS} steps by "
                  f"the profiler (windows {'; '.join(windows)}), busy share "
                  f"{busy['device_ms'] / busy['wall_ms']:.1%}", flush=True)
        del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dryrun_phase(dev, window: dict) -> None:
    """Phase 40: ``python -m repro_torch.launch dryrun --sweep`` in-process
    into DRYRUN_OUT: 40 records, every one ok; each printed with its
    roofline time on the H100 (max(flops / 989e12, bytes / 3.35e12), the
    figures of mec/profiles.py); llama3_2_1b x long_500k's
    argument_size_in_bytes equal to the bytes phase 39's tensors requested
    from the caching allocator in bf16, and its memory_allocated growth
    within the allocator's rounding (ALLOC_ROUND a tensor, and
    ALLOC_UNSPLIT a tensor above it); its roofline beside the measured ms a
    step at the last exit."""
    from repro_torch.launch.__main__ import main as launch_main

    if os.path.exists(DRYRUN_OUT):
        os.remove(DRYRUN_OUT)
    t0 = time.perf_counter()
    launch_main(["dryrun", "--sweep", "--out", DRYRUN_OUT])
    wall = time.perf_counter() - t0
    with open(DRYRUN_OUT) as f:
        recs = [json.loads(line) for line in f]
    bad = [r for r in recs if not r.get("ok")]
    if len(recs) != 40 or bad:
        raise SystemExit(f"dryrun: {len(recs)} records, {len(bad)} not ok: "
                         f"{bad[:1]}")
    print(f"dryrun --sweep: 40 ok records in {wall:.2f} s (meta device)")
    for r in recs:
        roof = max(r["flops"] / PEAK_BF16, r["bytes_accessed"] / PEAK_BYTES)
        print(f"  {r['arch']:18s} {r['shape']:12s} flops {r['flops']:.4e} "
              f"bytes {r['bytes_accessed']:.4e} arguments "
              f"{r['argument_size_in_bytes'] / 1e9:9.3f} GB, roofline "
              f"{roof * 1e3:.4f} ms")
    rec = next(r for r in recs
               if (r["arch"], r["shape"]) == (LM_ARCH, "long_500k"))
    want, got = rec["argument_size_in_bytes"], window["growth"]
    slack = (ALLOC_ROUND * window["n_tensors"]
             + ALLOC_UNSPLIT * window["n_large"])
    print(f"{LM_ARCH} x long_500k: argument_size_in_bytes {want}; phase 39's "
          f"tensors requested {window['requested']} B, memory_allocated grew "
          f"{got} B (allowed {want}..{want + slack}: {window['n_tensors']} "
          f"tensors x {ALLOC_ROUND} B + {window['n_large']} x "
          f"{ALLOC_UNSPLIT} B)")
    if window["requested"] != want or not want <= got <= want + slack:
        raise SystemExit(f"dryrun: {want} argument bytes, but phase 39's "
                         f"tensors requested {window['requested']} B and "
                         f"took {got} B")
    roof = max(rec["flops"] / PEAK_BF16, rec["bytes_accessed"] / PEAK_BYTES)
    last = max(window["ms"])
    print(f"{LM_ARCH} x long_500k: measured {window['ms'][last]:.3f} ms a "
          f"step at exit {last} (bf16, phase 39) against a roofline of "
          f"{roof * 1e3:.4f} ms ({window['ms'][last] / (roof * 1e3):.1f}x)")


# ------------------------------------------- the three dense configs (41)
# StableLM-3B, InternLM2-20B and Chameleon-34B at full width, bf16, one at
# a time, Chameleon first: its 68.6 GB of weights run right after the
# build, where the allocator is cleanest (RWKV-6 at 11 layers ran out of
# memory after the script's earlier phases)
DENSE_MODELS = ("chameleon_34b", "internlm2_20b", "stablelm_3b")
# their float32 consistency runs at full width with the depth cut to this
DENSE_F32_LAYERS = 4
# init's peak may pass the bf16 params' bytes (2 x launch/analysis.py's
# _param_count) by at most this: the float32 draw of one matrix
INIT_SLACK = 2e9
# the model whose init is also held against the stacked draws on the card
# (both sets of params fit beside each other)
STACK_CHECK_ARCH = "stablelm_3b"
# the kernels at the GQA configs' shapes: prefill (InternLM2: 48 heads
# over 8, Chameleon: 64 over 8, d = 128) and decode at the serve batch;
# StableLM's (32 over 32, d = 80) are phase 28's ZAMBA_ATTN and
# ZAMBA_DECODE
DENSE_FLASH = (((PREFILL_B, PREFILL_S, 48, 8, 128), True),
               ((PREFILL_B, PREFILL_S, 64, 8, 128), True))
DENSE_DECODE = (((SERVE_B, 48, 8, 128, SERVE_CACHE), "random"),
                ((SERVE_B, 64, 8, 128, SERVE_CACHE), "random"))


def stacked_init(gen, cfg, dev):
    """``DecoderLM.init`` with every dense ``w`` leaf built as before the
    init wrote each matrix into its slice: each Xavier matrix drawn and
    cast, then the list stacked (twice the leaf at once)."""
    from repro_torch.models import lm

    new_leaf = lm._init_leaf

    def leaf(generator, name, shape, *, device, dtype):
        if name != "w":
            return new_leaf(generator, name, shape, device=device,
                            dtype=dtype)
        limit = math.sqrt(6.0 / (shape[-2] + shape[-1]))
        mats = [(torch.rand(shape[-2:], generator=generator, device=device)
                 * (2.0 * limit) - limit).to(dtype)
                for _ in range(math.prod(shape[:-2]))]
        return torch.stack(mats).reshape(shape)

    lm._init_leaf = leaf
    try:
        return lm.DecoderLM.init(gen, cfg, device=dev)
    finally:
        lm._init_leaf = new_leaf


def same_bits(a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(torch.int16 if a.element_size() == 2
                                   else torch.int32),
                            b.view(torch.int16 if b.element_size() == 2
                                   else torch.int32)))


def dense_model_phase(dev, arch) -> tuple:
    """Phase 41, one model: ``DecoderLM.init`` at full width in bf16
    (random weights from seed 0), its peak allocation at most the bf16
    params' bytes + INIT_SLACK (and, for STACK_CHECK_ARCH, equal bit for
    bit to the stacked draws); a PREFILL_B x PREFILL_S prefill (flash
    launches one a layer); greedy decoding at every exit (greedy_exits,
    prompts of ZOO_PROMPT_LENS tokens, ZOO_NEW new ones); prefill against
    teacher-forced decode over ZOO_CONSIST_P tokens, every
    layer printed, layer 0 within CONSIST_TOL; then float32 at full width
    cut to DENSE_F32_LAYERS layers, every layer and the logits within
    CONSIST_F32_TOL. Returns (launch totals, a summary row)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.analysis import _param_count
    from repro_torch.models import DecoderLM

    t_phase = time.perf_counter()
    cfg = get_arch(arch)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = DecoderLM.init(gen, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    leaves = list(_leaves(params))
    n = sum(x.numel() for x in leaves)
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    counted = _param_count(cfg)["total"]
    limit = 2 * counted + INIT_SLACK
    print(f"{cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} kv heads x {cfg.head_dim}, exits "
          f"{cfg.exit_layers}, {cfg.dtype}; {n / 1e9:.3f} B params "
          f"({nbytes / 1e9:.3f} GB) drawn in {init_s:.2f} s; init peak "
          f"{peak / 1e9:.3f} GB (allocated before it {base / 1e9:.3f} GB), "
          f"limit 2 x _param_count {counted / 1e9:.3f} B + "
          f"{INIT_SLACK / 1e9:.0f} GB = {limit / 1e9:.3f} GB", flush=True)
    if peak > limit:
        raise SystemExit(f"{arch}: init peaked at {peak} bytes, above "
                         f"{limit}")
    torch.cuda.empty_cache()
    if arch == STACK_CHECK_ARCH:
        old = stacked_init(torch.Generator(device=dev).manual_seed(SEED),
                           cfg, dev)
        same = all(same_bits(a, b) for a, b in zip(leaves, _leaves(old)))
        print(f"  init == the stacked draws, bit for bit, on the card: "
              f"{same}", flush=True)
        if not same:
            raise SystemExit(f"{arch}: the slice-written init differs from "
                             f"the stacked draws")
        del old
        torch.cuda.empty_cache()
    row = {"arch": cfg.arch_id, "params_b": n / 1e9, "init_s": init_s,
           "init_peak_gb": peak / 1e9, "init_limit_gb": limit / 1e9}

    torch.cuda.reset_peak_memory_stats()
    flash, prefill_ms = prefill_phase(dev, cfg, params, gen)
    row.update(prefill_ms=prefill_ms,
               prompt_tok_s=PREFILL_B * PREFILL_S / prefill_ms * 1e3,
               prefill_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"  prefill peak memory {row['prefill_peak_gb']:.3f} GB",
          flush=True)
    torch.cuda.empty_cache()
    decode, row["decode_ms"] = greedy_exits(dev, cfg, params,
                                            ZOO_PROMPT_LENS, ZOO_NEW)

    errs = decode_vs_prefill(dev, cfg, params, gen, ZOO_CONSIST_P)
    first = max(errs["k[0]"], errs["v[0]"])
    if not first <= CONSIST_TOL:
        raise SystemExit(f"{arch} consistency (bf16, layer 0): relative L2 "
                         f"{first} above {CONSIST_TOL}")
    row["consistency_bf16"] = {"layer0": first,
                               "worst": max(errs.values()),
                               "logits": errs["logits"]}
    del params, leaves
    gc.collect()
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                n_layers=DENSE_F32_LAYERS, exit_layers=())
    params = DecoderLM.init(torch.Generator(device=dev).manual_seed(SEED),
                            cfg32, device=dev)
    errs = decode_vs_prefill(dev, cfg32, params, gen, ZOO_CONSIST_P)
    worst = max(errs.values())
    if not worst <= CONSIST_F32_TOL:
        raise SystemExit(f"{arch} consistency (float32, {DENSE_F32_LAYERS} "
                         f"layers): relative L2 {worst} above "
                         f"{CONSIST_F32_TOL}")
    row["consistency_f32"] = worst
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {arch} wall {time.perf_counter() - t_phase:.2f} s; memory "
          f"allocated after it {torch.cuda.memory_allocated() / 1e9:.3f} GB, "
          f"reserved {torch.cuda.memory_reserved() / 1e9:.3f} GB", flush=True)
    return {"flash_attention": flash, "decode_attention": decode}, row


def dense_phase(dev) -> dict:
    """Phase 41: the kernels at the GQA configs' new shapes against their
    plain versions (attention_rows), then dense_model_phase for each of
    DENSE_MODELS. Returns the launch totals, the kernel rows and the model
    rows."""
    rows = attention_rows(dev, torch.Generator(device=dev).manual_seed(SEED),
                          DENSE_FLASH, DENSE_DECODE)
    torch.cuda.empty_cache()
    totals = {"flash_attention": 0, "decode_attention": 0}
    models = []
    for arch in DENSE_MODELS:
        counts, row = dense_model_phase(dev, arch)
        models.append(row)
        for k in totals:
            totals[k] += counts[k]
    print(json.dumps({"dense_models": models}))
    return {"launches": totals, "kernel_rows": rows, "models": models}


# ------------------------------------------ the fleet axis over the cards (46)
def fleet_run(dev, mesh, spec: dict, timed=None) -> dict:
    """Phase 46's three runs on ``mesh`` (None: the unsharded reference,
    in this process), the timed ones first: (a) ``run_sharded`` in scan
    mode, timed on a second run; (b) one population generation; (c) one
    sweep pack (unsharded: ``run_cell`` per cell); then ``timed()``, if
    given; then (a) again in loop mode for the wrappers' launch counts and
    in scan mode under the profiler. Returns host copies."""
    from repro_torch.core import agent_def
    from repro_torch.kernels import ops
    from repro_torch.mec import MECEnv, make_scenario
    from repro_torch.mec.scenarios import scenario_space
    from repro_torch.nn.pytree import tree_tensors
    from repro_torch.pop import Curriculum, PopulationTrainer
    from repro_torch.rollout import RolloutDriver
    from repro_torch.sweep import SweepSpec, pack_cells, run_cell, run_pack

    def host(tree):
        return [x.cpu().numpy() for x in tree_tensors(tree)]

    out = {}
    env = MECEnv(make_scenario("fig5_baseline"), device=dev)
    drv = RolloutDriver(agent_def("grle", env, device=dev), spec["B"],
                        train=True, device=dev)
    run = (drv.run if mesh is None else
           lambda *a, **k: drv.run_sharded(*a, mesh=mesh, **k))
    carry, trace = run(SEED, spec["T"], mode="scan")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, trace = run(SEED, spec["T"], mode="scan")
    torch.cuda.synchronize()
    out["slot_ms"] = (time.perf_counter() - t0) / spec["T"] * 1e3
    out["graphs"] = drv.graphs_captured

    c = dict(POP_FULL, members=spec["P"], slots=spec["pop_slots"])
    penv = MECEnv(make_scenario(c["space"][0], n_devices=c["n_devices"]),
                  device=dev)
    space = scenario_space(*c["space"], n_devices=c["n_devices"], device=dev)
    tr = PopulationTrainer(
        agent_def(c["method"], penv, device=dev),
        Curriculum(space.lo, space.hi, n_regions=c["regions"]),
        n_members=c["members"], n_fleets=c["fleets"], n_slots=c["slots"],
        seed=c["seed"], mesh=mesh, replay_capacity=c["replay"],
        batch_size=c["batch"], train_every=c["train_every"], telemetry=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, out["pop_report"], det = tr.generation(tr.init_state(), detail=True)
    torch.cuda.synchronize()
    out["pop_s"] = time.perf_counter() - t0
    out["pop_agents"] = host(ts.pop.agents)
    out["pop_metrics"] = host(det.metrics)
    del tr, ts, det

    sweep = SweepSpec.from_names(
        "fig5_baseline", "grle", spec["cells"], n_devices=14,
        n_slots=spec["cell_slots"], replay_capacity=64, batch_size=16,
        train_every=10)
    (pack,) = pack_cells(sweep.expand())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["rows"] = ([run_cell(cell, device=dev) for cell in pack.cells]
                   if mesh is None else run_pack(pack, mesh=mesh,
                                                 device=dev))
    torch.cuda.synchronize()
    out["cells_s"] = time.perf_counter() - t0
    if timed is not None:
        timed()

    ops.reset_launch_counts()
    loop = run(SEED, spec["T"], mode="loop")
    torch.cuda.synchronize()
    out["counts"] = ops.launch_counts()
    out["loop_same"] = same_run(loop, (carry, trace))
    out["trace"] = host(trace)
    out["ring"] = host(carry.agent_state.replay)
    out["params"] = host(carry.agent_state.params)
    out["carry"] = host(carry)
    out["metrics"] = drv.metrics(carry)
    out["n_train"] = int((~torch.isnan(trace.loss)).sum())
    # the scan episode under the profiler: its actor kernels on the device
    # and its cudaGraphLaunch calls, until a window reads them all (a
    # window can drop records; fleet_check gates the last one)
    n = spec["T"] + out["n_train"]
    want = {"gcn_agg": 4 * n, "edge_score": n}
    graphs = spec["T"] * (1 if mesh is None else 2)
    out["scan_windows"] = []
    for _ in range(PROFILE_TRIES):
        _, prof, seen = profiled_call(
            lambda: run(SEED, spec["T"], mode="scan"), tuple(want),
            lead=True)
        out["scan_windows"].append((prof, seen))
        if prof == want and seen == graphs:
            break
    out["scan_want"] = (want, graphs)
    return out


def fleet_rank(spec: dict) -> dict:
    """One rank of phase 46 (``RankPool`` runs it on every rank, its card
    current): ``fleet_run`` on a ``fleet`` mesh over the whole group,
    which has one rank on a one-card machine."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.sharding import FLEET_AXIS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(kind, (dist.get_world_size(),),
                            mesh_dim_names=(FLEET_AXIS,))
    out = fleet_run(torch.device("cuda"), mesh, spec)
    out["rank"], out["device"] = dist.get_rank(), torch.cuda.current_device()
    return out


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def fleet_profile_check(tag: str, run: dict) -> str:
    """The gate on ``fleet_run``'s profiled scan episode: no window reads
    more actor kernels or graph launches than expected, and the last one
    reads them all (4 gcn_agg and 1 edge_score a slot and a train step;
    one cudaGraphLaunch a slot unsharded, two sharded). Returns its
    reading as printed."""
    (want, graphs), windows = run["scan_want"], run["scan_windows"]
    if any(seen > graphs or any(prof[k] > n for k, n in want.items())
           for prof, seen in windows):
        raise SystemExit(f"{tag}: the profiler saw more than {want} and "
                         f"{graphs} graph launches: {windows}")
    if windows[-1] != (want, graphs):
        raise SystemExit(f"{tag}: no profiler window of the scan episode "
                         f"saw {want} and {graphs} graph launches: "
                         f"{windows}")
    return (f"profiled scan: {want['gcn_agg']} gcn_agg, "
            f"{want['edge_score']} edge_score, {graphs} cudaGraphLaunch "
            f"({len(windows)} window(s))")


def fleet_check(label, spec: dict, want: dict, ranks: list) -> None:
    """Phase 46's gates on every rank's runs against the unsharded ones:
    (a) the trace (decisions first), the ring, params and the whole final
    carry bit for bit, the metrics summary equal, scan equal to loop, and
    exactly 4 gcn_agg and 1 edge_score launches a slot and a train step,
    no other kernel, in the loop (the wrappers' counts) and on the device
    in the scan (the profiler's, with two graph launches a slot); (b) the
    population's report, agents and [P] metrics bit for bit; (c) the
    pack's rows equal to ``run_cell``'s."""
    n = spec["T"] + want["n_train"]
    launches = {"gcn_agg": 4 * n, "edge_score": n,
                "flash_attention": 0, "decode_attention": 0, "ssm_scan": 0}

    def same_arrays(xs, ys):
        return len(xs) == len(ys) and all(
            x.dtype == y.dtype and x.shape == y.shape and np.array_equal(
                np.atleast_1d(x).view(np.uint8),
                np.atleast_1d(y).view(np.uint8)) for x, y in zip(xs, ys))

    for r in ranks:
        tag = f"{label} rank {r['rank']} (cuda:{r['device']})"
        if not np.array_equal(r["trace"][0], want["trace"][0]):
            bad = np.argwhere((r["trace"][0] != want["trace"][0]).any(-1))
            raise SystemExit(f"{tag}: decisions differ at (slot, fleet) "
                             f"{bad[:5].tolist()}")
        for key in ("trace", "ring", "params", "carry", "pop_agents",
                    "pop_metrics"):
            if not same_arrays(r[key], want[key]):
                raise SystemExit(f"{tag}: {key} differs from the unsharded "
                                 f"run")
        if r["metrics"] != want["metrics"] or not r["loop_same"]:
            raise SystemExit(f"{tag}: metrics {r['metrics']} vs "
                             f"{want['metrics']}, scan == loop "
                             f"{r['loop_same']}")
        if r["counts"] != launches:
            raise SystemExit(f"{tag}: launches {r['counts']}, expected "
                             f"{launches}")
        if r["pop_report"] != want["pop_report"]:
            raise SystemExit(f"{tag}: population report differs")
        if r["rows"] != want["rows"]:
            raise SystemExit(f"{tag}: sweep rows differ from run_cell's")
        profiled = fleet_profile_check(tag, r)
        print(f"  {tag}: decisions, ring, params, carry, metrics equal; "
              f"launches {r['counts']['gcn_agg']} gcn_agg, "
              f"{r['counts']['edge_score']} edge_score; {profiled}; slot "
              f"{r['slot_ms']:.4f} ms (scan, {r['graphs']} graphs "
              f"captured); population generation {r['pop_s']:.4f} s; "
              f"{len(r['rows'])} cell rows in {r['cells_s']:.4f} s",
              flush=True)


def fleet_phase(dev) -> dict:
    """Phase 46: the fleet, member and cell axes over the cards. One rank a
    card (``torch.cuda.device_count()``, NCCL, ``RankPool``: rank r on
    cuda:r) runs ``fleet_run`` on a ``fleet`` mesh over the group, after
    phase 2 built the kernels (the ranks load them); this process runs the
    same unsharded, and ``fleet_check`` holds every rank against it. On one
    card two gloo ranks sharing it run it next. The ranks start once this
    process's timed runs are done, and all have joined their groups before
    the NCCL ranks' runs, so no rank starts beside a timed run. Returns the
    ranks' launch counts, summed."""
    from repro_torch.sharding.ranks import RankPool
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    world = torch.cuda.device_count()
    spec = dict(B=FLEET_B, T=FLEET_T, P=4 * world,
                cells=world + 1 if world > 1 else 3,
                pop_slots=FLEET_POP_SLOTS, cell_slots=FLEET_CELL_SLOTS)
    print(f"world {world} (one NCCL rank a card): GRLE fig5_baseline M=14, "
          f"ring 128, minibatch 64, omega 10, B={FLEET_B}, T={FLEET_T}; "
          f"population P={spec['P']} x {FLEET_POP_SLOTS} slots at M=14; "
          f"{spec['cells']} cells x {FLEET_CELL_SLOTS} slots")
    if world == 1:
        print("one card: the group has one rank, so the all-gathers carry "
              "one block; the law across several ranks is held by the CPU "
              "tests (tests/test_torch_sharded_rollout.py, gloo, 2 and 4 "
              "ranks) and by two gloo ranks sharing this card below (the "
              "same runs: P=4 is 2 members a rank, 3 cells pad to 4)")
    with contextlib.ExitStack() as stack:
        pools = []

        def start_ranks():
            pools.append(stack.enter_context(RankPool(
                world, backend="nccl", cuda_devices=list(range(world)),
                init_method=f"tcp://localhost:{free_port()}", threads=4,
                timeout_s=FLEET_TIMEOUT_S)))
            if world == 1:
                pools.append(stack.enter_context(RankPool(
                    2, backend="gloo", cuda_devices=[0, 0],
                    init_method=f"tcp://localhost:{free_port()}",
                    threads=4, timeout_s=FLEET_TIMEOUT_S)))

        want = fleet_run(dev, None, spec, timed=start_ranks)
        profiled = fleet_profile_check("unsharded", want)
        print(f"  unsharded: slot {want['slot_ms']:.4f} ms (scan, "
              f"{want['graphs']} graphs captured), {want['n_train']} train "
              f"steps; {profiled}; population generation "
              f"{want['pop_s']:.4f} s; {len(want['rows'])} run_cell rows "
              f"in {want['cells_s']:.4f} s", flush=True)
        t0 = time.perf_counter()
        for pool in pools:
            pool.run(os.getpid)
        print(f"  every rank joined {time.perf_counter() - t0:.2f} s after "
              f"the unsharded runs", flush=True)
        runs = []
        for label, pool in zip(("nccl", "gloo, shared card"), pools):
            t0 = time.perf_counter()
            runs.append(pool.run(fleet_rank, spec))
            pool.close()
            print(f"  {pool.world} {label} rank(s) run and ended in "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
            fleet_check(label, spec, want, runs[-1])
    counts = {k: sum(r["counts"][k] for run in runs for r in run)
              for k in runs[0][0]["counts"]}
    print(f"graph launches a slot: sharded 2 (the fleets' half, then the "
          f"learner's; the all-gather between them outside the graphs), "
          f"unsharded 1")
    print(f"phase 46 wall {time.perf_counter() - t_phase:.2f} s")
    return counts


# --------------------------------------------------------- the examples (42)
EXAMPLES_STORE = os.path.join(ROOT, "build", "chip_smoke_sweep_figures")
EXAMPLES_CKPT = os.path.join(ROOT, "build", "chip_smoke_llama100m.ckpt")
# the reference's quickstart, and its scenario fleet, at their defaults
QUICKSTART_SLOTS = 400
FLEET_SLOTS, FLEET_FLEETS = 300, 8
# cuts by the examples' own flags, to keep the script inside its time
# limit: the scenario fleet's profiled rerun at 30 slots (the profiler's
# pass over ~1100 kernel records a slot was most of its time; the run at
# the defaults goes unprofiled) and the 100M trainer at 30 of its 300
# steps
FLEET_PROFILED_SLOTS = 30
TRAIN_100M_STEPS = 30


def example_run(name, argv, label, call=None):
    """``examples/<name>.py``'s ``main(argv)`` (or ``call(module, argv)``)
    in-process from zeroed launch counts -> (its result, wall s, the
    wrappers' launches)."""
    from repro_torch.kernels import ops

    ex = load_example(name)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = ex.main(list(argv)) if call is None else call(ex, list(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"  [{label}] wall {wall:.2f} s; wrapper launches {counts}",
          flush=True)
    return out, wall, counts


def actor_ratio(label, counts, *, attention=0):
    """A GRLE path's wrapper launches: gcn_agg four a forward, edge_score
    one, some of each; no ssm_scan, and no attention unless ``attention``
    says how many."""
    if (counts["gcn_agg"] != 4 * counts["edge_score"]
            or counts["edge_score"] == 0 or counts["ssm_scan"]
            or counts["flash_attention"] + counts["decode_attention"]
            != attention):
        raise SystemExit(f"{label}: launches {counts}")


def check_pop_result(out, args) -> tuple:
    """``compare_curriculum_dr``'s result as the population example reads
    it at ``args``: both arms with finite evaluations at each eval point,
    ``args.regions`` region counts summing to members x generations, a
    finite margin equal to the arms' difference and the verdict its sign
    (the sign itself not gated). Returns the arms' (curriculum, DR) eval
    means."""
    arms = out.get("arms", {})
    points = [float(t) for t in args.eval_points.split(",")]
    if (set(out) != {"eval_points", "arms", "margin", "curriculum_wins"}
            or sorted(arms) != ["curriculum", "dr"]
            or out["eval_points"] != points
            or any(set(r) != {"eval_rewards", "eval_mean", "final_train",
                              "region_visits"}
                   or len(r["eval_rewards"]) != len(points)
                   or not all(math.isfinite(x) for x in r["eval_rewards"])
                   or len(r["region_visits"]) != args.regions
                   or sum(r["region_visits"])
                   != args.members * args.generations
                   for r in arms.values())):
        raise SystemExit(f"population: result malformed: {out}")
    means = (arms["curriculum"]["eval_mean"], arms["dr"]["eval_mean"])
    if (not math.isfinite(out["margin"])
            or abs(out["margin"] - (means[0] - means[1])) > 1e-12
            or out["curriculum_wins"] != (out["margin"] > 0)):
        raise SystemExit(f"population: margin {out['margin']} and verdict "
                         f"{out['curriculum_wins']} do not match the arms' "
                         f"eval means {means}")
    return means


def examples_phase(dev) -> dict:
    """Phase 42: the six examples ported from the reference, in-process at
    their defaults (the sweep's store and the trainer's checkpoint under
    build/; the trainer at TRAIN_100M_STEPS steps), each printed with its
    wall time and rate, their wrappers' launches gated: the quickstart
    exactly 4 gcn_agg and 1 edge_score a GRLE forward (decisions and train
    steps) and none for DROO; the scenario fleet's scan episodes by the
    profiler's device records in a rerun at FLEET_PROFILED_SLOTS (the
    captured graphs replay without the wrappers), the same counts, warm-up
    slots included; the sweep and the population 4:1 (their replays
    uncounted, so their launches stay out of the sum); the population
    through the example's ``compare``: its result's layout and finite
    margin gated, the verdict printed but not gated (the margin's sign
    moves with the seed, ROADMAP queue 3); the serving example its
    decisions' actor launches and decode_attention exit x (prompt + new
    tokens) a group; the 100M
    trainer 12 flash launches a step, then the loss of one batch trained
    on three times falling at every step, and the checkpoint read back
    equal. Returns the exact launches summed: the quickstart's, the
    serving example's and the trainer's wrapper counts and the scenario
    fleet's profiled ones."""
    import shutil

    from repro_torch.train.checkpoint import restore_checkpoint

    totals = {"gcn_agg": 0, "edge_score": 0, "flash_attention": 0,
              "decode_attention": 0, "ssm_scan": 0}
    rows = {}

    def add(counts):
        for k in totals:
            totals[k] += counts.get(k, 0)

    # quickstart: GRLE vs DROO, one network of 14 devices, per-slot steps
    out, wall, counts = example_run("torch_quickstart", (), "quickstart")
    ts = out["train_steps"]["grle"]
    want = {"gcn_agg": 4 * (QUICKSTART_SLOTS + ts),
            "edge_score": QUICKSTART_SLOTS + ts, "flash_attention": 0,
            "decode_attention": 0, "ssm_scan": 0}
    print(f"  quickstart: GRLE {out['grle']}, DROO {out['droo']}, train steps "
          f"{out['train_steps']}; {2 * QUICKSTART_SLOTS / wall:.1f} slots/s; "
          f"expected {want}", flush=True)
    if counts != want:
        raise SystemExit(f"quickstart: launches {counts}, expected {want}")
    add(counts)
    rows["quickstart"] = dict(wall_s=wall,
                              slots_s=2 * QUICKSTART_SLOTS / wall,
                              grle=out["grle"], droo=out["droo"])

    # scenario fleet: per-fleet scenarios, scan episodes; the profiler
    # counts the replays' kernels: the training driver's 2 warm-up slots
    # and 1 warm-up train step, its decisions and train steps; the
    # evaluation driver's warm-up slot and 3 x slots // 2 decisions
    out, wall, counts = example_run("torch_scenario_fleet", (),
                                    "scenario fleet")
    actor_ratio("scenario fleet", counts)
    fleet_slots = FLEET_FLEETS * (FLEET_SLOTS + 3 * (FLEET_SLOTS // 2))
    print(f"  scenario fleet: train {out['train']}; eval {out['eval']}; "
          f"{fleet_slots / wall:.1f} fleet-slots/s", flush=True)
    if out["train"]["train_steps"] != FLEET_SLOTS // 10:
        raise SystemExit(f"scenario fleet: {out['train']['train_steps']} "
                         f"train steps, expected one every 10 slots")
    n = FLEET_PROFILED_SLOTS
    forwards = (n + n // 10 + 3) + (3 * (n // 2) + 1)
    ex = load_example("torch_scenario_fleet")
    _, prof, windows = profiled_until(
        lambda: ex.main(["--slots", str(n)]),
        {"gcn_agg": 4 * forwards, "edge_score": forwards}, "scenario fleet")
    print(f"  scenario fleet at --slots {n} under the profiler: {prof} "
          f"({forwards} actor forwards; windows {windows})", flush=True)
    add(prof)
    rows["scenario_fleet"] = dict(wall_s=wall,
                                  fleet_slots_s=fleet_slots / wall,
                                  train=out["train"], eval=out["eval"])

    # the paper's figure grid through the sweep
    shutil.rmtree(EXAMPLES_STORE, ignore_errors=True)
    try:
        report, wall, counts = example_run(
            "torch_sweep_paper_figures",
            ("--store", EXAMPLES_STORE, "--report",
             EXAMPLES_STORE + "_report.json"), "sweep")
    finally:
        shutil.rmtree(EXAMPLES_STORE, ignore_errors=True)
        if os.path.exists(EXAMPLES_STORE + "_report.json"):
            os.unlink(EXAMPLES_STORE + "_report.json")
    actor_ratio("sweep", counts)
    cells = report["grid"]["cells"]
    ratios = {s: e["ratios"] for s, e in report["scenarios"].items()}
    if cells != 40 or len(ratios) != 5 or any(
            sorted(r) != ["grle_vs_droo", "grle_vs_drooe", "grle_vs_grl"]
            or not all(math.isfinite(v) for x in r.values()
                       for v in x.values()) for r in ratios.values()):
        raise SystemExit(f"sweep: {cells} cells, ratios {ratios}")
    print(f"  sweep: {cells} cells, {cells / wall:.3f} cells/s; ratios "
          f"{json.dumps(ratios)}", flush=True)
    rows["sweep"] = dict(wall_s=wall, cells_s=cells / wall, ratios=ratios)

    # curriculum vs DR through the example's compare(): its main asserts
    # the curriculum wins, a sign that moves with the seed
    out, wall, counts = example_run(
        "torch_pop_curriculum", (), "population",
        call=lambda ex, argv: ex.compare(ex.parse_args(argv)))
    actor_ratio("population", counts)
    args = load_example("torch_pop_curriculum").parse_args([])
    means = check_pop_result(out, args)
    member_slots = 2 * args.members * args.generations * args.slots
    print(f"  population: margin {out['margin']:+.6f} (curriculum "
          f"{means[0]:.6f}, DR {means[1]:.6f}), curriculum wins: "
          f"{out['curriculum_wins']} (not gated); region visits "
          f"{out['arms']['curriculum']['region_visits']} vs "
          f"{out['arms']['dr']['region_visits']}; {member_slots / wall:.1f} "
          f"member-slots/s", flush=True)
    rows["pop_curriculum"] = dict(wall_s=wall,
                                  member_slots_s=member_slots / wall,
                                  margin=out["margin"],
                                  curriculum_wins=out["curriculum_wins"])

    # edge serving, decoding: reduced Qwen, two replicas, 12 slots of 4
    out, wall, counts = example_run("torch_edge_serving", ("--decode",),
                                    "edge serving")
    decisions = len(out["slots"]) + out["train_steps"]
    dec = sum(e * (6 + 4) for slot in out["slots"]
              for e in {e for _, e in slot["assignments"]})
    want = {"gcn_agg": 4 * decisions, "edge_score": decisions,
            "flash_attention": 0, "decode_attention": dec, "ssm_scan": 0}
    print(f"  edge serving: {out['summary']}; "
          f"{len(out['slots']) / wall:.2f} slots/s; expected {want}",
          flush=True)
    if counts != want:
        raise SystemExit(f"edge serving: launches {counts}, expected {want}")
    add(counts)
    rows["edge_serving"] = dict(wall_s=wall,
                                slots_s=len(out["slots"]) / wall,
                                summary=out["summary"])

    # the 100M trainer: float32 steps, flash one a layer a step
    if os.path.exists(EXAMPLES_CKPT):
        os.unlink(EXAMPLES_CKPT)
    out, wall, counts = example_run(
        "torch_train_100m", ("--steps", str(TRAIN_100M_STEPS),
                             "--checkpoint", EXAMPLES_CKPT), "train 100m")
    cfg = load_example("torch_train_100m").CONFIG_100M
    steps = len(out["losses"])
    want = {"gcn_agg": 0, "edge_score": 0,
            "flash_attention": cfg.n_layers * steps, "decode_attention": 0,
            "ssm_scan": 0}
    step_ms = sorted(out["step_s"][1:])[(steps - 1) // 2] * 1e3
    print(f"  train 100m: {out['n_params']:,} params, loss "
          f"{out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}, last metrics "
          f"{out['metrics']}; step {step_ms:.2f} ms (median after the "
          f"first), {1e3 / step_ms:.1f} steps/s; expected {want}",
          flush=True)
    if counts != want or not all(math.isfinite(x) for x in out["losses"]):
        raise SystemExit(f"train 100m: launches {counts}, expected {want}; "
                         f"or a loss is not finite")
    add(counts)
    fixed = fixed_batch_losses(cfg, out["state"], out["next_batch"]())
    print(f"  {FIXED_STEPS} AdamW steps (lr {FIXED_LR}) on one batch from "
          f"the trained params: loss {' -> '.join(f'{x:.4f}' for x in fixed)}",
          flush=True)
    if not all(math.isfinite(x) for x in fixed) or not all(
            b < a for a, b in zip(fixed, fixed[1:])):
        raise SystemExit(f"train 100m: the loss of a batch trained on did "
                         f"not fall at every step: {fixed}")
    back = restore_checkpoint(EXAMPLES_CKPT, like=out["state"].params)
    same = all(torch.equal(a, b) for a, b in zip(
        _leaves(back), _leaves(out["state"].params)))
    del back
    size = os.path.getsize(EXAMPLES_CKPT)
    os.unlink(EXAMPLES_CKPT)
    print(f"  checkpoint: {size / 1e6:.1f} MB (zlib), read back equal: "
          f"{same}", flush=True)
    if not same:
        raise SystemExit("train 100m: the checkpoint does not read back "
                         "equal to the params")
    rows["train_100m"] = dict(wall_s=wall, step_ms=step_ms,
                              steps_s=1e3 / step_ms,
                              loss_first=out["losses"][0],
                              loss_last=out["losses"][-1], fixed=fixed)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"examples": rows}))
    return totals


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    from repro_torch.core import agent_def, agent_state_from_params
    from repro_torch.kernels import _build, ops
    from repro_torch.mec import MECEnv, SlotTasks, make_scenario
    from repro_torch.rollout import RolloutDriver, SlotDraws

    dev = torch.device("cuda")

    phase(1, "card")
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    phase(2, "build")
    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"built {sorted(report)} in {time.perf_counter() - t0:.2f} s "
          f"(already present: {sorted(set(_build.KERNELS) - set(report))})")
    for name in _build.KERNELS:
        log = _build.build_log(name)
        for fn, regs, spills, smem in ptxas_report(log):
            print(f"  {name}: {fn}: {regs} registers, spill stores/loads "
                  f"{spills}, {smem} bytes smem")
        serialized = sorted({w for w in WGMMA_SERIALIZED if w in log})
        if serialized:
            raise SystemExit(f"{name}: ptxas serialized its wgmma (warnings "
                             f"{serialized}); keep every wgmma and its wait "
                             f"out of branches")
    print(f"no wgmma serialized (ptxas warnings {WGMMA_SERIALIZED})")

    # phase 41 runs here, right after the build, where the allocator is
    # cleanest: Chameleon-34B's weights take 68.6 GB of the card's 80
    phase(41, "StableLM-3B, InternLM2-20B and Chameleon-34B at full width, "
              "bf16: init, prefill, early-exit decode, consistency")
    t0 = time.perf_counter()
    dense = dense_phase(dev)
    print(f"phase 41 wall {time.perf_counter() - t0:.2f} s")

    phase(3, "kernels vs plain versions on the card")
    env = MECEnv(make_scenario("fig5_baseline"), device=dev)
    adef = agent_def("grle", env, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = adef.init(gen).params
    floor_ms = launch_floor_ms(dev)
    print(f"launch floor: {floor_ms * 1e3:.2f} us (graph replay of a "
          f"one-element in-place add)")
    stats = {"gcn_agg": {}, "edge_score": {}}
    for b in ACTOR_BATCHES:
        first = {"gcn_agg": 0.0, "edge_score": 0.0}
        for kernel, name, args, fn, plain, cost in actor_cases(
                env, params, gen, b):
            got = fn(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ms = graph_ms(lambda: fn(*args))
            plain_ms = graph_ms(lambda: plain(*args))
            call_ms = eager_ms(lambda: fn(*args))
            b_ms, b_by = bound(*cost)
            info = actor_info(kernel, args, dev)
            first_us = FIRST_DESIGN_US[kernel][name][b]
            first[kernel] += first_us
            print(f"  {kernel:10s} {name:14s} B={b:4d} {info}  max_abs_err "
                  f"{err:.3e}  kernel {ms * 1e3:8.2f} us (first design "
                  f"{first_us:.2f})  plain {plain_ms * 1e3:8.2f} us  eager "
                  f"call {call_ms * 1e3:8.2f} us  bound {b_ms * 1e3:6.3f} us "
                  f"({b_by})", flush=True)
            if not err <= TOL:
                raise SystemExit(f"{kernel} {name} B={b}: max abs error "
                                 f"{err} above {TOL}")
            s = stats[kernel].setdefault(b, dict(err=0.0, ms=0.0, plain=0.0,
                                                 bytes=0, flops=0))
            s["err"] = max(s["err"], err)
            s["ms"] += ms
            s["plain"] += plain_ms
            s["bytes"] += cost[0]
            s["flops"] += cost[1]
        for kernel, s in stats.items():
            print(f"  {kernel:10s} per slot B={b:4d}: kernel "
                  f"{s[b]['ms'] * 1e3:8.2f} us (first design "
                  f"{first[kernel]:.2f}), plain {s[b]['plain'] * 1e3:8.2f} us, "
                  f"bound {bound(s[b]['bytes'], s[b]['flops'])[0] * 1e3:.3f} us",
                  flush=True)

    phase(4, "golden replay of a JAX run")
    golden_phase(dev, "loop")

    phase(5, "main path: GRLE fig5_baseline, full width")
    drv = RolloutDriver(adef, N_FLEETS, train=False, device=dev)
    drv.run(SEED + 1, 5, mode="loop")           # warm-up: allocator, cuBLAS
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    carry, trace = drv.run(SEED, N_SLOTS, mode="loop")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    m = drv.metrics(carry)
    print(f"M={env.M} N={env.N} L={env.L} hidden={adef.hidden} "
          f"candidates={adef.n_candidates}+{adef.n_random} B={N_FLEETS} "
          f"T={N_SLOTS}")
    print(f"ssp {m['ssp']:.6f}  avg_accuracy {m['avg_accuracy']:.6f}  "
          f"avg_reward {m['avg_reward']:.6f}  tasks {int(m['tasks'])}")
    print(f"wall {wall:.4f} s  fleet-slots/s {N_FLEETS * N_SLOTS / wall:.1f}  "
          f"slot {wall / N_SLOTS * 1e3:.3f} ms")
    print(f"launches {counts}")
    if counts != {"gcn_agg": 4 * N_SLOTS, "edge_score": N_SLOTS,
                  "flash_attention": 0, "decode_attention": 0,
                  "ssm_scan": 0}:
        raise SystemExit(f"launch counts {counts}, expected gcn_agg "
                         f"{4 * N_SLOTS} and edge_score {N_SLOTS}")
    dec = trace.decisions
    if (tuple(dec.shape) != (N_SLOTS, N_FLEETS, env.M)
            or dec.dtype != torch.int32 or int(dec.min()) < 0
            or int(dec.max()) >= env.N * env.L
            or not bool(torch.isfinite(trace.reward).all())
            or not 0.0 < m["ssp"] <= 1.0
            or not 0.0 < m["avg_accuracy"] <= float(env.exit_acc.max())):
        raise SystemExit("main path output malformed")

    phase(6, "attention kernels vs plain versions on the card")
    attn = attention_phase(dev)

    phase(7, "LM golden replay of a JAX run (reduced Llama, f32)")
    lm_golden_phase(dev)

    phase(8, "LM prefill: llama3_2_1b, full width, bf16")
    cfg, params, lm_gen = lm_model(dev)
    flash_launches, _ = prefill_phase(dev, cfg, params, lm_gen)

    phase(9, "LM serve: greedy early-exit decoding, full width, bf16")
    decode_launches = serve_phase(dev, cfg, params, lm_gen)

    phase(10, "LM consistency: prefill vs teacher-forced decode")
    consistency_phase(dev, cfg, params, lm_gen)
    del params
    torch.cuda.empty_cache()

    phase(11, "ssm_scan vs its plain version on the card")
    ssm = ssm_scan_phase(dev)

    phase(12, "RWKV golden replay of a JAX run (reduced RWKV-6, f32)")
    rwkv_golden_phase(dev)

    phase(13, "RWKV prefill: rwkv6_7b, full width, bf16")
    cfg, params, lm_gen = lm_model(dev, SSM_ARCH)
    ssm_launches = rwkv_prefill_phase(dev, cfg, params, lm_gen)

    phase(14, "RWKV serve: greedy early-exit decoding, full width, bf16")
    rwkv_serve_phase(dev, cfg, params, lm_gen)

    phase(15, "RWKV consistency: prefill vs teacher-forced decode")
    rwkv_consistency_phase(dev, cfg, params, lm_gen)
    del params
    torch.cuda.empty_cache()

    phase(16, "training: actor kernels' gradients vs autograd of their "
              "plain versions")
    grad_err = grad_phase(dev, env, adef.init(gen).params, gen)

    phase(17, "training: golden replay of a JAX train=True run")
    train_golden_phase(dev)

    phase(18, "training path: GRLE fig5_baseline, full width, train=True")
    counts = train_path_phase(dev, adef)

    phase(19, "the compiled episode: RolloutDriver.run(mode=\"scan\")")
    compiled_episode_phase(dev, adef)

    phase(20, "serving: golden replay of a JAX EdgeServingEngine run")
    t0 = time.perf_counter()
    serve_golden_phase(dev)
    print(f"phase 20 wall {time.perf_counter() - t0:.2f} s")

    phase(21, "serving at full width: Llama-3.2-1B behind GRLE, sync and "
              "async")
    t0 = time.perf_counter()
    serve_path_phase(dev)
    print(f"phase 21 wall {time.perf_counter() - t0:.2f} s")

    phase(22, "dynamic and baseline golden replay of JAX train=True runs")
    t0 = time.perf_counter()
    dyn_golden_phase(dev)
    print(f"phase 22 wall {time.perf_counter() - t0:.2f} s")

    phase(23, "the paper's four methods at full width: fig8_csi, "
              "dyn_bursty, a domain-randomized fleet")
    methods_phase(dev)

    phase(24, "the paper's results grid through repro_torch.sweep")
    sweep_phase(dev)

    phase(25, "population: golden replay of a JAX PopulationTrainer run")
    pop_golden_phase(dev)

    phase(26, "population training at full width: GRLE, P=16, PBT and "
              "curriculum")
    pop_phase(dev)

    phase(27, "observability: the profile CLI's trace, hot program costs")
    obs_phase(dev)
    # the zoo's models need the card's memory: whatever the earlier phases
    # left unreferenced goes
    gc.collect()
    torch.cuda.empty_cache()
    print(f"memory allocated before the zoo: "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB")

    phase(28, "the attention and scan kernels at the zoo's new shapes vs "
              "their plain versions")
    t0 = time.perf_counter()
    zoo_rows = zoo_kernels_phase(dev)
    print(f"phase 28 wall {time.perf_counter() - t0:.2f} s")

    phase(29, "zoo golden replay of JAX runs (reduced Zamba2, DeepSeek-MoE, "
              "DeepSeek-V2, Whisper, f32)")
    t0 = time.perf_counter()
    zoo_golden_phase(dev)
    print(f"phase 29 wall {time.perf_counter() - t0:.2f} s")

    phase(30, "the zoo at full width, bf16: prefill, early-exit decode, "
              "consistency")
    t0 = time.perf_counter()
    zoo_totals = {"flash_attention": 0, "decode_attention": 0, "ssm_scan": 0}
    zoo_models = []
    for arch, b, s, layers in ZOO_MODELS:
        totals, row = zoo_model_phase(dev, arch, b, s, layers)
        zoo_models.append(row)
        for k in zoo_totals:
            zoo_totals[k] += totals[k]
    print(json.dumps({"zoo_models": zoo_models}))
    print(f"phase 30 wall {time.perf_counter() - t0:.2f} s")

    phase(31, "the slice's main path: Zamba2-2.7B behind GRLE "
              "(repro_torch.launch.serve)")
    t0 = time.perf_counter()
    zoo_serve = zoo_serve_phase(dev)
    print(f"phase 31 wall {time.perf_counter() - t0:.2f} s")

    phase(33, "the flash Function: the kernel forward, the plain version's "
              "backward")
    t0 = time.perf_counter()
    flash_fn = flash_function_phase(dev)
    print(f"phase 33 wall {time.perf_counter() - t0:.2f} s")

    phase(34, "training golden replay of JAX runs (reduced Llama, "
              "DeepSeek-MoE, Whisper, RWKV-6, Zamba2, f32)")
    t0 = time.perf_counter()
    lm_train_golden_phase(dev)
    print(f"phase 34 wall {time.perf_counter() - t0:.2f} s")

    phase(35, "path A: LM training, Llama-3.2-1B at full width, bf16 "
              "(repro_torch.launch.train)")
    t0 = time.perf_counter()
    train_counts = lm_train_phase(dev)
    print(f"phase 35 wall {time.perf_counter() - t0:.2f} s")

    phase(36, "path B: the paper's multi-exit VGG-16, trained, profiled on "
              "the card, GRLE on its profile")
    t0 = time.perf_counter()
    vgg_counts = vgg_path_phase(dev)
    print(f"phase 36 wall {time.perf_counter() - t0:.2f} s")

    phase(37, "the scan Function: the kernel forward, the plain chunked "
              "backward")
    t0 = time.perf_counter()
    ssm_fn = ssm_function_phase(dev)
    print(f"phase 37 wall {time.perf_counter() - t0:.2f} s")

    phase(38, "the SSM configs trained at full width, bf16: Zamba2-2.7B "
              f"(repro_torch.launch.train), RWKV-6-7B cut to "
              f"{RWKV_TRAIN_LAYERS} layers")
    t0 = time.perf_counter()
    ssm_train = ssm_train_phase(dev)
    print(f"phase 38 wall {time.perf_counter() - t0:.2f} s")

    phase(39, "the long-context window decode: Llama-3.2-1B under "
              "arch_for_shape(long_500k), window 8192, f32 and bf16")
    t0 = time.perf_counter()
    window = window_phase(dev)
    print(f"phase 39 wall {time.perf_counter() - t0:.2f} s")

    phase(40, "the one-card dry run: python -m repro_torch.launch dryrun "
              "--sweep")
    t0 = time.perf_counter()
    dryrun_phase(dev, window)
    print(f"phase 40 wall {time.perf_counter() - t0:.2f} s")

    phase(42, "the examples ported from the reference, at their defaults")
    t0 = time.perf_counter()
    ex_counts = examples_phase(dev)
    print(f"phase 42 wall {time.perf_counter() - t0:.2f} s")

    phase(44, "the continuous engine: golden replay of a JAX "
              "ContinuousServingEngine run at the serve-bench's --quick "
              "shape")
    t0 = time.perf_counter()
    serve_async_golden_phase(dev)
    print(f"phase 44 wall {time.perf_counter() - t0:.2f} s")

    phase(45, "the slice's main path: python -m repro_torch.launch "
              "serve-bench, the sync slot loop against continuous batching")
    t0 = time.perf_counter()
    bench_counts, bench_err = serve_bench_phase(dev)
    print(f"phase 45 wall {time.perf_counter() - t0:.2f} s")

    phase(46, "the fleet axis over the cards: run_sharded, a population "
              "generation and a sweep pack on one rank a card (NCCL) "
              "against the unsharded runs")
    fleet_counts = fleet_phase(dev)

    phase(43, "summary")
    sources = {"gcn_agg": ("src/repro_torch/csrc/gcn_agg.cu",
                           "src/repro/kernels/gcn_agg.py:40"),
               "edge_score": ("src/repro_torch/csrc/edge_score.cu",
                              "src/repro/kernels/edge_score.py:45")}
    kernels = []
    for name, (source, replaces) in sources.items():
        s = stats[name][N_FLEETS]
        b_ms, b_by = bound(s["bytes"], s["flops"])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": counts[name] + zoo_serve[name] + vgg_counts[name]
            + ex_counts[name] + bench_counts[name] + fleet_counts[name],
            "max_abs_err": max(grad_err, bench_err[name],
                               *(v["err"] for v in stats[name].values())),
            "ms": s["ms"], "plain_ms": s["plain"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None})
    dense_err = {k: max(r["max_abs_err"] for r in dense["kernel_rows"]
                        if r["name"] == k)
                 for k in ("flash_attention", "decode_attention")}
    attn["flash_attention"]["max_abs_err"] = max(
        attn["flash_attention"]["max_abs_err"], flash_fn["max_abs_err"],
        window["max_abs_err"]["flash_attention"],
        dense_err["flash_attention"])
    attn["decode_attention"]["max_abs_err"] = max(
        attn["decode_attention"]["max_abs_err"],
        window["max_abs_err"]["decode_attention"],
        dense_err["decode_attention"])
    ssm["max_abs_err"] = max(ssm["max_abs_err"], ssm_fn["max_abs_err"])
    launches = {"flash_attention": flash_launches
                + zoo_totals["flash_attention"]
                + train_counts["flash_attention"]
                + ssm_train["flash_attention"]
                + window["flash_attention"]
                + dense["launches"]["flash_attention"]
                + ex_counts["flash_attention"],
                "decode_attention": decode_launches
                + zoo_totals["decode_attention"]
                + zoo_serve["decode_attention"]
                + window["decode_attention"]
                + dense["launches"]["decode_attention"]
                + ex_counts["decode_attention"]}
    for name, replaces in (
            ("flash_attention", "src/repro/kernels/flash_attention.py:70"),
            ("decode_attention", "src/repro/kernels/decode_attention.py:56")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            **attn[name]})
    kernels.append({
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:93",
        "launches": ssm_launches + zoo_totals["ssm_scan"]
        + ssm_train["ssm_scan"], **ssm})
    print("gcn_agg, edge_score: times per slot at B=64, the sum over one "
          "actor forward's launches (4 and 1), launches of the training "
          "path (phase 18: 200 slots' and 20 train steps' forwards), error "
          "the larger of the forward's and the gradients'; "
          "flash_attention: one call at "
          f"[{PREFILL_B}, {PREFILL_S}, 32, 8, 64] bf16, launches of one "
          f"prefill; decode_attention: one call at [{LONG_B}, 32, 8, 64, "
          f"S={LONG_S}] bf16, every row read, launches of the serve phase's "
          f"four exits; ssm_scan: one call at {list(SSM_PREFILL[:5])} chunk "
          f"{SSM_PREFILL[5]} bf16, plain timed eagerly, launches of one RWKV "
          "prefill (its decode launches none); each kernel's launches add "
          "those of phase 30's prefills and decodes of the zoo and of phase "
          "31's serving path (gcn_agg and edge_score: phase 31's only), "
          "flash_attention those of phase 35's training run and of phase "
          "38's Zamba2 run, ssm_scan those of phase 38's two training runs, "
          "flash_attention and decode_attention those of phase 39's window "
          "runs, "
          "gcn_agg and edge_score those of phase 36's GRLE run (by the "
          "profiler); flash_attention and decode_attention those of phase "
          "41's three dense configs, and every kernel those of phase 42's "
          "quickstart, serving example and trainer (wrapper counts) and its "
          "scenario fleet's profiled run (the profiler's device records; "
          "the sweep's and the population's scan replays go uncounted, so "
          "they add nothing); flash_attention's error also covers phase 33's "
          "forwards at the training shapes, both attention kernels' errors "
          "phase 39's at the window's shapes and phase 41's at the GQA "
          "configs' shapes, ssm_scan's phase 37's; gcn_agg and edge_score "
          "also those of phase 45's two timed serve-bench windows, and "
          "their error phase 45's at the engines' shapes (M=4 and M=64); "
          "gcn_agg and edge_score also those of phase 46's sharded loop "
          "episodes, summed over the ranks; "
          "the zoo's new shapes timed in phase 28, the GQA configs' in "
          "phase 41:")
    print(json.dumps({"zoo_kernel_shapes": zoo_rows}))
    print(json.dumps({"dense_kernel_shapes": dense["kernel_rows"]}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
