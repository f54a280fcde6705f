#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (`src/repro_torch/`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

  build   nvcc builds every kernel of the ported paths from the sources in
          this checkout, all at once (K4 flash-decode, K1 mtsl_update, K2
          flash-attention and K3 ssd-scan, for sm_90a), and prints each
          ptxas report.
  kernel  K4 against its plain PyTorch version on the card at the serving
          path's shapes (4 slots, cap 320) and at 8 rows with ragged
          kv_valid, cap in {512, 4096}, window in {0, 1024}, at
          zamba2-7b's decode (4 slots, cap 320, 32 heads of 112), at the
          self-attention decodes of moe-serve, vlm-serve and encdec-serve
          (cap 288 / 96), and in the ring and cross modes of the rest of the zoo's serving
          (K4_CASES: mistral-nemo's ring of 4096, the VLM's 1601 and
          whisper's 1500 source keys): bf16 within 2e-2, f32 within 2e-5. Times the kernel, the plain
          version, F.scaled_dot_product_attention with the same mask (a
          yardstick only: the port never calls it) and the bound (bytes
          over 3.35 TB/s or flops over the dtype's peak, whichever is
          larger), each launch behind an L2 flush, with bound_share =
          bound / kernel time. Each case launches twice: the outputs must be
          bit-equal. Then the serving path's rows in a cap-320 and in a
          cap-4096 buffer: bit-equal outputs in bf16 and f32.
  k1      K1 against its plain version: every leaf shape that the train
          phase updates, read from the initial trees of full
          paper-resnet16 and paper-mlp with M = 10 (towers with one step
          size per client, the server with one), a flat 2^26-element leaf
          in f32 and bf16 (scalar step), and an odd 2003-element leaf (the
          scalar tail), each through the per-leaf call; then each whole
          tree through the multi-tensor call (mtsl_update_multi_, one
          launch), as the train path updates it, and a table whose step
          sizes are partly 0 (the baselines' straggler hold: every leaf of
          full paper-resnet16 as per-client copies with held clients, a
          per-cluster leaf with an idle cluster, a shared leaf at 0), whose
          held rows must come back bit-unchanged. Each must be bit-equal.
          Times the kernel, the plain version and one PyTorch call of the
          same function (`add_` / `addcmul_`, `_foreach_addcmul_` for a
          tree; a yardstick only), each behind an L2 flush; the bound is
          3 * numel * itemsize bytes over 3.35 TB/s.
  slice   gemma3-12b at full width and full depth (48 layers), M = 2
          clients, random weights from a seed, served through
          `repro_torch.launch.serve` (continuous engine, --bench): 8
          requests alternating clients, prompts of 64..256 tokens, 32 new
          tokens each, 4 slots, chunk 64. Every decode step and every
          extend chunk is a replay of the engine's CUDA graphs (M + 1 = 3
          captured at construction, `serve/graphs.py`). Checks every
          request's tokens, finite logits, the captures, and that every
          decode attention launched K4: K4's launches as counted on the
          card == attn_decode calls == (6 M + 42) per decode step, and
          the plain decode ran 0 times on the card.
  parity  full width, one 6-layer pattern unit in the tower and one in the
          server, f32 with TF32 off: greedy output of the continuous
          engine equals generate_sequential's token for token.
  train   the mtsl round (paper Alg. 1) through
          `repro_torch.launch.train`: paper-resnet16 at full width and
          depth (M = 10, b = 8, lr 0.1, 200 rounds), then paper-mlp
          (b = 16, 200 rounds), each at the launcher's default history
          cadence (every 20 rounds, the only host syncs). Checks that the
          launcher turned TF32 off, finite logged losses, a falling loss
          (round 200's below the mean of rounds 1 and 20), and that every
          parameter update went through K1 in one launch a round: leaves
          updated == leaves x rounds (17 x 200, 8 x 200) and multi-tensor
          launches == rounds, with no per-leaf launch and the plain update
          run 0 times on the card. Reports rounds/s, samples/s, peak memory, acc_mtl on a
          held-out batch, and a torch.profiler pass over 20 more resnet
          rounds (device vs wall ms per round, K1's share, top kernels).
  tparity full paper-resnet16, M = 10, b = 8, TF32 off, participation
          0.5, the card (K1, cuDNN) against the CPU (plain version) from
          one initial tree and the same batches. Round-1 gradients per
          leaf, max |card - CPU| / max |CPU|: within 1e-12 in f64 (the
          witness that both compute one function) and within 2e-3 in
          f32, with the tower ReLU inputs that f32 rounds to the other
          side of 0 counted on each side. Then 3 rounds in f32, the card's
          rounds under torch.use_deterministic_algorithms (cuDNN's default
          convolutions vary in the last bits from run to run, and no op
          without a deterministic algorithm may run): at lr
          0.01 losses within 1e-5 relative and every parameter within
          1e-5; at lr 0.1 losses within 1e-5 relative and the parameter
          gap reported (the f32 gradient gap times the step exceeds 1e-5
          there); each card round updates its 17 leaves in one K1 launch.
          Then two 20-round card runs from one seed under
          torch.use_deterministic_algorithms(True): bit-equal parameters.

  k2      K2 against its plain version (mha_reference) on the LM path's
          shape (zamba2-7b's shared attention: B = 2, H = 32, S = 2048,
          D = 112, bf16, causal) and with GQA, a window, a ragged S and in
          f32; then at the shapes the zoo phases run: whisper-tiny's
          encoder (B = 8, S = 1500, H = 6, D = 64, non-causal), its
          decoder's causal self-attention (B = 32, S = 448) and cross
          attention (B = 32, Sq = 448, Sk = 1500), llama-3.2-vision's
          cross attention (B = 2, Sq = 2048, Sk = 1601, H = 32 / 8,
          D = 128), deepseek-moe-16b's causal attention (B = 2, S = 2048,
          H = 16, D = 128) and an f32 cross case: bf16 within 2e-2, f32
          within 2e-5 (absolute plus relative, as tests/test_kernels.py
          holds them). Times the kernel, the plain version and
          F.scaled_dot_product_attention with the same mask (a yardstick
          only: the port never calls it), each behind an L2 flush; the
          bound is the larger of the bytes (q, k, v, out once) over 3.35
          TB/s and 4 D flops per visible (query, key) pair (Sq x Sk
          without the causal mask) over the dtype's peak, and bound_share
          = bound / kernel time. Each case launches twice: the outputs
          must be bit-equal.
  k3      K3 against its plain version (ssd_reference) on zamba2-7b's
          server shape (B = 2, L = 2048, H = 112, P = N = 64, chunk 128,
          bf16), its tower shape (B = 1), mamba2-130m's (B = 16, L = 256,
          H = 24, P = 64, N = 128), bf16 with an initial state, in f32
          with an initial state, and serving's extend shapes (B = 1, L =
          128, an initial state; mamba2-130m's and zamba2-7b's): y within 5e-2 in bf16 and 2e-5 in f32
          (absolute plus relative: y reaches 8 and more, where one bf16
          rounding step is 0.0625) and as a whole, ||y - y_plain|| /
          ||y_plain|| within K3_REL_L2; the final state within an absolute
          1e-4. Each bf16 case also reports how much of y's error is the
          output's own bf16 rounding and how much the kernel's (W rounded
          to bf16 in W x), against the plain version run in f32 on the same
          inputs. Each case launches twice: the outputs must be bit-equal.
          Reports each case's path (scan_plan: the tensor-core path for
          bf16, FMA for f32). Times the kernel and the plain version (no
          PyTorch call computes the SSD scan); the bound is the larger of
          the bytes (x, dt, B, C in, y and the state out, once) over 3.35
          TB/s and the chunked algorithm's flops at the reference's chunk
          over the dtype's peak, and bound_share = bound / kernel time.
  lm-train  zamba2-7b at full width and depth (81 layers, d_model 3584),
          M = 2 clients, b = 1, S = 2048, SGD, 3 mtsl rounds through
          train/loop.py::train and the registry, on
          client_batches(MultiTaskLMSource(vocab_size=4096)): the model's
          vocabulary stays 32,000, the data's is cut because the source
          builds dense [V, V] f64 chains (8.2 GB each at 32,000). Checks a
          finite loss every round, K2 and K3 launches per round equal to
          2 (remat: forward + recompute) x (M x tower layers + server
          layers) of each kind, every K3 launch on the tensor-core path, no
          plain K2 / K3 forward on the card, and K1 once a round over every
          leaf (launches == rounds, leaves updated == leaves x rounds).
          Reports s per round, peak memory, and a torch.profiler pass over
          one more round (device busy share, top kernels). Then, with the
          model freed, K1 against its plain version on every leaf shape of
          the trained tree at full width (7.26 B elements, random p and g),
          in batches of up to 2^30 elements, each one multi-tensor launch
          over many leaves: bit-equal.
  lm-learn  mamba2-130m at its full config, M = 4, b = 4, S = 256, adamw at
          lr 3e-3 (the LM example's), 100 rounds on a 4096-token
          MultiTaskLMSource: the loss must fall, and every K3 launch takes
          the tensor-core path; reports each task's
          held-out loss beside its chain's entropy floor, the host time to
          draw one round's tokens, and a torch.profiler pass over one more
          round.
  lm-parity  the smoke zamba2-7b and mamba2-130m rounds (f32, SGD lr 0.1,
          masked participation), 3 rounds on the card (K2, K3, K1) against
          the CPU (plain versions) from one initial tree and one batch
          stream: losses within 1e-5 relative, parameters within 1e-4;
          then two seeded card runs of each under
          torch.use_deterministic_algorithms(True, warn_only=True): bit-equal
          parameters (the ops that have no deterministic algorithm are
          reported).
  baselines  the paper's six federated baselines (fedavg, fedprox,
          splitfed, smofi, parallelsfl, fedem) on full paper-resnet16, M =
          10, b = 8, lr 0.1, local_steps 30, 15 rounds (450 gradient steps,
          the reference's Table 2 setting for the baselines on resnet,
          benchmarks/table2_accuracy.py), each through train/loop.py::train
          and the registry. Checks finite logged losses and that every
          local SGD step went through K1 in one launch: multi-tensor
          launches == local steps x rounds, leaves updated == 17 x that, no
          per-leaf launch and the plain update run 0 times on the card.
          A loss that is not finite fails the phase with the first tensor
          that went non-finite: every local step's update is probed in the
          run itself (the largest |value| of each gradient before K1 and of
          each parameter after, kept on the card: a few launches a step)
          and the message names the leaf, the round and the local step.
          The probe's host seconds are left out of the times (the rounds
          are host-bound), and fedavg runs 6 more rounds without it to
          read its cost directly.
          Reports per algorithm s per round, gradient steps per s, peak
          memory, the host's time inside K1's wrapper (the leaf table's
          build and copy), acc_mtl on the held-out batch, and round_bytes
          on star(10) beside mtsl's. After fedavg's run and its eval, one
          more fedavg round under torch.profiler with K1's wrapper marked:
          the round's device busy share and what the host does inside the
          wrapper (CPU operations and CUDA runtime calls, by name).
  bparity  card against CPU for the baselines. Full paper-resnet16, M =
          10, b = 8, TF32 off, participation 0.5 with stragglers,
          local_steps 2, lr 0.01, 3 rounds of each of the six from one
          initial state and the same batches, the card's rounds under
          deterministic algorithms as in tparity: losses within 1e-5 relative,
          every parameter leaf (and FedEM's responsibilities) within 1e-4,
          ParallelSFL's cluster map equal, SMoFi's momentum buffer (a sum
          of raw gradients) within GRAD_GAP_F32 of its scale, as tparity
          holds gradients, and K1 once a local step on the card; before
          them, round 1's per-client full-model gradients card vs CPU in
          f64 (within GRAD_GAP_F64) and f32 (within GRAD_GAP_F32). SMoFi's
          rounds run again in f64 on both sides (a plain f64 update in
          K1's place, which takes f32 and bf16 only): every leaf, smom
          included, within GRAD_GAP_F64 of its scale, the witness that the
          card's buffer is the CPU's function; reported beside it, each
          side's f32 state against its own f64 one and the ReLU inputs of
          round 3's first step that f32 rounds to the other side of 0. Then
          splitfed and fedavg on the smoke zamba2-7b and mamba2-130m in f32
          (K2, K3, K1), 3 masked rounds of 2 local steps at lr 0.05, with
          the same tolerances and K2 / K3 launches as counted. Then two
          seeded 10-round fedavg card runs under
          torch.use_deterministic_algorithms(True): bit-equal parameters.
  lm-baselines  splitfed and fedavg on mamba2-130m's full config: M = 4,
          b = 4, S = 256, SGD lr 0.05, local_steps 2, 10 rounds on the
          4096-token MultiTaskLMSource, through train/loop.py::train.
          Checks a finite loss every round, K3 launches per round as counted
          from the layers, clients, local steps and remat, every K3 launch
          on the tensor-core path, no plain K3 forward on the card, and K1
          launches == local steps x rounds. Reports s per round, peak
          memory and the losses. (fedavg on zamba2-7b at full width needs
          M full copies of 7.26 B f32 parameters: it does not fit 80 GB.)
  encdec, moe, vlm  the rest of the model zoo at full width, each through
          train/loop.py::train and the registry with SGD (ZOO_RUNS), on
          tokens from a 4096-token MultiTaskLMSource (the model's
          vocabulary stays full) plus, for the VLM, vision features and,
          for the encoder-decoder, audio frames from
          np.random.default_rng: whisper-tiny at full width and depth (4 +
          4 layers, d 384, 1500 frames, vocabulary 51,865; M = 4, b = 8,
          S = 448, 10 rounds), deepseek-moe-16b at 13 of its 28 layers (64
          routed experts of 1408 + 2 shared, top-6, a dense lead layer of
          11,264; M = 2, b = 1, S = 2048, 3 rounds) and
          llama-3.2-vision-11b at 25 of its 40 layers (cross layers at 5,
          10, ..., 25; vision 1601 x 1280; M = 2, b = 1, S = 2048, 3
          rounds). Checks finite losses, K2 launches per round in each mode
          (causal, non-causal self, cross) equal to the count from the
          stacks' block kinds and remat, no plain attention forward on the
          card, and K1 once a round over every leaf. Reports s per round,
          peak memory, the losses, the MoE's dropped-row share (rows over
          an expert's capacity) and a torch.profiler pass over one more
          round (device busy share, top kernels, the round's aux loss).
  fparity  the smoke configs of deepseek-moe-16b, qwen3-moe-30b-a3b,
          mistral-nemo-12b, llama-3.2-vision-11b and whisper-tiny in f32
          (K2's f32 path in every mode, K1): 3 masked mtsl rounds on the
          card against the CPU from one initial tree, with lm-parity's
          limits (losses within 1e-5 relative, parameters within 1e-4) and
          K2's launches per mode as counted; then two seeded card runs of
          each MoE arch (deterministic algorithms on): bit-equal.
  ssm-serve  mamba2-130m at full width and depth (24 layers, d 768, 24
          SSD heads of 64, N 128, vocabulary 50,280, split 4; bf16 serving
          tree), M = 4, random weights from a seed, served through
          `repro_torch.launch.serve --no-smoke --bench` on the continuous
          engine with slice's traffic (8 requests alternating clients,
          prompts of 64..256 tokens, 32 new, 4 slots, chunk 64). Checks
          every request's tokens, finite logits, K3 launches == 24 per
          extend chunk (one client's 4 tower layers + 20 server layers,
          every one on the tensor-core path) and the plain scan run 0 times
          on the card; a torch.profiler decode phase gives the SSM decode
          step's wall, device time and busy share. Then the sequential
          engine on the same prompts, each alone: K3 launches == 36 per
          prefill (every client's 4 tower layers + 20); reports each
          request's tokens shared with the continuous engine (bf16 rounds
          the two apart).
  hybrid-serve  zamba2-7b at full width and depth (81 layers, d 3584, 112
          SSD heads of 64, N 64, shared attention at layers 5, 11, ..., 77,
          all 13 on the server; bf16, ~14.5 GB of weights), M = 2, the same
          traffic: K3 launches == 81 per extend chunk, all tensor-core; K4
          launches == attn_decode calls == 13 per decode step; the plain
          scan and the plain decode run 0 times on the card.
  sparity  full width, f32, TF32 off, cut depth: mamba2-130m at 6 layers
          (split 2) and zamba2-7b at 12 (split 5: the shared attention at
          layers 5 and 11, on the server), M = 2, 4 requests of 5..130
          tokens over 2 slots at chunk 64: the continuous engine's greedy
          tokens equal generate_sequential's on the card token for token,
          and the card's prefill logits are within 1e-4 of the CPU's
          (relative to max(1, max |logit|)).
  moe-serve  deepseek-moe-16b at full width and depth (28 layers: the
          dense lead and one MoE layer in each tower, 26 MoE layers of 64
          routed experts of 1408 + 2 shared, top-6, on the server; bf16,
          capacity factor 1.25), M = 2, through `launch.serve --no-smoke
          --bench --profile` on the continuous engine with slice's traffic.
          Checks every request's tokens, finite logits, K4 launches ==
          attn_decode calls == 30 per decode step (2 x 2 tower + 26), no
          plain decode, no ring or cross launch; reports the MoE's
          dropped-row share and a profiled decode phase. Then the sequential
          engine on the same prompts, each alone (K4 30 per decode step),
          and the leading tokens each request shares with the continuous
          engine (bf16 at capacity 1.25: no parity expected).
  vlm-serve, encdec-serve  llama-3.2-vision-11b (40 layers, 8 cross
          layers all on the server; vision 1601 x 1280 from the seed) at
          M = 2, b = 2, prompt 256, and whisper-tiny (4 + 4 layers, 1500
          frames of 384 from the seed) at M = 4, b = 2, prompt 64, both at
          full width and depth in bf16 with 32 new tokens, through `launch.serve
          --no-smoke --bench --engine sequential` (a warm-up generation
          and a timed one: two prefills). Checks, per prefill, K2 cross
          launches == cross layers (8; 4) and K2 non-causal == encoder
          layers run (0; 4 x 2 tower + 2 server), and no causal K2 launch
          (the prefill's self-attention is plain, as the reference's); per
          decode step, K4 == self-attentions + cross decodes (2 x 4 + 36 +
          8 = 52; 4 + 4) with the cross decodes counted apart, attn_decode
          calls == K4 launches, no plain decode.
  swa-serve  mistral-nemo-12b-swa (40 layers, d 5120, every layer a
          window of 4096 on a ring cache of 4096 slots), M = 2, b = 1, bf16:
          `launch.serve --no-smoke --bench --engine sequential` at a
          4,064-token prompt and 64 new tokens (the decode wraps the ring),
          then the launcher's weights and inputs at 4,608 tokens (the
          rolled prefill) on ring caches, and at both lengths on
          full-capacity caches (decode_long_window = 0). Checks every ring decode on K4
          in ring mode (44 per step), cache capacities (4,096 on the ring,
          prompt + new otherwise), tokens; reports the leading tokens the
          ring and the full caches share (bf16: not asserted).
  xparity  the four configs of the new serving paths in f32 at full width
          (TF32 off): deepseek-moe-16b at 4 layers (split 2, the tower
          holding an MoE layer; capacity factor 8.0, the smoke configs'
          no-drop setting), llama-3.2-vision-11b at 5 (split 2, the cross
          layer on the server), whisper-tiny whole, mistral-nemo-12b-swa at
          4 with a window of 64, M = 2, 4 requests of 5..130 tokens each
          alone in its client's row: the card's prefill and every decode
          step's logits within 1e-4 of the CPU's (plain versions, fed the
          card's tokens; of max(1, max |logit|) per row), greedy tokens
          equal card vs CPU, K4 (ring, cross) and K2 (cross) on the card as
          the config asks; the MoE's continuous engine equals its
          sequential one token for token.
  graphs  the engines' compiled steps (CUDA graphs) against the same steps
          run eagerly (`graphs=False`), on the card. In f32 (TF32 off) at
          parity's, sparity's and xparity's cut depths (gemma3-12b 12
          layers, mamba2-130m 6, zamba2-7b 12, deepseek-moe-16b 4,
          llama-3.2-vision-11b 5, whisper-tiny whole, mistral-nemo-12b-swa
          4 with a window of 64), M = 2: the continuous engine on 4
          requests of 5..130 tokens over 2 slots at chunk 64, the
          sequential engine on 2 rows a client of 130 tokens, 8 new: the
          eager steps run under torch.cuda.set_sync_debug_mode("error"),
          greedy tokens equal, every decode step's logits within 1e-6 of
          their scale, the counters equal, captures M + 1 (continuous) or 1
          (sequential). Then in bf16 at full width with each serving
          phase's configuration and traffic (slice, ssm-serve,
          hybrid-serve, moe-serve, vlm-serve, encdec-serve, swa-serve),
          through `launch.serve.run_bench` replayed (the phase's own run)
          and eager (graphs=False; the same harness and warm-up), with
          every eager decode attention on K4 and every scan on K3's
          tensor-core path: prefill ms,
          ms a decode step, tok/s, captures, capture ms, the graph pool's
          GiB, the leading tokens the two share (bf16: reported), and a
          torch.profiler window of replayed steps (the first wave's extend
          chunks where they run K3; 8 decode steps: busy share), where the
          K4 and K3 launches the profiler sees inside the replays must
          equal the launches counted on the card (a window the profiler
          lost a record of is measured again, up to three times, and the
          last may lack one record of each, reported; more seen than
          counted fails).
  ckpt    the LM example's --full config (mamba2-130m, M = 4, f32 masters,
          scan_layers, no remat) trained through train/loop.py with AdamW
          lr 3e-3, b 4, S 256 on a 4096-token MultiTaskLMSource (the
          model's vocabulary stays 50,280), under deterministic
          algorithms: 10 rounds with a checkpoint, 10 more resumed from the
          file, against 20 uninterrupted rounds: loss histories and states
          (params, moments, step) bit-equal; K3 (its f32 FMA path) and K1
          once a round as counted. The file written on the card loads on
          the CPU bit-equal; `repro_torch.launch.serve --checkpoint` serves
          it twice (continuous engine, greedy) with equal tokens. The
          files (3.94 GB each) live under build/ckpt and are removed.
  pipeline  the prefetch pipeline (train/pipeline.py): full paper-resnet16
          (M = 10, b = 8, lr 0.1, 200 mtsl rounds) through
          `repro_torch.launch.train` at --prefetch 0 and 2 under
          deterministic algorithms: history and final state bit-equal, K1
          once a round (17 leaves); mamba2-130m's full config (M = 4, b =
          4, S = 256, adamw 3e-3, the 4096-token source) 10 rounds at both
          depths: bit-equal, K3 counted on the card equal at both depths
          (every launch tensor-core), K1 once a round. Then rounds/s of 50
          resnet16 rounds at depths 0, 2, 2, 0 and the busy share of 20
          profiled rounds at each depth, with the default convolutions;
          and the host's synthesis ms a round alone, resnet16's and the
          LM's.
  async   the event engine (train/events.py): paper-resnet16 20 rounds
          under --async on star(M) with uniform capability and ideal links
          == the synchronous run bit for bit; then train(async_mode) on
          multi-server (2 servers, --sync-every 2, half the clients
          stragglers, decay 0.5, max staleness 4, 10 Mb/s links):
          staleness > 0 seen, K1 launches == applies, s per apply; an
          EventEngine snapshot taken with cohorts in flight, saved in the
          msgpack checkpoint and resumed: bit-equal to the uninterrupted
          run (deterministic algorithms).
  cached  --data cached on paper-resnet16: a per-client cache and a
          Dirichlet(0.1) cache of 512 examples a client, each built by the
          launcher on first use under build/chip_cache; 20 rounds from each
          == the same rows trained from memory, bit for bit; build s,
          bytes, host ms a round and rounds/s against synthesis. The caches
          are removed.
  chunk   client chunking: paper-resnet16 at M = 64 (b = 8), dense against
          --client-chunk 8, 3 rounds at lr 0.01 under deterministic
          algorithms: losses within 1e-5 of their scale, parameters within
          1e-5 (CHUNK_LOSS_TOL, the CPU tests'); peak GiB and s a round of
          10 rounds of each; the host scan round (core/scan_round.py) at M
          32 and 64 with chunk 8 against the dense round (losses within
          the same tolerance, M/8 + 1 K1 launches a round), both M on the
          same per-block functions (the port is eager: there is no compile
          to count).

Each kernel time is the median of single calls timed by CUDA events, each
behind a 256 MB L2 flush and a ~0.2 ms spin on the card that lets the host
queue the call before the start event runs, so the host's wrapper time is
not counted; K1's tree call_ms leaves the spin out to count it.

K4 and K3 count their launches themselves on the card (one thread of a
launch's first block adds one to an int64 table, `kernels/counts.py`), so
the launches a phase reads are launches that ran, graph replays
included; the other counters are Python ones, which each graph replay
adds as its capture recorded them.

Prints the card's name and power limit first, a `{"kernels": [...]}`
line (K2's, K3's and K4's entries also carry `serve_launches`, their
launches in the serving phases: K4's ring and cross decodes and K2's
cross and non-causal prefill attention apart; K1's and K3's carry
`systems_launches`, their launches on the systems layers' paths), and as
its last line
`{"ok": true, "device": {...}}`.
`python3 chip_smoke.py --only k2,kernel` runs the build and the named
phases alone and prints no result line (`--only
ssm-serve,hybrid-serve,sparity,ckpt`: the serving and checkpoint phases,
about 2.5 minutes; `--only moe-serve,vlm-serve,encdec-serve,swa-serve,
xparity`: the rest of the zoo's serving; `--only graphs`: the compiled
steps against eager ones). Each run prints its total time, and the
serving, graphs and checkpoint phases each print their seconds. Without CUDA,
or without the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import time
import traceback
import warnings
from typing import NamedTuple
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense; f32 off tensor cores
HEAD_START_CYCLES = 400_000  # _median_ms's spin before each timed launch
K4 = {"name": "flash_decode", "route": "cuda",
      "source": "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu",
      "replaces": "src/repro/kernels/flash_decode/kernel.py:101"}
K1 = {"name": "mtsl_update", "route": "cuda",
      "source": "src/repro_torch/kernels/mtsl_update/csrc/mtsl_update.cu",
      "replaces": "src/repro/kernels/mtsl_update/kernel.py:25"}
K2 = {"name": "flash_attention", "route": "cuda",
      "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
      "replaces": "src/repro/kernels/flash_attention/kernel.py:97"}
K3 = {"name": "ssd_scan", "route": "cuda",
      "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
      "replaces": "src/repro/kernels/ssd_scan/kernel.py:86"}
K4_CASES = [  # (case, B, cap, Hq, Hkv, D, window, dtype, kv_valid range, mode)
    ("serving_path", 4, 320, 16, 8, 256, 1024, "bfloat16", (64, 289), "self"),
    ("b8_cap512_full", 8, 512, 16, 8, 256, 0, "bfloat16", (1, 513), "self"),
    ("b8_cap512_swa", 8, 512, 16, 8, 256, 1024, "bfloat16", (1, 513), "self"),
    ("b8_cap4096_full", 8, 4096, 16, 8, 256, 0, "bfloat16", (1, 4097), "self"),
    ("b8_cap4096_swa", 8, 4096, 16, 8, 256, 1024, "bfloat16", (1, 4097), "self"),
    ("b8_cap4096_swa_f32", 8, 4096, 16, 8, 256, 1024, "float32", (1, 4097), "self"),
    # zamba2-7b's shared attention in hybrid-serve's decode (4 slots,
    # cap 320, MHA, D = 112)
    ("zamba2_decode", 4, 320, 32, 32, 112, 0, "bfloat16", (64, 289), "self"),
    # the self-attention decodes of moe-serve (deepseek-moe-16b, MHA, D =
    # 128: the continuous engine's 4 slots, then the sequential engine's
    # M b = 8 server rows after one 256-token prompt), vlm-serve
    # (llama-3.2-vision-11b, GQA 4, M b = 4 rows) and encdec-serve
    # (whisper-tiny's decoder, MHA, D = 64, M b = 8 rows, cap 64 + 32)
    ("moe_decode", 4, 288, 16, 16, 128, 0, "bfloat16", (64, 289), "self"),
    ("moe_decode_seq", 8, 288, 16, 16, 128, 0, "bfloat16", (257, 289), "self"),
    ("vlm_decode", 4, 288, 32, 8, 128, 0, "bfloat16", (257, 289), "self"),
    ("whisper_decode", 8, 96, 6, 6, 64, 0, "bfloat16", (65, 97), "self"),
    # mistral-nemo-12b-swa's ring of 4096 slots in swa-serve's decode (M b =
    # 2 rows; past the wrap every slot is live)
    ("nemo_ring", 2, 4096, 32, 8, 128, 0, "bfloat16", (4096, 4097), "ring"),
    ("nemo_ring_ragged_f32", 4, 4096, 32, 8, 128, 0, "float32", (1, 4097), "ring"),
    # cross decodes over every key of the source: llama-3.2-vision's 1601
    # patches (vlm-serve, M b = 4 rows, GQA 4) and whisper-tiny's 1500
    # frames (encdec-serve, M b = 8 rows, MHA, D = 64); neither is a
    # multiple of K4's 64-row split
    ("vlm_cross", 4, 1601, 32, 8, 128, 0, "bfloat16", (1601, 1602), "cross"),
    ("whisper_cross", 8, 1500, 6, 6, 64, 0, "bfloat16", (1500, 1501), "cross"),
    ("whisper_cross_f32", 8, 1500, 6, 6, 64, 0, "float32", (1500, 1501), "cross"),
]
K2_CASES = [  # (case, B, Sq, Sk, causal, Hq, Hkv, D, window, dtype); the
    # first is lm-train's path
    ("zamba2_path", 2, 2048, 2048, True, 32, 32, 112, 0, "bfloat16"),
    ("gqa4_swa1024", 2, 2048, 2048, True, 32, 8, 128, 1024, "bfloat16"),
    ("ragged_s1000", 2, 1000, 1000, True, 16, 16, 112, 0, "bfloat16"),
    ("f32_s512", 1, 512, 512, True, 8, 4, 112, 0, "float32"),
    # whisper-tiny's encoder (non-causal, D = 64: the DP = 64 tiles), its
    # decoder's causal self-attention and its cross attention to the 1500
    # frames, at the encdec phase's tower (B = b) and server (B = M b) batches
    ("whisper_enc", 8, 1500, 1500, False, 6, 6, 64, 0, "bfloat16"),
    ("whisper_dec", 32, 448, 448, True, 6, 6, 64, 0, "bfloat16"),
    ("whisper_xattn", 32, 448, 1500, False, 6, 6, 64, 0, "bfloat16"),
    # llama-3.2-vision's cross attention to one tile of 1601 patches, on the
    # server (every cross layer lies above the split: B = M b)
    ("vlm_xattn", 2, 2048, 1601, False, 32, 8, 128, 0, "bfloat16"),
    # deepseek-moe-16b's causal attention (MHA, no window) on the server
    ("moe_path", 2, 2048, 2048, True, 16, 16, 128, 0, "bfloat16"),
    ("f32_xattn", 2, 200, 333, False, 4, 2, 64, 0, "float32"),
    # serving's prefill: whisper-tiny's encoder in a client's tower (B = b
    # = 2; the server's encoder layers take B = M b = 8, whisper_enc's
    # shape) and its decoder's cross attention (B = 8, a 64-token prompt);
    # llama-3.2-vision's cross attention (B = M b = 4, a 256-token prompt)
    ("whisper_enc_tower_serve", 2, 1500, 1500, False, 6, 6, 64, 0, "bfloat16"),
    ("whisper_xattn_serve", 8, 64, 1500, False, 6, 6, 64, 0, "bfloat16"),
    ("vlm_xattn_serve", 4, 256, 1601, False, 32, 8, 128, 0, "bfloat16"),
]
# K2's bf16 outputs are also held as a whole: the elementwise limit above
# lets one bf16 step through at |out| ~ 1, which at S = 2048 (|out| ~ 0.05)
# would hide a tiling fault worth a tenth of a typical value
K2_REL_L2 = {"bfloat16": 5e-3, "float32": 2e-5}
K3_CASES = [  # (case, B, L, H, P, N, chunk, dtype, initial state)
    ("zamba2_server", 2, 2048, 112, 64, 64, 128, "bfloat16", False),
    ("zamba2_tower", 1, 2048, 112, 64, 64, 128, "bfloat16", False),
    ("mamba2_130m", 16, 256, 24, 64, 128, 128, "bfloat16", False),
    ("bf16_state", 2, 2048, 112, 64, 64, 128, "bfloat16", True),
    ("f32_state", 2, 512, 8, 64, 64, 128, "float32", True),
    # serving's chunked extend (ssm-serve, hybrid-serve): one row, one chunk
    # of 128 positions (the engine's 64 padded up to the chunk), resumed
    # from the slot's f32 state
    ("mamba2_extend", 1, 128, 24, 64, 128, 128, "bfloat16", True),
    ("zamba2_extend", 1, 128, 112, 64, 64, 128, "bfloat16", True),
]
# K3's outputs as a whole, ||y - y_plain|| / ||y_plain||: the elementwise
# limit above lets a bf16 step through at |y| ~ 8. Set from the readings on
# an H100 (PERF.md): 2.58e-3 to 2.62e-3 in the bf16 cases (the output's own
# rounding is 1.66e-3 of it), 4.1e-7 in f32; about twice and five times that
K3_REL_L2 = {"bfloat16": 5e-3, "float32": 2e-6}
LM_TRAIN = {"arch": "zamba2-7b", "M": 2, "b": 1, "S": 2048, "rounds": 3,
            "lr": 0.05, "data_vocab": 4096}
LM_LEARN = {"arch": "mamba2-130m", "M": 4, "b": 4, "S": 256, "rounds": 100,
            "lr": 3e-3, "data_vocab": 4096, "log_every": 10}
# the rest of the zoo at full width (num_layers: the depth cut, None for
# full depth), each trained with SGD through the loop on a 4096-token LM
# source (the model's vocabulary stays full)
ZOO_RUNS = {
    # whisper-tiny at full width and depth (4 + 4 layers, 1500 frames,
    # whisper's 448-token text context)
    "encdec": {"arch": "whisper-tiny", "M": 4, "b": 8, "S": 448, "rounds": 10,
               "lr": 0.05, "data_vocab": 4096, "num_layers": None},
    # deepseek-moe-16b, 13 of 28 layers: 8.44 B parameters with M = 2
    # (f32 masters and gradients of the full depth, 17.26 B, would take
    # ~138 GB; 10 layers peaked at 54.4 GiB on an H100, each MoE layer adds
    # ~4.4 GiB)
    "moe": {"arch": "deepseek-moe-16b", "M": 2, "b": 1, "S": 2048, "rounds": 3,
            "lr": 0.05, "data_vocab": 4096, "num_layers": 13},
    # llama-3.2-vision-11b, 25 of 40 layers (cross layers at 5, 10, ..., 25):
    # 8.12 B parameters with M = 2 (full depth: 11.52 B, ~92 GB; 20 layers
    # peaked at 58.1 GiB)
    "vlm": {"arch": "llama-3.2-vision-11b", "M": 2, "b": 1, "S": 2048,
            "rounds": 3, "lr": 0.05, "data_vocab": 4096, "num_layers": 25},
}
ZOO_PARITY_ARCHS = ("deepseek-moe-16b", "qwen3-moe-30b-a3b", "mistral-nemo-12b",
                    "llama-3.2-vision-11b", "whisper-tiny")
# (case, shape, rows, dtype) beyond the train paths' own leaves
K1_FLAT_CASES = [
    ("flat_2^26_f32", (1 << 26,), 1, "float32"),
    ("flat_2^26_bf16", (1 << 26,), 1, "bfloat16"),
    ("odd_2003_f32", (2003,), 1, "float32"),
]
# lm-train's full-width K1 check: elements per batch of leaves (p, g and
# the plain result, 12 GiB in f32 at 2^30)
K1_BATCH_ELEMENTS = 1 << 30
K1_MAIN_CASE = "tree:paper-resnet16"  # the train path's one launch a round
TRAIN_RUNS = [  # (arch, batch per client, K1 leaves per round)
    ("paper-resnet16", 8, 17),
    ("paper-mlp", 16, 8),
]
ROUNDS = 200
LOG_EVERY = 20  # the launcher's history cadence (TrainConfig's default)
BASELINES = ("fedavg", "fedprox", "splitfed", "smofi", "parallelsfl", "fedem")
# the reference's Table 2 setting for the baselines on resnet
# (benchmarks/table2_accuracy.py): lr 0.1, 30 local steps, 450 gradient
# steps, 8 samples per client and step
BASELINE_RUN = {"arch": "paper-resnet16", "b": 8, "lr": 0.1, "local_steps": 30,
                "rounds": 15, "k1_leaves": 17}
BASELINE_UNPROBED_ROUNDS = 6  # fedavg once more without the probe
LM_BASELINES = {"arch": "mamba2-130m", "M": 4, "b": 4, "S": 256, "rounds": 10,
                "lr": 0.05, "local_steps": 2, "data_vocab": 4096}
# the serving phases of the SSM and hybrid LMs at full width and depth: 8
# requests alternating clients, prompts of 64..256 tokens, 32 new tokens, 4
# slots, chunk 64, random weights from a seed, bf16 serving trees
# (profile: one more decode phase under torch.profiler; ssm-serve's gives
# the SSM decode step's busy share)
SERVE_RUNS = {
    "ssm-serve": {"arch": "mamba2-130m", "M": 4, "profile": True,
                  "sequential": True},
    "hybrid-serve": {"arch": "zamba2-7b", "M": 2, "profile": False,
                     "sequential": False},
    # deepseek-moe-16b at full depth (its tower holds the dense lead and one
    # MoE layer, so the continuous engine's slot-alone dispatch runs)
    "moe-serve": {"arch": "deepseek-moe-16b", "M": 2, "profile": True,
                  "sequential": True},
}
SERVE_TRAFFIC = {"requests": 8, "slots": 4, "chunk": 64, "prompt_len": 256,
                 "min_prompt_len": 64, "new_tokens": 32}
# sparity: full width, f32, cut depth (mamba2-130m 6 layers, split 2;
# zamba2-7b 12 layers, split 5: its shared attention at layers 5 and 11,
# both on the server)
SPARITY_ARCHS = {"mamba2-130m": {"num_layers": 6, "split_layers": 2},
                 "zamba2-7b": {"num_layers": 12, "split_layers": 5}}
SPARITY_LOGITS_TOL = 1e-4  # card vs CPU prefill logits, of max(1, max |logit|)
# the VLM and the encoder-decoder at full width and depth through the
# launcher's sequential engine (--bench: a warm-up generation, then a timed
# prefill and decode), with vision features / audio frames from the seed
SEQ_SERVE_RUNS = {
    "vlm-serve": {"arch": "llama-3.2-vision-11b", "M": 2, "b": 2,
                  "prompt_len": 256, "new_tokens": 32},
    "encdec-serve": {"arch": "whisper-tiny", "M": 4, "b": 2, "prompt_len": 64,
                     "new_tokens": 32},
}
# mistral-nemo-12b-swa's ring caches (4096 slots) at full width and depth:
# a prompt whose decode wraps the ring, then one longer than the ring (the
# rolled prefill)
SWA_SERVE = {"arch": "mistral-nemo-12b-swa", "M": 2, "b": 1, "new_tokens": 64,
             "prompt_lens": (4064, 4608)}
# xparity: full width, f32, cut depth (whisper-tiny whole); the MoE at the
# smoke configs' no-drop capacity factor, the ring at a window of 64
XPARITY_ARCHS = {
    "deepseek-moe-16b": {"num_layers": 4, "split_layers": 2,
                         "capacity_factor": 8.0},
    "llama-3.2-vision-11b": {"num_layers": 5, "split_layers": 2},
    "whisper-tiny": {},
    "mistral-nemo-12b-swa": {"num_layers": 4, "split_layers": 2,
                             "sliding_window": 64, "decode_long_window": 64},
}
XPARITY_LOGITS_TOL = 1e-4  # card vs CPU logits, of max(1, max |logit|) per row
# graphs: replayed steps against eager ones. f32 at parity's, sparity's and
# xparity's cut depths, M = 2, 4 requests over 2 slots at chunk 64 (the
# sequential engine: one batch of 2 rows a client at the longest prompt)
GRAPH_F32_ARCHS = {"gemma3-12b": {"num_layers": 12}, **SPARITY_ARCHS,
                   **XPARITY_ARCHS}
GRAPH_REQUESTS = ([5, 70, 130, 17], [8, 6, 8, 7])  # prompt lengths, new tokens
GRAPH_MAX_LEN = 160
GRAPH_LOGITS_TOL = 1e-6  # replayed vs eager logits, of max(1, max |logit|) per row
PROFILE_MARGIN_S = 0.05  # host time between a profiled window and the trace's ends
PROFILER_LOST_MAX = 1  # kernel records of K4, and of K3, a profiled window may lack
# bf16 at full width with each serving phase's configuration and traffic:
# phase -> (arch, M, b, prompt_len, min_prompt_len, new_tokens, engine)
GRAPH_BF16 = {
    "slice": ("gemma3-12b", 2, 4, 256, 64, 32, "continuous"),
    **{key: (c["arch"], c["M"], SERVE_TRAFFIC["requests"] // c["M"],
             SERVE_TRAFFIC["prompt_len"], SERVE_TRAFFIC["min_prompt_len"],
             SERVE_TRAFFIC["new_tokens"], "continuous")
       for key, c in SERVE_RUNS.items()},
    **{key: (c["arch"], c["M"], c["b"], c["prompt_len"], None, c["new_tokens"],
             "sequential") for key, c in SEQ_SERVE_RUNS.items()},
    "swa-serve": (SWA_SERVE["arch"], SWA_SERVE["M"], SWA_SERVE["b"],
                  SWA_SERVE["prompt_lens"][0], None, SWA_SERVE["new_tokens"],
                  "sequential"),
}
# ckpt: the LM example's --full config, trained as lm-learn trains it
CKPT = {"arch": "mamba2-130m", "M": 4, "b": 4, "S": 256, "lr": 3e-3,
        "data_vocab": 4096, "rounds": 20, "resume_at": 10}
# round-1 gradients, card against CPU, max |a - b| / max |b| of the worst
# leaf, set from the readings on an H100 (PERF.md): f64, the witness that
# both compute one function (read: 8.3e-16), and f32 (read: 9.8e-4, twice
# that allowed). The f32 gap is not summation noise alone: a few tower
# ReLU inputs lie within 2.2e-7 of 0, and f32 rounds them to the other
# side on the card (4) and on the CPU (0 to 3), each flip moving whole
# gradient terms
GRAD_GAP_F64 = 1e-12
GRAD_GAP_F32 = 2e-3
# state leaves that hold raw gradient sums, not parameters: SMoFi's fused
# momentum buffer (v <- 0.9 v + mean g, no step size). bparity holds them
# as gradients (GRAD_GAP_F32 of the leaf's scale), the parameters within
# 1e-4: the same ReLU flips (two server and tower inputs within 6.7e-7 of
# 0 at SMoFi's third round, full paper-resnet16, seed 3, on a CPU:
# tests/torch_baseline_drift.py flips) move whole gradient terms, which a
# parameter takes times lr 0.01 but the buffer takes whole (read on an
# H100: 1.96e-4 absolute, 1.2e-3 of the leaf's scale, in
# smom/stage2/b0/conv1/w). The f64 witness shows the card computes the
# CPU's buffer (read: 9.4e-16 of its scale) and that f32 itself puts
# that leaf 1.2e-3 of its scale from f64 on each side
GRADIENT_SUM_LEAVES = ("smom/",)


@contextlib.contextmanager
def _deterministic(torch):
    """torch.use_deterministic_algorithms(True, warn_only=True) inside the
    block. Yields a list that, after the block, names the ops that ran and
    have no deterministic algorithm on the card (their warnings). The card
    side of tparity's and bparity's f32 trajectories runs inside it: with
    the defaults, cuDNN's convolutions give resnet16 a different state each
    run, which SMoFi's momentum can carry past the loss tolerance
    (tests/torch_card_determinism.py)."""
    ops = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield ops
        finally:
            torch.use_deterministic_algorithms(False)
    ops += sorted({str(w.message).split(".")[0][:100] for w in caught
                   if "deterministic" in str(w.message)})


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def _median_ms(fn, iters: int, flush, head_start: bool = True) -> float:
    """Median of `iters` timed calls of fn, each behind an L2 flush. With
    head_start the card's work alone; without, the host's time to issue fn
    too, wherever the card waits for it."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()  # the serving path finds each layer's cache cold in L2
        # ~0.2 ms of spinning on the card, so that the host has queued fn's
        # first launch before the start event runs: the events then time the
        # card's work, not the host's wrapper
        if head_start:
            torch.cuda._sleep(HEAD_START_CYCLES)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2]


def kernel_phase(torch, dev):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import decode_reference

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    tol = {"bfloat16": 2e-2, "float32": 2e-5}
    rows = []
    for name, B, cap, Hq, Hkv, D, window, dt, (lo, hi), mode in K4_CASES:
        dtype = getattr(torch, dt)
        q = torch.randn(B, 1, Hq, D, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, cap, Hkv, D, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, cap, Hkv, D, generator=gen, device=dev).to(dtype)
        kv_valid = torch.randint(lo, hi, (B,), generator=gen, device=dev,
                                 dtype=torch.int32)
        kv_valid[-1] = hi - 1  # one row full
        q_offset = kv_valid - 1
        kw = dict(kv_valid=kv_valid, q_offset=q_offset, window=window)
        out = flash_decode(q, k, v, mode=mode, **kw)
        again = flash_decode(q, k, v, mode=mode, **kw)
        ref = decode_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not err <= tol[dt]:
            raise AssertionError(f"K4 {name}: max |kernel - plain| {err} > {tol[dt]}")
        if not torch.equal(out, again):
            raise AssertionError(f"K4 {name}: two launches differ")

        kpos = torch.arange(cap, device=dev)
        mask = kpos[None, :] < kv_valid[:, None]
        if window:
            mask &= kpos[None, :] > q_offset[:, None] - window
        visible = int(mask.sum().item())
        elt = q.element_size()
        nbytes = (2 * visible * Hkv * D + 2 * B * Hq * D) * elt + 2 * 4 * B
        flops = 4 * visible * Hq * D
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dt]
        qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        amask = mask[:, None, None, :]
        row = {
            "case": name, "B": B, "cap": cap, "window": window, "dtype": dt,
            "mode": mode, "max_abs_err": err,
            "ms": _median_ms(lambda: flash_decode(q, k, v, mode=mode, **kw), 50,
                             flush),
            "plain_ms": _median_ms(lambda: decode_reference(q, k, v, **kw), 10,
                                   flush),
            "library_ms": _median_ms(
                lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=amask, enable_gqa=True), 20, flush),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "visible_rows": visible, "repeat_bit_equal": True,
        }
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        print(f"  K4 {name}: err {err:.3g}  kernel {row['ms']:.4f} ms  plain "
              f"{row['plain_ms']:.4f} ms  sdpa {row['library_ms']:.4f} ms  "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, share "
              f"{row['bound_share']:.3f})", flush=True)
    rows.append(_k4_cap_case(torch, dev, gen))
    del flush
    return rows


def _k4_cap_case(torch, dev, gen):
    """The serving path's rows in a cap-320 and in a cap-4096 buffer (the
    rows past 320 hold other values): the outputs must be bit-equal, in
    bf16 (split-KV) and in f32."""
    from repro_torch.kernels.flash_decode.ops import flash_decode

    B, Hq, Hkv, D = 4, 16, 8, 256
    kv_valid = torch.tensor([1, 64, 200, 320], dtype=torch.int32, device=dev)
    res = {"case": "cap320_vs_cap4096", "B": B, "kv_valid": kv_valid.tolist()}
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        q = torch.randn(B, 1, Hq, D, generator=gen, device=dev).to(dtype)
        big = [torch.randn(B, 4096, Hkv, D, generator=gen, device=dev).to(dtype)
               for _ in range(2)]
        small = [t[:, :320].contiguous() for t in big]
        for window in (0, 1024):
            kw = dict(kv_valid=kv_valid, q_offset=kv_valid - 1, window=window)
            if not torch.equal(flash_decode(q, *small, **kw), flash_decode(q, *big, **kw)):
                raise AssertionError(f"K4 {dt} window {window}: cap 320 and cap 4096 "
                                     f"give different outputs for the same rows")
        res[f"{dt}_bit_equal"] = True
    print(f"  K4 cap320_vs_cap4096: bit-equal in bf16 and f32, windows 0 and 1024",
          flush=True)
    return res


# each serving phase's launcher metrics (its replayed run), which the
# graphs phase sets beside an eager run of the same configuration
_REPLAYED = {}


def _check_captures(m: dict, want: int, what: str):
    """The launcher's engine captured `want` graphs (its steps), whatever
    the number of requests it served."""
    if not (m["graphs"] and m["captures"] == want and m["graph_pool_bytes"]):
        raise AssertionError(f"{what}: {m['captures']} graphs captured "
                             f"(graphs {m['graphs']}), want {want}")


def _graph_stats(m: dict) -> dict:
    return {"captures": m["captures"], "capture_ms": m["capture_ms"],
            "graph_pool_gib": m["graph_pool_bytes"] / 2**30}


def slice_phase(torch):
    from repro_torch.launch import serve

    M, new_tokens, vocab = 2, 32, 262_144
    argv = ["--arch", "gemma3-12b", "--no-smoke", "--device", "cuda",
            "--num-clients", str(M), "--batch-per-client", "4",
            "--slots", "4", "--chunk", "64", "--prompt-len", "256",
            "--min-prompt-len", "64", "--new-tokens", str(new_tokens),
            "--engine", "continuous", "--bench", "--profile", "--seed", "0"]
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(torch)
    t0 = time.perf_counter()
    m = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _REPLAYED["slice"] = m
    got = _read_counts(torch)
    launches, calls, plain = got["k4"], got["attn_decode"], got["k4_plain"]

    outs = m["outputs"]
    if len(outs) != 2 * 4:
        raise AssertionError(f"{len(outs)} requests returned, want 8")
    for i, o in enumerate(outs):
        if o.shape != (new_tokens,) or o.min() < 0 or o.max() >= vocab:
            raise AssertionError(f"request {i}: bad tokens {o}")
    if not m["logits_finite"]:
        raise AssertionError("non-finite logits")
    per_step = 6 * M + 42
    if not (launches == calls == per_step * m["decode_steps"] and launches > 0):
        raise AssertionError(
            f"K4 launches {launches}, attn_decode calls {calls}, decode steps "
            f"{m['decode_steps']} x {per_step}")
    if plain != 0:
        raise AssertionError(f"plain decode ran {plain} times on the card")
    _check_captures(m, M + 1, "slice")
    return {"prefill_ms": m["prefill_ms"], "decode_tok_s": m["decode_tok_s"],
            **_graph_stats(m),
            "tok_s_per_slot": m["tok_s_per_slot"], "slots": m["slots"],
            "decode_steps": m["decode_steps"], "extend_chunks": m["extend_chunks"],
            "k4_launches": launches, "attn_decode_calls": calls,
            "k4_launches_per_decode_step": per_step, "profile": m["profile"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "phase_s": wall}


def parity_phase(torch):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.launch.serve import init_params
    from repro_torch.models import build_model, layers
    from repro_torch.serve.continuous import ContinuousEngine, Request
    from repro_torch.serve.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("gemma3-12b").with_updates(num_layers=12, dtype="float32")
    model = build_model(cfg)
    M, max_len = 2, 64
    params = init_params(model, M, seed=1, device="cuda")
    rng = np.random.default_rng(1)
    lens, new = [5, 23, 40, 17], [8, 6, 8, 7]
    prompts = [rng.integers(0, cfg.vocab_size, size=L) for L in lens]
    n0, c0 = flash_decode.counts.total(), layers.attn_decode.calls

    eng = ContinuousEngine(model, params, M, max_len, slots=2, chunk=16,
                           device="cuda")
    for i, (p, n) in enumerate(zip(prompts, new)):
        eng.submit(Request(id=i, client=i % M, tokens=p, new_tokens=n))
    res = eng.run()
    seq = ServeEngine(model, params, M, max_len, device="cuda")
    for i, (p, n) in enumerate(zip(prompts, new)):
        toks = np.zeros((M, 1, len(p)), np.int64)
        toks[i % M, 0] = p
        ref = seq.generate_sequential({"tokens": toks}, n)[i % M, 0].numpy()
        if not (res[i] == ref).all():
            raise AssertionError(f"request {i}: continuous {res[i]} != "
                                 f"sequential {ref}")
    launches = flash_decode.counts.total() - n0
    if launches != layers.attn_decode.calls - c0:
        raise AssertionError("a decode attention bypassed K4 in the parity phase")
    return {"requests": len(prompts), "tokens": int(sum(new)),
            "k4_launches": launches}


def build_phase() -> dict:
    """Build every kernel at once, one nvcc per source; the registers lines
    of each ptxas report."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as k2_ops
    from repro_torch.kernels.flash_decode import ops as k4_ops
    from repro_torch.kernels.mtsl_update import ops as k1_ops
    from repro_torch.kernels.ssd_scan import ops as k3_ops

    libs = {"flash_decode": k4_ops._lib, "mtsl_update": k1_ops._lib,
            "flash_attention": k2_ops._lib, "ssd_scan": k3_ops._lib}
    with ThreadPoolExecutor(len(libs)) as ex:
        for fut in [ex.submit(fn) for fn in libs.values()]:
            fut.result()
    return {name: [ln.strip() for ln in build.BUILD_LOGS.get(name, "").splitlines()
                   if "registers" in ln] for name in libs}


def k1_cases(torch) -> list:
    """(case, shape, rows, dtype, paths) of K1: every leaf that a train
    path updates, read from the initial tree of each TRAIN_RUNS model at
    full size (tower leaves [M, ...] take one step size per client, R = M;
    server leaves R = 1), one case per distinct shape named after its
    first leaf; then the flat cases."""
    from repro_torch.configs import get_config
    from repro_torch.core.mtsl import init_state
    from repro_torch.core.split import is_client_path
    from repro_torch.models.registry import build_model
    from repro_torch.utils.tree import tree_leaves_with_path

    cases = {}
    for arch, _, _ in TRAIN_RUNS:
        cfg = get_config(arch)
        M = cfg.num_clients
        tree = init_state(build_model(cfg), torch.Generator().manual_seed(0), M)
        for path, leaf in tree_leaves_with_path(tree):
            key = (tuple(leaf.shape), M if is_client_path(path) else 1,
                   str(leaf.dtype).removeprefix("torch."))
            cases.setdefault(key, []).append(f"{arch}/{path}")
    return ([(paths[0], *key, paths) for key, paths in cases.items()]
            + [(*c, []) for c in K1_FLAT_CASES])


def k1_phase(torch, dev):
    from repro_torch.kernels.mtsl_update.ops import mtsl_update_
    from repro_torch.kernels.mtsl_update.ref import mtsl_update_reference

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows_out = []
    for name, shape, rows, dt, paths in k1_cases(torch):
        dtype = getattr(torch, dt)
        p = torch.randn(shape, generator=gen, device=dev).to(dtype)
        g = torch.randn(shape, generator=gen, device=dev).to(dtype)
        eta = torch.rand(rows, generator=gen, device=dev) * 10
        if rows > 1:
            eta[0] = 0.0  # a non-participating client: bit-frozen
        ref = mtsl_update_reference(p, g, eta)
        out = mtsl_update_(p.clone(), g, eta)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.equal(out, ref):
            raise AssertionError(f"K1 {name}: kernel != plain (max |diff| {err})")
        pk, pl = p.clone(), p.clone()
        if rows == 1:
            a = float(eta[0])

            def library():
                return pl.add_(g, alpha=-a)
        else:
            def library():
                return pl.view(rows, -1).addcmul_(eta[:, None], g.view(rows, -1),
                                                  value=-1)
        t_bytes = 3 * p.numel() * p.element_size() / HBM_BYTES_PER_S
        row = {
            "case": name, "shape": list(shape), "rows": rows, "dtype": dt,
            "leaves": paths, "max_abs_err": err, "bit_equal": True,
            "ms": _median_ms(lambda: mtsl_update_(pk, g, eta), 50, flush),
            "plain_ms": _median_ms(lambda: mtsl_update_reference(p, g, eta), 20,
                                   flush),
            "library_ms": _median_ms(library, 20, flush),
            "bound_ms": t_bytes * 1e3, "bound_by": "bytes",
        }
        rows_out.append(row)
        print(f"  K1 {name} {tuple(shape)} R={rows} {dt} ({len(paths)} leaves): "
              f"bit-equal  kernel "
              f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  library "
              f"{row['library_ms']:.4f} ms  bound {row['bound_ms']:.5f} ms",
              flush=True)
    for arch, _, _ in TRAIN_RUNS:
        rows_out.append(_k1_tree_case(torch, dev, gen, flush, arch))
    rows_out.append(_k1_hold_case(torch, dev, gen))
    del flush
    return rows_out


def _k1_hold_case(torch, dev, gen):
    """One multi-tensor launch whose step sizes are partly 0, as a baseline's
    local step makes it: every leaf of full paper-resnet16 as per-client
    copies [M, ...] with a straggler mask over the clients, a per-cluster
    leaf [2, ...] with an idle cluster, and a shared leaf on a step with no
    active client. Held rows must come back bit-unchanged, the rest equal
    to the plain version's."""
    from repro_torch.configs import get_config
    from repro_torch.core.federation import init_fedavg_params
    from repro_torch.kernels.mtsl_update.ops import mtsl_update_multi_
    from repro_torch.kernels.mtsl_update.ref import mtsl_update_reference
    from repro_torch.models.registry import build_model
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config("paper-resnet16")
    M = cfg.num_clients
    tree = init_fedavg_params(build_model(cfg), torch.Generator().manual_seed(0), M)
    live = torch.tensor([1, 0, 1, 1, 0, 0, 1, 0, 1, 1], dtype=torch.float32, device=dev)
    shapes = [(tuple(x.shape), 0.1 * live) for x in tree_leaves(tree)]
    shapes += [((2, 3, 3, 32, 64), torch.tensor([0.0, 0.1], device=dev)),
               ((64, 10), torch.zeros(1, device=dev))]
    ps = [torch.randn(shape, generator=gen, device=dev) for shape, _ in shapes]
    gs = [torch.randn(shape, generator=gen, device=dev) for shape, _ in shapes]
    etas = [eta for _, eta in shapes]
    before = [p.clone() for p in ps]
    refs = [mtsl_update_reference(p, g, e) for p, g, e in zip(ps, gs, etas)]
    n0 = mtsl_update_multi_.launches
    mtsl_update_multi_(ps, gs, etas)
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(ps, refs))
    held = sum(int((e == 0).sum()) for e in etas)
    for p, b, r, e in zip(ps, before, refs, etas):
        rows = e.numel()
        if not (torch.equal(p, r) and torch.equal(p.view(rows, -1)[e == 0],
                                                  b.view(rows, -1)[e == 0])):
            raise AssertionError("K1 hold: a held row moved, or kernel != plain")
    if mtsl_update_multi_.launches != n0 + 1:
        raise AssertionError("K1 hold: not one launch")
    row = {"case": "hold:paper-resnet16", "leaves": len(ps),
           "numel": sum(p.numel() for p in ps), "held_rows": held,
           "max_abs_err": err, "bit_equal": True, "held_rows_unchanged": True}
    print(f"  K1 hold ({len(ps)} leaves, {held} rows at step 0) one launch: "
          f"bit-equal, held rows unchanged", flush=True)
    return row


def _k1_tree_case(torch, dev, gen, flush, arch):
    """The whole initial tree of full `arch` (M = 10) through the
    multi-tensor call, as the train path's apply step updates it: towers
    with one step size per client (one of them 0), the server with one."""
    from repro_torch.configs import get_config
    from repro_torch.core.mtsl import init_state
    from repro_torch.core.split import is_client_path
    from repro_torch.kernels.mtsl_update.ops import (launch_table, leaf_table,
                                                     mtsl_update_multi_)
    from repro_torch.kernels.mtsl_update.ref import mtsl_update_reference
    from repro_torch.models.registry import build_model
    from repro_torch.utils.tree import tree_leaves_with_path

    cfg = get_config(arch)
    M = cfg.num_clients
    tree = init_state(build_model(cfg), torch.Generator().manual_seed(0), M)
    eta_t = torch.rand(M, generator=gen, device=dev) * 10
    eta_t[0] = 0.0
    eta_s = torch.rand(1, generator=gen, device=dev) * 10
    ps, gs, etas = [], [], []
    for path, leaf in tree_leaves_with_path(tree):
        ps.append(torch.randn(leaf.shape, generator=gen, device=dev))
        gs.append(torch.randn(leaf.shape, generator=gen, device=dev))
        etas.append(eta_t if is_client_path(path) else eta_s)
    refs = [mtsl_update_reference(p, g, e) for p, g, e in zip(ps, gs, etas)]
    out = mtsl_update_multi_([p.clone() for p in ps], gs, etas)
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(out, refs))
    if not all(torch.equal(a, b) for a, b in zip(out, refs)):
        raise AssertionError(f"K1 tree {arch}: kernel != plain (max |diff| {err})")
    pk = [p.clone() for p in ps]
    pl = [p.clone().view(e.numel(), -1) for p, e in zip(ps, etas)]
    gl = [g.view(e.numel(), -1) for g, e in zip(gs, etas)]
    el = [e[:, None] for e in etas]
    numel = sum(p.numel() for p in ps)
    table, pieces = leaf_table(pk, gs, etas)
    table = torch.from_numpy(table).to(dev)
    row = {
        "case": f"tree:{arch}", "leaves": len(ps), "numel": numel,
        "dtype": "float32", "max_abs_err": err, "bit_equal": True,
        # the kernel alone, on one table; then the call as a round makes it
        # (the host builds the table, copies it, launches)
        "ms": _median_ms(lambda: launch_table(table, pieces), 50, flush),
        "call_ms": _median_ms(lambda: mtsl_update_multi_(pk, gs, etas), 50, flush,
                              head_start=False),
        "plain_ms": _median_ms(lambda: [mtsl_update_reference(p, g, e) for p, g, e
                                        in zip(ps, gs, etas)], 20, flush),
        "library_ms": _median_ms(lambda: torch._foreach_addcmul_(pl, el, gl, value=-1),
                                 20, flush),
        "bound_ms": 3 * numel * 4 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }
    row["bound_share"] = row["bound_ms"] / row["ms"]
    print(f"  K1 tree {arch} ({len(ps)} leaves, {numel} elements) one launch: "
          f"bit-equal  kernel {row['ms']:.4f} ms  call {row['call_ms']:.4f} ms  "
          f"plain {row['plain_ms']:.4f} ms  "
          f"library {row['library_ms']:.4f} ms  bound {row['bound_ms']:.5f} ms "
          f"(share {row['bound_share']:.3f})", flush=True)
    return row


def _held_out_batch(cfg, M, per_task=64, seed=123):
    """Each task's test set (its main class only, paper §4.1), as the
    reference benchmarks draw it."""
    import numpy as np

    from repro_torch.data.synthetic import MultiTaskImageSource

    src = MultiTaskImageSource(num_classes=M, image_size=cfg.image_size,
                               channels=cfg.image_channels, seed=0)
    rng = np.random.default_rng(seed)
    xs, ys = zip(*(src.test_batch(rng, m, per_task) for m in range(M)))
    return {"image": np.stack(xs), "label": np.stack(ys).astype(np.int32)}


def train_phase(torch, dev, arch: str, b: int, leaves: int, rounds: int = ROUNDS):
    """The mtsl main path through the launcher as a user runs it (history
    every LOG_EVERY rounds, so the host reads the loss back only then), with
    K1's counts set to 0 just before and read just after. The loss checks
    read the logged rounds: rounds 1 and 20 against round 200."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.algorithms import get_algorithm
    from repro_torch.kernels.mtsl_update.ops import mtsl_update_, mtsl_update_multi_
    from repro_torch.kernels.mtsl_update.ref import mtsl_update_reference
    from repro_torch.launch import train as launch_train
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import stage_batch

    argv = ["--arch", arch, "--algorithm", "mtsl", "--device", dev.type,
            "--steps", str(rounds), "--batch-per-client", str(b), "--lr", "0.1",
            "--seed", "0"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        torch.backends.cudnn.allow_tf32 = True  # PyTorch's default: the
        # launcher must turn it off itself
    mtsl_update_.launches = 0
    mtsl_update_multi_.launches = mtsl_update_multi_.leaves = 0
    mtsl_update_reference.cuda_calls = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        state, hist = launch_train.main(argv)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, updated = mtsl_update_multi_.launches, mtsl_update_multi_.leaves
    single, plain = mtsl_update_.launches, mtsl_update_reference.cuda_calls
    if dev.type == "cuda" and (torch.backends.cudnn.allow_tf32
                               or torch.backends.cuda.matmul.allow_tf32):
        raise AssertionError(f"{arch}: the launcher left TF32 on")

    logged = sorted({1, rounds} | set(range(LOG_EVERY, rounds + 1, LOG_EVERY)))
    loss = np.array([e["loss"] for e in hist])
    r = np.array([e["round"] for e in hist])
    if r.tolist() != logged or not np.isfinite(loss).all():
        raise AssertionError(f"{arch}: history rounds {r.tolist()}, finite "
                             f"{np.isfinite(loss).all()}")
    first, last = loss[r <= 20].mean(), loss[r > rounds - 20].mean()
    if not last < first:
        raise AssertionError(f"{arch}: loss did not fall ({first} -> {last})")
    if dev.type == "cuda" and not (updated == leaves * rounds and launches == rounds
                                   and single == plain == 0):
        raise AssertionError(f"{arch}: K1 updated {updated} leaves in {launches} "
                             f"launches, want {leaves} x {rounds} in {rounds}; "
                             f"per-leaf launches {single}, plain updates on the "
                             f"card {plain}")
    cfg = get_config(arch)
    M = cfg.num_clients
    model = build_model(cfg)
    ev = get_algorithm("mtsl").eval_fn(model, M)(
        state, stage_batch(_held_out_batch(cfg, M), dev))
    steady_s = (hist[-1]["time"] - hist[0]["time"]) / (rounds - 1)
    res = {
        "arch": arch, "M": M, "batch_per_client": b, "rounds": rounds,
        "k1_launches": launches, "k1_leaves": leaves, "k1_leaves_updated": updated,
        "plain_updates_on_card": plain,
        "loss_first20": float(first), "loss_last20": float(last),
        "final_loss": float(loss[-1]), "acc_mtl_held_out": float(ev["acc_mtl"]),
        "phase_s": wall, "ms_per_round": steady_s * 1e3,
        "rounds_per_s": 1.0 / steady_s, "samples_per_s": M * b / steady_s,
    }
    if dev.type == "cuda":
        res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return res, state


def train_profile_phase(torch, dev, state, arch="paper-resnet16", b=8, rounds=20):
    """One torch.profiler pass over `rounds` more mtsl rounds from `state`,
    each as the launcher runs it (numpy synthesis, staging, round)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.algorithms import HParams, get_algorithm
    from repro_torch.core.lr_policy import server_scaled
    from repro_torch.core.schedule import full_schedule
    from repro_torch.data.pipeline import client_batches
    from repro_torch.data.synthetic import MultiTaskImageSource
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import stage_batch

    cfg = get_config(arch)
    M = cfg.num_clients
    rf = get_algorithm("mtsl").round_fn(
        build_model(cfg), M, HParams(lr=0.1, component_lr=server_scaled(M)))
    src = MultiTaskImageSource(num_classes=M, image_size=cfg.image_size,
                               channels=cfg.image_channels, seed=1)
    batches = client_batches(src, b, seed=1)
    sched = full_schedule(M, 1)
    state, _ = rf(state, stage_batch(next(batches), dev), sched)  # warm
    torch.cuda.synchronize()
    data_s = 0.0
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            td = time.perf_counter()
            batch = next(batches)
            data_s += time.perf_counter() - td
            state, metrics = rf(state, stage_batch(batch, dev), sched)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k1_ms = sum(e.self_device_time_total for e in kernels
                if "mtsl_update" in e.key) / 1e3
    return {
        "rounds": rounds, "wall_ms_per_round": wall_ms / rounds,
        "device_ms_per_round": device_ms / rounds,
        "device_busy_share": device_ms / wall_ms,
        "host_data_ms_per_round": data_s * 1e3 / rounds,
        "k1_device_ms_per_round": k1_ms / rounds,
        "kernel_launches_per_round": sum(e.count for e in kernels) / rounds,
        "top_kernels": [
            {"name": e.key[:80], "ms_per_round": e.self_device_time_total / 1e3 / rounds,
             "calls_per_round": e.count / rounds} for e in kernels[:10]],
    }


def _parity_setup(rounds: int):
    """What the parity phases start from: full paper-resnet16 (M = 10,
    b = 8), its initial tree on the CPU, `rounds` round batches and their
    masked schedules (participation 0.5), all from seed 3."""
    from repro_torch.configs import get_config
    from repro_torch.core.algorithms import HParams, get_algorithm
    from repro_torch.core.schedule import ScheduleConfig, schedule_stream
    from repro_torch.data.pipeline import client_batches
    from repro_torch.data.synthetic import MultiTaskImageSource
    from repro_torch.models.registry import build_model
    from repro_torch.utils.device import generator

    cfg = get_config("paper-resnet16")
    M, b = cfg.num_clients, 8
    model = build_model(cfg)
    init = get_algorithm("mtsl").init_state(model, generator("cpu", 3), M, HParams())
    src = MultiTaskImageSource(num_classes=M, image_size=cfg.image_size,
                               channels=cfg.image_channels, seed=3)
    batches = list(client_batches(src, b, steps=rounds, seed=3))
    scheds = schedule_stream(ScheduleConfig(participation_rate=0.5, seed=3), M, 1)
    return model, M, init.params, list(zip(batches, scheds))


def _relu_flips(torch, model, towers, image, truth=None, server=None):
    """The towers' ReLU inputs under vmap (with `server`, a server shared by
    every client, the server's after them), as f64 on the CPU; with `truth`
    (the same from an f64 run), per ReLU call that has any, the count of
    inputs whose sign differs from truth's and the largest |truth| among
    them."""
    import torch.nn.functional as F

    class Record(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is F.relu:
                self.seen.append(args[0])
            return func(*args, **(kwargs or {}))

    def fwd(tp, x):
        mode = Record()
        mode.seen = []
        with mode:
            h = model.tower_forward(tp, {"image": x})
            if server is not None:
                model.server_forward(server, h)
        return mode.seen

    acts = [a.detach().cpu().double() for a in torch.func.vmap(fwd)(towers, image)]
    if truth is None:
        return acts
    flips = {}
    for i, (a, t) in enumerate(zip(acts, truth)):
        f = (a > 0) != (t > 0)
        if f.any():
            flips[f"relu{i}"] = [int(f.sum()), float(t[f].abs().max())]
    return flips


def gradient_gap_phase(torch, dev):
    """Round-1 gradients of the parity phases' first round on `dev` and on
    the CPU, from one tree and batch, in f32 and in f64. Per leaf the gap
    is max |a - b| / max |b|; each reading names its worst leaf. If the
    card and the CPU compute one function, their f64 gradients agree to
    rounding (~1e-12 at most). Also counts the tower ReLU inputs whose
    sign in f32 differs from f64's on each side: such a flip moves whole
    gradient terms, far above f32 rounding."""
    from repro_torch.core.schedule import schedule_tensors
    from repro_torch.core.mtsl import TrainState, build_train_phases
    from repro_torch.optim import sgd
    from repro_torch.train.loop import stage_batch
    from repro_torch.utils.tree import tree_leaves_with_path, tree_map

    model, M, init, [(batch, sched)] = _parity_setup(1)
    local_step, _ = build_train_phases(model, sgd(0.1), M)
    grads, flips, truth = {}, {}, None
    for where in ("cpu", dev.type):
        for dt in (torch.float64, torch.float32):
            params = tree_map(lambda x: x.detach().to(where, dt).requires_grad_(), init)
            staged = {k: v.to(dt) if v.is_floating_point() else v
                      for k, v in stage_batch(batch, where).items()}
            mask, _, sizes = schedule_tensors(sched, where)
            g, _ = local_step(TrainState(params, (), 0), staged, mask, sizes)
            grads[where, dt] = {k: v.detach().cpu().double()
                                for k, v in tree_leaves_with_path(g)}
            with torch.no_grad():
                seen = _relu_flips(torch, model, params["towers"], staged["image"], truth)
            if truth is None:
                truth = seen
            else:
                side = "cpu" if where == "cpu" else "card"
                flips[f"{side}_{str(dt).removeprefix('torch.')}"] = seen

    def gap(a, b):
        rel, leaf = max(
            (float((grads[a][k] - ref).abs().max()) / (float(ref.abs().max()) or 1.0), k)
            for k, ref in grads[b].items())
        return {"rel": rel, "leaf": leaf,
                "leaf_max_abs_grad": float(grads[b][leaf].abs().max())}

    f32, f64 = torch.float32, torch.float64
    res = {"card_vs_cpu_f32": gap((dev.type, f32), ("cpu", f32)),
           "card_vs_cpu_f64": gap((dev.type, f64), ("cpu", f64)),
           "card_f32_vs_f64": gap((dev.type, f32), ("cpu", f64)),
           "cpu_f32_vs_f64": gap(("cpu", f32), ("cpu", f64)),
           "card_vs_cpu_f32_by_leaf": {
               k: float((grads[dev.type, f32][k] - ref).abs().max())
               / (float(ref.abs().max()) or 1.0)
               for k, ref in grads["cpu", f32].items()},
           "relu_flips_vs_cpu_f64": flips,
           "participants": sched.num_participants}
    if not res["card_vs_cpu_f64"]["rel"] <= GRAD_GAP_F64:
        raise AssertionError(f"f64 gradients, card vs CPU: {res}")
    if not res["card_vs_cpu_f32"]["rel"] <= GRAD_GAP_F32:
        raise AssertionError(f"f32 gradients, card vs CPU: {res}")
    return res


def _card_vs_cpu_rounds(torch, lr: float, rounds: int = 3):
    """`rounds` masked mtsl rounds of full paper-resnet16 (M = 10, b = 8)
    on the card and on the CPU from one tree and one batch stream. Returns
    per round the card's and the CPU's loss, the participants, and the
    largest parameter gap with the leaf it is in; raises if a loss differs
    by more than 1e-5 relative or a card update bypassed K1."""
    from repro_torch.core.algorithms import HParams, get_algorithm
    from repro_torch.core.lr_policy import server_scaled
    from repro_torch.core.mtsl import TrainState
    from repro_torch.kernels.mtsl_update.ops import mtsl_update_multi_
    from repro_torch.train.loop import stage_batch
    from repro_torch.utils.tree import tree_leaves_with_path, tree_map

    model, M, init, stream = _parity_setup(rounds)
    alg = get_algorithm("mtsl")
    hp = HParams(lr=lr, component_lr=server_scaled(M))
    cpu = TrainState(tree_map(lambda x: x.detach().clone().requires_grad_(), init),
                     (), 0)
    gpu = TrainState(tree_map(lambda x: x.detach().cuda().requires_grad_(), init),
                     (), 0)
    rf_cpu, rf_gpu = alg.round_fn(model, M, hp), alg.round_fn(model, M, hp)
    n0, l0 = mtsl_update_multi_.launches, mtsl_update_multi_.leaves
    per_round = []
    for batch, sched in stream:
        with _deterministic(torch) as nondet:
            gpu, mg = rf_gpu(gpu, stage_batch(batch, "cuda"), sched)
        if nondet:
            raise AssertionError(f"lr {lr}: card ops without a deterministic "
                                 f"algorithm: {nondet}")
        cpu, mc = rf_cpu(cpu, stage_batch(batch, "cpu"), sched)
        lg, lc = float(mg["loss"]), float(mc["loss"])
        if not abs(lg - lc) <= 1e-5 * abs(lc):
            raise AssertionError(f"lr {lr}: card loss {lg} vs CPU {lc}")
        cpu_leaves = dict(tree_leaves_with_path(cpu.params))
        err, leaf = max(((a.detach().cpu() - cpu_leaves[k].detach()).abs().max().item(), k)
                        for k, a in tree_leaves_with_path(gpu.params))
        per_round.append({"card_loss": lg, "cpu_loss": lc,
                          "participants": sched.num_participants,
                          "max_param_abs_diff": err, "worst_leaf": leaf})
    if not (mtsl_update_multi_.leaves - l0 == 17 * rounds
            and mtsl_update_multi_.launches - n0 == rounds):
        raise AssertionError("a card update bypassed K1, or K1 took more than one "
                             "launch a round, in the parity phase")
    return per_round


def train_parity_phase(torch):
    """Card against CPU, then seeded repeatability on the card.

    First the round-1 gradients (`gradient_gap_phase`): the f64 pair must
    agree within GRAD_GAP_F64, the f32 pair within GRAD_GAP_F32. Then the
    parameters of 3 rounds are held within 1e-5 at lr 0.01. At the train
    slice's lr 0.1 an f32 gradient gap of that size moves the parameters by
    more than 1e-5, so there only the losses are held (1e-5 relative) and
    the parameter gap is reported."""
    from repro_torch.launch import train as launch_train
    from repro_torch.utils.tree import tree_leaves

    grads = gradient_gap_phase(torch, torch.device("cuda"))
    held = _card_vs_cpu_rounds(torch, 0.01)
    err = max(r["max_param_abs_diff"] for r in held)
    if not err <= 1e-5:
        raise AssertionError(f"lr 0.01: card vs CPU params differ by {err}: {held}")
    reported = _card_vs_cpu_rounds(torch, 0.1)

    argv = ["--arch", "paper-resnet16", "--device", "cuda", "--steps", "20",
            "--batch-per-client", "8", "--lr", "0.1", "--seed", "5",
            "--participation-rate", "0.5"]
    torch.use_deterministic_algorithms(True)
    try:
        finals = []
        for _ in range(2):
            with contextlib.redirect_stdout(io.StringIO()):
                state, _ = launch_train.main(argv)
            finals.append([x.detach().clone() for x in tree_leaves(state.params)])
    finally:
        torch.use_deterministic_algorithms(False)
    if not all(torch.equal(a, c) for a, c in zip(*finals)):
        raise AssertionError("two seeded 20-round card runs differ")
    return {"round1_grad_gap": grads, "lr0.01": held, "lr0.1": reported,
            "repeat_rounds": 20,
            "repeat_bit_equal": True}


def _allclose(got, want, tol: float) -> bool:
    """|got - want| <= tol + tol * |want| everywhere (numpy's assert_allclose
    with atol = rtol = tol, as tests/test_kernels.py holds the kernels)."""
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= tol + tol * want.abs()).all())


def _visible_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask lets through, per head: all Sq x Sk
    without the causal mask (the paths' non-causal calls have no window),
    else those of a causal (+ window) mask over Sq = Sk."""
    if not causal:
        return Sq * Sk
    S = Sq
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def k2_phase(torch, dev):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attn_mask, mha_reference

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    tol = {"bfloat16": 2e-2, "float32": 2e-5}
    rows = []
    for name, B, Sq, Sk, causal, Hq, Hkv, D, window, dt in K2_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(B, S, h, D, generator=gen, device=dev).to(dtype)
                   for S, h in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv)))
        out = flash_attention(q, k, v, causal, window)
        again = flash_attention(q, k, v, causal, window)
        ref = mha_reference(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"K2 {name}: two launches differ")
        err = (out.float() - ref.float()).abs().max().item()
        rel_l2 = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
        if not (_allclose(out, ref, tol[dt]) and rel_l2 <= K2_REL_L2[dt]):
            raise AssertionError(
                f"K2 {name}: kernel vs plain beyond {tol[dt]} (abs + rel; max "
                f"|diff| {err}) or ||diff|| / ||ref|| {rel_l2} > {K2_REL_L2[dt]}")
        nbytes = 2 * (B * Sq * Hq * D + B * Sk * Hkv * D) * q.element_size()
        flops = 4 * D * Hq * B * _visible_pairs(Sq, Sk, causal, window)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dt]
        qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if window:
            amask = attn_mask(Sq, Sk, causal=causal, window=window, device=dev)

            def library():
                return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=amask,
                                                      enable_gqa=True)
        else:
            def library():
                return F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                                      enable_gqa=True)
        row = {
            "case": name, "B": B, "Sq": Sq, "Sk": Sk, "causal": causal, "Hq": Hq,
            "Hkv": Hkv, "D": D, "window": window, "dtype": dt, "max_abs_err": err,
            "rel_l2_err": rel_l2,
            "ms": _median_ms(lambda: flash_attention(q, k, v, causal, window), 20, flush),
            "plain_ms": _median_ms(
                lambda: mha_reference(q, k, v, causal=causal, window=window), 5, flush),
            "library_ms": _median_ms(library, 20, flush),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": flops, "bytes": nbytes, "repeat_bit_equal": True,
        }
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        print(f"  K2 {name}: err {err:.3g} (l2 {rel_l2:.3g})  kernel {row['ms']:.4f} ms  plain "
              f"{row['plain_ms']:.4f} ms  sdpa {row['library_ms']:.4f} ms  "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, share "
              f"{row['bound_share']:.3f})", flush=True)
        del q, k, v, out, again, ref
    del flush
    return rows


def _rel_l2(got, want) -> float:
    """||got - want|| / ||want||, in f32."""
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def _k3_rounding(torch, y, x, dt, A, Bm, Cm, chunk, h0) -> dict:
    """Where a bf16 K3 output's error comes from. The plain version computes
    in f32 from the bf16 inputs and rounds y once; run on the same inputs
    in f32 it gives that y unrounded (y32). Against y32, the kernel's y
    carries the output's rounding and its own (W rounded to bf16 for the
    W x product); the output's rounding alone is the plain y's error
    against y32. Independent errors add in squares, so the kernel's own is
    the root of the difference. {} for f32."""
    from repro_torch.kernels.ssd_scan.ref import ssd_reference

    if x.dtype != torch.bfloat16:
        return {}
    y32, _ = ssd_reference(x.float(), dt, A, Bm.float(), Cm.float(), chunk=chunk,
                           initial_state=h0)
    total, out = _rel_l2(y, y32), _rel_l2(y32.to(y.dtype), y32)
    return {"rel_l2_vs_f32": total, "output_rounding_rel_l2": out,
            "w_rounding_rel_l2": max(total * total - out * out, 0.0) ** 0.5}


def k3_phase(torch, dev):
    from repro_torch.kernels.ssd_scan.ops import scan_plan, ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_reference

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    tol = {"bfloat16": 5e-2, "float32": 2e-5}
    rows = []
    for name, B, L, H, P, N, chunk, dt, with_state in K3_CASES:
        dtype = getattr(torch, dt)

        def rnd(*shape, lo=None, hi=None, d=torch.float32):
            if lo is None:
                return torch.randn(*shape, generator=gen, device=dev).to(d)
            return torch.rand(*shape, generator=gen, device=dev) * (hi - lo) + lo

        x = rnd(B, L, H, P, d=dtype)
        dtv = rnd(B, L, H, lo=0.01, hi=0.2)
        A = -rnd(H, lo=0.5, hi=2.0)
        Bm, Cm = rnd(B, L, N, d=dtype), rnd(B, L, N, d=dtype)
        h0 = rnd(B, H, P, N) if with_state else None
        y, st = ssd_scan(x, dtv, A, Bm, Cm, chunk=chunk, initial_state=h0)
        y2, st2 = ssd_scan(x, dtv, A, Bm, Cm, chunk=chunk, initial_state=h0)
        yr, sr = ssd_reference(x, dtv, A, Bm, Cm, chunk=chunk, initial_state=h0)
        torch.cuda.synchronize()
        if not (torch.equal(y, y2) and torch.equal(st, st2)):
            raise AssertionError(f"K3 {name}: two launches differ")
        plan = scan_plan(B, L, H, P, N, dtype)
        err = (y.float() - yr.float()).abs().max().item()
        serr = (st - sr).abs().max().item()
        rel_l2 = _rel_l2(y, yr)
        if not (_allclose(y, yr, tol[dt]) and serr <= 1e-4
                and rel_l2 <= K3_REL_L2[dt]):
            raise AssertionError(f"K3 {name}: y beyond {tol[dt]} (abs + rel; max "
                                 f"|diff| {err}), ||diff|| / ||ref|| {rel_l2} > "
                                 f"{K3_REL_L2[dt]}, or state max |diff| {serr} > 1e-4")
        split = _k3_rounding(torch, y, x, dtv, A, Bm, Cm, chunk, h0)
        elt = x.element_size()
        nbytes = (2 * B * L * H * P + 2 * B * L * N) * elt + 4 * (B * L * H + H) \
            + 4 * B * H * P * N * (2 if with_state else 1)
        flops = B * H * 2 * L * (chunk * N + chunk * P // 2 + 2 * P * N)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dt]
        row = {
            "case": name, "B": B, "L": L, "H": H, "P": P, "N": N, "chunk": chunk,
            "dtype": dt, "initial_state": with_state, "path": plan["path"],
            "heads_per_block": plan["G"], "blocks": plan["grid"][0] * (
                plan["grid"][1] if len(plan["grid"]) > 1 else 1),
            "max_abs_err": err, "state_abs_err": serr, "rel_l2_err": rel_l2, **split,
            "ms": _median_ms(lambda: ssd_scan(x, dtv, A, Bm, Cm, chunk=chunk,
                                              initial_state=h0), 20, flush),
            "plain_ms": _median_ms(lambda: ssd_reference(
                x, dtv, A, Bm, Cm, chunk=chunk, initial_state=h0), 5, flush),
            "library_ms": None,  # no PyTorch call computes the SSD scan
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": flops, "bytes": nbytes, "repeat_bit_equal": True,
        }
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        print(f"  K3 {name} ({plan['path']}, G {plan['G']}): err y {err:.3g} (l2 "
              f"{rel_l2:.3g}; {split}) state {serr:.3g}  kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms"
              f"  bound {row['bound_ms']:.4f} ms ({row['bound_by']}, share "
              f"{row['bound_share']:.3f})", flush=True)
        del x, dtv, Bm, Cm, y, st, y2, st2, yr, sr
    del flush
    return rows


def _lm_counts(torch):
    """The paths' Python counters, by name: (object, attribute). K2's
    launches and plain forwards on CUDA tensors; K3's plain forwards on
    CUDA tensors; K1's multi-tensor launches, the leaves they updated, its
    per-leaf launches and its plain update on CUDA tensors; serving's
    decode attentions and plain decodes on CUDA tensors. K3's and K4's
    launches are counted on the card (`_read_counts`)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import mha_reference
    from repro_torch.kernels.flash_decode.ref import decode_reference
    from repro_torch.kernels.mtsl_update.ops import mtsl_update_, mtsl_update_multi_
    from repro_torch.kernels.ssd_scan.ref import ssd_reference
    from repro_torch.models import layers

    from repro_torch.kernels.mtsl_update.ref import mtsl_update_reference

    return {"k2": (flash_attention, "launches"),
            "k2_bidir": (flash_attention, "launches_bidir"),
            "k2_cross": (flash_attention, "launches_cross"),
            "k1": (mtsl_update_multi_, "launches"),
            "k1_leaves": (mtsl_update_multi_, "leaves"),
            "k1_single": (mtsl_update_, "launches"),
            "k2_plain": (mha_reference, "cuda_calls"),
            "k3_plain": (ssd_reference, "cuda_calls"),
            "k1_plain": (mtsl_update_reference, "cuda_calls"),
            "attn_decode": (layers.attn_decode, "calls"),
            "k4_plain": (decode_reference, "cuda_calls")}


def _reset_counts(torch):
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    for obj, attr in _lm_counts(torch).values():
        setattr(obj, attr, 0)
    flash_decode.counts.reset()
    ssd_scan.counts.reset()


def _read_counts(torch):
    """_lm_counts' counters, and K4's and K3's launches as the launches
    counted themselves on the card (graph replays included; waits for the
    card): k4 (every mode), k4_ring, k4_cross, k3 (both paths), k3_tc."""
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    got = {name: getattr(obj, attr) for name, (obj, attr) in _lm_counts(torch).items()}
    k4, k3 = flash_decode.counts.read(), ssd_scan.counts.read()
    got.update(k4=sum(k4.values()), k4_ring=k4["ring"], k4_cross=k4["cross"],
               k3=sum(k3.values()), k3_tc=k3["tc"])
    return got


# (K2 causal, K2 non-causal self, K2 cross, K3) launches of one block's
# forward, by kind
_BLOCK_LAUNCHES = {"full": (1, 0, 0, 0), "swa": (1, 0, 0, 0),
                   "dense_moe_lead": (1, 0, 0, 0), "moe": (1, 0, 0, 0),
                   "bidir": (0, 1, 0, 0), "cross": (1, 0, 1, 0),
                   "mamba": (0, 0, 0, 1), "shared_attn": (1, 0, 0, 1)}


def _lm_launches_per_round(cfg, M: int, microbatches: int = 1,
                           local_steps: int = 1, full_models: bool = False) -> dict:
    """K2 (all, and the non-causal self and cross ones apart) and K3
    launches one round makes, from each stack's block kinds
    (`models.registry.stack_kinds`, _BLOCK_LAUNCHES): the towers run once
    per client and local step, the server once per step (mtsl, splitfed:
    the clients' smashed data folds into one batch) or once per client and
    step (`full_models`: fedavg's per-client full models); under remat
    every unit's forward runs again in the backward."""
    from repro_torch.models.registry import stack_kinds

    remat = 1 if cfg.remat == "none" else 2
    n = remat * microbatches * local_steps
    tot = [0, 0, 0, 0]
    for (side, _), kinds in stack_kinds(cfg).items():
        times = M if side == "tower" or full_models else 1
        for kind in kinds:
            for i, c in enumerate(_BLOCK_LAUNCHES[kind]):
                tot[i] += n * times * c
    causal, bidir, cross, k3 = tot
    return {"k2": causal + bidir + cross, "k2_bidir": bidir, "k2_cross": cross,
            "k3": k3}


_KERNEL_KINDS = (  # (kind, substrings of the kernel's name), first match wins
    ("k2", ("flash_attention",)), ("k3", ("ssd_scan",)), ("k1", ("mtsl_update",)),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma")),
    ("reduce", ("reduce", "softmax", "logsumexp", "scan")),
    ("copy_cast", ("copy", "cat", "index")),
    ("elementwise", ("elementwise",)),
)


def _profile_round(torch, rf, state, batch, sched):
    """torch.profiler over one round: device busy share and top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = rf(state, batch, sched)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3

    def share(tag):
        return sum(e.self_device_time_total for e in kernels if tag in e.key) / 1e3

    by_kind = {}
    for e in kernels:  # the port's kernels by name, PyTorch's by family
        name = e.key.lower()
        kind = next((k for k, tags in _KERNEL_KINDS if any(t in name for t in tags)),
                    "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3
    return state, {
        "loss": loss, "aux": float(metrics["aux"]),
        "wall_ms": wall_ms, "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "k2_device_ms": share("flash_attention"),
        "k3_device_ms": share("ssd_scan"),
        "k1_device_ms": share("mtsl_update"),
        "device_ms_by_kind": by_kind,
        "kernel_launches": sum(e.count for e in kernels),
        "top_kernels": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                         "calls": e.count} for e in kernels[:12]],
    }


def lm_train_phase(torch, dev):
    """zamba2-7b at full width and depth, trained through the loop and the
    registry (see the module docstring), with the K2 / K3 counts set to 0
    just before and read just after."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.core.algorithms import HParams, get_algorithm
    from repro_torch.core.lr_policy import server_scaled
    from repro_torch.core.schedule import full_schedule
    from repro_torch.data.lm import MultiTaskLMSource
    from repro_torch.data.pipeline import client_batches
    from repro_torch.models.registry import build_model
    from repro_torch.optim import sgd
    from repro_torch.core.split import is_client_path
    from repro_torch.train.loop import TrainConfig, stage_batch, train
    from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

    c = LM_TRAIN
    cfg = get_config(c["arch"])
    M, rounds = c["M"], c["rounds"]
    model = build_model(cfg)
    src = MultiTaskLMSource(vocab_size=c["data_vocab"], num_clients=M, beta=1.0, seed=0)
    batches = client_batches(src, c["b"], seed=0, seq_len=c["S"])
    tcfg = TrainConfig(steps=rounds, lr=c["lr"], log_every=1, seed=0, device=dev.type)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(torch)
    t0 = time.perf_counter()
    state, hist = train(model, sgd(c["lr"]), batches, tcfg, M,
                        component_lr=server_scaled(M), log=lambda _: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts(torch)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [e["loss"] for e in hist]
    if len(hist) != rounds or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"lm-train: losses {losses}")
    want = _lm_launches_per_round(cfg, M)
    leaves = len(tree_leaves(state.params))
    if not (counts["k2"] == want["k2"] * rounds
            and counts["k3"] == counts["k3_tc"] == want["k3"] * rounds
            and counts["k2_plain"] == counts["k3_plain"] == 0
            and counts["k1"] == rounds and counts["k1_leaves"] == leaves * rounds
            and counts["k1_single"] == 0):
        raise AssertionError(f"lm-train: counts {counts}, want per round {want} "
                             f"(K3 all on the tensor cores) and K1 {leaves} leaves "
                             f"x {rounds} in {rounds} launches, no plain forward")
    n_params = sum(x.numel() for x in tree_leaves(state.params))
    times = [e["time"] for e in hist]
    res = {"arch": c["arch"], "M": M, "b": c["b"], "S": c["S"], "rounds": rounds,
           "num_layers": cfg.num_layers, "d_model": cfg.d_model,
           "params": n_params, "losses": losses,
           "s_per_round": [times[0]] + [b - a for a, b in zip(times, times[1:])],
           "peak_mem_gib": peak, "phase_s": wall, "counts": counts,
           "launches_per_round": want, "k1_leaves": leaves}
    rf = get_algorithm("mtsl").round_fn(model, M, HParams(
        lr=c["lr"], component_lr=server_scaled(M)))
    batch = stage_batch(next(client_batches(src, c["b"], seed=1, seq_len=c["S"])), dev)
    state, res["profile"] = _profile_round(torch, rf, state, batch, full_schedule(M, 1))
    specs = [(tuple(x.shape), x.dtype, is_client_path(k))
             for k, x in tree_leaves_with_path(state.params)]
    del state, batch
    torch.cuda.empty_cache()
    res["k1_full_width"] = _k1_full_width(torch, dev, specs, M)
    return res


def _k1_full_width(torch, dev, specs, M: int) -> dict:
    """K1 against its plain version on lm-train's own leaves at full width
    (`specs`: shape, dtype, tower or not, in tree order): random p and g for
    every leaf, in batches of at most K1_BATCH_ELEMENTS elements (a larger
    leaf alone) that fit on the card beside their plain results, each batch
    one multi-tensor launch over a table of many leaves, bit-equal. Towers
    take one step size per client (one of them 0), the server one."""
    import math

    from repro_torch.kernels.mtsl_update.ops import leaf_table, mtsl_update_multi_
    from repro_torch.kernels.mtsl_update.ref import mtsl_update_reference

    gen = torch.Generator(device=dev).manual_seed(4)
    eta_t = torch.rand(M, generator=gen, device=dev) * 10
    eta_t[0] = 0.0
    eta_s = torch.rand(1, generator=gen, device=dev) * 10
    batches, size = [[]], 0
    for spec in specs:
        n = math.prod(spec[0])
        if batches[-1] and size + n > K1_BATCH_ELEMENTS:
            batches.append([])
            size = 0
        batches[-1].append(spec)
        size += n
    most_leaves = most_pieces = 0
    t0 = time.perf_counter()
    for batch in batches:
        ps = [torch.randn(shape, generator=gen, device=dev, dtype=dtype)
              for shape, dtype, _ in batch]
        gs = [torch.randn(shape, generator=gen, device=dev, dtype=dtype)
              for shape, dtype, _ in batch]
        etas = [eta_t if tower else eta_s for _, _, tower in batch]
        refs = [mtsl_update_reference(p, g, e) for p, g, e in zip(ps, gs, etas)]
        table, pieces = leaf_table(ps, gs, etas)
        most_leaves, most_pieces = max(most_leaves, len(table)), max(most_pieces, pieces)
        n0 = mtsl_update_multi_.launches
        mtsl_update_multi_(ps, gs, etas)
        torch.cuda.synchronize()
        bad = [shape for (shape, _, _), p, r in zip(batch, ps, refs)
               if not torch.equal(p, r)]
        if bad or mtsl_update_multi_.launches != n0 + 1:
            raise AssertionError(f"K1 at full width: kernel != plain on leaves {bad}")
        del ps, gs, refs
    res = {"leaves": len(specs), "elements": sum(math.prod(s[0]) for s in specs),
           "batches": len(batches), "largest_leaf": max(math.prod(s[0]) for s in specs),
           "most_leaves_in_a_launch": most_leaves,
           "most_pieces_in_a_launch": most_pieces, "bit_equal": True,
           "check_s": time.perf_counter() - t0}
    print(f"  K1 at full width: {res}", flush=True)
    return res


def lm_learn_phase(torch, dev):
    """mamba2-130m at its full config learns the per-client chains."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.algorithms import HParams, get_algorithm
    from repro_torch.core.lr_policy import server_scaled
    from repro_torch.core.schedule import full_schedule
    from repro_torch.data.lm import MultiTaskLMSource
    from repro_torch.data.pipeline import client_batches
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.loop import TrainConfig, stage_batch, train

    c = LM_LEARN
    cfg = get_config(c["arch"])
    M, rounds = c["M"], c["rounds"]
    model = build_model(cfg)
    src = MultiTaskLMSource(vocab_size=c["data_vocab"], num_clients=M, beta=1.0, seed=0)
    tcfg = TrainConfig(steps=rounds, lr=c["lr"], log_every=c["log_every"], seed=0,
                       device=dev.type)
    _reset_counts(torch)
    t0 = time.perf_counter()
    state, hist = train(model, adamw(c["lr"]), client_batches(src, c["b"], seed=0,
                                                              seq_len=c["S"]),
                        tcfg, M, component_lr=server_scaled(M), log=lambda _: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts(torch)
    loss = np.array([e["loss"] for e in hist])
    if not (np.isfinite(loss).all() and loss[-2:].mean() < loss[:2].mean()):
        raise AssertionError(f"lm-learn: the loss did not fall: {loss.tolist()}")
    want = _lm_launches_per_round(cfg, M)
    if not (counts["k3"] == counts["k3_tc"] == want["k3"] * rounds
            and counts["k3_plain"] == 0):
        raise AssertionError(f"lm-learn: counts {counts}, want per round {want}, "
                             f"every K3 launch on the tensor cores")
    held = stage_batch(next(client_batches(src, 8, seed=123, seq_len=c["S"])), dev)
    ev = get_algorithm("mtsl").eval_fn(model, M)(state, held)
    per = ev["per_task_loss"].cpu().numpy()
    floors = np.array([src.entropy_floor(m) for m in range(M)])
    rf = get_algorithm("mtsl").round_fn(model, M, HParams(
        optimizer=adamw(c["lr"]), component_lr=server_scaled(M)))
    t0 = time.perf_counter()
    batch = next(client_batches(src, c["b"], seed=1, seq_len=c["S"]))
    data_ms = (time.perf_counter() - t0) * 1e3
    state, profile = _profile_round(torch, rf, state, stage_batch(batch, dev),
                                    full_schedule(M, 1))
    del state
    return {"arch": c["arch"], "M": M, "b": c["b"], "S": c["S"], "rounds": rounds,
            "lr": c["lr"], "optimizer": "adamw",
            "logged": [{"round": e["round"], "loss": e["loss"]} for e in hist],
            "held_out_per_task_loss": per.tolist(), "entropy_floor": floors.tolist(),
            "gap_to_floor": (per - floors).tolist(), "phase_s": wall,
            "ms_per_round": (hist[-1]["time"] - hist[0]["time"]) / (rounds - 1) * 1e3,
            "host_data_ms": data_ms, "counts": counts, "profile": profile}


def _lm_parity_run(torch, arch, device, init, batches, rounds, seed_sched):
    from repro_torch.configs import get_config
    from repro_torch.core.algorithms import HParams, get_algorithm
    from repro_torch.core.lr_policy import server_scaled
    from repro_torch.core.mtsl import TrainState
    from repro_torch.core.schedule import ScheduleConfig, schedule_stream
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import stage_batch
    from repro_torch.utils.tree import tree_map

    cfg = get_config(arch, smoke=True)
    M = cfg.num_clients
    rf = get_algorithm("mtsl").round_fn(build_model(cfg), M, HParams(
        lr=0.1, component_lr=server_scaled(M)))
    state = TrainState(tree_map(lambda x: x.detach().to(device).clone()
                                .requires_grad_(), init), (), 0)
    scheds = schedule_stream(ScheduleConfig(participation_rate=0.5, seed=seed_sched), M, 1)
    metrics = []
    for batch, sched in zip(batches[:rounds], scheds):
        state, m = rf(state, stage_batch(batch, device), sched)
        metrics.append({"loss": float(m["loss"]),
                        "per_task": m["per_task"].detach().cpu().tolist()})
    return state, metrics


def lm_parity_phase(torch):
    """Smoke zamba2-7b and mamba2-130m: 3 rounds card vs CPU, then two
    seeded card runs against each other (deterministic algorithms on)."""
    from repro_torch.configs import get_config
    from repro_torch.core.mtsl import init_state
    from repro_torch.data.lm import MultiTaskLMSource
    from repro_torch.data.pipeline import client_batches
    from repro_torch.models.registry import build_model
    from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

    out = {}
    for arch in ("zamba2-7b", "mamba2-130m"):
        cfg = get_config(arch, smoke=True)
        M = cfg.num_clients
        init = init_state(build_model(cfg), torch.Generator().manual_seed(4), M)
        src = MultiTaskLMSource(vocab_size=cfg.vocab_size, num_clients=M, beta=0.5,
                                seed=4)
        batches = list(client_batches(src, 4, steps=3, seed=4, seq_len=64))
        _reset_counts(torch)
        gpu, mg = _lm_parity_run(torch, arch, "cuda", init, batches, 3, 4)
        counts = _read_counts(torch)
        cpu, mc = _lm_parity_run(torch, arch, "cpu", init, batches, 3, 4)
        for r, (a, b) in enumerate(zip(mg, mc)):
            if not abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"]):
                raise AssertionError(f"lm-parity {arch} round {r + 1}: card {a} vs CPU {b}")
        cpu_leaves = dict(tree_leaves_with_path(cpu.params))
        err, leaf = max(((x.detach().cpu() - cpu_leaves[k].detach()).abs().max().item(), k)
                        for k, x in tree_leaves_with_path(gpu.params))
        if not err <= 1e-4:
            raise AssertionError(f"lm-parity {arch}: card vs CPU params differ by "
                                 f"{err} at {leaf}")
        want = _lm_launches_per_round(cfg, M)
        if not (counts["k2"] == 3 * want["k2"] and counts["k3"] == 3 * want["k3"]
                and counts["k2_plain"] == counts["k3_plain"] == 0):
            raise AssertionError(f"lm-parity {arch}: counts {counts}, want {want} x 3")
        # deterministic algorithms where PyTorch has them; an op without one
        # (torch.cumsum on CUDA, in the plain SSD backward) only warns, and
        # the warnings are reported
        with _deterministic(torch) as nondet:
            finals = [[x.detach().clone() for x in tree_leaves(
                _lm_parity_run(torch, arch, "cuda", init, batches, 3, 4)[0].params)]
                for _ in range(2)]
        if not all(torch.equal(a, b) for a, b in zip(*finals)):
            raise AssertionError(f"lm-parity {arch}: two seeded card runs differ")
        out[arch] = {"card": mg, "cpu": mc, "max_param_abs_diff": err,
                     "worst_leaf": leaf, "counts": counts, "repeat_bit_equal": True,
                     "ops_without_deterministic_algorithm": nondet}
    return out


# ---------------------------------------------------------------------------
# the rest of the model zoo: encoder-decoder, MoE, VLM
# ---------------------------------------------------------------------------


def _zoo_batches(cfg, M: int, b: int, S: int, n: int, seed: int, vocab: int,
                 beta: float = 1.0) -> list:
    """n round batches: {"tokens": [M, b, S]} from the LM source at
    `vocab`, plus the VLM's "vis" [M, b, vis_seq, vis_dim] or the
    encoder-decoder's "frames" [M, b, encoder_seq, d_model] in f32 from
    np.random.default_rng(seed) (the reference's launch/specs.py shapes)."""
    import numpy as np

    from repro_torch.data.lm import MultiTaskLMSource
    from repro_torch.data.pipeline import client_batches

    src = MultiTaskLMSource(vocab_size=vocab, num_clients=M, beta=beta, seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for batch in client_batches(src, b, steps=n, seed=seed, seq_len=S):
        if cfg.family == "vlm":
            batch["vis"] = rng.standard_normal((M, b, cfg.vis_seq, cfg.vis_dim),
                                               dtype=np.float32)
        if cfg.family == "encdec":
            batch["frames"] = rng.standard_normal(
                (M, b, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
        out.append(batch)
    return out


def zoo_phase(torch, dev, key: str):
    """One of ZOO_RUNS trained through train/loop.py::train and the registry
    (see the module docstring), the counts set to 0 just before and read
    just after."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.core.algorithms import HParams, get_algorithm
    from repro_torch.core.lr_policy import server_scaled
    from repro_torch.core.schedule import full_schedule
    from repro_torch.models.moe import moe_forward
    from repro_torch.models.registry import build_model
    from repro_torch.optim import sgd
    from repro_torch.train.loop import TrainConfig, stage_batch, train
    from repro_torch.utils.tree import tree_leaves

    c = ZOO_RUNS[key]
    cfg = get_config(c["arch"])
    if c["num_layers"]:
        cfg = cfg.with_updates(num_layers=c["num_layers"])
    M, rounds = c["M"], c["rounds"]
    model = build_model(cfg)
    # drawn before the clock starts: the frames are 74 MB a round
    batches = _zoo_batches(cfg, M, c["b"], c["S"], rounds + 1, 0, c["data_vocab"])
    tcfg = TrainConfig(steps=rounds, lr=c["lr"], log_every=1, seed=0, device=dev.type)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(torch)
    moe_forward.tally = (torch.zeros(2, dtype=torch.int64, device=dev)
                         if cfg.family == "moe" else None)
    try:
        t0 = time.perf_counter()
        state, hist = train(model, sgd(c["lr"]), iter(batches[:rounds]), tcfg, M,
                            component_lr=server_scaled(M), log=lambda _: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts(torch)
        tally = moe_forward.tally
    finally:
        moe_forward.tally = None
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [e["loss"] for e in hist]
    if len(hist) != rounds or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{key}: losses {losses}")
    want = _lm_launches_per_round(cfg, M)
    leaves = len(tree_leaves(state.params))
    if not (all(counts[k] == want[k] * rounds for k in ("k2", "k2_bidir", "k2_cross"))
            and counts["k2"] > 0 and counts["k2_plain"] == 0
            and counts["k1"] == rounds and counts["k1_leaves"] == leaves * rounds
            and counts["k1_single"] == 0 and counts["k1_plain"] == 0):
        raise AssertionError(f"{key}: counts {counts}, want per round {want} and "
                             f"K1 {leaves} leaves x {rounds} in {rounds} launches, "
                             f"no plain forward")
    times = [e["time"] for e in hist]
    res = {"arch": c["arch"], "M": M, "b": c["b"], "S": c["S"], "rounds": rounds,
           "num_layers": cfg.num_layers, "d_model": cfg.d_model,
           "params": sum(x.numel() for x in tree_leaves(state.params)),
           "losses": losses,
           "s_per_round": [times[0]] + [b - a for a, b in zip(times, times[1:])],
           "peak_mem_gib": peak, "phase_s": wall, "counts": counts,
           "launches_per_round": want, "k1_leaves": leaves}
    if tally is not None:
        kept, routed = tally.tolist()
        res["moe_rows_kept"], res["moe_rows_routed"] = kept, routed
        res["dropped_share"] = 1.0 - kept / routed
    rf = get_algorithm("mtsl").round_fn(model, M, HParams(
        lr=c["lr"], component_lr=server_scaled(M)))
    state, res["profile"] = _profile_round(torch, rf, state,
                                           stage_batch(batches[rounds], dev),
                                           full_schedule(M, 1))
    del state, batches
    return res


def zoo_parity_phase(torch):
    """The smoke configs of ZOO_PARITY_ARCHS in f32: 3 masked mtsl rounds on
    the card (K2 in every mode, K1) against the CPU (plain versions) from
    one initial tree and one batch stream; then two seeded card runs of the
    MoE archs against each other (deterministic algorithms on)."""
    from repro_torch.configs import get_config
    from repro_torch.core.mtsl import init_state
    from repro_torch.models.registry import build_model
    from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

    out = {}
    for arch in ZOO_PARITY_ARCHS:
        cfg = get_config(arch, smoke=True)
        M = cfg.num_clients
        init = init_state(build_model(cfg), torch.Generator().manual_seed(4), M)
        batches = _zoo_batches(cfg, M, 4, 64, 3, 4, cfg.vocab_size, beta=0.5)
        _reset_counts(torch)
        gpu, mg = _lm_parity_run(torch, arch, "cuda", init, batches, 3, 4)
        counts = _read_counts(torch)
        cpu, mc = _lm_parity_run(torch, arch, "cpu", init, batches, 3, 4)
        for r, (a, b) in enumerate(zip(mg, mc)):
            if not abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"]):
                raise AssertionError(f"fparity {arch} round {r + 1}: card {a} vs CPU {b}")
        cpu_leaves = dict(tree_leaves_with_path(cpu.params))
        err, leaf = max(((x.detach().cpu() - cpu_leaves[k].detach()).abs().max().item(), k)
                        for k, x in tree_leaves_with_path(gpu.params))
        if not err <= 1e-4:
            raise AssertionError(f"fparity {arch}: card vs CPU params differ by "
                                 f"{err} at {leaf}")
        want = _lm_launches_per_round(cfg, M)
        if not (all(counts[k] == 3 * want[k] for k in ("k2", "k2_bidir", "k2_cross"))
                and counts["k2"] > 0 and counts["k2_plain"] == 0 and counts["k1"] == 3):
            raise AssertionError(f"fparity {arch}: counts {counts}, want {want} x 3")
        res = {"card": mg, "cpu": mc, "max_param_abs_diff": err, "worst_leaf": leaf,
               "counts": counts}
        if cfg.family == "moe":
            with _deterministic(torch) as nondet:
                finals = [[x.detach().clone() for x in tree_leaves(
                    _lm_parity_run(torch, arch, "cuda", init, batches, 3, 4)[0].params)]
                    for _ in range(2)]
            if not all(torch.equal(a, b) for a, b in zip(*finals)):
                raise AssertionError(f"fparity {arch}: two seeded card runs differ")
            res["repeat_bit_equal"] = True
            res["ops_without_deterministic_algorithm"] = nondet
        out[arch] = res
    return out


# ---------------------------------------------------------------------------
# the six federated baselines
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _k1_host_time(acc):
    """Adds to acc[0] the host's seconds inside K1's multi-tensor wrapper as
    the baselines call it (the leaf table's build, its copy, the launch)."""
    from repro_torch.core import federation

    real = federation.mtsl_update_multi_

    def timed(ps, gs, etas):
        t0 = time.perf_counter()
        try:
            return real(ps, gs, etas)
        finally:
            acc[0] += time.perf_counter() - t0

    federation.mtsl_update_multi_ = timed
    try:
        yield
    finally:
        federation.mtsl_update_multi_ = real


def _k1_wrapper_profile(torch, rf, state, batch, sched):
    """One round under torch.profiler with K1's wrapper, as the baselines
    call it, marked: the round's wall and device time, the host's time
    inside the wrapper, and the CPU operations and CUDA runtime calls that
    ran inside it, each with its calls and summed inclusive ms, the widest
    first (the profiler's own cost is in every number)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core import federation

    real = federation.mtsl_update_multi_

    def marked(ps, gs, etas):
        with record_function("k1_wrapper"):
            return real(ps, gs, etas)

    torch.cuda.synchronize()
    federation.mtsl_update_multi_ = marked
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, metrics = rf(state, batch, sched)
            float(metrics["loss"])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        federation.mtsl_update_multi_ = real
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    spans = [(e.time_range.start, e.time_range.end, e.thread) for e in events
             if e.name == "k1_wrapper" and e.device_type == cpu]  # not its GPU span
    inside = {}
    for e in events:
        if e.device_type != cpu or e.name == "k1_wrapper":
            continue
        r = e.time_range
        if any(a <= r.start and r.end <= z and e.thread == th for a, z, th in spans):
            calls, us = inside.get(e.name, (0, 0.0))
            inside[e.name] = (calls + 1, us + r.elapsed_us())
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    return state, {
        "wall_ms": wall_ms, "device_ms": device_us / 1e3,
        "device_busy_share": device_us / 1e3 / wall_ms,
        "wrapper_calls": len(spans),
        "wrapper_ms": sum(z - a for a, z, _ in spans) / 1e3,
        "inside_wrapper": [{"name": k[:60], "calls": c, "ms": us / 1e3}
                           for k, (c, us) in sorted(inside.items(),
                                                    key=lambda kv: -kv[1][1])[:14]]}


def _state_leaves(state) -> dict:
    """{path: tensor} of an algorithm's state (FedEM's is (components, pi))."""
    from repro_torch.utils.tree import tree_leaves_with_path

    if isinstance(state, tuple):
        return {**{f"components/{k}": v for k, v in tree_leaves_with_path(state[0])},
                "pi": state[1]}
    return dict(tree_leaves_with_path(state))


def _state_to(state, device):
    from repro_torch.utils.tree import tree_map

    if isinstance(state, tuple):
        return (tree_map(lambda x: x.detach().to(device).clone(), state[0]),
                state[1].detach().to(device).clone())
    return tree_map(lambda x: x.detach().to(device).clone(), state)


def baselines_phase(torch, dev):
    """Each baseline on full paper-resnet16 through the loop and the registry
    (see the module docstring), with the counts set to 0 just before each
    run and read just after."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.core import comm_cost
    from repro_torch.core.algorithms import HParams, get_algorithm
    from repro_torch.core.schedule import full_schedule
    from repro_torch.data.pipeline import client_batches
    from repro_torch.data.synthetic import MultiTaskImageSource
    from repro_torch.models.registry import build_model
    from repro_torch.optim import sgd
    from repro_torch.train.loop import TrainConfig, stage_batch, train

    c = BASELINE_RUN
    cfg = get_config(c["arch"])
    M, ls, rounds = cfg.num_clients, c["local_steps"], c["rounds"]
    model = build_model(cfg)
    tower_p, total_p = comm_cost.model_param_counts(model)
    hp = HParams(lr=c["lr"], local_steps=ls)
    held = stage_batch(_held_out_batch(cfg, M), dev)
    out = {"arch": c["arch"], "M": M, "b": c["b"], "lr": c["lr"], "local_steps": ls,
           "rounds": rounds, "tower_params": tower_p, "total_params": total_p,
           "mtsl_round_bytes_star": get_algorithm("mtsl").round_bytes(
               cfg, M, c["b"], hp, tower_params=tower_p, total_params=total_p),
           "runs": {}}
    for name in BASELINES:
        alg = get_algorithm(name)
        src = MultiTaskImageSource(num_classes=M, image_size=cfg.image_size,
                                   channels=cfg.image_channels, seed=0)
        tcfg = TrainConfig(steps=ls * rounds, algorithm=name, lr=c["lr"],
                           local_steps=ls, log_every=1, seed=0, device=dev.type)
        torch.cuda.reset_peak_memory_stats()
        host = [0.0]
        _reset_counts(torch)
        t0 = time.perf_counter()
        with _k1_host_time(host), _nonfinite_probe(torch) as probe:
            state, hist = train(model, sgd(c["lr"]),
                                client_batches(src, c["b"] * ls, seed=0), tcfg, M,
                                log=lambda _: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts(torch)
        losses = [e["loss"] for e in hist]
        if len(hist) != rounds or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"baselines {name}: losses {losses}; "
                                 + _first_nonfinite(torch, name, state, probe.rows, ls))
        steps = ls * rounds
        if not (counts["k1"] == steps and counts["k1_leaves"] == c["k1_leaves"] * steps
                and counts["k1_single"] == counts["k1_plain"] == 0):
            raise AssertionError(
                f"baselines {name}: K1 counts {counts}, want {steps} launches over "
                f"{c['k1_leaves']} leaves each, no per-leaf launch, no plain update")
        ev = alg.eval_fn(model, M)(state, held)
        times = [e["time"] for e in hist]
        if name == "fedavg":  # after the counts and the eval were read
            state, prof = _k1_wrapper_profile(
                torch, alg.round_fn(model, M, hp),
                state, stage_batch(next(iter(client_batches(src, c["b"] * ls, seed=0))),
                                   dev), full_schedule(M, ls))
            out["fedavg_k1_wrapper_profile"] = prof
            print(f"  fedavg, one round profiled: {prof}", flush=True)
            # the probe's cost, read directly: the same run unprobed
            u = BASELINE_UNPROBED_ROUNDS
            torch.cuda.synchronize()
            _, hist_u = train(model, sgd(c["lr"]),
                              client_batches(src, c["b"] * ls, seed=0),
                              dataclasses.replace(tcfg, steps=ls * u), M,
                              log=lambda _: None)
            out["fedavg_unprobed"] = {
                "rounds": u, "s_per_round": (hist_u[-1]["time"] - hist_u[0]["time"])
                / (u - 1),
                # the probed run's same rounds, its probe's host seconds out
                "probed_run_s_per_round": (times[u - 1] - times[0]
                                           - sum(probe.host_s[ls:ls * u])) / (u - 1)}
            del hist_u
        # times over the unprobed work: the probe's host seconds left out
        # (the rounds are host-bound; fedavg's unprobed run above checks it)
        probe_s, probe_s_late = sum(probe.host_s), sum(probe.host_s[ls:])
        s_round = (times[-1] - times[0] - probe_s_late) / (rounds - 1)
        wall -= probe_s
        res = {"losses": losses, "s_per_round": s_round,
               "s_per_round_probed": (times[-1] - times[0]) / (rounds - 1),
               "probe_host_s": probe_s,
               "first_round_s": times[0] - sum(probe.host_s[:ls]),
               "grad_steps_per_s": ls / s_round,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
               "k1_launches": counts["k1"], "k1_leaves_updated": counts["k1_leaves"],
               "k1_host_s": host[0], "k1_host_share": host[0] / wall,
               "acc_mtl_held_out": float(ev["acc_mtl"]),
               "round_bytes_star": alg.round_bytes(cfg, M, c["b"], hp,
                                                   tower_params=tower_p,
                                                   total_params=total_p),
               "phase_s": wall}
        out["runs"][name] = res
        print(f"  {name}: {s_round * 1e3:.1f} ms per round ({ls / s_round:.1f} steps/s), "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, acc_mtl "
              f"{res['acc_mtl_held_out']:.3f}, K1 {counts['k1']} launches "
              f"(host {res['k1_host_share']:.3f} of the wall), "
              f"{res['round_bytes_star']} bytes per round", flush=True)
        del state, ev
        torch.cuda.empty_cache()
    return out


def _update_leaf_names(state) -> list:
    """Names of the leaves a baseline's local step updates, in its update
    list's order: the towers', then the server's (or the servers' /
    FedEM's components')."""
    from repro_torch.utils.tree import tree_leaves_with_path

    if isinstance(state, tuple):  # fedem: (components, pi)
        return [f"components/{p}" for p, _ in tree_leaves_with_path(state[0])]
    return [f"{key}/{p}" for key in ("towers", "server", "servers") if key in state
            for p, _ in tree_leaves_with_path(state[key])]


class _Probe(NamedTuple):
    rows: list  # per local step, a [2, leaves] device tensor
    host_s: list  # per local step, the host's seconds in the probe's own calls


@contextlib.contextmanager
def _nonfinite_probe(torch):
    """Yields a _Probe whose rows get, for every local step a baseline
    takes, the largest |value| of each leaf's update input (its gradient;
    SMoFi's server takes its fused momentum) before K1 and of each
    parameter after, as one [2, leaves] device tensor (`_foreach_norm` with
    ord=inf: a few launches a step, no wait for the card). A non-finite
    entry marks a non-finite tensor. host_s gets the host's seconds in
    those calls, so a timing can leave them out."""
    from repro_torch.core import federation

    real, inf = federation._sgd_step, float("inf")
    probe = _Probe([], [])

    def probed(ps, gs, etas):
        t0 = time.perf_counter()
        g = torch.stack(torch._foreach_norm(list(gs), inf))
        t1 = time.perf_counter()
        real(ps, gs, etas)
        t2 = time.perf_counter()
        probe.rows.append(
            torch.stack([g, torch.stack(torch._foreach_norm(list(ps), inf))]))
        probe.host_s.append(t1 - t0 + time.perf_counter() - t2)

    federation._sgd_step = probed
    try:
        yield probe
    finally:
        federation._sgd_step = real


def _first_nonfinite(torch, name, state, rows, local_steps: int) -> str:
    """The first non-finite tensor of a baseline's run from its probe rows
    (`_nonfinite_probe`): the algorithm, the round, the local step, and the
    gradient or parameter leaf."""
    if not rows:
        return "no local step ran"
    bad = ~torch.isfinite(torch.stack(rows).cpu())  # [steps, 2, leaves]
    names = _update_leaf_names(state)
    for step, kind, leaf in bad.nonzero().tolist():
        r, t = divmod(step, local_steps)
        what = names[leaf] if len(names) == bad.shape[2] else f"leaf #{leaf}"
        return (f"first non-finite tensor: {name}, round {r + 1}, local step "
                f"{t + 1}, the {('gradient', 'parameter')[kind]} of {what}")
    return "every gradient and parameter stayed finite (the loss overflowed first)"


def _baseline_card_vs_cpu(torch, name, model, M, hp, init, stream,
                          want_counts=None, keep=None):
    """Rounds of `name` on the card and on the CPU from `init` and one
    stream of (numpy batch, schedule). Returns per round the losses and the
    largest parameter gap, the final state's five widest leaf gaps with
    each leaf's scale (max |CPU value|), the card's counts, and a list of
    failures: a loss more than 1e-5 relative apart, a parameter leaf more
    than 1e-4 apart (the cluster map at all), a gradient sum
    (GRADIENT_SUM_LEAVES) more than GRAD_GAP_F32 of its scale apart, or the
    card's K1 (and, with want_counts, K2 / K3) counts off. With `keep` (a
    list), appends copies of the card's and the CPU's state after each
    round."""
    from repro_torch.core.algorithms import get_algorithm
    from repro_torch.train.loop import stage_batch

    alg = get_algorithm(name)
    rf_cpu, rf_gpu = alg.round_fn(model, M, hp), alg.round_fn(model, M, hp)
    cpu, gpu = _state_to(init, "cpu"), _state_to(init, "cuda")
    per_round, gpu_counts, failures = [], {}, []
    for r, (batch, sched) in enumerate(stream):
        _reset_counts(torch)
        with _deterministic(torch) as nondet:
            gpu, mg = rf_gpu(gpu, stage_batch(batch, "cuda"), sched)
            torch.cuda.synchronize()
        if nondet:
            failures.append(f"round {r + 1}: card ops without a deterministic "
                            f"algorithm: {nondet}")
        for k, v in _read_counts(torch).items():
            gpu_counts[k] = gpu_counts.get(k, 0) + v
        cpu, mc = rf_cpu(cpu, stage_batch(batch, "cpu"), sched)
        if keep is not None:
            keep.append((_state_to(gpu, "cuda"), _state_to(cpu, "cpu")))
        lg, lc = float(mg["loss"]), float(mc["loss"])
        if not abs(lg - lc) <= 1e-5 * abs(lc):
            failures.append(f"round {r + 1}: card loss {lg} vs CPU {lc}")
        cpu_leaves = _state_leaves(cpu)
        gaps = sorted(((a.detach().cpu().double() - cpu_leaves[k].double())
                       .abs().max().item(), k, cpu_leaves[k].double().abs().max().item())
                      for k, a in _state_leaves(gpu).items())[::-1]
        params = [g for g in gaps if not g[1].startswith(GRADIENT_SUM_LEAVES)]
        sums = [g for g in gaps if g[1].startswith(GRADIENT_SUM_LEAVES)]
        per_round.append({
            "card_loss": lg, "cpu_loss": lc, "participants": sched.num_participants,
            "max_param_abs_diff": params[0][0], "worst_leaf": params[0][1],
            **({"max_gradient_sum_rel_diff": max(g / (sc or 1.0) for g, _, sc in sums)}
               if sums else {})})
    rounds, ls = len(per_round), hp.local_steps
    err, leaf = max((r["max_param_abs_diff"], r["worst_leaf"]) for r in per_round)
    if not err <= 1e-4:
        failures.append(f"leaves differ by {err} at {leaf}")
    sum_rel = max(r.get("max_gradient_sum_rel_diff", 0.0) for r in per_round)
    if not sum_rel <= GRAD_GAP_F32:
        failures.append(f"a gradient sum differs by {sum_rel} of its scale")
    if "cidx" in cpu_leaves and not torch.equal(_state_leaves(gpu)["cidx"].cpu(),
                                                cpu_leaves["cidx"]):
        failures.append("cluster maps differ")
    want = {"k1": rounds * ls, "k1_single": 0, "k1_plain": 0,
            "k2_plain": 0, "k3_plain": 0, **(want_counts or {})}
    if any(gpu_counts[k] != v for k, v in want.items()):
        failures.append(f"card counts {gpu_counts}, want {want}")
    return {"rounds": per_round, "max_param_abs_diff": err, "worst_leaf": leaf,
            "max_gradient_sum_rel_diff": sum_rel,
            "widest_gaps": [{"leaf": k, "abs": g, "scale": sc, "rel": g / (sc or 1.0)}
                            for g, k, sc in gaps[:5]],
            "card_counts": gpu_counts, "failures": failures}


def _baseline_gradient_gap(torch, model, init, batch, b: int):
    """Round 1's first local step (the first `b` samples of each client's
    row) of the per-client full models (fedavg's layout): gradients on the
    card and on the CPU from one state and batch,
    in f32 and in f64: per leaf max |card - CPU| / max |CPU|, the worst
    leaf of each. The f64 pair agreeing to rounding is the witness that
    both compute one function."""
    from repro_torch.core.federation import _client_value_and_grad
    from repro_torch.train.loop import stage_batch
    from repro_torch.utils.tree import tree_leaves_with_path, tree_map

    vg = _client_value_and_grad(model)
    pcs = {"tower": init["towers"], "server": init["servers"]}
    grads = {}
    for where in ("cpu", "cuda"):
        for dt in (torch.float64, torch.float32):
            p = tree_map(lambda x: x.detach().to(where, dt), pcs)
            mb = {k: (v.to(dt) if v.is_floating_point() else v)[:, :b].contiguous()
                  for k, v in stage_batch(batch, where).items()}
            _, g = vg(p, mb)
            grads[where, dt] = {k: v.detach().cpu().double()
                                for k, v in tree_leaves_with_path(g)}

    def gap(dt):
        return max((float((grads["cuda", dt][k] - ref).abs().max())
                    / (float(ref.abs().max()) or 1.0), k)
                   for k, ref in grads["cpu", dt].items())

    f64, f32 = gap(torch.float64), gap(torch.float32)
    return {"card_vs_cpu_f64": {"rel": f64[0], "leaf": f64[1]},
            "card_vs_cpu_f32": {"rel": f32[0], "leaf": f32[1]}}


def _plain_f64_update(ps, gs, etas):
    """p <- p - eta·g per leaf and row in f64, uncounted: the f64 witness's
    stand-in for K1, which takes f32 and bf16 only."""
    for p, g, eta in zip(ps, gs, etas, strict=True):
        R = eta.numel()
        p.view(R, -1).sub_(eta.to(p.dtype).reshape(R, 1) * g.reshape(R, -1))
    return ps


def _smofi_f64_witness(torch, model, M, b, hp, init, stream, kept):
    """SMoFi's bparity rounds again in f64, on the card and on the CPU,
    from the same initial state and batches, each stepping through
    `_plain_f64_update` in place of K1 (the k1 phase holds K1 bit-equal
    to its plain version). If the card and the CPU compute one function,
    every leaf of the two f64 states, smom included, agrees within
    GRAD_GAP_F64 of its scale. `kept` holds the card's and the CPU's f32
    states after each round of `_baseline_card_vs_cpu`: reports per side
    how far the final f32 state lies from that side's f64 state, leaf by
    leaf for smom (the f32 rounding each side adds), and the ReLU inputs
    of round 3's first step (towers, then the shared server) whose sign
    under the side's f32 state after round 2 differs between f32 and f64
    arithmetic on that side."""
    from repro_torch.core import federation
    from repro_torch.core.algorithms import get_algorithm
    from repro_torch.train.loop import stage_batch
    from repro_torch.utils.tree import tree_map

    f64 = torch.float64
    alg = get_algorithm("smofi")
    finals = {}
    real = federation.mtsl_update_multi_
    federation.mtsl_update_multi_ = _plain_f64_update
    try:
        for where in ("cuda", "cpu"):
            rf = alg.round_fn(model, M, hp)
            st = tree_map(lambda x: x.detach().to(where, f64).clone(), init)
            for batch, sched in stream:
                staged = {k: v.to(f64) if v.is_floating_point() else v
                          for k, v in stage_batch(batch, where).items()}
                st, _ = rf(st, staged, sched)
            finals[where] = {k: v.detach().cpu() for k, v in _state_leaves(st).items()}
    finally:
        federation.mtsl_update_multi_ = real

    def rel(a, b):  # max |a - b| / max |b|, per leaf
        return {k: float((a[k].double() - ref).abs().max()) / (float(ref.abs().max()) or 1.0)
                for k, ref in b.items()}

    card64 = rel(finals["cuda"], finals["cpu"])
    worst = max(card64, key=card64.get)
    res = {"card_vs_cpu_f64": {"rel": card64[worst], "leaf": worst,
                               "smom_rel": max(v for k, v in card64.items()
                                               if k.startswith("smom/"))}}
    for side, i, where in (("card", 0, "cuda"), ("cpu", 1, "cpu")):
        f32 = {k: v.detach().cpu() for k, v in _state_leaves(kept[-1][i]).items()}
        gaps = rel(f32, finals[where])
        res[f"{side}_f32_vs_f64"] = {
            "smom_rel": max(v for k, v in gaps.items() if k.startswith("smom/")),
            "params_rel": max(v for k, v in gaps.items() if not k.startswith("smom/")),
            "smom_by_leaf": {k: v for k, v in gaps.items() if k.startswith("smom/")}}
        st = kept[1][i]
        image = stage_batch(stream[2][0], where)["image"][:, :b]
        with torch.no_grad():
            truth = _relu_flips(torch, model, tree_map(lambda x: x.to(f64), st["towers"]),
                                image.to(f64),
                                server=tree_map(lambda x: x.to(f64), st["server"]))
            flips = _relu_flips(torch, model, st["towers"], image, truth,
                                server=st["server"])
        res[f"{side}_relu_flips_f32_vs_f64"] = flips
    return res


def baselines_parity_phase(torch):
    """Card against CPU for the six baselines, then seeded repeatability
    (see the module docstring)."""
    import itertools

    from repro_torch.configs import get_config
    from repro_torch.core.algorithms import HParams, get_algorithm
    from repro_torch.core.schedule import (ScheduleConfig, capability_profile,
                                           schedule_stream)
    from repro_torch.data.lm import MultiTaskLMSource
    from repro_torch.data.pipeline import client_batches
    from repro_torch.data.synthetic import MultiTaskImageSource
    from repro_torch.models.registry import build_model
    from repro_torch.optim import sgd
    from repro_torch.train.loop import TrainConfig, train
    from repro_torch.utils.device import generator

    ls, rounds = 2, 3
    out = {"classifier": {}, "lm": {}}
    cfg = get_config("paper-resnet16")
    M, b = cfg.num_clients, 8
    model = build_model(cfg)
    scfg = ScheduleConfig(participation_rate=0.5, straggler_frac=0.5, seed=3)
    hp = HParams(lr=0.01, local_steps=ls,
                 capability=tuple(capability_profile(M, scfg)))
    src = MultiTaskImageSource(num_classes=M, image_size=cfg.image_size,
                               channels=cfg.image_channels, seed=3)
    batches = list(client_batches(src, b * ls, steps=rounds, seed=3))
    scheds = list(itertools.islice(schedule_stream(scfg, M, ls), rounds))
    failures = []
    for name in BASELINES:
        init = get_algorithm(name).init_state(model, generator("cpu", 3), M, hp)
        if name == "fedavg":
            out["round1_grad_gap"] = _baseline_gradient_gap(torch, model, init,
                                                            batches[0], b)
            print(f"  round-1 gradients, card vs CPU: {out['round1_grad_gap']}",
                  flush=True)
        kept = [] if name == "smofi" else None
        res = _baseline_card_vs_cpu(torch, name, model, M, hp, init,
                                    list(zip(batches, scheds)), keep=kept)
        if name == "smofi":
            out["smofi_f64_witness"] = wit = _smofi_f64_witness(
                torch, model, M, b, hp, init, list(zip(batches, scheds)), kept)
            del kept
            print(f"  smofi f64 witness: {wit}", flush=True)
            if not wit["card_vs_cpu_f64"]["rel"] <= GRAD_GAP_F64:
                failures.append(f"smofi f64 state, card vs CPU: {wit['card_vs_cpu_f64']}")
        out["classifier"][name] = res
        failures += [f"resnet16 {name}: {f}" for f in res["failures"]]
        print(f"  resnet16 {name}: card vs CPU within {res['max_param_abs_diff']:.3g} "
              f"({res['worst_leaf']}); widest {res['widest_gaps'][:3]}", flush=True)
    for arch in ("zamba2-7b", "mamba2-130m"):
        cfg = get_config(arch, smoke=True)
        M = cfg.num_clients
        model = build_model(cfg)
        hp = HParams(lr=0.05, local_steps=ls)
        src = MultiTaskLMSource(vocab_size=cfg.vocab_size, num_clients=M, beta=0.5,
                                seed=4)
        batches = list(client_batches(src, 4 * ls, steps=rounds, seed=4, seq_len=64))
        scheds = list(itertools.islice(schedule_stream(
            ScheduleConfig(participation_rate=0.5, seed=4), M, ls), rounds))
        for name in ("splitfed", "fedavg"):
            init = get_algorithm(name).init_state(model, generator("cpu", 4), M, hp)
            per = _lm_launches_per_round(cfg, M, local_steps=ls,
                                         full_models=name == "fedavg")
            res = _baseline_card_vs_cpu(
                torch, name, model, M, hp, init, list(zip(batches, scheds)),
                want_counts={k: rounds * v for k, v in per.items()})
            out["lm"][f"{arch}/{name}"] = res
            failures += [f"{arch} {name}: {f}" for f in res["failures"]]
            print(f"  {arch} {name}: card vs CPU within "
                  f"{res['max_param_abs_diff']:.3g} ({res['worst_leaf']})", flush=True)

    cfg = get_config("paper-resnet16")
    M, b = cfg.num_clients, 8
    model = build_model(cfg)
    src = MultiTaskImageSource(num_classes=M, image_size=cfg.image_size,
                               channels=cfg.image_channels, seed=5)
    tcfg = TrainConfig(steps=20, algorithm="fedavg", lr=0.1, local_steps=2, seed=5,
                       schedule=ScheduleConfig(participation_rate=0.5, seed=5),
                       device="cuda")
    torch.use_deterministic_algorithms(True)
    try:
        finals = []
        for _ in range(2):
            state, _ = train(model, sgd(0.1), client_batches(src, b * 2, seed=5),
                             tcfg, M, log=lambda _: None)
            finals.append([x.detach().clone() for x in _state_leaves(state).values()])
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(torch.equal(a, c) for a, c in zip(*finals))
    out["repeat"] = {"algorithm": "fedavg", "rounds": 10, "bit_equal": same}
    if not same:
        failures.append("two seeded 10-round fedavg card runs differ")
    grad = out["round1_grad_gap"]
    if not (grad["card_vs_cpu_f64"]["rel"] <= GRAD_GAP_F64
            and grad["card_vs_cpu_f32"]["rel"] <= GRAD_GAP_F32):
        failures.append(f"round-1 gradients, card vs CPU: {grad}")
    if failures:
        print("BPARITY " + json.dumps(out), flush=True)
        raise AssertionError("bparity: " + "; ".join(failures))
    return out


def lm_baselines_phase(torch, dev):
    """splitfed and fedavg on mamba2-130m's full config through the loop
    (see the module docstring), with the counts set to 0 just before each
    run and read just after."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.data.lm import MultiTaskLMSource
    from repro_torch.data.pipeline import client_batches
    from repro_torch.models.registry import build_model
    from repro_torch.optim import sgd
    from repro_torch.train.loop import TrainConfig, train

    c = LM_BASELINES
    cfg = get_config(c["arch"])
    M, ls, rounds = c["M"], c["local_steps"], c["rounds"]
    model = build_model(cfg)
    src = MultiTaskLMSource(vocab_size=c["data_vocab"], num_clients=M, beta=1.0, seed=0)
    out = {"arch": c["arch"], "M": M, "b": c["b"], "S": c["S"], "lr": c["lr"],
           "local_steps": ls, "rounds": rounds, "runs": {}}
    for name in ("splitfed", "fedavg"):
        tcfg = TrainConfig(steps=ls * rounds, algorithm=name, lr=c["lr"],
                           local_steps=ls, log_every=1, seed=0, device=dev.type)
        torch.cuda.reset_peak_memory_stats()
        _reset_counts(torch)
        t0 = time.perf_counter()
        state, hist = train(model, sgd(c["lr"]),
                            client_batches(src, c["b"] * ls, seed=0, seq_len=c["S"]),
                            tcfg, M, log=lambda _: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts(torch)
        losses = [e["loss"] for e in hist]
        if len(hist) != rounds or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"lm-baselines {name}: losses {losses}")
        want = _lm_launches_per_round(cfg, M, local_steps=ls,
                                      full_models=name == "fedavg")
        if not (counts["k3"] == counts["k3_tc"] == want["k3"] * rounds
                and counts["k2"] == want["k2"] * rounds
                and counts["k2_plain"] == counts["k3_plain"] == 0
                and counts["k1"] == ls * rounds
                and counts["k1_single"] == counts["k1_plain"] == 0):
            raise AssertionError(
                f"lm-baselines {name}: counts {counts}, want per round {want} (K3 "
                f"all on the tensor cores), K1 {ls * rounds} launches, no plain "
                f"forward or update")
        times = [e["time"] for e in hist]
        res = {"losses": losses, "first_round_s": times[0],
               "s_per_round": (times[-1] - times[0]) / (rounds - 1),
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
               "counts": counts, "launches_per_round": want, "phase_s": wall}
        out["runs"][name] = res
        print(f"  {name}: {res['s_per_round']:.3f} s per round, loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}, peak "
              f"{res['peak_mem_gib']:.2f} GiB, K3 {counts['k3']}", flush=True)
        del state
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# serving of the SSM and hybrid LMs, and checkpoints
# ---------------------------------------------------------------------------


_SELF_ATTN_KINDS = ("full", "swa", "dense_moe_lead", "moe", "cross",
                    "shared_attn")


def _serving_kinds(cfg) -> dict:
    """Per side, from the stacks' block kinds: the layers that scan
    (mamba, shared_attn: one K3 launch per extend or prefill), the
    self-attentions (one K4 launch per decode), the cross layers (one K2
    launch per prefill, one K4 per decode) and the encoder layers (bidir:
    one K2 launch per prefill)."""
    from repro_torch.models.registry import stack_kinds

    out = {}
    for (side, _), kinds in stack_kinds(cfg).items():
        got = out.setdefault(side, {"scan": 0, "attn": 0, "cross": 0, "bidir": 0})
        got["scan"] += sum(k in ("mamba", "shared_attn") for k in kinds)
        got["attn"] += sum(k in _SELF_ATTN_KINDS for k in kinds)
        got["cross"] += sum(k == "cross" for k in kinds)
        got["bidir"] += sum(k == "bidir" for k in kinds)
    return out


def _check_tokens(outs, n: int, new_tokens: int, vocab: int, what: str):
    if len(outs) != n:
        raise AssertionError(f"{what}: {len(outs)} requests returned, want {n}")
    for i, o in enumerate(outs):
        if o.shape != (new_tokens,) or o.min() < 0 or o.max() >= vocab:
            raise AssertionError(f"{what}: request {i}: bad tokens {o}")


def serve_phase(torch, key):
    """ssm-serve / hybrid-serve / moe-serve (see the module docstring): the
    launcher's continuous engine at full width and depth, K3 counted per
    extend chunk and K4 per decode step, the MoE's dropped rows tallied;
    ssm-serve and moe-serve then run the sequential engine on the same
    prompts, K3 counted per prefill and K4 per decode step."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.moe import moe_forward

    c, t = SERVE_RUNS[key], SERVE_TRAFFIC
    M, n = c["M"], t["requests"]
    cfg = get_config(c["arch"])
    kinds = _serving_kinds(cfg)
    argv = ["--arch", c["arch"], "--no-smoke", "--device", "cuda",
            "--num-clients", str(M), "--batch-per-client", str(n // M),
            "--slots", str(t["slots"]), "--chunk", str(t["chunk"]),
            "--prompt-len", str(t["prompt_len"]),
            "--min-prompt-len", str(t["min_prompt_len"]),
            "--new-tokens", str(t["new_tokens"]), "--engine", "continuous",
            "--bench", "--seed", "0"] + (["--profile"] if c["profile"] else [])
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(torch)
    # set before the engine captures its steps: the graphs add to it
    moe_forward.tally = (torch.zeros(2, dtype=torch.int64, device="cuda")
                         if cfg.family == "moe" else None)
    try:
        t0 = time.perf_counter()
        m = serve.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _REPLAYED[key] = m
        tally = moe_forward.tally
    finally:
        moe_forward.tally = None
    got = _read_counts(torch)
    _check_tokens(m["outputs"], n, t["new_tokens"], cfg.vocab_size, key)
    if not m["logits_finite"]:
        raise AssertionError(f"{key}: non-finite logits")
    extends, steps = m["stats"]["extend_steps"], m["stats"]["decode_steps"]
    # an extend runs one client's tower and the server; a decode step runs
    # every client's tower over all slots, then the server
    k3_per_chunk = kinds["tower"]["scan"] + kinds["server"]["scan"]
    k4_per_step = M * kinds["tower"]["attn"] + kinds["server"]["attn"]
    if not (got["k3"] == got["k3_tc"] == k3_per_chunk * extends
            and (got["k3"] > 0) == (k3_per_chunk > 0) and got["k3_plain"] == 0):
        raise AssertionError(f"{key}: counts {got}, want {k3_per_chunk} K3 launches "
                             f"per extend chunk x {extends}, all on the tensor cores")
    if not (got["k4"] == got["attn_decode"] == k4_per_step * steps
            and got["k4_plain"] == 0 and got["k4_ring"] == got["k4_cross"] == 0):
        raise AssertionError(f"{key}: counts {got}, want {k4_per_step} K4 launches "
                             f"per decode step x {steps}")
    _check_captures(m, M + 1, key)
    res = {"arch": c["arch"], "M": M, "prefill_ms": m["prefill_ms"],
           "decode_tok_s": m["decode_tok_s"], "tok_s_per_slot": m["tok_s_per_slot"],
           **_graph_stats(m),
           "slots": m["slots"], "extend_steps": extends, "decode_steps": steps,
           "counts": got, "k3_launches_per_extend_chunk": k3_per_chunk,
           "k4_launches_per_decode_step": k4_per_step, "profile": m.get("profile"),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "continuous_s": wall}
    if tally is not None:
        kept, routed = tally.tolist()
        res.update(moe_rows_kept=kept, moe_rows_routed=routed,
                   dropped_share=1.0 - kept / routed)
    if c["sequential"]:
        res["sequential"] = _sequential_serve(torch, cfg, M, m["outputs"], kinds)
    res["phase_s"] = time.perf_counter() - t0
    return res


def _sequential_serve(torch, cfg, M: int, outs, kinds) -> dict:
    """The same requests through generate_sequential, each alone in its
    client's row: K3 once per scanning layer of every client's tower and
    of the server per prefill, K4 once per self-attention of every
    client's tower and of the server per decode step. Reports how many requests' tokens equal the
    continuous engine's and how many leading tokens each shares with it
    (bf16: chunked and whole-prompt scans, and GEMMs over 1 or 4 rows,
    round apart, so a near tie may flip; sparity holds the parity in
    f32)."""
    import numpy as np

    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine

    t = SERVE_TRAFFIC
    model = build_model(cfg)
    params = serve.init_params(model, M, 0, "cuda")  # the launcher's seed
    prompts = serve._prompts(cfg, t["requests"], t["prompt_len"],
                             t["min_prompt_len"], 0)
    eng = ServeEngine(model, params, M, t["prompt_len"] + t["new_tokens"],
                      device="cuda")
    _reset_counts(torch)
    t0 = time.perf_counter()
    seq = []
    for i, p in enumerate(prompts):
        toks = np.zeros((M, 1, len(p)), np.int64)
        toks[i % M, 0] = p
        seq.append(eng.generate_sequential({"tokens": toks}, t["new_tokens"])[
            i % M, 0].numpy())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _read_counts(torch)
    _check_tokens(seq, len(prompts), t["new_tokens"], cfg.vocab_size, "sequential")
    per_prefill = M * kinds["tower"]["scan"] + kinds["server"]["scan"]
    if not (got["k3"] == got["k3_tc"] == per_prefill * len(prompts)
            and got["k3_plain"] == 0):
        raise AssertionError(f"sequential: counts {got}, want {per_prefill} K3 "
                             f"launches per prefill x {len(prompts)}")
    per_step = M * kinds["tower"]["attn"] + kinds["server"]["attn"]
    steps = len(prompts) * (t["new_tokens"] - 1)
    if not (got["k4"] == got["attn_decode"] == per_step * steps
            and got["k4_plain"] == 0):
        raise AssertionError(f"sequential: counts {got}, want {per_step} K4 "
                             f"launches per decode step x {steps}")
    lead = [_lead(a, b) for a, b in zip(seq, outs)]
    return {"prefills": len(prompts), "k3_launches_per_prefill": per_prefill,
            "counts": got, "s": wall,
            "requests_equal_to_continuous": sum(n == t["new_tokens"] for n in lead),
            "leading_tokens_equal_to_continuous": lead}


def serve_parity_phase(torch):
    """sparity (see the module docstring): continuous == sequential on the
    card, token for token, in f32; the card's prefill logits against the
    CPU's."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import init_params
    from repro_torch.models import build_model
    from repro_torch.serve.continuous import ContinuousEngine, Request
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.utils.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lens, new, max_len, M = [5, 70, 130, 17], [8, 6, 8, 7], 160, 2
    out = {}
    for arch, cut in SPARITY_ARCHS.items():
        t0 = time.perf_counter()
        cfg = get_config(arch).with_updates(dtype="float32", **cut)
        model = build_model(cfg)
        kinds = _serving_kinds(cfg)
        params = init_params(model, M, 1, "cuda")
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab_size, size=L) for L in lens]
        _reset_counts(torch)
        eng = ContinuousEngine(model, params, M, max_len, slots=2,
                               chunk=SERVE_TRAFFIC["chunk"], device="cuda")
        for i, (p, n) in enumerate(zip(prompts, new)):
            eng.submit(Request(id=i, client=i % M, tokens=p, new_tokens=n))
        res = eng.run()
        seq = ServeEngine(model, params, M, max_len, device="cuda")
        rows = []
        for i, (p, n) in enumerate(zip(prompts, new)):
            toks = np.zeros((M, 1, len(p)), np.int64)
            toks[i % M, 0] = p
            ref = seq.generate_sequential({"tokens": toks}, n)[i % M, 0].numpy()
            if not (res[i] == ref).all():
                raise AssertionError(f"sparity {arch} request {i}: continuous "
                                     f"{res[i]} != sequential {ref}")
            rows.append(toks)
        got = _read_counts(torch)
        if not (got["k3"] > 0 and got["k3_plain"] == 0 and got["k4_plain"] == 0
                and got["k4"] == got["attn_decode"]
                and (got["k4"] > 0) == (kinds["server"]["attn"] > 0)):
            raise AssertionError(f"sparity {arch}: counts {got}")
        # the card's prefill logits against the CPU's (plain versions)
        cpu_params = tree_map(lambda x: x.cpu(), params)
        cpu = ServeEngine(model, cpu_params, M, max_len, device="cpu")
        worst = 0.0
        with torch.no_grad():
            for toks in rows:
                tt = torch.as_tensor(toks)
                lg, _ = seq._prefill(params, {"tokens": tt.cuda()})
                lc, _ = cpu._prefill(cpu_params, {"tokens": tt})
                err = ((lg.cpu() - lc).abs().max() / max(1.0, lc.abs().max().item())).item()
                worst = max(worst, err)
        if not worst <= SPARITY_LOGITS_TOL:
            raise AssertionError(f"sparity {arch}: card vs CPU prefill logits "
                                 f"{worst} > {SPARITY_LOGITS_TOL} of their scale")
        out[arch] = {"layers": cfg.num_layers, "split": cfg.split_layers,
                     "requests": len(prompts), "tokens": int(sum(new)),
                     "counts": got, "prefill_logits_rel_err": worst,
                     "s": time.perf_counter() - t0}
        del params, cpu_params, eng, seq, cpu
        torch.cuda.empty_cache()
    return out


def _lead(a, b) -> int:
    """Leading tokens two greedy streams share."""
    import numpy as np

    return int(np.argmax(np.append(np.asarray(a) != np.asarray(b), True)))


def seq_serve_phase(torch, key):
    """vlm-serve / encdec-serve (see the module docstring): the launcher's
    sequential engine at full width and depth, K2 counted per prefill (per
    mode) and K4 per decode step (per mode)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    c = SEQ_SERVE_RUNS[key]
    M, b, n = c["M"], c["b"], c["new_tokens"]
    cfg = get_config(c["arch"])
    kinds = _serving_kinds(cfg)
    argv = ["--arch", c["arch"], "--no-smoke", "--device", "cuda",
            "--num-clients", str(M), "--batch-per-client", str(b),
            "--prompt-len", str(c["prompt_len"]), "--new-tokens", str(n),
            "--engine", "sequential", "--bench", "--seed", "0"]
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(torch)
    t0 = time.perf_counter()
    m = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _REPLAYED[key] = m
    got = _read_counts(torch)
    _check_tokens(m["outputs"], M * b, n, cfg.vocab_size, key)
    # the bench's warm-up generation and its timed pass: two prefills and
    # 2 (n - 1) decode steps
    prefills, steps = 2, 2 * (n - 1)
    tw, sv = kinds["tower"], kinds["server"]
    want = {"k2_cross": (M * tw["cross"] + sv["cross"]) * prefills,
            "k2_bidir": (M * tw["bidir"] + sv["bidir"]) * prefills,
            "k4_cross": (M * tw["cross"] + sv["cross"]) * steps,
            "k4": (M * (tw["attn"] + tw["cross"]) + sv["attn"] + sv["cross"]) * steps}
    want["k2"] = want["k2_cross"] + want["k2_bidir"]  # self-attention prefill: plain
    if not (all(got[k] == v for k, v in want.items()) and got["k2_cross"] > 0
            and got["attn_decode"] == got["k4"] and got["k4_plain"] == 0
            and got["k4_ring"] == 0):
        raise AssertionError(f"{key}: counts {got}, want {want} (two prefills, "
                             f"{steps} decode steps)")
    _check_captures(m, 1, key)  # one batch shape: the two passes share a graph
    return {"arch": c["arch"], "M": M, "b": b, "prompt_len": c["prompt_len"],
            "new_tokens": n, "prefill_ms": m["prefill_ms"], **_graph_stats(m),
            "decode_tok_s": m["decode_tok_s"], "tok_s_per_slot": m["tok_s_per_slot"],
            "ms_per_decode_step": M * b / m["decode_tok_s"] * 1e3,
            "counts": got, "want": want,
            "k4_launches_per_decode_step": want["k4"] // steps,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "phase_s": wall}


def _attn_caps(caches) -> set:
    """The capacities of every KV cache leaf in a ServeCaches."""
    from repro_torch.utils.tree import tree_leaves_with_path

    return {x.shape[1] for k, x in tree_leaves_with_path(
        {"tower": caches.tower, "server": caches.server})
        if k.endswith(("/k", "/v"))}


def swa_serve_phase(torch):
    """swa-serve (see the module docstring): ring caches at full width and
    depth through the launcher's sequential engine, then both prompt
    lengths on ring and full-capacity caches."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine, stage_inputs

    c = SWA_SERVE
    M, b, n = c["M"], c["b"], c["new_tokens"]
    cfg = get_config(c["arch"])
    window = cfg.sliding_window
    per_step = sum(M * v["attn"] if side == "tower" else v["attn"]
                   for side, v in _serving_kinds(cfg).items())
    L0, L1 = c["prompt_lens"]
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(torch)
    t0 = time.perf_counter()
    m = serve.main(["--arch", c["arch"], "--no-smoke", "--device", "cuda",
                    "--num-clients", str(M), "--batch-per-client", str(b),
                    "--prompt-len", str(L0), "--new-tokens", str(n),
                    "--engine", "sequential", "--bench", "--seed", "0"])
    torch.cuda.synchronize()
    bench_s = time.perf_counter() - t0
    _REPLAYED["swa-serve"] = m
    got = _read_counts(torch)
    _check_tokens(m["outputs"], M * b, n, cfg.vocab_size, "swa-serve")
    steps = 2 * (n - 1)
    if not (got["k4"] == got["k4_ring"] == got["attn_decode"] == per_step * steps
            and got["k4_plain"] == 0):
        raise AssertionError(f"swa-serve: counts {got}, want {per_step} ring "
                             f"launches per decode step x {steps}")
    _check_captures(m, 1, "swa-serve")
    res = {"arch": c["arch"], "M": M, "b": b, "window": window,
           "bench": {"prompt_len": L0, "new_tokens": n, **_graph_stats(m),
                     "prefill_ms": m["prefill_ms"], "decode_tok_s": m["decode_tok_s"],
                     "ms_per_decode_step": M * b / m["decode_tok_s"] * 1e3,
                     "counts": got, "s": bench_s},
           "k4_launches_per_decode_step": per_step}

    # both lengths on the ring and on full-capacity caches, the launcher's
    # weights (seed 0) and inputs; the bench's generation is L0's ring run
    model = build_model(cfg)
    model_full = build_model(cfg.with_updates(decode_long_window=0))
    params = serve.init_params(model, M, 0, "cuda")
    for L in (L0, L1):
        inputs = stage_inputs(serve.seeded_inputs(cfg, M, b, L, 0), "cuda")
        out = {}
        if L == L0:
            out["ring"] = {"tokens": np.stack(m["outputs"]), "counts": got,
                           "s": bench_s}
        for name, mod in (("ring", model), ("full", model_full)):
            if name in out:
                continue
            eng = ServeEngine(mod, params, M, L + n, device="cuda")
            with torch.no_grad():
                caps = _attn_caps(eng._prefill(params, inputs)[1])
            want_cap = {window} if name == "ring" else {L + n}
            if caps != want_cap:
                raise AssertionError(f"swa-serve {name} L={L}: cache caps {caps}, "
                                     f"want {want_cap}")
            _reset_counts(torch)
            t1 = time.perf_counter()
            toks = eng.generate_sequential(inputs, n)
            torch.cuda.synchronize()
            got = _read_counts(torch)
            ring = got["k4_ring"] if name == "ring" else 0
            if not (got["k4"] == got["attn_decode"] == per_step * (n - 1)
                    and got["k4_ring"] == ring and got["k4_plain"] == 0):
                raise AssertionError(f"swa-serve {name} L={L}: counts {got}")
            if name == "ring" and ring != got["k4"]:
                raise AssertionError(f"swa-serve ring L={L}: a decode off the ring: {got}")
            _check_tokens(list(toks.reshape(M * b, n).numpy()), M * b, n,
                          cfg.vocab_size, f"swa-serve {name} L={L}")
            out[name] = {"tokens": toks.reshape(M * b, n).numpy(), "counts": got,
                         "s": time.perf_counter() - t1}
        res[f"prompt_{L}"] = {
            "ring_counts": out["ring"]["counts"], "full_counts": out["full"]["counts"],
            "ring_s": out["ring"]["s"], "full_s": out["full"]["s"],
            "leading_tokens_equal_ring_vs_full": [
                _lead(a, f) for a, f in zip(out["ring"]["tokens"], out["full"]["tokens"])]}
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["phase_s"] = time.perf_counter() - t0
    del params
    return res


def _greedy_logits(torch, eng, params, inputs, n, forced=None):
    """Prefill and n - 1 decode steps through the engine's own steps:
    (tokens [n, rows], logits [n, rows, V] on the host). Greedy, or fed
    `forced` tokens [n, rows] (the card's) while reporting its own argmax."""
    M = eng.M
    rows = inputs["tokens"].shape[0] * inputs["tokens"].shape[1]
    S = inputs["tokens"].shape[2]
    with torch.no_grad():
        logits, caches = eng._prefill(params, inputs)
        lgs, own = [], []
        for t in range(n):
            lg = logits[:, -1].float()
            lgs.append(lg.cpu())
            own.append(torch.argmax(lg, dim=-1).cpu())
            if t == n - 1:
                break
            tok = own[-1] if forced is None else forced[t]
            logits = eng._decode(params, caches,
                                 tok.to(eng.device).long().reshape(M, rows // M, 1),
                                 S + t)
    return torch.stack(own), torch.stack(lgs)


def xparity_phase(torch):
    """xparity (see the module docstring): the four configs of the new
    serving paths in f32 at full width and cut depth, card against CPU per
    prefill and decode step; the MoE's continuous engine against its
    sequential one."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import init_params
    from repro_torch.models import build_model
    from repro_torch.serve.continuous import ContinuousEngine, Request
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.utils.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lens, new, max_len, M = [5, 70, 130, 17], [8, 6, 8, 7], 160, 2
    out = {}
    for arch, cut in XPARITY_ARCHS.items():
        t0 = time.perf_counter()
        cfg = get_config(arch).with_updates(dtype="float32", **cut)
        model = build_model(cfg)
        params = init_params(model, M, 1, "cuda")
        cpu_params = tree_map(lambda x: x.cpu(), params)
        card = ServeEngine(model, params, M, max_len, device="cuda")
        cpu = ServeEngine(model, cpu_params, M, max_len, device="cpu")
        rng = np.random.default_rng(1)
        worst, tokens = 0.0, []
        got = dict.fromkeys(_read_counts(torch), 0)  # the card's runs only
        for i, (L, nt) in enumerate(zip(lens, new)):
            inputs = {"tokens": np.zeros((M, 1, L), np.int64)}
            inputs["tokens"][i % M, 0] = rng.integers(0, cfg.vocab_size, size=L)
            if cfg.family == "vlm":
                inputs["vis"] = rng.standard_normal((M, 1, cfg.vis_seq, cfg.vis_dim),
                                                    dtype=np.float32)
            if cfg.family == "encdec":
                inputs["frames"] = rng.standard_normal(
                    (M, 1, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
            staged = {k: torch.as_tensor(v) for k, v in inputs.items()}
            _reset_counts(torch)
            tok_c, lg_c = _greedy_logits(torch, card, params,
                                         {k: v.cuda() for k, v in staged.items()}, nt)
            got = {k: got[k] + v for k, v in _read_counts(torch).items()}
            tok_h, lg_h = _greedy_logits(torch, cpu, cpu_params, staged, nt, tok_c)
            if not torch.equal(tok_c, tok_h):
                raise AssertionError(f"xparity {arch} request {i}: card tokens "
                                     f"{tok_c.T.tolist()} != CPU {tok_h.T.tolist()}")
            scale = torch.clamp(lg_h.abs().amax(-1), min=1.0)  # per step and row
            worst = max(worst, ((lg_c - lg_h).abs().amax(-1) / scale).max().item())
            tokens.append(tok_c[:, i % M].numpy())
        if not worst <= XPARITY_LOGITS_TOL:
            raise AssertionError(f"xparity {arch}: card vs CPU logits {worst} > "
                                 f"{XPARITY_LOGITS_TOL} of their scale")
        if not (got["k4"] == got["attn_decode"] > 0 and got["k4_plain"] == 0
                and (got["k4_ring"] > 0) == bool(cfg.decode_long_window)
                and (got["k4_cross"] > 0) == (cfg.family in ("vlm", "encdec"))
                and (got["k2_cross"] > 0) == (cfg.family in ("vlm", "encdec"))):
            raise AssertionError(f"xparity {arch}: counts {got}")
        res = {"layers": cfg.num_layers, "split": cfg.split_layers,
               "requests": len(lens), "tokens": int(sum(new)), "counts": got,
               "logits_rel_err": worst}
        if cfg.family == "moe":  # continuous == sequential on the card
            eng = ContinuousEngine(model, params, M, max_len, slots=2,
                                   chunk=SERVE_TRAFFIC["chunk"], device="cuda")
            rng = np.random.default_rng(1)
            for i, (L, nt) in enumerate(zip(lens, new)):
                eng.submit(Request(id=i, client=i % M, new_tokens=nt,
                                   tokens=rng.integers(0, cfg.vocab_size, size=L)))
            cont = eng.run()
            for i, want in enumerate(tokens):
                if not (cont[i] == want).all():
                    raise AssertionError(f"xparity {arch} request {i}: continuous "
                                         f"{cont[i]} != sequential {want}")
            res["continuous_equals_sequential"] = True
        res["s"] = time.perf_counter() - t0
        out[arch] = res
        del params, cpu_params, card, cpu
        torch.cuda.empty_cache()
    return out


def _profile_window(torch, fn, margin_s: float = PROFILE_MARGIN_S) -> dict:
    """torch.profiler over fn() (synced): wall and device ms, busy share,
    and the K4 and K3 launches the profiler sees (kernels named
    flash_decode* / ssd_scan*, inside graph replays too) beside the
    launches counted on the card over the same window (read outside the
    trace: the trace holds fn's work alone)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = _read_counts(torch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the window opens well after the trace does (an H100 run with no
        # margin lost the first 19 K4 launches of its first window)
        time.sleep(margin_s)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(margin_s)
    got = _read_counts(torch)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3

    def seen(tag):
        return sum(e.count for e in kernels if tag in e.key)

    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "kernel_launches": sum(e.count for e in kernels),
            "k4_kernels": {e.key[:60]: e.count for e in kernels
                           if "flash_decode" in e.key},
            "device_busy_share": device_ms / wall_ms,
            "k4_seen": seen("flash_decode"), "k4_counted": got["k4"] - before["k4"],
            "k3_seen": seen("ssd_scan"), "k3_counted": got["k3"] - before["k3"]}


def _check_seen(prof: dict, what: str):
    for k in ("k4", "k3"):
        if prof[f"{k}_seen"] != prof[f"{k}_counted"]:
            raise AssertionError(f"graphs {what}: the profiler saw {prof[f'{k}_seen']} "
                                 f"{k.upper()} launches, the counters say "
                                 f"{prof[f'{k}_counted']}")


def _synced_off(torch, sync_check: bool):
    """set_sync_debug_mode("error") inside the block when sync_check."""
    @contextlib.contextmanager
    def block():
        torch.cuda.set_sync_debug_mode("error" if sync_check else "default")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return block()


def _continuous_steps(torch, model, params, cfg, M, use_graphs: bool):
    """GRAPH_REQUESTS through a continuous engine step by step (eager steps
    under sync debug mode "error"): (tokens by request, each decode step's
    logits on the host, captures)."""
    import numpy as np

    from repro_torch.serve.continuous import ContinuousEngine, Request

    lens, new = GRAPH_REQUESTS
    eng = ContinuousEngine(model, params, M, GRAPH_MAX_LEN, slots=2,
                           chunk=SERVE_TRAFFIC["chunk"], device="cuda",
                           graphs=use_graphs)
    rng = np.random.default_rng(1)
    for i, (L, n) in enumerate(zip(lens, new)):
        eng.submit(Request(id=i, client=i % M, new_tokens=n,
                           tokens=rng.integers(0, cfg.vocab_size, size=L)))
    logits = []
    while True:
        with _synced_off(torch, not use_graphs):
            issued = eng._issue_chunk()
            decoded = eng._decode_once()
        if decoded is not None:
            logits.append(decoded.float().cpu())
        if not issued and decoded is None:
            break
    res = eng.run()
    return [res[i] for i in range(len(lens))], logits, eng.stats["captures"]


def _sequential_steps(torch, model, params, cfg, M, use_graphs: bool):
    """One seeded batch (M x 2 rows of GRAPH_REQUESTS' longest prompt)
    through the sequential engine's decode step, greedy (the eager step
    under sync debug mode "error"): (tokens [steps, rows], logits by step,
    captures)."""
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServeEngine, stage_inputs

    L, n = max(GRAPH_REQUESTS[0]), max(GRAPH_REQUESTS[1])
    eng = ServeEngine(model, params, M, GRAPH_MAX_LEN, device="cuda",
                      graphs=use_graphs)
    inputs = stage_inputs(serve.seeded_inputs(cfg, M, 2, L, 1), "cuda")
    with torch.no_grad():
        logits, caches = eng._prefill(params, inputs)
        tok = torch.argmax(logits[:, -1], dim=-1).reshape(M, 2, 1)
        buf = eng.load_caches(caches, 2, L)
        del caches
        toks, lgs = [tok.flatten().cpu()], []
        for _ in range(n - 1):
            with _synced_off(torch, not use_graphs):
                buf.tok.copy_(tok)
                lg = buf.step.run()[:, -1]
                tok = torch.argmax(lg, dim=-1).reshape(M, 2, 1)
            lgs.append(lg.float().cpu())
            toks.append(tok.flatten().cpu())
    return torch.stack(toks), lgs, eng.graphs.captures


def _graphs_f32(torch) -> dict:
    """Replay against eager in f32 at cut depth, per family."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import init_params
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for arch, cut in GRAPH_F32_ARCHS.items():
        t0 = time.perf_counter()
        cfg = get_config(arch).with_updates(dtype="float32", **cut)
        model = build_model(cfg)
        M = 2
        params = init_params(model, M, 1, "cuda")
        run = (_continuous_steps if model.tower_extend is not None
               and not cfg.decode_long_window else _sequential_steps)
        _reset_counts(torch)
        eager = run(torch, model, params, cfg, M, False)
        counts_eager = _read_counts(torch)
        _reset_counts(torch)
        replay = run(torch, model, params, cfg, M, True)
        counts_replay = _read_counts(torch)
        for i, (a, b) in enumerate(zip(replay[0], eager[0])):
            if not (torch.as_tensor(a) == torch.as_tensor(b)).all():
                raise AssertionError(f"graphs {arch}: replayed tokens {a} != eager {b} "
                                     f"(request or step {i})")
        if len(replay[1]) != len(eager[1]) or not eager[1]:
            raise AssertionError(f"graphs {arch}: {len(replay[1])} replayed decode "
                                 f"steps, {len(eager[1])} eager")
        worst = max(((a - b).abs().amax(-1) / torch.clamp(b.abs().amax(-1), min=1.0)
                     ).max().item() for a, b in zip(replay[1], eager[1]))
        if not worst <= GRAPH_LOGITS_TOL:
            raise AssertionError(f"graphs {arch}: replayed vs eager logits {worst} > "
                                 f"{GRAPH_LOGITS_TOL} of their scale")
        want = M + 1 if run is _continuous_steps else 1
        if not (replay[2] == want and eager[2] == 0 and counts_replay == counts_eager
                and counts_replay["k4_plain"] == 0):
            raise AssertionError(f"graphs {arch}: captures {replay[2]} (want {want}), "
                                 f"counts replayed {counts_replay}, eager {counts_eager}")
        out[arch] = {"layers": cfg.num_layers, "engine": run.__name__[1:].split("_")[0],
                     "captures": replay[2], "decode_steps": len(replay[1]),
                     "logits_rel_err": worst, "counts": counts_replay,
                     "s": time.perf_counter() - t0}
        print(f"  graphs f32 {arch}: {out[arch]['engine']}, {replay[2]} captures, "
              f"{len(replay[1])} decode steps, logits {worst:.2e} of scale "
              f"({out[arch]['s']:.1f} s)", flush=True)
        del params
        torch.cuda.empty_cache()
    return out


def _profile_seen(torch, fn, what: str, again=None, tries: int = 3) -> dict:
    """_profile_window over fn until the profiler sees every K4 and K3
    launch counted on the card, in at most `tries` windows (`again`
    readies the next one; margins 1x, 4x and 16x PROFILE_MARGIN_S around
    it). The counted launches are the kernels' own (each launch adds one
    on the card), so a window where the profiler sees fewer lost kernel
    records: in whole runs on an H100 it lost one K4 record of 432 or 240
    now and then, and one of moe-serve's 240 in every window of two whole
    runs, whatever the margin and wherever the counts were read. So the
    last window may lack up to PROFILER_LOST_MAX records of each kernel
    (reported as `profiler_lost`); more lost, or more seen than counted,
    fails. Returns that window, with the short ones as `misses`."""
    misses = []
    for i in range(tries):
        if i and again is not None:
            again()
        prof = _profile_window(torch, fn, PROFILE_MARGIN_S * 4 ** i)
        pairs = [(prof[f"{k}_seen"], prof[f"{k}_counted"]) for k in ("k4", "k3")]
        if any(s > c for s, c in pairs):
            _check_seen(prof, what)
        if all(s == c for s, c in pairs):
            return dict(prof, misses=misses, profiler_lost=0)
        misses.append(pairs)
    lost = [c - s for s, c in pairs]
    if max(lost) > PROFILER_LOST_MAX:
        raise AssertionError(f"graphs {what}: in {tries} windows the profiler saw fewer "
                             f"launches than the card counted: (seen, counted) of K4 "
                             f"and K3 {misses}")
    print(f"  graphs {what}: the profiler lost {lost} (K4, K3) kernel records of "
          f"{[c for _, c in pairs]} counted on the card, in each of {tries} windows",
          flush=True)
    return dict(prof, misses=misses, profiler_lost=sum(lost))


def _graphs_bf16(torch, key) -> dict:
    """One serving phase's configuration at full width in bf16, timed by
    launch.serve.run_bench twice on the same weights, with the same
    warm-up: the phase's own replayed run (run here where the phase did
    not run) and one with the steps run eagerly (graphs=False); then
    profiled windows of the replayed steps. The eager run's launches are
    checked as the f32 part cannot: every decode attention on K4, every
    scan on K3's tensor-core path."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serve.continuous import ContinuousEngine, Request
    from repro_torch.serve.engine import ServeEngine, stage_inputs

    arch, M, b, L, lo, n, kind = GRAPH_BF16[key]
    t0 = time.perf_counter()
    cfg = get_config(arch)
    model = build_model(cfg)
    params = serve.init_params(model, M, 0, "cuda")  # the launcher's seed
    t = SERVE_TRAFFIC

    def bench(use_graphs: bool) -> dict:
        return serve.run_bench(
            model, params, cfg, M, b, L, n, kind, t["chunk"], device="cuda", seed=0,
            min_prompt_len=lo, slots=t["slots"] if kind == "continuous" else None,
            graphs=use_graphs)

    def timings(r: dict) -> dict:
        return {"prefill_ms": r["prefill_ms"], "decode_tok_s": r["decode_tok_s"],
                "ms_per_decode_step": r["slots"] / r["decode_tok_s"] * 1e3,
                "captures": r["captures"], "capture_ms": r["capture_ms"]}

    m = _REPLAYED.get(key) or bench(True)
    replayed = dict(timings(m), graph_pool_gib=m["graph_pool_bytes"] / 2**30)
    _reset_counts(torch)
    e = bench(False)
    counts = _read_counts(torch)
    if not (counts["k4"] == counts["attn_decode"] and counts["k4_plain"] == 0
            and counts["k3"] == counts["k3_tc"] and counts["k3_plain"] == 0):
        raise AssertionError(f"graphs {key}: eager counts {counts}")
    eager = dict(timings(e), counts=counts)
    lead = [_lead(a, x) for a, x in zip(m["outputs"], e["outputs"])]
    want = M + 1 if kind == "continuous" else 1
    if not (m["graphs"] and m["captures"] == want and not e["graphs"]
            and e["captures"] == 0 and len(lead) == len(m["outputs"])):
        raise AssertionError(f"graphs {key}: captures {m['captures']} (want {want}), "
                             f"eager {e['captures']}, {len(lead)} requests compared")
    # the replayed steps under the profiler: the first wave's extend chunks
    # where they run K3, and PROFILE_STEPS decode steps (K4, busy share)
    steps = serve.PROFILE_STEPS
    extend = None
    if kind == "continuous":
        eng = ContinuousEngine(model, params, M, L + n, slots=t["slots"],
                               chunk=t["chunk"], seed=0, device="cuda")
        prompts = serve._prompts(cfg, t["slots"], L, lo, 0)

        def wave():
            eng.run()
            for i, p in enumerate(prompts):
                eng.submit(Request(id=i, client=i % M, tokens=p, new_tokens=n))

        wave()
        if cfg.family in ("ssm", "hybrid"):
            extend = _profile_seen(torch, eng.prefill_all, f"{key} extend", wave)
        else:
            eng.prefill_all()
        decode = _profile_seen(torch, lambda: eng.decode_all(max_steps=steps),
                               f"{key} decode")
        eng.run()
    else:
        eng = ServeEngine(model, params, M, L + n, device="cuda")
        inputs = stage_inputs(serve.seeded_inputs(cfg, M, b, L, 0), "cuda")
        eng.generate_sequential(inputs, 2)  # captures the decode step
        with torch.no_grad():
            logits, caches = eng._prefill(params, inputs)
            tok = eng._sample(logits, 0.0, None, 0).reshape(M, b, 1)
            buf = eng.load_caches(caches, b, L)
            decode = _profile_seen(
                torch, lambda: eng.decode(buf, tok, steps + 1), f"{key} decode",
                lambda: eng.load_caches(caches, b, L))
            del caches, buf
    res = {"arch": arch, "engine": kind, "M": M, "eager": eager,
           "replayed": replayed, "leading_tokens_equal": lead,
           "requests_equal": int(sum(x == n for x in lead)),
           "profile_decode": dict(decode, ms_per_step=decode["wall_ms"] / steps,
                                  device_ms_per_step=decode["device_ms"] / steps),
           "profile_extend": extend}
    del params, eng
    torch.cuda.empty_cache()
    res["s"] = time.perf_counter() - t0
    return res


def graphs_phase(torch) -> dict:
    """graphs (see the module docstring): replay against eager, in f32 at
    cut depth and in bf16 at full width."""
    out = {"f32": _graphs_f32(torch)}
    for key in GRAPH_BF16:
        out[key] = _graphs_bf16(torch, key)
        r = out[key]
        print(f"  graphs {key}: {r['eager']['ms_per_decode_step']:.1f} -> "
              f"{r['replayed']['ms_per_decode_step']:.1f} ms a step, busy "
              f"{r['profile_decode']['device_busy_share']:.3f}, "
              f"{r['replayed']['captures']} captures in "
              f"{r['replayed']['capture_ms']:.0f} ms, leading tokens "
              f"{r['leading_tokens_equal']} ({r['s']:.1f} s)", flush=True)
    return out


def _state_bits_equal(torch, a, b) -> bool:
    """Two mtsl TrainStates equal bit for bit, leaf by path (a loaded tree
    has its keys sorted): params, AdamW moments, step."""
    from repro_torch.utils.tree import tree_leaves_with_path

    la, lb = (dict(tree_leaves_with_path({"params": s.params, "opt": list(s.opt_state)}))
              for s in (a, b))
    return a.step == b.step and sorted(la) == sorted(lb) and all(
        la[k].dtype == lb[k].dtype
        and torch.equal(la[k].detach().cpu(), lb[k].detach().cpu()) for k in la)


def ckpt_phase(torch, dev):
    """ckpt (see the module docstring): train, checkpoint, resume, compare
    with an uninterrupted run; load the card's file on the CPU; serve it."""
    from repro_torch.configs import get_config
    from repro_torch.core.lr_policy import server_scaled
    from repro_torch.data.lm import MultiTaskLMSource
    from repro_torch.data.pipeline import client_batches
    from repro_torch.launch import serve
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.checkpoint import load_algorithm_state
    from repro_torch.train.loop import TrainConfig, train

    c = CKPT
    M, rounds, cut = c["M"], c["rounds"], c["resume_at"]
    cfg = get_config(c["arch"]).with_updates(num_clients=M, scan_layers=True,
                                             remat="none", dtype="float32")
    model = build_model(cfg)
    src = MultiTaskLMSource(vocab_size=c["data_vocab"], num_clients=M, beta=1.0, seed=0)
    batches = list(client_batches(src, c["b"], steps=rounds, seed=0, seq_len=c["S"]))
    folder = ROOT / "build" / "ckpt"  # inside the checkout, ignored by git
    folder.mkdir(parents=True, exist_ok=True)
    first, last = str(folder / "round10.msgpack"), str(folder / "round20.msgpack")

    def run(steps, stream, path=None, **kw):
        tcfg = TrainConfig(steps=steps, lr=c["lr"], log_every=1, seed=0,
                           device=dev.type, checkpoint_path=path)
        return train(model, adamw(c["lr"]), iter(stream), tcfg, M,
                     component_lr=server_scaled(M), log=lambda _: None, **kw)

    t0 = time.perf_counter()
    with _deterministic(torch) as nondet:
        _reset_counts(torch)
        full, h_full = run(rounds, batches)
        counts = _read_counts(torch)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        _, h1 = run(cut, batches[:cut], first)
        t1 = time.perf_counter()
        restored, name, extra = load_algorithm_state(first, "mtsl", cfg=cfg, device=dev)
        load_s = time.perf_counter() - t1
        resumed, h2 = run(rounds, batches[cut:], last, init_state=restored,
                          start_round=extra["round"])
    torch.cuda.synchronize()
    keys = ("loss", "step", "round", "participants")
    if [[e[k] for k in keys] for e in h1 + h2] != [[e[k] for k in keys] for e in h_full]:
        raise AssertionError(f"ckpt: resumed history {h1 + h2} != uninterrupted {h_full}")
    if not (name == "mtsl" and extra == {"step": cut, "round": cut}):
        raise AssertionError(f"ckpt: file says {name} {extra}")
    if not _state_bits_equal(torch, resumed, full):
        raise AssertionError("ckpt: the resumed state differs from the uninterrupted one")
    # f32 (the example's --full config): K3's FMA path
    want = _lm_launches_per_round(cfg, M)["k3"] * rounds
    if not (counts["k3"] == want and counts["k3_plain"] == 0
            and counts["k1"] == rounds and counts["k1_plain"] == 0):
        raise AssertionError(f"ckpt: counts {counts}, want {want} K3 launches and "
                             f"{rounds} K1 launches")
    cpu_state, _, extra20 = load_algorithm_state(last, "mtsl", cfg=cfg, device="cpu")
    if not (extra20["round"] == rounds and _state_bits_equal(torch, cpu_state, resumed)):
        raise AssertionError("ckpt: the card's file does not load on the CPU bit-equal")
    del full, resumed, restored, cpu_state
    torch.cuda.empty_cache()
    argv = ["--arch", c["arch"], "--no-smoke", "--device", "cuda",
            "--checkpoint", last, "--prompt-len", "64", "--new-tokens", "16"]
    outs = [serve.main(argv) for _ in range(2)]
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError("ckpt: two loads of the file serve different tokens")
    o = outs[0]
    if o.shape != (M, 2, 16) or int(o.min()) < 0 or int(o.max()) >= cfg.vocab_size:
        raise AssertionError(f"ckpt: bad served tokens {o}")
    size = os.path.getsize(last)
    for path in (first, last):
        os.remove(path)
    return {"arch": c["arch"], "M": M, "rounds": rounds, "resume_at": cut,
            "losses": [e["loss"] for e in h_full], "resume_bit_equal": True,
            "cpu_load_bit_equal": True, "served_tokens_equal": True,
            "file_bytes": size, "load_s": load_s, "train_s": t_train,
            "counts": counts, "ops_without_deterministic_algorithm": nondet,
            "phase_s": time.perf_counter() - t0}


# the training loop's systems layers (pipeline, async, cached, chunk): the
# train phase's paper-resnet16 (M = 10, b = 8, lr 0.1) unless stated
SYS_ARCH, SYS_B, SYS_LR = "paper-resnet16", 8, 0.1
SYS_LM = {"arch": "mamba2-130m", "M": 4, "b": 4, "S": 256, "lr": 3e-3,
          "data_vocab": 4096, "rounds": 10}
SYS_TIMED_ROUNDS = 50  # unprofiled rounds timed at each prefetch depth
SYS_PROFILE_ROUNDS = 20  # profiled rounds at each prefetch depth
ASYNC_RUN = {"rounds": 20, "num_servers": 2, "sync_every": 2, "straggler_frac": 0.5,
             "staleness_decay": 0.5, "max_staleness": 4, "link_mbps": 10.0,
             "cut": 12}
CACHED_RUN = {"rounds": 20, "examples": 512, "alpha": 0.1, "dir": "build/chip_cache"}
CHUNK_RUN = {"M": 64, "chunk": 8, "rounds": 3, "lr": 0.01, "timed_rounds": 10,
             "scan_M": (32, 64)}
CHUNK_LOSS_TOL = 1e-5  # of max(1, |loss|), and on parameters: the CPU tests'


def _launch(argv):
    """repro_torch.launch.train.main(argv) with its output captured."""
    from repro_torch.launch import train as launch_train

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state, hist = launch_train.main(argv)
    return state, hist, out.getvalue()


def _sys_argv(steps: int, *extra) -> list:
    return ["--arch", SYS_ARCH, "--algorithm", "mtsl", "--device", "cuda",
            "--steps", str(steps), "--batch-per-client", str(SYS_B), "--lr",
            str(SYS_LR), "--seed", "0", *extra]


def _as_launcher(torch, model, M: int, batches, rounds: int, prefetch: int,
                 lr: float = SYS_LR, **kw):
    """train() as the launcher calls it for mtsl on a classifier (sgd at lr,
    server_scaled(M), the default schedule, seed 0)."""
    from repro_torch.core.lr_policy import server_scaled
    from repro_torch.core.schedule import ScheduleConfig
    from repro_torch.optim import sgd
    from repro_torch.train.loop import TrainConfig, train

    kw = {"schedule": ScheduleConfig(seed=0), **kw}
    tcfg = TrainConfig(steps=rounds, algorithm="mtsl", lr=lr, seed=0,
                       batch_per_client=SYS_B, device="cuda", prefetch=prefetch,
                       **kw)
    return train(model, sgd(lr), batches, tcfg, M, component_lr=server_scaled(M),
                 log=lambda _: None)


def _image_source(cfg, M: int, num_tasks=None):
    from repro_torch.data.synthetic import MultiTaskImageSource

    return MultiTaskImageSource(num_classes=M if num_tasks is None else cfg.num_classes,
                                num_tasks=num_tasks, image_size=cfg.image_size,
                                channels=cfg.image_channels, seed=0)


def _check_k1(counts: dict, launches: int, what: str, leaves=None):
    if not (counts["k1"] == launches and counts["k1_single"] == counts["k1_plain"] == 0
            and (leaves is None or counts["k1_leaves"] == leaves)):
        raise AssertionError(f"{what}: K1 counts {counts}, want {launches} launches"
                             + (f" over {leaves} leaves" if leaves else "")
                             + ", no per-leaf launch, no plain update")


def _profiled_rounds(torch, fn) -> dict:
    """Wall and device time of fn() under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    return {"wall_s": wall, "device_s": device, "device_busy_share": device / wall}


def pipeline_phase(torch, dev):
    """pipeline (see the module docstring): prefetch 0 against 2."""
    from repro_torch.configs import get_config
    from repro_torch.core.lr_policy import server_scaled
    from repro_torch.data.lm import MultiTaskLMSource
    from repro_torch.data.pipeline import client_batches
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.loop import TrainConfig, train

    leaves = next(lv for arch, _, lv in TRAIN_RUNS if arch == SYS_ARCH)
    out = {"arch": SYS_ARCH, "rounds": ROUNDS, "depths": {}}
    runs = {}
    for depth in (0, 2):
        _reset_counts(torch)
        t0 = time.perf_counter()
        with _deterministic(torch):
            state, hist, _ = _launch(_sys_argv(ROUNDS, "--prefetch", str(depth)))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts(torch)
        _check_k1(counts, ROUNDS, f"pipeline depth {depth}", leaves * ROUNDS)
        runs[depth] = (state, [e["loss"] for e in hist])
        out["depths"][depth] = {"k1_launches": counts["k1"], "deterministic_run_s": wall}
    if runs[0][1] != runs[2][1] or not _state_bits_equal(torch, runs[0][0], runs[2][0]):
        raise AssertionError(f"pipeline: prefetch 2 differs from 0: {runs[0][1]} vs "
                             f"{runs[2][1]}")
    out["bit_equal"] = True
    del runs

    # rounds/s (depths in the order 0, 2, 2, 0: the host's drift shows as a
    # gap between a depth's two runs) and the busy share at each depth, as
    # a user runs it; and the host's synthesis alone
    cfg = get_config(SYS_ARCH)
    M = cfg.num_clients
    model = build_model(cfg)
    src = _image_source(cfg, M)
    R, P = SYS_TIMED_ROUNDS, SYS_PROFILE_ROUNDS
    _as_launcher(torch, model, M, client_batches(src, SYS_B, steps=5, seed=0), 5, 2)
    for depth in (0, 2, 2, 0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _as_launcher(torch, model, M, client_batches(src, SYS_B, steps=R, seed=0), R,
                     depth)
        torch.cuda.synchronize()
        out["depths"][depth].setdefault("rounds_per_s", []).append(
            R / (time.perf_counter() - t0))
    for depth in (0, 2):
        prof = _profiled_rounds(torch, lambda: _as_launcher(
            torch, model, M, client_batches(src, SYS_B, steps=P, seed=0), P, depth))
        out["depths"][depth].update(timed_rounds=R, profiled_rounds=P, **prof)
    t0 = time.perf_counter()
    for _ in client_batches(src, SYS_B, steps=R, seed=0):
        pass
    out["host_synthesis_ms_per_round"] = (time.perf_counter() - t0) * 1e3 / R

    # mamba2-130m at full width: K3 counted on the card at both depths
    c = SYS_LM
    cfg = get_config(c["arch"])
    M, R = c["M"], c["rounds"]
    model = build_model(cfg)
    src = MultiTaskLMSource(vocab_size=c["data_vocab"], num_clients=M, beta=1.0, seed=0)
    want = _lm_launches_per_round(cfg, M)
    lm = {}
    for depth in (0, 2):
        _reset_counts(torch)
        t0 = time.perf_counter()
        with _deterministic(torch):
            state, hist = train(
                model, adamw(c["lr"]),
                client_batches(src, c["b"], steps=R, seed=0, seq_len=c["S"]),
                TrainConfig(steps=R, lr=c["lr"], log_every=1, seed=0,
                            device=dev.type, prefetch=depth),
                M, component_lr=server_scaled(M), log=lambda _: None)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts(torch)
        _check_k1(counts, R, f"pipeline {c['arch']} depth {depth}")
        if not (counts["k3"] == counts["k3_tc"] == want["k3"] * R
                and counts["k3_plain"] == 0):
            raise AssertionError(f"pipeline {c['arch']} depth {depth}: counts {counts},"
                                 f" want {want['k3']} K3 launches a round")
        lm[depth] = (state, [e["loss"] for e in hist], counts, wall)
    if lm[0][1] != lm[2][1] or not _state_bits_equal(torch, lm[0][0], lm[2][0]):
        raise AssertionError(f"pipeline {c['arch']}: prefetch 2 differs from 0")
    out["lm"] = {"arch": c["arch"], "M": M, "b": c["b"], "S": c["S"], "rounds": R,
                 "bit_equal": True, "loss_first": lm[0][1][0], "loss_last": lm[0][1][-1],
                 "k3_launches": {d: lm[d][2]["k3"] for d in lm},
                 "k1_launches": {d: lm[d][2]["k1"] for d in lm},
                 "deterministic_run_s": {d: lm[d][3] for d in lm}}
    del lm

    t0 = time.perf_counter()
    for _ in client_batches(src, c["b"], steps=R, seed=0, seq_len=c["S"]):
        pass
    out["lm"]["host_synthesis_ms_per_round"] = (time.perf_counter() - t0) * 1e3 / R
    return out


def async_phase(torch, dev):
    """async (see the module docstring)."""
    import shutil

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.algorithms import HParams, get_algorithm
    from repro_torch.core.lr_policy import server_scaled
    from repro_torch.core.schedule import ScheduleConfig, capability_profile, schedule_stream
    from repro_torch.core.topology import build_topology, mbps
    from repro_torch.data.pipeline import client_batches
    from repro_torch.models.registry import build_model
    from repro_torch.train.checkpoint import load_algorithm_state, save_algorithm_state
    from repro_torch.train.events import EventEngine
    from repro_torch.train.loop import stage_batch
    from repro_torch.utils.device import generator

    c = ASYNC_RUN
    R = c["rounds"]
    out = {"arch": SYS_ARCH, "rounds": R}
    # star(M), uniform capability, ideal links: the synchronous trajectory
    got = {}
    for flags in (["--prefetch", "0"], ["--async"]):
        _reset_counts(torch)
        with _deterministic(torch):
            state, hist, _ = _launch(_sys_argv(R, *flags))
            torch.cuda.synchronize()
        _check_k1(_read_counts(torch), R, f"async {flags}")
        got[flags[0]] = (state, {e["round"]: e["loss"] for e in hist})
    # the async history logs at the cadence and its last apply; the sync
    # one also its first round: every round both logged must agree
    (s_sync, l_sync), (s_async, l_async) = got["--prefetch"], got["--async"]
    if (R not in l_async or any(l_sync.get(r) != x for r, x in l_async.items())
            or not _state_bits_equal(torch, s_sync, s_async)):
        raise AssertionError(f"async: star/uniform differs from sync: {l_sync} vs "
                             f"{l_async}")
    out["star_bit_equal_to_sync"] = True
    del got, s_sync, s_async

    # multi-server, stragglers, staleness decay and cut-off
    cfg = get_config(SYS_ARCH)
    M = cfg.num_clients
    model = build_model(cfg)
    link = mbps(c["link_mbps"])
    topo = build_topology("multi-server", M, num_servers=c["num_servers"], uplink=link,
                          downlink=link, backbone=mbps(0.0), sync_every=c["sync_every"])
    scfg = ScheduleConfig(straggler_frac=c["straggler_frac"], seed=0)
    kw = dict(topology=topo, schedule=scfg, async_mode=True, log_every=1,
              staleness_decay=c["staleness_decay"], max_staleness=c["max_staleness"])
    src = _image_source(cfg, M)
    _reset_counts(torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = _as_launcher(torch, model, M, client_batches(src, SYS_B, steps=R,
                                                                seed=0), R, 2, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts(torch)
    applies = hist[-1]["round"]
    stale = [e["staleness"] for e in hist]
    if not (max(stale) > 0 and all(np.isfinite([e["loss"] for e in hist]))):
        raise AssertionError(f"async multi-server: staleness {stale}")
    _check_k1(counts, applies, "async multi-server (one launch per apply)")
    out["multi_server"] = {
        "num_servers": c["num_servers"], "sync_every": c["sync_every"],
        "straggler_frac": c["straggler_frac"], "staleness_decay": c["staleness_decay"],
        "max_staleness": c["max_staleness"], "dispatches": R, "applies": applies,
        "max_staleness_seen": max(stale), "k1_launches": counts["k1"],
        "sim_time": hist[-1]["sim_time"], "run_s": wall, "s_per_apply": wall / applies,
        "loss_first": hist[0]["loss"], "loss_last": hist[-1]["loss"]}

    # a mid-flight snapshot through the checkpoint resumes bit for bit
    alg = get_algorithm("mtsl")
    hp = HParams(lr=SYS_LR, component_lr=server_scaled(M))
    topo_c = topo.with_capability(capability_profile(M, scfg, topo))
    pairs = list(zip((stage_batch(b, dev) for b in client_batches(src, SYS_B, steps=R,
                                                                    seed=0)),
                     schedule_stream(scfg, M, 1)))
    ek = dict(staleness_decay=c["staleness_decay"], max_staleness=c["max_staleness"])
    path = ROOT / "build" / "chip_async" / "async.msgpack"
    try:
        with _deterministic(torch):
            eng = EventEngine(alg, model, M, hp, topo_c, init_state=alg.init_state(
                model, generator(dev, 0), M, hp), **ek)
            gen = eng.run(iter(pairs), max_dispatches=R)
            for i, _ in enumerate(gen):
                if i == c["cut"]:
                    break
            in_flight = len(eng.cohorts)
            save_algorithm_state(str(path), alg, eng.state(), cfg=cfg,
                                 extra={"events": eng.snapshot()})
            restored, _, extra = load_algorithm_state(str(path), cfg=cfg, device=dev)
            snap = extra["events"]
            resumed = EventEngine(alg, model, M, hp, topo_c, init_state=restored,
                                  snapshot=snap, **ek)
            for _ in resumed.run(iter(pairs[snap["dispatches"]:]), max_dispatches=R):
                pass
            for _ in gen:
                pass
            torch.cuda.synchronize()
        same = ((resumed.applies, resumed.t, resumed.dropped)
                == (eng.applies, eng.t, eng.dropped)
                and _state_bits_equal(torch, resumed.state(), eng.state()))
    finally:
        shutil.rmtree(path.parent, ignore_errors=True)
    if not same or not in_flight:
        raise AssertionError(f"async: resumed at event {c['cut']} ({in_flight} cohorts "
                             f"in flight) differs from the uninterrupted run")
    out["resume"] = {"cut_event": c["cut"], "cohorts_in_flight": in_flight,
                     "bit_equal": True}
    return out


def _dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def cached_phase(torch, dev):
    """cached (see the module docstring)."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.data import shards
    from repro_torch.data.pipeline import client_batches
    from repro_torch.models.registry import build_model

    c = CACHED_RUN
    R, n = c["rounds"], c["examples"]
    cfg = get_config(SYS_ARCH)
    M = cfg.num_clients
    model = build_model(cfg)
    src = _image_source(cfg, M)
    root = ROOT / c["dir"]
    shutil.rmtree(root, ignore_errors=True)
    built = {}

    def timed(name):
        real = getattr(shards, name)

        def fn(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                built[name] = time.perf_counter() - t0

        return real, fn

    out = {"arch": SYS_ARCH, "rounds": R, "examples_per_client": n, "caches": {}}
    try:
        for kind, extra in (("per_client", []),
                            ("dirichlet", ["--dirichlet-alpha", str(c["alpha"])])):
            d = root / kind
            argv = _sys_argv(R, "--data", "cached", "--cache-dir", str(d),
                             "--cache-examples", str(n), *extra)
            name = "build_dirichlet_cache" if extra else "build_cache"
            real, fn = timed(name)
            setattr(shards, name, fn)
            _reset_counts(torch)
            try:
                with _deterministic(torch):
                    s_cache, h_cache, log = _launch(argv)
            finally:
                setattr(shards, name, real)
            _check_k1(_read_counts(torch), R, f"cached {kind}")
            if "built client cache" not in log or name not in built:
                raise AssertionError(f"cached {kind}: the launcher did not build the "
                                     "cache on first use")
            if extra:
                corpus = shards.pooled_corpus(src, M * n, seed=0)
                mem = shards.materialize_dirichlet(corpus, M, c["alpha"], seed=0)
            else:
                mem = shards.materialize_source(src, n, seed=0)
            with _deterministic(torch):
                s_mem, h_mem = _as_launcher(torch, model, M,
                                            client_batches(mem, SYS_B, steps=R, seed=0),
                                            R, 2)
                torch.cuda.synchronize()
            if ([e["loss"] for e in h_cache] != [e["loss"] for e in h_mem]
                    or not _state_bits_equal(torch, s_cache, s_mem)):
                raise AssertionError(f"cached {kind}: training from the cache differs "
                                     "from the same rows in memory")
            ds = shards.load_cache(str(d))
            t0 = time.perf_counter()
            for _ in client_batches(ds, SYS_B, steps=R, seed=0):
                pass
            read_ms = (time.perf_counter() - t0) * 1e3 / R
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _as_launcher(torch, model, M, client_batches(ds, SYS_B, steps=R, seed=0), R, 2)
            torch.cuda.synchronize()
            out["caches"][kind] = {
                "build_s": built[name], "bytes": _dir_bytes(d),
                "examples": sum(ds.num_examples(m) for m in range(M)),
                "bit_equal_to_in_memory": True, "host_read_ms_per_round": read_ms,
                "rounds_per_s": R / (time.perf_counter() - t0)}
        t0 = time.perf_counter()
        for _ in client_batches(src, SYS_B, steps=R, seed=0):
            pass
        synth_ms = (time.perf_counter() - t0) * 1e3 / R
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _as_launcher(torch, model, M, client_batches(src, SYS_B, steps=R, seed=0), R, 2)
        torch.cuda.synchronize()
        out["synthesis"] = {"host_ms_per_round": synth_ms,
                            "rounds_per_s": R / (time.perf_counter() - t0)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["removed"] = not root.exists()
    return out


def chunk_phase(torch, dev):
    """chunk (see the module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.core.algorithms import HParams, get_algorithm
    from repro_torch.core.lr_policy import server_scaled
    from repro_torch.core.scan_round import build_mtsl_scan_round
    from repro_torch.core.schedule import full_schedule
    from repro_torch.data.pipeline import client_batches
    from repro_torch.kernels.mtsl_update.ops import mtsl_update_multi_
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import stage_batch
    from repro_torch.utils.device import generator
    from repro_torch.utils.tree import tree_leaves_with_path

    c = CHUNK_RUN
    M, chunk, R = c["M"], c["chunk"], c["rounds"]
    base = ["--num-clients", str(M)]
    out = {"arch": SYS_ARCH, "M": M, "chunk": chunk, "b": SYS_B}

    def gap(a, b):
        la, lb = (dict(tree_leaves_with_path(s.params)) for s in (a, b))
        return max(float((la[k].detach() - lb[k].detach()).abs().max()) for k in la)

    # dense against chunked, R rounds at lr 0.01 (the CPU tests' tolerance)
    runs = {}
    for flags in ([], ["--client-chunk", str(chunk)]):
        argv = _sys_argv(R, *base, *flags, "--prefetch", "0")
        argv[argv.index("--lr") + 1] = str(c["lr"])
        _reset_counts(torch)
        with _deterministic(torch):
            state, hist, _ = _launch(argv)
            torch.cuda.synchronize()
        _check_k1(_read_counts(torch), R, f"chunk {flags}")
        runs[bool(flags)] = (state, [e["loss"] for e in hist])
    (s_d, l_d), (s_c, l_c) = runs[False], runs[True]
    scale = max(1.0, max(abs(x) for x in l_d))
    loss_gap, param_gap = max(abs(a - b) for a, b in zip(l_d, l_c)), gap(s_d, s_c)
    if loss_gap > CHUNK_LOSS_TOL * scale or param_gap > CHUNK_LOSS_TOL:
        raise AssertionError(f"chunk: chunked vs dense loss gap {loss_gap} (scale "
                             f"{scale}), parameter gap {param_gap}")
    out["vs_dense"] = {"rounds": R, "lr": c["lr"], "loss_gap": loss_gap,
                       "loss_scale": scale, "param_gap": param_gap}
    del runs, s_d, s_c

    # peak memory and s per round, as a user runs them
    T = c["timed_rounds"]
    for flags, key in (([], "dense"), (["--client-chunk", str(chunk)], "chunked")):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # the run's own peak: what earlier phases still hold is not its
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        _, hist, _ = _launch(_sys_argv(T, *base, *flags))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[key] = {"rounds": T, "run_s": wall,
                    "s_per_round": (hist[-1]["time"] - hist[0]["time"]) / (T - 1),
                    "peak_mem_gib": (torch.cuda.max_memory_allocated() - held) / 2**30,
                    "held_before_gib": held / 2**30}

    # the host scan round at two M, on the same per-block functions
    cfg = get_config(SYS_ARCH).with_updates(num_clients=max(c["scan_M"]))
    model = build_model(cfg)
    alg = get_algorithm("mtsl")
    out["scan"], kernels = {}, []
    for m in c["scan_M"]:
        hp = HParams(lr=c["lr"], component_lr=server_scaled(m))
        src = _image_source(cfg, m, num_tasks=m)
        batches = [stage_batch(b, dev) for b in client_batches(src, SYS_B, steps=R,
                                                                seed=0)]
        dense, scan = alg.round_fn(model, m, hp), build_mtsl_scan_round(model, m, hp,
                                                                          chunk=chunk)
        s_d = alg.init_state(model, generator(dev, 0), m, hp)
        s_s = alg.init_state(model, generator(dev, 0), m, hp)
        sched = full_schedule(m, 1)
        losses, launches = [], []
        with _deterministic(torch):
            for b in batches:
                s_d, m_d = dense(s_d, b, sched)
                n0 = mtsl_update_multi_.launches
                s_s, m_s = scan(s_s, b, sched)
                launches.append(mtsl_update_multi_.launches - n0)
                losses.append((float(m_d["loss"]), float(m_s["loss"])))
        scale = max(1.0, max(abs(a) for a, _ in losses))
        lgap = max(abs(a - b) for a, b in losses)
        if lgap > CHUNK_LOSS_TOL * scale or set(launches) != {m // chunk + 1}:
            raise AssertionError(f"chunk scan M={m}: losses {losses}, K1 launches a "
                                 f"round {launches}, want {m // chunk + 1}")
        kernels.append(scan.kernels)
        out["scan"][m] = {"loss_gap": lgap, "loss_scale": scale,
                          "k1_launches_per_round": launches[0],
                          "param_gap": gap(s_d, s_s)}
    if any(k is not kernels[0] for k in kernels):
        raise AssertionError(f"chunk scan: M {c['scan_M']} built their own functions")
    return out


PHASES = ("kernel", "k1", "k2", "k3", "slice", "parity", "train", "tparity",
          "lm-train", "lm-learn", "lm-parity", "baselines", "bparity",
          "lm-baselines", "encdec", "moe", "vlm", "fparity", "ssm-serve",
          "hybrid-serve", "sparity", "moe-serve", "vlm-serve", "encdec-serve",
          "swa-serve", "xparity", "graphs", "ckpt", "pipeline", "async", "cached",
          "chunk")


def _phases_wanted(argv):
    """`--only a,b,...` runs the build and those phases and prints no
    result line; no arguments run every phase."""
    only = set(PHASES)
    if argv:
        if len(argv) != 2 or argv[0] != "--only" or not set(argv[1].split(",")) <= only:
            raise SystemExit(f"usage: chip_smoke.py [--only {','.join(PHASES)}]")
        only = set(argv[1].split(","))

    def want(name):
        return name in only

    want.only, want.partial = only, only != set(PHASES)
    return want


def main() -> int:
    # cuBLAS reproducibility under use_deterministic_algorithms (tparity);
    # must be set before CUDA initialises
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        import torch
    except ImportError:
        return _fail("torch is not installed")
    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        return _fail(f"no src/repro_torch beside {Path(__file__).name}: run it "
                     "from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
          "nvidia-smi: no output", flush=True)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda "
          f"{torch.version.cuda}  device {torch.cuda.get_device_name(0)}",
          flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    want = _phases_wanted(sys.argv[1:])
    try:
        t0 = time.perf_counter()
        regs = build_phase()
        report["build_s"] = time.perf_counter() - t0
        print(f"[build] {', '.join(regs)} in {report['build_s']:.1f} s", flush=True)
        for name, lines in regs.items():
            print(f"  ptxas {name}: {lines}", flush=True)

        if want("kernel"):
            print("[kernel] K4 vs its plain version", flush=True)
            cases = kernel_phase(torch, dev)
            print("KERNEL_CASES " + json.dumps(cases), flush=True)

        if want("k1"):
            print("[k1] K1 vs its plain version (bit-equal)", flush=True)
            k1_cases = k1_phase(torch, dev)
            print("K1_CASES " + json.dumps(k1_cases), flush=True)

        if want("k2"):
            print("[k2] K2 vs its plain version", flush=True)
            k2_cases = k2_phase(torch, dev)
            print("K2_CASES " + json.dumps(k2_cases), flush=True)

        if want("k3"):
            print("[k3] K3 vs its plain version", flush=True)
            k3_cases = k3_phase(torch, dev)
            print("K3_CASES " + json.dumps(k3_cases), flush=True)
            torch.cuda.empty_cache()

        if want("slice"):
            print("[slice] gemma3-12b full width/depth, M=2, continuous", flush=True)
            report["slice"] = slice_phase(torch)
            print("SLICE " + json.dumps(report["slice"]), flush=True)
            torch.cuda.empty_cache()

        if want("parity"):
            print("[parity] full width, 6+6 layers, f32: continuous == sequential",
                  flush=True)
            report["parity"] = parity_phase(torch)
            print("PARITY " + json.dumps(report["parity"]), flush=True)
            torch.cuda.empty_cache()

        if want("train"):
            report["train"] = []
            for arch, b, leaves in TRAIN_RUNS:
                print(f"[train] {arch} full width/depth, mtsl, {ROUNDS} rounds",
                      flush=True)
                res, state = train_phase(torch, dev, arch, b, leaves)
                if arch == "paper-resnet16":
                    res["profile"] = train_profile_phase(torch, dev, state)
                del state
                report["train"].append(res)
                print("TRAIN " + json.dumps(res), flush=True)

        if want("tparity"):
            print("[tparity] paper-resnet16, 3 masked rounds: card == CPU; seeded "
                  "repeatability", flush=True)
            report["tparity"] = train_parity_phase(torch)
            print("TPARITY " + json.dumps(report["tparity"]), flush=True)
            torch.cuda.empty_cache()

        if want("lm-train"):
            print(f"[lm-train] {LM_TRAIN['arch']} full width/depth, M={LM_TRAIN['M']}, "
                  f"S={LM_TRAIN['S']}, SGD, {LM_TRAIN['rounds']} rounds", flush=True)
            report["lm_train"] = lm_train_phase(torch, dev)
            print("LM_TRAIN " + json.dumps(report["lm_train"]), flush=True)
            torch.cuda.empty_cache()

        if want("lm-learn"):
            print(f"[lm-learn] {LM_LEARN['arch']} full config, adamw, "
                  f"{LM_LEARN['rounds']} rounds", flush=True)
            report["lm_learn"] = lm_learn_phase(torch, dev)
            print("LM_LEARN " + json.dumps(report["lm_learn"]), flush=True)
            torch.cuda.empty_cache()

        if want("lm-parity"):
            print("[lm-parity] smoke zamba2-7b and mamba2-130m: card == CPU; seeded "
                  "repeatability", flush=True)
            report["lm_parity"] = lm_parity_phase(torch)
            print("LM_PARITY " + json.dumps(report["lm_parity"]), flush=True)
            torch.cuda.empty_cache()

        if want("baselines"):
            print(f"[baselines] {', '.join(BASELINES)} on full "
                  f"{BASELINE_RUN['arch']}, {BASELINE_RUN['local_steps']} local "
                  f"steps x {BASELINE_RUN['rounds']} rounds", flush=True)
            report["baselines"] = baselines_phase(torch, dev)
            print("BASELINES " + json.dumps(report["baselines"]), flush=True)
            torch.cuda.empty_cache()

        if want("bparity"):
            print("[bparity] the baselines, card == CPU; seeded repeatability",
                  flush=True)
            report["bparity"] = baselines_parity_phase(torch)
            print("BPARITY " + json.dumps(report["bparity"]), flush=True)
            torch.cuda.empty_cache()

        if want("lm-baselines"):
            print(f"[lm-baselines] splitfed and fedavg on {LM_BASELINES['arch']} "
                  f"full config, {LM_BASELINES['rounds']} rounds", flush=True)
            report["lm_baselines"] = lm_baselines_phase(torch, dev)
            print("LM_BASELINES " + json.dumps(report["lm_baselines"]), flush=True)
            torch.cuda.empty_cache()

        for key in ("encdec", "moe", "vlm"):
            if want(key):
                c = ZOO_RUNS[key]
                print(f"[{key}] {c['arch']} full width, "
                      f"{c['num_layers'] or 'all'} layers, M={c['M']}, b={c['b']}, "
                      f"S={c['S']}, SGD, {c['rounds']} rounds", flush=True)
                report[key] = zoo_phase(torch, dev, key)
                print(f"{key.upper()} " + json.dumps(report[key]), flush=True)
                torch.cuda.empty_cache()

        if want("fparity"):
            print(f"[fparity] smoke {', '.join(ZOO_PARITY_ARCHS)}: card == CPU",
                  flush=True)
            report["fparity"] = zoo_parity_phase(torch)
            print("FPARITY " + json.dumps(report["fparity"]), flush=True)

        for key in ("ssm-serve", "hybrid-serve"):
            if want(key):
                c = SERVE_RUNS[key]
                print(f"[{key}] {c['arch']} full width/depth, M={c['M']}, "
                      "continuous engine", flush=True)
                report[key] = serve_phase(torch, key)
                print(f"{key.upper().replace('-', '_')} " + json.dumps(report[key]),
                      flush=True)
                print(f"[{key}] {report[key]['phase_s']:.1f} s", flush=True)
                torch.cuda.empty_cache()

        if want("sparity"):
            print(f"[sparity] {', '.join(SPARITY_ARCHS)} full width, cut depth, "
                  "f32: continuous == sequential; card vs CPU logits", flush=True)
            t1 = time.perf_counter()
            report["sparity"] = serve_parity_phase(torch)
            print("SPARITY " + json.dumps(report["sparity"]), flush=True)
            print(f"[sparity] {time.perf_counter() - t1:.1f} s", flush=True)

        if want("moe-serve"):
            c = SERVE_RUNS["moe-serve"]
            print(f"[moe-serve] {c['arch']} full width/depth, M={c['M']}, continuous "
                  "then sequential engine", flush=True)
            report["moe-serve"] = serve_phase(torch, "moe-serve")
            print("MOE_SERVE " + json.dumps(report["moe-serve"]), flush=True)
            print(f"[moe-serve] {report['moe-serve']['phase_s']:.1f} s", flush=True)
            torch.cuda.empty_cache()

        for key, c in SEQ_SERVE_RUNS.items():
            if want(key):
                print(f"[{key}] {c['arch']} full width/depth, M={c['M']}, b={c['b']}, "
                      "sequential engine", flush=True)
                report[key] = seq_serve_phase(torch, key)
                print(f"{key.upper().replace('-', '_')} " + json.dumps(report[key]),
                      flush=True)
                print(f"[{key}] {report[key]['phase_s']:.1f} s", flush=True)
                torch.cuda.empty_cache()

        if want("swa-serve"):
            print(f"[swa-serve] {SWA_SERVE['arch']} full width/depth, ring caches, "
                  f"prompts {SWA_SERVE['prompt_lens']}", flush=True)
            report["swa-serve"] = swa_serve_phase(torch)
            print("SWA_SERVE " + json.dumps(report["swa-serve"]), flush=True)
            print(f"[swa-serve] {report['swa-serve']['phase_s']:.1f} s", flush=True)
            torch.cuda.empty_cache()

        if want("xparity"):
            print(f"[xparity] {', '.join(XPARITY_ARCHS)} full width, cut depth, f32: "
                  "card vs CPU logits and tokens", flush=True)
            t1 = time.perf_counter()
            report["xparity"] = xparity_phase(torch)
            print("XPARITY " + json.dumps(report["xparity"]), flush=True)
            print(f"[xparity] {time.perf_counter() - t1:.1f} s", flush=True)

        if want("graphs"):
            print("[graphs] replayed steps vs eager: f32 at cut depth, bf16 at full "
                  "width", flush=True)
            t1 = time.perf_counter()
            report["graphs"] = graphs_phase(torch)
            print("GRAPHS " + json.dumps(report["graphs"]), flush=True)
            print(f"[graphs] {time.perf_counter() - t1:.1f} s", flush=True)
            torch.cuda.empty_cache()

        if want("ckpt"):
            print(f"[ckpt] {CKPT['arch']} full config, adamw, {CKPT['resume_at']} "
                  f"+ {CKPT['rounds'] - CKPT['resume_at']} rounds resumed vs "
                  f"{CKPT['rounds']}; then served", flush=True)
            report["ckpt"] = ckpt_phase(torch, dev)
            print("CKPT " + json.dumps(report["ckpt"]), flush=True)
            print(f"[ckpt] {report['ckpt']['phase_s']:.1f} s", flush=True)
            torch.cuda.empty_cache()

        # the training loop's systems layers run last: in a whole run where
        # they ran before the graphs phase, its profiler windows lost kernel
        # records (PERF.md §7)
        for key, fn, what in (
                ("pipeline", pipeline_phase, f"{SYS_ARCH} and {SYS_LM['arch']}, "
                 "--prefetch 0 vs 2: bit-equal; rounds/s and busy share"),
                ("async", async_phase, f"{SYS_ARCH} --async: star == sync; "
                 "multi-server with stragglers; snapshot resume"),
                ("cached", cached_phase, f"{SYS_ARCH} --data cached (per-client, "
                 "Dirichlet) built on first use == in memory"),
                ("chunk", chunk_phase, f"{SYS_ARCH} M={CHUNK_RUN['M']}, dense vs "
                 f"--client-chunk {CHUNK_RUN['chunk']}; the scan round at M "
                 f"{CHUNK_RUN['scan_M']}")):
            if want(key):
                print(f"[{key}] {what}", flush=True)
                t1 = time.perf_counter()
                report[key] = fn(torch, dev)
                report[key]["phase_s"] = time.perf_counter() - t1
                print(f"{key.upper()} " + json.dumps(report[key]), flush=True)
                print(f"[{key}] {report[key]['phase_s']:.1f} s", flush=True)
                torch.cuda.empty_cache()
    except Exception:  # any phase failing fails the run
        traceback.print_exc()
        return _fail("a phase failed")
    if want.partial:  # a subset of the phases: no result line
        print(f"chip_smoke: phases {sorted(want.only)} passed in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return 0

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    k4 = dict(K4, launches=report["slice"]["k4_launches"],
              **{key: cases[0][key] for key in keys})
    k1_case = next(c for c in k1_cases if c["case"] == K1_MAIN_CASE)
    k1 = dict(K1, launches=report["train"][0]["k1_launches"],
              **{key: k1_case[key] for key in keys})
    lm_counts = report["lm_train"]["counts"]
    k2 = dict(K2, launches=lm_counts["k2"], **{key: k2_cases[0][key] for key in keys})
    k3 = dict(K3, launches=lm_counts["k3"], **{key: k3_cases[0][key] for key in keys})
    # the serving phases' launches beside the training path's (K4's ring and
    # cross decodes, K2's cross and non-causal prefill attention, apart)
    k3["serve_launches"] = {key: report[key]["counts"]["k3"] for key in SERVE_RUNS}
    # the systems layers' paths: K1 once a round (pipelined, cached), once
    # an apply (async), once a round dense or chunked, M/chunk + 1 times a
    # scan round; K3 on the pipelined LM run, counted on the card
    k1["systems_launches"] = {
        "pipeline_prefetch2": report["pipeline"]["depths"][2]["k1_launches"],
        "async_multi_server": report["async"]["multi_server"]["k1_launches"],
        "scan_round_per_round": {m: r["k1_launches_per_round"]
                                 for m, r in report["chunk"]["scan"].items()}}
    k3["systems_launches"] = {"pipeline_lm": report["pipeline"]["lm"]["k3_launches"]}
    k4["serve_launches"] = {key: report[key]["counts"]["k4"]
                            for key in ("ssm-serve", "hybrid-serve")}
    zoo_serve = {"moe-serve": report["moe-serve"]["counts"],
                 "vlm-serve": report["vlm-serve"]["counts"],
                 "encdec-serve": report["encdec-serve"]["counts"],
                 "swa-serve": report["swa-serve"]["bench"]["counts"]}
    for key, got in zoo_serve.items():
        k4["serve_launches"][key] = {"all": got["k4"], "ring": got["k4_ring"],
                                     "cross": got["k4_cross"]}
    k2["serve_launches"] = {key: {"cross": got["k2_cross"], "bidir": got["k2_bidir"]}
                            for key, got in zoo_serve.items()}
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all", flush=True)
    print(json.dumps({"kernels": [k4, k1, k2, k3]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
