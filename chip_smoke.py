#!/usr/bin/env python3
"""Drive the PyTorch port (ray_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. The card's name and power limit (from nvidia-smi), then the build of
   every kernel from the sources under ray_tpu_torch/ops/csrc (one nvcc
   per source, all started together) with each one's ptxas report, and
   the SASS check: the toolkit's cuobjdump lists, for every kernel function
   of each library, whether its machine code holds HGMMA (wgmma, the
   tensor cores), UTMALDG (TMA loads) and UTMASTG (TMA stores). The bf16
   kernels of B1, B2 and B3 must hold HGMMA and UTMALDG; a missing
   cuobjdump fails the run.
2. Each kernel against its plain PyTorch version on the card, at the main
   paths' shapes and edge shapes (ragged lengths, a length shorter than one
   tile, Lq != Lk across a 128-row boundary, G in {1, 3, 4}, D in {64,
   128}, q/k/v as views of one fused projection), a view that breaks TMA's
   16-byte stride rule must raise ValueError; then each kernel is timed in
   turns with one PyTorch library call computing the same function
   (kernel, library, library, kernel; median of 5 rounds, spread printed),
   beside its plain version and the least time the card could take
   (bound): the flash forward (B1) at the tpu-7b prefill shape and the
   tpu-3b training shape, the dQ (B2) and dK/dV (B3) backward kernels at
   the tpu-3b training shape.
3. The generator at the full width and depth of tpu-7b (32 layers, bf16,
   seeded random weights): make_generate_fn with batch 8, prompt 512, 32
   new tokens, greedy. Its prefill must launch the flash kernel once per
   layer, and its last-position prefill logits must agree with the same
   weights run through plain attention.
4. The continuous-batching engine on the same model: six requests of
   100-700 prompt tokens, one submitted mid-decode, stepped to the end.
   Every greedy token it emitted is then held against a one-shot forward
   of the same weights over the prompt and the tokens before it. The
   engine runs with step_profile: the decode steps' MFU, MFU over the
   compute phase and host gap (its engine.decode spans' attribution) are
   printed.
5. Training at tpu-3b width and 4 layers (fp32 master weights, bf16
   compute, no activation recompute, batch 4 x 1024): one make_train_fns
   step through the kernels and one through plain attention, from the same
   weights; the loss, grad_norm and every parameter's gradient must agree.
6. Training tpu-3b at full width and depth: make_train_fns with adamw(3e-4)
   and loss_chunk 256, no activation recompute, 5 steps of batch 4 x 1024
   on one repeated batch. Every step must launch each of the three kernels
   once per layer, and the loss must fall. Step time, tokens/s and peak
   memory are printed.
7. The JAX bench's training recipe on tpu-3b at full width and depth: bf16
   weights, adafactor(3e-4), remat "dots", loss_chunk 256, 5 steps of
   batch 4 x 1024 on one repeated batch. First a 4-layer check of the same
   recipe with remat "dots" against remat off: the loss and every gradient
   must agree. Every step must launch the forward kernel twice per layer
   (the forward and the backward's recompute) and the dQ and dK/dV kernels
   once; the loss must fall. Step time, tokens/s, peak memory and an MFU
   are printed.
8. The engine's features on tpu-7b at full width, cut to SERVE_LAYERS =
   16 of its 32 layers (8 slots of
   1024 tokens, chunk 128, budget 256): (a) the prefix cache, with full
   precision and int8 blocks: 4 shared 384-token prefixes, 4 requests each;
   every request's greedy tokens must equal the same prompt's as a miss on
   a fresh engine (and, in full precision, on an engine without the
   cache); (b) the blocks exported and imported into a second engine give
   the exporter's tokens; (c) speculative decoding, k=4, with a self-draft
   and a random tpu-125m draft, in bf16 and again on the same weights in
   fp32: in fp32 spec-on greedy streams must equal spec-off (a stream may
   differ only at a near-tie of the spec-off logits, at most one of 8) and
   the self-draft must accept at least 90% of its tokens; in bf16, where a
   random model's logits tie often and the verify forward rounds otherwise
   than a decode step, every spec-on token is held to a one-shot forward
   as in phase 4, and the agreement with spec-off is printed.
9. MoE serving: mixtral-8x7b at full width (d_model 4096, d_ff 14336,
   32/8 heads, 8 experts, top-2) cut to 16 of its 32 layers, bf16, seeded
   random weights. The generator at batch 8, prompt 512, 32 greedy tokens
   must launch the flash kernel once per layer in its prefill; then the
   prefill's and a decode step's time, the peak memory, the share of
   routing picks dropped at capacity_factor 1.25, and (informational) the
   share of routing decisions that equal those of plain attention and the
   largest logit difference at positions routed alike in every layer.
   The engine runs phase 4's request mix (8 slots of 1024, chunk 128,
   budget 256). At 1.25 a chunk of 128 tokens (C = 40), a decode step
   (C = 1) and a one-shot forward route differently, so its tokens are
   held in phase 11.
10. MoE training: the JAX bench's recipe (bf16 weights, adafactor(3e-4),
    remat "dots", loss_chunk 256) on mixtral-8x7b at full width and 4
    layers: first phase 7's check of remat "dots" against remat off (the
    routing is recomputed, the expert products kept), then 5 steps of
    batch 4 x 1024 on one repeated batch: the forward
    kernel twice per layer per step and the dQ and dK/dV kernels once, a
    falling loss, and moe_aux finite and above 0 at every step.
11. MoE holds, mixtral-8x7b at full width and 2 layers in fp32 (where the
    kernels keep their FMA paths and a near-tied routing pick does not
    flip on rounding): a prefill through the kernels against plain
    attention, with identical routing and logits within phase 3's bound;
    the engine's every token against a one-shot forward at
    capacity_factor 4.0 (= E/K, where C = L: nothing is dropped and the
    routing no longer depends on how a sequence is cut); one training step
    through the kernels against plain attention, with identical routing
    and the loss and gradients within phase 5's bounds.
12. The device mesh (parallel/mesh.py) on a world of one rank: an NCCL
    process group started from an in-process store and make_mesh over it,
    so every parameter is a DTensor and attention runs as a local_map
    island, as on a larger world. (a) The recipe on tpu-3b at full width
    and depth through make_train_fns(mesh=...) against the no-mesh
    trainer from the same seed and batch, their 5 steps taken in turns:
    each step's loss and grad_norm within phase 7's bound, the same kernel
    launches, and both step times with their ratio. (b) tpu-7b at full
    width and depth: make_infer_fns' last-position logits against the
    no-mesh forward (phase 3's bound), make_generate_fn(mesh=...) greedy,
    8x512 + 16 tokens, against the no-mesh generator (equal streams, or
    the first difference at a near-tie as phase 8 holds spec decoding),
    and the prefill and decode-step times of both, taken in turns. (c)
    The dispatch under the mesh at the prefill's attention shapes:
    sharded_local launches B1 on TMA-readable local shards and equals
    flash_attention; ring (seq=1) equals plain attention within phase 3's
    bound. (d) mixtral-8x7b at full width and 4 layers on a mesh whose
    one dim is ``expert`` (the stacked experts sharded over it): two
    recipe steps against two no-mesh steps, as (a), one model at a time.
13. Pipeline parallelism on tpu-3b's recipe blocks (bf16 weights,
    adafactor(3e-4), seeded random weights; the embedding and the
    unembedding outside the stages, the last stage's loss the chunked
    cross-entropy against the unembedding). (a) The in-process MPMD
    trainer (train/mpmd.py): 12 of the 24 blocks (PIPELINE_LAYERS) in 2
    stages of 6, 4 microbatches of 1 x 1024 (phase 7's 4096 tokens per
    step), 1F1B, 3 steps: step 1's loss against the same blocks run one
    after another (phase 5's loss bound), each step launching B1 96
    times (forward and the backward's recompute) and B2 and B3 48 times,
    every stage program at one input
    shape; the step time, per-stage compute, host time, measured and
    analytic bubble, peak memory, the replay budget, the ratio to phase
    7's step and the trainer's StepProfiler record (runtime_mpmd_mfu) are
    printed. (b) The same with stage 1 killed in step 3's
    first forward: the recovery (park, rebuild from the step-2 snapshot,
    replay) must land (a)'s state digests bit for bit. (c) 4 virtual
    stages of 3 blocks interleaved on 2 hosts against the plain 4-stage
    pipeline, 2 steps: bit-identical digests. (d) pipeline_apply on a
    mesh whose one dim is ``stage`` (world of one, S = 1), 2 blocks, 4
    microbatches: the loss and every gradient bitwise equal to the blocks
    run microbatch by microbatch.
14. The runtime core (ray_tpu_torch.init: the port's GCS, node manager,
    workers and shared-memory store) on the card. (a) init() with no
    resources must detect one GPU, with no torch or CUDA library mapped in
    the GCS or the node manager; a num_gpus=1 task must see
    CUDA_VISIBLE_DEVICES "0" and run B1 at the tpu-7b prefill shape on
    tensors sent from the driver's card, its o and lse back on cuda:0
    within phase 2's bounds of the plain version, its worker's launch
    count risen; two num_gpus=0.5 actors must share id 0 and a num_gpus=1
    task must wait until both are gone. (b) A 1 GiB bf16 tensor through
    put and get from the CPU (read zero-copy: the result's storage lies
    in the arena) and from the card (back on cuda:0), and a CUDA tensor
    returned by a GPU actor: each bitwise equal; the put and get GB/s are
    printed. (c) Phase 13 (a)'s pipeline with remote=True: each stage an
    actor with {"GPU": 0.5}, the weights through the object store; the
    step losses and state digests must equal 13 (a)'s bit for bit, and
    each step's B1/B2/B3 launches, counted in the actor processes and
    summed by the trainer, 96/48/48; the step time, its ratio to 13 (a),
    per-stage compute and each actor's peak memory are printed. (d) The
    same with stage 1's actor killed (ray_tpu_torch.kill) during step 3:
    the trainer provisions a new actor, restores it and replays, to (c)'s
    bits. After shutdown no ray_tpu_torch process and no
    /dev/shm/raytpu_torch_* file may remain.
15. Each phase's wall time and the smoke's total, a JSON line of the
    kernels (with each one's TFLOP/s, its share of the bound, whether it
    runs on the tensor cores and its launches on the mesh's, the
    pipeline's, the actors', Serve's, the train worker's, sharded
    serving's, RL's, the compiled DAG's, the client's and Tune's paths),
    the card line again, and last the result. It is printed after phase
    20; each phase also prints its own wall time when it ends.
16. Serve on the card (ray_tpu_torch.serve, on a fresh runtime with a
    64 GiB store: every part's weights fit at once). (a)
    serve.start(http_port=0) and serve.run of an
    LLMDeployment of tpu-7b at full width and depth on a num_gpus=1
    replica (phase 4's engine: 8 slots of 1024, chunk 128, budget 256;
    params_fn phase 3's seeded init on the replica's card): the replica's
    GPU ids must equal its mask "0", params_fn must run once and publish
    the weights into the store; the replica's start, the publish and the
    time to the first answer over HTTP are printed. (b) Phase 4's six
    requests at once, over HTTP (streamed NDJSON read by urllib) and over
    a streaming handle, then through the in-process engine on the same
    mix: each stream held against a one-shot forward as in phase 4; TTFT
    and TPOT per request as each client saw them, and the replica's
    serve_llm_ttft_ms and serve_llm_tpot_ms from the /metrics aggregate.
    (c) Two replicas at num_gpus 0.5 built together, tpu-7b's width cut
    to 8 layers in fp32 (a resumed stream re-prefills the tokens already
    delivered, and a bf16 random model's logits tie): one runs params_fn
    and publishes, the other reads the weights from the store; params_fn
    must have run once. (d) ServeReplicaKiller kills the busy one of them
    mid-stream: the stream resumes on the survivor and must equal an
    uninterrupted stream, and is held against a one-shot forward. (e)
    build_disagg_app with one prefill and one decode replica at num_gpus
    0.5 (8 layers, bf16): a 512-token prompt is prefilled on the prefill
    tier and its bf16 spans cross the store into the decode tier, whose
    greedy tokens must equal a colocated LLMDeployment's; the span bytes
    and dtypes and the hand-off are printed. Before serve.shutdown(),
    timeline() must hold the replicas' engine spans (engine.slot,
    engine.decode) and the proxy's proxy.request spans, which are printed
    with runtime_decode_step_mfu from the /metrics aggregate. (f)
    serve.shutdown() and shutdown() must leave no process or arena of the
    session. Engines attend through the cache: phase 16 launches no flash
    kernel, in the smoke's own process or in a replica.
17. The train executor on the card (ray_tpu_torch.train, on a fresh
    runtime). (a) TorchTrainer with one num_gpus=1 worker whose loop is
    phase 7's recipe on tpu-3b at full width and depth (the same seeds and
    batch) through make_train_fns(profiler=train.step_profiler()), 5 steps:
    the worker's GPU ids and mask must be "0", each step's loss and
    grad_norm bit for bit phase 7's, its launches 48/24/24, and the
    profiler's runtime_train_step_mfu, _mfu_compute and
    _phase_ms{compute,host_gap,data_wait}, read back from the GCS
    time-series plane (util/state.query_metrics), equal to its last
    record; each step's time and its ratio to phase 7's, the peak memory,
    wrap_step's FLOPs beside the model FLOPs and the MFU are printed. (b)
    The recipe cut to 2 layers, a Checkpoint (torch.save of the state) per
    step, the worker exiting once the trainer stored step 2's, and
    FailureConfig(max_failures=1): the gang restarts from the latest
    checkpoint, every step's loss and grad_norm must equal an
    uninterrupted run's in this process, and CheckpointManager must keep
    num_to_keep=2; the recovery time is printed. (c) timeline() must hold
    the train.fit span and train.report instants, the worker's
    train_step.step spans with mfu and compute_ms, and the
    runtime_train_step_mfu counter track. (d) shutdown() must leave no
    process or arena of the session.
18. Sharded serving on the card (ray_tpu_torch.serve.sharded, on a fresh
    runtime), printed after phase 17 and before the kernels line. (a)
    serve.start(http_port=0, grpc_port=0 where grpcio imports) and
    serve.run(build_sharded_app(<tpu-7b's config>, num_hosts=1, ...)) at
    full width, cut to 16 of its 32 layers (which leaves the smoke room
    for phase 20; phase 4's engine, phase 3's seeded init through params_fn
    on the replica's card) on a num_gpus=1 replica whose engine runs in
    lockstep over a one-card DTensor mesh (a world of one rank, NCCL):
    the replica's GPU ids must equal its mask "0", its world and mesh must
    be one rank, params_fn must run once; one token over HTTP (the first
    answer, as phase 16's), then phase 4's six requests at once
    over HTTP and then over a streaming handle, each stream held against
    a one-shot forward; the ready time, TTFT and TPOT per request, the
    replica's engine.decode spans from the timeline and its
    last_stream_digest are printed. (c) Where grpcio imports, a generate
    through the gRPC proxy's untyped ingress (serve.grpc_call) must give
    the tokens of the same generate over a handle; where it does not, (c)
    is left out and the smoke says so. The longest heartbeat silence is
    printed, and after shutdown() no process or arena of the session may
    remain. (b) Phase 4's requests through InferenceEngine() and then
    InferenceEngine(mesh=<one-card mesh>) on the same model in this
    process: the tokens must be equal. Phase 18 launches no flash kernel,
    in the replica or in this process (sharded_serve_launches 0/0/0).
19. RL on the card (ray_tpu_torch.rl), printed after phase 18 and before
    the kernels line. (a) The gymnasium version (or that it is not
    installed) and the card line. (b) Each learner's update on the card
    held against the same update on the CPU, from the same seeded weights
    and batch in fp32 (TF32 off): PPO's whole update_from_batch at the
    CartPole config (6 epochs x 4 minibatches of 128, the (64, 64) net),
    IMPALA's and APPO's update_from_trajectory with the LSTM and the conv
    net, 8 DQN steps on prioritized minibatches, 8 SAC steps with the
    normal draws given to both, and one BC train(): the largest weight
    difference of each must be within RL_WEIGHT_TOL, and each update's
    first call on both devices is printed; then, warm, each run's time
    on the card, its ms per minibatch update, its FLOPs (count_flops) and
    their share of the fp32 peak, PPO's runtime_rl_update_mfu and the
    device's busy share of a profiled run. (c) Where gymnasium imports, on a
    fresh runtime: PPO on CartPole-v1 with two CPU env-runner actors
    (4 envs x 64 steps each) and the learner on the card must reach an
    episode_return_mean of 150 within 40 iterations (the JAX package's
    own gate, tests/test_rl_regression.py); per iteration the sample
    time, the learn time, env steps/s, the learner's ms per minibatch,
    runtime_rl_update_mfu and (on every other iteration, under
    torch.profiler) the device's busy share of the learn window are
    printed. Then one APPO iteration with use_lstm=True on
    ray_tpu_torch/RepeatAfterMe-v0 and one SAC iteration on Pendulum-v1,
    with the same figures. RL launches no flash kernel (rl_launches
    0/0/0); after shutdown() no process or arena of the session may
    remain; the phase's wall time is printed. Without gymnasium (c) is
    left out and the smoke says so.
20. The compiled DAG, client mode and Tune on the card (ray_tpu_torch.dag,
    .client, .tune), printed after phase 19 and before the kernels line.
    (a) On a fresh runtime, two stage actors at num_gpus 0.5 started
    together, holding an 8-block cut of tpu-3b at full width (phase 13's
    bf16 weights and seed): stage 0 the embedding and blocks 0-3, stage 1
    blocks 4-7, the final norm and the head on the last position (fp32
    logits). InputNode -> s0.forward.bind -> s1.forward.bind, compiled
    with a 16 MiB buffer (the pickled B=2, L=1024 bf16 activations are 12
    MiB); 10 executes on seeded token batches, each output bit for bit
    the driver's in-process forward of the same stages; each execute's
    time (median and spread), each hop (pickle, channel write and read,
    unpickle) against each stage's compute, what crosses each edge (a
    host int64 batch, a CUDA bf16 activation, CUDA fp32 logits) and its
    pickled size; the same chain through .remote(); a one-actor Echo DAG's
    round trip on a small int against .remote(). The B1 launches counted
    in the actors must be 8 per execute; teardown must see each actor loop
    return "closed" and leave no channel file. (b) With (a)'s runtime shut
    down, a host subprocess starts the port's runtime with the card and
    serve_proxy(), which must listen on 127.0.0.1; this process connects
    with init("ray://...") and holds no runtime; through the proxy a num_gpus=1 actor (mask "0") builds the
    same cut, and its forward of (a)'s first batch must equal (a)'s output
    bit for bit (8 B1 launches); a 64 MiB numpy array is put and got back
    bitwise equal (MB/s printed); the host then shuts down, and no process
    or /dev/shm file of its session may remain. (c) On a fresh runtime, a
    Tuner over 4 trials (lr a grid of 4, resources_per_trial {"CPU": 1,
    "GPU": 0.25}, max_concurrent_trials 4) under ASHA (loss, min, max_t 4,
    grace_period 1, reduction_factor 2); each trial takes phase 6's
    fp32-AdamW step on a 2-block cut of tpu-3b at full width at B=2,
    L=1024 and reports its loss every step: every trial's mask must be
    "0", ASHA's decisions must equal the same scheduler replayed in this
    process on the reported results, and the best trial's losses must
    equal, bit for bit, its configuration's steps run in this process;
    each trial's steps, step times and peak memory, ASHA's first STOP
    beside the step whose poll brought it (the tuner kills the trial's
    actor there, unless its steps were all done by then), the fit's
    wall time and the trials' B1/B2/B3 launches (2/2/2 a step) are
    printed. (d) The versions of pyarrow and pandas, or that they are not
    installed.
21. Cluster services on the card (ray_tpu_torch.scripts.cli,
    .job_submission, .dashboard, .autoscaler, train.sharded_checkpoint,
    serve.weights.checkpoint_weight_source, data); every CLI call is a
    process with the repo on its path and a TMPDIR of its own. (a) `cli
    start --head --dashboard` (the dashboard on 127.0.0.1, a free port; a
    16 GiB store); phase 7's token batch, once per step, is written as
    12 rows of 1025 int32 tokens to a Parquet file; `cli submit --wait`
    of a job whose driver passes data.read_parquet of that file as
    TorchTrainer(datasets={"train": ...}) and runs phase 17's recipe
    loop (tpu-3b at full width and depth, bf16, adafactor(3e-4), remat
    "dots", phase 7's seeds) for 3 steps with one num_gpus=1 worker, each
    step's batch taken from get_dataset_shard("train").iter_torch_batches
    (batch_size=4, device="cuda", dtypes=torch.int64), the last step
    saving the parameters with save_sharded: the job must end SUCCEEDED
    through JobSubmissionClient, GET /api/jobs and `cli list jobs`, its
    report must reach get_job_logs, each batch must be phase 7's batch as
    int64 on cuda:0, its 3 losses must equal phase 7's bit for bit, and
    each step must launch B1/B2/B3 48/24/24 times; the head's start, the
    worker's start, the step times, each step's data_wait (the step
    profiler) and the checkpoint's size and write rate are printed. (b) `cli serve
    deploy` of a YAML naming an LLMDeployment of tpu-3b on a num_gpus=1
    replica whose params_fn is checkpoint_weight_source of (a)'s
    checkpoint: the parameters the replica restored must have the digest
    the job's worker saved; 4 greedy requests at once over HTTP are each
    held against a one-shot forward of the same checkpoint in this
    process (phase 16's hold, NEAR_TIE_GAP); `cli serve status` must show
    the application; after `cli serve delete` and `cli stop` no process
    or /dev/shm file of the session may remain. The replica's time to
    ready (its worker's start, the checkpoint's read and publish, in
    GB/s) and each request's TTFT and TPOT are printed. (c) `cli up
    --block` on a fake-provider YAML whose head offers no GPU and whose
    one node type, gpu_worker, declares {"CPU": 1, "GPU": 1} (min 0, max
    1, idle timeout 5 s): a num_gpus=1 task, the forward of the recipe's
    first 2 blocks at full width on B=1, L=1024 with phase 13's seed
    (weights made in the task), pends until the autoscaler launches the
    node, must equal the same forward here bit for bit and launch B1
    twice; the node must be removed once idle, and after `cli down` no
    process or /dev/shm file of the session may remain. The times from
    the submit to the node's start, the task's start and the node's
    removal are printed, and the phase's wall time; the job's worker and
    the autoscaled task count their launches (``cluster_launches``).
22. Data into the card (ray_tpu_torch.data), last before the kernels
    line, in this process's runtime with an 8 GiB store: 1 GiB of token
    rows (262,144 rows of 1025 int32 tokens from a numpy seed) in 64
    Parquet files go through read_parquet, map_batches (each row split
    into inputs and targets shifted by one), random_shuffle(seed=22) and
    iter_torch_batches(batch_size=256, dtypes=torch.int64) three times:
    (a) on the card with a stand-in step (a fixed fp32 matmul chain of
    ~5 ms, waited for) after each batch, (b) on the card without one, (c)
    on the CPU. Every batch must be int64 (256, 1024) on cuda:0 (on the
    CPU in (c)) with its targets its inputs shifted by one; every row
    must arrive once (the sorted row hashes equal the files'); the order
    must be the same in all three runs batch by batch (a position-
    weighted hash of each batch, and three batches element for element);
    no process or /dev/shm file of the session may remain after
    shutdown. Each run's rows/s, GB/s into the card, median, p99 and
    longest wait per batch and its stages' execution stats are printed,
    and the store's spill, restore and eviction counts. No kernel runs.

The serving model is freed before the training phases and built again
(from the same seed) for phase 8; each MoE phase builds its own model.
Launch counts are zeroed just before each main-path phase (3, 4, 6, 7, 8,
9, 10, 12, each part of 13, 16 (b), 18 (b), 19 (c)) and read just after
it; phase 14's stage actors, phase 17's and 21's train workers, phase
20's actors and trials and phase 21's autoscaled task are fresh processes
whose counts start at 0 (phase 20
(a) zeroes its stages' counts again just before it compiles the DAG, and
a trial counts each step's launches itself), and the trainer (the loop)
sums what each reports per step; launches made to compare or time a
kernel (2, 5, the remat checks of 7 and 10, 11, phase 12's no-mesh
generator and its dispatch check) do not count. Phase 12's no-mesh
trainers are the steps its mesh steps are held to, and count; so do phase
13 (d)'s blocks run one after another.
"""

import contextlib
import dataclasses
import functools
import gc
import glob
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# bf16 kernel output against the plain version: o is stored in bf16 (one
# ulp is 2**-7 near 1, 2**-6 near 2-4) and p is rounded to bf16 against the
# running max in the kernel, the final max in the plain version
BF16_TOL = 2e-2
# fp32: the bound the JAX package holds its own Pallas kernel to
# (tests/test_model_parallel.py); lse is fp32 in every dtype
FP32_TOL = 2e-3
# tpu-7b prefill logits, kernel path vs plain attention (mha_reference),
# relative L2 error: the plain attention rounds its scores to bf16
# (2**-9 relative on scores of size ~10 moves probabilities by ~2%), and
# 32 bf16 layers add a few ulps each
LOGITS_REL_TOL = 5e-2
# engine greedy tokens against a one-shot (teacher-forced) forward: the
# engine's token must be the one-shot argmax or within this many logit
# units of it. The two paths attend differently (fp32 cached attention vs
# the kernel's bf16 p), and each logit may move by about the 0.125 max abs
# difference measured kernel vs plain attention on tpu-7b prefill logits
# (H100 80GB HBM3, 700 W); two logits moving apart give twice that, with
# room for decode's longer caches. A wrong slot, position or cache write
# picks a token several units (logits spread ~6) below the argmax.
NEAR_TIE_GAP = 0.5

# B2/B3 in bf16 against their plain version, relative L2 error of each
# gradient: dq/dk/dv are stored in bf16 (a relative step of up to 2**-8)
# and ds is rounded to bf16 from fp32 values that differ in their last
# bits between the two, so an elementwise bound would have to grow with L
BWD_BF16_REL_L2 = 1e-2
# phase 5, one training step at tpu-3b width through the kernels against
# one through plain attention (mha_reference under autograd), same weights
# and batch. The plain attention rounds its scores to bf16 before the
# softmax and the kernels keep them in fp32, as in the prefill-logits check
# above, so the two differ as bf16 paths do: the loss (~10.4 = ln 32000 at
# random init, a mean over 4096 positions) to 1e-2 absolute; grad_norm and
# each parameter's gradient to a relative L2 error of 5e-2, the bound held
# on the prefill logits above (LOGITS_REL_TOL). A one-off fp32-compute run
# of the same step (H100 80GB HBM3, 700 W) put the largest gradient rel L2
# of the kernel path at 3.01e-2 from it and that of plain attention at
# 3.32e-2: the two bf16 paths differ far less from each other than either
# does from fp32
TRAIN_LOSS_TOL = 1e-2
TRAIN_GRAD_REL_L2 = 5e-2
# phase 6: memorising one batch, the loss after 5 steps must be below the
# first by this much, the margin the JAX package asserts for its own train
# step (tests/test_model_parallel.py)
LOSS_DROP = 0.1
# phase 7's 4-layer check: remat "dots" recomputes what remat off kept, by
# the same kernels and GEMMs on the same inputs, so the loss and every
# gradient agree to this relative L2 error (bitwise equality is printed)
RECIPE_REMAT_REL_L2 = 1e-3
# phase 8 (c): the verify forward's GEMMs have k+1 times the rows of a
# decode step's and may take another cuBLAS algorithm, moving a bf16 logit
# in its last bit: a spec-on stream may leave the spec-off one only where
# the spec-off logits' top two are within this share of the top logit, and
# in at most SPEC_MAX_DIFFERING of the streams
SPEC_NEAR_TIE = 1e-2
SPEC_MAX_DIFFERING = 1
# a self-draft proposes with the decode step's numbers: near-ties aside it
# is always accepted
SELF_DRAFT_MIN_ACCEPT = 0.9
# phase 19 (b): an RL learner's weights after its update on the card
# against the same update on the CPU, fp32 with TF32 off. The two devices
# sum the same products in another order (~1e-7 relative), and Adam
# divides each step by sqrt(v): where a gradient is at that rounding
# level its step can move by up to the learning rate (1e-3 at most here)
# times the rounding's share of the gradient, so a weight moves by far
# less than 1e-4 over the few steps held. The CPU tests hold the same
# updates to JAX's at 2e-5 (tests/test_torch_rl_learners.py)
RL_WEIGHT_TOL = 1e-4
# phase 19 (c): the JAX package's own PPO gate on CartPole-v1
# (tests/test_rl_regression.py::test_ppo_cartpole_threshold)
RL_GATE_RETURN = 150.0
RL_GATE_ITERS = 40

# every kernel's bf16 instantiation must run on the tensor cores, fed by TMA
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# rounds of kernel, library, library, kernel when a kernel is timed beside
# its library call
TURN_ROUNDS = 5

H100_BF16_FLOPS = 989.4e12  # dense tensor-core peak, H100 SXM data sheet
H100_FP32_FLOPS = 67e12    # fp32 outside the tensor cores
H100_BYTES_S = 3.35e12     # HBM3


def sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def median_spread(times):
    times = sorted(times)
    return float(np.median(times)), times[0], times[-1]


def time_in_turns(kernel, library, rounds=TURN_ROUNDS):
    """Kernel and library call timed alternately (kernel, library, library,
    kernel) for `rounds` rounds, so that a drift of the card's clocks or
    of the allocator hits both alike. Returns (median, min, max) of each."""
    ks, ls = [], []
    for _ in range(rounds):
        ks.append(cuda_ms(kernel))
        ls.append(cuda_ms(library))
        ls.append(cuda_ms(library))
        ks.append(cuda_ms(kernel))
    return median_spread(ks), median_spread(ls)


def fmt_turns(kernel, library):
    (km, klo, khi), (lm, llo, lhi) = kernel, library
    return (f"kernel {km:.4f} ms [{klo:.4f}, {khi:.4f}], library {lm:.4f} ms "
            f"[{llo:.4f}, {lhi:.4f}] (median [min, max] of {2 * TURN_ROUNDS} "
            f"in turns), kernel/library {km / lm:.2f}x")


def find_cuobjdump():
    found = shutil.which("cuobjdump")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "cuobjdump")
    if os.path.exists(path):
        return path
    fail("cuobjdump not found on PATH or in $CUDA_HOME/bin: the SASS check "
         "of the tensor-core kernels cannot run")


def sass_check(built):
    """Phase 1: per kernel function of each library, whether its SASS holds
    HGMMA (wgmma), UTMALDG (TMA load) and UTMASTG (TMA store). Fails if a
    bf16 (tensor-core) function of B1, B2 or B3 lacks HGMMA or UTMALDG.
    Returns {kernel: True if any of its functions runs on the tensor
    cores}."""
    tool = find_cuobjdump()
    tensor_cores = {}
    for name, (path, _) in built.items():
        sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        found, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :", 1)[1].strip()
                found[fn] = set()
            elif fn is not None:
                found[fn].update(op for op in ("HGMMA", "UTMALDG", "UTMASTG")
                                 if op in line)
        if not found:
            fail(f"cuobjdump found no kernel function in {path}")
        for fn, ops_found in sorted(found.items()):
            tc = "_tc_kernel" in fn
            print(f"sass {name}: {'bf16 wgmma+TMA' if tc else 'FMA'} function "
                  f"{fn}: " + ", ".join(
                      f"{op} {'yes' if op in ops_found else 'no'}"
                      for op in ("HGMMA", "UTMALDG", "UTMASTG")), flush=True)
            if tc and not {"HGMMA", "UTMALDG"} <= ops_found:
                fail(f"{name}: the bf16 function {fn} lacks HGMMA or UTMALDG")
        tensor_cores[name] = any("HGMMA" in f for f in found.values())
    for name in KERNELS:
        if not tensor_cores.get(name):
            fail(f"{name}: no function on the tensor cores")
    return tensor_cores


def kept_pairs(q, k, causal):
    """(query, key) pairs the mask keeps, over batch and query heads."""
    B, Lq, H, _ = q.shape
    Lk = k.shape[1]
    if causal:
        rows = torch.arange(Lq, dtype=torch.float64)
        return B * H * float(torch.clamp(rows + 1, max=Lk).sum())
    return float(B * H * Lq * Lk)


def roofline_ms(flops, nbytes, dtype):
    """Least time on the card: the larger of the operations over the peak
    rate of their type and the bytes over the memory rate."""
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def attention_work(q, k, causal):
    """Forward: (FLOPs, bytes): q, k, v read and o written once (+ fp32
    lse), against 4*D FLOPs (two products) per kept pair."""
    B, Lq, H, D = q.shape
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
        + B * H * Lq * 4
    return 4.0 * D * kept_pairs(q, k, causal), nbytes


def bwd_work(q, k, causal, kernel):
    """Backward kernels: (FLOPs, bytes): each input read once and each
    output written once (dQ: q, k, v, dO in, dq out; dK/dV: q, k, v, dO in,
    dk, dv out; both read the fp32 lse and delta), against 2*D FLOPs per
    product per kept pair: three products for dQ (s, dp, dq), four for
    dK/dV (s, dp, dv, dk)."""
    B, Lq, H, D = q.shape
    q_n, k_n = q.numel(), k.numel()
    elems = 3 * q_n + 2 * k_n if kernel == "flash_bwd_dq" \
        else 2 * q_n + 4 * k_n
    products = 3 if kernel == "flash_bwd_dq" else 4
    nbytes = elems * q.element_size() + 2 * B * H * Lq * 4
    return 2.0 * D * products * kept_pairs(q, k, causal), nbytes


def moe_capacity(cfg, L):
    """An expert layer's slots per expert for L tokens (the package is
    imported once the card is found)."""
    from ray_tpu_torch.models.moe import capacity
    return capacity(cfg, L)


def rates(flops, bound_ms, ms):
    """The record's achieved TFLOP/s and share of the bound."""
    return {"tflops": flops / (ms * 1e-3) / 1e12, "bound_share": bound_ms / ms}


def wrappers(ops):
    return {"flash_fwd": ops.flash_attention_fwd,
            "flash_bwd_dq": ops.flash_attention_bwd_dq,
            "flash_bwd_dkv": ops.flash_attention_bwd_dkv}


def zero_counts(ops):
    for fn in wrappers(ops).values():
        fn.launches = 0


def read_counts(ops):
    return {name: fn.launches for name, fn in wrappers(ops).items()}


# the tensor-core tiling's edges, run by the forward and the backward
# checks: a length that is a multiple of 64 but not of 128, one shorter
# than a tile, Lq != Lk across a 128-row boundary both ways, G in {1, 3,
# 4}, and q, k, v as strided views of one fused [B, L, H + 2 Hkv, D]
# projection ("fused" cases, Lq == Lk)
EDGE_CASES = [  # name, B, Lq, Lk, H, Hkv, D, dtype, causal
    ("L=192", 2, 192, 192, 24, 8, 128, torch.bfloat16, True),
    ("L=17 G=3", 2, 17, 17, 12, 4, 64, torch.bfloat16, True),
    ("Lq=129 Lk=257 causal G=4", 2, 129, 257, 16, 4, 128, torch.bfloat16,
     True),
    ("Lq=129 Lk=257 non-causal G=1", 2, 129, 257, 8, 8, 64, torch.bfloat16,
     False),
    ("Lq=257 Lk=129 causal G=3", 2, 257, 129, 12, 4, 128, torch.bfloat16,
     True),
    ("Lq=257 Lk=129 non-causal G=4", 2, 257, 129, 16, 4, 64,
     torch.bfloat16, False),
    ("fused qkv view G=3", 2, 256, 256, 24, 8, 128, torch.bfloat16, True),
    ("fused qkv view D=64 G=1", 1, 130, 130, 8, 8, 64, torch.bfloat16,
     False),
]


def case_inputs(g, name, B, Lq, Lk, H, Hkv, D, dtype):
    """q, k, v on the card, seeded; for a "fused" case, views of one
    [B, L, H + 2 Hkv, D] tensor, as a fused QKV projection gives them."""
    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.float32).to(dtype)
    if name.startswith("fused"):
        qkv = rand(B, Lq, H + 2 * Hkv, D)
        return qkv[:, :, :H], qkv[:, :, H:H + Hkv], qkv[:, :, H + Hkv:]
    return rand(B, Lq, H, D), rand(B, Lk, Hkv, D), rand(B, Lk, Hkv, D)


def check_tma_refusal(ops):
    """A bf16 operand whose head stride is not a multiple of 16 bytes (a
    view of [..., 130] storage) must raise ValueError before any launch."""
    q = torch.zeros(2, 64, 8, 130, device="cuda", dtype=torch.bfloat16)
    q = q[..., :128]
    k = torch.zeros(2, 64, 2, 128, device="cuda", dtype=torch.bfloat16)
    lse = torch.zeros(2, 8, 64, device="cuda")
    before = read_counts(ops)
    for name, call in (
            ("flash_fwd", lambda: ops.flash_attention_fwd(q, k, k, True)),
            ("flash_bwd_dq", lambda: ops.flash_attention_bwd_dq(
                q, k, k, q.contiguous(), lse, lse, True)),
            ("flash_bwd_dkv", lambda: ops.flash_attention_bwd_dkv(
                q, k, k, q.contiguous(), lse, lse, True))):
        try:
            call()
        except ValueError as e:
            print(f"{name}: a head stride of 260 bytes is refused: {e}",
                  flush=True)
        else:
            fail(f"{name} took a view that breaks TMA's 16-byte rule")
    if read_counts(ops) != before:
        fail("a refused call launched a kernel")


def check_flash_kernel(ops, tensor_cores):
    """Phase 2: kernel vs plain version on the card, at the shapes of both
    main paths (tpu-7b prefill, tpu-3b training) and edge shapes; timing
    at the tpu-7b prefill shape, in turns with SDPA. Returns the kernel's
    record (without launches)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [  # name, B, Lq, Lk, H, Hkv, D, dtype, causal
        ("tpu-7b prefill", 8, 512, 512, 32, 8, 128, torch.bfloat16, True),
        ("tpu-3b training", 4, 1024, 1024, 24, 8, 128, torch.bfloat16,
         True),
        ("llama-1b prefill", 8, 512, 512, 32, 8, 64, torch.bfloat16, True),
        ("ragged L=200", 2, 200, 200, 32, 8, 128, torch.bfloat16, True),
        ("Lq<Lk causal", 2, 130, 300, 32, 8, 128, torch.bfloat16, True),
        ("Lq>Lk causal", 2, 300, 130, 32, 8, 64, torch.bfloat16, True),
        ("Lq<Lk non-causal", 2, 130, 300, 32, 8, 128, torch.bfloat16,
         False),
        ("fp32 ragged", 2, 200, 200, 8, 2, 128, torch.float32, True),
        ("fp32 Lq>Lk non-causal", 2, 300, 130, 8, 2, 64, torch.float32,
         False),
    ] + EDGE_CASES
    record = None
    for name, B, Lq, Lk, H, Hkv, D, dtype, causal in cases:
        q, k, v = case_inputs(g, name, B, Lq, Lk, H, Hkv, D, dtype)
        before = ops.flash_attention_fwd.launches
        o, lse = ops.flash_attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        if ops.flash_attention_fwd.launches != before + 1:
            fail(f"flash_fwd {name}: the launch counter did not move")
        ro, rlse = ops.flash_attention_fwd_reference(q, k, v, causal)
        tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        err_o = (o.float() - ro.float()).abs().max().item()
        err_lse = (lse - rlse).abs().max().item()
        ok = torch.allclose(o.float(), ro.float(), rtol=tol, atol=tol) and \
            torch.allclose(lse, rlse, rtol=FP32_TOL, atol=FP32_TOL)
        print(f"flash_fwd {name}: B={B} Lq={Lq} Lk={Lk} H={H} Hkv={Hkv} "
              f"D={D} {dtype} causal={causal}: max|o-plain|={err_o:.3e} "
              f"max|lse-plain|={err_lse:.3e} (tol {tol:g}/{FP32_TOL:g}) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok or not torch.isfinite(o.float()).all():
            fail(f"flash_fwd {name} disagrees with its plain version")
        if record is None:   # the main path's shape: time it
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            kern, lib = time_in_turns(
                lambda: ops.flash_attention_fwd(q, k, v, causal), sdpa)
            plain_ms = cuda_ms(
                lambda: ops.flash_attention_fwd_reference(q, k, v, causal))
            sdpa_err = (sdpa().transpose(1, 2).float() - ro.float()
                        ).abs().max().item()
            flops, nbytes = attention_work(q, k, causal)
            bound_ms, bound_by = roofline_ms(flops, nbytes, q.dtype)
            print(f"flash_fwd {name} timing: {fmt_turns(kern, lib)}; plain "
                  f"{plain_ms:.4f} ms; max|sdpa-plain|={sdpa_err:.3e}; bound "
                  f"{bound_ms:.4f} ms by {bound_by}", flush=True)
            record = {"name": "flash_fwd", "route": "cuda",
                      "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
                      "replaces": "ray_tpu/ops/attention.py:54",
                      "max_abs_err": err_o, "ms": kern[0],
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": lib[0],
                      **rates(flops, bound_ms, kern[0]),
                      "tensor_cores": tensor_cores["flash_fwd"]}
        del q, k, v, o, lse, ro, rlse
    check_tma_refusal(ops)
    torch.cuda.empty_cache()
    return record


def rel_l2(got, want):
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


def check_bwd_kernels(ops, tensor_cores):
    """Phase 2, backward: the dQ and dK/dV kernels against their plain
    version on the card, on the forward kernel's o and lse (each held to
    the plain forward's first); timing at the tpu-3b training shape.
    Returns the two kernels' records (without launches)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    cases = [  # name, B, Lq, Lk, H, Hkv, D, dtype, causal
        ("tpu-3b training", 4, 1024, 1024, 24, 8, 128, torch.bfloat16,
         True),
        ("D=64 GQA 32/8", 2, 512, 512, 32, 8, 64, torch.bfloat16, True),
        ("ragged L=200", 2, 200, 200, 24, 8, 128, torch.bfloat16, True),
        ("Lq<Lk causal", 2, 130, 300, 24, 8, 128, torch.bfloat16, True),
        ("Lq>Lk causal", 2, 300, 130, 32, 8, 64, torch.bfloat16, True),
        ("Lq<Lk non-causal", 2, 130, 300, 24, 8, 128, torch.bfloat16,
         False),
        ("Lq>Lk non-causal", 2, 300, 130, 8, 2, 64, torch.bfloat16, False),
        ("fp32 ragged", 2, 200, 200, 8, 2, 128, torch.float32, True),
        ("fp32 Lq<Lk causal", 1, 130, 300, 4, 1, 64, torch.float32, True),
        ("fp32 Lq>Lk non-causal", 2, 300, 130, 8, 2, 64, torch.float32,
         False),
    ] + EDGE_CASES
    records = None
    for name, B, Lq, Lk, H, Hkv, D, dtype, causal in cases:
        q, k, v = case_inputs(g, name, B, Lq, Lk, H, Hkv, D, dtype)
        do = torch.randn((B, Lq, H, D), generator=g, device="cuda",
                         dtype=torch.float32).to(dtype)
        o, lse = ops.flash_attention_fwd(q, k, v, causal)
        # the backward reads the forward kernel's o and lse: hold them to
        # their plain version first, so that both backwards are given right
        # inputs
        ro, rlse = ops.flash_attention_fwd_reference(q, k, v, causal)
        tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        if not (torch.allclose(o.float(), ro.float(), rtol=tol, atol=tol)
                and torch.allclose(lse, rlse, rtol=FP32_TOL, atol=FP32_TOL)):
            fail(f"flash_fwd {name}: o or lse disagrees with its plain "
                 f"version (max |o-plain| "
                 f"{(o.float() - ro.float()).abs().max().item():.3e}, "
                 f"max |lse-plain| {(lse - rlse).abs().max().item():.3e})")
        del ro, rlse
        before = read_counts(ops)
        got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        after = read_counts(ops)
        for kernel in KERNELS[1:]:
            if after[kernel] != before[kernel] + 1:
                fail(f"{kernel} {name}: the launch counter did not move")
        want = ops.flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
        errs = [(got_i.float() - want_i.float()).abs().max().item()
                for got_i, want_i in zip(got, want)]
        rels = [rel_l2(got_i, want_i) for got_i, want_i in zip(got, want)]
        if dtype == torch.float32:
            ok = all(torch.allclose(got_i, want_i, rtol=FP32_TOL,
                                    atol=FP32_TOL)
                     for got_i, want_i in zip(got, want))
            tol = f"rtol=atol={FP32_TOL:g}"
        else:
            ok = max(rels) <= BWD_BF16_REL_L2
            tol = f"rel L2 {BWD_BF16_REL_L2:g}"
        ok = ok and all(torch.isfinite(x.float()).all() for x in got)
        print(f"flash_bwd {name}: B={B} Lq={Lq} Lk={Lk} H={H} Hkv={Hkv} "
              f"D={D} {dtype} causal={causal}: max|d-plain| dq/dk/dv "
              f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}, rel L2 "
              f"{rels[0]:.3e}/{rels[1]:.3e}/{rels[2]:.3e} ({tol}) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"flash_bwd {name} disagrees with its plain version")
        if records is None:   # the training path's shape: time it
            records = time_bwd_kernels(ops, q, k, v, o, lse, do, causal,
                                       errs, tensor_cores)
        del q, k, v, do, o, lse, got, want
    torch.cuda.empty_cache()
    return records


def time_bwd_kernels(ops, q, k, v, o, lse, do, causal, errs, tensor_cores):
    """B2 and B3 each timed in turns with PyTorch's backward of
    scaled_dot_product_attention (dq, dk and dv in one call, so the same
    library call stands beside both), their plain versions and bounds; B1
    at this shape too, in turns with SDPA's forward."""
    delta = ops._delta(o, do)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    dot = do.transpose(1, 2)

    def sdpa_bwd():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
    turns = {
        "flash_bwd_dq": time_in_turns(lambda: ops.flash_attention_bwd_dq(
            q, k, v, do, lse, delta, causal), sdpa_bwd),
        "flash_bwd_dkv": time_in_turns(lambda: ops.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, causal), sdpa_bwd),
    }
    plain_ms = {
        "flash_bwd_dq": cuda_ms(lambda: ops.flash_attention_bwd_dq_reference(
            q, k, v, do, lse, delta, causal)),
        "flash_bwd_dkv": cuda_ms(
            lambda: ops.flash_attention_bwd_dkv_reference(
                q, k, v, do, lse, delta, causal)),
    }
    want = ops.flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    sdpa_rel = [rel_l2(x.transpose(1, 2), w)
                for x, w in zip(sdpa_bwd(), want)]
    fwd = time_in_turns(
        lambda: ops.flash_attention_fwd(q, k, v, causal),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt.detach(), kt.detach(), vt.detach(), is_causal=causal,
            enable_gqa=True))
    fwd_plain_ms = cuda_ms(
        lambda: ops.flash_attention_fwd_reference(q, k, v, causal))
    fwd_flops, fwd_bytes = attention_work(q, k, causal)
    fwd_bound, fwd_by = roofline_ms(fwd_flops, fwd_bytes, q.dtype)
    print(f"flash_fwd at the tpu-3b training shape: {fmt_turns(*fwd)}, "
          f"{fwd_flops / (fwd[0][0] * 1e-3) / 1e12:.1f} TFLOP/s; plain "
          f"{fwd_plain_ms:.4f} ms; bound {fwd_bound:.4f} ms by {fwd_by}",
          flush=True)
    print(f"sdpa backward at the tpu-3b training shape: dq, dk and dv in one "
          f"call; rel L2 vs plain dq/dk/dv {sdpa_rel[0]:.3e}/"
          f"{sdpa_rel[1]:.3e}/{sdpa_rel[2]:.3e}", flush=True)
    records = []
    for kernel, src, line, err in (
            ("flash_bwd_dq", "flash_bwd_dq.cu", 94, errs[0]),
            ("flash_bwd_dkv", "flash_bwd_dkv.cu", 129, max(errs[1:]))):
        flops, nbytes = bwd_work(q, k, causal, kernel)
        bound, by = roofline_ms(flops, nbytes, q.dtype)
        kern, lib = turns[kernel]
        print(f"{kernel} tpu-3b training timing: {fmt_turns(kern, lib)} "
              f"(library: sdpa backward), "
              f"{flops / (kern[0] * 1e-3) / 1e12:.1f} TFLOP/s; plain "
              f"{plain_ms[kernel]:.4f} ms; bound {bound:.4f} ms by {by}",
              flush=True)
        records.append({"name": kernel, "route": "cuda",
                        "source": f"ray_tpu_torch/ops/csrc/{src}",
                        "replaces": f"ray_tpu/ops/attention.py:{line}",
                        "max_abs_err": err, "ms": kern[0],
                        "plain_ms": plain_ms[kernel], "bound_ms": bound,
                        "bound_by": by, "library_ms": lib[0],
                        **rates(flops, bound, kern[0]),
                        "tensor_cores": tensor_cores[kernel]})
    return records


def run_generator(models, ops, device="cuda", name="tpu-7b", B=8, P=512,
                  N=32):
    """Phase 3. Returns (model, flash launches during generation). On a
    CPU (a rehearsal at a small size) the kernel is never launched."""
    cfg = models.MODEL_REGISTRY[name]
    model = models.TransformerLM(cfg, device="meta")
    init_fn, gen_fn = models.make_generate_fn(
        model, batch=B, prompt_len=P, max_new_tokens=N, temperature=0.0,
        device=device)
    t0 = time.perf_counter()
    init_fn(torch.Generator(device=device).manual_seed(0))
    sync(device)
    n_params = models.count_params(model)
    print(f"{name}: {n_params / 1e9:.3f} B parameters, init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    tokens = torch.randint(0, cfg.vocab_size, (B, P), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(1))

    zero_counts(ops)                               # main path: generator
    t0 = time.perf_counter()
    out = gen_fn(tokens)
    sync(device)
    gen_s = time.perf_counter() - t0
    counts = read_counts(ops)
    launches = counts["flash_fwd"]
    print(f"generator: {B}x{P} prompt + {N} new tokens in {gen_s:.3f} s "
          f"({B * N / gen_s:.1f} tokens/s incl. prefill), flash_fwd "
          f"launches {launches}", flush=True)
    want_launches = cfg.n_layers if device == "cuda" else 0
    if launches != want_launches:
        fail(f"the prefill launched flash_fwd {launches} times, want "
             f"{want_launches} (one per layer on the card)")
    if counts["flash_bwd_dq"] or counts["flash_bwd_dkv"]:
        fail(f"serving launched backward kernels: {counts}")
    if tuple(out.shape) != (B, N) or int(out.min()) < 0 \
            or int(out.max()) >= cfg.vocab_size:
        fail(f"generator output {tuple(out.shape)} out of range")

    # the same weights through plain attention (mha_reference)
    ref = models.TransformerLM(
        dataclasses.replace(cfg, attention_impl="reference"), device="meta")
    ref.load_state_dict(model.state_dict(), assign=True)
    with torch.inference_mode():
        got = model(tokens, cache=models.init_cache(
            cfg, B, P, device=device))[0][:, -1]
        want = ref(tokens, cache=models.init_cache(
            cfg, B, P, device=device))[0][:, -1]
    got, want = got.float(), want.float()
    rel = ((got - want).norm() / want.norm()).item()
    print(f"prefill logits, kernel vs plain attention: relative L2 "
          f"{rel:.3e} (tol {LOGITS_REL_TOL:g}), max abs "
          f"{(got - want).abs().max().item():.3e}, max |logit| "
          f"{want.abs().max().item():.3e}, last-token argmax agreement "
          f"{(got.argmax(-1) == want.argmax(-1)).float().mean().item():.3f}",
          flush=True)
    if not torch.isfinite(got).all() or rel > LOGITS_REL_TOL:
        fail("prefill logits disagree with plain attention")
    _, ref_gen = models.make_generate_fn(ref, batch=B, prompt_len=P,
                                         max_new_tokens=N, device=device)
    out_ref = ref_gen(tokens)
    agree = (out == out_ref).float().mean().item()
    first_diff = [int((row_a != row_b).nonzero()[0]) if (row_a != row_b)
                  .any() else N for row_a, row_b in zip(out, out_ref)]
    print(f"greedy tokens, kernel vs plain attention (informational, bf16 "
          f"near-ties may flip): agreement {agree:.3f}, first difference "
          f"per row {first_diff}", flush=True)
    del ref, got, want
    return model, launches


def run_engine(model, models, inference, ops, card, device="cuda",
               n_slots=8, max_len=1024, chunk=128, budget=256,
               lens=(100, 230, 370, 480, 610, 700),
               new=(16, 20, 24, 28, 32, 24), hold=True):
    """Phase 4 (and 9, 11). Returns flash launches during the engine's run.
    hold=False leaves out the check against a one-shot forward (an expert
    model at a capacity factor under E/K routes a chunk, a decode step and
    a one-shot forward differently)."""
    from ray_tpu_torch._private import events
    vocab = model.cfg.vocab_size
    cfg = inference.EngineConfig(n_slots=n_slots, max_len=max_len,
                                 prefill_chunk=chunk, prefill_budget=budget,
                                 step_profile=True)
    eng = inference.InferenceEngine(model, cfg, device=device, seed=0)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, vocab, n) for n in lens]

    events.drain()           # this run's engine.decode spans, read below
    zero_counts(ops)                               # main path: engine
    t0 = time.perf_counter()
    handles = [eng.submit(p, max_new_tokens=n)
               for p, n in zip(prompts[:-1], new[:-1])]
    steps = 0
    while handles[0].first_token_t is None:
        eng.step()
        steps += 1
        if steps > 200:
            fail("engine: the first request never started decoding")
    for _ in range(4):            # the last request arrives mid-decode
        eng.step()
        steps += 1
    if handles[0].finish_reason is not None:
        fail("engine: the first request finished before the last arrived")
    handles.append(eng.submit(prompts[-1], max_new_tokens=new[-1]))
    while not all(h.finish_reason for h in handles):
        eng.step()
        steps += 1
        if steps > 400:
            fail("engine: requests did not finish")
    sync(device)
    wall = time.perf_counter() - t0
    counts = read_counts(ops)
    launches = counts["flash_fwd"]
    if counts["flash_bwd_dq"] or counts["flash_bwd_dkv"]:
        fail(f"serving launched backward kernels: {counts}")

    total = 0
    streams = []
    for i, (h, n) in enumerate(zip(handles, new)):
        toks = h.tokens()
        streams.append(toks)
        total += len(toks)
        rate = (len(toks) - 1) / (h.finished_t - h.first_token_t)
        print(f"engine request {i}: prompt {lens[i]}, {len(toks)} tokens, "
              f"finish {h.finish_reason}, TTFT {h.ttft_s * 1e3:.1f} ms, "
              f"decode {rate:.1f} tokens/s", flush=True)
        if len(toks) != n or h.finish_reason != "length" or \
                min(toks) < 0 or max(toks) >= vocab:
            fail(f"engine request {i}: {len(toks)} tokens (want {n}), "
                 f"finish {h.finish_reason}")
    print(f"engine: {len(handles)} requests, {total} tokens in {steps} "
          f"steps, {wall:.3f} s ({total / wall:.1f} tokens/s overall), "
          f"flash_fwd launches {launches} (chunked prefill and decode attend "
          f"through the cache) [{card}]", flush=True)
    decodes = [r["attrs"] for r in events.drain()
               if r.get("name") == "engine.decode"]
    print(f"engine: the decode steps' attribution "
          f"(runtime_decode_step_*, StepProfiler over analytic FLOPs), "
          f"{decode_profile(decodes)} [{card}]", flush=True)

    if hold:
        check_one_shot("engine", model, models, prompts, streams, device)
    return launches


def profile_fields(rec):
    """A StepProfiler record's MFU and phases, for a print."""
    return {k: rec.get(k) for k in ("mfu", "mfu_compute", "compute_ms",
                                    "host_gap_ms", "data_wait_ms",
                                    "tokens_per_s")}


def decode_profile(attrs):
    """median [min, max] of each engine.decode span's attribution."""
    if not attrs:
        fail("the engine recorded no attributed decode step")
    out = []
    for key in ("mfu", "mfu_compute", "compute_ms", "host_gap_ms",
                "data_wait_ms"):
        vals = [a[key] for a in attrs if key in a]
        if vals:
            med, lo, hi = median_spread(vals)
            out.append(f"{key} {med:.6g} [{lo:.6g}, {hi:.6g}]")
    return f"{len(attrs)} steps: " + ", ".join(out)


def check_one_shot(what, model, models, prompts, streams, device):
    """Every greedy engine token against a one-shot forward over the prompt
    and the engine's earlier tokens (logits at position P-1+i predict token
    i): it must be the argmax or within NEAR_TIE_GAP of it."""
    gaps, exact = [], 0
    with torch.inference_mode():
        for prompt, toks in zip(prompts, streams):
            seq = torch.tensor(np.concatenate([prompt, toks[:-1]]),
                               dtype=torch.long, device=device)[None]
            logits = model(seq, cache=models.init_cache(
                model.cfg, 1, seq.shape[1], device=device))[0][0]
            logits = logits[len(prompt) - 1:].float()
            picked = torch.tensor(toks, device=device)
            gap = logits.max(-1).values - logits.gather(
                1, picked[:, None])[:, 0]
            if not torch.isfinite(logits).all():
                fail(f"{what} check: one-shot logits are not finite")
            gaps.append(gap.max().item())
            exact += int((logits.argmax(-1) == picked).sum())
    total = sum(len(t) for t in streams)
    print(f"{what} tokens vs one-shot forward of the same weights: "
          f"{exact}/{total} are its argmax, largest gap below the argmax "
          f"{max(gaps):.3e} (tol {NEAR_TIE_GAP:g}), per request "
          f"{[round(g, 4) for g in gaps]}", flush=True)
    if max(gaps) > NEAR_TIE_GAP:
        fail(f"{what} tokens disagree with a one-shot forward")


def train_fns(models, parallel, cfg, device, B, L, loss_chunk,
              optimizer=None, profiler=None):
    """A tpu-3b-shaped model on the meta device and its trainer: by default
    adamw(3e-4) with optax's other defaults, fp32 master weights and no
    activation recompute (phases 5 and 6, whose numbers PERF.md compares
    across PRs); phase 7 passes its recipe's config and optimizer, phase
    17's train worker also its step profiler."""
    model = models.TransformerLM(cfg, device="meta")
    init_fn, step_fn, _ = parallel.make_train_fns(
        model, optimizer or parallel.adamw(3e-4), batch_shape=(B, L + 1),
        loss_chunk=loss_chunk, device=device, profiler=profiler)
    return model, init_fn, step_fn


def run_train_parity(models, parallel, ops, device="cuda", name="tpu-3b",
                     n_layers=4, B=4, L=1024, loss_chunk=256, optimizer=None,
                     **cfg_kw):
    """Phase 5 (and 11): one training step through the kernels and one
    through plain attention, from the same seeded weights and batch. For
    an expert model the two forwards' routing must be identical.
    ``optimizer`` (adamw(3e-4) by default) does not touch the gradients
    compared; cfg_kw changes the config (phase 11: fp32)."""
    cfg = dataclasses.replace(models.MODEL_REGISTRY[name], n_layers=n_layers,
                              remat=False, **cfg_kw)
    tokens = torch.randint(0, cfg.vocab_size, (B, L + 1), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(2))
    plain = dataclasses.replace(cfg, attention_impl="reference")
    runs = {}
    for impl, run_cfg in (("kernels", cfg), ("plain", plain)):
        model, init_fn, step_fn = train_fns(models, parallel, run_cfg,
                                            device, B, L, loss_chunk,
                                            optimizer)
        state = init_fn(torch.Generator(device=device).manual_seed(0))
        zero_counts(ops)
        with RoutingRecorder(model) as routing:
            _, metrics = step_fn(state, tokens)
        sync(device)
        runs[impl] = (metrics["loss"].item(), metrics["grad_norm"].item(),
                      {n: p.grad for n, p in model.named_parameters()},
                      read_counts(ops), routing)
        del model, state, metrics
    want_launches = n_layers if device == "cuda" else 0
    for impl, (_, _, _, counts, _) in runs.items():
        want = want_launches if impl == "kernels" else 0
        if set(counts.values()) != {want}:
            fail(f"train step through {impl} attention launched {counts}, "
                 f"want {want} of each kernel")

    (loss, gnorm, grads, _, routing), (rloss, rgnorm, rgrads, _, rrouting) = \
        runs["kernels"], runs["plain"]
    if cfg.n_experts:
        agree = routing.agreement(rrouting)
        print(f"train step, {name} width, {n_layers} layers: routing "
              f"decisions equal between kernels and plain attention "
              f"{agree.float().mean().item():.6f} of {agree.numel()}",
              flush=True)
        if not agree.all():
            fail("the kernel training step routed otherwise than plain "
                 "attention")
    rels = sorted(((rel_l2(grads[n], rgrads[n]), n) for n in grads),
                  reverse=True)
    loss_diff, gnorm_rel = abs(loss - rloss), abs(gnorm - rgnorm) / rgnorm
    print(f"train step, {name} width, {n_layers} layers, B={B} L={L}, "
          f"kernels vs plain: loss {loss:.6f} vs {rloss:.6f} (|diff| "
          f"{loss_diff:.3e}, tol {TRAIN_LOSS_TOL:g}), grad_norm {gnorm:.6f} "
          f"vs {rgnorm:.6f} (rel {gnorm_rel:.3e}), gradient rel L2 over "
          f"{len(rels)} parameters: max {rels[0][0]:.3e}, median "
          f"{rels[len(rels) // 2][0]:.3e} (tol {TRAIN_GRAD_REL_L2:g}); "
          f"largest three {[(n, round(r, 5)) for r, n in rels[:3]]}",
          flush=True)
    values = [v for run in runs.values() for v in run[:2]]
    if not all(map(np.isfinite, values)) or loss_diff > TRAIN_LOSS_TOL \
            or max(gnorm_rel, rels[0][0]) > TRAIN_GRAD_REL_L2:
        fail("the kernel training step disagrees with plain attention")
    del runs
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def run_train(models, parallel, ops, card, device="cuda", name="tpu-3b",
              n_layers=None, B=4, L=1024, steps=5, loss_chunk=256):
    """Phase 6: train at full width and depth, fp32 master weights, AdamW,
    no activation recompute. Returns the kernel launch counts of the
    run."""
    cfg = dataclasses.replace(models.MODEL_REGISTRY[name], remat=False)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model, init_fn, step_fn = train_fns(models, parallel, cfg, device, B, L,
                                        loss_chunk)
    t0 = time.perf_counter()
    state = init_fn(torch.Generator(device=device).manual_seed(0))
    sync(device)
    print(f"train {name}: {models.count_params(model) / 1e9:.3f} B "
          f"parameters in {next(model.parameters()).dtype}, init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    tokens = torch.randint(0, cfg.vocab_size, (B, L + 1), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(3))
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    want = cfg.n_layers if device == "cuda" else 0
    losses, times = [], []
    zero_counts(ops)                               # main path: training
    for i in range(steps):
        before = read_counts(ops)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, tokens)
        sync(device)
        times.append(time.perf_counter() - t0)
        loss, gnorm = metrics["loss"].item(), metrics["grad_norm"].item()
        losses.append(loss)
        step_counts = {k: n - before[k] for k, n in read_counts(ops).items()}
        print(f"train step {i + 1}: loss {loss:.6f}, grad_norm {gnorm:.6f},"
              f" {times[-1] * 1e3:.1f} ms ({B * L / times[-1]:.1f} tokens/s),"
              f" launches {step_counts}", flush=True)
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            fail(f"train step {i + 1}: loss {loss}, grad_norm {gnorm}")
        if set(step_counts.values()) != {want}:
            fail(f"train step {i + 1} launched {step_counts}, want {want} "
                 f"of each kernel (one per layer on the card)")
    counts = read_counts(ops)
    steady = float(np.median(times[1:])) if steps > 1 else times[0]
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
            if device == "cuda" else "n/a (CPU)")
    print(f"train {name}: {steps} steps of {B}x{L} tokens, step time "
          f"{steady * 1e3:.1f} ms (median of steps 2-{steps}), "
          f"{B * L / steady:.1f} tokens/s, peak memory allocated {peak}, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} [{card}]", flush=True)
    if not losses[-1] < losses[0] - LOSS_DROP:
        fail(f"the loss did not fall by {LOSS_DROP}: {losses}")
    if state.step != steps:
        fail(f"state.step is {state.step}, want {steps}")
    del state, model
    return counts


def recipe_cfg(models, name, **kw):
    """The JAX bench's headline training rung (bench.py, reports/
    mfu_ablate.py): bf16 weights, remat "dots", flash attention."""
    return dataclasses.replace(models.MODEL_REGISTRY[name],
                               param_dtype=torch.bfloat16, remat=True,
                               remat_policy="dots", **kw)


def run_recipe_parity(models, parallel, device="cuda", name="tpu-3b",
                      n_layers=4, B=4, L=1024, loss_chunk=256):
    """Phase 7, first: one step of the recipe with remat "dots" and one with
    remat off, from the same seeded weights and batch: the loss and every
    gradient must agree."""
    tokens = torch.randint(0, models.MODEL_REGISTRY[name].vocab_size,
                           (B, L + 1), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(4))
    runs = {}
    for remat in (True, False):
        cfg = recipe_cfg(models, name, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, remat=remat)
        model, init_fn, step_fn = train_fns(
            models, parallel, cfg, device, B, L, loss_chunk,
            parallel.adafactor(3e-4))
        state = init_fn(torch.Generator(device=device).manual_seed(0))
        _, metrics = step_fn(state, tokens)
        sync(device)
        runs[remat] = (metrics["loss"], {n: p.grad.clone() for n, p in
                                         model.named_parameters()})
        del model, state, metrics
    (loss, grads), (rloss, rgrads) = runs[True], runs[False]
    rels = sorted(((rel_l2(grads[n], rgrads[n]), n) for n in grads),
                  reverse=True)
    loss_rel = rel_l2(loss, rloss)
    bitwise = torch.equal(loss, rloss) and all(
        torch.equal(grads[n], rgrads[n]) for n in grads)
    print(f"recipe step, {name} width, {n_layers} layers, B={B} L={L}, bf16 "
          f"weights, adafactor, remat dots vs off: loss {loss.item():.6f} vs "
          f"{rloss.item():.6f} (rel {loss_rel:.3e}), gradient rel L2 over "
          f"{len(rels)} parameters: max {rels[0][0]:.3e} ({rels[0][1]}) "
          f"(tol {RECIPE_REMAT_REL_L2:g}); bitwise equal: {bitwise}",
          flush=True)
    if not torch.isfinite(loss) or max(loss_rel, rels[0][0]) \
            > RECIPE_REMAT_REL_L2:
        fail("the recipe step with remat dots disagrees with remat off")
    del runs
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def forward_model_flops(model, B, L):
    """A forward's model FLOPs over B x L tokens: 2 per parameter per token
    outside the expert layers (the embedding's lookup does no product),
    causal attention's two products (4*D per kept (query, key) pair) and,
    for an expert model, each layer's router, its dispatch and combine
    products and its experts' three GEMMs over every slot of its capacity
    (the dense dispatch computes empty slots too)."""
    cfg = model.cfg
    n = sum(p.numel() for name, p in model.named_parameters()
            if ".moe." not in name and name != "embed")
    pairs = B * cfg.n_heads * L * (L + 1) / 2
    flops = 2.0 * n * B * L + 4.0 * cfg.head_dim * pairs * cfg.n_layers
    if cfg.n_experts:
        E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
        C = moe_capacity(cfg, L)
        per_layer = (2.0 * B * L * D * E + 2 * 2.0 * B * L * E * C * D
                     + 3 * 2.0 * E * B * C * D * F)
        flops += per_layer * cfg.n_layers
    return flops


def step_model_flops(model, B, L):
    """A training step's model FLOPs: the forward's and twice that
    backward. Recompute is not counted."""
    return 3 * forward_model_flops(model, B, L)


def run_recipe(models, parallel, ops, card, device="cuda", name="tpu-3b",
               n_layers=None, B=4, L=1024, steps=5, loss_chunk=256,
               lr=3e-4):
    """Phase 7: the recipe at full width and depth (phase 10: an expert
    model cut to n_layers). Returns the kernel launch counts of the run,
    its step time (the median of steps 2 on) and each step's (loss,
    grad_norm, seconds).
    lr is the recipe's; Adafactor scales its steps by the weights' RMS, so
    at a rehearsal's llama-debug size 3e-4 moves the loss by only ~0.02 in
    5 steps, and the rehearsal passes 1e-2."""
    cfg = recipe_cfg(models, name)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model, init_fn, step_fn = train_fns(models, parallel, cfg, device, B, L,
                                        loss_chunk, parallel.adafactor(lr))
    t0 = time.perf_counter()
    state = init_fn(torch.Generator(device=device).manual_seed(0))
    sync(device)
    dtypes = sorted({str(p.dtype) for p in model.parameters()})
    print(f"recipe {name}: {models.count_params(model) / 1e9:.3f} B "
          f"parameters in {dtypes}, adafactor({lr:g}), remat "
          f"{cfg.remat_policy}, init {time.perf_counter() - t0:.2f} s",
          flush=True)
    tokens = torch.randint(0, cfg.vocab_size, (B, L + 1), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(3))
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    n = cfg.n_layers if device == "cuda" else 0
    want = {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    losses, times, trajectory = [], [], []
    zero_counts(ops)                               # main path: the recipe
    for i in range(steps):
        before = read_counts(ops)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, tokens)
        sync(device)
        times.append(time.perf_counter() - t0)
        loss, gnorm = metrics["loss"].item(), metrics["grad_norm"].item()
        aux = metrics["moe_aux"].item()
        losses.append(loss)
        trajectory.append((loss, gnorm, times[-1]))
        step_counts = {k: c - before[k] for k, c in read_counts(ops).items()}
        moe = (f", moe_aux {aux:.6f}, total_loss "
               f"{metrics['total_loss'].item():.6f}" if cfg.n_experts else "")
        print(f"recipe step {i + 1}: loss {loss:.6f}{moe}, grad_norm "
              f"{gnorm:.6f}, {times[-1] * 1e3:.1f} ms "
              f"({B * L / times[-1]:.1f} tokens/s), launches {step_counts}",
              flush=True)
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            fail(f"recipe step {i + 1}: loss {loss}, grad_norm {gnorm}")
        if cfg.n_experts and not (np.isfinite(aux) and aux > 0):
            fail(f"recipe step {i + 1}: moe_aux {aux}")
        if step_counts != want:
            fail(f"recipe step {i + 1} launched {step_counts}, want {want} "
                 f"(the forward kernel twice per layer: forward and "
                 f"recompute)")
    counts = read_counts(ops)
    steady = float(np.median(times[1:])) if steps > 1 else times[0]
    flops = step_model_flops(model, B, L)
    if device == "cuda":
        peak = f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
        mfu = f"{flops / steady / H100_BF16_FLOPS * 100:.1f}%"
    else:
        peak = mfu = "n/a (CPU)"
    print(f"recipe {name}, {cfg.n_layers} layers: {steps} steps of {B}x{L} "
          f"tokens, step time "
          f"{steady * 1e3:.1f} ms (median of steps 2-{steps}), "
          f"{B * L / steady:.1f} tokens/s, peak memory allocated {peak}, "
          f"model FLOPs {flops / 1e12:.2f} TFLOP per step, MFU {mfu} of "
          f"{H100_BF16_FLOPS / 1e12:.1f} TFLOP/s (informational), loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} [{card}]", flush=True)
    if not losses[-1] < losses[0] - LOSS_DROP:
        fail(f"the recipe's loss did not fall by {LOSS_DROP}: {losses}")
    if state.step != steps:
        fail(f"state.step is {state.step}, want {steps}")
    del state, model
    return counts, steady, trajectory


def add_counts(total, ops):
    for name, n in read_counts(ops).items():
        total[name] = total.get(name, 0) + n


def serve(eng, prompts, new, ops, counts, limit=2000):
    """Drive an engine over prompts and return their handles. Each prompt
    is submitted once the one before has its first token, so every prefill
    runs alone, in chunks aligned at multiples of prefill_chunk (chunk
    boundaries move a bf16 computation in its last bits, and a hit must
    meet the same numbers as its miss). The engine's launches are added to
    counts."""
    steps = 0

    def step():
        nonlocal steps
        eng.step()
        steps += 1
        if steps > limit:
            fail("engine: requests did not finish")
    zero_counts(ops)
    handles = []
    for p in prompts:
        handles.append(eng.submit(p, max_new_tokens=new))
        while handles[-1].first_token_t is None:
            step()
    while not all(h.finish_reason for h in handles):
        step()
    add_counts(counts, ops)
    return handles


def engine_cfg(inference, n_slots, max_len, chunk, budget, **kw):
    return inference.EngineConfig(n_slots=n_slots, max_len=max_len,
                                  prefill_chunk=chunk, prefill_budget=budget,
                                  **kw)


def release(device):
    """Return what the engines just dropped to the card."""
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def run_prefix_cache(model, inference, ops, card, counts, device="cuda",
                     n_slots=8, max_len=1024, chunk=128, budget=256,
                     cache_slots=4, n_prefixes=4, prefix_len=384,
                     per_prefix=4, suffix=(16, 96), new=32):
    """Phase 8 (a) and (b), for full-precision and int8 blocks."""
    vocab = model.cfg.vocab_size
    rng = np.random.RandomState(5)
    heads = [rng.randint(0, vocab, prefix_len) for _ in range(n_prefixes)]
    prompts = [[np.concatenate([h, rng.randint(0, vocab, rng.randint(
        suffix[0], suffix[1] + 1))]) for _ in range(per_prefix)]
        for h in heads]
    flat = [p for group in prompts for p in group]
    mcfg = model.cfg
    for mode in ("none", "int8"):
        cfg = engine_cfg(inference, n_slots, max_len, chunk, budget,
                         prefix_cache_slots=cache_slots, kv_quant=mode)
        eng = inference.InferenceEngine(model, cfg, device=device, seed=0)
        t0 = time.perf_counter()
        # one prefix at a time: its first request misses, the rest hit
        handles = [h for group in prompts
                   for h in serve(eng, group, new, ops, counts)]
        sync(device)
        wall = time.perf_counter() - t0
        got = [h.tokens() for h in handles]
        matched = [h.prefix_matched for h in handles]
        st = eng.stats()
        # the same prompts as misses on fresh engines: one engine per
        # request index, whose prompts have distinct prefixes
        want = [None] * len(flat)
        for j in range(per_prefix):
            ref = inference.InferenceEngine(model, cfg, device=device,
                                            seed=0)
            hs = serve(ref, [g[j] for g in prompts], new, ops, counts)
            for g, h in enumerate(hs):
                if h.prefix_matched:
                    fail("a reference prompt hit the cache")
                want[g * per_prefix + j] = h.tokens()
            del ref
            release(device)
        hit = [i for i, m in enumerate(matched) if m]
        miss = [i for i, m in enumerate(matched) if not m]
        ttft = {k: float(np.median([handles[i].ttft_s for i in idx])) * 1e3
                for k, idx in (("hit", hit), ("miss", miss))}
        per_token = kvq_bytes(mcfg, mode)
        equal = sum(g == w for g, w in zip(got, want))
        print(f"prefix cache kv_quant={mode}: {len(flat)} requests "
              f"({n_prefixes} prefixes of {prefix_len} tokens, suffixes "
              f"{suffix[0]}-{suffix[1]}, {new} greedy tokens) in "
              f"{wall:.3f} s; {len(hit)} hits, matched tokens "
              f"{sum(matched)}; TTFT median hit {ttft['hit']:.1f} ms, miss "
              f"{ttft['miss']:.1f} ms; blocks used "
              f"{st['prefix_blocks_cached']} of "
              f"{st['prefix_blocks_cached'] + st['prefix_blocks_free']}, "
              f"{per_token} bytes per cached token; tokens equal to a miss "
              f"on a fresh engine: {equal}/{len(flat)} [{card}]", flush=True)
        if not hit or sum(matched) <= 0 or equal != len(flat):
            fail(f"prefix cache kv_quant={mode}: a hit's tokens differ "
                 f"from its miss's, or nothing hit")
        if mode == "none":
            off = inference.InferenceEngine(
                model, engine_cfg(inference, n_slots, max_len, chunk,
                                  budget), device=device, seed=0)
            plain = [h.tokens() for group in prompts
                     for h in serve(off, group, new, ops, counts)]
            del off
            release(device)
            same = sum(g == w for g, w in zip(got, plain))
            print(f"prefix cache kv_quant=none vs an engine without the "
                  f"cache: {same}/{len(flat)} streams equal", flush=True)
            if same != len(flat):
                fail("the prefix cache changed the tokens of full-precision "
                     "blocks")
        run_kv_handoff(model, inference, ops, eng, cfg, prompts, got,
                       counts, device, per_prefix, new)
        del eng
        release(device)


def kvq_bytes(mcfg, mode):
    """Bytes one cached token costs in the block pool (K and V)."""
    from ray_tpu_torch.inference import kv_quant
    if mode == "int8":
        return kv_quant.int8_block_bytes_per_token(mcfg.n_kv_heads,
                                                   mcfg.head_dim)
    itemsize = torch.empty((), dtype=mcfg.dtype).element_size()
    return kv_quant.fp_block_bytes_per_token(mcfg.n_kv_heads, mcfg.head_dim,
                                             itemsize)


def run_kv_handoff(model, inference, ops, exporter, cfg, prompts, got,
                   counts, device, per_prefix, new):
    """Phase 8 (b): each prefix's blocks exported from the engine of (a)
    and imported into a fresh engine over the same weights, which must
    serve the prompt from them with the exporter's greedy tokens."""
    importer = inference.InferenceEngine(model, cfg, device=device, seed=0)
    chosen = [g[1] for g in prompts]
    n_bytes, covered, dtypes = 0, 0, set()
    t0 = time.perf_counter()
    for p in chosen:
        c, spans = exporter.export_kv_blocks(p)
        n_bytes += sum(a.nbytes for span in spans for a in span)
        dtypes |= {f"{a.dtype}:{a.dtype.itemsize}B" for span in spans
                   for a in span}
        covered += importer.import_kv_blocks(p, spans)
    hand_s = time.perf_counter() - t0
    hs = serve(importer, chosen, new, ops, counts)
    tokens = [h.tokens() for h in hs]
    want = [got[g * per_prefix + 1] for g in range(len(prompts))]
    matched = [h.prefix_matched for h in hs]
    print(f"kv hand-off kv_quant={cfg.kv_quant}: {len(chosen)} prompts, "
          f"{covered} tokens imported in {n_bytes / 2**20:.1f} MiB "
          f"({n_bytes} bytes) of host spans of {sorted(dtypes)} "
          f"({hand_s * 1e3:.1f} ms export + import), matched "
          f"{matched}, importer tokens equal to the exporter's: "
          f"{sum(t == w for t, w in zip(tokens, want))}/{len(chosen)}",
          flush=True)
    if tokens != want or not all(matched):
        fail(f"kv hand-off kv_quant={cfg.kv_quant}: the importer's tokens "
             f"differ from the exporter's")
    del importer
    release(device)


def first_diff(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def run_spec(model, models, inference, ops, card, counts, device="cuda",
             n_slots=8, max_len=1024, chunk=128, budget=256, k=4,
             lens=(64, 100, 150, 200, 260, 320, 380, 448), new=32,
             draft_name="tpu-125m"):
    """Phase 8 (c): speculative decoding with a self-draft and a random
    draft, against the engine without it, in the model's dtype. In fp32
    the spec-on streams must equal spec-off (near-tie rule) and the
    self-draft must accept at least SELF_DRAFT_MIN_ACCEPT. In bf16 a
    verify forward and a decode step differ in their last bits, and a
    random model's bf16 logits tie often (its top two are often one bf16
    step apart), so there every spec-on token is held to a one-shot forward
    as phase 4 holds the engine's, and the agreement with spec-off and the
    accept rates are printed."""
    exact = model.cfg.dtype == torch.float32
    dtype = str(model.cfg.dtype).replace("torch.", "")
    vocab = model.cfg.vocab_size
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, vocab, n) for n in lens]
    cfg = engine_cfg(inference, n_slots, max_len, chunk, budget)
    draft_cfg = dataclasses.replace(models.MODEL_REGISTRY[draft_name],
                                    dtype=model.cfg.dtype)
    drafts = {
        "self-draft": {"draft_model": model.cfg, "k": k,
                       "draft_params_fn": model.state_dict},
        f"random {draft_name} draft": {"draft_model": draft_cfg, "k": k,
                                       "draft_seed": 7},
    }
    runs, rates = {}, {}
    for label, spec in [("spec off", None)] + list(drafts.items()):
        eng = inference.InferenceEngine(model, cfg, device=device, seed=0,
                                        spec=spec)
        times, decode_steps = [], 0
        zero_counts(ops)
        handles = [eng.submit(p, max_new_tokens=new) for p in prompts]
        while not all(h.finish_reason for h in handles):
            prefilled = all(h.first_token_t is not None for h in handles)
            before = eng.tokens_generated
            t0 = time.perf_counter()
            eng.step()
            sync(device)
            if eng.tokens_generated > before:
                decode_steps += 1
                if prefilled:
                    times.append(time.perf_counter() - t0)
            if eng.steps > 2000:
                fail(f"spec {label}: requests did not finish")
        add_counts(counts, ops)
        runs[label] = [h.tokens() for h in handles]
        rates[label] = eng.stats().get("spec_accept_rate", "n/a")
        print(f"spec decode {dtype}, {label} (k={k}): "
              f"{eng.tokens_generated} decoded tokens in {decode_steps} "
              f"decode steps ({eng.tokens_generated / decode_steps:.2f} "
              f"tokens per step over {n_slots} slots), decode step "
              f"{np.median(times) * 1e3:.1f} ms (median of {len(times)}), "
              f"accept rate {rates[label]} [{card}]", flush=True)
        del eng
        release(device)
    off = runs["spec off"]
    for label in drafts:
        diffs = []
        for prompt, a, b in zip(prompts, off, runs[label]):
            i = first_diff(a, b)
            if i is None and len(a) == len(b):
                continue
            i = min(len(a), len(b)) if i is None else i
            diffs.append((i, near_tie(model, models, prompt, a, i, device)))
        print(f"spec decode {dtype}, {label}: {len(prompts) - len(diffs)}/"
              f"{len(prompts)} streams equal spec off; at the first "
              f"difference of the others (position, spec-off top-2 logit "
              f"gap / top logit): {[(i, round(d, 5)) for i, d in diffs]} "
              f"(near-tie below {SPEC_NEAR_TIE:g})", flush=True)
        if not exact:
            check_one_shot(f"spec decode {dtype}, {label},", model, models,
                           prompts, runs[label], device)
            continue
        if len(diffs) > SPEC_MAX_DIFFERING or any(
                d >= SPEC_NEAR_TIE for _, d in diffs):
            fail(f"spec decode {dtype}, {label}: streams differ from spec "
                 f"off beyond a near-tie")
    if exact and rates["self-draft"] < SELF_DRAFT_MIN_ACCEPT:
        fail(f"the self-draft accepted {rates['self-draft']} of its "
             f"tokens, want at least {SELF_DRAFT_MIN_ACCEPT}")


def near_tie(model, models, prompt, tokens, i, device):
    """The spec-off stream's logits at its token i (a one-shot forward of
    the prompt and tokens[:i]): the gap between the top two over the top
    logit's size."""
    seq = torch.tensor(np.concatenate([prompt, tokens[:i]]),
                       dtype=torch.long, device=device)[None]
    with torch.inference_mode():
        logits = model(seq, cache=models.init_cache(
            model.cfg, 1, seq.shape[1], device=device))[0][0, -1].float()
    top = torch.topk(logits, 2).values
    return ((top[0] - top[1]) / top[0].abs()).item()


def run_engine_features(models, inference, ops, card, device="cuda",
                        name="tpu-7b", n_layers=None, **kw):
    """Phase 8 on a fresh seeded model of `name` (bf16, as served; cut to
    ``n_layers``), then (c) again on its weights in fp32. Returns the
    kernels' launches in its engines' runs."""
    cfg = models.MODEL_REGISTRY[name]
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = models.TransformerLM(cfg, device="meta")
    model.load_state_dict(models.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device),
        assign=True)
    counts = {}
    run_prefix_cache(model, inference, ops, card, counts, device=device,
                     **kw.get("prefix", {}))
    run_spec(model, models, inference, ops, card, counts, device=device,
             **kw.get("spec", {}))
    wide = models.TransformerLM(
        dataclasses.replace(cfg, dtype=torch.float32), device="meta")
    wide.load_state_dict({n: t.float() for n, t in
                          model.state_dict().items()}, assign=True)
    del model
    release(device)
    run_spec(wide, models, inference, ops, card, counts, device=device,
             **kw.get("spec", {}))
    del wide
    release(device)
    return counts


class RoutingRecorder:
    """While open, records every expert layer's routing in the forwards a
    model runs: per layer, a list of (chosen experts [B,L,K] in priority
    order, kept [B,L,K]), one per call, through the layer's own router. A
    dense model records nothing."""

    def __init__(self, model):
        self.layers = [blk.moe for blk in model.layers
                       if blk.moe is not None]
        self.calls = [[] for _ in self.layers]
        self.hooks = []

    def _record(self, i, mod, args):
        x = args[0]
        with torch.no_grad():
            _, _, idx, pos = mod.route(x)
        self.calls[i].append((idx, pos < moe_capacity(mod.cfg, x.shape[1])))

    def __enter__(self):
        self.hooks = [moe.register_forward_pre_hook(
            functools.partial(self._record, i))
            for i, moe in enumerate(self.layers)]
        return self

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()

    def agreement(self, other):
        """[n_layers, B, L]: True where a token's routing (its experts in
        order and which picks were kept) equals ``other``'s, in the first
        forward each recorded."""
        return torch.stack([
            ((a[0][0] == b[0][0]) & (a[0][1] == b[0][1])).all(-1)
            for a, b in zip(self.calls, other.calls)])

    def dropped_share(self):
        """The share of picks dropped over capacity, in the first forward."""
        kept = torch.stack([calls[0][1] for calls in self.calls])
        return 1.0 - kept.float().mean().item()


def largest(t):
    return t.max().item() if t.numel() else 0.0


def moe_model(models, cfg, device, seed=0):
    """A model of cfg with seeded random weights in cfg.dtype."""
    model = models.TransformerLM(cfg, device="meta")
    model.load_state_dict(models.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed), device),
        assign=True)
    return model


def sharing(models, model, **cfg_kw):
    """A second model over the same weight tensors, its config changed."""
    other = models.TransformerLM(dataclasses.replace(model.cfg, **cfg_kw),
                                 device="meta")
    other.load_state_dict(model.state_dict(), assign=True)
    return other


def run_moe_serving(models, inference, ops, card, device="cuda",
                    name="mixtral-8x7b", n_layers=16, B=8, P=512, N=32,
                    engine=None):
    """Phase 9. Returns the flash launches of the generator's and the
    engine's runs."""
    cfg = dataclasses.replace(models.MODEL_REGISTRY[name], n_layers=n_layers)
    t0 = time.perf_counter()
    model = moe_model(models, cfg, device)
    sync(device)
    print(f"{name}, {n_layers} of {models.MODEL_REGISTRY[name].n_layers} "
          f"layers: {models.count_params(model) / 1e9:.3f} B parameters, "
          f"init {time.perf_counter() - t0:.2f} s", flush=True)
    _, gen_fn = models.make_generate_fn(model, batch=B, prompt_len=P,
                                        max_new_tokens=N, device=device)
    tokens = torch.randint(0, cfg.vocab_size, (B, P), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(1))
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()

    zero_counts(ops)                               # main path: generator
    t0 = time.perf_counter()
    out = gen_fn(tokens)
    sync(device)
    gen_s = time.perf_counter() - t0
    counts = read_counts(ops)
    launches = counts["flash_fwd"]
    want = n_layers if device == "cuda" else 0
    print(f"moe generator: {B}x{P} prompt + {N} new tokens in {gen_s:.3f} s "
          f"({B * N / gen_s:.1f} tokens/s incl. prefill), flash_fwd "
          f"launches {launches}", flush=True)
    if launches != want or counts["flash_bwd_dq"] or counts["flash_bwd_dkv"]:
        fail(f"the MoE generator launched {counts}, want {want} of flash_fwd "
             f"(one per layer on the card) and no backward kernel")
    if tuple(out.shape) != (B, N) or int(out.min()) < 0 \
            or int(out.max()) >= cfg.vocab_size:
        fail(f"MoE generator output {tuple(out.shape)} out of range")

    # the prefill and a decode step timed alone, on the generator's shapes
    decode_steps = 8
    with torch.inference_mode():
        cache = models.init_cache(cfg, B, P + decode_steps, device=device)
        sync(device)
        t0 = time.perf_counter()
        logits, cache = model(tokens, cache=cache)
        sync(device)
        prefill_s = time.perf_counter() - t0
        tok = logits[:, -1].argmax(-1)
        t0 = time.perf_counter()
        for _ in range(decode_steps):
            logits, cache = model(tok[:, None], cache=cache)
            tok = logits[:, -1].argmax(-1)
        sync(device)
        decode_s = (time.perf_counter() - t0) / decode_steps
        del cache, logits
    flops = forward_model_flops(model, B, P)
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
            if device == "cuda" else "n/a (CPU)")
    print(f"moe {name}, {n_layers} layers: prefill of {B}x{P} tokens "
          f"{prefill_s * 1e3:.2f} ms ({flops / 1e12:.2f} TFLOP of model "
          f"FLOPs, expert GEMMs at capacity; "
          f"{flops / prefill_s / 1e12:.1f} TFLOP/s, informational), decode "
          f"step {decode_s * 1e3:.2f} ms (mean of {decode_steps}, "
          f"{B / decode_s:.1f} tokens/s), peak memory "
          f"allocated {peak} [{card}]", flush=True)

    # the same weights through plain attention: in bf16 a rounding may
    # flip a near-tied routing pick, so this is printed, not held (phase
    # 11 holds the kernels in fp32)
    ref = sharing(models, model, attention_impl="reference")
    with torch.inference_mode():
        with RoutingRecorder(model) as routing:
            got = model(tokens).float()
        with RoutingRecorder(ref) as rrouting:
            want_logits = ref(tokens).float()
    agree = routing.agreement(rrouting)
    same = agree.all(0)                              # [B, P]
    gap = (got - want_logits).abs().amax(-1)         # [B, P]
    print(f"moe prefill, kernels vs plain attention (bf16, informational): "
          f"routing decisions equal {agree.float().mean().item():.6f} of "
          f"{agree.numel()} (token, layer) pairs; positions routed alike in "
          f"every layer {same.float().mean().item():.4f}, largest logit "
          f"difference there {largest(gap[same]):.3e} (elsewhere "
          f"{largest(gap[~same]):.3e}); "
          f"picks dropped at capacity_factor {cfg.capacity_factor:g} "
          f"(C={moe_capacity(cfg, P)}): {routing.dropped_share():.4f}",
          flush=True)
    if not torch.isfinite(got).all():
        fail("MoE prefill logits are not finite")
    del ref, got, want_logits, routing, rrouting

    eng_launches = run_engine(model, models, inference, ops, card,
                              device=device, hold=False, **(engine or {}))
    del model
    release(device)
    return launches + eng_launches


def run_moe_holds(models, parallel, inference, ops, card, device="cuda",
                  name="mixtral-8x7b", n_layers=2, B=4, L=512, loss_chunk=256,
                  engine=None):
    """Phase 11: the expert model in fp32 at a cut depth; the prefill and
    the training step at B x L tokens."""
    cfg = dataclasses.replace(models.MODEL_REGISTRY[name], n_layers=n_layers,
                              dtype=torch.float32)
    model = moe_model(models, cfg, device)
    ref = sharing(models, model, attention_impl="reference")
    tokens = torch.randint(0, cfg.vocab_size, (B, L), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(8))
    with torch.inference_mode():
        before = read_counts(ops)["flash_fwd"]
        with RoutingRecorder(model) as routing:
            got = model(tokens, cache=models.init_cache(
                cfg, B, L, device=device))[0]
        launched = read_counts(ops)["flash_fwd"] - before
        with RoutingRecorder(ref) as rrouting:
            want = ref(tokens, cache=models.init_cache(
                cfg, B, L, device=device))[0]
    agree = routing.agreement(rrouting)
    rel = rel_l2(got, want)
    print(f"moe hold, {name} width, {n_layers} layers, fp32 prefill {B}x{L}, "
          f"kernels vs plain attention: routing decisions equal "
          f"{agree.float().mean().item():.6f} of {agree.numel()}, logits "
          f"relative L2 {rel:.3e} (tol {LOGITS_REL_TOL:g}), max abs "
          f"{(got - want).abs().max().item():.3e}, flash_fwd launches "
          f"{launched}", flush=True)
    if launched != (n_layers if device == "cuda" else 0):
        fail(f"the fp32 MoE prefill launched flash_fwd {launched} times")
    if not agree.all() or not torch.isfinite(got).all() \
            or rel > LOGITS_REL_TOL:
        fail("the fp32 MoE prefill through the kernels disagrees with plain "
             "attention")
    del ref, got, want, routing, rrouting

    # at capacity_factor E/K every expert has C = L slots: the engine's
    # chunks and decode steps route as the one-shot forward does
    wide = sharing(models, model, capacity_factor=cfg.n_experts
                   / cfg.expert_top_k)
    run_engine(wide, models, inference, ops, card, device=device,
               **(engine or {}))
    del wide, model
    release(device)
    # adafactor's factored moments are small, so the first run's fp32
    # gradients fit beside the second run (AdamW's moments would not)
    run_train_parity(models, parallel, ops, device=device, name=name,
                     n_layers=n_layers, B=B, L=L, loss_chunk=loss_chunk,
                     optimizer=parallel.adafactor(3e-4), dtype=torch.float32)


def mesh_of(parallel, device, **axes):
    """Phase 12's mesh: the default process group as a world of one rank
    (NCCL on the card, gloo on a CPU rehearsal; started once, from an
    in-process store, no MASTER_ADDR), and a mesh over it."""
    parallel.init_world(device=device)
    return parallel.make_mesh(parallel.MeshConfig(**axes),
                              device_type=device)


def mesh_step_pair(models, parallel, ops, device, cfg, mesh, B, L, steps,
                   loss_chunk, lr, together):
    """Train cfg's recipe from seed 0 with and without the mesh on one
    batch. With ``together`` both models live at once and their steps
    alternate (no mesh, mesh, mesh, no mesh, ...), so a drift of the
    card's clocks hits both alike; else the no-mesh run goes first and is
    freed, and each run's peak memory is taken. Returns {label: (metrics
    of every step, step times, launch counts of every step, peak bytes
    allocated or None)}."""
    tokens = torch.randint(0, cfg.vocab_size, (B, L + 1), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(3))
    runs = {}

    def build(label):
        model = models.TransformerLM(cfg, device="meta")
        init_fn, step_fn, shardings = parallel.make_train_fns(
            model, parallel.adafactor(lr), mesh=mesh if label == "mesh"
            else None, batch_shape=(B, L + 1), loss_chunk=loss_chunk,
            device=device)
        state = init_fn(torch.Generator(device=device).manual_seed(0))
        runs[label] = {"state": state, "step": step_fn, "metrics": [],
                       "times": [], "counts": [], "peak": None}

    def step(label):
        run = runs[label]
        before = read_counts(ops)
        t0 = time.perf_counter()
        run["state"], metrics = run["step"](run["state"], tokens)
        sync(device)
        run["times"].append(time.perf_counter() - t0)
        run["metrics"].append({k: float(v) for k, v in metrics.items()})
        run["counts"].append({k: c - before[k]
                              for k, c in read_counts(ops).items()})

    order = [("no mesh", "mesh") if i % 2 == 0 else ("mesh", "no mesh")
             for i in range(steps)]
    if together:
        build("no mesh")
        build("mesh")
        for pair in order:
            for label in pair:
                step(label)
    else:
        for label in ("no mesh", "mesh"):
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            build(label)
            for _ in range(steps):
                step(label)
            if device == "cuda":
                runs[label]["peak"] = torch.cuda.max_memory_allocated()
            # the step function holds the model (and its gradients) too
            runs[label]["state"] = runs[label]["step"] = None
            release(device)
    out = {label: (r["metrics"], r["times"], r["counts"], r["peak"])
           for label, r in runs.items()}
    del runs
    release(device)
    return out


def check_mesh_steps(what, cfg, runs, card, device):
    """The mesh's steps against the no-mesh steps: each step's loss and
    grad_norm within phase 7's recipe bound, equal kernel launches (the
    recipe's: the forward kernel twice per layer, dQ and dK/dV once), the
    step times, median [min, max] of steps 2 on, with their ratio, and
    each run's peak memory where it was taken."""
    (m0, t0, c0, p0), (m1, t1, c1, p1) = runs["no mesh"], runs["mesh"]
    n = cfg.n_layers if device == "cuda" else 0
    want = {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    for i, (a, b, ca, cb) in enumerate(zip(m0, m1, c0, c1)):
        rels = {k: abs(b[k] - a[k]) / max(abs(a[k]), 1e-30)
                for k in ("loss", "grad_norm", "moe_aux") if a[k]}
        print(f"{what} step {i + 1}: loss {a['loss']:.6f} (no mesh) vs "
              f"{b['loss']:.6f} (mesh), grad_norm {a['grad_norm']:.6f} vs "
              f"{b['grad_norm']:.6f}, relative differences "
              f"{ {k: f'{v:.3e}' for k, v in rels.items()} } (tol "
              f"{RECIPE_REMAT_REL_L2:g}), launches {ca} vs {cb}", flush=True)
        if not all(np.isfinite(v) for v in b.values()) or \
                max(rels.values()) > RECIPE_REMAT_REL_L2:
            fail(f"{what} step {i + 1}: the mesh step disagrees with the "
                 f"no-mesh step")
        if ca != want or cb != ca:
            fail(f"{what} step {i + 1}: launches {cb} (mesh) and {ca} (no "
                 f"mesh), want {want} each")
    if len(t0) > 1:
        (a, alo, ahi), (b, blo, bhi) = (median_spread(t[1:]) for t in (t0, t1))
        print(f"{what}: step time no mesh {a * 1e3:.1f} ms [{alo * 1e3:.1f}, "
              f"{ahi * 1e3:.1f}], mesh {b * 1e3:.1f} ms [{blo * 1e3:.1f}, "
              f"{bhi * 1e3:.1f}] (median [min, max] of steps 2-{len(t0)}), "
              f"mesh/no mesh {b / a:.3f} [{card}]", flush=True)
    if p0 is not None:
        print(f"{what}: peak memory allocated no mesh {p0 / 2**30:.2f} GiB, "
              f"mesh {p1 / 2**30:.2f} GiB", flush=True)


def run_mesh_train(models, parallel, ops, card, device="cuda",
                   name="tpu-3b", n_layers=None, B=4, L=1024, steps=5,
                   loss_chunk=256, lr=3e-4, together=True, **axes):
    """Phase 12 (a) and (d): the recipe through make_train_fns(mesh=...)
    on a world of one rank against the no-mesh trainer. Returns the
    launch counts of both runs."""
    cfg = recipe_cfg(models, name)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    mesh = mesh_of(parallel, device, **(axes or {"fsdp": -1}))
    zero_counts(ops)                   # main path: the mesh's trainers
    runs = mesh_step_pair(models, parallel, ops, device, cfg, mesh, B, L,
                          steps, loss_chunk, lr, together)
    counts = read_counts(ops)
    print(f"mesh {mesh.mesh_dim_names} {tuple(mesh.shape)}, recipe "
          f"{name}, {cfg.n_layers} layers, {steps} steps of {B}x{L}:",
          flush=True)
    check_mesh_steps(f"mesh recipe {name}", cfg, runs, card, device)
    return counts


def generate_times(gen1, gen, tokens, device, N):
    """Prefill time (a generator of one token) and decode-step time (the
    rest of an N-token generator's time over its N - 1 steps)."""
    t0 = time.perf_counter()
    gen1(tokens)
    sync(device)
    t1 = time.perf_counter()
    out = gen(tokens)
    sync(device)
    t2 = time.perf_counter()
    return out, t1 - t0, (t2 - t1 - (t1 - t0)) / (N - 1)


def run_mesh_serve(models, parallel, ops, card, device="cuda",
                   name="tpu-7b", n_layers=None, B=8, P=512, N=16,
                   rounds=3):
    """Phase 12 (b) and (c): tpu-7b through make_infer_fns and
    make_generate_fn on a world-1 mesh against the no-mesh forward and
    generator (greedy; the same weights from seed 0); then the dispatch
    under the mesh at the prefill's attention shapes. Returns the flash
    launches of the mesh's serving path."""
    cfg = models.MODEL_REGISTRY[name]
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    mesh = mesh_of(parallel, device, fsdp=-1)
    tokens = torch.randint(0, cfg.vocab_size, (B, P), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(1))
    plain = models.TransformerLM(cfg, device="meta")
    _, gen1 = models.make_generate_fn(plain, batch=B, prompt_len=P,
                                      max_new_tokens=1, device=device)
    init_fn, gen = models.make_generate_fn(plain, batch=B, prompt_len=P,
                                           max_new_tokens=N, device=device)
    init_fn(torch.Generator(device=device).manual_seed(0))
    sharded = models.TransformerLM(cfg, device="meta")
    minit, infer, _ = parallel.make_infer_fns(sharded, mesh,
                                              batch_shape=(B, P),
                                              device=device)
    minit(torch.Generator(device=device).manual_seed(0))
    _, mgen1 = models.make_generate_fn(sharded, mesh, batch=B, prompt_len=P,
                                       max_new_tokens=1, device=device)
    _, mgen = models.make_generate_fn(sharded, mesh, batch=B, prompt_len=P,
                                      max_new_tokens=N, device=device)

    zero_counts(ops)                   # main path: the mesh's serving
    got = infer(tokens).float()
    mesh_counts = read_counts(ops)
    with torch.inference_mode():
        want = plain(tokens, return_hidden=True)[:, -1]
        want = (want @ plain.unembed_weight()).float()
    rel = rel_l2(got, want)
    print(f"mesh {mesh.mesh_dim_names}: make_infer_fns {name} last-position "
          f"logits vs the no-mesh forward: relative L2 {rel:.3e} (tol "
          f"{LOGITS_REL_TOL:g}), bitwise equal {torch.equal(got, want)}, "
          f"flash_fwd launches {mesh_counts['flash_fwd']}", flush=True)
    if not torch.isfinite(got).all() or rel > LOGITS_REL_TOL:
        fail("mesh logits disagree with the no-mesh forward")
    times = {"no mesh": [], "mesh": []}
    outs = {}
    for r in range(rounds):
        for label in (("no mesh", "mesh") if r % 2 == 0
                      else ("mesh", "no mesh")):
            before = read_counts(ops)
            outs[label], pre, dec = generate_times(
                *((mgen1, mgen) if label == "mesh" else (gen1, gen)),
                tokens, device, N)
            times[label].append((pre, dec))
            if label == "mesh":
                mesh_counts = {k: mesh_counts[k] + c - before[k]
                               for k, c in read_counts(ops).items()}
            else:
                # the no-mesh generator is the comparison, not the path
                for k, fn in wrappers(ops).items():
                    fn.launches = before[k]
    a, b = outs["no mesh"], outs["mesh"]
    diffs = [first_diff(x.tolist(), y.tolist()) for x, y in zip(a, b)]
    gaps = [near_tie(plain, models, tokens[i].cpu().numpy(),
                     a[i].cpu().numpy(), d, device)
            for i, d in enumerate(diffs) if d is not None]
    print(f"mesh generator {B}x{P} + {N} greedy tokens vs the no-mesh "
          f"generator: {diffs.count(None)}/{B} streams equal, first "
          f"difference per stream {diffs}, top-2 gap there (share of the "
          f"top logit) {[f'{g:.4f}' for g in gaps]}", flush=True)
    if any(g > SPEC_NEAR_TIE for g in gaps):
        fail("the mesh generator left the no-mesh one away from a tie")
    for label, ts in times.items():
        pre = median_spread([t[0] for t in ts])
        dec = median_spread([t[1] for t in ts])
        print(f"{label}: prefill {B}x{P} {pre[0] * 1e3:.1f} ms "
              f"[{pre[1] * 1e3:.1f}, {pre[2] * 1e3:.1f}], decode step {dec[0] * 1e3:.2f} ms "
              f"[{dec[1] * 1e3:.2f}, {dec[2] * 1e3:.2f}] (median [min, max] "
              f"of {rounds}, taken in turns) [{card}]", flush=True)
    want_fwd = (1 + rounds * 2) * cfg.n_layers if device == "cuda" else 0
    if mesh_counts["flash_fwd"] != want_fwd:
        fail(f"the mesh's serving launched flash_fwd "
             f"{mesh_counts['flash_fwd']} times, want {want_fwd} (one per "
             f"layer per prefill)")
    del plain, sharded, gen, gen1, mgen, mgen1
    release(device)
    run_mesh_dispatch(ops, mesh, cfg, device, B, P)
    return mesh_counts


def run_mesh_dispatch(ops, mesh, cfg, device, B, L):
    """Phase 12 (c): attention through the dispatch under the world-1
    mesh, q/k/v DTensors at the prefill's shapes: sharded_local runs the
    flash kernel on the local shards (a TMA-readable layout, checked) and
    must equal flash_attention on the whole tensors; ring on seq=1 must
    equal plain attention within phase 3's bound. Comparison launches:
    not counted."""
    from torch.distributed.tensor import distribute_tensor
    from ray_tpu_torch.ops import dispatch
    from ray_tpu_torch.parallel import use_mesh
    from ray_tpu_torch.parallel.sharding import spec_to_placements
    g = torch.Generator(device=device).manual_seed(5)
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = (torch.randn(B, L, h, D, device=device, generator=g,
                           dtype=cfg.dtype) for h in (H, Hkv, Hkv))
    place = spec_to_placements((("data", "fsdp"), None, "tensor", None),
                               mesh)
    dq, dk, dv = (distribute_tensor(x, mesh, place, src_data_rank=None)
                  for x in (q, k, v))
    why = [ops.tma_layout_error(x.to_local().stride(),
                                x.to_local().data_ptr(),
                                x.to_local().element_size())
           for x in (dq, dk, dv)]
    saved = read_counts(ops)
    with use_mesh(mesh), torch.no_grad():
        before = ops.flash_attention_fwd.launches
        local = dispatch.attention(dq, dk, dv, impl="sharded_local")
        launched = ops.flash_attention_fwd.launches - before
        ring = dispatch.attention(dq, dk, dv, impl="ring")
        whole = ops.flash_attention(q, k, v)
        plain = ops.mha_reference(q, k, v)
    for name, fn in wrappers(ops).items():
        fn.launches = saved[name]
    local, ring = local.full_tensor(), ring.full_tensor()
    rel = rel_l2(ring, plain)
    print(f"dispatch under mesh {mesh.mesh_dim_names} at {B}x{L}x{H}/{Hkv}"
          f"x{D} {str(cfg.dtype).split('.')[-1]}: local shards TMA-readable "
          f"{[w is None for w in why]}; sharded_local launched flash_fwd "
          f"{launched} time(s), equal to flash_attention "
          f"{torch.equal(local, whole)}; ring (seq=1) vs plain attention "
          f"relative L2 {rel:.3e} (tol {LOGITS_REL_TOL:g})", flush=True)
    if device == "cuda" and (launched != 1 or any(why)):
        fail(f"sharded_local: {launched} launches, TMA {why}")
    if not torch.equal(local, whole) or rel > LOGITS_REL_TOL:
        fail("attention under the mesh disagrees with the whole-tensor "
             "attention")


# ------------------------------------------------------------- phase 13

def pipeline_data(cfg, weights, device, M, L, steps):
    """data_fn(step) -> (M embedded inputs [1, L, d] in cfg.dtype, M
    targets [1, L]), CPU tensors made on the device from a seed per step,
    the embedding outside the stages as the JAX MPMD dry run keeps it."""
    embed = weights["embed"]
    data = {}
    for step in range(1, steps + 1):
        g = torch.Generator(device=device).manual_seed(100 + step)
        toks = torch.randint(0, cfg.vocab_size, (M, 1, L + 1), device=device,
                             generator=g)
        data[step] = ([embed[toks[m, :, :-1]].to(cfg.dtype).cpu()
                       for m in range(M)],
                      [toks[m, :, 1:].cpu() for m in range(M)])
    return lambda step: data[step]


def pipeline_trainer(train, builders, M, **kw):
    return train.MPMDPipelineTrainer(
        builders, train.MPMDConfig(n_microbatches=M, **kw),
        train.FailureConfig(max_failures=2, restart_policy="stage",
                            restart_backoff_s=0.0))


def check_compiled_once(what, tr):
    counts = tr.compile_counts()
    if any(c != {"fwd": 1, "bwd": 1, "apply": 1} for c in counts):
        fail(f"{what}: stage programs ran at more than one input shape "
             f"{counts}")


def free_trainer(tr, device):
    tr.shutdown()
    release(device)


def sequential_loss(models, parallel, cfg, weights, data_fn, loss_chunk,
                    device):
    """Step 1's loss without the pipeline: the same blocks, one model of
    all of them, over the same microbatches (mean of the microbatch
    losses, as the trainer reports it)."""
    stage = models.BlockStage(cfg, cfg.n_layers, device="meta")
    stage.load_state_dict(models.stage_state_dict(weights, 0, cfg.n_layers),
                          assign=True)
    unembed = weights["unembed"].to(cfg.dtype)
    inputs, targets = data_fn(1)
    with torch.no_grad():
        losses = [parallel.chunked_cross_entropy(
            stage(x.to(device)), unembed, t.to(device), chunk=loss_chunk)[0]
            .cpu().numpy() for x, t in zip(inputs, targets)]
    return float(np.mean(losses))


# phases 13 and 14 run tpu-3b's recipe blocks at full width cut to 12 of
# its 24 layers (2 stages of 6), which leaves the whole smoke room for
# phase 21
PIPELINE_LAYERS = 12


def run_pipeline(models, parallel, train, ops, card, recipe_step_s,
                 device="cuda", name="tpu-3b", n_layers=None, L=1024, M=4,
                 steps=3, inter_steps=2, spmd_blocks=2, loss_chunk=256,
                 lr=3e-4):
    """Phase 13: the in-process MPMD pipeline trainer and the SPMD
    pipeline_apply on cfg's recipe blocks. Returns the kernel launch
    counts of (a)-(d) together and (a)'s run (step losses, state digests,
    step time), which phase 14's actor stages are held to."""
    t_phase = time.perf_counter()
    cfg = recipe_cfg(models, name)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    weights = models.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device,
        dtype=cfg.param_dtype)
    data_fn = pipeline_data(cfg, weights, device, M, L, steps)
    want_loss = sequential_loss(models, parallel, cfg, weights, data_fn,
                                loss_chunk, device)
    n = cfg.n_layers if device == "cuda" else 0
    per_step = {"flash_fwd": 2 * n * M, "flash_bwd_dq": n * M,
                "flash_bwd_dkv": n * M}
    total = {}

    print(f"pipeline {name}: weights and the sequential loss "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # (a) 2 stages of n_layers / 2 blocks, 1F1B, M microbatches
    t_part = time.perf_counter()

    def builders(n_virtual):
        return train.block_stage_builders(
            cfg, weights, n_virtual, parallel.adafactor(lr), loss_chunk)

    tr = pipeline_trainer(train, builders(2), M)
    step_counts = []

    def counted(step):
        step_counts.append(read_counts(ops))
        return data_fn(step)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tr.start()
    zero_counts(ops)                   # main path: the MPMD pipeline
    out = tr.fit(counted, steps)
    step_counts.append(read_counts(ops))
    add_counts(total, ops)
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
            if device == "cuda" else "n/a (CPU)")
    launches = [{k: b[k] - a[k] for k in a}
                for a, b in zip(step_counts, step_counts[1:])]
    loss = out["history"][0]["loss"]
    print(f"pipeline {name}: {cfg.n_layers} blocks in 2 stages, {M} "
          f"microbatches of 1x{L}, 1f1b, adafactor({lr:g}), bf16 weights; "
          f"step 1 loss {loss:.6f} vs the blocks one after another "
          f"{want_loss:.6f} (|diff| {abs(loss - want_loss):.3e}, tol "
          f"{TRAIN_LOSS_TOL:g}, bitwise {loss == want_loss}); launches per "
          f"step {launches} (want {per_step})", flush=True)
    if not np.isfinite(loss) or abs(loss - want_loss) > TRAIN_LOSS_TOL:
        fail("the pipeline's first loss disagrees with the blocks run one "
             "after another")
    if any(c != per_step for c in launches):
        fail(f"pipeline steps launched {launches}, want {per_step} each")
    check_compiled_once("pipeline", tr)
    for h in out["history"]:
        compute = [h[f"stage{s}_compute_s"] for s in range(2)]
        print(f"pipeline step {h['step']}: loss {h['loss']:.6f}, wall "
              f"{h['wall_s'] * 1e3:.1f} ms, stage compute "
              f"{[round(c * 1e3, 1) for c in compute]} ms, host (hops and "
              f"dispatch) {(h['wall_s'] - sum(compute)) * 1e3:.1f} ms, "
              f"measured bubble "
              f"{[h[f'stage{s}_bubble_fraction'] for s in range(2)]}",
              flush=True)
    fwd_bwd = [(m["fwd_s"], m["bwd_s"]) for chunks in tr.last_stage_metrics
               for m in chunks]
    flops = [m["flops"] for chunks in tr.last_stage_metrics for m in chunks]
    walls = [h["wall_s"] for h in out["history"]]
    steady = float(np.median(walls[1:])) if steps > 1 else walls[0]
    print(f"pipeline {name}: stage FLOPs per step {flops} (4x the "
          f"forward's aten products and attention), "
          f"{sum(flops) / steady / 1e12:.1f} TFLOP/s over the step time",
          flush=True)
    print(f"pipeline {name}: runtime_mpmd_* of the last step (the trainer's "
          f"StepProfiler, {tr.profiler.flops / 1e12:.3f} TFLOP per step): "
          f"{profile_fields(tr.profiler.last)} [{card}]", flush=True)
    if not all(f > 0 for f in flops):
        fail(f"a stage counted no FLOPs: {flops}")
    print(f"pipeline {name}: step time {steady * 1e3:.1f} ms (median of "
          f"steps 2-{steps}), {M * L / steady:.1f} tokens/s; last step "
          f"per stage (fwd s, bwd+recompute s) {fwd_bwd}; analytic bubble "
          f"{out['bubble_fraction_analytic']:.4f}; peak memory allocated "
          f"{peak}; replay budget {out['replay_budget']}; phase 7's recipe "
          f"step at the same {M * L} tokens {recipe_step_s * 1e3:.1f} ms, "
          f"pipeline/recipe {steady / recipe_step_s:.3f} [{card}]",
          flush=True)
    base = tr.state_digests()
    in_process = {"losses": [h["loss"] for h in out["history"]],
                  "digests": base, "step_s": steady,
                  "launches": per_step}
    free_trainer(tr, device)
    print(f"pipeline (a): {time.perf_counter() - t_part:.1f} s", flush=True)

    # (b) the same, stage 1 killed in step 3's first forward
    t_part = time.perf_counter()
    tr = pipeline_trainer(train, builders(2), M)
    tr.start()
    tr.handles[1]._fail_at = (steps, "F")
    zero_counts(ops)                   # main path: recovery and replay
    t0 = time.perf_counter()
    tr.fit(data_fn, steps)
    fit_s = time.perf_counter() - t0
    add_counts(total, ops)
    digests = tr.state_digests()
    print(f"pipeline elastic: recoveries {tr.recoveries}, fit {fit_s:.2f} "
          f"s, part (b) {time.perf_counter() - t_part:.1f} s; digests equal "
          f"the uninterrupted run's: {digests == base}", flush=True)
    if not tr.recoveries or digests != base:
        fail("the pipeline's recovery did not land the uninterrupted run's "
             "state bit for bit")
    check_compiled_once("pipeline elastic", tr)
    free_trainer(tr, device)

    # (c) 4 virtual stages on 2 hosts against the plain 4-stage pipeline
    t_part = time.perf_counter()
    runs = {}
    for v in (1, 2):
        tr = pipeline_trainer(train, builders(4), M, virtual_stages=v)
        zero_counts(ops)               # main path: 4 virtual stages
        out = tr.fit(data_fn, inter_steps)
        add_counts(total, ops)
        check_compiled_once(f"pipeline virtual_stages={v}", tr)
        runs[v] = (tr.state_digests(), out)
        free_trainer(tr, device)
    print(f"pipeline interleaved: 4 virtual stages of "
          f"{cfg.n_layers // 4} blocks, {inter_steps} steps; analytic "
          f"bubble plain (4 hosts) "
          f"{runs[1][1]['bubble_fraction_analytic']:.4f}, interleaved (2 "
          f"hosts, v=2) {runs[2][1]['bubble_fraction_analytic']:.4f}; "
          f"step walls plain "
          f"{[h['wall_s'] for h in runs[1][1]['history']]} s, interleaved "
          f"{[h['wall_s'] for h in runs[2][1]['history']]} s; digests "
          f"equal: {runs[1][0] == runs[2][0]}; part (c) "
          f"{time.perf_counter() - t_part:.1f} s", flush=True)
    if runs[1][0] != runs[2][0]:
        fail("the interleaved pipeline's state differs from the plain one")

    # (d) the SPMD pipeline_apply on a world of one rank: S = 1
    zero_counts(ops)                   # main path: pipeline_apply
    run_spmd_pipeline(models, parallel, ops, cfg, weights, data_fn, device,
                      spmd_blocks, loss_chunk)
    add_counts(total, ops)
    del weights
    release(device)
    print(f"phase 13 (pipeline): {time.perf_counter() - t_phase:.1f} s, "
          f"launches {total}", flush=True)
    return total, in_process


def run_spmd_pipeline(models, parallel, ops, cfg, weights, data_fn, device,
                      n_blocks, loss_chunk):
    """Phase 13 (d): pipeline_apply over a mesh whose one dim is ``stage``
    (world of one: S = 1) through n_blocks blocks as one stage, against
    the same blocks run microbatch by microbatch: the loss and every
    gradient bitwise equal, the same kernel launches."""
    from torch.func import functional_call
    mesh = mesh_of(parallel, device, fsdp=1, stage=-1)
    stage = models.BlockStage(cfg, n_blocks, device="meta")
    sd = models.stage_state_dict(weights, 0, n_blocks)
    unembed = weights["unembed"].to(cfg.dtype)
    inputs, targets = data_fn(1)
    xs = torch.stack(inputs).to(device)
    tgts = [t.to(device) for t in targets]

    def stage_fn(p, x):
        return functional_call(stage, p, (x,))

    def loss_of(ys):
        return sum(parallel.chunked_cross_entropy(
            ys[m], unembed, tgts[m], chunk=loss_chunk)[0]
            for m in range(len(tgts))) / len(tgts)

    params = parallel.shard_stage_params(
        parallel.stack_stage_params([sd]), mesh)
    for p in params.values():
        p.requires_grad_(True)
    before = read_counts(ops)
    loss = loss_of(parallel.pipeline_apply(stage_fn, params, xs, mesh))
    loss.backward()
    sync(device)
    mid = read_counts(ops)
    plain = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
    ref = loss_of(torch.stack([stage_fn(plain, x) for x in xs]))
    ref.backward()
    sync(device)
    after = read_counts(ops)
    launches = [{k: mid[k] - before[k] for k in mid},
                {k: after[k] - mid[k] for k in mid}]
    equal = [torch.equal(params[k].grad.to_local()[0], plain[k].grad)
             for k in sd]
    print(f"pipeline_apply on mesh {mesh.mesh_dim_names} "
          f"{tuple(mesh.shape)}: {n_blocks} blocks, {len(tgts)} "
          f"microbatches; loss {loss.item():.6f} vs one after another "
          f"{ref.item():.6f} (bitwise {torch.equal(loss, ref)}); gradients "
          f"bitwise equal {sum(equal)}/{len(equal)}; launches {launches}",
          flush=True)
    if not torch.equal(loss, ref) or not all(equal):
        fail("pipeline_apply at S = 1 differs from the blocks run one after "
             "another")
    if launches[0] != launches[1]:
        fail(f"pipeline_apply launched {launches[0]}, the blocks one after "
             f"another {launches[1]}")


# ------------------------------------------------------------- phase 14

# the flash kernels' wrapper names, as the actor stages report launches
WRAPPER_OF = {"flash_fwd": "flash_attention_fwd",
              "flash_bwd_dq": "flash_attention_bwd_dq",
              "flash_bwd_dkv": "flash_attention_bwd_dkv"}


def _b1_in_worker(q, k, v):
    """Phase 14 (a), in a num_gpus=1 worker: B1 on tensors that arrived
    from the driver's card, with this process's launch counter."""
    from ray_tpu_torch.ops import attention as ops
    before = ops.flash_attention_fwd.launches
    o, lse = ops.flash_attention_fwd(q, k, v, True)
    torch.cuda.synchronize()
    return {"mask": os.environ.get("CUDA_VISIBLE_DEVICES"), "o": o,
            "lse": lse, "launches": ops.flash_attention_fwd.launches - before,
            "device": str(o.device), "name": torch.cuda.get_device_name(0)}


def _mask_of_worker():
    return os.environ.get("CUDA_VISIBLE_DEVICES")


class _HalfGpu:
    """A num_gpus=0.5 actor: reports the mask its process was given."""

    def mask(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")


class _CudaMaker:
    """A GPU actor returning a CUDA tensor made from a seed."""

    def make(self, n, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(n, generator=g, device="cuda").to(torch.bfloat16)


def _session_pids(session, module=None):
    """PIDs of the runtime session ``session``: processes whose arguments
    carry its name (the GCS, node managers and workers are started with
    ``--session-name``), running ``module`` if given. Another runtime on
    the machine has another session name."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if session.encode() in argv and (
                module is None or module.encode() in argv):
            out.append(int(pid))
    return out


def _loads_torch(pid):
    """Whether a process has libtorch or the CUDA driver mapped."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            maps = f.read()
    except OSError:
        return None
    return "libtorch" in maps or "libcuda" in maps


def _arena(rt):
    import ctypes
    store = rt._get_worker().core.store
    base = ctypes.addressof(store._mem)
    return base, base + ctypes.sizeof(store._mem)


def runtime_card(rt, ops, card):
    """Phase 14 (a): GPUs detected by the control plane, masks, B1 in a
    worker, and fractional sharing."""
    res = rt.cluster_resources()
    session = rt._context.node.session_name
    control = {w: _session_pids(session, f"ray_tpu_torch._private.{w}")
               for w in ("gcs", "node_manager")}
    torch_in_control = {w: [_loads_torch(p) for p in pids]
                        for w, pids in control.items()}
    print(f"runtime: cluster_resources {res}; control-plane processes "
          f"{control}, libtorch/libcuda mapped {torch_in_control} [{card}]",
          flush=True)
    if res.get("GPU") != 1.0:
        fail(f"the runtime detected {res.get('GPU')} GPUs, want 1")
    if not all(control.values()) or any(
            v is not False for vs in torch_in_control.values() for v in vs):
        fail("a control-plane process loaded torch or CUDA (or was not "
             "found)")

    g = torch.Generator(device="cuda").manual_seed(14)
    q, k, v = case_inputs(g, "tpu-7b prefill", 8, 512, 512, 32, 8, 128,
                          torch.bfloat16)
    t0 = time.perf_counter()
    got = rt.get(rt.remote(num_gpus=1)(_b1_in_worker).remote(q, k, v),
                 timeout=600)
    task_s = time.perf_counter() - t0
    ro, rlse = ops.flash_attention_fwd_reference(q, k, v, True)
    o, lse = got["o"], got["lse"]
    err_o = (o.float() - ro.float()).abs().max().item()
    err_lse = (lse - rlse).abs().max().item()
    ok = (o.device == q.device and lse.device == q.device
          and torch.allclose(o.float(), ro.float(), rtol=BF16_TOL,
                             atol=BF16_TOL)
          and torch.allclose(lse, rlse, rtol=FP32_TOL, atol=FP32_TOL))
    print(f"runtime: a num_gpus=1 task saw CUDA_VISIBLE_DEVICES="
          f"{got['mask']!r} ({got['name']}, {got['device']}), ran B1 at the "
          f"tpu-7b prefill shape (8x512, H=32, Hkv=8, D=128, bf16) with "
          f"{got['launches']} launch(es) in the worker, returned o on "
          f"{o.device}: max|o-plain| {err_o:.3e}, max|lse-plain| "
          f"{err_lse:.3e} (tol {BF16_TOL:g}/{FP32_TOL:g}); task with the "
          f"worker's start {task_s:.2f} s", flush=True)
    if got["mask"] != "0" or got["launches"] < 1 or not ok:
        fail("the GPU task's mask, launch count or B1 result is wrong")
    del q, k, v, o, lse, ro, rlse

    half = rt.remote(num_gpus=0.5)(_HalfGpu)
    a, b = half.remote(), half.remote()
    masks = rt.get([a.mask.remote(), b.mask.remote()], timeout=300)
    whole = rt.remote(num_gpus=1)(_mask_of_worker).remote()
    ready, _ = rt.wait([whole], timeout=3.0)
    waited = not ready
    rt.kill(a)
    rt.kill(b)
    after = rt.get(whole, timeout=300)
    print(f"runtime: two num_gpus=0.5 actors got masks {masks}; a "
          f"num_gpus=1 task waited while they lived: {waited}, then ran "
          f"with {after!r}", flush=True)
    if masks != ["0", "0"] or not waited or after != "0":
        fail("fractional GPUs were not shared, or a whole request did not "
             "wait for them")


def runtime_objects(rt, card):
    """Phase 14 (b): a 1 GiB bf16 tensor through the store from the CPU
    (zero-copy read) and from the card, and a CUDA tensor returned by a
    GPU actor."""
    n = 2 ** 29                       # 1 GiB of bf16
    g = torch.Generator(device="cuda").manual_seed(15)
    on_card = torch.randn(n, generator=g, device="cuda").to(torch.bfloat16)
    host = on_card.cpu()
    gb = n * 2 / 1e9                  # GB/s below: 10^9 bytes a second
    lo, hi = _arena(rt)
    rates = {}
    t0 = time.perf_counter()
    ref = rt.put(host)
    rates["cpu_put"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = rt.get(ref)
    rates["cpu_get"] = time.perf_counter() - t0
    zero_copy = lo <= got.data_ptr() < hi
    cpu_equal = torch.equal(got, host)
    del got, ref
    t0 = time.perf_counter()
    ref = rt.put(on_card)
    rates["cuda_put"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = rt.get(ref)
    torch.cuda.synchronize()
    rates["cuda_get"] = time.perf_counter() - t0
    cuda_equal = got.device == on_card.device and torch.equal(got, on_card)
    del got, ref, host
    maker = rt.remote(num_gpus=1)(_CudaMaker).remote()
    t0 = time.perf_counter()
    from_actor = rt.get(maker.make.remote(n, 15), timeout=600)
    torch.cuda.synchronize()
    actor_s = time.perf_counter() - t0
    actor_equal = (from_actor.device == on_card.device
                   and torch.equal(from_actor, on_card))
    rt.kill(maker)
    del from_actor, on_card
    torch.cuda.empty_cache()
    print(f"runtime objects: 1 GiB bf16 tensor: CPU put "
          f"{gb / rates['cpu_put']:.2f} GB/s ({rates['cpu_put']:.3f} s), "
          f"get {gb / rates['cpu_get']:.2f} GB/s ({rates['cpu_get']:.6f} s, "
          f"zero-copy {zero_copy}), bitwise equal {cpu_equal}; CUDA put "
          f"{gb / rates['cuda_put']:.2f} GB/s ({rates['cuda_put']:.3f} s), "
          f"get to cuda:0 {gb / rates['cuda_get']:.2f} GB/s "
          f"({rates['cuda_get']:.3f} s), bitwise equal {cuda_equal}; a "
          f"GPU actor's CUDA tensor landed on cuda:0 in {actor_s:.2f} s "
          f"(the actor's start included), bitwise equal {actor_equal} "
          f"[{card}]", flush=True)
    if not (zero_copy and cpu_equal and cuda_equal and actor_equal):
        fail("a tensor did not come back bitwise equal, or the CPU read "
             "was not zero-copy")


def runtime_pipeline(models, parallel, train, ops, card, in_process,
                     device="cuda", name="tpu-3b", n_layers=None, L=1024,
                     M=4, steps=3, loss_chunk=256, lr=3e-4):
    """Phase 14 (c) and (d): phase 13 (a)'s pipeline (the same arguments,
    so the same seed) with its two stages as actors, each given half of
    the card, then with stage 1's actor killed twice at fixed points.
    Returns the flash launches the actors counted in (c) and (d)."""
    import ray_tpu_torch as rt
    cfg = recipe_cfg(models, name)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    weights = models.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device,
        dtype=cfg.param_dtype)
    data_fn = pipeline_data(cfg, weights, device, M, L, steps)
    t0 = time.perf_counter()
    wref = rt.put({k: v.cpu() for k, v in weights.items()})
    put_s = time.perf_counter() - t0
    del weights
    release(device)
    builders = train.block_stage_builders(
        cfg, wref, 2, parallel.adafactor(lr), loss_chunk, device=device)
    gpus = [{"GPU": 0.5}] * 2 if device == "cuda" else None
    want = {WRAPPER_OF[k]: n for k, n in in_process["launches"].items()}
    total = {k: 0 for k in WRAPPER_OF}

    def trainer(provision_fn=None, **config):
        return train.MPMDPipelineTrainer(
            builders, train.MPMDConfig(n_microbatches=M, **config),
            train.FailureConfig(max_failures=2, restart_policy="stage",
                                restart_backoff_s=0.0),
            remote=True, stage_resources=gpus, provision_fn=provision_fn)

    def add(history):
        for h in history:
            for k in WRAPPER_OF:
                total[k] += h.get("launches", {}).get(WRAPPER_OF[k], 0)

    # (c)
    tr = trainer()
    t0 = time.perf_counter()
    tr.start()
    start_s = time.perf_counter() - t0
    zero_counts(ops)                  # main path: in the stage actors
    out = tr.fit(data_fn, steps)
    if any(read_counts(ops).values()):
        fail("the driver launched a kernel; the stages must")
    add(out["history"])
    losses = [h["loss"] for h in out["history"]]
    digests = tr.state_digests()
    walls = [h["wall_s"] for h in out["history"]]
    steady = float(np.median(walls[1:]))
    mem = tr.memory_stats()
    launches = [h.get("launches") for h in out["history"]]
    print(f"runtime pipeline: {name} weights into the store "
          f"{put_s:.2f} s (object {wref.id.hex()[:16]}); "
          f"{arena_line(rt)}; 2 stage actors (resources {gpus}, pids "
          f"{[m['pid'] for m in mem]}) started in {start_s:.2f} s; losses "
          f"{losses} vs in-process {in_process['losses']} (bitwise "
          f"{losses == in_process['losses']}); digests equal "
          f"{digests == in_process['digests']}; launches per step, summed "
          f"over the actors {launches} (want {want} each)", flush=True)
    for h in out["history"]:
        compute = [h[f"stage{s}_compute_s"] for s in range(2)]
        print(f"runtime pipeline step {h['step']}: wall "
              f"{h['wall_s'] * 1e3:.1f} ms, stage compute "
              f"{[round(c * 1e3, 1) for c in compute]} ms, measured "
              f"bubble {[h[f'stage{s}_bubble_fraction'] for s in range(2)]}",
              flush=True)
    print(f"runtime pipeline: step time {steady * 1e3:.1f} ms (median of "
          f"steps 2-{steps}) vs in-process {in_process['step_s'] * 1e3:.1f} "
          f"ms, actors/in-process {steady / in_process['step_s']:.3f}; "
          f"peak memory allocated per actor "
          f"{[round(m['peak_bytes'] / 2 ** 30, 2) for m in mem]} GiB "
          f"[{card}]", flush=True)
    if losses != in_process["losses"] or digests != in_process["digests"]:
        fail("the actor stages' losses or state differ from the in-process "
             "pipeline's")
    if any(x != want for x in launches):
        fail(f"the actor stages launched {launches}, want {want} per step")
    check_compiled_once("runtime pipeline", tr)
    tr.shutdown()
    print(f"runtime pipeline (c): {arena_line(rt)}", flush=True)

    # (d) synchronous checkpoints at every step, and stage 1's actor
    # armed (the stage_step / stage_seal chaos channels) to die twice at
    # fixed points: in step 2 at its 3rd op (it checks stage_step once
    # per forward and once per backward, 2M times a step), with the
    # step-1 boundary sealed, so the survivor rolls back to its own
    # snapshot; then its replacement when asked for its step-2 snapshot,
    # before sealing it, so in step 3 the survivor, whose own snapshot is
    # newer, is restored to the step-1 boundary
    from ray_tpu_torch.util.chaos import StageKiller
    arms = {1: StageKiller(at_call=2 * M + 3).env({}),
            2: StageKiller(at_call=1, channel="stage_seal").env({})}
    made = []

    def provision(idx, snapshot=None):
        env = {}
        if idx == 1:
            made.append(idx)
            env = arms.get(len(made), {})
        return train.ActorStageHandle.provision(
            idx, 2, M, builders[idx], snapshot,
            resources=gpus[idx] if gpus else None,
            extra_options={"runtime_env": {"env_vars": env}} if env else None)

    tr = trainer(provision, checkpoint_every=1, async_checkpoint=False)
    t0 = time.perf_counter()
    out = tr.fit(data_fn, steps)
    fit_s = time.perf_counter() - t0
    add(out["history"])
    digests_d = tr.state_digests()
    got = [(r["step"], r["stages"], r["boundary"], r["survivors_restored"],
            r["replayed_steps"]) for r in tr.recoveries]
    want_rec = [(2, [1], 1, False, [2]), (3, [1], 1, True, [2, 3])]
    print(f"runtime pipeline elastic: stage 1 provisioned {len(made)} "
          f"times; recoveries (step, stages, boundary, survivors restored "
          f"rather than rolled back, replayed) {got} (want {want_rec}), "
          f"recovery {[r['recovery_s'] for r in tr.recoveries]} s, causes "
          f"{[r['cause'][:120] for r in tr.recoveries]}; fit {fit_s:.2f} s; "
          f"digests equal (c)'s: {digests_d == digests}", flush=True)
    if got != want_rec or digests_d != digests:
        fail("the killed stage actors were not recovered through both "
             "ways back to a boundary, or not to (c)'s bits")
    if any(h.get("launches") != want for h in out["history"]):
        fail(f"the actor stages launched "
             f"{[h.get('launches') for h in out['history']]} in (d), want "
             f"{want} per step")
    tr.shutdown()
    print(f"runtime pipeline (d): {arena_line(rt)}", flush=True)
    del wref
    return total


def arena_line(rt):
    """The driver node's arena: bytes in use of its capacity, and what
    LRU eviction has taken (objects, bytes) since the store began."""
    st = rt._get_worker().core.store.stats()
    return (f"arena {st['bytes_in_use'] / 2 ** 30:.2f} of "
            f"{st['capacity'] / 2 ** 30:.2f} GiB in use, "
            f"{st['num_evictions']} objects ({st['bytes_evicted'] / 2 ** 30:.2f}"
            f" GiB) and {st['span_evictions']} spanning objects evicted so "
            f"far")


def heartbeat_gap(rt, what):
    """Print the longest heartbeat silence the GCS saw from the node in
    this session, beside the silence after which it declares the node
    dead."""
    from ray_tpu_torch._private.config import cfg
    gap = max(n["max_heartbeat_gap_s"] for n in rt.nodes())
    print(f"{what}: the longest heartbeat silence the GCS saw from the "
          f"node {gap:.3f} s (a node is dead after "
          f"{cfg.node_death_timeout_s} s)", flush=True)


def run_runtime(models, parallel, train, ops, card, in_process):
    """Phase 14: the runtime core on the card. Returns the flash launches
    counted in the stage actors of (c) and (d)."""
    import ray_tpu_torch as rt
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    rt.init(object_store_memory=32 * 2 ** 30)
    session = rt._context.node.session_name
    print(f"runtime: init {time.perf_counter() - t0:.2f} s (session "
          f"{session})", flush=True)
    try:
        runtime_card(rt, ops, card)
        runtime_objects(rt, card)
        counts = runtime_pipeline(models, parallel, train, ops, card,
                                  in_process, n_layers=PIPELINE_LAYERS)
        heartbeat_gap(rt, "runtime")
    finally:
        rt.shutdown()
    left, shm = session_left(session)
    print(f"runtime: after shutdown, the session's processes {left}, "
          f"/dev/shm files {shm}; phase 14 {time.perf_counter() - t_phase:.1f}"
          f" s, actor launches {counts}", flush=True)
    if left or shm:
        fail("the runtime left processes or shared-memory files behind")
    return counts


# ------------------------------------------------------------- phase 16

# phases 8 and 18 run tpu-7b at full width cut to 16 of its 32 layers,
# which leaves the whole smoke room for phases 20 and 21
SERVE_LAYERS = 16

def _serve_classes(inference):
    """LLMDeployment and the disaggregated decode tier with what phase 16
    reads from inside a replica: its GPU ids and mask, its construction
    time, how its weights were resolved, its flash launches, the requests
    it admitted, and (decode tier) each KV hand-off's time. Made here, in
    a function, so the runtime ships them by value."""
    import threading

    from ray_tpu_torch.serve.disagg import DisaggLLMDeployment

    class Probe:
        def _start_probe(self):
            self._t_init = time.perf_counter()
            self._submits = []

        def _end_probe(self):
            from ray_tpu_torch.serve import weights
            self.init_s = time.perf_counter() - self._t_init
            self.weights = dict(weights.last_resolve)

        def probe(self):
            import sys

            import ray_tpu_torch as rt
            ops = sys.modules.get("ray_tpu_torch.ops.attention")
            launches = {name: getattr(ops, fn).launches for name, fn in (
                ("flash_fwd", "flash_attention_fwd"),
                ("flash_bwd_dq", "flash_attention_bwd_dq"),
                ("flash_bwd_dkv", "flash_attention_bwd_dkv"))} if ops else {}
            return {"ids": rt.get_gpu_ids(),
                    "mask": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "device": str(self.engine.device), "pid": os.getpid(),
                    "init_s": self.init_s, "weights": self.weights,
                    "launches": launches}

        def push_metrics(self):
            from ray_tpu_torch.util import metrics
            return metrics.push_once()

        def _submit_request(self, prompt_tokens, max_new_tokens, *args):
            self._submits.append((list(prompt_tokens), int(max_new_tokens)))
            return super()._submit_request(prompt_tokens, max_new_tokens,
                                           *args)

        def submitted(self):
            """(prompt tokens, max_new_tokens) of each admitted request."""
            return list(self._submits)

    class SmokeLLM(Probe, inference.LLMDeployment):
        def __init__(self, *args, **kwargs):
            self._start_probe()
            super().__init__(*args, **kwargs)
            self._end_probe()

    class SmokeDecode(Probe, DisaggLLMDeployment):
        def __init__(self, *args, **kwargs):
            self._start_probe()
            super().__init__(*args, **kwargs)
            self._end_probe()
            self._handoffs = []
            self._lock = threading.Lock()

        def _submit_request(self, *args, **kwargs):
            imports = self.engine.kv_imports
            t0 = time.perf_counter()
            handle = super()._submit_request(*args, **kwargs)
            with self._lock:
                self._handoffs.append({
                    "seconds": time.perf_counter() - t0,
                    "imports": self.engine.kv_imports - imports})
            return handle

        def handoff_info(self):
            def counter(m):
                return {str(dict(tags)): v
                        for tags, v in m._snapshot()["samples"]}
            return {"admissions": list(self._handoffs),
                    "stats": self.engine.stats(),
                    "handoffs": counter(self._m_handoffs),
                    "bytes": counter(self._m_handoff_bytes),
                    "tokens": counter(self._m_handoff_tokens)}

    return SmokeLLM, SmokeDecode


def _params_fn(cfg, marks, device):
    """A params_fn for a replica: phase 3's seeded init on the replica's
    card, leaving a line in ``marks`` each time it runs."""
    def params_fn():
        import torch as _torch

        from ray_tpu_torch.models import init_params
        with open(marks, "a") as f:
            f.write(f"{os.getpid()}\n")
        return init_params(cfg, _torch.Generator(device=device)
                           .manual_seed(0), device)
    return params_fn


def _runs(path):
    try:
        with open(path) as f:
            return len(f.read().split())
    except FileNotFoundError:
        return 0


def _seeded_model(models, cfg, device):
    model = models.TransformerLM(cfg, device="meta")
    model.load_state_dict(models.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device),
        assign=True)
    sync(device)
    return model


def _http_stream(url, body, out, key):
    """POST one request with a streamed response, read by urllib line by
    line (one NDJSON line per token); records the tokens and the time of
    each, from the moment the request was sent."""
    import urllib.request
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json", "X-RayTPU-Stream": "1"})
    t0 = time.perf_counter()
    toks, times = [], []
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            status = resp.status
            for line in resp:
                if line.strip():
                    toks.append(json.loads(line))
                    times.append(time.perf_counter() - t0)
    except Exception as e:   # recorded and failed on by the caller
        status = f"{type(e).__name__}: {e}"
    out[key] = {"status": status, "tokens": toks, "times": times}


def _handle_stream(handle, prompt, n, out, key):
    t0 = time.perf_counter()
    toks, times = [], []
    for tok in handle.options(stream=True).remote(prompt, max_new_tokens=n):
        toks.append(tok)
        times.append(time.perf_counter() - t0)
    out[key] = {"status": 200, "tokens": toks, "times": times}


def _concurrently(fn, args_list):
    import threading
    out = {}
    threads = [threading.Thread(target=fn, args=(*args, out, i))
               for i, args in enumerate(args_list)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return [out.get(i) for i in range(len(args_list))]


def _ttft_tpot(times):
    """TTFT and mean time per output token after the first, in ms."""
    tpot = ((times[-1] - times[0]) / (len(times) - 1) * 1e3
            if len(times) > 1 else float("nan"))
    return round(times[0] * 1e3, 2), round(tpot, 3)


def _llm_metrics(rt):
    """serve_llm_ttft_ms and serve_llm_tpot_ms from the /metrics text (the
    GCS's aggregate of every process's push, as render_prometheus renders
    it): {name: (sum, count)} summed over the processes."""
    from ray_tpu_torch.util.metrics import render_prometheus
    text = render_prometheus(rt._get_worker().gcs_call("get_metrics"))
    out = {}
    for name in ("serve_llm_ttft_ms", "serve_llm_tpot_ms"):
        s = c = 0.0
        for line in text.splitlines():
            if line.startswith(f"{name}_sum"):
                s += float(line.split()[-1])
            elif line.startswith(f"{name}_count"):
                c += float(line.split()[-1])
        out[name] = (s, c)
    return out


def _metric_means(before, after):
    out = {}
    for name in after:
        ds = after[name][0] - before.get(name, (0.0, 0.0))[0]
        dc = after[name][1] - before.get(name, (0.0, 0.0))[1]
        out[name] = (round(ds / dc, 3) if dc else None, int(dc))
    return out


def _push_all(rt, handle):
    for r in handle._router.replicas:
        rt.get(r.handle_request.remote("push_metrics", (), {}), timeout=60)


def _replicas(handle, n, timeout_s=900):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        handle._router.refresh(force=True)
        if len(handle._router.replicas) >= n:
            return list(handle._router.replicas)
        time.sleep(0.2)
    fail(f"serve: {n} replicas did not come up in {timeout_s} s")


def _delete_app(rt, serve, app, device, timeout_s=300):
    """serve.delete, then wait until the app's GPU claims are released (a
    replica the controller was replacing may still be coming up)."""
    serve.delete(app)
    release(device)
    if device != "cuda":
        return
    deadline = time.monotonic() + timeout_s
    while rt.available_resources().get("GPU", 0.0) < 1.0:
        if time.monotonic() > deadline:
            fail(f"serve: the card's GPU claims were not released after "
                 f"deleting {app!r}: {rt.available_resources()}")
        time.sleep(0.2)


def _probe_all(rt, replicas):
    return [rt.get(r.handle_request.remote("probe", (), {}), timeout=900)
            for r in replicas]


def serve_start_and_requests(rt, serve, models, inference, ops, card, cls,
                             marks, device, name, engine, lens, new):
    """Phase 16 (a) and (b): one replica with the whole card serves
    ``name`` at full width and depth; phase 4's requests over HTTP and
    over a streaming handle, all at once, each stream held against a
    one-shot forward, beside the in-process engine on the same mix."""
    cfg = models.MODEL_REGISTRY[name]
    gpus = {"num_gpus": 1} if device == "cuda" else {}
    t0 = time.perf_counter()
    serve.start(http_port=0)
    start_s = time.perf_counter() - t0
    (addr,) = [p["http"] for p in serve.proxies().values()]
    dep = serve.deployment(cls, name="llm", ray_actor_options=gpus)
    t0 = time.perf_counter()
    handle = serve.run(dep.bind(name, params_fn=_params_fn(cfg, marks,
                                                           device),
                                device=device, **engine),
                       name="llm", route_prefix="/")
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in lens]
    (info,) = _probe_all(rt, _replicas(handle, 1))   # built
    ready_s = time.perf_counter() - t0
    first = {}
    _http_stream(f"http://{addr}/", {"prompt_tokens": [1, 2, 3],
                                     "max_new_tokens": 1}, first, 0)
    first_s = time.perf_counter() - t0
    w = info["weights"]
    print(f"serve (a): {cfg.n_layers} layers at full width; proxy up at "
          f"{addr} in {start_s:.2f} s; replica pid "
          f"{info['pid']} GPU ids {info['ids']} mask {info['mask']!r} on "
          f"{info['device']}; replica ready {ready_s:.2f} s after serve.run "
          f"(its worker's start, imports and CUDA context, then the "
          f"LLMDeployment construction {info['init_s']:.2f} s, of which "
          f"params_fn "
          f"{w.get('load_s', float('nan')):.2f} s and the weights' publish "
          f"into the store {w.get('publish_s', float('nan')):.2f} s (source "
          f"{w.get('source')}, "
          f"{models.count_params(models.TransformerLM(cfg, device='meta')) * 2 / 1e9:.2f}"
          f" GB); first answer over HTTP {first_s:.2f} s after serve.run "
          f"(status {first[0]['status']}) [{card}]", flush=True)
    if first[0]["status"] != 200 or len(first[0]["tokens"]) != 1:
        fail(f"serve: the first HTTP answer was {first[0]}")
    if device == "cuda" and (info["ids"] != ["0"] or info["mask"] != "0"):
        fail(f"serve: a num_gpus=1 replica got ids {info['ids']} and mask "
             f"{info['mask']!r}, want ['0'] and '0'")
    if info["ids"] != ([info["mask"]] if info["mask"] else []):
        fail(f"serve: the replica's GPU ids {info['ids']} are not its mask "
             f"{info['mask']!r}")
    if _runs(marks) != 1 or w.get("source") != "loader":
        fail(f"serve: params_fn ran {_runs(marks)} times, source "
             f"{w.get('source')}; want once, through the loader")

    # (b) the six requests at once: over HTTP, over a handle, over HTTP
    # again (the order's share of a difference shows between the two
    # HTTP runs)
    reqs = [(p.tolist(), n) for p, n in zip(prompts, new)]

    def over_http(p, n, out, i):
        _http_stream(f"http://{addr}/", {"prompt_tokens": p,
                                          "max_new_tokens": n}, out, i)

    def over_a_handle(p, n, out, i):
        _handle_stream(handle, p, n, out, i)
    zero_counts(ops)
    results, metrics = [], []
    for what, fn in (("HTTP", over_http), ("handle", over_a_handle),
                     ("HTTP, again", over_http)):
        _push_all(rt, handle)
        before = _llm_metrics(rt)
        t0 = time.perf_counter()
        runs = _concurrently(fn, reqs)
        wall = time.perf_counter() - t0
        _push_all(rt, handle)
        metrics.append(_metric_means(before, _llm_metrics(rt)))
        results.append((what, runs, wall))
    for what, runs, _ in results:
        for i, (r, n) in enumerate(zip(runs, new)):
            if r is None or r["status"] != 200 or len(r["tokens"]) != n:
                fail(f"serve (b): {what} request {i} gave "
                     f"{None if r is None else (r['status'], len(r['tokens']))}"
                     f", want 200 and {n} tokens")

    # the same mix in process, on a model from the same seed, after a
    # one-token warm-up as the replica had (its first HTTP answer)
    model = _seeded_model(models, cfg, device)
    eng = inference.InferenceEngine(
        model, inference.EngineConfig(
            n_slots=engine["n_slots"], max_len=engine["max_len"],
            prefill_chunk=engine["prefill_chunk"],
            prefill_budget=engine["prefill_budget"]),
        device=device, seed=0).start()
    eng.submit([1, 2, 3], max_new_tokens=1).tokens()
    sync(device)
    inproc = []
    for what in ("in process", "in process, again"):
        t0 = time.perf_counter()
        hs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, new)]
        local = [h.tokens() for h in hs]
        inproc.append((what, hs, local, time.perf_counter() - t0))
    eng.stop()
    launches = read_counts(ops)
    (info,) = _probe_all(rt, handle._router.replicas)
    for (what, runs, wall), m in zip(results, metrics):
        rows = [_ttft_tpot(r["times"]) for r in runs]
        print(f"serve (b) over {what}: 6 requests at once, "
              f"{sum(new)} tokens in {wall:.3f} s; per request (TTFT ms, "
              f"TPOT ms) as the client saw them {rows}; the replica's "
              f"/metrics (mean ms, count) {m} [{card}]", flush=True)
    for what, hs, toks, wall in inproc:
        rows = [(round(h.ttft_s * 1e3, 2),
                 round((h.finished_t - h.first_token_t) / (len(t) - 1)
                       * 1e3, 3)) for h, t in zip(hs, toks)]
        print(f"serve (b) {what} (phase 4's engine, the same mix at once): "
              f"{sum(new)} tokens in {wall:.3f} s; per request (TTFT ms, "
              f"TPOT ms) {rows} [{card}]", flush=True)
    print(f"serve (b): flash launches in the replica {info['launches']}, "
          f"in this process (its engine) {launches}", flush=True)
    if any(launches.values()) or any(info["launches"].values()):
        fail("serve: an engine launched a flash kernel (it attends through "
             "the cache)")
    for what, runs, _ in results:
        check_one_shot(f"serve over {what}", model, models, prompts,
                       [r["tokens"] for r in runs], device)
    for what, _, toks, _ in inproc:
        check_one_shot(f"engine {what}", model, models, prompts, toks,
                       device)
    same = sum(a["tokens"] == b for a, b in zip(results[0][1], local))
    print(f"serve (b): HTTP streams equal to the in-process engine's "
          f"(informational; batching differs, bf16 ties may flip): "
          f"{same}/6", flush=True)
    del model, eng
    _delete_app(rt, serve, "llm", device)
    return launches


def serve_weight_plane_and_kill(rt, serve, models, ops, card, cls, marks,
                                device, cfg, engine, new=48):
    """Phase 16 (c) and (d): two replicas at half the card each, built
    together; one runs params_fn and publishes, the other reads the
    weights from the store. Then one is killed mid-stream and the stream
    resumes on the survivor."""
    from ray_tpu_torch.util.chaos import ServeReplicaKiller
    gpus = {"num_gpus": 0.5} if device == "cuda" else {}
    dep = serve.deployment(cls, name="pair", num_replicas=2,
                           ray_actor_options=gpus)
    t0 = time.perf_counter()
    handle = serve.run(dep.bind(cfg, params_fn=_params_fn(cfg, marks,
                                                           device),
                                weights_key="smoke/pair", device=device,
                                stream_coalesce_tokens=8, **engine),
                       name="pair", route_prefix=None)
    infos = _probe_all(rt, _replicas(handle, 2))
    up_s = time.perf_counter() - t0
    runs = _runs(marks)
    print(f"serve (c): {cfg.n_layers}-layer {cfg.dtype} cut at full width, "
          f"2 replicas up in {up_s:.2f} s: "
          + "; ".join(f"pid {i['pid']} ids {i['ids']} mask {i['mask']!r} "
                      f"start {i['init_s']:.2f} s, weights "
                      f"{i['weights'].get('source')} in "
                      f"{i['weights'].get('seconds', float('nan')):.2f} s"
                      + (f" (params_fn {i['weights']['load_s']:.2f} s, "
                         f"publish {i['weights']['publish_s']:.2f} s)"
                         if i["weights"].get("source") == "loader" else
                         f" (waiting for the publish "
                         f"{i['weights'].get('wait_s', 0.0):.2f} s, the "
                         f"read from the store "
                         f"{i['weights'].get('get_s', float('nan')):.2f} s; "
                         f"the rest of the construction, the copy to the "
                         f"card and the engine: "
                         f"{i['init_s'] - i['weights'].get('seconds', 0.0):.2f}"
                         f" s)")
                      for i in infos)
          + f"; params_fn ran {runs} time(s) [{card}]", flush=True)
    if runs != 1 or sorted(i["weights"].get("source") for i in infos) != \
            ["arena", "loader"]:
        fail("serve (c): params_fn did not run exactly once, or the second "
             "replica did not read the weights from the store")
    if device == "cuda" and any(i["ids"] != ["0"] or i["mask"] != "0"
                                for i in infos):
        fail("serve (c): a num_gpus=0.5 replica's ids or mask is not '0'")

    # (d) an uninterrupted stream, then the same request with its replica
    # killed after 2 coalesced chunks. The survivor re-prefills the
    # delivered tokens: in bf16 a near-tied logit of the random model may
    # then pick another token than the uninterrupted decode did, so the
    # resumed stream is held against a one-shot forward, and the
    # survivor's record of what it was asked shows no token lost or
    # doubled.
    prompt = np.random.RandomState(16).randint(0, cfg.vocab_size, 200)
    stream = handle.options(stream=True)
    oracle = list(stream.remote(prompt.tolist(), max_new_tokens=new))
    pair = list(handle._router.replicas)
    killer = ServeReplicaKiller("pair", "pair")
    gen = stream.remote(prompt.tolist(), max_new_tokens=new)
    got = [next(gen) for _ in range(17)]
    t0 = time.perf_counter()
    if not killer.kill_one(prefer_busy=True):
        fail("serve (d): no replica to kill")
    got.extend(gen)
    resume_s = time.perf_counter() - t0

    def resumed_on(reps):
        out = []
        for r in reps:
            try:
                asked = rt.get(r.handle_request.remote("submitted", (), {}),
                               timeout=300)
            except (rt.ActorDiedError, rt.WorkerCrashedError):
                continue        # the killed one
            out += [(p[len(prompt):], n) for p, n in asked
                    if len(p) > len(prompt)]
        return out
    # the survivor's record; the replacement's only when it has none
    resumed = resumed_on(pair)
    where = "the survivor"
    if not resumed:
        handle._router.refresh(force=True)
        ids = {r._actor_id for r in pair}
        resumed = resumed_on([r for r in handle._router.replicas
                              if r._actor_id not in ids])
        where = "the replacement"
    print(f"serve (d): killed a replica after 17 of {new} tokens; the "
          f"stream resumed on {where}, the rest in {resume_s:.2f} s; "
          f"{len(got)} tokens; it was asked to go on after "
          f"{[len(t) for t, _ in resumed]} delivered tokens for "
          f"{[n for _, n in resumed]} more; equal to the uninterrupted "
          f"stream (informational in bf16): {got == oracle} (first "
          f"difference {first_diff(got, oracle)}) [{card}]", flush=True)
    if len(got) != new or len(resumed) != 1 or where != "the survivor":
        fail(f"serve (d): {len(got)} tokens, want {new}; {len(resumed)} "
             f"resumed requests on {where}, want 1 on the survivor")
    (done, more), = resumed
    if done != got[:len(done)] or more != new - len(done) \
            or len(done) < 17:
        fail("serve (d): the survivor was not asked to go on from exactly "
             "the delivered tokens: a token was lost or doubled")
    model = _seeded_model(models, cfg, device)
    check_one_shot("serve (d) resumed stream", model, models, [prompt],
                   [got], device)
    del model
    _delete_app(rt, serve, "pair", device)


def serve_disagg(rt, serve, models, inference, ops, card, cls, marks,
                 device, cfg, engine, prompt_len=512, new=32):
    """Phase 16 (e): build_disagg_app with one prefill and one decode
    replica at half the card each; a prompt prefilled on the prefill tier
    hands its KV spans to the decode tier through the store, whose greedy
    tokens must equal a colocated LLMDeployment's."""
    from ray_tpu_torch.serve import DeploymentHandle
    from ray_tpu_torch.serve.deployment import Application, Deployment
    from ray_tpu_torch.serve.disagg import build_disagg_app, unpack_kv_spans
    gpus = {"ray_actor_options": {"num_gpus": 0.5}} if device == "cuda" \
        else {}
    tier = dict(engine, params_fn=_params_fn(cfg, marks, device),
                weights_key="smoke/disagg", device=device)
    app = build_disagg_app(
        cfg, decode_replicas=1, prefill_replicas=1,
        prefill_kwargs=dict(tier, n_slots=2),
        decode_kwargs=dict(tier), prefill_deployment_kwargs=gpus,
        decode_deployment_kwargs=gpus)
    # the same graph, with the decode tier's class replaced by its
    # probing subclass
    app = Application(Deployment(cls, app.deployment.name,
                                 app.deployment.config), app.args,
                      app.kwargs)
    t0 = time.perf_counter()
    handle = serve.run(app, name="disagg", route_prefix=None)
    replicas = _replicas(handle, 1)
    _probe_all(rt, replicas)
    prefill = DeploymentHandle("prefill", "disagg")
    prefill.stats.remote().result(timeout=900)      # built too
    up_s = time.perf_counter() - t0
    # the first request after the deploy: the fresh prefill replica's
    # first export is this hand-off
    prompt = np.random.RandomState(5).randint(0, cfg.vocab_size,
                                              prompt_len)
    t0 = time.perf_counter()
    got = list(handle.options(stream=True).remote(prompt.tolist(),
                                                  max_new_tokens=new))
    req_s = time.perf_counter() - t0
    info = rt.get(replicas[0].handle_request.remote("handoff_info", (), {}),
                  timeout=60)
    out = prefill.prefill_export.remote(prompt.tolist()).result(timeout=600)
    spans = unpack_kv_spans(rt.get(out["ref"], timeout=600))
    span_bytes = sum(a.nbytes for s in spans for a in s)
    dtypes = sorted({f"{a.dtype}:{a.dtype.itemsize}B" for s in spans
                     for a in s})
    colocated = inference.LLMDeployment(
        cfg, params_fn=lambda: models.init_params(
            cfg, torch.Generator(device=device).manual_seed(0), device),
        weights_key=None, device=device, **engine)
    want = colocated.generate(prompt.tolist(), max_new_tokens=new)
    st = info["stats"]
    print(f"serve (e): prefill and decode tiers ({cfg.n_layers}-layer "
          f"{cfg.dtype} cut at full width) up in {up_s:.2f} s; the first "
          f"request, a {prompt_len}-token prompt: {len(got)} tokens in "
          f"{req_s:.2f} s; "
          f"hand-off {info['admissions']} (seconds of the admission, KV "
          f"imports), kv_imports {st['kv_imports']}, remote_prefix_tokens "
          f"{st['remote_prefix_tokens']}, serve_kv_handoffs_total "
          f"{info['handoffs']}, bytes {info['bytes']}; the prefill tier's "
          f"export: {out['covered']} tokens in {len(spans)} spans, "
          f"{span_bytes} bytes ({span_bytes / 2 ** 20:.1f} MiB), dtypes "
          f"{dtypes}; decode tier equal to the colocated LLMDeployment: "
          f"{got == want} (first difference {first_diff(got, want)}) "
          f"[{card}]", flush=True)
    if st["kv_imports"] != 1 or st["remote_prefix_tokens"] != \
            (prompt_len - 1) // engine["prefill_chunk"] * \
            engine["prefill_chunk"]:
        fail("serve (e): the decode tier did not import the prefill tier's "
             "blocks")
    if cfg.dtype == torch.bfloat16 and "bfloat16:2B" not in dtypes:
        fail(f"serve (e): bf16 spans shipped as {dtypes}")
    if got != want:
        fail("serve (e): the decode tier's tokens differ from the colocated "
             "replica's")
    check_one_shot("serve (e) decode tier", colocated.model, models,
                   [prompt], [got], device)
    colocated.engine.stop()
    del colocated
    _delete_app(rt, serve, "disagg", device)


def run_serve(models, inference, ops, card, device="cuda", name="tpu-7b",
              cut_layers=8, engine=None, lens=(100, 230, 370, 480, 610, 700),
              new=(16, 20, 24, 28, 32, 24), store_gib=64, disagg_prompt=512):
    """Phase 16: Serve on the card. Returns the flash launches in the
    smoke's own process during (b) (the engines reach no kernel). The
    store holds every part's weights at once (~29 GB at tpu-7b: an
    object whose owner died stays until the arena is under pressure), so
    nothing spills."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    engine = engine or dict(n_slots=8, max_len=1024, prefill_chunk=128,
                            prefill_budget=256)
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    rt.init(object_store_memory=store_gib * 2 ** 30)
    session = rt._context.node.session_name
    print(f"serve: init {time.perf_counter() - t0:.2f} s (session "
          f"{session}, store {store_gib} GiB), resources "
          f"{rt.cluster_resources()}", flush=True)
    SmokeLLM, SmokeDecode = _serve_classes(inference)
    full = models.MODEL_REGISTRY[name]
    marks = tempfile.mkdtemp(prefix="serve_smoke_")
    def arena(part):
        st = rt._get_worker().core.store.stats()
        print(f"serve: the store after {part}: {st['bytes_in_use']} of "
              f"{st['capacity']} bytes in use", flush=True)
    try:
        launches = serve_start_and_requests(
            rt, serve, models, inference, ops, card, SmokeLLM,
            os.path.join(marks, "a"), device, name, engine, lens, new)
        arena("(a)-(b)")
        serve_weight_plane_and_kill(
            rt, serve, models, ops, card, SmokeLLM, os.path.join(marks, "c"),
            device, dataclasses.replace(full, n_layers=cut_layers), engine)
        arena("(c)-(d)")
        serve_disagg(rt, serve, models, inference, ops, card, SmokeDecode,
                     os.path.join(marks, "e"), device,
                     dataclasses.replace(full, n_layers=cut_layers), engine,
                     prompt_len=disagg_prompt)
        arena("(e)")
        heartbeat_gap(rt, "serve")
        serve_timeline(rt, card)
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
            shutil.rmtree(marks, ignore_errors=True)
    left, shm = session_left(session)
    print(f"serve (f): after serve.shutdown() and shutdown(), the session's "
          f"processes {left}, /dev/shm files {shm}; phase 16 "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    if left or shm:
        fail("serve left processes or shared-memory files behind")
    return launches


def serve_timeline(rt, card):
    """Phase 16, before serve.shutdown(): the timeline holds the replicas'
    engine spans and the proxy's request spans; the replicas' decode-step
    MFU from the /metrics aggregate."""
    import tempfile

    from ray_tpu_torch.util.metrics import render_prometheus
    path = os.path.join(tempfile.mkdtemp(prefix="serve_timeline_"),
                        "timeline.json")
    rt.timeline(path)
    with open(path) as f:
        evs = json.load(f)
    me = rt._get_worker().core.worker_id[:8]
    spans = {}
    for e in evs:
        if e.get("ph") == "X" and (e.get("cat") == "engine"
                                   and e["tid"] != me
                                   or e["name"] == "proxy.request"):
            spans.setdefault(e["name"], []).append(e["dur"] / 1e3)
    summary = {k: f"{len(v)}, median {float(np.median(v)):.2f} ms "
                  f"[{min(v):.2f}, {max(v):.2f}]"
               for k, v in sorted(spans.items())}
    text = render_prometheus(rt._get_worker().gcs_call("get_metrics"))
    mfu = [line for line in text.splitlines()
           if line.startswith("runtime_decode_step_mfu")]
    print(f"serve: timeline {len(evs)} events ({os.path.getsize(path)} "
          f"bytes); the replicas' engine spans and the proxy's request "
          f"spans (count, duration) {summary}; runtime_decode_step_mfu* in "
          f"the /metrics aggregate: {mfu} [{card}]",
          flush=True)
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    if not {"engine.decode", "engine.slot", "proxy.request"} <= set(spans):
        fail(f"serve: the timeline lacks the replicas' engine spans or the "
             f"proxy's request spans: {sorted(spans)}")


def session_left(session, timeout_s=30):
    """After shutdown(): the session's processes (the GCS, node managers
    and workers) and /dev/shm arenas still there once they had
    ``timeout_s`` to go; another runtime on the machine is not this
    session's."""
    import glob
    deadline = time.monotonic() + timeout_s
    while True:
        left = _session_pids(session)
        shm = glob.glob(f"/dev/shm/raytpu_torch_{session}_*")
        if not left and not shm or time.monotonic() > deadline:
            return left, shm
        time.sleep(0.5)


# ------------------------------------------------------------- phase 17

def recipe_worker_loop(config):
    """Phase 17's train_loop_per_worker: phase 7's recipe (tpu-3b, bf16
    weights, adafactor, remat "dots", the same seeds and batch) through
    make_train_fns(profiler=train.step_profiler()), reporting each step's
    loss, grad_norm, time, kernel launches and profiler record. With
    ``checkpoint`` each step reports a Checkpoint of the state
    (torch.save), and a run resumed from one continues after its step;
    with ``crash_after`` the worker exits once the trainer has stored that
    step's checkpoint (``crash_wait``), once (a marker file remembers
    it). With ``save_to`` the last step saves the parameters there with
    ``save_sharded`` (phase 21) and reports the write's time, its bytes
    and the parameters' digest. With ``dataset`` each step's batch comes
    from the trainer's Dataset (``get_dataset_shard("train")``, phase
    21), through ``iter_torch_batches`` on the worker's card, the wait
    counted as the profiler's data_wait; the report says whether it
    equals the batch made here. Each report carries when the loop began
    (``t_loop``, the host's clock)."""
    t_loop = time.time()
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import models, parallel, train
    from ray_tpu_torch.ops import attention as ops
    from ray_tpu_torch.util import metrics
    # no TF32, as main() sets it (a function here: the loop is pickled
    # by value, and torch.backends.cudnn is a module object pickle refuses)
    torch.set_float32_matmul_precision("highest")
    device, B, L = config["device"], config["B"], config["L"]
    cfg = recipe_cfg(models, config["name"])
    if config["n_layers"]:
        cfg = dataclasses.replace(cfg, n_layers=config["n_layers"])
    prof = train.step_profiler()
    model, init_fn, step_fn = train_fns(
        models, parallel, cfg, device, B, L, config["loss_chunk"],
        parallel.adafactor(config["lr"]), profiler=prof)
    state = init_fn(torch.Generator(device=device).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (B, L + 1), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(3))
    made = tokens
    batches = None
    if config.get("dataset"):
        batches = iter(train.get_dataset_shard("train").iter_torch_batches(
            batch_size=B, device=device, dtypes=torch.int64))
    resumed = train.get_checkpoint()
    if resumed is not None:
        saved = torch.load(os.path.join(resumed.to_directory(), "state.pt"),
                           map_location=device)
        model.load_state_dict(saved["model"])
        state.optimizer.load_state_dict(saved["optimizer"])
        state.step = saved["step"]
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    while state.step < config["steps"]:
        if batches is not None:
            with prof.waiting_for_data():
                tokens = next(batches)["tokens"]
        before = read_counts(ops)
        t0 = time.perf_counter()
        state, m = step_fn(state, tokens)
        dt = time.perf_counter() - t0
        report = {
            "step": state.step, "loss": m["loss"].item(),
            "grad_norm": m["grad_norm"].item(), "step_s": dt,
            "launches": {k: c - before[k]
                         for k, c in read_counts(ops).items()},
            "profile": dict(prof.last), "flops": prof.flops,
            "model_flops": step_model_flops(model, B, L),
            "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                         if device == "cuda" else None),
            "gpu_ids": rt.get_gpu_ids(),
            "mask": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "resumed": resumed is not None, "t_end": time.time(),
            "t_loop": t_loop}
        if batches is not None:
            report["batch"] = {"equal": torch.equal(tokens, made),
                               "dtype": str(tokens.dtype),
                               "device": str(tokens.device),
                               "shape": list(tokens.shape)}
        if config.get("save_to") and state.step == config["steps"]:
            from ray_tpu_torch.train.sharded_checkpoint import save_sharded
            sd = model.state_dict()
            sync(device)
            t0 = time.perf_counter()
            save_sharded(sd, config["save_to"])
            report["ckpt"] = {
                "s": time.perf_counter() - t0, "digest": params_digest(sd),
                "bytes": sum(t.numel() * t.element_size()
                             for t in sd.values())}
        ckpt = None
        if config["checkpoint"]:
            with tempfile.TemporaryDirectory() as d:
                torch.save({"model": model.state_dict(),
                            "optimizer": state.optimizer.state_dict(),
                            "step": state.step}, os.path.join(d, "state.pt"))
                ckpt = train.Checkpoint.from_directory(d)
        train.report(report, checkpoint=ckpt)
        marker = config.get("crash_marker")
        if state.step == config.get("crash_after") and \
                not os.path.exists(marker):
            deadline = time.monotonic() + 300
            while not os.path.exists(config["crash_wait"]):
                if time.monotonic() > deadline:
                    raise TimeoutError("the trainer never stored the "
                                       "checkpoint")
                time.sleep(0.05)
            with open(marker, "w") as f:
                f.write(repr(time.time()))
            os._exit(1)
    # the last step's gauges and spans reach the GCS before the executor
    # kills this actor
    metrics.push_once()
    from ray_tpu_torch._private import events
    events.flush()


def _fit(rt, train, config, tmp, name, **run):
    res = train.TorchTrainer(
        recipe_worker_loop, train_loop_config=config,
        scaling_config=train.ScalingConfig(
            num_workers=1, use_gpu=config["device"] == "cuda"),
        run_config=train.RunConfig(storage_path=tmp, name=name,
                                   **run)).fit()
    if res.error is not None:
        fail(f"train executor ({name}): {res.error!r}")
    return res


def train_executor_main(rt, models, train, card, tmp, recipe_steps, config):
    """Phase 17 (a): phase 7's recipe at full size in a num_gpus=1 train
    worker. Returns the worker's kernel launches."""
    from ray_tpu_torch.util import state as state_api
    device, steps = config["device"], config["steps"]
    B, L = config["B"], config["L"]
    t0 = time.perf_counter()
    res = _fit(rt, train, dict(config, checkpoint=False), tmp, "recipe")
    fit_s = time.perf_counter() - t0
    hist = res.metrics_history
    if [h["step"] for h in hist] != list(range(1, steps + 1)):
        fail(f"train executor: reported steps {[h['step'] for h in hist]}")
    n = (config["n_layers"] or models.MODEL_REGISTRY[config["name"]]
         .n_layers) if device == "cuda" else 0
    want = {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    launches = {k: 0 for k in want}
    for h, (loss, gnorm, s7) in zip(hist, recipe_steps):
        same = h["loss"] == loss and h["grad_norm"] == gnorm
        print(f"train executor step {h['step']}: loss {h['loss']!r} "
              f"grad_norm {h['grad_norm']!r} (phase 7: {loss!r} {gnorm!r}, "
              f"bitwise {same}), {h['step_s'] * 1e3:.1f} ms ({h['step_s'] / s7:.3f}"
              f"x phase 7's {s7 * 1e3:.1f} ms), launches {h['launches']}, "
              f"profile {profile_fields(h['profile'])}", flush=True)
        if not same:
            fail(f"train executor step {h['step']}: loss/grad_norm differ "
                 f"from phase 7's in-process step")
        if h["launches"] != want:
            fail(f"train executor step {h['step']} launched {h['launches']},"
                 f" want {want}")
        if device == "cuda" and (h["gpu_ids"] != ["0"] or h["mask"] != "0"):
            fail(f"train worker GPU ids {h['gpu_ids']}, mask {h['mask']}")
        for k in want:
            launches[k] += h["launches"][k]
    last = hist[-1]
    gap = last["flops"] / last["model_flops"] - 1
    steady = float(np.median([h["step_s"] for h in hist[1:]]))
    p7 = float(np.median([s for _, _, s in recipe_steps[1:]]))
    print(f"train executor: {steps} steps of {B}x{L} in a num_gpus=1 worker, "
          f"fit {fit_s:.1f} s; step {steady * 1e3:.1f} ms (median of steps "
          f"2-{steps}) vs phase 7's {p7 * 1e3:.1f} ms ({steady / p7:.3f}x); "
          f"peak memory allocated {last['peak_gib']} GiB; wrap_step's "
          f"FLOPs {last['flops'] / 1e12:.4f} TFLOP per step vs "
          f"step_model_flops {last['model_flops'] / 1e12:.4f} "
          f"({gap * 100:+.2f}%); MFU {last['profile'].get('mfu')} "
          f"(compute {last['profile'].get('mfu_compute')}) [{card}]",
          flush=True)
    # the profiler's gauges, read back from the GCS time-series plane
    got = {}
    for metric, tags, key in (
            ("runtime_train_step_mfu", None, "mfu"),
            ("runtime_train_step_mfu_compute", None, "mfu_compute"),
            ("runtime_train_step_phase_ms", {"phase": "compute"},
             "compute_ms"),
            ("runtime_train_step_phase_ms", {"phase": "host_gap"},
             "host_gap_ms"),
            ("runtime_train_step_phase_ms", {"phase": "data_wait"},
             "data_wait_ms")):
        q = state_api.query_metrics(metric, window=600, agg="latest",
                                    tags=tags)
        got[key] = (q.get("value"), last["profile"].get(key))
    print(f"train executor: query_metrics (latest) vs the worker's last "
          f"record: {got}", flush=True)
    if any(a != b for a, b in got.values()):
        fail(f"the GCS time-series plane disagrees with the worker's "
             f"profiler: {got}")
    return launches


def train_executor_restart(rt, train, models, parallel, card, tmp, config,
                           n_layers, steps=4, crash_after=2, keep=2):
    """Phase 17 (b): the recipe cut to n_layers, a checkpoint per step, the
    worker killed once the trainer stored step crash_after's checkpoint;
    the gang restarts from the latest checkpoint and its steps must equal
    an uninterrupted run's. Returns the workers' kernel launches."""
    device, B, L = config["device"], config["B"], config["L"]
    config = dict(config, n_layers=n_layers, steps=steps, checkpoint=True,
                  crash_after=crash_after,
                  crash_marker=os.path.join(tmp, "crashed"),
                  crash_wait=os.path.join(tmp, "restart", "checkpoints",
                                          f"checkpoint_{crash_after:06d}"))
    # the uninterrupted run, in this process
    cfg = dataclasses.replace(recipe_cfg(models, config["name"]),
                              n_layers=n_layers)
    model, init_fn, step_fn = train_fns(
        models, parallel, cfg, device, B, L, config["loss_chunk"],
        parallel.adafactor(config["lr"]))
    st = init_fn(torch.Generator(device=device).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (B, L + 1), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(3))
    want = []
    for _ in range(steps):
        st, m = step_fn(st, tokens)
        want.append((m["loss"].item(), m["grad_norm"].item()))
    del model, st, m
    release(device)
    t0 = time.perf_counter()
    res = _fit(rt, train, config, tmp, "restart",
               failure_config=train.FailureConfig(max_failures=1),
               checkpoint_config=train.CheckpointConfig(num_to_keep=keep))
    fit_s = time.perf_counter() - t0
    hist = res.metrics_history
    with open(config["crash_marker"]) as f:
        crashed_at = float(f.read())
    resumed = [h for h in hist if h["resumed"]]
    got = [(h["loss"], h["grad_norm"]) for h in hist]
    steps_seen = [h["step"] for h in hist]
    ckpts = sorted(os.listdir(os.path.join(tmp, "restart", "checkpoints")))
    recovery = resumed[0]["t_end"] - resumed[0]["step_s"] - crashed_at \
        if resumed else None
    print(f"train executor (b): {n_layers} layers, {steps} steps, crash "
          f"after step {crash_after}: reported steps {steps_seen}, resumed "
          f"{[h['step'] for h in resumed]}, losses {[g[0] for g in got]} vs "
          f"uninterrupted {[w[0] for w in want]}; recovery (crash to the "
          f"resumed worker's first step) {recovery:.2f} s, fit {fit_s:.1f} "
          f"s; checkpoints kept {ckpts} (num_to_keep {keep}) [{card}]",
          flush=True)
    if steps_seen != list(range(1, crash_after + 1)) + list(
            range(crash_after + 1, steps + 1)) or not resumed:
        fail(f"train executor (b): steps {steps_seen}, resumed {resumed}")
    if got != want:
        fail("train executor (b): the resumed steps differ from the "
             "uninterrupted run")
    if len(ckpts) != keep:
        fail(f"train executor (b): {len(ckpts)} checkpoints kept, want "
             f"{keep}")
    return {k: sum(h["launches"][k] for h in hist) for k in KERNELS}


def train_executor_timeline(rt, card, tmp):
    """Phase 17 (c): the chrome JSON holds this process's train.fit span and
    train.report instants, the worker's train_step.step spans and the
    runtime_train_step_mfu counter track."""
    path = rt.timeline(os.path.join(tmp, "timeline.json"))
    with open(path) as f:
        evs = json.load(f)
    fit_spans = [e for e in evs if e["name"] == "train.fit"
                 and e["ph"] == "X"]
    reports = [e for e in evs if e["name"] == "train.report"
               and e["ph"] == "i"]
    steps = [e for e in evs if e["name"] == "train_step.step"
             and e["ph"] == "X" and "mfu" in e["args"]
             and "compute_ms" in e["args"]]
    mfu_track = [e for e in evs if e["ph"] == "C"
                 and e["name"] == "runtime_train_step_mfu"]
    print(f"train executor (c): timeline {len(evs)} events; train.fit "
          f"{len(fit_spans)}, train.report {len(reports)}, train_step.step "
          f"{len(steps)} (mfu {[e['args']['mfu'] for e in steps]}), "
          f"runtime_train_step_mfu counter samples {len(mfu_track)} [{card}]",
          flush=True)
    if not (fit_spans and reports and steps and mfu_track):
        fail("train executor (c): the timeline lacks a train.fit span, "
             "train.report instants, train_step.step spans or the "
             "runtime_train_step_mfu track")


def run_train_executor(models, parallel, train, card, recipe_steps,
                       device="cuda", name="tpu-3b", n_layers=None, B=4,
                       L=1024, steps=5, loss_chunk=256, lr=3e-4,
                       restart_layers=2):
    """Phase 17: the train executor on the card. Returns the flash
    launches counted in the train workers. recipe_steps are phase 7's
    (loss, grad_norm, seconds) per step; n_layers cuts (a)'s model (a
    rehearsal's), restart_layers (b)'s."""
    import tempfile

    import ray_tpu_torch as rt
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="train_smoke_")
    t0 = time.perf_counter()
    rt.init(object_store_memory=(32 if device == "cuda" else 1) * 2 ** 30)
    session = rt._context.node.session_name
    print(f"train executor: init {time.perf_counter() - t0:.2f} s (session "
          f"{session})", flush=True)
    config = dict(device=device, name=name, n_layers=n_layers, B=B, L=L,
                  steps=steps, loss_chunk=loss_chunk, lr=lr)
    try:
        t_part = time.perf_counter()
        launches = train_executor_main(rt, models, train, card, tmp,
                                       recipe_steps[:steps], config)
        print(f"train executor (a): {time.perf_counter() - t_part:.1f} s",
              flush=True)
        t_part = time.perf_counter()
        for k, n in train_executor_restart(rt, train, models, parallel, card,
                                           tmp, config,
                                           restart_layers).items():
            launches[k] += n
        print(f"train executor (b): {time.perf_counter() - t_part:.1f} s",
              flush=True)
        train_executor_timeline(rt, card, tmp)
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    left, shm = session_left(session)
    print(f"train executor (d): after shutdown, the session's processes "
          f"{left}, /dev/shm files {shm}; phase 17 "
          f"{time.perf_counter() - t_phase:.1f} s, worker launches "
          f"{launches} [{card}]", flush=True)
    if left or shm:
        fail("the train executor left processes or shared-memory files "
             "behind")
    return launches


# ------------------------------------------------------------- phase 18

def _sharded_class():
    """ShardedEngineReplica with what phase 18 reads from inside the
    replica: its GPU ids and mask, its pid, its construction time and the
    flash launches in its process. Made here, in a function, so the
    runtime ships it by value."""
    from ray_tpu_torch.serve.sharded import ShardedEngineReplica

    class SmokeSharded(ShardedEngineReplica):
        def __init__(self, *args, **kwargs):
            t0 = time.perf_counter()
            super().__init__(*args, **kwargs)
            self.init_s = time.perf_counter() - t0

        def probe(self):
            import sys

            import ray_tpu_torch as rt
            ops = sys.modules.get("ray_tpu_torch.ops.attention")
            launches = {name: getattr(ops, fn).launches for name, fn in (
                ("flash_fwd", "flash_attention_fwd"),
                ("flash_bwd_dq", "flash_attention_bwd_dq"),
                ("flash_bwd_dkv", "flash_attention_bwd_dkv"))} if ops else {}
            return {"ids": rt.get_gpu_ids(),
                    "mask": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "pid": os.getpid(), "init_s": self.init_s,
                    "mesh": [str(self.mesh.device_type),
                             list(self.mesh.mesh_dim_names),
                             self.mesh.size()],
                    "world": self._world, "launches": launches}
    return SmokeSharded


def _decode_spans(rt, me):
    """The engine.decode spans (ms) of the replicas' processes, from the
    timeline."""
    import tempfile
    path = os.path.join(tempfile.mkdtemp(prefix="sharded_timeline_"),
                        "timeline.json")
    rt.timeline(path)
    with open(path) as f:
        evs = json.load(f)
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    return [e["dur"] / 1e3 for e in evs
            if e.get("ph") == "X" and e["name"] == "engine.decode"
            and e["tid"] != me]


def _grpc_version():
    """grpcio's version, or None where it does not import."""
    try:
        import grpc
    except ImportError:
        return None
    return grpc.__version__


def sharded_serve(rt, serve, models, card, cls, marks, device, cfg, engine,
                  prompts, new, use_grpc):
    """Phase 18 (a) and (c): build_sharded_app at num_hosts=1 on a
    num_gpus=1 replica, phase 4's requests over HTTP and over a handle,
    each stream held against a one-shot forward; a gRPC generate's tokens
    equal a handle generate's. Returns the one-shot model for (b)."""
    from ray_tpu_torch.serve.deployment import Application, Deployment
    from ray_tpu_torch.serve.sharded import build_sharded_app
    gpus = {"num_gpus": 1} if device == "cuda" else {}
    serve.start(http_port=0, grpc_port=0 if use_grpc else None)
    (addrs,) = serve.proxies().values()
    app = build_sharded_app(cfg, num_hosts=1, name="sharded",
                            deployment_kwargs={"ray_actor_options": gpus},
                            params_fn=_params_fn(cfg, marks, device),
                            device=device, **engine)
    # the same graph, with the replica's class replaced by its probing
    # subclass
    app = Application(Deployment(cls, app.deployment.name,
                                 app.deployment.config), app.args,
                      app.kwargs)
    t0 = time.perf_counter()
    handle = serve.run(app, name="sharded", route_prefix="/")
    (replica,) = _replicas(handle, 1)
    (info,) = _probe_all(rt, [replica])
    ready_s = time.perf_counter() - t0
    print(f"sharded serve (a): a num_hosts=1 ShardedEngineReplica "
          f"({cfg.n_layers} layers at full width, {cfg.dtype}) ready "
          f"{ready_s:.2f} s after "
          f"serve.run (construction {info['init_s']:.2f} s); pid "
          f"{info['pid']}, GPU ids {info['ids']} mask {info['mask']!r}, "
          f"mesh {info['mesh']}, world {info['world']} [{card}]",
          flush=True)
    if device == "cuda" and (info["ids"] != ["0"] or info["mask"] != "0"):
        fail(f"sharded serve: the replica got ids {info['ids']} and mask "
             f"{info['mask']!r}, want ['0'] and '0'")
    if info["world"] != 1 or info["mesh"][2] != 1:
        fail(f"sharded serve: want a world and a mesh of one rank, got "
             f"{info['world']} and {info['mesh']}")
    if _runs(marks) != 1:
        fail(f"sharded serve: params_fn ran {_runs(marks)} times, want once")
    # the first answer, one token over HTTP, as phase 16's: what a fresh
    # replica's first batch pays (C7) stays out of the six requests' times
    first = {}
    _http_stream(f"http://{addrs['http']}/", {"prompt_tokens": [1, 2, 3],
                                               "max_new_tokens": 1}, first, 0)
    first_s = time.perf_counter() - t0
    print(f"sharded serve (a): the first answer over HTTP (1 token) "
          f"{first_s:.2f} s after serve.run, status {first[0]['status']} "
          f"[{card}]", flush=True)
    if first[0]["status"] != 200 or len(first[0]["tokens"]) != 1:
        fail(f"sharded serve: the first HTTP answer was {first[0]}")
    reqs = [(p.tolist(), n) for p, n in zip(prompts, new)]

    def over_http(p, n, out, i):
        _http_stream(f"http://{addrs['http']}/",
                     {"prompt_tokens": p, "max_new_tokens": n}, out, i)

    def over_a_handle(p, n, out, i):
        _handle_stream(handle, p, n, out, i)
    results = []
    for what, fn in (("HTTP", over_http), ("handle", over_a_handle)):
        t0 = time.perf_counter()
        runs = _concurrently(fn, reqs)
        results.append((what, runs, time.perf_counter() - t0))
        for i, (r, n) in enumerate(zip(runs, new)):
            if r is None or r["status"] != 200 or len(r["tokens"]) != n:
                fail(f"sharded serve (a): {what} request {i} gave "
                     f"{None if r is None else (r['status'], len(r['tokens']))}"
                     f", want 200 and {n} tokens")
    digest = rt.get(replica.handle_request.remote(
        "last_stream_digest", (), {}), timeout=60)
    for what, runs, wall in results:
        rows = [_ttft_tpot(r["times"]) for r in runs]
        tpot = [t for _, t in rows]
        print(f"sharded serve (a) over {what}: 6 requests at once, "
              f"{sum(new)} tokens in {wall:.3f} s; per request (TTFT ms, "
              f"TPOT ms) {rows}; TPOT median {float(np.median(tpot)):.3f} "
              f"ms [{card}]", flush=True)
    me = rt._get_worker().core.worker_id[:8]
    spans = _decode_spans(rt, me)
    if not spans:
        fail("sharded serve: the timeline holds no engine.decode span of "
             "the replica")
    med, lo, hi = median_spread(spans)
    print(f"sharded serve (a): the replica's engine.decode spans: "
          f"{len(spans)}, median {med:.2f} ms [{lo:.2f}, {hi:.2f}]; its "
          f"last_stream_digest {digest} [{card}]", flush=True)
    model = _seeded_model(models, cfg, device)
    for what, runs, _ in results:
        check_one_shot(f"sharded serve over {what}", model, models, prompts,
                       [r["tokens"] for r in runs], device)

    # (c) gRPC: one generate through the proxy's untyped ingress, against
    # the same generate over a handle, each alone on the replica
    if use_grpc:
        req = {"prompt_tokens": reqs[0][0], "max_new_tokens": reqs[0][1]}
        want = handle.generate.remote(req).result(timeout=600)
        t0 = time.perf_counter()
        got = serve.grpc_call(addrs["grpc"], req, application="sharded",
                              method="generate", timeout=600)
        grpc_s = time.perf_counter() - t0
        print(f"sharded serve (c): grpc_call generate via {addrs['grpc']}: "
              f"{len(got)} tokens in {grpc_s:.3f} s, equal to the handle's "
              f"generate: {got == want}; equal to (a)'s handle stream of "
              f"the same request (informational: six requests shared the "
              f"batch there): {got == results[1][1][0]['tokens']} [{card}]",
              flush=True)
        if got != want:
            fail("sharded serve (c): the gRPC tokens differ from the "
                 "handle's")
    (info,) = _probe_all(rt, [replica])
    _delete_app(rt, serve, "sharded", device)
    return model, info["launches"]


def phase4_schedule(eng, prompts, new, limit=400):
    """Phase 4's arrivals: all requests but the last at once, the last
    four steps after the first has its first token. Returns the greedy
    tokens and the steps taken."""
    handles = [eng.submit(p, max_new_tokens=n)
               for p, n in zip(prompts[:-1], new[:-1])]
    steps = 0
    while handles[0].first_token_t is None or steps < 4:
        if handles[0].first_token_t is not None:
            steps += 1          # the four steps before the last arrives
        eng.step()
    handles.append(eng.submit(prompts[-1], max_new_tokens=new[-1]))
    while not all(h.finish_reason for h in handles):
        eng.step()
        steps += 1
        if steps > limit:
            fail("engine: requests did not finish")
    return [h.tokens() for h in handles], eng.steps


def mesh_engine(inference, ops, card, model, device, engine, prompts, new):
    """Phase 18 (b): phase 4's requests through InferenceEngine() and then
    InferenceEngine(mesh=<one-card mesh>) on the same model (distributed
    over the mesh in place): the tokens must be equal. Returns the
    launches in this process during the mesh engine's run."""
    from ray_tpu_torch.serve.sharded import default_serving_mesh
    out = {}
    for what in ("no mesh", "mesh"):
        mesh = default_serving_mesh(device) if what == "mesh" else None
        eng = inference.InferenceEngine(
            model, inference.EngineConfig(**engine), device=device, seed=0,
            mesh=mesh)
        zero_counts(ops)                       # main path: the mesh engine
        t0 = time.perf_counter()
        toks, steps = phase4_schedule(eng, prompts, new)
        sync(device)
        out[what] = (toks, time.perf_counter() - t0, steps)
        launches = read_counts(ops)
        del eng
    same = out["mesh"][0] == out["no mesh"][0]
    print(f"sharded serve (b): phase 4's requests through "
          f"InferenceEngine(mesh=<one-card mesh>) "
          f"{out['mesh'][1]:.2f} s in {out['mesh'][2]} steps "
          f"({out['mesh'][1] / out['mesh'][2] * 1e3:.2f} ms a step), "
          f"InferenceEngine() {out['no mesh'][1]:.2f} s in "
          f"{out['no mesh'][2]} steps "
          f"({out['no mesh'][1] / out['no mesh'][2] * 1e3:.2f} ms a step); "
          f"tokens equal: {same}; flash launches in the mesh engine's run "
          f"{launches} [{card}]", flush=True)
    if not same:
        fail("sharded serve (b): the mesh engine's tokens differ from the "
             "engine's without a mesh")
    return launches


def run_sharded_serve(models, inference, ops, card, device="cuda",
                      name="tpu-7b", engine=None,
                      lens=(100, 230, 370, 480, 610, 700),
                      new=(16, 20, 24, 28, 32, 24)):
    """Phase 18: sharded serving on the card (a) to (c), on a fresh
    runtime. Returns the flash launches of its main path: the replica's
    and this process's during (b)."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    engine = engine or dict(n_slots=8, max_len=1024, prefill_chunk=128,
                            prefill_budget=256)
    t_phase = time.perf_counter()
    version = _grpc_version()
    print(f"sharded serve: grpcio "
          f"{version or 'is not installed: (c) is left out'}", flush=True)
    cfg = dataclasses.replace(models.MODEL_REGISTRY[name],
                              n_layers=SERVE_LAYERS)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in lens]
    rt.init(object_store_memory=4 * 2 ** 30)
    session = rt._context.node.session_name
    marks = tempfile.mkdtemp(prefix="sharded_smoke_")
    try:
        model, replica_launches = sharded_serve(
            rt, serve, models, card, _sharded_class(),
            os.path.join(marks, "a"), device, cfg, engine, prompts, new,
            use_grpc=version is not None)
        heartbeat_gap(rt, "sharded serve")
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
            shutil.rmtree(marks, ignore_errors=True)
    left, shm = session_left(session)
    if left or shm:
        fail(f"sharded serve left processes {left} or shared-memory files "
             f"{shm} behind")
    launches = mesh_engine(inference, ops, card, model, device, engine,
                           prompts, new)
    del model
    release(device)
    total = {k: launches[k] + replica_launches.get(k, 0) for k in KERNELS}
    print(f"sharded serve: flash launches in the replica "
          f"{replica_launches}, in this process during (b) {launches}; "
          f"phase 18 {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    if any(total.values()):
        fail("sharded serve: an engine launched a flash kernel (it attends "
             "through the cache)")
    return total


# ------------------------------------------------------------- phase 19

def _gym_version():
    try:
        import gymnasium
    except ImportError:
        return None
    return gymnasium.__version__


def _timed_ms(fn, device):
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def _profiled(fn, device):
    """``fn()``, timed, and on the card under torch.profiler: (its output,
    the device's kernel time or None on the CPU, the call's host time;
    ms)."""
    from contextlib import nullcontext

    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.trace_serving import busy_ms
    trace = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
             if device == "cuda" else nullcontext())
    with trace:
        out, ms = _timed_ms(fn, device)
    return out, busy_ms(trace) if device == "cuda" else None, ms


def _ppo_config(device):
    """The CartPole-v1 PPO config of the JAX package's gate
    (tests/test_rl_regression.py::test_ppo_cartpole_threshold), its
    learner on ``device``."""
    from ray_tpu_torch.rl import AlgorithmConfig
    return (AlgorithmConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=64)
            .training(train_batch_size=512, minibatch_size=128,
                      num_epochs=6, lr=3e-4, entropy_coeff=0.01)
            .learners(device=device))


def _rl_cfg(**kw):
    """A learner's config dict for the learners built by hand in (b):
    phase 19 (c)'s CartPole PPO values unless overridden."""
    cfg = dict(obs_shape=[4], action_spec={"type": "discrete", "n": 2},
               hidden_sizes=(64, 64), lr=3e-4, grad_clip=0.5,
               clip_param=0.2, vf_loss_coeff=0.5, entropy_coeff=0.01,
               minibatch_size=128, num_epochs=6, seed=0, gamma=0.99,
               lambda_=0.95, tau=0.005, initial_alpha=0.2,
               target_entropy=None, target_update_freq=2)
    cfg.update(kw)
    return cfg


def _rl_trajectory(rng, T, B, obs_shape, n_actions, hidden=None):
    out = {"obs": rng.random((T, B) + tuple(obs_shape)).astype(np.float32),
           "actions": rng.integers(0, n_actions, (T, B)).astype(np.int64),
           "behavior_logp": (np.log(1.0 / n_actions)
                             + 0.3 * rng.normal(size=(T, B)))
           .astype(np.float32),
           "rewards": rng.normal(size=(T, B)).astype(np.float32),
           "dones": (rng.random((T, B)) < 0.1).astype(np.float32),
           "bootstrap_obs": rng.random((B,) + tuple(obs_shape))
           .astype(np.float32),
           "bootstrap_value": rng.normal(size=B).astype(np.float32)}
    if hidden:
        for k in ("initial_state_c", "initial_state_h"):
            out[k] = (0.3 * rng.normal(size=(B, hidden))).astype(np.float32)
    return out


def _rl_weights(learner):
    """Every weight a learner updates, by name (numpy, on the host); a
    LearnerGroup's as its get_weights() hands them to the runners."""
    if hasattr(learner, "local"):            # a LearnerGroup
        return {f"group.{k}": v for k, v in learner.get_weights().items()}
    nets = {name: getattr(learner, name) for name in
            ("net", "target_net", "pi", "q", "q_target")
            if isinstance(getattr(learner, name, None), torch.nn.Module)}
    if hasattr(learner, "module"):
        nets["module"] = learner.module.net
    out = {f"{n}.{k}": v.detach().cpu().numpy()
           for n, net in nets.items() for k, v in net.state_dict().items()}
    if hasattr(learner, "log_alpha"):
        out["log_alpha"] = learner.log_alpha.detach().cpu().numpy()
    return out


def _rl_copy(src, dst):
    src, dst = getattr(src, "local", src), getattr(dst, "local", dst)
    for name in ("net", "target_net", "pi", "q", "q_target"):
        if isinstance(getattr(src, name, None), torch.nn.Module):
            getattr(dst, name).load_state_dict(getattr(src, name)
                                               .state_dict())
    if hasattr(src, "module"):
        dst.module.net.load_state_dict(src.module.net.state_dict())


def rl_learner_holds(card, device):
    """Phase 19 (b): each learner's update on ``device`` against the same
    update on the CPU, from the same weights and inputs, then once warm
    (timed, and once under ``count_flops``). PPO goes the way PPO builds
    its learners: ``AlgorithmConfig.learners(device=)`` → ``LearnerGroup``
    → ``update_from_batch`` → ``get_weights`` for the runners' sync; one
    more of its updates is traced for the device's busy share."""
    from ray_tpu_torch.rl.algorithm import learner_config
    from ray_tpu_torch.rl.appo import AppoLearner
    from ray_tpu_torch.rl.dqn import DQNLearner
    from ray_tpu_torch.rl.impala import ImpalaLearner
    from ray_tpu_torch.rl.learner import LearnerGroup, to_device
    from ray_tpu_torch.rl.offline import BC, BCConfig
    from ray_tpu_torch.rl.replay_buffer import PrioritizedReplayBuffer
    from ray_tpu_torch.rl.sac import SACLearner
    from ray_tpu_torch.util.profiling import count_flops

    rng = np.random.default_rng(19)
    n = 512
    ppo_batch = {"obs": rng.normal(size=(n, 4)).astype(np.float32),
                 "actions": rng.integers(0, 2, n).astype(np.int64),
                 "logp": (np.log(0.5) + 0.3 * rng.normal(size=n))
                 .astype(np.float32),
                 "advantages": rng.normal(size=n).astype(np.float32),
                 "value_targets": rng.normal(size=n).astype(np.float32)}
    lstm = _rl_cfg(obs_shape=[2], hidden_sizes=(64,), use_lstm=True,
                   lr=2e-3, grad_clip=40.0, gamma=0.9, clip_param=0.3,
                   entropy_coeff=0.003, num_epochs=4)
    conv = _rl_cfg(obs_shape=[8, 8, 1],
                   action_spec={"type": "discrete", "n": 4}, lr=1e-3,
                   grad_clip=40.0, gamma=0.95, num_epochs=2)
    lstm_trajs = [_rl_trajectory(rng, 32, 8, (2,), 2, hidden=64)
                  for _ in range(2)]
    conv_trajs = [_rl_trajectory(rng, 32, 8, (8, 8, 1), 4)
                  for _ in range(2)]
    q_data = {"obs": rng.normal(size=(1024, 4)).astype(np.float32),
              "actions": rng.integers(0, 2, 1024).astype(np.int64),
              "rewards": rng.normal(size=1024).astype(np.float32),
              "dones": (rng.random(1024) < 0.05).astype(np.float32),
              "next_obs": rng.normal(size=(1024, 4)).astype(np.float32)}
    buf = PrioritizedReplayBuffer(1024, seed=0)
    buf.add(q_data)
    buf.update_priorities(np.arange(1024), rng.normal(size=1024))
    q_mbs = [buf.sample(128) for _ in range(8)]
    sac_mbs = [{"obs": rng.normal(size=(128, 3)).astype(np.float32),
                "actions": np.tanh(rng.normal(size=(128, 1)))
                .astype(np.float32),
                "rewards": rng.normal(size=128).astype(np.float32),
                "dones": (rng.random(128) < 0.05).astype(np.float32),
                "next_obs": rng.normal(size=(128, 3)).astype(np.float32)}
               for _ in range(8)]
    sac_noise = [torch.from_numpy(rng.normal(size=(2, 128, 1))
                                  .astype(np.float32)) for _ in range(8)]
    rows = [{"obs": (o := rng.normal(size=4).astype(np.float32)).tolist(),
             "action": int(o[0] > 0)} for _ in range(512)]

    class _Rows:
        def iter_batches(self, batch_size, batch_format="numpy"):
            for i in range(0, len(rows), batch_size):
                chunk = rows[i:i + batch_size]
                yield {"obs": [r["obs"] for r in chunk],
                       "action": np.asarray([r["action"] for r in chunk])}

    def ppo_group(dev):
        return LearnerGroup(learner_config(
            _ppo_config(dev), [4], {"type": "discrete", "n": 2}), 4, 2)

    def dqn_run(lr_):
        for mb in q_mbs:
            mb = dict(mb)
            w = torch.as_tensor(mb.pop("weights"), device=lr_.device)
            mb.pop("indices")
            lr_.update(to_device(mb, lr_.device), w)

    def sac_run(lr_):
        for mb, noise in zip(sac_mbs, sac_noise):
            noise = noise.to(lr_.device)
            lr_.update(to_device(mb, lr_.device),
                       torch.ones(128, device=lr_.device), noise[0],
                       noise[1])

    def bc(dev):
        return BC(BCConfig(dataset=_Rows(), obs_dim=4, action_dim=2,
                           lr=1e-3, train_batch_size=128, num_epochs=2,
                           device=dev))

    # (name, learner on a device, one run, minibatch updates per run)
    cases = [
        ("PPO LearnerGroup from AlgorithmConfig, update_from_batch "
         "(6 epochs x 4 minibatches of 128)", ppo_group,
         lambda g: g.update_from_batch(ppo_batch), 24),
        ("IMPALA LSTM, 2 fragments of 32 x 8, 4 passes",
         lambda d: ImpalaLearner({**lstm, "learner_device": d}, 2, 2),
         lambda l: [l.update_from_trajectory(t) for t in lstm_trajs], 8),
        ("APPO LSTM, 2 fragments of 32 x 8, 4 passes, target synced",
         lambda d: AppoLearner({**lstm, "learner_device": d,
                                "target_update_freq": 1}, 2, 2),
         lambda l: [l.update_from_trajectory(t) for t in lstm_trajs], 8),
        ("IMPALA conv 8x8x1, 2 fragments of 32 x 8, 2 passes",
         lambda d: ImpalaLearner({**conv, "learner_device": d}, 64, 4),
         lambda l: [l.update_from_trajectory(t) for t in conv_trajs], 4),
        ("APPO conv 8x8x1, 2 fragments of 32 x 8, 2 passes, target synced",
         lambda d: AppoLearner({**conv, "learner_device": d,
                                "target_update_freq": 1}, 64, 4),
         lambda l: [l.update_from_trajectory(t) for t in conv_trajs], 4),
        ("DQN, 8 prioritized minibatches of 128",
         lambda d: DQNLearner(_rl_cfg(lr=1e-3, learner_device=d), 4, 2),
         dqn_run, 8),
        ("SAC, 8 minibatches of 128, noise given",
         lambda d: SACLearner(_rl_cfg(learner_device=d), 3, 1), sac_run, 8),
        ("BC train(), 512 rows in batches of 128, 2 epochs", bc,
         lambda l: l.train(), 8),
    ]
    group = None
    for name, make, run, n_updates in cases:
        cpu, dev = make("cpu"), make(device)
        _rl_copy(cpu, dev)
        _, cpu_ms = _timed_ms(lambda: run(cpu), "cpu")
        _, first_ms = _timed_ms(lambda: run(dev), device)
        want, got = _rl_weights(cpu), _rl_weights(dev)
        assert set(want) == set(got), name
        diff = max(float(np.abs(got[k] - want[k]).max()) for k in want)
        _, ms = _timed_ms(lambda: run(dev), device)
        flops = count_flops(lambda: run(dev))[1]
        share = (f", {flops / (ms / 1e3) / H100_FP32_FLOPS:.2e} of the fp32 "
                 f"peak (67 TFLOP/s)" if device == "cuda" else "")
        print(f"rl (b) {name}: max |weight, {device} - cpu| {diff:.3e} "
              f"(bound {RL_WEIGHT_TOL:g}); first call {first_ms:.2f} ms on "
              f"{device}, {cpu_ms:.2f} ms on the CPU; warm {ms:.2f} ms a "
              f"run, {ms / n_updates:.3f} ms per minibatch update "
              f"({n_updates} a run), {flops:.0f} FLOPs a run{share} "
              f"[{card}]", flush=True)
        if not diff <= RL_WEIGHT_TOL:
            fail(f"rl (b) {name}: the {device} update differs from the "
                 f"CPU's by {diff:.3e} > {RL_WEIGHT_TOL}")
        if make is ppo_group:
            group = dev
    _, busy, ms = _profiled(lambda: group.update_from_batch(ppo_batch),
                            device)
    traced = ("not measured (no card)" if busy is None else
              f"{busy:.2f} ms = {100 * busy / ms:.1f}% of the traced run's "
              f"{ms:.2f} ms")
    print(f"rl (b) PPO LearnerGroup traced: device busy {traced}; "
          f"runtime_rl_update_mfu {group.local.profiler.last.get('mfu')} "
          f"(its last minibatch, against "
          f"{group.local.profiler.peak_flops / 1e12:g} TFLOP/s) [{card}]",
          flush=True)


def rl_end_to_end(card, device):
    """Phase 19 (c): PPO on CartPole-v1 to the JAX package's gate, then
    one APPO (LSTM) and one SAC iteration. One line per iteration; one
    PPO iteration and the other two are traced for the device's busy
    share."""
    from ray_tpu_torch.rl import APPO, SAC, AlgorithmConfig
    t0 = time.perf_counter()
    algo = _ppo_config(device).build()
    cfg = algo.config
    print(f"rl (c) PPO built (2 runner actors, learner on {device}) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    learner = algo.learner_group.local
    reached = None
    best = float("-inf")
    try:
        for it in range(1, RL_GATE_ITERS + 1):
            r, busy, _ = (_profiled(algo.train, device) if it == 2
                          else (algo.train(), None, None))
            ret = r["episode_return_mean"]
            if ret is not None:
                best = max(best, ret)
            n_mb = cfg.num_epochs * -(-r["num_env_steps_sampled"]
                                      // cfg.minibatch_size)
            learn_ms = r["learn_time_s"] * 1e3
            traced = ("" if busy is None else
                      f", device busy {busy:.2f} ms = "
                      f"{100 * busy / learn_ms:.1f}% of the learn time "
                      f"(traced)")
            print(f"rl (c) PPO it {it}: return {ret}, sample "
                  f"{r['sample_time_s'] * 1e3:.2f} ms, learn "
                  f"{learn_ms:.2f} ms ({n_mb} minibatches, "
                  f"{learn_ms / n_mb:.3f} ms each), env steps/s "
                  f"{r['env_steps_per_s']:.1f}, runtime_rl_update_mfu "
                  f"{learner.profiler.last.get('mfu')}{traced}", flush=True)
            if ret is not None and ret >= RL_GATE_RETURN:
                reached = it
                break
    finally:
        algo.stop()
    outcome = (f"reached {RL_GATE_RETURN} at iteration {reached}"
               if reached else f"did not reach {RL_GATE_RETURN}")
    print(f"rl (c) PPO CartPole-v1: best episode_return_mean {best}, "
          f"{outcome} (the JAX package's gate: within {RL_GATE_ITERS} "
          f"iterations); FLOPs per minibatch update "
          f"{learner.profiler.flops:.0f} [{card}]", flush=True)
    if reached is None:
        fail(f"rl (c): PPO on CartPole-v1 did not reach {RL_GATE_RETURN} "
             f"within {RL_GATE_ITERS} iterations (best {best})")

    appo = (AlgorithmConfig().environment("ray_tpu_torch/RepeatAfterMe-v0")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=8,
                         rollout_fragment_length=32)
            .training(lr=2e-3, entropy_coeff=0.003, clip_param=0.3,
                      num_epochs=4, hidden_sizes=(64,), use_lstm=True,
                      target_update_freq=2, gamma=0.9)
            .learners(device=device))
    sac = (AlgorithmConfig().environment("Pendulum-v1")
           .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                        rollout_fragment_length=64)
           .training(minibatch_size=128, lr=3e-4, gamma=0.99, tau=0.005,
                     updates_per_step=1.0)
           .learners(device=device))
    # sampling overlaps learning in both, so the busy share is of the
    # whole iteration
    for name, cls, cfg in (("APPO LSTM RepeatAfterMe", APPO, appo),
                           ("SAC Pendulum", SAC, sac)):
        algo = cls(cfg)
        try:
            r, busy, wall = _profiled(algo.train, device)
        finally:
            algo.stop()
        traced = ("not measured (no card)" if busy is None else
                  f"{busy:.2f} ms = {100 * busy / wall:.1f}%")
        print(f"rl (c) {name} it 1: return {r['episode_return_mean']}, "
              f"iteration {wall:.2f} ms (traced), env steps/s "
              f"{r['env_steps_per_s']:.1f}, device busy {traced} [{card}]",
              flush=True)


def run_rl(ops, card, device="cuda"):
    """Phase 19: RL on the card. Returns the flash launches counted while
    (b) and (c) drove the learners (none expected)."""
    t_phase = time.perf_counter()
    version = _gym_version()
    print(f"rl (a): gymnasium {version or 'is not installed: (c) is left out'}"
          f"; card: {card}", flush=True)
    if device == "cuda":
        torch.ones(8, 8, device=device) @ torch.ones(8, 8, device=device)
    zero_counts(ops)                   # main path: the learners' updates
    rl_learner_holds(card, device)
    counts = read_counts(ops)
    print(f"rl (b): flash launches {counts}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if version is None:
        print("rl (c) did not run: gymnasium is not installed on this "
              "machine, and the env runners step gymnasium envs",
              flush=True)
    else:
        import ray_tpu_torch as rt
        t_part = time.perf_counter()
        rt.init(object_store_memory=2 * 2 ** 30)
        session = rt._context.node.session_name
        zero_counts(ops)               # main path: PPO, APPO, SAC
        try:
            rl_end_to_end(card, device)
            end_to_end = read_counts(ops)
            heartbeat_gap(rt, "rl")
        finally:
            rt.shutdown()
        left, shm = session_left(session)
        if left or shm:
            fail(f"rl left processes {left} or shared-memory files {shm} "
                 f"behind")
        print(f"rl (c): flash launches {end_to_end}; "
              f"{time.perf_counter() - t_part:.1f} s", flush=True)
        counts = {k: counts[k] + end_to_end[k] for k in KERNELS}
    print(f"rl: flash launches {counts}; phase 19 "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    if any(counts.values()):
        fail("rl: the RL path launched a flash kernel")
    return counts


# ------------------------------------------------------------- phase 20

# (a)/(b): tpu-3b's recipe blocks (phase 13's bf16 weights and seed) cut
# to 8 blocks in 2 stages of 4
DAG_LAYERS, DAG_STAGES = 8, 2
# the compiled DAG's channel size: it must hold the pickled B=2, L=1024
# bf16 activations (12 MiB) and the last position's fp32 logits
DAG_BUFFER = 16 * 2 ** 20


class DagStage:
    """Phase 20 (a) and (b): stage ``index`` of ``n_stages`` of a
    ``n_layers``-block cut of ``name``'s recipe blocks at full width, made
    from phase 13's seed on ``device`` (every process makes all the
    weights and keeps its own). Stage 0 embeds the tokens; the last stage
    applies the final norm and the head to the last position (fp32
    logits). forward records, for each call, when it began and when it
    ended with the card synced (the host's wall clock, which the driver
    shares), so an execute splits into stage compute and hops."""

    def __init__(self, name, n_layers, index, n_stages, device="cuda"):
        from ray_tpu_torch import models
        from ray_tpu_torch.models.transformer import RMSNorm
        self.device = device
        cfg = dataclasses.replace(recipe_cfg(models, name), n_layers=n_layers)
        self.cfg = cfg
        weights = models.init_params(
            cfg, torch.Generator(device=device).manual_seed(0), device,
            dtype=cfg.param_dtype)
        per = n_layers // n_stages
        self.blocks = models.BlockStage(cfg, per, device="meta")
        self.blocks.load_state_dict(
            models.stage_state_dict(weights, index * per, per), assign=True)
        self.embed = weights["embed"] if index == 0 else None
        self.norm = self.unembed = None
        if index == n_stages - 1:
            self.norm = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype,
                                "meta")
            self.norm.load_state_dict(
                {"scale": weights["final_norm.scale"]}, assign=True)
            self.unembed = weights["unembed"].to(cfg.dtype)
        del weights
        self.calls = []

    def forward(self, x):
        t_in = time.time()
        with torch.no_grad():
            if self.embed is not None:
                x = torch.nn.functional.embedding(
                    x.to(self.device), self.embed).to(self.cfg.dtype)
            x = self.blocks(x)
            if self.norm is not None:
                x = (self.norm(x)[:, -1] @ self.unembed).float()
        sync(self.device)
        self.calls.append((t_in, time.time()))
        return x

    def mask(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    def counts(self):
        from ray_tpu_torch.ops import attention as ops
        return read_counts(ops)

    def zero(self):
        from ray_tpu_torch.ops import attention as ops
        zero_counts(ops)
        self.calls = []

    def timings(self):
        return self.calls


class DagModel:
    """Phase 20 (b): the whole cut in one actor (both of (a)'s stages, one
    after the other), its logits returned on the host."""

    def __init__(self, name, n_layers, n_stages, device="cuda"):
        self.stages = [DagStage(name, n_layers, i, n_stages, device)
                       for i in range(n_stages)]

    def forward(self, tokens):
        for s in self.stages:
            tokens = s.forward(tokens)
        return tokens.cpu()

    def mask(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    def counts(self):
        return self.stages[0].counts()


class _Echo:
    def ping(self, x):
        return x


def _dag_tokens(vocab, B, L, n, device):
    g = torch.Generator(device=device).manual_seed(200)
    return [torch.randint(0, vocab, (B, L), device=device, generator=g)
            .cpu() for _ in range(n)]


def _pickled_bytes(x):
    import pickle
    return len(pickle.dumps(x, protocol=5))


def _ms_spread(seconds):
    med, lo, hi = median_spread([s * 1e3 for s in seconds])
    return f"{med:.2f} ms [{lo:.2f}, {hi:.2f}]"


def dag_pipeline(rt, ops, card, device, name, n_layers, B, L, n_exec):
    """Phase 20 (a). Returns the driver's outputs (the reference of (b))
    and the flash launches counted in the stage actors."""
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.experimental.channel import CHANNEL_PREFIX
    t_part = time.perf_counter()
    gpu = 1.0 / DAG_STAGES if device == "cuda" else 0
    stage_cls = rt.remote(num_gpus=gpu)(DagStage)
    stages = [stage_cls.remote(name, n_layers, i, DAG_STAGES, device)
              for i in range(DAG_STAGES)]
    masks = rt.get([s.mask.remote() for s in stages], timeout=600)
    start_s = time.perf_counter() - t_part
    local = [DagStage(name, n_layers, i, DAG_STAGES, device)
             for i in range(DAG_STAGES)]
    cfg = local[0].cfg
    batches = _dag_tokens(cfg.vocab_size, B, L, n_exec, device)
    want = []
    for tokens in batches:
        x = tokens
        for s in local:
            x = s.forward(x)
        want.append(x)
    names = ["driver -> stage 0"] + [
        f"stage {i} -> " + ("driver" if i == DAG_STAGES - 1
                            else f"stage {i + 1}")
        for i in range(DAG_STAGES)]
    edges, x = [(names[0], batches[0])], batches[0]
    for i, s in enumerate(local):
        x = s.forward(x)
        edges.append((names[i + 1], x))
    del local
    release(device)
    crossing = [(e, f"{t.device.type} {t.dtype} {list(t.shape)}",
                 _pickled_bytes(t)) for e, t in edges]
    print(f"dag (a): {DAG_STAGES} stage actors of {name}'s {n_layers}-block "
          f"cut ({n_layers // DAG_STAGES} blocks each, bf16 weights of "
          f"phase 13's seed; num_gpus {gpu} each) up in {start_s:.2f} s, "
          f"masks {masks}; edges (what crosses, pickled bytes) {crossing} "
          f"[{card}]", flush=True)
    if device == "cuda" and masks != ["0"] * DAG_STAGES:
        fail(f"the stage actors' masks are {masks}, want '0' each")

    rt.get([s.zero.remote() for s in stages], timeout=60)
    with InputNode() as inp:
        node = inp
        for s in stages:
            node = s.forward.bind(node)
    t0 = time.perf_counter()
    dag = node.experimental_compile(max_buffer_size=DAG_BUFFER)
    compile_s = time.perf_counter() - t0
    got, spans = [], []
    try:
        for tokens in batches:      # main path: the compiled DAG
            t_in = time.time()
            got.append(dag.execute(tokens, timeout_s=300))
            spans.append((t_in, time.time()))
    finally:
        dag.teardown()
    loops = rt.get(dag._loop_refs, timeout=60)
    left = glob.glob(f"{glob.escape(dag.prefix)}*")
    counts = [rt.get(s.counts.remote(), timeout=60) for s in stages]
    calls = [rt.get(s.timings.remote(), timeout=60) for s in stages]
    total = {k: sum(c[k] for c in counts) for k in KERNELS}
    equal = [torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want)]
    kinds = {f"{g.device.type} {g.dtype} {list(g.shape)}" for g in got}
    hops = [[] for _ in range(DAG_STAGES + 1)]
    compute = [[] for _ in range(DAG_STAGES)]
    for e, (t_in, t_out) in enumerate(spans):
        prev = t_in
        for s in range(DAG_STAGES):
            c_in, c_out = calls[s][e]
            hops[s].append(c_in - prev)
            compute[s].append(c_out - c_in)
            prev = c_out
        hops[-1].append(t_out - prev)
    # the first execute carries the stages' first kernels and the
    # channels' first touch: printed alone, the rest as median [min, max]
    wall = [b - a for a, b in spans]
    print(f"dag (a): compile {compile_s * 1e3:.1f} ms; {n_exec} executes of "
          f"{B}x{L} tokens, the first {wall[0] * 1e3:.2f} ms, the rest "
          f"{_ms_spread(wall[1:])} (median [min, max]); outputs {kinds}, "
          f"bitwise equal to the driver's in-process forward "
          f"{sum(equal)}/{len(equal)}; B1 launches counted in the actors "
          f"{counts} (sum {total}, want {n_layers} per execute) [{card}]",
          flush=True)
    names = [f"{n} (pickle, write, wake, read, unpickle)" for n in names]
    for s in range(DAG_STAGES):
        print(f"dag (a) hop {names[s]}: {_ms_spread(hops[s][1:])}; stage "
              f"{s} compute {_ms_spread(compute[s][1:])} (executes 2-"
              f"{n_exec})", flush=True)
    print(f"dag (a) hop {names[-1]}: {_ms_spread(hops[-1][1:])}; the hops' "
          f"share of executes 2-{n_exec} "
          f"{sum(sum(h[1:]) for h in hops) / sum(wall[1:]):.3f} [{card}]",
          flush=True)
    print(f"dag (a) teardown: actor loops returned {loops}; channel files "
          f"left {left}", flush=True)
    if not all(equal) or len(got) != n_exec:
        fail("the compiled DAG's outputs differ from the in-process forward")
    if set(loops) != {"closed"} or left:
        fail(f"teardown: loops {loops}, channel files left {left}")
    want_b1 = n_layers * n_exec if device == "cuda" else 0
    if total != {"flash_fwd": want_b1, "flash_bwd_dq": 0,
                 "flash_bwd_dkv": 0}:
        fail(f"the stage actors launched {total}, want {want_b1} B1")

    # the same chain through .remote(), its values through the store
    chain = []
    for tokens in batches:
        t0 = time.perf_counter()
        ref = tokens
        for s in stages:
            ref = s.forward.remote(ref)
        out = rt.get(ref, timeout=300)
        chain.append(time.perf_counter() - t0)
        if not torch.equal(out.cpu(), want[len(chain) - 1].cpu()):
            fail("the .remote() chain's output differs from the DAG's")
    print(f"dag (a) the same chain through .remote(): "
          f"{_ms_spread(chain)} a call vs the DAG's {_ms_spread(wall[1:])}, "
          f".remote()/DAG {np.median(chain) / np.median(wall[1:]):.3f} "
          f"[{card}]", flush=True)

    # a one-actor Echo DAG on a small int against .remote()
    echo = rt.remote(_Echo).remote()
    with InputNode() as inp:
        edag = echo.ping.bind(inp).experimental_compile()
    try:
        for i in range(5):
            edag.execute(i)
        n = 200
        t0 = time.perf_counter()
        for i in range(n):
            if edag.execute(i) != i:
                fail("the Echo DAG returned another value")
        dag_us = (time.perf_counter() - t0) / n * 1e6
    finally:
        edag.teardown()
    rt.get(echo.ping.remote(0), timeout=60)
    t0 = time.perf_counter()
    for i in range(n):
        rt.get(echo.ping.remote(i), timeout=60)
    rpc_us = (time.perf_counter() - t0) / n * 1e6
    print(f"dag (a) Echo round trip of a small int: compiled DAG "
          f"{dag_us:.1f} us, .remote() {rpc_us:.1f} us ({n} calls each, "
          f"{rpc_us / dag_us:.1f}x); part (a) "
          f"{time.perf_counter() - t_part:.1f} s", flush=True)
    for s in stages + [echo]:
        rt.kill(s)
    return want, total


CLIENT_HOST = """
import sys
import ray_tpu_torch as rt
from ray_tpu_torch.client import serve_proxy
rt.init(object_store_memory=4 * 2 ** 30)
print("SESSION=" + rt._context.node.session_name, flush=True)
print("PROXY_ADDR=" + serve_proxy(), flush=True)
sys.stdin.readline()
rt.shutdown()
print("HOST_DONE", flush=True)
"""


def client_session(rt, ops, card, device, name, n_layers, tokens, want):
    """Phase 20 (b): a host subprocess holds the runtime and the proxy;
    this process connects with init("ray://...") and holds none. Returns
    the flash launches counted in the client's actor."""
    t_part = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.dirname(os.path.abspath(__file__)),
                    env.get("PYTHONPATH")) if p)
    host = subprocess.Popen([sys.executable, "-c", CLIENT_HOST],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True, env=env)
    info = {}
    while "PROXY_ADDR" not in info:
        line = host.stdout.readline()
        if not line:
            fail(f"the client host exited (rc {host.wait()}) before its "
                 f"proxy was up")
        if "=" in line:
            k, v = line.strip().split("=", 1)
            info[k] = v
    up_s = time.perf_counter() - t_part
    try:
        if not info["PROXY_ADDR"].startswith("tcp:127.0.0.1:"):
            fail(f"client (b): the proxy listens on {info['PROXY_ADDR']}, "
                 f"not on loopback")
        t0 = time.perf_counter()
        ctx = rt.init(f"ray://{info['PROXY_ADDR']}")
        connect_s = time.perf_counter() - t0
        if rt.is_initialized() or ctx is not rt._client():
            fail("client mode: this process holds a runtime")
        t0 = time.perf_counter()
        gpu = 1 if device == "cuda" else 0
        model = rt.remote(num_gpus=gpu)(DagModel).remote(
            name, n_layers, DAG_STAGES, device)
        mask = rt.get(model.mask.remote(), timeout=600)
        actor_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = rt.get(model.forward.remote(tokens), timeout=300)
        forward_s = time.perf_counter() - t0
        counts = rt.get(model.counts.remote(), timeout=60)
        equal = torch.equal(out, want.cpu())
        arr = np.random.default_rng(5).integers(
            0, 2 ** 63, size=64 * 2 ** 20 // 8, dtype=np.int64)
        t0 = time.perf_counter()
        ref = rt.put(arr)
        put_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = rt.get(ref, timeout=300)
        get_s = time.perf_counter() - t0
        mb = arr.nbytes / 2 ** 20
        same = back.dtype == arr.dtype and np.array_equal(back, arr)
        rt.kill(model)
        rt.shutdown()               # client mode: leaves the proxy session
    finally:
        try:
            done, _ = host.communicate("stop\n", timeout=120)
        except subprocess.TimeoutExpired:
            host.kill()
            done, _ = host.communicate()
        rc = host.returncode
    left, shm = session_left(info["SESSION"])
    print(f"client (b): host runtime and proxy at {info['PROXY_ADDR']} up "
          f"in {up_s:.2f} s, init('ray://...') {connect_s * 1e3:.1f} ms "
          f"(no local runtime); a num_gpus={gpu} actor through the proxy "
          f"up in {actor_s:.2f} s, mask {mask!r}; its forward of (a)'s "
          f"first batch {forward_s * 1e3:.1f} ms, logits "
          f"{list(out.shape)} {out.dtype} bitwise equal to (a)'s: {equal}; "
          f"launches in the actor {counts}; a {mb:.0f} MiB int64 array put "
          f"{mb / put_s:.1f} MB/s ({put_s:.3f} s), get {mb / get_s:.1f} MB/s "
          f"({get_s:.3f} s), bitwise equal {same} [{card}]", flush=True)
    print(f"client (b): host exit {rc} ({'HOST_DONE' in done}); after its "
          f"shutdown the session's processes {left}, /dev/shm files {shm}; "
          f"part (b) {time.perf_counter() - t_part:.1f} s", flush=True)
    if device == "cuda" and mask != "0":
        fail(f"the client's GPU actor has mask {mask!r}, want '0'")
    if not equal or not same:
        fail("client mode: the actor's logits or the array came back "
             "otherwise")
    want_b1 = n_layers if device == "cuda" else 0
    if counts != {"flash_fwd": want_b1, "flash_bwd_dq": 0,
                  "flash_bwd_dkv": 0}:
        fail(f"the client's actor launched {counts}, want {want_b1} B1")
    if rc != 0 or left or shm:
        fail(f"the client host left processes {left} or files {shm} "
             f"(exit {rc})")
    return counts


def tune_steps(config):
    """Phase 20 (c)'s trial: phase 6's fp32-AdamW step (no recompute,
    fp32 master weights) on ``config``'s cut of its model at full width,
    lr from the config; yields each step's loss, time, peak memory and
    the step's flash launches. The trial and the driver's reference run
    this."""
    from ray_tpu_torch import models, parallel
    from ray_tpu_torch.ops import attention as ops
    device = config["device"]
    cfg = dataclasses.replace(models.MODEL_REGISTRY[config["name"]],
                              remat=False, n_layers=config["n_layers"])
    B, L = config["B"], config["L"]
    _, init_fn, step_fn = train_fns(
        models, parallel, cfg, device, B, L, config["loss_chunk"],
        parallel.adamw(config["lr"]))
    state = init_fn(torch.Generator(device=device).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (B, L + 1), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(3))
    for _ in range(config["steps"]):
        before = read_counts(ops)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, tokens)
        loss = metrics["loss"].item()
        step_s = time.perf_counter() - t0
        yield {"loss": loss, "step_ms": step_s * 1e3,
               "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                            if device == "cuda" else 0.0),
               "launches": {k: n - before[k]
                            for k, n in read_counts(ops).items()}}


def tune_trial(config):
    """Phase 20 (c): one Tune trial, in its trial actor."""
    from ray_tpu_torch import tune
    mask = os.environ.get("CUDA_VISIBLE_DEVICES")
    for result in tune_steps(config):
        tune.report(mask=mask, pid=os.getpid(), **result)


def tune_trials(rt, card, device, name, n_layers, B, L, loss_chunk):
    """Phase 20 (c). Returns the flash launches the trials counted."""
    from ray_tpu_torch import tune
    t_part = time.perf_counter()
    lrs = [3e-4, 1e-3, 3e-3, 1e-2]
    asha = dict(metric="loss", mode="min", max_t=4, grace_period=1,
                reduction_factor=2)
    log = []

    class RecordingASHA(tune.ASHAScheduler):
        def on_result(self, trial_id, result):
            decision = super().on_result(trial_id, result)
            log.append((trial_id, dict(result), decision))
            return decision

    per_trial = {"CPU": 1, "GPU": 0.25} if device == "cuda" else {"CPU": 1}
    space = {"lr": tune.grid_search(lrs), "device": device, "name": name,
             "n_layers": n_layers, "B": B, "L": L,
             "loss_chunk": loss_chunk, "steps": asha["max_t"]}
    tuner = tune.Tuner(tune_trial, param_space=space,
                       tune_config=tune.TuneConfig(
                           scheduler=RecordingASHA(**asha),
                           max_concurrent_trials=4),
                       resources_per_trial=per_trial)
    t0 = time.perf_counter()
    grid = tuner.fit()
    fit_s = time.perf_counter() - t0
    replay = tune.ASHAScheduler(**asha)
    replayed = [replay.on_result(t, r) for t, r, _ in log]
    decided = [d for _, _, d in log]
    total = {k: 0 for k in KERNELS}
    for r in sorted(grid, key=lambda r: r.trial_id):
        h = r.history
        for k in KERNELS:
            total[k] += sum(x["launches"][k] for x in h)
        stops = [d for t, _, d in log if t == r.trial_id]
        # the tuner kills a trial's actor at the poll that brings ASHA's
        # first STOP, after the steps that poll read: a trial whose steps
        # were all read by then had ended before the STOP could end it
        first_stop = next((x["training_iteration"] for t, x, d in log
                           if t == r.trial_id and d == tune.schedulers.STOP),
                          None)
        if first_stop is None:
            ended = "ran to its end, no STOP"
        elif len(h) < asha["max_t"]:
            ended = (f"first STOP at step {first_stop}, its actor killed "
                     f"at the poll that read step {len(h)} of "
                     f"{asha['max_t']}")
        else:
            ended = (f"first STOP at step {first_stop}, read after all "
                     f"{len(h)} steps: the trial had ended before it")
        print(f"tune (c) {r.trial_id}: lr {r.config['lr']:g}, pid "
              f"{h[0]['pid'] if h else None}, mask "
              f"{sorted({x['mask'] for x in h})}, {len(h)} steps, losses "
              f"{[x['loss'] for x in h]}, step "
              f"{[round(x['step_ms'], 1) for x in h]} ms, peak "
              f"{max((x['peak_gib'] for x in h), default=0):.2f} GiB, ASHA "
              f"{stops}: {ended}; error {r.error}", flush=True)
    best = grid.get_best_result("loss", mode="min")
    ref_cfg = dict(best.config, steps=len(best.history))
    ref = [x["loss"] for x in tune_steps(ref_cfg)]
    got = [x["loss"] for x in best.history]
    masks = {x["mask"] for r in grid for x in r.history}
    print(f"tune (c): {len(grid)} trials of {name} at {n_layers} blocks, "
          f"{B}x{L}, adamw(lr) over lr {lrs}, resources per trial "
          f"{per_trial}, 4 at once, ASHA {asha}: fit {fit_s:.2f} s; ASHA's "
          f"{len(log)} decisions replayed in this process equal: "
          f"{replayed == decided}; the best trial ({best.trial_id}, lr "
          f"{best.config['lr']:g}) losses {got} vs the same steps in this "
          f"process {ref} (bitwise {got == ref}); flash launches counted in "
          f"the trials {total}; part (c) {time.perf_counter() - t_part:.1f} "
          f"s [{card}]", flush=True)
    if any(r.error for r in grid) or len(grid) != len(lrs):
        fail(f"tune: trials failed {[r.error for r in grid]}")
    if device == "cuda" and masks != {"0"}:
        fail(f"tune: the trials' masks are {masks}, want '0'")
    if replayed != decided or got != ref:
        fail("tune: ASHA's replay or the best trial's losses differ")
    steps = sum(len(r.history) for r in grid)
    want = n_layers * steps if device == "cuda" else 0
    if total != {k: want for k in KERNELS}:
        fail(f"tune: the trials launched {total}, want {want} of each")
    return total


def _version(module):
    import importlib
    try:
        return importlib.import_module(module).__version__
    except ImportError:
        return None


def run_dag_client_tune(models, ops, card, device="cuda", name="tpu-3b",
                        n_layers=DAG_LAYERS, B=2, L=1024, n_exec=10,
                        tune_layers=2, loss_chunk=256):
    """Phase 20: the compiled DAG (a), client mode (b), Tune (c) and the
    probe (d). Returns the flash launches of (a), (b) and (c)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.native.build import build as build_native
    t_phase = time.perf_counter()
    lib = build_native("mutable_channel")
    print(f"dag: the channel library {os.path.basename(lib)} (g++, from "
          f"ray_tpu_torch/native/mutable_channel.cpp) ready in "
          f"{time.perf_counter() - t_phase:.2f} s", flush=True)
    rt.init(object_store_memory=8 * 2 ** 30)
    session = rt._context.node.session_name
    try:
        want, dag_counts = dag_pipeline(rt, ops, card, device, name,
                                        n_layers, B, L, n_exec)
    finally:
        rt.shutdown()
    left, shm = session_left(session)
    if left or shm:
        fail(f"dag: the runtime left processes {left} or files {shm}")
    tokens = _dag_tokens(models.MODEL_REGISTRY[name].vocab_size, B, L, 1,
                         device)[0]
    client_counts = client_session(rt, ops, card, device, name, n_layers,
                                   tokens, want[0])
    rt.init(object_store_memory=8 * 2 ** 30)
    session = rt._context.node.session_name
    try:
        tune_counts = tune_trials(rt, card, device, name, tune_layers, B, L,
                                  loss_chunk)
    finally:
        rt.shutdown()
    left, shm = session_left(session)
    if left or shm:
        fail(f"tune: the runtime left processes {left} or files {shm}")
    print(f"probe (d): pyarrow {_version('pyarrow') or 'not installed'}, "
          f"pandas {_version('pandas') or 'not installed'}", flush=True)
    print(f"phase 20 (dag, client, tune): "
          f"{time.perf_counter() - t_phase:.1f} s, launches: dag "
          f"{dag_counts}, client {client_counts}, tune {tune_counts} "
          f"[{card}]", flush=True)
    return dag_counts, client_counts, tune_counts


# ------------------------------------------------------------- phase 21

def params_digest(sd):
    """sha256 over a state dict's names, dtypes, shapes and bytes, in
    name order: what phase 21 holds a checkpoint's readers to."""
    import hashlib
    h = hashlib.sha256()
    for n in sorted(sd):
        t = sd[n].detach().contiguous().cpu().reshape(-1)
        h.update(f"{n}:{t.dtype}:{tuple(sd[n].shape)}".encode())
        h.update(t.view(torch.uint8).numpy())
    return h.hexdigest()


def phase21_job(config_json):
    """Phase 21 (a)'s job entrypoint, run by the job's supervisor as
    ``python -c 'import chip_smoke; ...'`` with the cluster's address in
    its environment: phase 17's recipe loop in a num_gpus=1 TorchTrainer
    worker, which takes each step's batch from ``data.read_parquet`` of
    the smoke's token file through ``TorchTrainer(datasets=)``, its last
    step saving the parameters with save_sharded; prints the reports on
    one line that starts with PHASE21."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data, train
    config = json.loads(config_json)
    rt.init()
    t_fit = time.time()
    res = train.TorchTrainer(
        recipe_worker_loop, train_loop_config=config,
        scaling_config=train.ScalingConfig(
            num_workers=1, use_gpu=config["device"] == "cuda"),
        run_config=train.RunConfig(storage_path=config["tmp"],
                                   name="phase21"),
        datasets={"train": data.read_parquet(config["data"])}).fit()
    if res.error is not None:
        raise res.error
    print("PHASE21 " + json.dumps({"t_fit": t_fit,
                                   "history": res.metrics_history},
                                  default=str), flush=True)


def build_phase21_app(path, name, num_gpus, engine):
    """Phase 21 (b)'s application, named by the YAML that ``cli serve
    deploy`` reads: LLMDeployment of ``name`` whose params_fn is
    checkpoint_weight_source(path), recording the digest of the
    parameters it restored, its construction's start and length and how
    the weight source resolved. The class is made here, in a function,
    so the runtime ships it by value."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.inference.api import LLMDeployment

    class CheckpointLLM(LLMDeployment):
        def __init__(self, path, name, **engine):
            from ray_tpu_torch.serve import weights
            self.t_init = time.time()
            source = weights.checkpoint_weight_source(path)

            def params_fn():
                params = source()
                self.digest = params_digest(params)
                return params
            super().__init__(name, params_fn=params_fn, weights_key=None,
                             **engine)
            self.init_s = time.time() - self.t_init
            self.weights = dict(weights.last_resolve)

        def probe(self):
            import ray_tpu_torch as rt
            return {"digest": self.digest, "t_init": self.t_init,
                    "init_s": self.init_s, "weights": self.weights,
                    "pid": os.getpid(), "ids": rt.get_gpu_ids(),
                    "mask": os.environ.get("CUDA_VISIBLE_DEVICES")}

    gpus = {"num_gpus": num_gpus} if num_gpus else {}
    return serve.deployment(CheckpointLLM, name="llm",
                            ray_actor_options=gpus).bind(path, name,
                                                         **engine)


def autoscaled_forward(name, n_layers, L, device):
    """Phase 21 (c)'s task: the forward of the first ``n_layers`` blocks
    of ``name``'s recipe at full width (phase 20's DagStage: phase 13's
    seed, made here on the task's card, so nothing rides the node's
    arena), B=1, the final norm and head on the last position. Returns
    the logits, the flash launches and when the task began."""
    t_start = time.time()
    from ray_tpu_torch.ops import attention as ops
    torch.set_float32_matmul_precision("highest")
    zero_counts(ops)
    stage = DagStage(name, n_layers, 0, 1, device)
    tokens = _dag_tokens(stage.cfg.vocab_size, 1, L, 1, device)[0]
    out = stage.forward(tokens).cpu()
    return {"t_start": t_start, "logits": out, "launches": read_counts(ops),
            "mask": os.environ.get("CUDA_VISIBLE_DEVICES")}


def _cli(args, env, timeout=900):
    """``python -m ray_tpu_torch.scripts.cli`` as a process; fails the
    smoke when it exits non-zero."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", *args],
        env=env, capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        fail(f"cli {' '.join(args[:3])} exited {out.returncode}: "
             f"{out.stdout[-2000:]} {out.stderr[-2000:]}")
    return out.stdout, time.perf_counter() - t0


def _cluster_env(tmp):
    """What the port's CLI and the cluster it starts run with: the repo
    and nothing else on the path, and a TMPDIR of their own (the head
    file and the session's logs go under it)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root, TMPDIR=os.path.join(tmp, "t"))
    env.pop("RAY_TPU_TORCH_ADDRESS", None)
    os.makedirs(env["TMPDIR"], exist_ok=True)
    return env


def cluster_job(rt, models, card, env, tmp, recipe_steps, config):
    """Phase 21 (a): a head from the CLI with the dashboard on loopback, a
    submitted job training ``config``'s recipe in a num_gpus=1 worker on
    batches from a Parquet Dataset, and saving a sharded checkpoint. Returns the session, the dashboard's
    address, the checkpoint's digest and the worker's launches."""
    import re
    import shlex
    import urllib.request

    from ray_tpu_torch.job_submission import JobSubmissionClient
    out, head_s = _cli(["start", "--head", "--dashboard", "--dashboard-port",
                        "0", "--object-store-memory",
                        str(config["store_bytes"])], env)
    dash = re.search(r"dashboard at (http://\S+)", out).group(1)
    with open(os.path.join(env["TMPDIR"], "raytpu_torch",
                           "latest_head.json")) as f:
        head = json.load(f)
    print(f"cluster (a): torch {torch.__version__}; `cli start --head "
          f"--dashboard` {head_s:.2f} s, GCS {head['gcs_address']}, session "
          f"{head['session']}, dashboard {dash} [{card}]", flush=True)
    if not dash.startswith("http://127.0.0.1:"):
        fail(f"the dashboard listens on {dash}, not on loopback")
    job_cfg = {k: config[k] for k in ("device", "name", "n_layers", "B", "L",
                                      "steps", "loss_chunk", "lr")}
    job_cfg.update(checkpoint=False, tmp=tmp, save_to=config["ckpt"],
                   dataset=True, data=write_recipe_tokens(models, config,
                                                          tmp))
    entry = (f"{sys.executable} -c 'import sys, chip_smoke; "
             f"chip_smoke.phase21_job(sys.argv[1])' "
             f"{shlex.quote(json.dumps(job_cfg))}")
    t_submit = time.time()
    out, job_s = _cli(["submit", "--wait", "--timeout", "900", entry], env)
    job_id = re.search(r"submitted (\S+)", out).group(1)
    rt.init(address=head["gcs_address"])
    client = JobSubmissionClient()
    status = client.get_job_status(job_id)
    logs = client.get_job_logs(job_id)
    with urllib.request.urlopen(f"{dash}/api/jobs", timeout=30) as r:
        rest = {j["job_id"]: j["status"] for j in json.loads(r.read())}
    listed = {str(j["job_id"]): j.get("status") for j in
              json.loads(_cli(["list", "jobs"], env)[0])}
    print(f"cluster (a): job {job_id} {status} in {job_s:.1f} s (`cli "
          f"submit --wait`); through /api/jobs {rest.get(job_id)}, `cli list "
          f"jobs` {listed.get(job_id)}; {len(logs.splitlines())} log lines "
          f"through get_job_logs", flush=True)
    if {status, rest.get(job_id), listed.get(job_id)} != {"SUCCEEDED"}:
        fail("the job did not end SUCCEEDED through the client, the "
             "dashboard and the CLI")
    line = [x for x in logs.splitlines() if x.startswith("PHASE21 ")]
    if not line:
        fail(f"the job's report never reached get_job_logs: {logs[-2000:]}")
    report = json.loads(line[-1][len("PHASE21 "):])
    hist = report["history"]
    n = (config["n_layers"] or models_registry_layers(config["name"])) \
        if config["device"] == "cuda" else 0
    want = {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    launches = {k: 0 for k in want}
    print(f"cluster (a): the train worker's loop began "
          f"{hist[0]['t_loop'] - report['t_fit']:.2f} s after fit() "
          f"({hist[0]['t_loop'] - t_submit:.2f} s after the submit) [{card}]",
          flush=True)
    for h, (loss, gnorm, _) in zip(hist, recipe_steps):
        same = h["loss"] == loss and h["grad_norm"] == gnorm
        print(f"cluster (a) step {h['step']}: loss {h['loss']!r} (phase 7: "
              f"{loss!r}, bitwise {same}), {h['step_s'] * 1e3:.1f} ms, "
              f"data_wait {h['profile'].get('data_wait_ms')} ms (batch from "
              f"the Dataset: {h['batch']}), launches {h['launches']} "
              f"[{card}]", flush=True)
        if not same:
            fail(f"cluster job step {h['step']}: loss/grad_norm differ from "
                 f"phase 7's in-process step")
        want_dev = "cuda:0" if config["device"] == "cuda" else "cpu"
        if not h["batch"]["equal"] or h["batch"]["device"] != want_dev or \
                h["batch"]["dtype"] != "torch.int64":
            fail(f"cluster job step {h['step']}: the Dataset's batch is "
                 f"{h['batch']}, not phase 7's int64 batch on {want_dev}")
        if h["launches"] != want:
            fail(f"cluster job step {h['step']} launched {h['launches']}, "
                 f"want {want}")
        for k in want:
            launches[k] += h["launches"][k]
    if len(hist) != config["steps"]:
        fail(f"the job reported {len(hist)} steps")
    ck = hist[-1]["ckpt"]
    print(f"cluster (a): save_sharded wrote {ck['bytes'] / 1e9:.3f} GB in "
          f"{ck['s']:.2f} s ({ck['bytes'] / ck['s'] / 1e9:.2f} GB/s), digest "
          f"{ck['digest'][:16]} [{card}]", flush=True)
    return head, dash, ck["digest"], launches


def write_recipe_tokens(models, config, tmp):
    """Phase 7's token batch (B rows of L+1 tokens from the same seed,
    made on the same device) once per step, as int32 rows of one Parquet
    file for the job's Dataset. Returns the file's absolute path."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    device, B, L = config["device"], config["B"], config["L"]
    cfg = recipe_cfg(models, config["name"])
    tokens = torch.randint(0, cfg.vocab_size, (B, L + 1), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(3)).to(torch.int32).cpu().numpy()
    rows = np.concatenate([tokens] * config["steps"])
    path = os.path.join(tmp, "tokens.parquet")
    pq.write_table(pa.table({"tokens": pa.FixedSizeListArray.from_arrays(
        pa.array(rows.reshape(-1)), L + 1)}), path)
    print(f"cluster (a): {rows.shape[0]} rows of {L + 1} int32 tokens "
          f"(phase 7's batch, {config['steps']} steps) in {path}",
          flush=True)
    return path


def models_registry_layers(name):
    from ray_tpu_torch.models import MODEL_REGISTRY
    return MODEL_REGISTRY[name].n_layers


def cluster_serve(rt, serve, models, inference, card, env, tmp, head, digest,
                  config):
    """Phase 21 (b): `cli serve deploy` of an LLMDeployment whose
    params_fn reads (a)'s checkpoint; the replica's params digest,
    greedy requests over HTTP against a one-shot forward of the same
    checkpoint in this process, `cli serve status`, then `cli serve
    delete` and `cli stop`, after which nothing of the session is
    left."""
    import yaml

    from ray_tpu_torch.inference.api import _load_params, _resolve_model
    from ray_tpu_torch.train.sharded_checkpoint import restore_host_arrays
    device, name = config["device"], config["name"]
    spec = {"http_options": {"port": 0}, "applications": [{
        "name": "llm", "route_prefix": "/",
        "import_path": "chip_smoke:build_phase21_app",
        "args": {"path": config["ckpt"], "name": name,
                 "num_gpus": 1 if device == "cuda" else 0,
                 "engine": dict(config["engine"], device=device)}}]}
    path = os.path.join(tmp, "serve.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(spec, f)
    t_deploy = time.time()
    _, deploy_s = _cli(["serve", "deploy", path], env)
    handle = serve.get_app_handle("llm")
    (info,) = [rt.get(r.handle_request.remote("probe", (), {}), timeout=900)
               for r in _replicas(handle, 1)]
    ready_s = time.time() - t_deploy
    w = info["weights"]
    gb = config["ckpt_bytes"] / 1e9
    print(f"cluster (b): `cli serve deploy` {deploy_s:.2f} s; replica ready "
          f"{ready_s:.2f} s after the deploy began: its worker's start "
          f"{info['t_init'] - t_deploy:.2f} s, the LLMDeployment "
          f"construction {info['init_s']:.2f} s, of which the checkpoint "
          f"read {w.get('load_s', float('nan')):.2f} s "
          f"({gb / w.get('load_s', float('nan')):.2f} GB/s) and the publish "
          f"{w.get('publish_s', float('nan')):.2f} s "
          f"({gb / w.get('publish_s', float('nan')):.2f} GB/s), source "
          f"{w.get('source')}; GPU ids {info['ids']} mask {info['mask']!r}; "
          f"params digest {info['digest'][:16]} (job's {digest[:16]}) "
          f"[{card}]", flush=True)
    if info["digest"] != digest:
        fail("the replica's restored params differ from the job's")
    if w.get("source") != "loader" or not w.get("published"):
        fail(f"the checkpoint was not read and published once: {w}")
    (addr,) = [p["http"] for p in serve.proxies().values()]
    cfg = models.MODEL_REGISTRY[name]
    rng = np.random.RandomState(21)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in config["lens"]]
    new = config["new"]

    def over_http(p, n, out, i):
        _http_stream(f"http://{addr}/", {"prompt_tokens": p.tolist(),
                                          "max_new_tokens": n}, out, i)
    runs = _concurrently(over_http, list(zip(prompts, new)))
    for i, (r, n) in enumerate(zip(runs, new)):
        if r is None or r["status"] != 200 or len(r["tokens"]) != n:
            fail(f"cluster (b): request {i} gave "
                 f"{None if r is None else (r['status'], len(r['tokens']))}")
    print(f"cluster (b): {len(prompts)} greedy requests at once over HTTP; "
          f"per request (TTFT ms, TPOT ms) "
          f"{[_ttft_tpot(r['times']) for r in runs]} [{card}]", flush=True)
    model = _load_params(_resolve_model(name),
                         restore_host_arrays(config["ckpt"]), device)
    check_one_shot("cluster serve", model, models, prompts,
                   [r["tokens"] for r in runs], device)
    del model
    release(device)
    st = json.loads(_cli(["serve", "status"], env)[0])
    print(f"cluster (b): `cli serve status` applications "
          f"{st['applications']}", flush=True)
    if "llm" not in st["applications"] or not st["applications"]["llm"]:
        fail("`cli serve status` does not show the application")
    _cli(["serve", "delete", "llm"], env)
    rt.shutdown()
    _cli(["stop"], env)
    left, shm = session_left(head["session"])
    print(f"cluster (b): after `cli serve delete` and `cli stop`, the "
          f"session's processes {left}, /dev/shm files {shm}", flush=True)
    if left or shm:
        fail("`cli stop` left processes or shared-memory files behind")


ASC_YAML = """\
cluster_name: phase21
provider: {type: fake}
head: {num_cpus: 1, resources: {GPU: 0}}
available_node_types:
  gpu_worker:
    resources: {CPU: 1, GPU: 1}
    min_workers: 0
    max_workers: 1
idle_timeout_s: %s
"""


def cluster_autoscale(rt, card, env, tmp, config):
    """Phase 21 (c): `cli up --block` on a fake-provider cluster whose
    head offers no GPU; a num_gpus=1 task pends until the autoscaler
    launches the gpu_worker node, runs the forward of the recipe's first
    blocks there, equal bit for bit to the same forward here; the idle
    node is removed, and `cli down` leaves nothing of the session.
    Returns the task's launches."""
    device = config["device"]
    path = os.path.join(tmp, "cluster.yaml")
    with open(path, "w") as f:
        f.write(ASC_YAML % config["idle_timeout_s"])
    state = os.path.join(env["TMPDIR"], "raytpu_torch",
                         "cluster_launcher.json")
    t0 = time.perf_counter()
    up = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "up", "--block",
         path], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        while not os.path.exists(state):
            if up.poll() is not None or time.perf_counter() - t0 > 120:
                fail(f"`cli up` did not bring the cluster up: "
                     f"{up.stdout.read()[-2000:]}")
            time.sleep(0.1)
        with open(state) as f:
            st = json.load(f)
        up_s = time.perf_counter() - t0
        rt.init(address=st["gcs_address"])
        task = rt.remote(autoscaled_forward).options(
            num_gpus=1, num_cpus=0)
        t_submit = time.time()
        ref = task.remote(config["name"], config["asc_layers"],
                          config["asc_L"], device)
        node_up = None
        while node_up is None:
            if sum(n["alive"] for n in rt.nodes()) > 1:
                node_up = time.time() - t_submit
            elif time.time() - t_submit > 120:
                fail("the autoscaler launched no node for the GPU task")
            time.sleep(0.05)
        got = rt.get(ref, timeout=600)
        t_done = time.time()
        removed = None
        while removed is None:
            if sum(n["alive"] for n in rt.nodes()) == 1:
                removed = time.time() - t_submit
            elif time.time() - t_done > 120:
                fail("the autoscaler did not remove the idle GPU node")
            time.sleep(0.1)
        rt.shutdown()
        want = autoscaled_forward(config["name"], config["asc_layers"],
                                  config["asc_L"], device)
        same = torch.equal(got["logits"], want["logits"])
        print(f"cluster (c): `cli up` {up_s:.2f} s; from the GPU task's "
              f"submit: node up {node_up:.2f} s, the task began "
              f"{got['t_start'] - t_submit:.2f} s, ended "
              f"{t_done - t_submit:.2f} s, node removed {removed:.2f} s "
              f"(idle timeout {config['idle_timeout_s']} s); mask "
              f"{got['mask']!r}; launches {got['launches']} (here "
              f"{want['launches']}); logits {tuple(got['logits'].shape)} "
              f"bitwise equal to the same forward here: {same} [{card}]",
              flush=True)
        if not same:
            fail("the autoscaled node's forward differs from this process's")
        n = config["asc_layers"] if device == "cuda" else 0
        if got["launches"]["flash_fwd"] != n or \
                got["launches"]["flash_bwd_dq"] or \
                got["launches"]["flash_bwd_dkv"]:
            fail(f"the autoscaled task launched {got['launches']}, want "
                 f"{n} B1")
        _cli(["down"], env)
        if up.wait(timeout=60) != 0:
            fail(f"`cli up --block` exited {up.returncode}")
    finally:
        if up.poll() is None:
            up.kill()
            up.wait()
    left, shm = session_left(st["session"])
    print(f"cluster (c): after `cli down`, the session's processes {left}, "
          f"/dev/shm files {shm}", flush=True)
    if left or shm:
        fail("`cli down` left processes or shared-memory files behind")
    return got["launches"]


def run_cluster_services(models, inference, ops, card, recipe_steps,
                         device="cuda", name="tpu-3b", n_layers=None, B=4,
                         L=1024, steps=3, loss_chunk=256, lr=3e-4,
                         engine=None, lens=(37, 100, 250, 500),
                         new=(16, 16, 16, 16), asc_layers=2, asc_L=1024,
                         idle_timeout_s=5, store_gib=16):
    """Phase 21: a cluster started from the port's CLI trains ``name``,
    checkpoints it and serves it from the checkpoint; then the
    autoscaler launches a GPU node for pending demand and removes it.
    Returns the flash launches of the job's worker and of the autoscaled
    task."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase21_")
    env = _cluster_env(tmp)
    config = dict(device=device, name=name, n_layers=n_layers, B=B, L=L,
                  steps=steps, loss_chunk=loss_chunk, lr=lr,
                  ckpt=os.path.join(tmp, "ckpt"),
                  store_bytes=store_gib * 2 ** 30,
                  engine=engine or dict(n_slots=4, max_len=1024,
                                        prefill_chunk=256,
                                        prefill_budget=512),
                  lens=lens, new=new, asc_layers=asc_layers, asc_L=asc_L,
                  idle_timeout_s=idle_timeout_s)
    try:
        t0 = time.perf_counter()
        head, dash, digest, launches = cluster_job(rt, models, card, env,
                                                   tmp, recipe_steps[:steps],
                                                   config)
        print(f"cluster (a): {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        config["ckpt_bytes"] = sum(
            os.path.getsize(os.path.join(config["ckpt"], f))
            for f in os.listdir(config["ckpt"]))
        cluster_serve(rt, serve, models, inference, card, env, tmp, head,
                      digest, config)
        print(f"cluster (b): {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        for k, n in cluster_autoscale(rt, card, env, tmp, config).items():
            launches[k] += n
        print(f"cluster (c): {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        if rt.is_initialized():
            rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"cluster: phase 21 {time.perf_counter() - t_phase:.1f} s, "
          f"launches {launches} [{card}]", flush=True)
    return launches


# ------------------------------------------------------------- phase 22

def write_token_files(root, n_files, rows_per_file, width, vocab, seed,
                      weights):
    """``n_files`` Parquet files of ``rows_per_file`` rows of ``width``
    int32 tokens below ``vocab`` (one row group each), made with numpy
    from ``seed``. Returns every row's hash (``weights`` dotted with the
    row, exact in int64), sorted: the files' order-free digest."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    hashes = []
    for i in range(n_files):
        t = rng.integers(0, vocab, (rows_per_file, width), dtype=np.int32)
        # random tokens neither compress nor dictionary-encode: writing
        # them plain saves both the writer's and the readers' time
        pq.write_table(pa.table({"tokens": pa.FixedSizeListArray.from_arrays(
            pa.array(t.reshape(-1)), width)}),
            os.path.join(root, f"part-{i:05d}.parquet"),
            compression="none", use_dictionary=False)
        hashes.append(t.astype(np.int64) @ weights)
    return np.sort(np.concatenate(hashes))


def split_tokens(table):
    """Phase 22's map: each row of L+1 tokens becomes ``inputs`` (the
    first L) and ``targets`` (the last L)."""
    from ray_tpu_torch.data.block import column_to_dense
    t = column_to_dense(table.column("tokens"))
    return {"inputs": t[:, :-1], "targets": t[:, 1:]}


def token_pipeline(data, root, seed):
    """read_parquet -> map_batches(split_tokens) -> random_shuffle(seed)."""
    return data.read_parquet(root).map_batches(
        split_tokens, batch_format="pyarrow").random_shuffle(seed=seed)


def stand_in_step(device, target_ms):
    """A fixed fp32 matmul chain of about ``target_ms`` on the card (the
    stand-in for a training step), and its measured time; nothing on the
    CPU."""
    if device != "cuda":
        return (lambda: None), 0.0
    a = torch.randn(2048, 2048, device=device)
    step = functools.partial(torch.mm, a, a)
    ms = cuda_ms(step, iters=20)
    reps = max(1, round(target_ms / ms))

    def chain():
        for _ in range(reps):
            step()
    return chain, cuda_ms(chain, iters=10)


def consume(batches, device, B, L, weights, step, keep=()):
    """Iterate phase 22's batches: hold each one's device, dtype, shape and
    shift, hash its rows (order-free) and the batch (order), run ``step``
    and wait for the card. Returns the row hashes, the per-batch hashes,
    the host's wait per batch (s), the kept batches and the seconds."""
    want_dev = torch.device("cuda", 0) if device == "cuda" else \
        torch.device("cpu")
    w_in = torch.as_tensor(weights[:L], device=want_dev)
    w_last = int(weights[L])
    gen = torch.Generator().manual_seed(2222)
    w_pos = torch.randint(1, 2 ** 20, (B, L), generator=gen,
                          dtype=torch.int64).to(want_dev)
    rows, order, waits, kept = [], [], [], {}
    it = iter(batches)
    t_all = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        b = next(it, None)
        waits.append(time.perf_counter() - t0)
        if b is None:
            waits.pop()
            break
        x, y = b["inputs"], b["targets"]
        for v in (x, y):
            if v.device != want_dev or v.dtype != torch.int64 or \
                    tuple(v.shape) != (B, L):
                fail(f"phase 22: batch {i} is {v.dtype} {tuple(v.shape)} "
                     f"on {v.device}, not int64 ({B}, {L}) on {want_dev}")
        if not torch.equal(x[:, 1:], y[:, :-1]):
            fail(f"phase 22: batch {i}'s targets are not its inputs "
                 "shifted by one")
        rows.append((x * w_in).sum(1) + y[:, -1] * w_last)
        order.append((x * w_pos).sum())
        if i in keep:
            kept[i] = {"inputs": x.cpu(), "targets": y.cpu()}
        step()
        sync(device)
        i += 1
    seconds = time.perf_counter() - t_all
    return (torch.cat(rows).cpu().numpy(), torch.stack(order).cpu().tolist(),
            waits, kept, seconds)


def _wait_ms(waits):
    ms = np.asarray(waits) * 1e3
    return (f"median {np.median(ms):.3f} ms, p99 "
            f"{np.percentile(ms, 99):.3f} ms, max {ms.max():.3f} ms")


def run_data_ingest(card, device="cuda", n_files=64, rows_per_file=4096,
                    L=1024, B=256, store_gib=8, step_ms=5.0, seed=22):
    """Phase 22: Data into the card. ``n_files`` Parquet files of
    ``rows_per_file`` rows of L+1 int32 tokens (1 GiB at the defaults)
    stream through read_parquet, map_batches (inputs/targets), a seeded
    random_shuffle and iter_torch_batches(batch_size=B, device, int64) in
    this process's runtime, three times: (a) with a stand-in step of
    ~``step_ms`` on the card, (b) without one, (c) on the CPU. Every row
    arrives once (an order-free digest against the files'), every batch
    is int64 (B, L) on the device, and (a), (b) and (c) give the same
    order batch by batch."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import data, models
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase22_")
    vocab = models.MODEL_REGISTRY["tpu-3b"].vocab_size
    weights = np.random.default_rng(seed + 1).integers(
        1, 2 ** 20, L + 1).astype(np.int64)
    t0 = time.perf_counter()
    want_rows = write_token_files(os.path.join(tmp, "tokens"), n_files,
                                  rows_per_file, L + 1, vocab, seed, weights)
    n_rows = n_files * rows_per_file
    file_gib = n_rows * (L + 1) * 4 / 2 ** 30
    print(f"data (22): wrote {n_rows} rows of {L + 1} int32 tokens "
          f"({file_gib:.3f} GiB) to {n_files} Parquet files in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rt.init(object_store_memory=store_gib * 2 ** 30)
    session = rt._context.node.session_name
    print(f"data (22): init {time.perf_counter() - t0:.2f} s (session "
          f"{session}, {store_gib} GiB store)", flush=True)
    n_batches = n_rows // B
    keep = (0, n_batches // 2, n_batches - 1)
    try:
        step, step_real_ms = stand_in_step(device, step_ms)
        runs = {}
        for run, dev, do_step in (("a", device, True), ("b", device, False),
                                  ("c", "cpu", False)):
            if run == "b" and device != "cuda":
                continue
            ds = token_pipeline(data, os.path.join(tmp, "tokens"), seed)
            batches = ds.iter_torch_batches(batch_size=B, device=dev,
                                            dtypes=torch.int64)
            rows, order, waits, kept, secs = consume(
                batches, dev, B, L, weights,
                step if do_step else (lambda: None), keep)
            runs[run] = (order, kept)
            got_rows = np.sort(rows)
            card_gb = len(order) * 2 * B * L * 8 / 1e9
            print(f"data (22{run}): {len(order)} batches on {dev} "
                  f"{'with a stand-in step of ' + format(step_real_ms, '.3f') + ' ms' if do_step and dev == 'cuda' else 'without a step'}"
                  f" in {secs:.2f} s: {len(rows) / secs:.0f} rows/s, "
                  f"{card_gb / secs:.3f} GB/s of int64 batches into the "
                  f"{'card' if dev == 'cuda' else 'host'}; wait per batch "
                  f"{_wait_ms(waits)} [{card}]", flush=True)
            print(f"data (22{run}): stages\n{ds.stats()}", flush=True)
            if len(order) != n_batches or len(rows) != n_batches * B:
                fail(f"phase 22 ({run}): {len(order)} batches, want "
                     f"{n_batches}")
            if len(got_rows) != len(want_rows) or \
                    not np.array_equal(got_rows, want_rows):
                fail(f"phase 22 ({run}): the rows read differ from the "
                     "files' (order-free digest)")
        same = {r: runs[r][0] == runs["a"][0] for r in runs}
        exact = {r: all(torch.equal(runs[r][1][i][k], runs["a"][1][i][k])
                        for i in keep for k in ("inputs", "targets"))
                 for r in runs}
        print(f"data (22): every row once in every run; the shuffled order "
              f"equals run (a)'s batch by batch (position-weighted hash of "
              f"every batch): {same}; batches {list(keep)} equal element "
              f"for element: {exact}", flush=True)
        if not all(same.values()) or not all(exact.values()):
            fail("phase 22: the order of the batches differs between the "
                 "card's and the CPU's runs")
        core = rt._get_worker().core
        import asyncio
        info = asyncio.run_coroutine_threadsafe(
            core.node_conn.call("get_node_info"), core.loop).result(60)
        st = info["store"]
        print(f"data (22): store: spilled {st['spilled']} objects "
              f"({st['spilled_bytes'] / 2 ** 30:.3f} GiB), restored "
              f"{st['restored']} ({st['restored_bytes'] / 2 ** 30:.3f} GiB) "
              f"and {st['restored_inline']} inline, dropped {st['dropped']} "
              f"restored copies, evicted {st['num_evictions']} "
              f"({(st['bytes_evicted'] or 0) / 2 ** 30:.3f} GiB)", flush=True)
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    left, shm = session_left(session)
    print(f"data (22): after shutdown, the session's processes {left}, "
          f"/dev/shm files {shm}; phase 22 "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    if left or shm:
        fail("phase 22 left processes or shared-memory files behind")


PHASE_WALL = {}


@contextlib.contextmanager
def phase(label):
    """Time one phase of main() on the host's clock and print it."""
    t0 = time.perf_counter()
    yield
    PHASE_WALL[label] = round(time.perf_counter() - t0, 1)
    print(f"phase {label}: {PHASE_WALL[label]} s of wall time", flush=True)


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA "
             "card")
    from ray_tpu_torch import inference, models, parallel, train
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as ops

    # the preemption-notice check never asks a cloud metadata server here
    os.environ["RAY_TPU_TORCH_DISABLE_GCE_METADATA"] = "1"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    try:
        import ml_dtypes
        bf16_spans = f"ml_dtypes {ml_dtypes.__version__}: 2-byte bf16 spans"
    except ImportError:
        bf16_spans = "ml_dtypes not installed: bf16 spans go out as fp32"
    print(f"kv spans: {bf16_spans}", flush=True)

    with phase("1"):
        t0 = time.perf_counter()
        built = _build.build(*KERNELS)
        print(f"kernel build ({len(KERNELS)} sources in parallel): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for name, (_, log) in built.items():
            for line in log.splitlines():
                if any(w in line for w in ("entry function", "registers",
                                           "spill")):
                    print(f"ptxas {name}: {line.strip()}", flush=True)
        tensor_cores = sass_check(built)

    with phase("2"):
        records = {"flash_fwd": check_flash_kernel(ops, tensor_cores)}
        for record in check_bwd_kernels(ops, tensor_cores):
            records[record["name"]] = record
    with phase("3"):
        model, gen_launches = run_generator(models, ops)
    with phase("4"):
        eng_launches = run_engine(model, models, inference, ops, card)
    del model
    release("cuda")
    with phase("5"):
        run_train_parity(models, parallel, ops)
    with phase("6"):
        train_counts = run_train(models, parallel, ops, card)
    release("cuda")
    with phase("7"):
        run_recipe_parity(models, parallel)
        recipe_counts, recipe_step_s, recipe_steps = run_recipe(
            models, parallel, ops, card)
    release("cuda")
    with phase("8"):
        feature_counts = run_engine_features(models, inference, ops, card,
                                             n_layers=SERVE_LAYERS)
    with phase("9"):
        moe_serve_launches = run_moe_serving(models, inference, ops, card)
    with phase("10"):
        run_recipe_parity(models, parallel, name="mixtral-8x7b")
        moe_train_counts, _, _ = run_recipe(models, parallel, ops, card,
                                            name="mixtral-8x7b", n_layers=4)
    release("cuda")
    with phase("11"):
        run_moe_holds(models, parallel, inference, ops, card)
    with phase("12"):
        mesh_counts = [
            run_mesh_train(models, parallel, ops, card),
            run_mesh_serve(models, parallel, ops, card),
            run_mesh_train(models, parallel, ops, card,
                           name="mixtral-8x7b", n_layers=4, steps=2,
                           together=False, fsdp=1, expert=-1)]
    with phase("13"):
        pipeline_counts, in_process = run_pipeline(
            models, parallel, train, ops, card, recipe_step_s,
            n_layers=PIPELINE_LAYERS)
    release("cuda")
    with phase("14"):
        runtime_counts = run_runtime(models, parallel, train, ops, card,
                                     in_process)
    release("cuda")
    with phase("16"):
        serve_counts = run_serve(models, inference, ops, card)
    release("cuda")
    with phase("17"):
        executor_counts = run_train_executor(models, parallel, train, card,
                                             recipe_steps)
    release("cuda")
    with phase("18"):
        sharded_counts = run_sharded_serve(models, inference, ops, card)
    release("cuda")
    with phase("19"):
        rl_counts = run_rl(ops, card)
    release("cuda")
    with phase("20"):
        dag_counts, client_counts, tune_counts = run_dag_client_tune(
            models, ops, card)
    release("cuda")
    with phase("21"):
        cluster_counts = run_cluster_services(models, inference, ops, card,
                                              recipe_steps)
    release("cuda")
    with phase("22"):
        run_data_ingest(card)
    for name in KERNELS:
        records[name]["launches"] = (train_counts[name] + recipe_counts[name]
                                     + feature_counts.get(name, 0)
                                     + moe_train_counts[name]
                                     + sum(c[name] for c in mesh_counts)
                                     + pipeline_counts[name]
                                     + runtime_counts[name]
                                     + executor_counts[name]
                                     + dag_counts[name]
                                     + client_counts[name]
                                     + tune_counts[name]
                                     + cluster_counts[name])
        records[name]["mesh_launches"] = sum(c[name] for c in mesh_counts)
        records[name]["pipeline_launches"] = pipeline_counts[name]
        records[name]["actor_launches"] = runtime_counts[name]
        records[name]["serve_launches"] = serve_counts[name]
        records[name]["train_worker_launches"] = executor_counts[name]
        records[name]["sharded_serve_launches"] = sharded_counts[name]
        records[name]["rl_launches"] = rl_counts[name]
        records[name]["dag_launches"] = dag_counts[name]
        records[name]["client_launches"] = client_counts[name]
        records[name]["tune_launches"] = tune_counts[name]
        records[name]["cluster_launches"] = cluster_counts[name]
    records["flash_fwd"]["launches"] += (gen_launches + eng_launches
                                         + moe_serve_launches)
    for name in KERNELS:
        if records[name]["launches"] == 0:
            fail(f"the main path never launched {name}")

    print(f"phase wall times (s): {PHASE_WALL}; the smoke's total "
          f"{time.perf_counter() - t_start:.1f} s since main() began",
          flush=True)
    print(json.dumps({"kernels": [records[name] for name in KERNELS]}),
          flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)

if __name__ == "__main__":
    main()
