#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``ray_tpu_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, one NVIDIA H100

(``--workflow-driver run|resume STORAGE`` runs one of phase 33's drivers.)

Builds the port's CUDA kernels from the sources in the checkout, holds each
against its plain PyTorch version at its path's shapes, times it, and drives
the port's main paths through the entry points a user calls: the paged-KV
serving engine at the full GPT-J-6B width (28 layers, bf16, random weights
from a seed), plain and speculating; GPT training at bench.py's 406M shape
(24 layers, bf16, random weights from a seed); and the serving engine at
GPT-124M (the reference's default GPTConfig, 12 layers, bf16 over fp32
master weights), plain, speculating and across a weight hot-swap, in
process and then from a GPU actor of the port's runtime; and GPT-J-6B
served by Serve from a ``num_gpus=1`` replica over the handle and HTTP,
with a mid-stream failover on GPT-124M; and the 406M training shape through
``TorchTrainer`` on a ``num_gpus=1`` worker of the runtime, restarted from
its checkpoint after the worker dies, and fed from a ``ray_tpu_torch.data``
Dataset through ``iter_torch_batches``, beside a global shuffle of a 1.07 GB
token corpus to the card; GPT-124M trained under each remat policy and as
a mixture of experts, and tuned by ``Tuner`` over trial actors sharing the
card (ASHA, PBT) and over a ``TorchTrainer``; GPT-124M trained by async
RLHF (rollout engines in GPU-share actors, the learner in this process,
each version pushed over the object plane), and PPO on CartPole; and DQN,
SAC, TD3, DDPG, BC, CQL, IMPALA, APPO, ES, Dreamer and multi-agent PPO at
their defaults on the reference's envs; and the operator's tools (a job,
the device-step profiler, the ``obs`` CLI, the dashboard, an OTLP export
and an ``ActorPool``) over a GPT-124M serving job; and ``python -m
ray_tpu_torch`` (``start``, ``up``, ``down``, ``status`` and the state
commands) with a GPT-124M actor on the CLI's head and on a GPU node that
the autoscaler buys on demand; and a durable GPT-124M workflow whose driver
is killed after its decode step and which a fresh driver resumes; and the
406M shape trained on a device mesh (``ray_tpu_torch.parallel``) over an
NCCL group of one card, through the one-process step and a
``TorchTrainer`` worker, with a sharded checkpoint; and GPT-J-6B through
the tensor-parallel engine's runner at tp 1 on an NCCL group of one.
Phases, each of which raises on failure:

1. device: name, compute capability, power limit;
2. build: the three kernel sources, in parallel, and their ``-Xptxas -v`` register /
   shared-memory reports;
3. K1 (paged decode attention) vs its plain version, fp32 and bf16, head
   dims 64 (GPT's 12 heads), 128 and 256, at lengths on the block and split
   edges, and its live split partials vs ``decode_partials_torch``;
4. K1 timing beside the plain version, the library call and the bound,
   with its split size and CTA count, at GPT-J-6B's and GPT-124M's decode
   shapes;
5. fp32 identity: a full-width, 2-layer GPT-J engine is token-identical to
   the dense ``gptj_decode``;
6. GPT-J-6B serve: ``run_loop`` in a thread, requests from several threads
   through ``stream_tokens``, prefix-cache hits, a copy-on-write fork,
   greedy and seeded-sampled requests; checks the pool audit, the kernel's
   launch count and every greedy token against the dense forward;
7. decode profile: device busy time of a steady 8-slot decode step by
   kernel (``PROFILE_STEPS`` steps), against its wall time without the
   profiler, and the host time of the step's Gumbel noise;
8. K2 (paged verify attention) vs its plain version, fp32 and bf16, head
   dims 64, 128 and 256, windows 1-9, 16, 17 and 33 (an inactive slot, a
   window straddling a block edge, one straddling a split edge, one past
   the table), window index by window index vs K1, and its live split
   partials vs ``verify_partials_torch``;
9. K2 timing beside the plain version, the library call (in turns), the
   bound and K1, at GPT-J-6B's verify shape and at GPT-124M's (12 heads of
   64), and across windows 1-16 and 32 (in turns);
10. fp32 spec identity: a full-width, 2-layer speculating GPT-J engine is
    token-identical to dense ``gptj_decode`` — with a test-double drafter
    that makes full, partial and zero acceptance happen (spec_k 4 and 9),
    and with the n-gram drafter;
11. GPT-J-6B spec serve: the phase-6 weights behind a speculating engine
    (spec_k=4, n-gram drafter) serving client threads; checks the audits,
    both kernels' launch counts against the verify and plain decode steps,
    and every greedy token against the dense forward;
12. verify profile: device busy time of a steady 8-slot verify step by
    kernel, against its wall time without the profiler, and the host time
    of the step's Gumbel noise;
13. library times (SDPA forward, forward+backward) and bounds for the
    training slice's flash-attention kernels K3-K5;
14. K3-K5 (flash forward, dQ, dK/dV) vs their plain versions, fp32 and
    bf16, head dims 64 and 128, seq 1024, a ragged 1000 and 1001 (lse and
    delta rows then start off 16-byte boundaries); an operand off a
    16-byte boundary is refused;
15. K3-K5 at the training shape: vs their plain versions there (the
    kernels line's errors), their timing beside the plain versions, the
    library calls and the bounds, their achieved TFLOP/s and ratio to the
    library call, K4 + K5 against SDPA's backward, and their ``-Xptxas -v``
    reports;
16. fp32 training identity: a narrow GPT takes 3 AdamW steps through K3-K5
    and 3 through the einsum attention, under remat "full" and "attn";
    losses and parameters agree;
17. 406M training: bench.py's training shape (24 layers, d 1024, vocab
    50304, batch 26, bf16, remat "attn") through ``build_train_step``:
    step 0's qkv weight gradients and loss against the einsum path; step
    time, tokens/s, MFU, losses, peak memory, K3-K5 launches against the
    expected per-step counts, remat "attn" against "attn_qkv" in turns,
    and a profile of two steps;
18. GPT fp32 identity: a full-width (d 768, 12 heads of 64, vocab 50304),
    2-layer fp32 GPT engine is token-identical to the dense ``gpt_decode``,
    plain and speculating at spec_k 4 (test-double and n-gram drafters);
19. GPT-124M serve: phase 6's traffic, then phase 11's on a speculating
    engine, at full depth in bf16; checks the audits, K1 at 12 launches a
    decode step, K2 at 12 a verify step, and every greedy token against the
    dense forward;
20. GPT-124M decode and verify profile: phases 7 and 12 on those engines;
21. GPT-124M hot swap: ``update_weights`` to a second seed's weights while
    requests are in flight; checks that parameter storage stays in place,
    the version is stamped, the prefix tree is flushed, and every greedy
    token submitted after the swap against the dense forward under the new
    weights; times the swap;
22. GPT-124M production engine: phase 19's engines with the production
    half on. (a) phase 19's traffic, plain and at spec_k=4: the metric
    counters against the tokens streamed and the engines' own counts, the
    inter-token latency histogram against the tokens, each request's
    flight-recorder events in order and its phases summing to finish -
    submit; (b) the HBM ledger against ``torch.cuda.memory_allocated`` and
    the pool tensors; (c) the watchdog under a real device wedge (a ~4 s
    spin in front of one decode step): the stall event and counter, the
    step-age gauge, a deadline request's stream ended and
    ``EngineStalledError`` raised while the device still spins, then a
    clean recovery; (d) deadline shedding at the card's measured service
    rate; (e) the hooks' cost per decode and verify step, on and off in
    turns; K1 and K2 at 12 launches a step throughout;
23. the runtime on the card, through ``ray_tpu_torch.init/remote/get/put``:
    (a) ``init()`` with no arguments offers ``GPU: 1`` (= the device count =
    ``nvidia-smi -L``) and the card's accelerator-type resource, the native
    arena is loaded, /dev/shm can hold (e)'s push; (b) K1 at GPT-124M's
    decode shape against its plain version in a ``num_gpus=1`` task, in a
    worker forked from a template that never mapped CUDA or torch; two such
    tasks do not overlap; (c) a 256 MB fp32 and a 256 MB bf16 CPU tensor
    from the driver to a GPU task and back, and a CUDA tensor returned by a
    GPU task, bit for bit, same-node gets as views of the store, put/get
    GB/s; (d) the GPT-124M engine in a ``num_gpus=1`` actor (built in
    ``__init__``, ``run_loop`` in a thread, as the reference's RLHF rollout
    worker) serving phase 19's traffic plain and at spec_k=4: greedy tokens
    against the dense forward, audits and K1/K2 at 12 launches a step read
    from the actor, tokens/s and TTFT beside phase 19's, the runtime's added
    ms per request; (e) a push of seed 1's 652 MB of fp32 weights through
    the object plane (zero-copy get in the actor, host-to-device copy,
    ``update_weights``), timed, and greedy tokens after it against the
    dense forward under seed 1; (f) ``shutdown()`` leaves no runtime process,
    no /dev/shm segment of the store and no extra compute app on the card;
24. Serve over the engine (``ray_tpu_torch.serve``): (a) ``init()`` with no
    arguments and ``serve.run(build_llm_app(model="gptj", ...), http=True)``
    with phase 6's engine config and seed 0: one ``num_gpus=1`` replica
    (``CountingLLMDeployment``, the package's ``LLMDeployment`` with a
    method that reads the kernels' counts inside the replica), timed from
    ``serve.run`` to ready; the controller's and the proxy's processes map
    no torch or CUDA library; (b) phase 6's traffic through
    ``handle.options(stream=True)`` from driver threads: greedy tokens
    against the dense forward, K1 at 28 launches a decode step and both
    audits read from the replica, tokens/s and TTFT beside phase 6's, and
    Serve's added ms per request (the client's time minus the engine's
    submit-to-finish from its phase ledger); (c) the greedy prompts over
    loopback HTTP (chunked streams, the ``x-request-id`` echo, (b)'s
    tokens), then a ``deadline_s`` the backlog cannot meet answered 429
    with ``Retry-After``; (d) one ``loadgen.run_curve`` arm: 3 Poisson
    arrivals at half (b)'s request rate, client TTFT and e2e percentiles,
    the share of requests attributed and of phase sums within 5% of e2e;
    (e) ``serve.delete`` returns the GPU resource and the replica's memory;
    (f) GPT-124M (full width and depth, fp32, spec_k=4, ``warmup=False``)
    in one replica: a greedy 128-token stream cut after 64 tokens by SIGKILL
    of the replica resumes on the replacement (placed once the dead
    worker's GPU is released) and equals an uninterrupted stream and the
    dense forward; kill -> replacement ready -> first resumed token timed;
    K1 and K2 at 12 launches a step in the new replica; (g)
    ``serve.shutdown()`` and ``shutdown()`` leave no runtime process and no
    store segment;
25. Train over the runtime (``ray_tpu_torch.train``): ``init()`` with the card
    as one ``GPU``, then ``TorchTrainer(ScalingConfig(num_workers=1,
    use_gpu=True), FailureConfig(max_failures=1))`` trains phase 17's model
    (``TRAIN_406M``, batch 26, weights from a CUDA generator seeded 0 built
    in the worker, phase 17's tokens through ``get_dataset_shard("train")``)
    for its 6 steps through K3-K5, saving its train state after step 2
    (``save_state``, ``CheckpointConfig(num_to_keep=1)``): (a) the first
    worker's losses of steps 0-3 equal phase 17's bit for bit, its K3/K4/K5
    launches as expected; the median step against phase 17's, fit() to the
    first report, peak memory, the checkpoint's bytes, save and commit
    times; it ends by ``os._exit(1)`` right after reporting step 3; (b) the
    group restarts from step 2's checkpoint and steps 3-5 equal phase 17's
    bit for bit; death to the first resumed report split into the worker's
    start, the model's build, the checkpoint's load and the first step (an
    uninterrupted 12-step run came first until phase 32 came); (c) after
    ``fit()`` the ``GPU`` resource and the card's memory are free again;
    (d) two CPU actors allreduce 64 MB fp32 torch tensors by fan-in and by
    the ring (``ray_tpu_torch.collective``), equal to numpy's sums;
26. Data into Train (``ray_tpu_torch.data``): (a) phase 25's run fed
    from ``data.read_numpy`` over 13 ``.npy`` files of 12 rows (phase 17's
    batch 6 times over, so batches straddle files) through
    ``TorchTrainer(datasets=...)``, ``get_dataset_shard`` and
    ``iter_torch_batches(batch_size=26, drop_last=True)``, whose batches
    land on the card with no copy of the loop's own: 6 batches, losses equal
    phase 25's bit for bit, K3/K4/K5 at 144 launches each, the card
    released after ``fit()``; the median step against phase 17's, the
    trainer between two steps against phase 25's, ``fit()`` to the first
    report; (b) 64 ``.npy`` files of 4096 rows x 1025 int32 tokens (numpy
    seed 0, 1.07 GB) through ``read_numpy`` -> ``random_shuffle(seed=0)``
    -> ``iter_torch_batches(batch_size=256, dtypes=int64)`` to the card in
    the driver, and the same without the shuffle: every row arrives once
    (the row count and a multiset hash computed on the card, equal to
    numpy's over the files), the shuffled first batch differs from the
    corpus's first 256 rows; rows/s and GB/s from the first read to the
    last batch on the card, the shuffle's share of that time, the object
    store's capacity and peak use;
27. GPT remat policies and MoE, at GPT-124M's full width (d 768, 12 layers,
    12 heads of 64, vocab 50304, bf16, fused CE, batch 8 x 1024, weights
    from a CUDA generator seeded 0): (a) one ``build_train_step`` step under
    each of the remat policies "full", "dots", "attn", "attn_qkv" and
    "big" from one set of weights: losses equal bit for bit, gradients
    within ``GRAD_POLICY_GAP`` of "full"'s, K3/K4/K5 at 24/12/12 launches a
    step under "full" and "dots" and 12/12/12 under the others; then 5
    steps each, the policies in turns: median step and peak memory; (b)
    with 8 experts in every block (top-2, capacity 1.25, aux 0.01, remat
    "full"): the aux loss at init within (0.5, 6.0), step 0's loss and
    aux against the port's fp32 plain path on the card (einsum attention,
    the reference's einsum dispatch), the fp32 index dispatch against the
    einsum one, 5 AdamW steps with finite, falling losses; dropped
    assignments per layer, K3/K4/K5 launches, step ms, tokens/s, peak
    memory;
28. Tune over Train (``ray_tpu_torch.tune``), ``init()`` with the card as
    one ``GPU`` and ``preload_python_modules`` ``TUNE_PRELOAD`` (every
    trial and trainer worker forks from a template that imported them
    once), dense GPT-124M (remat "attn", batch 8) as the trainable:
    (a) ``Tuner`` with ``ASHAScheduler(max_t=3, grace_period=2,
    reduction_factor=2)``, 4 trials of lr from ``loguniform(1e-5, 1e-3)``
    (seed 28) at ``with_resources({"CPU": 1, "GPU": 0.5})``, two at a time
    on the card: every trial ``TERMINATED``, ASHA stops one before max_t,
    the best trial's losses equal a ``build_train_step`` run in this process bit
    for bit, the trials' K3/K4/K5 launches add up to 12 a step each; (b)
    ``PopulationBasedTraining(synch=True)`` over 2 trials, interval 2, 3
    iterations, the report at step 2 carrying a checkpoint of the
    train state (``TUNE_STEPS`` and ``PBT_INTERVAL``, cut from 6 steps and a
    checkpoint with every report when phase 30 came, and from 4 steps when
    phase 31 came): at step 2 the trial
    behind waits for the other, so the worse one exploits whichever reports
    first; an exploit happens, the exploiting trial's restored parameters hash equal to the
    donor's checkpoint, its lr is the donor's times 0.8 or 1.2; (c)
    ``Tuner(TorchTrainer(..., ScalingConfig(num_workers=1, use_gpu=True)))``
    over two lrs, 2 steps each (``as_trainable``): the best result has the
    lower loss, the inner worker holds the card (the cluster's GPU is all
    taken while it trains), its launches reported.
29. RL and RLHF on the card (``ray_tpu_torch.rlhf``, ``ray_tpu_torch.rl``),
    GPT-124M, traffic from numpy seed 29: 32 prompts of 64-128 ids over the
    whole vocabulary, 128 new tokens each at temperature 1.0, top_k 0,
    top_p 1.0. (a) one in-process ``RolloutWorker`` (phase 19's engine
    config, weights from a CUDA generator seeded 0) generates the 32
    trajectories at version 0 through K1, a learner in this process holds
    the same weights (checked equal), and the batch is built as
    ``rlhf.Algorithm`` builds it (T 256, O 128): |learner logprob -
    behavior logprob| over the unmasked tokens within ``LOGP_GAP_MAX``
    and ``LOGP_GAP_MEAN``, the same read one position late (prompt_len +
    j) beyond the mean bound; then one update: step ms, peak memory,
    ``mean_ratio`` within ``RATIO_GAP`` of 1, K3/K4/K5 at 24/12/12; (b)
    ``rlhf.Algorithm`` with two rollout workers in actors at ``GPU`` 0.25
    and the learner in this process, 2 iterations (``RLHF_ITERS``, cut from
    8 when phase 30 came, from 4 when phase 31 came and from 3 when phase 33
    came; train_batch 32,
    rollout_inflight 16, max_staleness 4, reward the share of generated
    ids below 1024): per iteration the learner step, the publish time and
    bytes, consumed versions and staleness, rollout tokens/s and reward,
    each worker's applies; every worker's version advances, every consumed
    trajectory within max_staleness, a rollout finishes between two
    learner steps, losses finite, K1 at 12 launches a decode step in each
    worker (read through the actor), the learner's K3/K4/K5 at 24/12/12 an
    update; (c) ``PPOConfig`` on CartPole with the learner and env runner
    on the card, 3 iterations, then one ``Learner.update`` on the card
    against the same update on the CPU from the same weights and
    minibatch within ``PPO_TOL``;
30. the rest of RL on the card (``ray_tpu_torch.rl``), every algorithm at
    its config's defaults (hidden 64 x 64) on the reference's envs, only
    the iterations cut, seed 30: (a) DQN on CartPole with prioritized
    replay, 3 iterations (past ``learning_starts`` and a target sync);
    (b) SAC, (c) TD3 and DDPG on Pendulum, 4 iterations each (the last
    makes 200 updates, each followed by the Polyak average); (d) BC on
    4000 scripted-expert CartPole transitions and CQL on 4000 random
    Pendulum transitions, each recorded here and read back from ``.npz``;
    (e) IMPALA and APPO with two env-runner actors at ``ENV_RUNNER_GPUS``
    of the card, the learner in this process, 2 iterations; (f) ES over
    two env-runner actors, 2 iterations (the three built side by side, so
    their six runner actors come up together); (g) Dreamer on MinAtar Breakout
    (latent 128, batch 128, horizon 8), 3 iterations, and an update's time;
    (h) shared-policy PPO on ``EchoCoopEnv`` (4 envs x 2 agents), 2
    iterations. Each part checks its metrics finite and its mechanism
    (per-sample priorities and the synced target, Polyak targets lagging,
    BC's falling NLL, the async steps consumed, ES's update), prints its
    iteration seconds, a learner update's median ms and env steps/s, and
    for every learner (DQN, SAC, TD3, DDPG, BC, CQL, IMPALA, APPO, Dreamer)
    holds one update on the card against the same update on the CPU from
    the same weights, batch and draws (its Polyak or target sync after it)
    within ``RL_TOL`` relative to max(1, |cpu|).

31. operator tooling over a GPT-124M job, ``GPTConfig()`` in bf16 with
    weights from a CUDA generator seeded 31 and phase 19's engine config:
    ``init()`` with the card, a TCP listener and ``dashboard.start()`` on
    127.0.0.1. (a) ``job.submit_job`` runs a script written to a temporary
    directory, which attaches through ``RAY_TPU_ADDRESS``, builds the
    engine in a ``num_gpus=1`` actor, calls ``warmup()`` and generates 16
    greedy requests (prompts of 64-256 ids from numpy seed 31, 64 new
    tokens each), and prints tokens/s and the engine's ``stats()``:
    ``wait_job`` returns ``SUCCEEDED``, ``get_job_logs`` holds the line,
    every token against the dense forward, K1 at 12 launches a decode
    step; (b) the device-step profiler on the card: ``stats()["retraces"]``
    is 0, and the cluster's ``device_step_seconds{site=decode|prefill}``
    counts grew by the runner's decode and prefill calls; each site's p50
    and p99; (c) ``python -m ray_tpu_torch.obs`` against the live cluster,
    each command a subprocess: ``top --once``, ``series
    llm_generated_tokens``, ``waterfall --probe 200``, ``alerts
    --eval-once``, ``objects``, ``arena`` and ``export -o ... --post``
    (``RAY_TPU_OTLP_ENDPOINT`` a stub collector on 127.0.0.1) exit 0; the
    export holds the ``device_step_seconds`` histogram with a site=decode
    point at the cluster's count, and the stub received the POSTs; (d) the
    dashboard: ``/api/cluster_resources`` shows ``GPU`` 1.0, ``/api/jobs``
    lists (a)'s job ``SUCCEEDED``, ``/metrics`` carries
    ``core_resource_total{resource="GPU"}``, and ``/api/grafana`` has a
    panel for every metric name the cluster collected; (e) an
    ``ActorPool`` of two actors at ``num_gpus=0.5`` holding GPT-124M's
    training-path forward (K3) scores 8 batches of 4 x 1024 ids
    (``pool.map``): each batch's summed logprob equals an in-process
    forward's within ``TOL[bf16]`` relative to max(1, |ref|), and a closure
    over a CUDA tensor inspects as serializable (``check_serialize``);
32. the CLI and the autoscaler on the card: every process is a ``python -m
    ray_tpu_torch`` started here, the driver attached by address, and the
    ``num_gpus=1`` actor holds GPT-124M (bf16, seed 32, phase 19's engine
    config), warmed up, for 8 greedy requests (prompts of 64-256 ids from
    numpy seed 32, 32 new tokens), whose tokens equal the same engine's in
    this process (else within the bf16 top-2 margin of the dense forward)
    with K1 at 12 launches a decode step. (a) ``start --head``: ``status``
    shows ``GPU`` = ``detect_num_gpus()`` and the card's accelerator-type
    key; ``start --address --labels`` joins a second node; the actor runs
    on the head's node; ``summary``, ``list actors``, ``list nodes``,
    ``node-stats``, ``stacks``, ``timeline``, ``grafana`` and ``job
    submit`` side by side, then ``job status`` (``SUCCEEDED``) and ``job
    logs``, all exit 0; SIGTERM: the head exits 0 within 10 s and the node
    agent exits after its reconnect grace. (b) ``up`` over a ``.json``
    config (the fake provider, a CPU head, ``gpu_worker`` at ``GPU`` 1,
    ``max_workers`` 1, idle timeout 5 s, ticks of 0.5 s): no ``GPU`` before
    demand; the actor's request makes the autoscaler buy exactly one GPU
    node, where the actor runs, its tokens equal to (a)'s; after the kill
    the node is terminated within the idle timeout plus two ticks (and 0.5
    s) and ``GPU`` is gone; SIGTERM: ``up`` prints its instance counts
    (``TERMINATED`` 1) and exits 0; ``down`` terminates 0 instances. The
    cluster's ``GPU`` total, polled throughout, never exceeds the card
    count;
33. a durable GPT-124M workflow (``ray_tpu_torch.workflow``): prompts (a
    CPU step, 8 of 64-256 ids from numpy seed 33) -> ``generate`` (a
    ``num_gpus=1`` step: GPT-124M in bf16 from seed 33 in phase 19's
    engine, 32 greedy tokens a prompt, K1) -> ``score`` (a ``num_gpus=1``
    step with ``wait_for_event("go")``: each continuation's summed logprob
    under teacher forcing, K3) -> ``summarize``, which returns a
    continuation of one CPU step. (a) driver 1, this script run as
    ``--workflow-driver run`` in its own session with its own cluster,
    calls ``workflow.run``; once ``generate``'s commit is in the event log
    it is SIGKILLed: within 20 s no process of its session is left, the
    card's compute apps and free memory are back to this process's alone,
    and the status reads ``RUNNING``; (b) after ``send_event("go")``,
    driver 2, a fresh process with a fresh cluster, calls ``resume``: no
    ``generate`` starts after the kill, K1 launches 0 times and K3 12 times
    a forward in ``score``, the status is ``SUCCESSFUL`` and ``get_output``
    equals what ``resume`` returned, a second ``resume`` returns it and
    starts no step, and the virtual actor ``RunLedger`` (one write, one
    ``@readonly`` read) holds exactly one finished run; kill -> resume is
    split into driver start, the worker's start with torch, the CUDA
    context, the build and the step; (c) the same weights and prompts
    through the engine and the forward in this process: the workflow's
    tokens equal bit for bit, its scores within ``TOL[bf16]`` relative to
    max(1, |ref|);
34. GPT-406M on a device mesh (``ray_tpu_torch.parallel``): (e) first,
    ``fit_report(TRAIN_406M, n_devices=8, batch=8)`` on the card, rank 0 of
    an fsdp-8 step under a fake process group: ``argument_bytes`` equals
    the rule table's local shards (parameters and two Adam moments),
    ``per_chip_bytes`` (``max_memory_allocated`` over the step) lies above
    it and below the card's memory, and no group is left; then an NCCL
    mesh of one card (``make_mesh(MeshConfig())``): (a) phase 17's model
    and batch through ``build_train_step(..., mesh)`` and the one-device
    step, a step of each in turns, 4 each: every parameter and Adam moment
    a ``DTensor`` on the mesh, both runs' losses equal to phase 17's bit
    for bit, step time, tokens/s, MFU and peak memory of each; (b) K3/K4/K5
    24 each a mesh step and the plain attention never called; (c)
    ``mesh_allreduce`` of integer-valued fp32 on the card equal to
    ``sum/prod/amin/amax(0)`` exactly, for each ``ReduceOp``; (d) a
    ``TorchTrainer`` GPU worker under ``TorchConfig(init_distributed=True)``
    trains the 406M width at 4 layers on its own NCCL mesh for 2 steps and
    reports ``save_pytree_checkpoint`` of the sharded state; a second
    ``fit`` restores it into a fresh sharded state and takes one step, its
    loss equal bit for bit to this process's third step of the same run;
35. the tensor-parallel engine's runner at tp 1 (``llm.multichip``):
    GPT-J-6B on phase 6's weights (adopted, no second copy) through
    ``TensorParallelPagedModelRunner`` and ``ShardedKVBlockPool`` on a
    private ``ProcessGroupNCCL`` of one rank (no follower), beside the plain
    engine on the same weights: 8 requests (prompts of 192-480 ids from
    numpy seed 35, 32 new tokens; 4 greedy, 4 seeded with seed 42), plain
    and at ``spec_k=4``; the tp runner's tokens and logprobs equal the plain
    engine's bit for bit (the same arithmetic in the same order), its
    ``hbm_ledger()["per_device"]`` holds one card with the plain ledger's
    totals, the pool's audit passes, and K1 launches 28 times a decode
    step and K2 28 times a verify step; decode and verify step times of
    both, in turns.

The last line is ``{"ok": true, "device": {...}}``; the line before it has
the card's name and power limit, the one before that the kernels' record.
Exits non-zero, printing no result, when there is no CUDA device.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import os
import pickle
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path
from types import SimpleNamespace

# phase 24 drives the HTTP ingress, whose proxy is built on h11: the card's
# machine has it (and grpc), so the ingress is held there every run
import h11  # noqa: F401
import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import ray_tpu_torch
from ray_tpu_torch import _native, dashboard, job, serve, workflow
from ray_tpu_torch._private import chaos, events, shm_store
from ray_tpu_torch._private.shm_store import shm_mapping_of
from ray_tpu_torch.exceptions import OverloadedError
from ray_tpu_torch.llm import EngineConfig, EngineStalledError, LLMEngine, SamplingParams
from ray_tpu_torch.llm import engine as engine_mod
from ray_tpu_torch.llm import loadgen
from ray_tpu_torch.llm import prefix_cache as prefix_mod
from ray_tpu_torch.llm import watchdog as watchdog_mod
from ray_tpu_torch.llm.model_runner import _row_noise, _window_noise
from ray_tpu_torch.llm.scheduler import RUNNING
from ray_tpu_torch.models.gpt import GPT, GPTConfig, gpt_decode, gpt_forward, gpt_init, gpt_loss
from ray_tpu_torch.models.gptj import GPTJ_6B, GPTJConfig, gptj_decode, gptj_forward, gptj_init
from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.ops.flash_attention import (
    KERNEL_HEAD_DIMS,
    flash_attention,
    flash_bwd_dkv_cuda,
    flash_bwd_dq_cuda,
    flash_bwd_reference,
    flash_fwd_cuda,
    flash_fwd_reference,
    kernel_smem_bytes,
)
from ray_tpu_torch.ops.fused_ce import fused_softmax_cross_entropy
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.ops.paged_attention import (
    DECODE_HEAD_DIMS,
    VERIFY_HEAD_DIMS,
    decode_splits,
    paged_attention,
    paged_attention_cuda,
    paged_verify_attention,
    paged_verify_attention_cuda,
    verify_partials_torch,
)
from ray_tpu_torch.ops import attention as attention_mod
from ray_tpu_torch.ops import flash_attention as flash_mod
from ray_tpu_torch.parallel import MeshConfig, adamw, build_train_step, make_mesh
from ray_tpu_torch.parallel.sharding import param_mesh
from ray_tpu_torch.rl import PPOConfig, SampleBatch
from ray_tpu_torch.rl.algorithm import ENV_RUNNER_GPUS
from ray_tpu_torch.rl.algorithms.ppo import ppo_loss
from ray_tpu_torch.rl.algorithms.sac import polyak_update
from ray_tpu_torch.rl.learner import Learner, host_weights
from ray_tpu_torch.rl.rl_module import ActorCriticModule, RLModuleSpec
from ray_tpu_torch.rlhf import Algorithm as RLHFAlgorithm
from ray_tpu_torch.rlhf import RLHFConfig, RolloutWorker, group_advantages
from ray_tpu_torch.rlhf import rollout as rollout_mod
from ray_tpu_torch.rlhf.algorithm import build_batch
from ray_tpu_torch.rlhf.learner import make_learner_group, policy_logprobs
from ray_tpu_torch.serve.llm import LLMDeployment, build_llm_app
from ray_tpu_torch.util import metrics, phases, tracing
from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.check_serialize import inspect_serializability

# H100 SXM data-sheet peaks (dense): HBM bytes/s and operations/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# the kernels' sources, ray_tpu_torch/ops/csrc/<name>.cu
KERNELS = ("paged_attention", "paged_verify_attention", "flash_attention")

# slice shapes: GPT-J-6B decode at 8 slots, block 16, 128-entry tables; the
# verify window of spec_k = 4
S, H, D, BS, T = 8, 16, 256, 16, 128
W = 5
NB = S * T + 1  # the serve phase's pool: 1025 blocks, block 0 the trash block
# phase 6's engine over that pool, served again by a replica in phase 24
GPTJ_ENGINE = EngineConfig(max_slots=S, block_size=BS, max_blocks_per_seq=T, num_blocks=NB, prefill_chunk=256)
# phase 8's windows: every width up to 9 (past the first design's widest, 8), one and
# two 16-row query tiles and one past them (a second walk of the pages);
# phase 9's sweep
K2_WINDOWS = (*range(1, 10), 16, 17, 33)
K2_SWEEP = (*range(1, 17), 32)

# the training slice: bench.py's 406M shape at batch 26 (attention operands
# (26 x 16, 1024, 64))
TRAIN_406M = GPTConfig(vocab_size=50_304, seq_len=1024, d_model=1024, n_layers=24, n_heads=16,
                       remat_policy="attn", ce_chunks=1)
TRAIN_B, TRAIN_H, TRAIN_S, TRAIN_D = 26, 16, 1024, 64

# the GPT serving slice: the reference's default GPTConfig, what its
# serve/llm.py serves for model="gpt" and every RLHF rollout engine runs
# (vocab 50304, seq 1024, d 768, 12 layers, 12 heads of 64; bf16 over fp32
# master weights)
GPT_124M = GPTConfig()

# K1 vs plain: the fp32 pair differs only in summation order (the
# reference's Pallas-vs-XLA tolerance); in bf16 both round one fp32 result
# to bf16, and a different summation order can move it by one bf16 step
# (2^-8 relative) at magnitudes up to ~1
TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}

# greedy check of the bf16 serve: an engine token must be the dense
# forward's argmax unless the dense forward's top-2 logits lie within this
# margin of each other (bf16 rounding at other places in the two paths
# moves logits by a few hundredths after 28 layers)
BF16_TOP2_MARGIN = 0.1

# phase 17: the largest relative gap allowed between step 0's qkv weight
# gradients through K3-K5 and through the einsum attention, at the 406M
# shape in bf16 (set between the measured gap and the gaps of kernels with
# their causal mask removed; PERF.md)
QKV_GRAD_GAP = 0.15


T_START = time.perf_counter()  # each phase's header shows the seconds since the script started


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - T_START:.1f} s)", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls. A spin
    kernel holds the device while the host queues the timed calls, so the
    events time the device's work even where the host takes longer to
    issue a call than the device to run it (a fast kernel behind a Python
    wrapper, on a slow host)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0  # one call's issue time (or more, if it syncs)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * iters * host_s + 0.01) * 2e9))  # cycles at up to 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns: dict, iters: int) -> dict:
    """``cuda_ms`` of each callable, after a warm-up of every one (a card
    coming out of idle times its first calls slow), in turns: the order of
    ``fns``, then reversed. Returns {name: [first turn, second turn]}."""
    for fn in fns.values():
        cuda_ms(fn, iters)
    times = {name: [] for name in fns}
    for name in [*fns, *reversed(fns)]:
        times[name].append(cuda_ms(fns[name], iters))
    return times


def k1_inputs(dtype, lengths, seed, d=D, h=H):
    """Random q/pools and per-slot tables of distinct live blocks, padded
    with the trash block past each slot's length."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lengths = lengths.cuda()
    q = torch.randn(S, h, d, device="cuda", generator=g).to(dtype)
    kp = torch.randn(NB, h, BS, d, device="cuda", generator=g).to(dtype)
    vp = torch.randn(NB, h, BS, d, device="cuda", generator=g).to(dtype)
    tables = (torch.randperm(NB - 1, device="cuda", generator=g)[: S * T] + 1).view(S, T)
    live = torch.arange(T, device="cuda")[None, :] < ((lengths + BS - 1) // BS)[:, None]
    tables = torch.where(live, tables, 0).int().contiguous()
    return q, kp, vp, tables, lengths.int()


def k1_bound_ms(dtype, lengths, d=D, h=H) -> float:
    """Least time for one call: each live K/V row, q, the live table entries
    and the lengths read once, out written once; 4*d operations per row."""
    esize = torch.finfo(dtype).bits // 8
    n = int(lengths.sum())
    live_entries = int(((lengths + BS - 1) // BS).sum())
    nbytes = 2 * n * h * d * esize + 2 * S * h * d * esize + 4 * (live_entries + S)
    ops = 4 * n * h * d
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]) * 1e3


def k1_heads(d: int) -> int:
    """Heads of K1's checks at head dim ``d``: GPT-124M's 12 at 64, GPT-J-6B's
    16 otherwise."""
    return GPT_124M.n_heads if d == GPT_124M.head_dim else H


# K1's live split partials against decode_partials_torch: both sum exact
# fp32 products in another order (the inputs are rounded to bf16 before
# either sees them), so the gap is fp32 rounding at the largest partial
K1_PARTIALS_TOL = 1e-4


def k1_partials_gap(q, kp, vp, tables, lengths) -> float:
    """K1's live split partials after one launch (read from the stream's
    workspace, which holds the last launch's) against
    ``decode_partials_torch``: the largest difference over acc, m and l,
    relative to max(1, the largest plain value)."""
    split_tokens, splits = decode_splits(T, BS)
    s, h, d = q.shape
    paged_attention(q, kp, vp, tables, lengths, impl="cuda")
    torch.cuda.synchronize()
    ws = pa._workspaces[(q.device, torch.cuda.current_stream().cuda_stream)][0]
    got = ws[: s * h * splits * (d + 2)].view(s, h, splits, d + 2)
    want = pa.decode_partials_torch(q, kp, vp, tables, lengths, split_tokens)
    live = torch.arange(splits, device="cuda")[None, :] * split_tokens < lengths.long()[:, None]
    live = live[:, None, :].expand(s, h, splits)
    return ((got[live] - want[live]).abs().max() / want[live].abs().max().clamp_min(1)).item()


def check_k1() -> float:
    """Phase 3, at every head dim of ``DECODE_HEAD_DIMS`` (64 with GPT's 12
    heads): two batches of 8 slots, lengths on the block edges (15, 16, 17),
    on and next to the split edges (split - 1, split, split + 1, two splits
    and one more), within a single split (1, 100), the full table (2048),
    random ones and 0; then the live split partials of each batch against
    ``decode_partials_torch``. Returns the bf16 max abs error over the
    compared rows."""
    rng = np.random.RandomState(0)
    sp = decode_splits(T, BS)[0]
    batches = (torch.tensor([1, 15, 16, 17, T * BS, *rng.randint(1, T * BS + 1, 2), 0]),
               torch.tensor([sp - 1, sp, sp + 1, 2 * sp, 2 * sp + 1, 100, rng.randint(1, T * BS + 1), 0]))
    err_bf16 = 0.0
    for d in DECODE_HEAD_DIMS:
        h = k1_heads(d)
        for dtype in (torch.float32, torch.bfloat16):
            for lens in batches:
                compared = lens > 0  # a 0-length row is only required to be finite
                args = k1_inputs(dtype, lens, seed=1, d=d, h=h)
                ref = paged_attention(*args, impl="torch")
                out = paged_attention(*args, impl="cuda")
                torch.cuda.synchronize()
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"K1 {dtype} d={d}: non-finite output")
                err = (out.float() - ref.float()).abs()[compared.cuda()].max().item()
                gap = k1_partials_gap(*args)
                print(f"K1 {dtype} d={d} heads={h} split {sp} lengths={lens.tolist()} max_abs_err={err:.3g} "
                      f"tol={TOL[dtype]}; live split partials vs decode_partials_torch {gap:.3g} of "
                      f"max(1, largest value) (limit {K1_PARTIALS_TOL})")
                if not err <= TOL[dtype]:
                    raise AssertionError(f"K1 {dtype} d={d}: max abs error {err} > {TOL[dtype]}")
                if not gap <= K1_PARTIALS_TOL:
                    raise AssertionError(f"K1 {dtype} d={d}: split partials differ by {gap}")
                if dtype == torch.bfloat16:
                    err_bf16 = max(err_bf16, err)
                del args, ref, out
        torch.cuda.empty_cache()
    return err_bf16


def time_k1(d: int = D) -> dict:
    """Phase 4 at a decode shape: 8 slots x 1024 context, bf16, head dim
    ``d`` (GPT-J-6B's 16 heads of 256, GPT-124M's 12 of 64); the kernel and
    the library call in turns (``in_turns``), each the mean of its two
    turns."""
    dtype = torch.bfloat16
    h = k1_heads(d)
    lens = torch.full((S,), 1024)
    q, kp, vp, tables, lengths = k1_inputs(dtype, lens, seed=2, d=d, h=h)
    plain_ms = cuda_ms(lambda: paged_attention(q, kp, vp, tables, lengths, impl="torch"), 20)
    # library yardstick: SDPA over K/V gathered to dense beforehand (the
    # gather is NOT timed) with the length mask
    live = int(((lens.max() + BS - 1) // BS).item())
    idx = tables[:, :live].long()
    kd = kp[idx].transpose(1, 2).reshape(S, h, live * BS, d)
    vd = vp[idx].transpose(1, 2).reshape(S, h, live * BS, d)
    mask = (torch.arange(live * BS, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    turns = in_turns({"kernel": lambda: paged_attention(q, kp, vp, tables, lengths, impl="cuda"),
                      "library": lambda: F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask)}, 200)
    ms, library_ms = (sum(turns[n]) / 2 for n in ("kernel", "library"))
    rec = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=k1_bound_ms(dtype, lens, d, h))
    split_tokens, splits = decode_splits(T, BS)
    live_ctas = S * h * -(-1024 // split_tokens)
    print(
        f"K1 timing bf16 S={S} H={h} D={d} BS={BS} len=1024: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library (SDPA on pre-gathered K/V, gather excluded) "
        f"{library_ms:.4f} ms (kernel/library {ms / library_ms:.3f}x; turns "
        f"{' / '.join(f'{t:.4f}' for t in turns['kernel'])} and "
        f"{' / '.join(f'{t:.4f}' for t in turns['library'])}), bound {rec['bound_ms']:.4f} ms "
        f"(bytes, {ms / rec['bound_ms']:.2f}x); split {split_tokens} positions, {splits * h * S} CTAs "
        f"({live_ctas} with a live position)"
    )
    return rec


def k2_inputs(dtype, base, seed, inactive=(), w=W, d=D, h=H):
    """Random q/pools, window positions ``base[s] + arange(w)`` and per-slot
    tables of distinct live blocks (the live length capped at T*BS), padded
    with the trash block; slots in ``inactive`` get an all-trash table, as
    the engine gives an empty slot."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    positions = (base[:, None] + torch.arange(w)[None, :]).int().cuda()
    q = torch.randn(S, w, h, d, device="cuda", generator=g).to(dtype)
    kp = torch.randn(NB, h, BS, d, device="cuda", generator=g).to(dtype)
    vp = torch.randn(NB, h, BS, d, device="cuda", generator=g).to(dtype)
    tables = (torch.randperm(NB - 1, device="cuda", generator=g)[: S * T] + 1).view(S, T)
    n_live = (positions[:, -1] + 1).clamp(max=T * BS)
    live = torch.arange(T, device="cuda")[None, :] < ((n_live + BS - 1) // BS)[:, None]
    for s in inactive:
        live[s] = False
    tables = torch.where(live, tables, 0).int().contiguous()
    return q, kp, vp, tables, positions.contiguous()


def k2_bound_ms(dtype, positions, d=D, h=H) -> float:
    """Least time for one call: each slot's live K/V rows (up to its last
    query, capped at T*BS), q, the live table entries and the positions
    read once, out written once; 4*d operations per (query, attended
    row, head)."""
    esize = torch.finfo(dtype).bits // 8
    pos = positions.long().cpu()
    w = pos.shape[1]
    n_live = (pos[:, -1] + 1).clamp(max=T * BS)
    live_entries = int(((n_live + BS - 1) // BS).sum())
    nbytes = (2 * int(n_live.sum()) * h * d * esize + 2 * S * w * h * d * esize
              + 4 * (live_entries + S * w))
    ops = 4 * int((pos + 1).clamp(max=T * BS).sum()) * h * d
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]) * 1e3


def k2_bases(w: int, rng) -> torch.Tensor:
    """Phase 8's first positions: slot 0 inactive (base 0, all-trash table:
    only required finite), a window straddling a block edge, one whose last
    position is past T*BS, one at 1019, one straddling the split edge, and
    random ones."""
    split = decode_splits(T, BS)[0]
    return torch.tensor([0, 13, T * BS - 2, 1019, split - w // 2 - 1,
                         *rng.randint(0, T * BS - w, S - 5)])


# K2's live split partials against verify_partials_torch: in fp32 both sum
# exact products in another order; in bf16 the kernel rounds P to bf16
# (2^-9 relative) before its P V product, so its acc may differ by about
# one bf16 step of the largest partial
K2_PARTIALS_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def k2_partials_gap(q, kp, vp, tables, positions) -> float:
    """K2's live split partials after one launch (read from the stream's
    workspace, which holds the last launch's) against
    ``verify_partials_torch``: the largest difference over acc, m and l,
    relative to max(1, the largest plain value)."""
    split_tokens, splits = decode_splits(T, BS)
    s, w, h, d = q.shape
    paged_verify_attention(q, kp, vp, tables, positions, impl="cuda")
    torch.cuda.synchronize()
    ws = pa._workspaces[(q.device, torch.cuda.current_stream().cuda_stream)][0]
    got = ws[: s * h * splits * w * (d + 2)].view(s, h, splits, w, d + 2)
    want = verify_partials_torch(q, kp, vp, tables, positions, split_tokens)
    length = (positions[:, -1].long() + 1).clamp(max=T * BS)
    live = torch.arange(splits, device="cuda")[None, :] * split_tokens < length[:, None]
    live = live[:, None, :].expand(s, h, splits)
    return ((got[live] - want[live]).abs().max() / want[live].abs().max().clamp_min(1)).item()


def check_k2() -> float:
    """Phase 8: K2 vs its plain version at every window of ``K2_WINDOWS``
    and head dim of ``VERIFY_HEAD_DIMS``, in fp32 and bf16 (``k2_bases``),
    and at head dim 256 window index by window index vs K1; then its live
    split partials at phase 9's shape. Each element within ``TOL`` x max(1,
    |reference|): in bf16 both sides round an fp32 value to bf16, one step
    of which is 2^-8 of its magnitude, and K2 also rounds P to bf16 before
    its P V product (2^-9 relative), which moves its fp32 value across a
    rounding boundary more often; outputs of a window over a few tokens
    reach magnitudes 2-4. Returns the bf16 max abs error against the plain
    version."""
    rng = np.random.RandomState(4)
    compared = (torch.arange(S) != 0).cuda()
    err_bf16 = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for d in VERIFY_HEAD_DIMS:
            errs, errs_k1, ok = [], [], True
            for w in K2_WINDOWS:
                err_k1 = 0.0
                q, kp, vp, tables, positions = k2_inputs(dtype, k2_bases(w, rng), seed=5 + w, inactive=(0,),
                                                         w=w, d=d)
                ref = paged_verify_attention(q, kp, vp, tables, positions, impl="torch")
                out = paged_verify_attention(q, kp, vp, tables, positions, impl="cuda")
                torch.cuda.synchronize()
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"K2 {dtype} d={d} W={w}: non-finite output")
                err = (out.float() - ref.float()).abs()[compared]
                errs.append(err.max().item())
                ok &= bool((err <= TOL[dtype] * ref[compared].float().abs().clamp_min(1)).all())
                if d == D:
                    # each window index is a decode step at that position: K1
                    # at lengths positions[:, i] + 1 on the same cache
                    for i in range(w):
                        one = paged_attention(q[:, i].contiguous(), kp, vp, tables, positions[:, i] + 1,
                                              impl="cuda").float()
                        err = (out[:, i].float() - one).abs()
                        ok &= bool((err <= TOL[dtype] * one.abs().clamp_min(1)).all())
                        err_k1 = max(err_k1, err.max().item())
                    errs_k1.append(err_k1)
                del q, kp, vp, ref, out
            print(f"K2 {dtype} d={d} windows {list(K2_WINDOWS)} vs plain: max_abs_err "
                  f"{[f'{e:.3g}' for e in errs]}"
                  + (f"; vs K1 per window index {[f'{e:.3g}' for e in errs_k1]}" if errs_k1 else "")
                  + f" (tol {TOL[dtype]} x max(1, |reference|))")
            if not ok:
                raise AssertionError(f"K2 {dtype} d={d}: an error above {TOL[dtype]} x max(1, |reference|)")
            if dtype == torch.bfloat16:
                err_bf16 = max(err_bf16, *errs)
        torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.bfloat16):
        args = k2_inputs(dtype, torch.tensor([0, 13, T * BS - 2, *[1019] * (S - 3)]), seed=7, inactive=(0,))
        gap = k2_partials_gap(*args)
        print(f"K2 {dtype} W={W}: live split partials (acc, m, l) vs verify_partials_torch, largest "
              f"difference {gap:.3g} of max(1, largest value) (limit {K2_PARTIALS_TOL[dtype]})")
        if not gap <= K2_PARTIALS_TOL[dtype]:
            raise AssertionError(f"K2 {dtype}: split partials differ from verify_partials_torch by {gap}")
    return err_bf16


def time_k2(k1_ms: float, d: int = D) -> dict:
    """Phase 9 at a verify shape: 8 slots, windows at 1019-1023, bf16, head
    dim ``d`` (GPT-J-6B's 16 heads of 256, GPT-124M's 12 of 64); the kernel
    and the library call in turns (``in_turns``), each the mean of its two
    turns; then, at GPT-J-6B's shape, the kernel across ``K2_SWEEP`` with
    the last query at 1023, in turns. ``k1_ms`` is K1's time at the same
    shape."""
    dtype = torch.bfloat16
    h = k1_heads(d)
    base = torch.full((S,), 1019)
    q, kp, vp, tables, positions = k2_inputs(dtype, base, seed=7, d=d, h=h)
    plain_ms = cuda_ms(
        lambda: paged_verify_attention(q, kp, vp, tables, positions, impl="torch"), 20)
    # library yardstick: SDPA with q (S, H, W, D) over K/V gathered to dense
    # beforehand (the gather is NOT timed) with the per-query position mask
    n = int(positions[:, -1].max().item()) + 1
    live = (n + BS - 1) // BS
    idx = tables[:, :live].long()
    kd = kp[idx].transpose(1, 2).reshape(S, h, live * BS, d)
    vd = vp[idx].transpose(1, 2).reshape(S, h, live * BS, d)
    key_pos = torch.arange(live * BS, device="cuda")
    mask = (key_pos[None, None, :] <= positions[:, :, None])[:, None]  # (S, 1, W, keys)
    qh = q.transpose(1, 2)  # (S, H, W, D)
    turns = in_turns({"kernel": lambda: paged_verify_attention(q, kp, vp, tables, positions, impl="cuda"),
                      "library": lambda: F.scaled_dot_product_attention(qh, kd, vd, attn_mask=mask)}, 200)
    ms, library_ms = (sum(turns[n]) / 2 for n in ("kernel", "library"))
    rec = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=k2_bound_ms(dtype, positions, d, h))
    split_tokens, splits = decode_splits(T, BS)
    print(
        f"K2 timing bf16 S={S} W={W} H={h} D={d} BS={BS} positions 1019-1023: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library (SDPA on pre-gathered K/V with the position mask, "
        f"gather excluded) {library_ms:.4f} ms (kernel/library {ms / library_ms:.3f}x; turns "
        f"{' / '.join(f'{t:.4f}' for t in turns['kernel'])} and "
        f"{' / '.join(f'{t:.4f}' for t in turns['library'])}), bound {rec['bound_ms']:.4f} ms "
        f"(bytes, {ms / rec['bound_ms']:.2f}x); K2 / K1 at the same context {ms / k1_ms:.3f}; split "
        f"{split_tokens} positions, {splits * h * S} CTAs ({S * h * -(-1024 // split_tokens)} with a "
        f"live position)"
    )
    del kd, vd, q, kp, vp
    if d != D:
        return rec
    # the window swept at one context: a kernel held to its byte bound takes
    # about the same time at every W (K/V is read once per window); one held
    # by its per-query work grows with W
    fns, bounds = {}, {}
    for w in K2_SWEEP:
        args = k2_inputs(dtype, torch.full((S,), 1024 - w), seed=7, w=w)
        fns[w] = lambda args=args: paged_verify_attention(*args, impl="cuda")
        bounds[w] = k2_bound_ms(dtype, args[4])
    sweep = {w: sum(ts) / 2 for w, ts in in_turns(fns, 200).items()}
    fastest = min(sweep.values())
    print("K2 by window, bf16, last query at 1023, in turns: " + "; ".join(
        f"W={w} {t:.4f} ms ({t / fastest:.2f}x fastest, {t / k1_ms:.2f}x K1, {t / bounds[w]:.2f}x bound)"
        for w, t in sweep.items()) + f"; slowest/fastest {max(sweep.values()) / fastest:.3f}")
    return rec


def engine_identity(cfg, params, decode, label: str) -> None:
    """A 4-slot engine's greedy output equals the dense ``decode`` token for
    token: four requests, one after another's prompt is cached (a prefix
    hit), one diverging inside a cached block (a copy-on-write fork)."""
    eng = LLMEngine(
        cfg, params,
        EngineConfig(max_slots=4, block_size=16, max_blocks_per_seq=32, num_blocks=129,
                     prefill_chunk=64),
    )
    rng = np.random.RandomState(1)
    head = list(rng.randint(0, cfg.vocab_size, 40))
    prompts = [
        head + list(rng.randint(0, cfg.vocab_size, 37)),
        list(rng.randint(0, cfg.vocab_size, 130)),
        head[:36] + list(rng.randint(0, cfg.vocab_size, 20)),  # diverges mid-block
        list(rng.randint(0, cfg.vocab_size, 9)),
    ]
    n_new = 16
    first = eng.submit(prompts[0], SamplingParams(max_tokens=n_new))
    while not first.finished:
        eng.step()
    reqs = [first] + [eng.submit(p, SamplingParams(max_tokens=n_new)) for p in prompts[1:]]
    while not all(r.finished for r in reqs):
        eng.step()
    for p, r in zip(prompts, reqs):
        ref = decode(cfg, params, torch.tensor([p], device="cuda"), n_new)[0, len(p):]
        if r.out != ref.tolist():
            raise AssertionError(f"fp32 engine {r.out} != dense {label} {ref.tolist()}")
    pc = eng.prefix_cache.stats()
    if not (eng.pool.audit()["ok"] and eng.prefix_cache.audit()["ok"]):
        raise AssertionError("fp32 engine: pool or prefix-cache audit failed")
    if pc["hit_tokens"] <= 0 or pc["cow_forks"] < 1:
        raise AssertionError(f"fp32 engine: expected prefix hits and a CoW fork, got {pc}")
    print(
        f"fp32 identity: {len(reqs)} requests x {n_new} tokens equal dense {label} "
        f"(prefix hit tokens {pc['hit_tokens']}, cow forks {pc['cow_forks']})"
    )


def fp32_identity() -> None:
    """Phase 5: GPT-J at full width, 2 layers, fp32 — engine greedy == dense
    decode."""
    cfg = GPTJConfig(n_layers=2, dtype="float32")
    params = gptj_init(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    engine_identity(cfg, params, gptj_decode, "gptj_decode")


def serve_threads(eng: LLMEngine, first, make_rest, first_to_end: bool = False):
    """``run_loop`` in a thread; ``first`` (prompt, params) is submitted
    alone and its first token (with ``first_to_end``, all of it) streamed
    before the others arrive, so its prompt blocks are in the prefix tree;
    then every request of ``make_rest(first's tokens so far)`` is submitted
    and streamed from its own thread. Every kernel's launch count and the
    runner's step counts are set to 0 just before the loop starts. Returns
    ({index: (prompt, params, request, streamed tokens)}, wall seconds)."""
    results: dict[int, tuple] = {}
    errors: list[BaseException] = []

    def client(idx, prompt, sp):
        try:
            req = eng.submit(prompt, sp)
            results[idx] = (prompt, sp, req, list(eng.stream_tokens(req, timeout=600)))
        except BaseException as e:  # surfaced by the main thread below
            errors.append(e)

    # the main path's run starts here: every count from 0
    paged_attention_cuda.launches = 0
    paged_verify_attention_cuda.launches = 0
    eng.runner.launches = dict.fromkeys(eng.runner.launches, 0)
    stop = threading.Event()
    loop = threading.Thread(target=eng.run_loop, args=(stop,), daemon=True)
    t_start = time.perf_counter()
    loop.start()
    try:
        req0 = eng.submit(*first)
        stream0 = eng.stream_tokens(req0, timeout=600)
        tok0 = list(stream0) if first_to_end else [next(stream0)]
        rest = make_rest(tok0)
        threads = [threading.Thread(target=lambda: results.__setitem__(0, (*first, req0, tok0 + list(stream0))))]
        threads += [
            threading.Thread(target=client, args=(idx, *item))
            for idx, item in enumerate(rest, start=1)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        if any(t.is_alive() for t in threads):
            raise AssertionError("serve: a client thread did not finish")
        wall = time.perf_counter() - t_start
    finally:
        stop.set()
        loop.join(timeout=60)
    if errors:
        raise errors[0]
    if len(results) != 1 + len(rest):
        raise AssertionError(f"serve: {len(results)} of {1 + len(rest)} requests returned")
    return results, wall


def check_served(eng: LLMEngine, results: dict, label: str) -> None:
    """Every request ran to max_tokens, streamed what it recorded, with
    in-range tokens and finite logprobs; both ledgers audit clean."""
    V = eng.model_cfg.vocab_size
    for idx, (prompt, sp, req, streamed) in sorted(results.items()):
        if req.finish_reason != "length" or len(req.out) != sp.max_tokens or streamed != req.out:
            raise AssertionError(f"{label}: request {idx} ended {req.finish_reason} with {len(req.out)} tokens")
        if not all(0 <= t < V for t in req.out) or not np.isfinite(req.out_logprobs).all():
            raise AssertionError(f"{label}: request {idx} has out-of-range tokens or non-finite logprobs")
    audit, pc_audit = eng.pool.audit(), eng.prefix_cache.audit()
    if not (audit["ok"] and pc_audit["ok"]):
        raise AssertionError(f"{label}: audit failed {audit} {pc_audit}")


def gpt_forward_plain(cfg: GPTConfig, params, tokens):
    """The dense GPT forward as an oracle: plain attention (the reference's
    ``impl="xla"``, no kernel), no remat, fp32 logits."""
    with torch.no_grad():
        return gpt_forward(dataclasses.replace(cfg, attn_impl="xla", remat=False), params, tokens)


def check_greedy(cfg, params, results: dict, label: str, forward=gptj_forward, indices=None) -> None:
    """Every greedy token (of the requests in ``indices``, default all)
    against the dense ``forward`` over prompt + output."""
    checked = excused = 0
    for idx, (prompt, sp, req, _) in sorted(results.items()):
        if sp.temperature > 0 or (indices is not None and idx not in indices):
            continue
        seq = torch.tensor([prompt + req.out[:-1]], device="cuda")
        logits = forward(cfg, params, seq)[0, len(prompt) - 1 :]  # predicts out[j]
        top2 = logits.topk(2, dim=-1).values
        for j, tok in enumerate(req.out):
            checked += 1
            if tok == int(logits[j].argmax()):
                continue
            gap = float(top2[j, 0] - top2[j, 1])
            behind = float(top2[j, 0] - logits[j, tok])
            if gap >= BF16_TOP2_MARGIN or behind >= BF16_TOP2_MARGIN:
                raise AssertionError(
                    f"{label}: request {idx} token {j} = {tok} is {behind:.4f} behind the dense "
                    f"argmax (top-2 gap {gap:.4f}, margin {BF16_TOP2_MARGIN})"
                )
            excused += 1
    if checked == 0:
        raise AssertionError(f"{label}: no greedy token to check")
    print(
        f"{label} greedy check: {checked} tokens against the dense bf16 forward, {excused} "
        f"differ within the top-2 margin {BF16_TOP2_MARGIN}"
    )


def ttft_ms(results: dict) -> str:
    ttft = sorted(r[2].first_token_t - r[2].arrival_t for r in results.values())
    return f"{ttft[0] * 1e3:.1f}/{ttft[len(ttft) // 2] * 1e3:.1f}/{ttft[-1] * 1e3:.1f} ms"


def mix_traffic(V: int, longest: int = 1024):
    """Phase 6's requests: (the first, the rest). Prompts 64 to ``longest``
    tokens over a vocabulary of ``V``, shared 256-token heads, one diverging
    inside a cached block, greedy and seeded-sampled, 32 new tokens each."""
    rng = np.random.RandomState(2)

    def toks(n):
        return [int(t) for t in rng.randint(0, V, n)]

    greedy = SamplingParams(max_tokens=32)
    head = toks(256)  # shared head: 16 full blocks
    first = (head + toks(192), greedy)
    rest = [
        (head + toks(64), greedy),
        (head + toks(512), SamplingParams(max_tokens=32, temperature=0.8, top_k=50, top_p=0.95, seed=7)),
        (head[:200] + toks(300), greedy),  # diverges inside block 12: a CoW fork
        (toks(64), greedy),
        (toks(longest), SamplingParams(max_tokens=32, temperature=1.0, seed=11)),
        (toks(100), greedy),
        (head + toks(32), greedy),
        (toks(700), SamplingParams(max_tokens=32, temperature=0.7, top_p=0.9, seed=5)),
    ]
    return first, rest


def serve_mix(eng: LLMEngine, params, label: str, card: str, forward, longest: int = 1024) -> dict:
    """Phase 6's traffic on a warmed-up engine: 9 requests from client
    threads (``serve_threads``), prompts 64 to ``longest`` tokens, shared
    256-token heads (prefix hits), one diverging inside a cached block (a
    CoW fork), greedy and seeded-sampled, 32 new tokens each. Checks every
    request, both audits, K1's launches per decode step and every greedy
    token against the dense ``forward``. Returns the K1 launches, the
    engine, and the requests."""
    cfg = eng.model_cfg
    first, rest = mix_traffic(cfg.vocab_size, longest)
    base = eng.stats()
    results, wall = serve_threads(eng, first, lambda _: rest)
    st = eng.stats()
    k1_launches = paged_attention_cuda.launches
    decode_steps = eng.runner.launches["decode"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check_served(eng, results, label)
    pc = st["prefix_cache"]
    if pc["hit_tokens"] <= 0 or pc["cow_forks"] < 1:
        raise AssertionError(f"{label}: expected prefix hits and a CoW fork, got {pc}")
    if decode_steps < 1 or k1_launches != cfg.n_layers * decode_steps:
        raise AssertionError(
            f"{label}: K1 launched {k1_launches} times over {decode_steps} decode steps "
            f"(expected {cfg.n_layers} per step)"
        )
    check_greedy(cfg, params, results, label, forward)

    n_tok = st["tokens_generated"] - base["tokens_generated"]
    d_steps = st["decode_steps"] - base["decode_steps"]
    step_ms = (st["decode_s"] - base["decode_s"]) / max(d_steps, 1) * 1e3
    print(
        f"{label} [{card}]: {len(results)} requests, {n_tok} tokens in {wall:.3f} s "
        f"= {n_tok / wall:.2f} tokens/s; TTFT min/median/max {ttft_ms(results)}; "
        f"decode step {step_ms:.3f} ms over {d_steps} steps; K1 launches {k1_launches} = "
        f"{cfg.n_layers} x {decode_steps}; prefix hit tokens {pc['hit_tokens']}, cow forks "
        f"{pc['cow_forks']}, preemptions {st['preemptions']}; peak memory {peak_gb:.2f} GB"
    )
    return dict(launches=k1_launches, engine=eng, results=results, tokens_per_s=n_tok / wall,
                ttft_ms=ttft_ms(results))


def serve_6b(card: str) -> dict:
    """Phase 6: GPT-J-6B, bf16, served by run_loop to several client threads."""
    cfg = GPTJ_6B
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = gptj_init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    print(f"GPT-J-6B random init on the card: {time.perf_counter() - t0:.1f} s")
    eng = LLMEngine(cfg, params, GPTJ_ENGINE)
    eng.warmup()
    return dict(serve_mix(eng, params, "GPT-J-6B serve", card, gptj_forward), params=params)


def noise_host_ms(eng: LLMEngine, reqs) -> tuple[float, float]:
    """Host time of one decode step's Gumbel noise for ``reqs``' batch, and
    for the same batch made all greedy (mean of 20 calls, device synced)."""
    seeds = [r.params.seed & 0xFFFFFFFF for r in reqs]
    counters = [len(r.out) for r in reqs]
    temp = [r.params.temperature for r in reqs]
    V = eng.model_cfg.vocab_size

    def ms(temps) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            _row_noise(seeds, counters, temps, V, eng.device)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / 20

    return ms(temp), ms([0.0] * len(reqs))


#: the steps phases 7, 12 and 20 time without the profiler, and as many with
#: it (10 until phase 34 came: the profiler's processing of its events took
#: most of those phases' 17-25 s)
PROFILE_STEPS = 3


def profile_steps(eng: LLMEngine, steps: int, before_step=lambda: None):
    """``steps`` engine steps timed without the profiler (the wall time an
    idle share is read against: the profiler slows the host), then ``steps``
    more under torch.profiler. Returns (wall ms/step, profiled wall ms/step,
    the device kernels' averages)."""

    def run() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            before_step()
            eng.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    wall_ms = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_wall_ms = run()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return wall_ms, prof_wall_ms, kernels


def print_device_split(kernels, steps: int, wall_ms: float, attn: str, attn_key: str) -> None:
    """Device busy per step against the unprofiled wall, split into cuBLAS
    GEMMs, the attention kernel (``attn_key`` in its name) and the rest,
    with the six longest kernels."""

    def dev_ms(events) -> float:
        return sum(e.self_device_time_total for e in events) / 1e3 / steps

    busy = dev_ms(kernels)
    if busy == 0:
        print("  device time not measured (the profiler saw no device activity)")
        return
    k = dev_ms([e for e in kernels if attn_key in e.key])
    # cuBLAS names its GEMM kernels nvjet_*, *gemm*, *xmma* or cutlass_*
    gemm_words = ("gemm", "nvjet", "xmma", "cutlass")
    gemm = dev_ms([e for e in kernels if any(w in e.key.lower() for w in gemm_words)])
    n_launch = sum(e.count for e in kernels) / steps
    print(
        f"  device busy {busy:.3f} ms/step (idle share {1 - busy / wall_ms:.3f} of the "
        f"unprofiled step), {n_launch:.0f} device ops/step; GEMM {gemm:.3f} ms, "
        f"{attn} {k:.3f} ms ({k / busy:.3f} of busy), other {busy - gemm - k:.3f} ms per step"
    )
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {dev_ms([e]):8.3f} ms/step  {e.count // steps:5d}/step  {e.key[:90]}")


def steady_batch(eng: LLMEngine, max_tokens: int):
    """Phase 7's traffic: every slot running after a 512-token prompt, even
    slots greedy, odd slots sampled."""
    rng = np.random.RandomState(3)
    V = eng.model_cfg.vocab_size
    params = [
        SamplingParams(max_tokens=max_tokens) if i % 2 == 0
        else SamplingParams(max_tokens=max_tokens, temperature=0.8, top_k=50, top_p=0.95, seed=i)
        for i in range(eng.cfg.max_slots)
    ]
    reqs = [eng.submit([int(t) for t in rng.randint(0, V, 512)], p) for p in params]
    while not all(r.state == RUNNING for r in reqs):
        eng.step()
    return reqs


def profile_decode(eng: LLMEngine, card: str, label: str = "decode profile") -> None:
    """Phase 7: where a steady decode step's time goes — every slot decoding
    after a 512-token prompt (half greedy, half sampled); device time by
    kernel against the step's wall time without the profiler."""
    reqs = steady_batch(eng, 64)
    steps = PROFILE_STEPS
    wall_ms, prof_wall_ms, kernels = profile_steps(eng, steps)
    if not all(r.state == RUNNING for r in reqs):
        raise AssertionError("decode profile: a request finished inside the timed steps")
    noise_ms, noise_greedy_ms = noise_host_ms(eng, reqs)
    n_sampled = sum(r.params.temperature > 0 for r in reqs)
    print(
        f"{label} [{card}]: {len(reqs)} slots ({n_sampled} sampled) at context "
        f"~{reqs[0].seq_len}: {wall_ms:.3f} ms/step wall without the profiler, "
        f"{prof_wall_ms:.3f} ms/step with it; host Gumbel noise {noise_ms:.3f} ms/step "
        f"for this batch, {noise_greedy_ms:.3f} ms/step all greedy"
    )
    print_device_split(kernels, steps, wall_ms, "K1", "paged_decode_")
    for r in reqs:
        eng.cancel(r.id)
    eng.step()


class DenseDrafter:
    """Test double for phases 10 and 18: proposes each request's dense greedy
    continuation, always confident, with one token deliberately wrong in
    every row on every third call (at index (call // 3 + row) % k), so
    full, partial and zero acceptance all run whatever the random model
    does. ``designed`` counts the windows by the acceptance the double
    built in."""

    def __init__(self, k: int, truth: dict, vocab: int):
        self.k = k
        self.truth = truth  # prompt tuple -> dense continuation
        self.vocab = vocab
        self.calls = 0
        self.designed = {"full": 0, "partial": 0, "zero": 0}
        self.last_matched = np.zeros(0, bool)

    def propose(self, contexts):
        rows = []
        for r, ctx in enumerate(contexts):
            prompt = next(p for p in self.truth if tuple(ctx[: len(p)]) == p)
            done = len(ctx) - len(prompt)
            row = (self.truth[prompt][done:] + [0] * self.k)[: self.k]
            if self.calls % 3 == 2:
                j = (self.calls // 3 + r) % self.k
                row[j] = (row[j] + 1) % self.vocab
                self.designed["zero" if j == 0 else "partial"] += 1
            else:
                self.designed["full"] += 1
            rows.append(row)
        self.calls += 1
        self.last_matched = np.ones(len(contexts), bool)
        return np.asarray(rows, np.int32)


def fp32_spec_identity() -> None:
    """Phase 10: GPT-J at full width, 2 layers, fp32 — the speculating
    engine's greedy output equals dense decode token for token
    (``spec_identity``) at spec_k 4 and 9 (a window of 10, past the first
    design's widest)."""
    cfg = GPTJConfig(n_layers=2, dtype="float32")
    params = gptj_init(cfg, torch.Generator(device="cuda").manual_seed(3), "cuda")
    spec_identity(cfg, params, gptj_decode, "gptj_decode", (4, 9))


def spec_identity(cfg, params, decode, label: str, ks) -> None:
    """A speculating 4-slot engine's greedy output equals the dense
    ``decode`` token for token, first with the test-double drafter (full,
    partial and zero acceptance) at each spec_k of ``ks``, then with the
    real n-gram drafter on a prompt with a periodic tail at spec_k 4."""
    ecfg = EngineConfig(max_slots=4, block_size=16, max_blocks_per_seq=32, num_blocks=129,
                        prefill_chunk=64, spec_k=4)
    rng = np.random.RandomState(5)

    def toks(n):
        return [int(t) for t in rng.randint(0, cfg.vocab_size, n)]

    def dense(prompt, n):
        out = decode(cfg, params, torch.tensor([prompt], device="cuda"), n)
        return out[0, len(prompt):].tolist()

    n_new = 32
    prompts = [toks(40), toks(77), toks(130), toks(9)]
    truth = {tuple(p): dense(p, n_new) for p in prompts}
    for k in ks:
        eng = LLMEngine(cfg, params, dataclasses.replace(ecfg, spec_k=k))
        double = DenseDrafter(k, truth, cfg.vocab_size)
        eng._drafter = double
        launches = paged_verify_attention_cuda.launches
        reqs = [eng.submit(p, SamplingParams(max_tokens=n_new)) for p in prompts]
        while not all(r.finished for r in reqs):
            eng.step()
        for p, r in zip(prompts, reqs):
            if r.out != truth[tuple(p)]:
                raise AssertionError(f"fp32 spec engine (spec_k={k}) {r.out} != dense decode {truth[tuple(p)]}")
        st = eng.stats()
        if not (0 < st["spec_accepted"] < st["spec_proposed"]) or min(double.designed.values()) < 1:
            raise AssertionError(f"fp32 spec (spec_k={k}): acceptance not exercised: {st}, {double.designed}")
        if paged_verify_attention_cuda.launches - launches != cfg.n_layers * st["verify_steps"]:
            raise AssertionError(f"fp32 spec (spec_k={k}): K2 launches do not match the verify steps")
        if not (eng.pool.audit()["ok"] and eng.prefix_cache.audit()["ok"]):
            raise AssertionError(f"fp32 spec engine (spec_k={k}): pool or prefix-cache audit failed")
        print(
            f"fp32 spec identity (test-double drafter, spec_k={k}, window {k + 1}): {len(reqs)} requests x "
            f"{n_new} tokens equal dense {label}; {st['verify_steps']} verify steps, windows designed "
            f"{double.designed}, accepted {st['spec_accepted']} of {st['spec_proposed']}"
        )
    pattern = toks(7)
    prompt = toks(30) + pattern * 6  # a periodic tail
    want = dense(prompt, n_new)
    eng = LLMEngine(cfg, params, ecfg)
    out = eng.generate(prompt, SamplingParams(max_tokens=n_new))
    st = eng.stats()
    if out != want:
        raise AssertionError(f"fp32 spec engine (n-gram) {out} != dense decode {want}")
    if st["verify_steps"] < 1:
        raise AssertionError(f"fp32 spec (n-gram): no verify step ran: {st}")
    print(
        f"fp32 spec identity (n-gram drafter, periodic tail): {n_new} tokens equal dense "
        f"{label}; {st['verify_steps']} verify steps, accepted {st['spec_accepted']} of "
        f"{st['spec_proposed']}"
    )


def spec_serve_6b(params, card: str) -> dict:
    """Phase 11: GPT-J-6B, bf16, phase 6's weights, speculating (spec_k=4,
    n-gram drafter), served by run_loop to client threads."""
    torch.cuda.reset_peak_memory_stats()
    eng = LLMEngine(
        GPTJ_6B, params,
        EngineConfig(max_slots=8, block_size=16, max_blocks_per_seq=128, num_blocks=1025,
                     prefill_chunk=256, spec_k=4),
    )
    eng.warmup()
    return spec_serve(eng, params, "GPT-J-6B spec serve", card, gptj_forward)


SPEC_NEW = 48  # new tokens of each request of phase 11's traffic


def spec_traffic(V: int):
    """Phase 11's requests: (the first, make_rest(the first's output)).
    A regeneration, periodic tails, shared heads, greedy and seeded-sampled,
    ``SPEC_NEW`` new tokens each, over a vocabulary of ``V``."""
    rng = np.random.RandomState(6)

    def toks(n):
        return [int(t) for t in rng.randint(0, V, n)]

    n_new = SPEC_NEW
    greedy = SamplingParams(max_tokens=n_new)
    head = toks(256)  # shared head: 16 full blocks
    pat = [toks(12), toks(9), toks(5)]
    first_prompt = head + toks(100)
    first = (first_prompt, greedy)

    def make_rest(first_out):
        # the first request has finished: one client sends its prompt again
        # (a regeneration) after another sent prompt + its output, so the
        # regeneration drafts from that request's cached path
        # (PrefixCache.paths); the others have periodic tails, shared heads,
        # or neither, greedy and seeded-sampled mixed
        return [
            (first_prompt + first_out[:40], greedy),
            (first_prompt, greedy),
            (head + pat[0] * 8, greedy),
            (head + toks(128) + pat[1] * 6,
             SamplingParams(max_tokens=n_new, temperature=0.8, top_k=50, top_p=0.95, seed=7)),
            (toks(300) + pat[2] * 10, greedy),
            (toks(64), greedy),
            (head[:200] + toks(100) + pat[0] * 5,
             SamplingParams(max_tokens=n_new, temperature=1.0, seed=11)),
            (toks(512) + pat[1] * 6, greedy),
            (head + toks(32), SamplingParams(max_tokens=n_new, temperature=0.7, top_p=0.9, seed=5)),
        ]

    return first, make_rest


def spec_serve(eng: LLMEngine, params, label: str, card: str, forward) -> dict:
    """Phase 11's traffic on a warmed-up speculating engine: a first request
    to its end, then 9 from client threads — a regeneration, periodic
    tails, shared heads, greedy and seeded-sampled, 48 new tokens each.
    Checks every request, both audits, K2's launches per verify step, K1's
    per plain decode step and every greedy token against the dense
    ``forward``. Returns the K2 and K1 launches and the engine."""
    cfg = eng.model_cfg
    V = cfg.vocab_size
    n_new = SPEC_NEW
    first, make_rest = spec_traffic(V)
    base = eng.stats()
    results, wall = serve_threads(eng, first, make_rest, first_to_end=True)
    st = eng.stats()
    k1_launches = paged_attention_cuda.launches
    k2_launches = paged_verify_attention_cuda.launches
    decode_steps = eng.runner.launches["decode"]
    verify_steps = eng.runner.launches["verify"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check_served(eng, results, label)
    if verify_steps < 1 or k2_launches != cfg.n_layers * verify_steps:
        raise AssertionError(
            f"{label}: K2 launched {k2_launches} times over {verify_steps} verify steps "
            f"(expected {cfg.n_layers} per step)"
        )
    if k1_launches != cfg.n_layers * decode_steps:
        raise AssertionError(
            f"{label}: K1 launched {k1_launches} times over {decode_steps} plain decode "
            f"steps (expected {cfg.n_layers} per step)"
        )
    check_greedy(cfg, params, results, label, forward)

    def delta(key):
        return st[key] - base[key]

    n_tok = delta("tokens_generated")
    v_steps, d_steps = delta("verify_steps"), delta("decode_steps")
    proposed, accepted = delta("spec_proposed"), delta("spec_accepted")
    cfg_k = eng.cfg.spec_k
    # host noise of a verify step at this traffic's mix: 8 slots, window 5,
    # the sampled slots' share of the requests
    sampled = [sp for _, sp, _, _ in results.values() if sp.temperature > 0]
    temps = [sp.temperature for sp in sampled] + [0.0] * (S - len(sampled))
    seeds, counters = list(range(S)), [n_new // 2] * S
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        _window_noise(seeds, counters, temps[:S], W, V, eng.device)
    torch.cuda.synchronize()
    noise_ms = (time.perf_counter() - t0) * 1e3 / 20
    print(
        f"{label} [{card}]: {len(results)} requests, {n_tok} tokens in {wall:.3f} s "
        f"= {n_tok / wall:.2f} tokens/s; TTFT min/median/max {ttft_ms(results)}; "
        f"{v_steps} verify steps at {delta('verify_s') / max(v_steps, 1) * 1e3:.3f} ms, "
        f"{d_steps} plain decode steps at {delta('decode_s') / max(d_steps, 1) * 1e3:.3f} ms; "
        f"acceptance {accepted}/{proposed} = {accepted / max(proposed, 1):.3f}, "
        f"{delta('spec_emitted') / max(v_steps, 1):.2f} tokens per verify step "
        f"({delta('spec_emitted') * cfg_k / max(proposed, 1):.2f} per slot window); drafting "
        f"{delta('spec_draft_seconds') / max(v_steps, 1) * 1e3:.3f} ms per verify step "
        f"({delta('spec_draft_seconds') * 1e3:.1f} ms in all); host noise "
        f"{noise_ms:.3f} ms per verify step ({len(sampled[:S])} of {S} slots sampled, W={W}); "
        f"K2 launches {k2_launches} = {cfg.n_layers} x {verify_steps}, K1 launches "
        f"{k1_launches} = {cfg.n_layers} x {decode_steps}; prefix hit tokens "
        f"{st['prefix_cache']['hit_tokens']}, preemptions {st['preemptions']}; peak memory "
        f"{peak_gb:.2f} GB"
    )
    return dict(launches=k2_launches, k1_launches=k1_launches, engine=eng, results=results,
                tokens_per_s=n_tok / wall, ttft_ms=ttft_ms(results))


class ConfidentDrafter:
    """Test double for phase 12: proposes each context's last token k times,
    always confident, so the gate opens for every slot."""

    def __init__(self, k: int):
        self.k = k
        self.last_matched = np.zeros(0, bool)

    def propose(self, contexts):
        self.last_matched = np.ones(len(contexts), bool)
        return np.asarray([[ctx[-1]] * self.k for ctx in contexts], np.int32)


def profile_verify(eng: LLMEngine, card: str, label: str = "verify profile") -> None:
    """Phase 12: where a steady verify step's time goes — phase 7's traffic
    on phase 11's speculating engine. The test-double drafter is always
    confident and the acceptance backoff is held off before each step, so
    every timed step is a verify step over all 8 slots (W = spec_k + 1);
    the double's drafting costs nothing, so the wall time holds no n-gram
    search (phase 11 reports that). Device time by kernel against the
    step's wall time without the profiler."""
    eng._drafter = ConfidentDrafter(eng.cfg.spec_k)
    reqs = steady_batch(eng, 256)
    steps = PROFILE_STEPS
    before = dict(eng.runner.launches)

    def hold_off_backoff():
        eng._spec_skip = 0

    wall_ms, prof_wall_ms, kernels = profile_steps(eng, steps, hold_off_backoff)
    verified = eng.runner.launches["verify"] - before["verify"]
    decoded = eng.runner.launches["decode"] - before["decode"]
    if verified != 2 * steps or decoded != 0:
        raise AssertionError(f"verify profile: {verified} verify and {decoded} decode steps, "
                             f"expected {2 * steps} and 0")
    if not all(r.state == RUNNING for r in reqs):
        raise AssertionError("verify profile: a request finished inside the timed steps")
    w = eng.cfg.spec_k + 1
    seeds = [r.params.seed & 0xFFFFFFFF for r in reqs]
    counters = [len(r.out) for r in reqs]
    temps = [r.params.temperature for r in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        _window_noise(seeds, counters, temps, w, eng.model_cfg.vocab_size, eng.device)
    torch.cuda.synchronize()
    noise_ms = (time.perf_counter() - t0) * 1e3 / 20
    n_sampled = sum(t > 0 for t in temps)
    print(
        f"{label} [{card}]: {len(reqs)} slots ({n_sampled} sampled), W={w}, at context "
        f"~{reqs[0].seq_len}: {wall_ms:.3f} ms/step wall without the profiler, "
        f"{prof_wall_ms:.3f} ms/step with it; host Gumbel noise {noise_ms:.3f} ms/step "
        f"for this batch"
    )
    print_device_split(kernels, steps, wall_ms, "K2", "paged_verify_kernel")
    for r in reqs:
        eng.cancel(r.id)
    eng.step()


# GPT-124M's serving engine: 8 slots, block 16, tables of 64 blocks (the
# positional table's 1024 positions), a pool that holds every slot's table
GPT_ENGINE = EngineConfig(max_slots=8, block_size=16, max_blocks_per_seq=64, num_blocks=513,
                          prefill_chunk=256)


def gpt_fp32_identity() -> None:
    """Phase 18: GPT at full width (vocab 50304, d 768, 12 heads of 64), 2
    layers, fp32 — the engine's greedy output equals the dense
    ``gpt_decode`` token for token, plain (``engine_identity``) and
    speculating at spec_k 4 (``spec_identity``)."""
    cfg = dataclasses.replace(GPT_124M, n_layers=2, dtype="float32")
    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(21), "cuda")
    engine_identity(cfg, params, gpt_decode, "gpt_decode")
    spec_identity(cfg, params, gpt_decode, "gpt_decode", (4,))


def serve_gpt(card: str) -> dict:
    """Phase 19: GPT-124M, bf16 over fp32 master weights, full depth: phase
    6's traffic (``serve_mix``, the longest prompt cut to 960 so prompt +
    32 fits the 1024 positions), then phase 11's on a speculating engine
    over the same weights (``spec_serve``)."""
    cfg = GPT_124M
    torch.cuda.reset_peak_memory_stats()
    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    eng = LLMEngine(cfg, params, GPT_ENGINE)
    eng.warmup()
    served = serve_mix(eng, params, "GPT-124M serve", card, gpt_forward_plain, longest=960)
    torch.cuda.reset_peak_memory_stats()
    spec_eng = LLMEngine(cfg, params, dataclasses.replace(GPT_ENGINE, spec_k=4))
    spec_eng.warmup()
    spec = spec_serve(spec_eng, params, "GPT-124M spec serve", card, gpt_forward_plain)
    return dict(k1=served["launches"], k2=spec["launches"], engine=eng, spec_engine=spec_eng,
                in_process={"plain": (served["tokens_per_s"], served["ttft_ms"]),
                            "spec": (spec["tokens_per_s"], spec["ttft_ms"])})


def start_loop(eng: LLMEngine):
    """``run_loop`` in a daemon thread; returns (stop event, thread)."""
    stop = threading.Event()
    loop = threading.Thread(target=eng.run_loop, args=(stop,), daemon=True)
    loop.start()
    return stop, loop


def stop_loop(stop, loop) -> None:
    stop.set()
    loop.join(timeout=60)
    if loop.is_alive():
        raise AssertionError("run_loop did not stop")


def hot_swap_gpt(eng: LLMEngine, card: str) -> dict:
    """Phase 21: ``update_weights`` to a second seed's weights in the middle
    of traffic. Four requests of 256 tokens (greedy and sampled, two with a
    cached 256-token head) stream under ``run_loop`` until each has 8
    tokens; the loop pauses, the swap lands between two steps with the four
    in flight, the loop resumes; four more requests of 48 tokens follow,
    and the same weights are swapped in once more with the loop busy (the
    time a swap waits for the engine lock under traffic). Checks that every parameter keeps
    its storage, the version moves by one and is stamped on each request,
    the prefix tree is emptied and its epoch bumped, every request is served
    (the early ones continue under the new weights) with K1 at 12 launches
    a decode step, and every greedy token of the later requests against the
    dense forward under the NEW weights. Times the swap (host clock, device
    synced)."""
    cfg = eng.model_cfg
    new = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    ptrs = {n: p.data_ptr() for n, p in eng.runner.params.named_parameters()}
    version0, epoch0 = eng.weights_version, eng.prefix_cache.epoch
    rng = np.random.RandomState(9)

    def toks(n):
        return [int(t) for t in rng.randint(0, cfg.vocab_size, n)]

    greedy = SamplingParams(max_tokens=48)
    sampled = SamplingParams(max_tokens=48, temperature=0.9, top_k=40, seed=3)
    # the early requests run long enough that none can end before the swap
    long_greedy, long_sampled = (dataclasses.replace(sp, max_tokens=256) for sp in (greedy, sampled))
    head = toks(256)
    eng.generate(head + toks(16), SamplingParams(max_tokens=2))  # the head's blocks in the tree
    early = [(head + toks(64), long_greedy), (toks(300), long_sampled), (head + toks(200), long_greedy),
             (toks(90), long_greedy)]
    late = [(head + toks(32), greedy), (toks(100), greedy), (head[:100] + toks(50), greedy), (toks(60), sampled)]
    results = {}

    def wait(cond, what):
        deadline = time.monotonic() + 300
        while not cond():
            if time.monotonic() > deadline:
                raise AssertionError(f"hot swap: {what}")
            time.sleep(0.002)

    # the path's run starts here: every count from 0
    paged_attention_cuda.launches = 0
    paged_verify_attention_cuda.launches = 0
    eng.runner.launches = dict.fromkeys(eng.runner.launches, 0)
    loop = start_loop(eng)
    try:
        reqs = [eng.submit(p, sp) for p, sp in early]
        wait(lambda: all(len(r.out) >= 8 for r in reqs), "the early requests did not start")
        # the loop pauses for the swap: a thread blocked on the engine lock
        # can wait many steps behind a busy run_loop, whose next step takes
        # the lock again at once (Python's locks are not fair)
        stop_loop(*loop)
        cached = eng.prefix_cache.stats()["cached_blocks"]
        in_flight = sum(not r.finished for r in reqs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        version = eng.update_weights(new)
        torch.cuda.synchronize()
        swap_ms = (time.perf_counter() - t0) * 1e3
        after = eng.prefix_cache.stats()["cached_blocks"]
        loop = start_loop(eng)
        reqs += [eng.submit(p, sp) for p, sp in late]
        # the same weights again with the loop busy: how long a swap waits
        # for the engine lock under traffic (the values do not change)
        t0 = time.perf_counter()
        busy_version = eng.update_weights(new)
        torch.cuda.synchronize()
        busy_swap_ms = (time.perf_counter() - t0) * 1e3
        busy_steps = eng.stats()["steps"]
        wait(lambda: all(r.finished for r in reqs), "a request did not finish")
    finally:
        stop_loop(*loop)
    k1_launches = paged_attention_cuda.launches
    decode_steps = eng.runner.launches["decode"]
    for idx, ((prompt, sp), req) in enumerate(zip(early + late, reqs)):
        results[idx] = (prompt, sp, req, list(eng.stream_tokens(req, timeout=5)))
    check_served(eng, results, "hot swap")
    if {n: p.data_ptr() for n, p in eng.runner.params.named_parameters()} != ptrs:
        raise AssertionError("hot swap: a parameter moved to new storage")
    if version != version0 + 1 or busy_version != version + 1 or eng.weights_version != busy_version:
        raise AssertionError(f"hot swap: version {version0} -> {version} -> {busy_version}")
    stamps = [r.weights_version for r in reqs]
    if stamps != [version0] * len(early) + [version] * len(late):
        raise AssertionError(f"hot swap: request versions {stamps}")
    if not (cached > 0 and after == 0 and eng.prefix_cache.epoch == epoch0 + 2):
        raise AssertionError(f"hot swap: prefix tree {cached} -> {after} blocks, epoch {epoch0} -> "
                             f"{eng.prefix_cache.epoch}")
    if in_flight != len(early):
        raise AssertionError(f"hot swap: {len(early) - in_flight} early requests ended before the swap")
    if decode_steps < 1 or k1_launches != cfg.n_layers * decode_steps:
        raise AssertionError(f"hot swap: K1 launched {k1_launches} times over {decode_steps} decode steps")
    check_greedy(cfg, new, results, "hot swap (requests after the swap, new weights)", gpt_forward_plain,
                 indices=range(len(early), len(reqs)))
    print(
        f"GPT-124M hot swap [{card}]: update_weights {swap_ms:.3f} ms (host clock, device synced; "
        f"{sum(p.numel() for p in new.parameters()) / 1e6:.1f}M fp32 parameters copied in place), version "
        f"{version0} -> {version}; with run_loop busy {busy_swap_ms:.3f} ms (lock wait included; "
        f"{busy_steps} engine steps so far); {in_flight} requests in flight across it; prefix tree {cached} -> "
        f"{after} cached blocks, epoch {epoch0} -> {eng.prefix_cache.epoch} (two swaps); {len(reqs)} requests served, "
        f"K1 launches {k1_launches} = {cfg.n_layers} x {decode_steps}"
    )
    return dict(swap_ms=swap_ms, busy_swap_ms=busy_swap_ms, launches=k1_launches)


# phase 22: GPT-124M's engine with the production half on — phase 19's
# engines (watchdog deadlines cut to 1 s and 0.1 s so a wedge of a few
# seconds reads as a stall)
GPT_PROD_ENGINE = dataclasses.replace(GPT_ENGINE, watchdog_stall_s=1.0, watchdog_interval_s=0.1)
WEDGE_S = 4.0  # the device spin phase 22 (c) puts in front of one decode step
HOOK_PAIRS = {"decode": 100, "verify": 40}  # phase 22 (e): on/off pairs of steps
HOOK_STEPS = 10  # phase 22 (e): warm-up steps, which also count an on step's records


def metric_value(metric, tags: str = ""):
    """A metric's merged value in this process (a float, or a histogram's
    buckets + sum + count)."""
    return metric._snapshot()["data"].get(tags, 0.0)


def hist_delta(metric, before) -> list:
    """A histogram's buckets + sum + count gained since ``before``."""
    now = metric_value(metric)
    if not isinstance(now, list):
        return [0] * (len(metric.boundaries) + 3)
    if not isinstance(before, list):
        return list(now)
    return [a - b for a, b in zip(now, before)]


def reset_counts(*engines) -> None:
    """Every kernel launch count and the engines' step counts to 0: a part
    of phase 22 starts here."""
    paged_attention_cuda.launches = 0
    paged_verify_attention_cuda.launches = 0
    for eng in engines:
        eng.runner.launches = dict.fromkeys(eng.runner.launches, 0)


def check_counts(label: str, *engines) -> tuple[int, int]:
    """K1 at n_layers launches a decode step and K2 at n_layers a verify
    step of ``engines`` since ``reset_counts``; returns (K1, K2) launches."""
    layers = engines[0].model_cfg.n_layers
    decode = sum(e.runner.launches["decode"] for e in engines)
    verify = sum(e.runner.launches["verify"] for e in engines)
    k1, k2 = paged_attention_cuda.launches, paged_verify_attention_cuda.launches
    if k1 != layers * decode or k2 != layers * verify:
        raise AssertionError(f"{label}: K1 {k1} launches over {decode} decode steps, K2 {k2} over "
                             f"{verify} verify steps (expected {layers} a step)")
    return k1, k2


def check_request_hooks(eng: LLMEngine, results: dict, label: str) -> dict:
    """Per request of ``results``: its flight-recorder events run submit →
    admit → first token → ... → finish; its engine phases sum to finish −
    submit within 1e-6 s (the ledger's cursor ends at the finish stamp);
    verify time lands in ``spec_verify`` (a request with verify steps has
    some, one without has none) and a request with no plain decode step
    has no more than its finish tail in ``decode``. Returns the phase
    totals over the requests."""
    totals = dict.fromkeys(phases.ENGINE_PHASES, 0.0)
    worst = 0.0
    for idx, (_prompt, _sp, req, _) in sorted(results.items()):
        types = [e["type"] for e in events.snapshot(req.trace_id)]
        order = [types.index(t) if t in types else -1
                 for t in ("llm.submit", "llm.admit", "llm.first_token", "llm.phase.ledger", "llm.finish")]
        if order != sorted(order) or order[0] != 0 or -1 in order or types[-1] != "llm.finish":
            raise AssertionError(f"{label}: request {idx} events out of order: {types[:6]} ... {types[-3:]}")
        led = req.phase_led
        gap = abs(sum(led[1:]) - (led[0] - req.arrival_t))
        worst = max(worst, gap)
        if gap > 1e-6:
            raise AssertionError(f"{label}: request {idx} phases sum {sum(led[1:])} s, finish - submit "
                                 f"{led[0] - req.arrival_t} s")
        got = dict(zip(phases.ENGINE_PHASES, led[1:]))
        if (got["spec_verify"] > 0) != ("llm.verify" in types):
            raise AssertionError(f"{label}: request {idx} spec_verify {got['spec_verify']} with "
                                 f"{types.count('llm.verify')} verify steps")
        if "llm.decode" not in types and got["decode"] > 1e-3:
            raise AssertionError(f"{label}: request {idx} has no plain decode step but {got['decode']} s "
                                 f"in decode")
        for k, v in got.items():
            totals[k] += v
    print(f"  {label}: {len(results)} requests' events in order; phases sum to finish - submit within "
          f"{worst:.3g} s; phase totals " + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in totals.items()))
    return totals


def hooks_under_traffic(eng: LLMEngine, spec_eng: LLMEngine, params, card: str) -> tuple[int, int]:
    """Phase 22 (a): phase 19's traffic, plain (``serve_mix``) and at
    spec_k=4 (``spec_serve``), with every hook on; the counters against
    what was streamed and the engines' own counts, the inter-token latency
    histogram against the tokens, each request's events and phases."""
    m = engine_mod._metrics()
    k1 = k2 = 0
    for label, engine in (("plain", eng), ("spec_k=4", spec_eng)):
        keys = ("tokens", "finished", "spec_proposed", "spec_accepted")
        before = {k: metric_value(m[k]) for k in keys}
        itl0, ttft0 = metric_value(m["itl"]), metric_value(m["ttft"])
        base = engine.stats()
        events.clear()
        if engine is eng:
            served = serve_mix(engine, params, "GPT-124M serve, hooks on", card, gpt_forward_plain, longest=960)
        else:
            served = spec_serve(engine, params, "GPT-124M spec serve, hooks on", card, gpt_forward_plain)
        results = served["results"]
        a, b = check_counts(f"hooks ({label})", engine)
        k1, k2 = k1 + a, k2 + b
        st = engine.stats()
        got = {k: metric_value(m[k]) - before[k] for k in keys}
        streamed = sum(len(r[3]) for r in results.values())
        if got["tokens"] != streamed or got["finished"] != len(results):
            raise AssertionError(f"hooks ({label}): llm_generated_tokens +{got['tokens']} for {streamed} "
                                 f"streamed, llm_finished_requests +{got['finished']} for {len(results)}")
        spec = (st.get("spec_proposed", 0) - base.get("spec_proposed", 0),
                st.get("spec_accepted", 0) - base.get("spec_accepted", 0))
        if (got["spec_proposed"], got["spec_accepted"]) != spec:
            raise AssertionError(f"hooks ({label}): spec counters {got} against the engine's {spec}")
        itl, ttft = hist_delta(m["itl"], itl0), hist_delta(m["ttft"], ttft0)
        if itl[-1] != streamed - len(results) or ttft[-1] != len(results):
            raise AssertionError(f"hooks ({label}): {itl[-1]} inter-token gaps and {ttft[-1]} first tokens "
                                 f"for {streamed} tokens of {len(results)} requests")
        itl_median = metrics.percentiles_from_buckets(m["itl"].boundaries, itl[:-2], 0.5)
        steps = st["decode_steps"] - base["decode_steps"]
        step_ms = (st["decode_s"] - base["decode_s"]) / max(steps, 1) * 1e3
        if engine is spec_eng:
            v_steps = st["verify_steps"] - base["verify_steps"]
            step_ms = (st["verify_s"] - base["verify_s"] + st["decode_s"] - base["decode_s"]) / max(
                steps + v_steps, 1) * 1e3
        print(f"  hooks ({label}) [{card}]: llm_generated_tokens +{got['tokens']:.0f} = streamed, "
              f"llm_finished_requests +{got['finished']:.0f}, spec draft/accepted +{got['spec_proposed']:.0f}/"
              f"+{got['spec_accepted']:.0f} = the engine's; inter-token latency: {itl[-1]} gaps (tokens - "
              f"requests), median {itl_median * 1e3:.3f} ms (bucket interpolation) against the host-clock "
              f"decode{'/verify' if engine is spec_eng else ''} step of this run {step_ms:.3f} ms; mean "
              f"{itl[-2] / max(itl[-1], 1) * 1e3:.3f} ms")
        totals = check_request_hooks(engine, results, f"hooks ({label})")
        if (totals["spec_verify"] > 0) != (engine is spec_eng):
            raise AssertionError(f"hooks ({label}): spec_verify total {totals['spec_verify']}")
    return k1, k2


def ledger_against_card(eng: LLMEngine, spec_eng: LLMEngine, params, swap_bytes) -> None:
    """Phase 22 (b): the HBM ledger against the card's own accounting, and
    (``swap_bytes``, when phase 21 ran) phase 21's engine's params_bytes
    before and after its ``update_weights``."""
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    unique = {p.untyped_storage().data_ptr(): p.untyped_storage().nbytes() for p in params.parameters()}
    n_values = sum(p.numel() for p in params.parameters())
    total = 0
    for label, engine in (("plain", eng), ("spec_k=4", spec_eng)):
        led = engine.hbm_ledger()
        usable = engine.pool.cfg.num_blocks - 1
        if led["params_bytes"] != sum(unique.values()):
            raise AssertionError(f"ledger ({label}): params_bytes {led['params_bytes']} != "
                                 f"{sum(unique.values())} of unique storage")
        if led["pool_bytes"] != engine.pool.k.nbytes + engine.pool.v.nbytes:
            raise AssertionError(f"ledger ({label}): pool_bytes {led['pool_bytes']}")
        if led["seq_bytes"] + led["cache_bytes"] + led["free_bytes"] != usable * led["block_bytes"]:
            raise AssertionError(f"ledger ({label}): partition {led} != {usable} x block_bytes")
        held = led["params_bytes"] + led["pool_bytes"] + led["drafter_bytes"]
        if held > allocated:
            raise AssertionError(f"ledger ({label}): {held} bytes held > memory_allocated {allocated}")
        total += led["pool_bytes"] + led["drafter_bytes"]
        print(f"  ledger ({label}): params {led['params_bytes']} B ({n_values / 1e6:.1f}M fp32 values, "
              f"{len(unique)} storages), pool {led['pool_bytes']} B = k + v, block {led['block_bytes']} B, "
              f"seq {led['seq_bytes']} + cache {led['cache_bytes']} + free {led['free_bytes']} = {usable} "
              f"usable blocks; params + pool + drafter {held} B <= memory_allocated {allocated} B")
    total += sum(unique.values())
    print(f"  ledger: both engines (params shared) hold {total} B of memory_allocated {allocated} B; the "
          f"rest, {allocated - total} B ({(allocated - total) / 1e6:.1f} MB), is activations, workspace "
          f"and the kernels' per-stream workspace")
    if swap_bytes is None:
        return
    if swap_bytes[0] != swap_bytes[1]:
        raise AssertionError(f"ledger: params_bytes {swap_bytes[0]} before phase 21's update_weights, "
                             f"{swap_bytes[1]} after")
    print(f"  ledger: phase 21's engine params_bytes {swap_bytes[0]} before update_weights, {swap_bytes[1]} "
          f"after (written in place)")


def spin_cycles(seconds: float) -> int:
    """Clock cycles of ``torch.cuda._sleep`` that spin the device about
    ``seconds``, calibrated with CUDA events on a 50 ms spin."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    n = 100_000_000
    for _ in range(2):  # the first spin pays the launch's setup
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(n)
        end.record()
        torch.cuda.synchronize()
        per_ms = n / start.elapsed_time(end)
        n = int(per_ms * 50)
    return int(per_ms * seconds * 1e3)


def device_spin(cycles: int):
    """Spin the current stream for ``cycles``; returns an event that is
    complete once the spin has ended (``query()`` is False until then)."""
    torch.cuda._sleep(cycles)
    done = torch.cuda.Event()
    done.record()
    return done


def watchdog_wedge(eng: LLMEngine, params, card: str) -> tuple[int, int]:
    """Phase 22 (c): the watchdog under a real device wedge. A test double
    wraps ``runner.decode_step`` for one call and puts a ~4 s device spin in
    front of the real call; the step's one host sync then waits on the
    device while the step holds the engine lock. While the device spins:
    one stall event, the stall counter +1, the step-age gauge >= 1 s, a
    1.5 s-deadline request's stream ended by the watchdog's lockless
    unblock, and ``stream_tokens(timeout=2.0)`` raising
    ``EngineStalledError``. After: the engine resumes, the step age returns
    to 0, the audits are clean, and the surviving requests' greedy tokens
    match the dense forward. None of this can happen unless the step
    thread's device wait releases the GIL: then the phase fails."""
    wm = watchdog_mod._metrics()
    cycles = spin_cycles(WEDGE_S)
    rng = np.random.RandomState(12)

    def toks(n):
        return [int(t) for t in rng.randint(0, eng.model_cfg.vocab_size, n)]

    real_decode = eng.runner.decode_step
    wedge: dict = {}

    def wedged_decode(*args, **kw):
        eng.runner.decode_step = real_decode  # one call only
        wedge["t0"] = time.monotonic()
        wedge["done"] = device_spin(cycles)
        return real_decode(*args, **kw)

    def spinning() -> bool:
        return "done" in wedge and not wedge["done"].query()

    outcome: dict = {}

    def consume(name, req, timeout):
        got = []
        try:
            for t in eng.stream_tokens(req, timeout=timeout):
                got.append(t)
            outcome[name] = ("ended", time.monotonic(), spinning(), got)
        except EngineStalledError as err:
            outcome[name] = ("stalled", time.monotonic(), spinning(), err)
        except BaseException as err:  # surfaced below
            outcome[name] = ("error", time.monotonic(), False, err)

    wd = eng.start_watchdog()  # after warmup(): kernel builds are not stalls
    stalls0, leaks0, wd_stalls0 = metric_value(wm["stalls"]), metric_value(wm["leaks"]), wd.stall_count
    reset_counts(eng)
    events.clear()
    greedy = SamplingParams(max_tokens=48)
    # every request is in before the loop starts (a submit from another
    # thread can wait several steps for the engine lock): the doomed one
    # first, into an empty engine (no backlog: never shed), then the
    # survivors and the probe; the wedge is armed, and the loop's first
    # step prefills the doomed request and decodes it behind the spin
    doomed = eng.submit(toks(32), SamplingParams(max_tokens=200), deadline_s=1.5)
    survivors = [(p, greedy) for p in (toks(64), toks(150), toks(200))]
    reqs = [eng.submit(p, sp) for p, sp in survivors]
    probe = eng.submit(toks(40), SamplingParams(max_tokens=16))
    eng.runner.decode_step = wedged_decode
    consumers = [threading.Thread(target=consume, args=("doomed", doomed, 60)),
                 threading.Thread(target=consume, args=("probe", probe, 2.0))]
    consumers += [threading.Thread(target=consume, args=(i, r, 60)) for i, r in enumerate(reqs)]
    for t in consumers:
        t.start()
    loop = start_loop(eng)
    try:
        age_max = 0.0
        t_arm = time.monotonic()
        while "done" not in wedge or spinning():
            age_max = max(age_max, metric_value(wm["step_age"]))
            time.sleep(0.02)
            if time.monotonic() - t_arm > 60:
                raise AssertionError("wedge: the spin did not start or did not end")
        spin_s = time.monotonic() - wedge["t0"]
        for t in consumers:
            t.join(timeout=120)
        if any(t.is_alive() for t in consumers):
            raise AssertionError("wedge: a consumer did not finish")
        # the engine has resumed: let the loop drain, then the watchdog tick
        deadline = time.monotonic() + 60
        while eng.has_work() or metric_value(wm["step_age"]) != 0.0:
            if time.monotonic() > deadline:
                raise AssertionError(f"wedge: step age {metric_value(wm['step_age'])} after the spin")
            time.sleep(0.02)
    finally:
        eng.runner.decode_step = real_decode
        stop_loop(*loop)
    stall_events = [e for e in events.snapshot() if e["type"] == "llm.watchdog.stall"]
    by_watchdog = [e for e in stall_events if e.get("source") == "watchdog"]
    reap_events = [e for e in events.snapshot() if e["type"] == "llm.watchdog.reap"]
    leak_events = [e for e in events.snapshot() if e["type"] == "llm.watchdog.leak"]
    kind, t_doomed, doomed_spinning, _ = outcome["doomed"]
    pkind, t_probe, probe_spinning, err = outcome["probe"]
    if len(by_watchdog) != 1 or metric_value(wm["stalls"]) - stalls0 != 1 or wd.stall_count - wd_stalls0 != 1:
        raise AssertionError(f"wedge: {len(by_watchdog)} watchdog stall events, counter "
                             f"+{metric_value(wm['stalls']) - stalls0}")
    if age_max < 1.0 or by_watchdog[0]["last_step_age_s"] < 1.0:
        raise AssertionError(f"wedge: step age gauge peaked at {age_max} s")
    if kind != "ended" or not doomed_spinning or doomed.finish_reason != "deadline":
        raise AssertionError(f"wedge: the doomed stream {kind}, device spinning then: {doomed_spinning}, "
                             f"finish {doomed.finish_reason}")
    if not any(e["mode"] == "emergency" for e in reap_events):
        raise AssertionError(f"wedge: no lockless reap: {reap_events}")
    if pkind != "stalled" or not probe_spinning or err.last_step_age_s < 1.0 or err.queue_depth < 1:
        raise AssertionError(f"wedge: the probe {pkind} ({err!r}), device spinning then: {probe_spinning}")
    audit = wd.check_once()["audit"]
    if not audit["ok"] or leak_events or metric_value(wm["leaks"]) != leaks0 or metric_value(wm["audit_ok"]) != 1.0:
        raise AssertionError(f"wedge: audit {audit}, leak events {leak_events}")
    results = {i: (p, sp, r, outcome[i][3]) for i, ((p, sp), r) in enumerate(zip(survivors, reqs))}
    check_served(eng, results, "wedge survivors")
    check_greedy(eng.model_cfg, params, results, "wedge survivors", gpt_forward_plain)
    k1, k2 = check_counts("wedge", eng)
    print(
        f"  wedge [{card}]: device spin {spin_s:.2f} s ({cycles} cycles) in front of one decode step; "
        f"watchdog stall event at step age {by_watchdog[0]['last_step_age_s']:.3f} s, gauge peak "
        f"{age_max:.3f} s; the 1.5 s-deadline stream ended {t_doomed - wedge['t0']:.3f} s into the spin "
        f"(lockless reap); the probe's stream_tokens(timeout=2.0) raised EngineStalledError "
        f"{t_probe - wedge['t0']:.3f} s into it (last_step_age_s {err.last_step_age_s:.3f}, queue_depth "
        f"{err.queue_depth}, kv_utilization {err.kv_utilization:.3f}); after: step age 0, audit ok, no leak "
        f"event, {len(reqs)} survivors served; K1 launches {k1}"
    )
    return k1, k2


def shed_at_service_rate(eng: LLMEngine, card: str) -> tuple[int, int]:
    """Phase 22 (d): deadline shedding at the card's own service rate. Eight
    slots of 256-token requests serve for more than one 0.5 s rate window;
    a request whose deadline is below backlog / rate is refused with
    ``OverloadedError`` (``retry_after_s`` = estimate - deadline), an
    ``llm.shed`` event and ``llm_shed_requests`` + 1; one with ten times the
    estimate is admitted and finishes inside it."""
    m = engine_mod._metrics()
    rng = np.random.RandomState(13)
    V = eng.model_cfg.vocab_size
    reset_counts(eng)
    events.clear()
    shed0 = metric_value(m["shed"])
    loop = start_loop(eng)
    try:
        fill = [eng.submit([int(t) for t in rng.randint(0, V, 128)], SamplingParams(max_tokens=256))
                for _ in range(eng.cfg.max_slots)]
        t0 = time.monotonic()
        # the rate is read without the engine lock: a thread waiting for it
        # can wait many steps behind the busy loop (Python's locks are not fair)
        while time.monotonic() - t0 < 0.6 or eng._rate <= 0:
            if time.monotonic() - t0 > 60:
                raise AssertionError("shed: no service rate measured")
            time.sleep(0.05)
        # the loop pauses for the two submits, as phase 21 pauses it for its
        # swap: a submit blocked on the engine lock can wait out the backlog
        stop_loop(*loop)
        rate = eng._rate
        n_new = 64
        backlog = sum(max(r.params.max_tokens - len(r.out), 0) for r in fill)
        est = (backlog + n_new) / rate
        deadline = est / 4
        try:
            eng.submit([int(t) for t in rng.randint(0, V, 64)], SamplingParams(max_tokens=n_new),
                       deadline_s=deadline)
            raise AssertionError(f"shed: a {deadline:.3f} s deadline against a {est:.3f} s estimate was admitted")
        except OverloadedError as err:
            refused = err
        (ev,) = [e for e in events.snapshot() if e["type"] == "llm.shed"]
        loose_s = 10 * est
        loose = eng.submit([int(t) for t in rng.randint(0, V, 64)], SamplingParams(max_tokens=n_new),
                           deadline_s=loose_s)
        loop = start_loop(eng)
        streamed = list(eng.stream_tokens(loose, timeout=loose_s + 30))
        took = time.time() - loose.arrival_t
        for r in fill:
            eng.cancel(r.id)
        while eng.has_work():
            time.sleep(0.01)
    finally:
        stop_loop(*loop)
    # the engine rounds est - deadline from its unrounded estimate, while the
    # event carries the estimate rounded to 3 places: the unrounded one lies
    # within 0.0005 of it, and those two ends give every retry_after_s the
    # engine could have computed
    ends = {max(0.1, round(ev["estimate_s"] + d - deadline, 2)) for d in (-0.0005, 0.0005)}
    if refused.retry_after_s != ev["retry_after_s"] or refused.retry_after_s not in ends:
        raise AssertionError(f"shed: retry_after_s {refused.retry_after_s} against the event's {ev}")
    if abs(ev["estimate_s"] - est) > 0.2 * est or metric_value(m["shed"]) - shed0 != 1:
        raise AssertionError(f"shed: engine estimate {ev['estimate_s']} s against {est:.3f} s, counter "
                             f"+{metric_value(m['shed']) - shed0}")
    if loose.finish_reason != "length" or len(streamed) != n_new or took > loose_s:
        raise AssertionError(f"shed: the loose request ended {loose.finish_reason} after {took:.3f} s "
                             f"(deadline {loose_s:.3f} s)")
    k1, k2 = check_counts("shed", eng)
    print(
        f"  shed [{card}]: service rate {rate:.1f} tokens/s with {len(fill)} slots of 256-token requests; "
        f"backlog {backlog} + {n_new} tokens -> estimate {est:.3f} s (engine's {ev['estimate_s']:.3f} s); a "
        f"{deadline:.3f} s deadline refused with OverloadedError, retry_after_s {refused.retry_after_s} "
        f"(estimate - deadline {ev['estimate_s'] - deadline:.3f} s), llm_shed_requests +1; a {loose_s:.3f} s "
        f"deadline admitted, finished in {took:.3f} s"
    )
    return k1, k2


def hooks_off(reqs) -> dict:
    """Everything the hooks cost turned off: the flight recorder, the phase
    gate, and tracing at sample rate 0 on the stepping thread (an unsampled
    context, so the step span is the shared null span). A request carries
    its phase ledger from submit; requests submitted with the gate off
    carry none, as ``reqs`` do while it is off. Returns what ``hooks_on``
    restores."""
    saved = dict(env=os.environ.get("RAY_TPU_TRACE_SAMPLE"), led={r.id: r.phase_led for r in reqs})
    events.set_enabled(False)
    phases.set_enabled(False)
    for r in reqs:
        r.phase_led = None
    os.environ["RAY_TPU_TRACE_SAMPLE"] = "0"
    saved["ctx"] = tracing.set_trace_context(tracing.mint_context())
    return saved


def hooks_on(reqs, saved: dict) -> None:
    events.set_enabled(True)
    phases.set_enabled(True)
    for r in reqs:
        r.phase_led = saved["led"][r.id]
    if saved["env"] is None:
        os.environ.pop("RAY_TPU_TRACE_SAMPLE", None)
    else:
        os.environ["RAY_TPU_TRACE_SAMPLE"] = saved["env"]
    tracing.set_trace_context(saved["ctx"])


def host_us(fn, n: int = 20000) -> float:
    """Host time of one call of ``fn``, µs (mean of ``n`` after a warm-up)."""
    for _ in range(100):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def hook_call_us(eng: LLMEngine) -> dict:
    """Each hook's host time per call in this process, µs: the toggled hooks
    (a flight-recorder event with a step's fields, the step span with its
    attributes, a phase charge) and the metrics on in both arms (a counter,
    the inter-token histogram, ``_publish_gauges`` with its pool-lock
    snapshot)."""
    m = engine_mod._metrics()
    led = phases.new_ledger(time.time())

    def span():
        with tracing.span("llm_engine_step", step=1, running=8, waiting=0, spec={"k": 4}):
            pass

    def publish():
        with eng._lock:
            eng._publish_gauges()

    out = dict(
        record=host_us(lambda: events.record("llm.decode", request_id="req-0", engine_req="req-0",
                                             step=1, token=5)),
        span=host_us(span),
        charge=host_us(lambda: phases.charge(led, phases.DECODE, time.time())),
        counter=host_us(lambda: m["tokens"].inc()),
        histogram=host_us(lambda: m["itl"].observe(0.02)),
        publish=host_us(publish, 2000),
    )
    events.clear()
    tracing.clear()
    return out


def hooks_cost(eng: LLMEngine, spec_eng: LLMEngine, card: str) -> tuple[int, int]:
    """Phase 22 (e): what the hooks cost a steady step. Phase 20's steady
    decode steps (8 slots after 512-token prompts, half sampled) and verify
    steps (the confident test-double drafter, W 5), with the arms in turns
    of one step: pairs of steps, one on and one off, the order alternating
    from pair to pair, each step's wall ending in its own host sync. A
    step's host noise (the sampled slots' Gumbel draws, Python dispatch,
    other threads) moves it by milliseconds from one step to the next, so
    the estimate is the median of the pairs' differences; the hooks' own
    host time per step is printed beside it: the events, spans and charges
    an on step makes times each one's host time per call in this process
    (``hook_call_us``)."""
    k1 = k2 = 0
    for label, engine in (("decode", eng), ("verify", spec_eng)):
        pairs = HOOK_PAIRS[label]
        if engine is spec_eng:
            engine._drafter = ConfidentDrafter(engine.cfg.spec_k)
        # 512 + 500 positions fit the table; a verify step emits at most 5
        # tokens a slot, so no request can finish inside the timed steps
        reqs = steady_batch(engine, 500)
        reset_counts(engine)

        def step(arm) -> float:
            saved = hooks_off(reqs) if arm == "off" else None
            try:
                engine._spec_skip = 0  # every speculating step a verify step
                t0 = time.perf_counter()
                engine.step()
                return (time.perf_counter() - t0) * 1e3
            finally:
                if saved is not None:
                    hooks_on(reqs, saved)

        # warm-up steps that also count what an on step records
        events.clear()
        tracing.clear()
        for _ in range(HOOK_STEPS):
            step("on")
        evs = events.snapshot()
        per_step = dict(
            record=len(evs) / HOOK_STEPS,
            span=len(tracing.get_spans()) / HOOK_STEPS,
            # one charge per active request per step, beside its llm.decode/llm.verify
            charge=sum(e["type"] in ("llm.decode", "llm.verify") for e in evs) / HOOK_STEPS,
        )
        # tokens emitted per step: one per llm.decode, accepted + 1 per llm.verify
        tokens = sum(e.get("accepted", 0) + 1 for e in evs
                     if e["type"] in ("llm.decode", "llm.verify")) / HOOK_STEPS
        walls = {"on": [], "off": []}
        diffs = []
        for i in range(pairs):
            got = {arm: step(arm) for arm in (("on", "off") if i % 2 == 0 else ("off", "on"))}
            for arm, ms in got.items():
                walls[arm].append(ms)
            diffs.append(got["on"] - got["off"])
        if not all(r.state == RUNNING for r in reqs):
            raise AssertionError(f"hooks cost ({label}): a request finished inside the timed steps")
        step_kind = "verify" if engine is spec_eng else "decode"
        other = "decode" if step_kind == "verify" else "verify"
        if engine.runner.launches[step_kind] != HOOK_STEPS + 2 * pairs or engine.runner.launches[other]:
            raise AssertionError(f"hooks cost ({label}): {engine.runner.launches}")
        a, b = check_counts(f"hooks cost ({label})", engine)
        k1, k2 = k1 + a, k2 + b
        us = hook_call_us(engine)
        hooks_us = sum(per_step[k] * us[k] for k in per_step)
        metrics_us = us["publish"] + (us["counter"] + us["histogram"]) * tokens
        on, off = (float(np.median(walls[arm])) for arm in ("on", "off"))
        diff = float(np.median(diffs))
        q1, q3 = (float(np.percentile(diffs, q)) for q in (25, 75))
        print(f"  hooks cost, {label} step [{card}]: {pairs} pairs of steps, on and off in turns: hooks on "
              f"median {on:.3f} ms/step, off {off:.3f} ms/step; median paired difference on - off "
              f"{diff * 1e3:.1f} us/step = {diff / on * 100:.2f}% of the step (quartiles {q1 * 1e3:.1f} / "
              f"{q3 * 1e3:.1f} us; on slower in {sum(d > 0 for d in diffs)} of {pairs} pairs)")
        print(f"  hooks cost, {label} step, host time of the hooks themselves [{card}]: per step "
              f"{per_step['record']:.1f} events x {us['record']:.3f} us + {per_step['span']:.1f} span x "
              f"{us['span']:.3f} us + {per_step['charge']:.1f} phase charges x {us['charge']:.3f} us = "
              f"{hooks_us:.1f} us ({hooks_us / 1e3 / on * 100:.2f}% of the on step); the metrics, on in both "
              f"arms: _publish_gauges {us['publish']:.3f} us + {tokens:.1f} tokens x (counter "
              f"{us['counter']:.3f} + histogram {us['histogram']:.3f}) us = {metrics_us:.1f} us")
        for r in reqs:
            engine.cancel(r.id)
        engine.step()
    return k1, k2


def production_engine(card: str, swap_bytes=None) -> dict:
    """Phase 22: phase 19's GPT-124M engines (seed 0, bf16 over fp32
    masters, plain and spec_k=4) with the production half on: (a) metrics,
    events and phases under phase 19's traffic; (b) the HBM ledger against
    the card; (c) the watchdog under a real device wedge; (d) deadline
    shedding at the card's own service rate; (e) what the hooks cost a
    steady step, in turns. Every metric family the engine, watchdog,
    prefix cache and phase ledger name is in ``prometheus_text()``."""
    cfg = GPT_124M
    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    eng = LLMEngine(cfg, params, GPT_PROD_ENGINE)
    eng.warmup()
    spec_eng = LLMEngine(cfg, params, dataclasses.replace(GPT_PROD_ENGINE, spec_k=4))
    spec_eng.warmup()
    launches = {}
    print("(a) metrics, events and phases under phase 19's traffic")
    launches["a"] = hooks_under_traffic(eng, spec_eng, params, card)
    print("(b) the HBM ledger against the card")
    ledger_against_card(eng, spec_eng, params, swap_bytes)
    print("(c) the watchdog under a device wedge")
    launches["c"] = watchdog_wedge(eng, params, card)
    print("(d) deadline shedding at the card's service rate")
    launches["d"] = shed_at_service_rate(eng, card)
    eng._watchdog.stop()  # (e) times the hooks alone
    text = metrics.prometheus_text()
    names = (*engine_mod.METRIC_NAMES, *watchdog_mod.METRIC_NAMES, *prefix_mod.METRIC_NAMES,
             *phases.METRIC_NAMES)
    missing = [n for n in names if f"# TYPE ray_tpu_{n} " not in text]
    if missing:
        raise AssertionError(f"prometheus_text lacks {missing}")
    print(f"  prometheus_text: all {len(names)} families of the engine, watchdog, prefix cache and phase "
          f"ledger ({len(text.splitlines())} lines)")
    print("(e) what the hooks cost, in turns")
    launches["e"] = hooks_cost(eng, spec_eng, card)
    return dict(k1=sum(v[0] for v in launches.values()), k2=sum(v[1] for v in launches.values()))


# ---------------------------------------------------------------------------
# phase 23: the runtime on the card — the port's own init/remote/get/put,
# a forked GPU worker running K1, tensors through the object plane, the
# GPT-124M engine in a num_gpus=1 actor, a weight push, a clean shutdown
# ---------------------------------------------------------------------------

# GPT-124M's fp32 weights (163.1M values), the push of (e)
PUSH_VALUES = 163_109_376
RUNTIME_TENSOR_BYTES = 256 << 20  # (c): each tensor through the object plane


def shm_entries() -> set:
    return {n for n in os.listdir("/dev/shm") if n.startswith(("rta-", "psm_"))}


def compute_apps() -> list[str]:
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def process_alive(pid: int) -> bool:
    """A process that exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def runtime_resources(card: str) -> dict:
    """Phase 23 (a): ``ray_tpu_torch.init()`` with no arguments sees the
    card as ``GPU: 1`` (= ``torch.cuda.device_count()`` = ``nvidia-smi -L``)
    with its accelerator-type resource; the native arena is loaded; /dev/shm
    can hold (e)'s push."""
    torch.zeros(1, device="cuda")  # the driver's own CUDA context, counted in ``before``
    torch.cuda.synchronize()
    before = dict(shm=shm_entries(), apps=compute_apps())
    st = os.statvfs("/dev/shm")
    shm_total, shm_free = st.f_blocks * st.f_frsize, st.f_bavail * st.f_frsize
    push_bytes = PUSH_VALUES * 4
    print(f"/dev/shm: {shm_total / 1e9:.1f} GB, {shm_free / 1e9:.1f} GB free; (e)'s push needs "
          f"{push_bytes / 1e9:.3f} GB there")
    if shm_free < 2 * push_bytes:
        raise AssertionError(f"/dev/shm has {shm_free / 1e9:.3f} GB free: it cannot hold the "
                             f"{push_bytes / 1e9:.3f} GB weight push (twice that is required)")
    t0 = time.perf_counter()
    ray_tpu_torch.init()
    init_s = time.perf_counter() - t0
    res = ray_tpu_torch.cluster_resources()
    smi = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True, timeout=60, check=True)
    smi_cards = [ln for ln in smi.stdout.splitlines() if ln.startswith("GPU ")]
    acc = {k: v for k, v in res.items() if k.startswith("GPU-")}
    print(f"ray_tpu_torch.init() in {init_s:.3f} s: {res}")
    if not (res.get("GPU") == 1.0 == torch.cuda.device_count() == len(smi_cards)):
        raise AssertionError(f"GPU resource {res.get('GPU')}, torch sees {torch.cuda.device_count()}, "
                             f"nvidia-smi -L lists {len(smi_cards)}")
    want_acc = "GPU-" + torch.cuda.get_device_name(0).replace(" ", "-")
    if acc != {want_acc: 1.0}:
        raise AssertionError(f"accelerator-type resource {acc}, expected {{{want_acc!r}: 1.0}}")
    if _native.load() is None or not shm_store._write_arena_name:
        raise AssertionError("the native arena did not load: the runtime fell back to the pure-Python store")
    arena = shm_store.attach_arena(shm_store._write_arena_name)
    print(f"native arena {shm_store._write_arena_name}: capacity {arena.capacity / 1e9:.2f} GB; "
          f"accelerator type {want_acc}")
    return before


def k1_in_a_gpu_task(seed: int, cfg: dict) -> dict:
    """Phase 23 (b), in a forked worker: K1 at GPT-124M's decode shape
    against the plain version. Records, before touching the card, whether
    torch was loaded and CUDA initialised in this process."""
    import os
    import sys
    import time

    t0 = time.time()
    torch_loaded = "torch" in sys.modules
    import torch

    cuda_before = torch.cuda.is_initialized()
    from ray_tpu_torch.ops.paged_attention import paged_attention, paged_attention_cuda

    s, h, d, bs, t, nb = cfg["slots"], cfg["heads"], cfg["head_dim"], cfg["block"], cfg["table"], cfg["blocks"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    lengths = torch.randint(1, t * bs + 1, (s,), device="cuda", generator=g)
    lengths[0] = t * bs
    q = torch.randn(s, h, d, device="cuda", generator=g).bfloat16()
    kp = torch.randn(nb, h, bs, d, device="cuda", generator=g).bfloat16()
    vp = torch.randn(nb, h, bs, d, device="cuda", generator=g).bfloat16()
    tables = (torch.randperm(nb - 1, device="cuda", generator=g)[: s * t] + 1).view(s, t)
    live = torch.arange(t, device="cuda")[None, :] < ((lengths + bs - 1) // bs)[:, None]
    tables = torch.where(live, tables, 0).int().contiguous()
    lengths = lengths.int()
    paged_attention_cuda.launches = 0
    out = paged_attention(q, kp, vp, tables, lengths, impl="cuda")
    ref = paged_attention(q, kp, vp, tables, lengths, impl="torch")
    torch.cuda.synchronize()
    return dict(
        err=float((out.float() - ref.float()).abs().max()), finite=bool(torch.isfinite(out).all()),
        launches=paged_attention_cuda.launches, pid=os.getpid(), ppid=os.getppid(),
        torch_loaded=torch_loaded, cuda_before=cuda_before, device=torch.cuda.get_device_name(0),
        t0=t0, t1=time.time(),
    )


def kernel_in_gpu_tasks(card: str) -> dict:
    """Phase 23 (b): K1 in a ``num_gpus=1`` task, inside a worker forked
    from the template (whose mappings hold no CUDA or torch library), and
    two such tasks submitted together do not overlap."""
    cfg = dict(slots=8, heads=GPT_124M.n_heads, head_dim=GPT_124M.head_dim, block=GPT_ENGINE.block_size,
               table=GPT_ENGINE.max_blocks_per_seq, blocks=GPT_ENGINE.num_blocks)
    task = ray_tpu_torch.remote(num_gpus=1)(k1_in_a_gpu_task)
    t0 = time.perf_counter()
    first, second = ray_tpu_torch.get([task.remote(1, cfg), task.remote(2, cfg)], timeout=600)
    wall = time.perf_counter() - t0
    for r in (first, second):
        if not (r["finite"] and r["err"] <= TOL[torch.bfloat16] and r["launches"] == 1):
            raise AssertionError(f"K1 in a GPU task: {r}")
    # the earlier task ran in a worker forked for it from the template: CUDA
    # was not initialised there before the task touched the card
    earlier = min((first, second), key=lambda r: r["t0"])
    if earlier["cuda_before"]:
        raise AssertionError(f"K1 in a GPU task: CUDA was initialised in a fresh forked worker: {earlier}")
    template = first["ppid"]
    with open(f"/proc/{template}/cmdline", "rb") as f:
        argv = f.read().replace(b"\0", b" ").decode()
    with open(f"/proc/{template}/maps") as f:
        maps = f.read()
    if "ray_tpu_torch._private.worker_template" not in argv:
        raise AssertionError(f"the GPU task's parent is not the forkserver template: {argv}")
    if any(lib in maps for lib in ("libcuda", "libtorch", "libc10")):
        raise AssertionError("the forkserver template mapped a CUDA or torch library")
    spans = sorted((r["t0"], r["t1"]) for r in (first, second))
    if spans[1][0] < spans[0][1]:
        raise AssertionError(f"two num_gpus=1 tasks overlapped on one GPU: {spans}")
    print(
        f"K1 in forked GPU workers [{card}]: pids {first['pid']}, {second['pid']} (template {template}: "
        f"no CUDA or torch library mapped; torch loaded at task start {first['torch_loaded']}/"
        f"{second['torch_loaded']}, CUDA initialised {first['cuda_before']}/{second['cuda_before']}); "
        f"max abs err vs plain {max(first['err'], second['err']):.3g} (tol {TOL[torch.bfloat16]}); the two tasks "
        f"ran one after the other ({spans[0][1] - spans[0][0]:.3f} s, then {spans[1][1] - spans[1][0]:.3f} s, "
        f"gap {spans[1][0] - spans[0][1]:.3f} s); {wall:.3f} s for both"
    )
    return dict(pids={first["pid"], second["pid"]}, template=template)


def echo_on_the_card(to_card: bool, *xs):
    """Phase 23 (c), in a GPU worker: where each tensor landed (a view of
    the store?), and the tensors back — as they came, or moved to the card."""
    import torch

    from ray_tpu_torch._private.shm_store import shm_mapping_of

    mapped = [shm_mapping_of(x.data_ptr()) for x in xs]
    out = [x.cuda() for x in xs] if to_card else xs
    if to_card:
        torch.cuda.synchronize()
    return mapped, out, torch.cuda.get_device_name(0)


def tensors_through_the_plane(card: str) -> dict:
    """Phase 23 (c): a 256 MB fp32 and a 256 MB bf16 CPU tensor from the
    driver to a GPU task and back, and a CUDA tensor returned by a GPU task,
    each bit for bit; same-node gets are views of the store; put/get GB/s."""
    g = torch.Generator().manual_seed(23)
    xs = [torch.randn(RUNTIME_TENSOR_BYTES // 4, generator=g),
          torch.randn(RUNTIME_TENSOR_BYTES // 2, generator=g).to(torch.bfloat16)]
    rates, refs = [], []
    for x in xs:
        nbytes = x.numel() * x.element_size()
        t0 = time.perf_counter()
        ref = ray_tpu_torch.put(x)
        t1 = time.perf_counter()
        back = ray_tpu_torch.get(ref)
        t2 = time.perf_counter()
        seg = shm_mapping_of(back.data_ptr())
        if not (torch.equal(back.view(torch.uint8), x.view(torch.uint8)) and seg):
            raise AssertionError(f"{x.dtype} put/get: equal {torch.equal(back, x)}, mapping {seg}")
        rates.append((x.dtype, nbytes / (t1 - t0) / 1e9, nbytes / (t2 - t1) / 1e9, seg))
        refs.append(ref)
        del back
    echo = ray_tpu_torch.remote(num_gpus=1)(echo_on_the_card)
    t0 = time.perf_counter()
    mapped, back, _ = ray_tpu_torch.get(echo.remote(False, *refs), timeout=600)
    round_trip = time.perf_counter() - t0
    for x, y in zip(xs, back):
        if not (y.device.type == "cpu" and y.dtype == x.dtype
                and torch.equal(y.view(torch.uint8), x.view(torch.uint8)) and shm_mapping_of(y.data_ptr())):
            raise AssertionError(f"{x.dtype} driver -> GPU task -> driver: not bit for bit or not a store view")
    if not all(mapped):
        raise AssertionError(f"the GPU task's arguments were not views of the store: {mapped}")
    del back
    t0 = time.perf_counter()
    _, on_card, _ = ray_tpu_torch.get(echo.remote(True, refs[1]), timeout=600)
    card_trip = time.perf_counter() - t0
    y = on_card[0]
    if not (y.device.type == "cuda" and y.dtype == torch.bfloat16
            and torch.equal(y.view(torch.int16).cpu(), xs[1].view(torch.int16))):
        raise AssertionError(f"a CUDA tensor from a GPU task arrived on {y.device}, or changed")
    for dtype, put_gbs, get_gbs, seg in rates:
        print(f"{str(dtype)[6:]} {RUNTIME_TENSOR_BYTES >> 20} MB [{card}]: put {put_gbs:.3f} GB/s, same-node get "
              f"{get_gbs:.3f} GB/s (zero copy: a view of {seg})")
    del refs, on_card
    print(f"driver -> GPU task -> driver, both tensors ({2 * RUNTIME_TENSOR_BYTES >> 20} MB): {round_trip:.3f} s, "
          f"bit for bit, views of the store on both sides; a bf16 CUDA tensor from a GPU task arrived on "
          f"{y.device} in {card_trip:.3f} s, bit for bit")
    return dict(rates=rates, round_trip_s=round_trip)


class GPTEngineHost:
    """Phase 23 (d)-(e): the GPT-124M paged engine in a ``num_gpus=1`` actor,
    after the reference's RLHF ``RolloutWorker`` (``rlhf/rollout.py:41-75``):
    the engines are built in ``__init__`` from a seed (plain, and at spec_k=4
    over the same weights, as phase 19), each ``run_loop`` runs in a thread,
    and work is submitted and gathered through ``.remote()`` calls."""

    def __init__(self, seed: int):
        import os
        import sys
        import threading

        self.torch_at_start = "torch" in sys.modules
        import torch

        from ray_tpu_torch.llm import LLMEngine

        self.cuda_at_start = torch.cuda.is_initialized()
        self.pid = os.getpid()
        params = gpt_init(GPT_124M, torch.Generator(device="cuda").manual_seed(seed), "cuda")
        self.engines = {0: LLMEngine(GPT_124M, params, GPT_ENGINE),
                        4: LLMEngine(GPT_124M, params, dataclasses.replace(GPT_ENGINE, spec_k=4))}
        self.loops, self.pending = {}, {}
        for k, eng in self.engines.items():
            eng.warmup()
            stop = threading.Event()
            loop = threading.Thread(target=eng.run_loop, args=(stop,), daemon=True)
            loop.start()
            self.loops[k] = (stop, loop)

    def info(self) -> dict:
        return dict(pid=self.pid, torch_at_start=self.torch_at_start, cuda_at_start=self.cuda_at_start,
                    device=torch.cuda.get_device_name(0))

    def submit(self, k: int, prompt: list, sp) -> int:
        """Queue one request on engine ``k``; returns its id. The actor's
        clock starts before the engine's submit, whose wait for the engine
        lock is the engine's time, not the runtime's."""
        t0 = time.perf_counter()
        req = self.engines[k].submit(prompt, sp)
        self.pending[req.id] = (k, req, t0)
        return req.id

    def first_token(self, rid: int) -> None:
        """Wait until the request has its first token (consumes nothing)."""
        req = self.pending[rid][1]
        deadline = time.monotonic() + 600
        while req.first_token_t is None and not req.finished:
            if time.monotonic() > deadline:
                raise TimeoutError(f"request {rid} has no first token")
            time.sleep(0.001)

    def gather(self, rid: int) -> dict:
        """Stream the request to its end; its tokens and the engine's own
        timestamps, and the actor's time from its submit to its end."""
        k, req, t0 = self.pending.pop(rid)
        streamed = list(self.engines[k].stream_tokens(req, timeout=600))
        return dict(out=list(req.out), streamed=streamed, finish_reason=req.finish_reason,
                    finite=bool(np.isfinite(req.out_logprobs).all()), ttft_s=req.first_token_t - req.arrival_t,
                    actor_s=time.perf_counter() - t0, weights_version=req.weights_version)

    def reset_counts(self) -> None:
        paged_attention_cuda.launches = 0
        paged_verify_attention_cuda.launches = 0
        for eng in self.engines.values():
            eng.runner.launches = dict.fromkeys(eng.runner.launches, 0)

    def counts(self, k: int) -> dict:
        eng = self.engines[k]
        return dict(k1=paged_attention_cuda.launches, k2=paged_verify_attention_cuda.launches,
                    decode=eng.runner.launches["decode"], verify=eng.runner.launches.get("verify", 0),
                    stats=eng.stats(), audits=(eng.pool.audit()["ok"], eng.prefix_cache.audit()["ok"]))

    def drop(self, k: int) -> None:
        stop, loop = self.loops.pop(k)
        stop.set()
        loop.join(timeout=60)
        del self.engines[k]
        torch.cuda.empty_cache()

    def push(self, refs: list) -> dict:
        """(e): the new weights from the object plane (zero copy), to the
        card, then ``update_weights`` between two steps."""
        t0 = time.perf_counter()
        host = ray_tpu_torch.get(refs[0])
        t1 = time.perf_counter()
        # values under pickle's out-of-band cut (4 KB: the layernorm vectors)
        # ride in the pickle stream; every larger one must be a store view
        big = [p for p in host.parameters() if p.numel() * p.element_size() >= 4096]
        mapped = [shm_mapping_of(p.data_ptr()) for p in big]
        mapped_bytes = sum(p.numel() * p.element_size() for p, m in zip(big, mapped) if m)
        new = host.to("cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        version = self.engines[0].update_weights(new)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        del host
        return dict(get_s=t1 - t0, h2d_s=t2 - t1, update_s=t3 - t2, version=version,
                    zero_copy=all(mapped), mapped_bytes=mapped_bytes, segments=sorted({m for m in mapped if m}),
                    values=sum(p.numel() for p in new.parameters()))


def through_actor(actor, k: int, first, rest, first_to_end: bool = False) -> tuple[dict, float, list]:
    """``serve_threads`` through the actor: ``first`` is submitted alone and
    its first token (with ``first_to_end``, all of it) awaited, then every
    request of ``rest`` (a list, or a function of the first's tokens) is
    submitted and gathered from its own client thread. Returns ({index:
    (prompt, sp, request view, streamed)}, wall seconds, per-request runtime
    ms: the driver's time from submit to gathered minus the actor's own)."""
    results, added, errors = {}, [], []

    def gather(idx, prompt, sp, rid, t0):
        try:
            r = ray_tpu_torch.get(actor.gather.remote(rid), timeout=900)
            added.append((time.perf_counter() - t0 - r["actor_s"]) * 1e3)
            view = SimpleNamespace(out=r["out"], finish_reason=r["finish_reason"], first_token_t=r["ttft_s"],
                                   arrival_t=0.0, finite=r["finite"], weights_version=r["weights_version"])
            results[idx] = (prompt, sp, view, r["streamed"])
        except BaseException as e:  # surfaced below
            errors.append(e)

    def client(idx, prompt, sp):
        try:
            t0 = time.perf_counter()
            rid = ray_tpu_torch.get(actor.submit.remote(k, prompt, sp), timeout=300)
        except BaseException as e:
            errors.append(e)
            return
        gather(idx, prompt, sp, rid, t0)

    t_start = time.perf_counter()
    rid0 = ray_tpu_torch.get(actor.submit.remote(k, *first), timeout=300)
    threads = []
    if first_to_end:
        gather(0, *first, rid0, t_start)
        if errors:
            raise errors[0]
        items = rest(results[0][2].out)
    else:
        ray_tpu_torch.get(actor.first_token.remote(rid0), timeout=900)
        items = rest
        threads.append(threading.Thread(target=gather, args=(0, *first, rid0, t_start)))
    threads += [threading.Thread(target=client, args=(idx, *item)) for idx, item in enumerate(items, start=1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t_start
    if errors:
        raise errors[0]
    if len(results) != 1 + len(items):
        raise AssertionError(f"through the actor: {len(results)} of {1 + len(items)} requests returned")
    return results, wall, added


def check_actor_served(results: dict, counts: dict, cfg, label: str) -> None:
    V = cfg.vocab_size
    for idx, (prompt, sp, req, streamed) in sorted(results.items()):
        if req.finish_reason != "length" or len(req.out) != sp.max_tokens or streamed != req.out:
            raise AssertionError(f"{label}: request {idx} ended {req.finish_reason} with {len(req.out)} tokens")
        if not all(0 <= t < V for t in req.out) or not req.finite:
            raise AssertionError(f"{label}: request {idx} has out-of-range tokens or non-finite logprobs")
    if not all(counts["audits"]):
        raise AssertionError(f"{label}: audit failed in the actor {counts['audits']}")
    if counts["decode"] < 1 or counts["k1"] != cfg.n_layers * counts["decode"]:
        raise AssertionError(f"{label}: K1 launched {counts['k1']} times over {counts['decode']} decode steps")
    if counts["k2"] != cfg.n_layers * counts["verify"]:
        raise AssertionError(f"{label}: K2 launched {counts['k2']} times over {counts['verify']} verify steps")


def engine_in_an_actor(card: str, in_process: dict) -> dict:
    """Phase 23 (d) and (e)."""
    cfg = GPT_124M
    apps_before = compute_apps()
    host_cls = ray_tpu_torch.remote(num_gpus=1, max_concurrency=16)(GPTEngineHost)
    t0 = time.perf_counter()
    actor = host_cls.remote(0)
    info = ray_tpu_torch.get(actor.info.remote(), timeout=900)
    print(f"(d) GPT-124M engines (plain and spec_k=4, seed 0) up in actor pid {info['pid']} on {info['device']} "
          f"in {time.perf_counter() - t0:.1f} s (torch loaded at start {info['torch_at_start']}, CUDA "
          f"initialised {info['cuda_at_start']}: an idle worker of (b) is adopted when there is one)")
    apps_alive = compute_apps()
    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    launches = dict(k1=0, k2=0)
    out = {}
    # phase 19's traffic, started as serve_threads starts it there
    for k, label, (first, rest), first_to_end in (
        (0, "GPT-124M serve through the actor", mix_traffic(cfg.vocab_size, 960), False),
        (4, "GPT-124M spec serve through the actor", spec_traffic(cfg.vocab_size), True),
    ):
        ray_tpu_torch.get(actor.reset_counts.remote(), timeout=60)
        base = ray_tpu_torch.get(actor.counts.remote(k), timeout=60)["stats"]
        results, wall, added = through_actor(actor, k, first, rest, first_to_end)
        counts = ray_tpu_torch.get(actor.counts.remote(k), timeout=60)
        check_actor_served(results, counts, cfg, label)
        if k and counts["verify"] < 1:
            raise AssertionError(f"{label}: no verify step")
        check_greedy(cfg, params, results, label, gpt_forward_plain)
        n_tok = counts["stats"]["tokens_generated"] - base["tokens_generated"]
        added.sort()
        tps, ttft = in_process["spec" if k else "plain"]
        print(
            f"{label} [{card}]: {len(results)} requests, {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.2f} "
            f"tokens/s (in process, phase 19: {tps:.2f}); TTFT min/median/max {ttft_ms(results)} (phase 19: "
            f"{ttft}); the runtime's added time per request min/median/max {added[0]:.2f}/"
            f"{added[len(added) // 2]:.2f}/{added[-1]:.2f} ms; K1 launches {counts['k1']} = {cfg.n_layers} x "
            f"{counts['decode']}, K2 launches {counts['k2']} = {cfg.n_layers} x {counts['verify']} (read from "
            f"the actor)"
        )
        launches["k1"] += counts["k1"]
        launches["k2"] += counts["k2"]
        out[k] = dict(tokens_per_s=n_tok / wall, added_ms=added[len(added) // 2])
    # a no-op actor call and a no-op task: the runtime's floor per call
    noop = ray_tpu_torch.remote(num_cpus=0)(lambda: None)
    ray_tpu_torch.get(noop.remote(), timeout=60)
    t0 = time.perf_counter()
    for _ in range(200):
        ray_tpu_torch.get(actor.reset_counts.remote(), timeout=60)
    call_ms = (time.perf_counter() - t0) / 200 * 1e3
    t0 = time.perf_counter()
    for _ in range(200):
        ray_tpu_torch.get(noop.remote(), timeout=60)
    task_ms = (time.perf_counter() - t0) / 200 * 1e3
    print(f"round trips [{card}]: actor call {call_ms:.3f} ms, task {task_ms:.3f} ms (200 each, host clock)")

    # (e) the weight push
    ray_tpu_torch.get(actor.drop.remote(4), timeout=120)
    new = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    host = copy.deepcopy(new).cpu()
    push_bytes = sum(p.numel() * p.element_size() for p in host.parameters())
    t0 = time.perf_counter()
    ref = ray_tpu_torch.put(host)
    t1 = time.perf_counter()
    pushed = ray_tpu_torch.get(actor.push.remote([ref]), timeout=900)
    t2 = time.perf_counter()
    if not (pushed["zero_copy"] and pushed["version"] == 1 and pushed["values"] == PUSH_VALUES):
        raise AssertionError(f"(e) weight push: {pushed}")
    ray_tpu_torch.get(actor.reset_counts.remote(), timeout=60)
    rng = np.random.RandomState(9)
    late = [([int(t) for t in rng.randint(0, cfg.vocab_size, n)], SamplingParams(max_tokens=48))
            for n in (300, 32, 100, 60)]
    results, _, _ = through_actor(actor, 0, late[0], late[1:])
    counts = ray_tpu_torch.get(actor.counts.remote(0), timeout=60)
    check_actor_served(results, counts, cfg, "after the push")
    if {r[2].weights_version for r in results.values()} != {1}:
        raise AssertionError("after the push: a request ran under another weights version")
    check_greedy(cfg, new, results, "GPT-124M through the actor after the push (seed 1's weights)",
                 gpt_forward_plain)
    launches["k1"] += counts["k1"]
    print(
        f"(e) weight push [{card}]: {pushed['values'] / 1e6:.1f}M fp32 values, {push_bytes / 1e6:.1f} MB; put "
        f"{(t1 - t0) * 1e3:.1f} ms ({push_bytes / (t1 - t0) / 1e9:.3f} GB/s); the actor's get "
        f"{pushed['get_s'] * 1e3:.1f} ms (zero copy: {pushed['mapped_bytes']} of {push_bytes} bytes are views "
        f"of {pushed['segments']}, the rest vectors under 4 KB in the pickle stream) + "
        f"host-to-device {pushed['h2d_s'] * 1e3:.1f} ms ({push_bytes / pushed['h2d_s'] / 1e9:.3f} GB/s); "
        f"update_weights {pushed['update_s'] * 1e3:.3f} ms; the whole push {(t2 - t0) * 1e3:.1f} ms; version "
        f"{pushed['version']}; K1 launches after it {counts['k1']} = {cfg.n_layers} x {counts['decode']}"
    )
    del ref, host, new, params
    return dict(launches=launches, actor_pid=info["pid"], apps=(apps_before, apps_alive), serve=out,
                push_s=t2 - t0)


def clean_shutdown(before: dict, pids: set, actor_pid: int, apps: tuple, label: str = "(f)") -> None:
    """Phase 23 (f), phase 24 (g): after ``shutdown()`` no worker (the
    actor's included) nor the template survives, no /dev/shm segment of the
    store remains, and the card's compute apps are back to the driver's."""
    apps_before, apps_alive = apps
    t0 = time.perf_counter()
    ray_tpu_torch.shutdown()
    shutdown_s = time.perf_counter() - t0
    deadline = time.monotonic() + 30
    while any(process_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    alive = sorted(p for p in pids if process_alive(p))
    if alive:
        raise AssertionError(f"after shutdown these runtime processes live on: {alive}")
    left = shm_entries() - before["shm"]
    if left:
        raise AssertionError(f"after shutdown /dev/shm still holds {sorted(left)}")
    while len(compute_apps()) > len(before["apps"]) and time.monotonic() < deadline:
        time.sleep(0.1)
    apps_after = compute_apps()
    listed = [ln for ln in apps_after if ln.split(",")[0].strip() == str(actor_pid)]
    if listed or len(apps_after) > len(before["apps"]):
        raise AssertionError(f"after shutdown nvidia-smi still lists the card's compute apps {apps_after} "
                             f"(before the runtime: {before['apps']})")
    seen = any(ln.split(",")[0].strip() == str(actor_pid) for ln in apps_alive)
    print(f"{label} shutdown in {shutdown_s:.3f} s: {len(pids)} runtime processes gone (the actor {actor_pid}, "
          f"the other workers and the template), no rta-/psm_ segment left in /dev/shm, nvidia-smi compute apps "
          f"{len(apps_before)} -> {len(apps_alive)} with the actor -> {len(apps_after)} (the actor's pid "
          f"{'listed while it lived' if seen else 'not visible to nvidia-smi in this container'})")


def runtime_on_card(card: str, in_process: dict) -> dict:
    """Phase 23: the runtime on the card, (a)-(f)."""
    print("(a) resources")
    before = runtime_resources(card)
    try:
        print("(b) K1 in a GPU task")
        tasks = kernel_in_gpu_tasks(card)
        print("(c) tensors through the object plane")
        tensors_through_the_plane(card)
        served = engine_in_an_actor(card, in_process)
    except BaseException:
        ray_tpu_torch.shutdown()
        raise
    print("(f) shutdown")
    clean_shutdown(before, tasks["pids"] | {tasks["template"], served["actor_pid"]}, served["actor_pid"],
                   served["apps"])
    return served["launches"]


# ---------------------------------------------------------------------------
# phase 24: Serve over the port's engine
# ---------------------------------------------------------------------------

FAILOVER_NEW = 128  # (f): the greedy stream's new tokens; 256 until phase 32 came
FAILOVER_CUT = 64  # (f): the tokens the client holds when the replica is killed
LOADGEN_REQUESTS = 3  # (d); 32 until phase 31 came, 16 until phase 32 came
ATTRIBUTION_EPS = 0.05  # (d): phases must sum to e2e within this share
TORCH_LIBS = ("libtorch", "libc10", "libcuda", "libcudart", "libnvrtc", "libcublas")


class CountingLLMDeployment(LLMDeployment):
    """Phase 24's replica: the package's ``LLMDeployment`` with one method
    added, which reads inside the replica the kernels' launch counts, the
    runner's step counts, both ledgers' audits and the HBM ledger, and with
    ``reset`` then sets the counts to 0."""

    def kernel_counts(self, reset: bool = False) -> dict:
        import os

        from ray_tpu_torch.ops.paged_attention import paged_attention_cuda, paged_verify_attention_cuda

        eng = self._engine
        out = dict(k1=paged_attention_cuda.launches, k2=paged_verify_attention_cuda.launches,
                   decode=eng.runner.launches["decode"], verify=eng.runner.launches.get("verify", 0),
                   audits=(eng.pool.audit()["ok"], eng.prefix_cache.audit()["ok"]),
                   hbm=eng.hbm_ledger(), pid=os.getpid())
        if reset:
            paged_attention_cuda.launches = 0
            paged_verify_attention_cuda.launches = 0
            eng.runner.launches = dict.fromkeys(eng.runner.launches, 0)
        return out


def counting_app(**kw):
    """``build_llm_app(**kw)`` with its deployment's class swapped for
    ``CountingLLMDeployment`` (every option of the app kept)."""
    app = build_llm_app(**kw)
    if app.deployment.config.ray_actor_options != {"num_gpus": 1}:
        raise AssertionError(f"a replica built for the card asks for "
                             f"{app.deployment.config.ray_actor_options}, not one GPU")
    app.deployment = dataclasses.replace(app.deployment, callable_cls=CountingLLMDeployment)
    return app


def live_actor_pids(class_name: str) -> list[int]:
    """Worker pids of the live actors of ``class_name`` (the head's table)."""
    from ray_tpu_torch._private.head import ACTOR_ALIVE
    from ray_tpu_torch._private.runtime import get_ctx

    head = get_ctx().head
    with head.lock:
        return [a.worker.proc.pid for a in head.actors.values()
                if a.create_spec.get("class_name") == class_name and a.state == ACTOR_ALIVE
                and a.worker is not None and a.worker.proc is not None]


def runtime_pids() -> set:
    """Every live worker's pid and each node's template pid."""
    from ray_tpu_torch._private.runtime import get_ctx

    head = get_ctx().head
    with head.lock:
        pids = {wh.proc.pid for node in head.nodes.values() for wh in node.all_workers
                if wh.proc is not None and wh.proc.pid}
        pids |= {node.template.popen.pid for node in head.nodes.values() if node.template is not None}
    return pids


def mapped_libs(pid: int) -> list[str]:
    with open(f"/proc/{pid}/maps") as f:
        return sorted({ln.split()[-1].rsplit("/", 1)[-1] for ln in f if any(lib in ln for lib in TORCH_LIBS)})


def sp_kwargs(sp: SamplingParams) -> dict:
    """A request's sampling knobs as the deployment's keyword arguments."""
    return dict(max_tokens=sp.max_tokens, temperature=sp.temperature, top_k=sp.top_k, top_p=sp.top_p,
                seed=sp.seed)


def ledger_times(rids) -> dict:
    """{request id: engine submit-to-finish seconds} from the replicas'
    ``llm.phase.ledger`` events, drained through the head."""
    want, out = set(rids), {}
    deadline = time.monotonic() + 30
    while True:
        for e in events.collect_cluster_events():
            if e.get("type") == "llm.phase.ledger" and e.get("request_id") in want:
                out[e["request_id"]] = e["t_finish"] - e["t_submit"]
        if len(out) == len(want) or time.monotonic() > deadline:
            return out
        time.sleep(0.2)


def handle_traffic(handle, cfg, params, card: str, in_process: dict) -> dict:
    """(b): phase 6's traffic through ``handle.options(stream=True)`` from
    driver threads, started as ``serve_threads`` starts it (the first
    request's first token, then the rest)."""
    first, rest = mix_traffic(cfg.vocab_size)
    items = [first, *rest]
    results, client_s, ttft, errors = {}, {}, {}, []
    rids = {idx: f"p24b-{idx}" for idx in range(len(items))}
    first_token = threading.Event()

    def client(idx):
        prompt, sp = items[idx]
        try:
            with tracing.trace_context(rids[idx]):
                t0 = time.perf_counter()
                toks = []
                for tok in handle.options(stream=True).remote(prompt, **sp_kwargs(sp)):
                    if not toks:
                        ttft[idx] = time.perf_counter() - t0
                        first_token.set()
                    toks.append(tok)
                client_s[idx] = time.perf_counter() - t0
            results[idx] = (prompt, sp, SimpleNamespace(out=toks), toks)
        except BaseException as e:  # surfaced below
            errors.append(e)
            first_token.set()

    counts0 = handle.kernel_counts.remote(True).result(timeout=120)  # every count from 0
    t_start = time.perf_counter()
    threads = [threading.Thread(target=client, args=(0,))]
    threads[0].start()
    if not first_token.wait(timeout=600):
        raise AssertionError("(b): the first request has no first token")
    threads += [threading.Thread(target=client, args=(idx,)) for idx in range(1, len(items))]
    for t in threads[1:]:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t_start
    if errors:
        raise errors[0]
    counts = handle.kernel_counts.remote().result(timeout=120)
    if len(results) != len(items):
        raise AssertionError(f"(b): {len(results)} of {len(items)} requests returned")
    for idx, (prompt, sp, view, _) in sorted(results.items()):
        if len(view.out) != sp.max_tokens or not all(0 <= t < cfg.vocab_size for t in view.out):
            raise AssertionError(f"(b): request {idx} streamed {len(view.out)} tokens or out-of-range ones")
    if not all(counts["audits"]):
        raise AssertionError(f"(b): audit failed in the replica {counts['audits']}")
    if counts["decode"] < 1 or counts["k1"] != cfg.n_layers * counts["decode"]:
        raise AssertionError(f"(b): K1 launched {counts['k1']} times over {counts['decode']} decode steps "
                             f"in the replica (expected {cfg.n_layers} per step)")
    check_greedy(cfg, params, results, "(b) GPT-J-6B through the handle", gptj_forward)
    engine_s = ledger_times(rids.values())
    if len(engine_s) != len(items):
        raise AssertionError(f"(b): {len(engine_s)} of {len(items)} engine phase ledgers reached the driver")
    added = sorted((client_s[idx] - engine_s[rids[idx]]) * 1e3 for idx in results)
    n_tok = sum(len(r[2].out) for r in results.values())
    ttfts = sorted(ttft.values())
    tps, ttft6 = in_process
    print(
        f"(b) GPT-J-6B through the handle [{card}]: {len(results)} requests, {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.2f} tokens/s (in process, phase 6: {tps:.2f}); client TTFT min/median/max "
        f"{ttfts[0] * 1e3:.1f}/{ttfts[len(ttfts) // 2] * 1e3:.1f}/{ttfts[-1] * 1e3:.1f} ms (phase 6: {ttft6}); "
        f"Serve's added time per request (client minus the engine's submit-to-finish) min/median/max "
        f"{added[0]:.2f}/{added[len(added) // 2]:.2f}/{added[-1]:.2f} ms; K1 launches {counts['k1']} = "
        f"{cfg.n_layers} x {counts['decode']} (read from the replica, pid {counts['pid']}; before the run "
        f"it had {counts0['k1']} from its warmup)"
    )
    return dict(results=results, k1=counts["k1"], wall=wall, tokens_per_s=n_tok / wall,
                requests_per_s=len(items) / wall, added_ms=added[len(added) // 2],
                ttft_ms=ttfts[len(ttfts) // 2] * 1e3)


def http_post(port: int, app: str, body: dict, headers: dict | None = None, timeout: float = 600):
    """(status, headers, body bytes) of one POST over loopback HTTP."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", f"/{app}", body=json.dumps(body),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, resp.read()
    finally:
        conn.close()


def http_traffic(handle, port: int, cfg, served: dict, card: str) -> int:
    """(c): (b)'s greedy prompts over loopback HTTP, from client threads:
    chunked streams, the ``x-request-id`` echo, (b)'s tokens. Then a
    request whose ``deadline_s`` the backlog cannot meet gets 429 with
    ``Retry-After``. Returns the replica's K1 launches."""
    greedy = {idx: r for idx, r in served["results"].items() if r[1].temperature == 0}
    got, errors = {}, []

    def client(idx):
        prompt, sp = greedy[idx][:2]
        try:
            got[idx] = http_post(port, "gptj", {"prompt": prompt, "max_tokens": sp.max_tokens},
                                 {"x-request-id": f"p24c-{idx}"})
        except BaseException as e:
            errors.append(e)

    handle.kernel_counts.remote(True).result(timeout=120)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(idx,)) for idx in greedy]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    for idx, (status, hdrs, body) in sorted(got.items()):
        toks = [json.loads(ln) for ln in body.splitlines() if ln.strip()]
        if status != 200 or hdrs.get("transfer-encoding") != "chunked" or hdrs.get("x-request-id") != f"p24c-{idx}":
            raise AssertionError(f"(c): request {idx} answered {status} with headers {hdrs}")
        if toks != greedy[idx][2].out:
            raise AssertionError(f"(c): request {idx}'s tokens over HTTP differ from (b)'s")
    counts = handle.kernel_counts.remote().result(timeout=120)
    if counts["decode"] < 1 or counts["k1"] != cfg.n_layers * counts["decode"] or not all(counts["audits"]):
        raise AssertionError(f"(c): the replica's counts {counts}")
    print(f"(c) GPT-J-6B over HTTP [{card}]: {len(got)} greedy requests in {wall:.3f} s, chunked, x-request-id "
          f"echoed, every token equal to (b)'s; K1 launches {counts['k1']} = {cfg.n_layers} x {counts['decode']}")
    # the shed: a backlog that outlasts the engine's 0.5 s rate window, then
    # a request whose deadline the backlog cannot meet
    prompt = greedy[min(greedy)][0]
    backlog_errors: list = []

    def backlog(i):
        try:
            st, _, _ = http_post(port, "gptj", {"prompt": prompt, "max_tokens": 48, "seed": i,
                                                "temperature": 0.8})
            if st != 200:
                backlog_errors.append(st)
        except BaseException as e:
            backlog_errors.append(e)

    threads = [threading.Thread(target=backlog, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 120
    while True:
        st = handle.stats.remote().result(timeout=60)
        if st["running"] + st["waiting"] >= 8 and st["service_rate_tokens_per_s"] > 0:
            break
        if time.monotonic() > deadline:
            raise AssertionError(f"(c): the backlog never formed: {st}")
        time.sleep(0.05)
    status, hdrs, body = http_post(port, "gptj", {"prompt": prompt, "max_tokens": 48, "deadline_s": 0.05},
                                   {"x-request-id": "p24c-shed"})
    for t in threads:
        t.join(timeout=900)
    if status != 429 or int(hdrs.get("retry-after", "0")) < 1 or hdrs.get("x-request-id") != "p24c-shed":
        raise AssertionError(f"(c): the doomed request answered {status} {hdrs} {body[:200]!r}")
    if backlog_errors:
        raise AssertionError(f"(c): backlog requests failed: {backlog_errors}")
    counts = handle.kernel_counts.remote().result(timeout=120)
    print(f"(c) shed [{card}]: with {st['running']} running and {st['waiting']} waiting at "
          f"{st['service_rate_tokens_per_s']:.1f} tokens/s, a 0.05 s deadline got 429, Retry-After "
          f"{hdrs['retry-after']} s ({json.loads(body)['error'][:160]}); the 12 backlog requests completed")
    return counts["k1"]


def open_loop(handle, port: int, cfg, served: dict, card: str) -> dict:
    """(d): one ``loadgen.run_curve`` arm: Poisson arrivals at half the
    request rate (b) sustained, ``LOADGEN_REQUESTS`` requests of phase 6's
    prompts (cycled) with their sampling knobs, 32 new tokens."""
    items = [served["results"][idx][:2] for idx in sorted(served["results"])]
    rate = served["requests_per_s"] / 2
    offsets = loadgen.arrivals("poisson", rate=rate, duration_s=4 * LOADGEN_REQUESTS / rate, seed=24)
    offsets = offsets[:LOADGEN_REQUESTS]
    if len(offsets) != LOADGEN_REQUESTS:
        raise AssertionError(f"(d): the curve has {len(offsets)} arrivals")

    def payload(i):
        prompt, sp = items[i % len(items)]
        return {"prompt": prompt, **sp_kwargs(sp)}

    handle.kernel_counts.remote(True).result(timeout=120)
    t0 = time.perf_counter()
    recs = loadgen.run_curve(port, "gptj", offsets, payload)
    dur = time.perf_counter() - t0
    counts = handle.kernel_counts.remote().result(timeout=120)
    client = loadgen.summarize_client(recs, dur)
    if client["ok"] != LOADGEN_REQUESTS:
        raise AssertionError(f"(d): {client['ok']} of {LOADGEN_REQUESTS} requests answered 200: {client}")
    if counts["decode"] < 1 or counts["k1"] != cfg.n_layers * counts["decode"] or not all(counts["audits"]):
        raise AssertionError(f"(d): the replica's counts {counts}")
    rids = {r["request_id"] for r in recs if r.get("request_id")}
    deadline = time.monotonic() + 30
    while True:
        attr = loadgen._attribution_for(loadgen._drain_phase_events(), rids, ATTRIBUTION_EPS)
        if attr["n_requests"] >= len(rids) or time.monotonic() > deadline:
            break
        time.sleep(0.5)
    frac = attr["n_requests"] / client["ok"]
    if frac < 1.0 or attr["within_eps_frac"] is None:
        raise AssertionError(f"(d): {attr['n_requests']} of {client['ok']} requests attributed")
    e2e, ttft = client["e2e_s"], client["ttft_s"]
    print(
        f"(d) open loop [{card}]: {LOADGEN_REQUESTS} Poisson arrivals at {rate:.3f} requests/s (half of (b)'s "
        f"{served['requests_per_s']:.3f}) over {dur:.1f} s; client TTFT p50/p99 {ttft['p50'] * 1e3:.1f}/"
        f"{ttft['p99'] * 1e3:.1f} ms, e2e p50/p99 {e2e['p50'] * 1e3:.1f}/{e2e['p99'] * 1e3:.1f} ms; "
        f"attributed_frac {frac:.4f} ({attr['scopes']['proxy']} proxy-joined); phases sum to e2e within "
        f"{ATTRIBUTION_EPS:.0%} for {attr['within_eps']}/{attr['n_requests']} ({attr['within_eps_frac']:.4f}, "
        f"worst {attr['worst_err']:.4f}); per-phase p50 "
        + ", ".join(f"{k} {v['p50'] * 1e3:.1f} ms" for k, v in attr["per_phase"].items())
        + f"; K1 launches {counts['k1']} = {cfg.n_layers} x {counts['decode']}"
    )
    if attr["within_eps_frac"] < 0.99:
        raise AssertionError(f"(d): phases sum to e2e within {ATTRIBUTION_EPS:.0%} for only "
                             f"{attr['within_eps']} of {attr['n_requests']} requests")
    return dict(k1=counts["k1"], ttft=ttft, e2e=e2e, attributed_frac=frac, within=attr["within_eps_frac"])


def gpu_available() -> float:
    return ray_tpu_torch.available_resources().get("GPU", 0.0)


def delete_app(handle, card: str) -> None:
    """(e): ``serve.delete`` gives the card back: the GPU resource is free
    again and the driver sees the replica's memory returned."""
    ledger = handle.kernel_counts.remote().result(timeout=120)["hbm"]
    held = ledger["params_bytes"] + ledger["pool_bytes"]
    free0 = torch.cuda.mem_get_info()[0]
    if gpu_available() != 0.0:
        raise AssertionError(f"(e): the GPU resource reads {gpu_available()} while the replica holds it")
    t0 = time.perf_counter()
    serve.delete("gptj")
    deadline = time.monotonic() + 60
    while (gpu_available() != 1.0 or torch.cuda.mem_get_info()[0] - free0 < held) and time.monotonic() < deadline:
        time.sleep(0.05)
    back_s = time.perf_counter() - t0
    freed = torch.cuda.mem_get_info()[0] - free0
    if gpu_available() != 1.0 or freed < held:
        raise AssertionError(f"(e): after serve.delete the GPU resource reads {gpu_available()} and "
                             f"{freed / 1e9:.2f} GB came back (the replica's weights and pool: {held / 1e9:.2f} GB)")
    print(f"(e) serve.delete [{card}]: the GPU resource free again and {freed / 1e9:.2f} GB of device memory "
          f"back in {back_s:.2f} s (the replica's weights and KV pool {held / 1e9:.2f} GB; the rest its CUDA "
          f"context, activations and allocator cache; required: at least the weights and pool)")


def failover(card: str) -> dict:
    """(f): GPT-124M at full width and depth in one ``num_gpus=1`` replica,
    speculating (spec_k=4), ``warmup=False``, in fp32: the resumed replica
    re-prefills prompt + delivered tokens where the first one decoded them
    one by one, and in bf16 the two paths round differently, which flips
    greedy near-ties of random weights (on the CPU at the 12th token after
    the cut); fp32 holds the resume itself to token identity. A greedy
    ``FAILOVER_NEW``-token stream is cut after ``FAILOVER_CUT`` tokens by
    SIGKILL of its replica; the handle resumes it on the replacement, which
    the controller can place only once the dead worker's GPU is released.
    The tokens must equal an uninterrupted stream's and the dense
    forward's; the new replica runs K1 and K2 at 12 launches a step."""
    cfg = dataclasses.replace(GPT_124M, dtype="float32")
    t0 = time.perf_counter()
    handle = serve.run(counting_app(model="gpt", model_cfg=cfg, warmup=False,
                                    engine_config=dataclasses.replace(GPT_ENGINE, spec_k=4)), name="gpt")
    ready_s = time.perf_counter() - t0
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    rng = np.random.RandomState(24)
    pat = [int(t) for t in rng.randint(0, cfg.vocab_size, 16)]
    prompt = [int(t) for t in rng.randint(0, cfg.vocab_size, 32)] + pat * 4
    clean = list(handle.options(stream=True).remote(prompt, max_tokens=FAILOVER_NEW))
    pids = runtime_pids()
    stream = handle.options(stream=True).remote(prompt, max_tokens=FAILOVER_NEW)
    got, marks = [], {}
    old_id = None

    def watch():
        """Timestamps after the kill: the GPU released, the replacement
        ready (a new initialized replica)."""
        while "ready" not in marks and time.perf_counter() - marks["kill"] < 120:
            if "released" not in marks and gpu_available() == 1.0:
                marks["released"] = time.perf_counter()
            ids = ray_tpu_torch.get(controller.get_replica_actor_ids.remote("gpt_LLMDeployment"), timeout=30)
            new = [h for h in ids.get("gpt_LLMDeployment", []) if h != old_id]
            if new and ray_tpu_torch.get(controller.ready.remote(), timeout=30):
                marks["ready"] = time.perf_counter()
                marks["new_id"] = new[0]
            time.sleep(0.01)

    watcher = threading.Thread(target=watch, daemon=True)
    arrivals = []
    for tok in stream:
        got.append(tok)
        arrivals.append(time.perf_counter())
        if len(got) == FAILOVER_CUT and "kill" not in marks:
            old_id = stream._replica._actor_id.hex()
            pid = chaos.pid_of_actor(old_id)
            marks["kill"] = time.perf_counter()
            os.kill(pid, signal.SIGKILL)
            watcher.start()
    watcher.join(timeout=150)
    if "kill" not in marks or "ready" not in marks:
        raise AssertionError(f"(f): the failover did not run through: {sorted(marks)}")
    # tokens the dead replica produced before the kill still arrive at once;
    # the first resumed token is the one after the longest silence
    after = [t for t in arrivals if t > marks["kill"]]
    gaps = [b - a for a, b in zip([marks["kill"], *after], after)]
    marks["resumed"] = after[max(range(len(gaps)), key=gaps.__getitem__)]
    if got != clean or len(got) != FAILOVER_NEW:
        bad = next((i for i, (a, b) in enumerate(zip(got, clean)) if a != b), min(len(got), len(clean)))
        raise AssertionError(f"(f): the resumed stream ({len(got)} tokens) differs from the uninterrupted one "
                             f"from token {bad}")
    if "released" in marks and marks["released"] > marks["ready"]:
        raise AssertionError("(f): the replacement was ready before the dead worker's GPU was released")
    # two short requests on the new replica: a random prompt, whose first
    # steps the drafter cannot match (plain decode, K1), and a periodic one
    # (verify, K2) — the resumed stream alone may take either path only
    # (on the card a periodic stream verified at every step)
    extra = [([int(t) for t in rng.randint(0, cfg.vocab_size, 40)], 16), (pat * 5, 16)]
    for p, n in extra:
        if len(list(handle.options(stream=True).remote(p, max_tokens=n))) != n:
            raise AssertionError("(f): a request on the new replica came back short")
    counts = handle.kernel_counts.remote().result(timeout=120)
    if counts["decode"] < 1 or counts["verify"] < 1:
        raise AssertionError(f"(f): the new replica ran {counts['decode']} decode and {counts['verify']} "
                             f"verify steps")
    if counts["k1"] != cfg.n_layers * counts["decode"] or counts["k2"] != cfg.n_layers * counts["verify"]:
        raise AssertionError(f"(f): the new replica's launches {counts}")
    if not all(counts["audits"]):
        raise AssertionError(f"(f): audit failed in the new replica {counts['audits']}")
    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    check_greedy(cfg, params, {0: (prompt, SamplingParams(max_tokens=FAILOVER_NEW), SimpleNamespace(out=got),
                                   got)}, "(f) GPT-124M stream across the failover", gpt_forward_plain)
    del params
    released = (f"{(marks['released'] - marks['kill']) * 1e3:.1f} ms" if "released" in marks
                else "not seen between two polls")
    print(
        f"(f) failover [{card}]: GPT-124M (fp32) replica up in {ready_s:.2f} s (warmup=False); a {FAILOVER_NEW}-token "
        f"greedy stream killed (SIGKILL of pid {pid}) after {FAILOVER_CUT} tokens; kill -> GPU released "
        f"{released}; kill -> replacement ready {(marks['ready'] - marks['kill']) * 1e3:.1f} ms (the controller "
        f"polled every ~10 ms); kill -> first resumed token {(marks['resumed'] - marks['kill']) * 1e3:.1f} ms; "
        f"the stream equals the uninterrupted "
        f"one and the dense forward; the new replica (pid {counts['pid']}), with two short requests more (a random "
        f"and a periodic prompt): K1 {counts['k1']} = {cfg.n_layers} x {counts['decode']}, K2 {counts['k2']} = "
        f"{cfg.n_layers} x {counts['verify']}"
    )
    return dict(k1=counts["k1"], k2=counts["k2"], pids=pids | runtime_pids() | {pid}, replica_pid=counts["pid"],
                kill_ready_ms=(marks["ready"] - marks["kill"]) * 1e3,
                kill_resumed_ms=(marks["resumed"] - marks["kill"]) * 1e3)


def serve_on_card(card: str, in_process: tuple) -> dict:
    """Phase 24: Serve over the port's engine, (a)-(g)."""
    cfg = GPTJ_6B
    t_phase = time.perf_counter()
    print("(a) start")
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    before = dict(shm=shm_entries(), apps=compute_apps())
    ray_tpu_torch.init()
    try:
        if ray_tpu_torch.cluster_resources().get("GPU") != 1.0:
            raise AssertionError(f"(a): init() offers {ray_tpu_torch.cluster_resources()}")
        app = counting_app(model="gptj", model_cfg=cfg, engine_config=GPTJ_ENGINE, seed=0)
        t0 = time.perf_counter()
        handle = serve.run(app, name="gptj", http=True, http_port=0)
        ready_s = time.perf_counter() - t0
        controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
        port = ray_tpu_torch.get(controller.get_proxy_port.remote(), timeout=60)
        control = {name: live_actor_pids(name) for name in ("ServeController", "ProxyActor")}
        replica = live_actor_pids("Replica")
        if sorted(len(v) for v in control.values()) != [1, 1] or len(replica) != 1:
            raise AssertionError(f"(a): control plane {control}, replicas {replica}")
        libs = {name: mapped_libs(pids[0]) for name, pids in control.items()}
        if any(libs.values()):
            raise AssertionError(f"(a): the Serve control plane mapped torch or CUDA: {libs}")
        replica_libs = mapped_libs(replica[0])
        if not any("libcuda" in lib for lib in replica_libs):
            raise AssertionError(f"(a): the replica mapped no CUDA library: {replica_libs}")
        apps_alive = compute_apps()
        print(f"(a) GPT-J-6B app ready in {ready_s:.2f} s after serve.run (one num_gpus=1 replica, pid "
              f"{replica[0]}: weights drawn on the card from seed 0 + warmup; GPU available now "
              f"{gpu_available()}); HTTP on port {port}; controller pid {control['ServeController'][0]} and "
              f"proxy pid {control['ProxyActor'][0]} mapped no torch or CUDA library (the replica maps "
              f"{', '.join(replica_libs[:4])}, ...)")
        params = gptj_init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        print("(b) handle traffic")
        served = handle_traffic(handle, cfg, params, card, in_process)
        del params
        torch.cuda.empty_cache()
        print("(c) HTTP")
        k1_http = http_traffic(handle, port, cfg, served, card)
        print("(d) open-loop load")
        loaded = open_loop(handle, port, cfg, served, card)
        pids = runtime_pids()
        print("(e) delete")
        delete_app(handle, card)
        print("(f) failover on one card")
        failed_over = failover(card)
        pids |= failed_over["pids"]
        print("(g) shutdown")
        serve.shutdown()
    except BaseException:
        try:
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()
        raise
    clean_shutdown(before, pids, failed_over["replica_pid"], (before["apps"], apps_alive), label="(g)")
    phase_s = time.perf_counter() - t_phase
    print(f"phase 24 [{card}]: {phase_s:.1f} s")
    return dict(k1_gptj=served["k1"] + k1_http + loaded["k1"], k1_gpt=failed_over["k1"], k2=failed_over["k2"],
                seconds=phase_s)


def flash_bound(nbytes: int, ops: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for bf16 work on the card."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[torch.bfloat16] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def flash_yardsticks() -> dict:
    """Phase 13: library times for K3-K5 at bench.py's training shape: batch
    26, 16 heads, seq 1024, head dim 64, bf16, causal. One SDPA backward
    computes dq, dk and dv together, so it stands for K4 and K5 at once.
    Bounds: K3 reads q, k, v and writes out and the fp32 lse; K4 (dq) reads
    q, k, v, dO, lse and delta and writes dq; K5 (dk, dv) reads the same and
    writes dk and dv. Causal operations: 2*S*S*D per head per matmul,
    halved; K3 does 2 matmuls, K4 3 (S, dP, dQ), K5 4 (S, dV, dP, dK).
    Returns the library times, each kernel's (bound ms, bound by) and its
    operations."""
    g = torch.Generator(device="cuda").manual_seed(8)
    q, k, v, do = (torch.randn(TRAIN_B, TRAIN_H, TRAIN_S, TRAIN_D, device="cuda", generator=g,
                               dtype=torch.bfloat16) for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_(True)
    fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 50)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        torch.autograd.grad(out, (q, k, v), do)

    fwd_bwd_ms = cuda_ms(fwd_bwd, 50)
    tensor = TRAIN_B * TRAIN_H * TRAIN_S * TRAIN_D * 2  # bytes of one bf16 (B, H, S, D) tensor
    row = TRAIN_B * TRAIN_H * TRAIN_S * 4  # bytes of one fp32 (B, H, S) lse or delta
    matmul = 2 * TRAIN_B * TRAIN_H * TRAIN_S * TRAIN_S * TRAIN_D / 2  # one causal matmul
    work = {"K3": (4 * tensor + row, 2 * matmul), "K4": (5 * tensor + 2 * row, 3 * matmul),
            "K5": (6 * tensor + 2 * row, 4 * matmul)}
    print(f"flash yardsticks bf16 B={TRAIN_B} H={TRAIN_H} S={TRAIN_S} D={TRAIN_D} causal: SDPA "
          f"forward {fwd_ms:.4f} ms, forward+backward {fwd_bwd_ms:.4f} ms (backward ~"
          f"{fwd_bwd_ms - fwd_ms:.4f} ms, one call for dq, dk and dv)")
    bounds = {}
    for name, (nbytes, ops) in work.items():
        bounds[name] = flash_bound(nbytes, ops)
        print(f"  {name} bound {bounds[name][0]:.4f} ms ({bounds[name][1]}: {nbytes / 1e6:.1f} MB "
              f"= {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, {ops / 1e9:.1f} GFLOP = "
              f"{ops / PEAK_OPS_PER_S[torch.bfloat16] * 1e3:.4f} ms)")
    return dict(fwd_ms=fwd_ms, bwd_ms=fwd_bwd_ms - fwd_ms, bounds=bounds,
                ops={name: ops for name, (_, ops) in work.items()})


def flash_kernels_run(q, k, v, do):
    """K3, then K4 and K5 on delta from K3's out, as FlashAttention's
    backward runs them: (out, lse, dq, dk, dv)."""
    out, lse = flash_fwd_cuda(q, k, v)
    delta = (do.float() * out.float()).sum(-1)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta)
    return out, lse, dq, dk, dv


def flash_errors(q, k, v, do) -> dict:
    """K3-K5 on (bh, seq, d) inputs against their plain versions on the same
    card; raises on a miss. fp32: out within 2e-5, lse 1e-4 and grads 1e-4
    (summation order only). bf16: out within 1e-2 x max(1, |plain|)
    elementwise (both round one fp32 value to bf16; a different summation
    order moves it by one bf16 step, 2^-7 of its magnitude, and outputs reach
    magnitudes 2-4 on early rows); lse 1e-4; the grads against the plain
    version run in fp32 on the same bf16 inputs and the kernels' out and
    lse, within 1e-2 x max(1, max |plain|): the kernels round P and dS to
    bf16 (2^-9 relative) before their second product and their results to
    bf16. Returns the max abs errors per kernel (K5: the larger of dk's and
    dv's)."""
    dtype, (bh, seq, d) = q.dtype, q.shape
    what = f"flash {dtype} bh={bh} d={d} seq={seq}"
    out, lse, dq, dk, dv = flash_kernels_run(q, k, v, do)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(t).all()) for t in (out, lse, dq, dk, dv)):
        raise AssertionError(f"{what}: non-finite output")
    ref_out, ref_lse = flash_fwd_reference(q, k, v)
    err_out = (out.float() - ref_out.float()).abs()
    err_lse = (lse - ref_lse).abs().max().item()
    if dtype == torch.float32:
        refs = flash_bwd_reference(q, k, v, out, lse, do)
        ok_out = err_out.max().item() <= TOL[dtype]
        grad_tol = [1e-4] * 3
    else:
        refs = flash_bwd_reference(q.float(), k.float(), v.float(), out.float(), lse, do.float())
        ok_out = bool((err_out <= TOL[dtype] * ref_out.float().abs().clamp_min(1)).all())
        grad_tol = [1e-2 * max(1.0, r.abs().max().item()) for r in refs]
    err_g = [(a.float() - r.float()).abs().max().item() for a, r in zip((dq, dk, dv), refs)]
    print(f"{what}: max_abs_err out {err_out.max().item():.3g}, lse {err_lse:.3g}, dq "
          f"{err_g[0]:.3g}, dk {err_g[1]:.3g}, dv {err_g[2]:.3g} "
          f"(grad tol {', '.join(f'{t:.3g}' for t in grad_tol)})")
    if not (ok_out and err_lse <= 1e-4 and all(e <= t for e, t in zip(err_g, grad_tol))):
        raise AssertionError(f"{what}: kernels disagree with plain")
    return dict(K3=err_out.max().item(), K4=err_g[0], K5=max(err_g[1:]))


def check_flash() -> None:
    """Phase 14: K3-K5 vs their plain versions (``flash_errors``) at d 64
    and 128, fp32 and bf16, at seq 1024, a ragged 1000 and 1001 (the lse
    and delta rows of head bh start at bh x 1001 x 4 bytes, off 16-byte
    boundaries) (bh = 2 x 16). Phase 15 checks the training shape itself.
    An operand that starts off a 16-byte boundary is refused."""
    for dtype in (torch.float32, torch.bfloat16):
        for d in KERNEL_HEAD_DIMS:
            for seq in (1024, 1000, 1001):
                g = torch.Generator(device="cuda").manual_seed(seq + d)
                flash_errors(*(torch.randn(32, seq, d, device="cuda", generator=g).to(dtype)
                               for _ in range(4)))
    q = torch.zeros(2 * 64 * 64 + 1, device="cuda", dtype=torch.bfloat16)[1:].view(2, 64, 64)
    try:
        flash_fwd_cuda(q, q, q)
    except ValueError as e:
        print(f"flash operand off a 16-byte boundary refused: {e}")
    else:
        raise AssertionError("flash forward took an operand off a 16-byte boundary")
    # a head dim the kernels lack raises on the card
    try:
        flash_attention(*(torch.zeros(1, 2, 16, 256, device="cuda"),) * 3)
    except ValueError as e:
        print(f"flash head_dim 256 refused: {e}")
    else:
        raise AssertionError("flash attention took head_dim 256")


def flash_build_report() -> None:
    """Registers and spills of each flash kernel instance, from the
    ``-Xptxas -v`` report of the build, and the dynamic shared memory its
    launch requests (``kernel_smem_bytes``, from the source)."""
    current = None
    for line in _kernels.build_log("flash_attention").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            kind = next(k for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") if f"{k}_kernel" in name)
            dtype = torch.bfloat16 if "nv_bfloat16" in name else torch.float32
            d = 128 if "Li128E" in name else 64
            current = (f"{kind}{' (wgmma)' if 'wgmma' in name else ''} "
                       f"{'bf16' if dtype == torch.bfloat16 else 'fp32'} d={d}: "
                       f"{kernel_smem_bytes(kind, d, dtype)} B dynamic shared memory")
        elif current and "spill stores" in line:
            current += ", " + line.split(",", 1)[1].strip()
        elif current and "Used" in line and "registers" in line:
            print(f"  {current}, {line.split(':', 1)[1].strip()}")
            current = None


def time_flash(yard: dict) -> dict:
    """Phase 15 at the training shape (bh 416, seq 1024, d 64, bf16): the
    kernels against their plain versions there (``flash_errors``), then
    each kernel, after an idle second, 200 launches between CUDA events,
    beside its bound, its plain version (``flash_bwd_reference`` computes
    dq, dk and dv in one call, so K4 and K5 share that time) and the
    library call (SDPA forward for K3; SDPA's backward, one call for dq,
    dk and dv, for K4 and K5).
    Prints each kernel's achieved TFLOP/s (phase 13's operations over its
    time) and its time over the library call's. Returns each kernel's
    record for the kernels line, its max abs error the one at this shape."""
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = (torch.randn(TRAIN_B * TRAIN_H, TRAIN_S, TRAIN_D, device="cuda", generator=g,
                               dtype=torch.bfloat16) for _ in range(4))
    errs = flash_errors(q, k, v, do)
    torch.cuda.empty_cache()
    out, lse = flash_fwd_cuda(q, k, v)
    delta = (do.float() * out.float()).sum(-1)

    def idle_then_ms(fn) -> float:
        # each kernel from an idle card: right after 200 launches of K3 or
        # K5, K4 times 1-7% slower than after an idle second, the mma.sync
        # design and the wgmma one alike, and the cause is not measured
        # (chip_flash_probe.py)
        torch.cuda.synchronize()
        time.sleep(1.0)
        return cuda_ms(fn, 200)

    ms = {
        "K3": idle_then_ms(lambda: flash_fwd_cuda(q, k, v)),
        "K4": idle_then_ms(lambda: flash_bwd_dq_cuda(q, k, v, do, lse, delta)),
        "K5": idle_then_ms(lambda: flash_bwd_dkv_cuda(q, k, v, do, lse, delta)),
    }
    plain_fwd = cuda_ms(lambda: flash_fwd_reference(q, k, v), 10, warmup=1)
    plain_bwd = cuda_ms(lambda: flash_bwd_reference(q, k, v, out, lse, do), 5, warmup=1)
    plain = {"K3": plain_fwd, "K4": plain_bwd, "K5": plain_bwd}
    library = {"K3": yard["fwd_ms"], "K4": yard["bwd_ms"], "K5": yard["bwd_ms"]}
    recs = {}
    for name in ms:
        bound_ms, bound_by = yard["bounds"][name]
        recs[name] = dict(max_abs_err=errs[name], ms=ms[name], plain_ms=plain[name],
                          library_ms=library[name], bound_ms=bound_ms, bound_by=bound_by)
        print(f"{name} timing bf16 bh={TRAIN_B * TRAIN_H} S={TRAIN_S} D={TRAIN_D}: kernel "
              f"{ms[name]:.4f} ms ({yard['ops'][name] / ms[name] / 1e9:.1f} TFLOP/s), bound "
              f"{bound_ms:.4f} ms ({bound_by}, {ms[name] / bound_ms:.2f}x), plain {plain[name]:.4f} ms, "
              f"library {library[name]:.4f} ms (kernel/library {ms[name] / library[name]:.3f}x)")
    print(f"K4 + K5 {ms['K4'] + ms['K5']:.4f} ms against SDPA's backward {yard['bwd_ms']:.4f} ms: "
          f"{(ms['K4'] + ms['K5']) / yard['bwd_ms']:.3f}x")
    print("flash build report (-Xptxas -v):")
    flash_build_report()
    return recs


def flash_launches() -> tuple[int, int, int]:
    return flash_fwd_cuda.launches, flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches


def reset_flash_launches() -> None:
    flash_fwd_cuda.launches = flash_bwd_dq_cuda.launches = flash_bwd_dkv_cuda.launches = 0


def expected_flash_launches(cfg: GPTConfig, steps: int) -> tuple[int, int, int]:
    """K3, K4, K5 launches for ``steps`` training steps: one of each per
    layer, and K3 once more per layer under remat "full" and "dots" (the
    backward recomputes the flash forward; the other policies keep its
    out and lse)."""
    k3 = (2 if cfg.remat and cfg.remat_policy in ("full", "dots") else 1) * cfg.n_layers * steps
    return k3, cfg.n_layers * steps, cfg.n_layers * steps


def train_steps(cfg: GPTConfig, params, batches, lr: float):
    """``build_train_step`` with ``adamw(lr)`` over ``batches``: (losses,
    the state after the last step)."""
    init_fn, step_fn = build_train_step(lambda p, t: gpt_loss(cfg, p, t), adamw(lr))
    state = init_fn(params)
    losses = []
    for b in batches:
        state, loss = step_fn(state, b)
        losses.append(loss.item())
    return losses, state


def fp32_training_identity() -> None:
    """Phase 16: a narrow fp32 GPT (vocab 4096, seq 256, d 256, 4 heads of
    64, 2 layers) takes 3 AdamW steps (lr 1e-4) through K3-K5
    (``attn_impl="flash"``) and 3 through the einsum path (``"xla"``) from
    the same params and tokens, under remat "full" and "attn". Losses agree
    within 1e-5 relative at every step; parameters within 1e-4 after the
    last, except the key slice of the qkv bias: its gradient is zero in
    exact arithmetic (the softmax ignores a constant added to a query's
    scores), so both paths compute rounding noise there, which AdamW's
    normalised update turns into steps of up to lr; it is held within
    2 x lr x steps."""
    lr, steps = 1e-4, 3
    rng = np.random.RandomState(12)
    base = GPTConfig(vocab_size=4096, seq_len=256, d_model=256, n_layers=2, n_heads=4,
                     dtype="float32")
    batches = [torch.from_numpy(rng.randint(0, base.vocab_size, (4, base.seq_len + 1))).cuda()
               for _ in range(steps)]
    init = gpt_init(base, torch.Generator(device="cuda").manual_seed(4))
    d = base.d_model
    for policy in ("full", "attn"):
        runs = {}
        for impl in ("flash", "xla"):
            cfg = dataclasses.replace(base, remat_policy=policy, attn_impl=impl)
            params = copy.deepcopy(init)
            reset_flash_launches()
            losses, state = train_steps(cfg, params, batches, lr)
            runs[impl] = (losses, list(state.params.named_parameters()), flash_launches())
        (lf, pf, nf), (lx, px, nx) = runs["flash"], runs["xla"]
        want = expected_flash_launches(dataclasses.replace(base, remat_policy=policy), steps)
        if nf != want or nx != (0, 0, 0):
            raise AssertionError(f"fp32 training {policy}: flash launches {nf} (expected {want}), "
                                 f"xla run {nx}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(lf, lx))
        worst, worst_key = 0.0, 0.0
        for (name, a), (_, b) in zip(pf, px):
            diff = (a.detach() - b.detach()).abs()
            if name.endswith("attn_qkv.bias"):
                worst_key = max(worst_key, diff[d:2 * d].max().item())
                diff = torch.cat([diff[:d], diff[2 * d:]])
            worst = max(worst, diff.max().item())
        print(f"fp32 training identity remat={policy}: losses flash {[f'{x:.6f}' for x in lf]} vs "
              f"xla {[f'{x:.6f}' for x in lx]} (max rel {rel:.3g}); params max abs diff {worst:.3g} "
              f"(key bias {worst_key:.3g}); K3/K4/K5 launches {nf}")
        if not (rel <= 1e-5 and worst <= 1e-4 and worst_key <= 2 * lr * steps):
            raise AssertionError(f"fp32 training {policy}: flash and xla paths disagree")


def qkv_grads(cfg: GPTConfig, params, tokens, mesh=None):
    """``gpt_loss`` (on ``mesh``, if given) and its gradient for each
    layer's qkv weight: (loss, [(3 d, d) fp32 per layer])."""
    loss = gpt_loss(cfg, params, tokens, mesh)
    return loss.item(), torch.autograd.grad(loss, [b.attn_qkv.weight for b in params.blocks])


def qkv_grad_gaps(got, want, d: int) -> dict:
    """The largest relative gap over layers, ||got - want|| / ||want||, of
    the q, k and v rows of the qkv weight gradients. The q rows take their
    gradient from K4's dq, the k and v rows from K5's dk and dv, and all
    three from K3's out and lse."""
    return {name: max(((g[i * d:(i + 1) * d] - w[i * d:(i + 1) * d]).norm()
                       / w[i * d:(i + 1) * d].norm()).item() for g, w in zip(got, want))
            for i, name in enumerate("qkv")}


def train_406m_tokens() -> np.ndarray:
    """The 406M step's batch: (26, 1025) int64 tokens from numpy seed 13."""
    rng = np.random.RandomState(13)
    return rng.randint(0, TRAIN_406M.vocab_size, (TRAIN_B, TRAIN_406M.seq_len + 1))


def train_406m(card: str) -> dict:
    """Phase 17: the 406M training shape of bench.py (vocab 50304, seq 1024,
    d 1024, 24 layers, 16 heads, remat "attn", one CE chunk), bf16, random
    weights from seed 0, random tokens (26, 1025) from numpy. Step 0's
    gradients of every layer's qkv weight are held against the einsum
    attention path's (``QKV_GRAD_GAP``), and its loss too; then one warmup
    step, 5 timed steps through ``build_train_step`` and ``adamw(1e-4)``
    with the launch counts from 0, then 12 steps alternating remat "attn"
    and "attn_qkv", then 2 unprofiled and 2 profiled steps."""
    cfg = TRAIN_406M
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in params.parameters())
    tokens = torch.from_numpy(train_406m_tokens()).cuda()
    # the einsum path under remat "full": the same values, with one block's
    # (26, 16, 1024, 1024) probabilities alive at a time
    _, flash_grads = qkv_grads(cfg, params, tokens)
    xla_loss, xla_grads = qkv_grads(dataclasses.replace(cfg, attn_impl="xla", remat_policy="full"),
                                    params, tokens)
    gaps = qkv_grad_gaps(flash_grads, xla_grads, cfg.d_model)
    xla_qkv_grads = [g.cpu() for g in xla_grads]  # phase 34 (g) holds ring attention's against them
    del flash_grads, xla_grads
    print(f"406M step 0 qkv weight gradients, flash vs xla, largest relative gap over layers: "
          + ", ".join(f"{n} {g:.3g}" for n, g in gaps.items()) + f" (limit {QKV_GRAD_GAP})")
    if not all(g <= QKV_GRAD_GAP for g in gaps.values()):
        raise AssertionError(f"406M step 0: qkv gradients through K3-K5 differ from xla's: {gaps}")

    init_fn, step_fn = build_train_step(lambda p, t: gpt_loss(cfg, p, t), adamw(1e-4))
    state = init_fn(params)
    t0 = time.perf_counter()
    state, loss = step_fn(state, tokens)
    losses = [loss.item()]
    warm_s = time.perf_counter() - t0
    # the two attention paths round at other places (the kernels' P in bf16,
    # the einsum's probabilities in bf16), which moves the mean loss (~11.33)
    # by well under 1e-2. At random init the loss is about ln V + 1/2 whatever
    # attention computes, so this checks the step's plumbing; the gradients
    # above check attention.
    if not abs(losses[0] - xla_loss) <= 1e-2:
        raise AssertionError(f"406M step 0: flash loss {losses[0]} vs xla {xla_loss}")

    # the main path's run: every count from 0
    reset_flash_launches()
    steps = 5
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, loss = step_fn(state, tokens)
        losses.append(loss.item())  # ends in a host sync
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = flash_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = expected_flash_launches(cfg, steps)
    if launches != want:
        raise AssertionError(f"406M: K3/K4/K5 launched {launches} times over {steps} steps, expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"406M: non-finite loss {losses}")
    ms = float(np.mean(step_ms))
    tok_s = TRAIN_B * cfg.seq_len / (ms / 1e3)
    L, d, V, s = cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.seq_len
    flops_per_token = 6 * (12 * L * d * d + d * V) + 6 * L * s * d
    mfu = flops_per_token * tok_s / PEAK_OPS_PER_S[torch.bfloat16]
    print(
        f"406M training [{card}]: {n_params / 1e6:.1f}M params, batch {TRAIN_B} x {s}; warmup step "
        f"{warm_s:.3f} s; step {ms:.3f} ms (steps {[f'{x:.1f}' for x in step_ms]}), "
        f"{tok_s:.0f} tokens/s, MFU {mfu:.4f} (6*(12*L*d^2 + d*V) + 6*L*s*d = "
        f"{flops_per_token / 1e9:.3f} GFLOP per token, no remat recompute, over 989 TFLOP/s); "
        f"losses {[f'{x:.6f}' for x in losses]} (step 0 xla {xla_loss:.6f}, tolerance 1e-2); peak memory "
        f"{peak_gb:.2f} GB; K3/K4/K5 launches {launches} = {want} expected"
    )

    # remat "attn" (ln1 and the qkv projection recomputed) against
    # "attn_qkv" (the qkv projection kept, the port's "attn" before its
    # repair), in turns on the same state: the step and its memory peak
    # above what it found allocated
    qkv_cfg = dataclasses.replace(cfg, remat_policy="attn_qkv")
    _, qkv_step_fn = build_train_step(lambda p, t: gpt_loss(qkv_cfg, p, t), adamw(1e-4))
    policy_ms, policy_peak = {"attn": [], "attn_qkv": []}, {"attn": 0, "attn_qkv": 0}
    for policy in ("attn", "attn_qkv", "attn_qkv", "attn") * 3:
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        state, loss = (step_fn if policy == "attn" else qkv_step_fn)(state, tokens)
        loss.item()
        policy_ms[policy].append((time.perf_counter() - t0) * 1e3)
        policy_peak[policy] = max(policy_peak[policy], torch.cuda.max_memory_allocated() - before)
    print("  remat policy in turns (attn, attn_qkv, attn_qkv, attn) x 3: " + "; ".join(
        f"{p} median {np.median(v):.3f} ms (steps {[f'{x:.1f}' for x in v]}), peak {policy_peak[p] / 1e9:.3f} GB "
        f"above the train state" for p, v in policy_ms.items())
        + f"; attn_qkv / attn {np.median(policy_ms['attn_qkv']) / np.median(policy_ms['attn']):.4f}")

    # where the step's time goes: 2 steps without the profiler, 2 with it
    def run(n) -> float:
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state, loss = step_fn(state, tokens)
        loss.item()
        return (time.perf_counter() - t0) * 1e3 / n

    wall_ms = run(2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_wall_ms = run(2)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def dev_ms(events) -> float:
        return sum(e.self_device_time_total for e in events) / 1e3 / 2

    busy = dev_ms(kernels)
    print(f"  profile: {wall_ms:.3f} ms/step without the profiler, {prof_wall_ms:.3f} with it")
    if busy == 0:
        print("  device time not measured (the profiler saw no device activity)")
    else:
        gemm_words = ("gemm", "nvjet", "xmma", "cutlass")
        gemm = dev_ms([e for e in kernels if any(w in e.key.lower() for w in gemm_words)])
        flash = {n: dev_ms([e for e in kernels if f"{key}_kernel" in e.key])
                 for n, key in (("K3", "flash_fwd"), ("K4", "flash_bwd_dq"), ("K5", "flash_bwd_dkv"))}
        n_launch = sum(e.count for e in kernels) / 2
        print(f"  device busy {busy:.3f} ms/step (idle share {1 - busy / wall_ms:.3f} of the "
              f"unprofiled step), {n_launch:.0f} device ops/step; GEMM {gemm:.3f} ms, K3 "
              f"{flash['K3']:.3f} ms, K4 {flash['K4']:.3f} ms, K5 {flash['K5']:.3f} ms, other "
              f"{busy - gemm - sum(flash.values()):.3f} ms per step")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"  {dev_ms([e]):8.3f} ms/step  {e.count // 2:5d}/step  {e.key[:90]}")
        # the same device time by the host op that launched each kernel
        ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU
               and e.self_device_time_total > 0]
        print("  by launching op: " + "; ".join(
            f"{e.key} {dev_ms([e]):.3f} ms ({e.count // 2}/step)"
            for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:12]))

    # the fused CE's share: its forward and backward alone at this step's
    # shape (its three products are in the GEMM figure above as well)
    x = torch.randn(TRAIN_B * s, d, device=tokens.device, dtype=cfg.torch_dtype,
                    requires_grad=True)
    w = state.params.lm_head.weight
    targets = tokens[:, 1:].reshape(-1)

    def ce_step():
        losses = fused_softmax_cross_entropy(x, w.t(), targets, cfg.ce_chunks)
        torch.autograd.grad(losses.mean(), (x, w))

    print(f"  fused CE forward + backward {cuda_ms(ce_step, 5, warmup=1):.3f} ms per step "
          f"({TRAIN_B * s} tokens x vocab {V}, {cfg.ce_chunks} chunk; CUDA events, alone)")
    return dict(launches=dict(zip(("K3", "K4", "K5"), launches)), losses=losses[:steps + 1],
                step_ms=step_ms, n_params=n_params, xla_qkv_grads=xla_qkv_grads, xla_loss=xla_loss)


# ---------------------------------------------------------------------------
# phase 25: Train over the runtime
# ---------------------------------------------------------------------------

TRAIN25_STEPS = 6  # steps 0-5, phase 17's six (0-11, over two runs, until phase 32 came)
TRAIN25_CKPT_AT = 2  # the step after which the train state is checkpointed (3 steps in)
TRAIN25_DIE_AFTER = 3  # the first worker dies right after reporting this step
COLLECTIVE_BYTES = 64 << 20  # (d): each rank's fp32 tensor


def train_loop_406m(config: dict) -> None:
    """Phase 25's train loop, run by the ``TorchTrainer`` worker: phase 17's
    model and step (``TRAIN_406M`` at batch 26, ``gpt_init`` with a CUDA
    generator seeded 0, ``build_train_step(gpt_loss, adamw(1e-4))``) over
    the batches of ``get_dataset_shard("train")``, each moved to the card
    in the loop. It resumes from ``get_checkpoint()`` when there is one,
    saves the train state after step ``ckpt_at`` (``save_state``), and
    reports after every step: the loss, the step's ms (host clock ending in
    the loss's sync), the worker's K3/K4/K5 launches counted from 0 at the
    loop's start, its peak memory and its clock. On a first attempt with
    ``die_after`` set, the worker process ends with ``os._exit(1)`` right
    after reporting that step, its clock written to ``death_file``
    first."""
    t_enter = time.time()
    from ray_tpu_torch import train

    # a fresh worker keeps torch's default, no TF32, which main() sets for
    # phase 17 (and the loop names no ``torch.backends``: cloudpickle cannot
    # carry its module objects by value)
    cfg = config["cfg"]
    t0 = time.perf_counter()
    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0))
    init_fn, step_fn = build_train_step(lambda p, t: gpt_loss(cfg, p, t), adamw(1e-4))
    state = init_fn(params)
    build_s = time.perf_counter() - t0
    start, load_s = 0, None
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        t0 = time.perf_counter()
        state = train.load_state(ckpt, state)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        start = state.step
    reset_flash_launches()
    torch.cuda.reset_peak_memory_stats()
    shard = train.get_dataset_shard("train")
    if config.get("from_dataset"):
        # phase 26: a Dataset's batches, moved to the card by its iterator
        batches = (b["tokens"] for b in shard.iter_torch_batches(batch_size=TRAIN_B, drop_last=True))
    else:
        batches = (torch.from_numpy(b).cuda() for b in shard)
    for i, tokens in enumerate(batches):
        if i < start:
            continue
        t0 = time.perf_counter()
        state, loss = step_fn(state, tokens)
        loss = loss.item()  # ends in a host sync
        step_ms = (time.perf_counter() - t0) * 1e3
        saved = None
        if i == config["ckpt_at"]:
            stage = tempfile.mkdtemp(dir=config["stage"])
            t0 = time.perf_counter()
            saved = train.save_state(state, stage)
            save_s = time.perf_counter() - t0
            ckpt_bytes = sum(f.stat().st_size for f in Path(stage).iterdir())
        metrics = dict(step=i, loss=loss, ms=step_ms, launches=list(flash_launches()), resumed_from=start,
                       on_card=tokens.is_cuda, rows=tokens.shape[0],
                       wall=time.time(), enter_wall=t_enter, build_s=build_s, load_s=load_s,
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        if saved is not None:
            metrics.update(save_s=save_s, ckpt_bytes=ckpt_bytes)
        train.report(metrics, checkpoint=saved)
        if saved is not None:
            shutil.rmtree(stage)  # committed into the trial directory by now
        if i == config["die_after"] and start == 0:
            Path(config["death_file"]).write_text(repr(time.time()))
            os._exit(1)  # a real process death, right after reporting this step


def fit_406m(storage: str, name: str, die_after: int = -1, dataset=None) -> tuple:
    """One ``TorchTrainer`` run of ``train_loop_406m`` on one ``num_gpus=1``
    worker: (the ``Result``, the clock at ``fit()``, the death file). Fed
    phase 17's batch ``TRAIN25_STEPS`` times as a list, or ``dataset``
    (phase 26). Only the run whose worker dies (``die_after``) saves a
    checkpoint: it is the one that resumes from it."""
    from ray_tpu_torch import train

    stage = tempfile.mkdtemp(dir=storage, prefix="stage_")
    death_file = os.path.join(stage, "died_at")
    batches = [train_406m_tokens()] * TRAIN25_STEPS if dataset is None else dataset
    trainer = train.TorchTrainer(
        train_loop_406m,
        train_loop_config=dict(cfg=TRAIN_406M, ckpt_at=TRAIN25_CKPT_AT if die_after >= 0 else -1,
                               die_after=die_after, stage=stage, death_file=death_file,
                               from_dataset=dataset is not None),
        scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
        run_config=train.RunConfig(
            name=name, storage_path=storage, verbose=1,
            checkpoint_config=train.CheckpointConfig(num_to_keep=1),
            failure_config=train.FailureConfig(max_failures=1 if die_after >= 0 else 0)),
        datasets={"train": batches},
    )
    t_fit = time.time()
    result = trainer.fit()
    return result, t_fit, death_file


def card_released(free_before: int, cache_bytes: int, label: str, timeout_s: float = 60.0) -> None:
    """(c): after ``fit()`` the ``GPU`` resource is free again and the card's
    free memory is back to what it was before the phase, within
    this process's allocator cache (the worker's process and context are gone)."""
    deadline = time.monotonic() + timeout_s
    while True:
        gpu = gpu_available()
        free = torch.cuda.mem_get_info()[0]
        if gpu == 1.0 and free >= free_before - cache_bytes:
            break
        if time.monotonic() > deadline:
            raise AssertionError(f"{label}: GPU resource {gpu}, card free {free / 1e9:.3f} GB against "
                                 f"{free_before / 1e9:.3f} GB before the phase (cache {cache_bytes / 1e9:.3f} GB)")
        time.sleep(0.2)
    print(f"(c) {label}: GPU resource free again ({gpu}), card free {free / 1e9:.3f} GB against "
          f"{free_before / 1e9:.3f} GB before the phase (allocator cache {cache_bytes / 1e9:.3f} GB), "
          f"{compute_apps() or 'no'} compute apps")


class CollectiveMember:
    """(d): a CPU actor in a host collective group."""

    def __init__(self, rank: int, world: int, group: str):
        from ray_tpu_torch import collective

        self.rank, self.world, self.group = rank, world, group
        collective.init_collective_group(world, rank, group_name=group)

    @staticmethod
    def values(rank: int, n: int) -> np.ndarray:
        # integers: every sum is exact in fp32, whatever the order
        return np.random.RandomState(rank).randint(-1000, 1000, n).astype(np.float32)

    def allreduce(self, n: int, ring: bool) -> tuple:
        """One allreduce of an (n,) fp32 CPU tensor, by the ring or by
        fan-in (the ring threshold put above or below the tensor in this
        process): (its result equals numpy's sum, the path taken, seconds)."""
        from ray_tpu_torch import collective
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        x = torch.from_numpy(self.values(self.rank, n))
        GLOBAL_CONFIG.collective_ring_threshold_bytes = 1 if ring else 4 * n + 1
        collective.barrier(group_name=self.group)
        t0 = time.perf_counter()
        out = collective.allreduce(x, group_name=self.group, timeout=300.0)
        s = time.perf_counter() - t0
        want = sum(self.values(r, n) for r in range(self.world))
        return out is x and np.array_equal(out.numpy(), want), s


def collective_on_the_runtime() -> None:
    """(d): two CPU actors allreduce 64 MB fp32 torch tensors, by fan-in and
    by the ring; the results equal numpy's sums."""
    member = ray_tpu_torch.remote(num_cpus=1)(CollectiveMember)
    world, n = 2, COLLECTIVE_BYTES // 4
    members = [member.remote(r, world, "phase25") for r in range(world)]
    for ring in (False, True):
        out = ray_tpu_torch.get([m.allreduce.remote(n, ring) for m in members], timeout=600)
        if not all(ok for ok, _ in out):
            raise AssertionError(f"(d) allreduce by {'ring' if ring else 'fan-in'}: a result differs from numpy's sum")
        slowest = max(s for _, s in out)
        print(f"(d) allreduce of {COLLECTIVE_BYTES / 2**20:.0f} MB fp32 torch tensors over {world} CPU actors by "
              f"{'the ring' if ring else 'fan-in'}: equal to numpy's sum on every rank; slowest rank "
              f"{slowest * 1e3:.1f} ms, {COLLECTIVE_BYTES / slowest / 1e9:.3f} GB/s of tensor per rank")
    for m in members:
        ray_tpu_torch.kill(m)


def train_over_runtime(card: str, phase17: dict) -> dict:
    """Phase 25: ``TorchTrainer`` over the port's runtime with the card as one
    ``GPU``: one run of phase 17's six steps (model and batch) on one
    ``num_gpus=1`` worker under ``FailureConfig(max_failures=1)``, the train
    state checkpointed after step 2 (``CheckpointConfig(num_to_keep=1)``).
    (a) its first worker: losses of steps 0-3 equal phase 17's bit for bit,
    K3/K4/K5 launches as expected, finite losses; the median step against
    phase 17's, ``fit()`` to the first report, peak memory, the
    checkpoint's bytes, save and commit times; it calls ``os._exit(1)``
    right after reporting step 3. (b) the group restarts from step 2's
    checkpoint: steps 3-5 equal phase 17's bit for bit, the new worker's
    launches as expected; the death to the first resumed report, split.
    (c) after ``fit()`` the GPU and its memory are released. (d) the host
    collectives on CPU actors. (Until phase 32 came, an uninterrupted run
    of 12 steps, checkpointing too, came first, and the failover run's
    resumed steps were held against it.)"""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    free_before = torch.cuda.mem_get_info()[0]
    cache_bytes = max(torch.cuda.memory_reserved() - torch.cuda.memory_allocated(), 64 << 20)
    ray_tpu_torch.init()
    res = ray_tpu_torch.cluster_resources()
    if res.get("GPU") != 1.0:
        raise AssertionError(f"ray_tpu_torch.init() offers GPU {res.get('GPU')}, expected 1")
    storage = tempfile.mkdtemp(prefix="phase25_")
    n_params = phase17["n_params"]
    want_bytes = 12 * n_params  # fp32 masters and AdamW's two moments
    disk = shutil.disk_usage(storage)
    print(f"storage {storage}: {disk.free / 1e9:.1f} GB free of {disk.total / 1e9:.1f} GB; a checkpoint is "
          f"~{want_bytes / 1e9:.2f} GB (12 bytes a parameter), staged and committed: twice that")
    if disk.free < 2.5 * want_bytes:
        raise AssertionError(f"{storage} has {disk.free / 1e9:.1f} GB free: too little for two checkpoints")
    try:
        result, t_fit, death_file = fit_406m(storage, "failover", die_after=TRAIN25_DIE_AFTER)
        if result.error is not None:
            raise AssertionError(f"fit() failed: {result.error!r}")
        hist = [h["metrics"] for h in result.metrics_history]
        first = [m for m in hist if m["resumed_from"] == 0]
        resumed = [m for m in hist if m["resumed_from"] > 0]
        if [m["step"] for m in first] != list(range(TRAIN25_DIE_AFTER + 1)) or \
                [m["step"] for m in resumed] != list(range(TRAIN25_CKPT_AT + 1, TRAIN25_STEPS)):
            raise AssertionError(f"reported steps {[(m['step'], m['resumed_from']) for m in hist]}")
        want17 = phase17["losses"]
        if len(want17) != TRAIN25_STEPS:
            raise AssertionError(f"phase 17 has {len(want17)} losses, the run {TRAIN25_STEPS} steps")

        # (a) the first worker, to its death
        got_a = [m["loss"] for m in first]
        same17 = got_a == want17[:len(first)]
        saved = first[TRAIN25_CKPT_AT]
        # the report after the checkpoint's waits for its commit
        after = first[TRAIN25_CKPT_AT + 1]
        commit_s = after["wall"] - saved["wall"] - after["ms"] / 1e3
        # the trainer's time between two steps: report, ack and the next
        # batch's copy (the clock of step i's report minus step i - 1's,
        # less step i), within each worker, the commit's step left out
        between = [m["wall"] - prev["wall"] - m["ms"] / 1e3 for run in (first, resumed)
                   for prev, m in zip(run, run[1:]) if m is not after]
        f_launch = tuple(first[-1]["launches"])
        want_f = expected_flash_launches(TRAIN_406M, len(first))
        ms = [m["ms"] for m in first[1:]]
        print(f"(a) TorchTrainer, 1 num_gpus=1 worker, FailureConfig(max_failures=1), {TRAIN25_STEPS} steps "
              f"[{card}]: the first worker's losses {[f'{x:.6f}' for x in got_a]} "
              f"{'equal' if same17 else 'DIFFER from'} phase 17's steps 0-{len(first) - 1} bit for bit; median step "
              f"{np.median(ms):.3f} ms against phase 17's {np.median(phase17['step_ms']):.3f} ms "
              f"({np.median(ms) / np.median(phase17['step_ms']):.3f}x; steps {[f'{x:.1f}' for x in ms]}); "
              f"K3/K4/K5 launches {f_launch} = {want_f} expected; fit() to the first report "
              f"{first[0]['wall'] - t_fit:.2f} s (worker start to loop {first[0]['enter_wall'] - t_fit:.2f} s, "
              f"model built on the card {first[0]['build_s']:.2f} s, step 0 {first[0]['ms']:.1f} ms); "
              f"the trainer between two steps {np.median(between) * 1e3:.2f} ms (median; report, ack, batch to "
              f"the card); checkpoint after step {TRAIN25_CKPT_AT}: {saved['ckpt_bytes'] / 1e9:.3f} GB "
              f"({saved['ckpt_bytes'] / n_params:.2f} bytes a parameter) saved in {saved['save_s']:.2f} s, "
              f"committed into the trial directory (and the stage deleted) in {commit_s:.2f} s; worker peak "
              f"memory {max(m['peak_gb'] for m in hist):.2f} GB")
        if not same17:
            raise AssertionError(f"(a) losses {got_a} differ from phase 17's {want17}")
        if f_launch != want_f:
            raise AssertionError(f"(a) K3/K4/K5 launched {f_launch} times in the first worker, expected {want_f}")
        if not all(np.isfinite([m["loss"] for m in hist])):
            raise AssertionError(f"(a) non-finite loss {[m['loss'] for m in hist]}")

        # (b) the group restarted from the checkpoint
        died_at = float(Path(death_file).read_text())
        ckpt_step = result.checkpoint.get_metadata().get("step") if result.checkpoint else None
        got = [m["loss"] for m in resumed]
        same_b = got == want17[TRAIN25_CKPT_AT + 1:]
        r0 = resumed[0]
        r_launch = tuple(resumed[-1]["launches"])
        want_r = expected_flash_launches(TRAIN_406M, len(resumed))
        print(f"(b) worker os._exit(1) after reporting step {TRAIN25_DIE_AFTER}; the group restarted from "
              f"step {TRAIN25_CKPT_AT}'s checkpoint (train state {ckpt_step} steps in); resumed steps "
              f"{[m['step'] for m in resumed]} losses {[f'{x:.6f}' for x in got]} "
              f"{'equal' if same_b else 'DIFFER from'} phase 17's bit for bit; death to the first resumed report "
              f"{r0['wall'] - died_at:.2f} s = group restart and worker start to the loop "
              f"{r0['enter_wall'] - died_at:.2f} s + model built on the card {r0['build_s']:.2f} s + checkpoint "
              f"load {r0['load_s']:.2f} s + first step {r0['ms'] / 1e3:.2f} s + the rest "
              f"{r0['wall'] - r0['enter_wall'] - r0['build_s'] - r0['load_s'] - r0['ms'] / 1e3:.2f} s; "
              f"K3/K4/K5 launches in the new worker {r_launch} = {want_r} expected")
        if not same_b:
            raise AssertionError(f"(b) resumed losses {got} differ from phase 17's {want17[TRAIN25_CKPT_AT + 1:]}")
        if ckpt_step is None or ckpt_step < TRAIN25_CKPT_AT + 1:
            raise AssertionError(f"(b) the last checkpoint is {ckpt_step} steps in, expected step "
                                 f"{TRAIN25_CKPT_AT}'s ({TRAIN25_CKPT_AT + 1} steps in) or later")
        if r_launch != want_r:
            raise AssertionError(f"(b) K3/K4/K5 launched {r_launch} times in the new worker, expected {want_r}")
        card_released(free_before, cache_bytes, "after the run")

        # (d) host collectives on the runtime
        collective_on_the_runtime()
    finally:
        shutil.rmtree(storage, ignore_errors=True)
        ray_tpu_torch.shutdown()
    print(f"phase 25 [{card}]: {time.perf_counter() - t_phase:.1f} s")
    losses = [m["loss"] for m in first[:TRAIN25_CKPT_AT + 1] + resumed]  # the run's steps 0-5
    return dict(launches=dict(zip(("K3", "K4", "K5"), tuple(a + b for a, b in zip(f_launch, r_launch)))),
                losses=losses, between_ms=np.median(between) * 1e3)


# ---------------------------------------------------------------------------
# phase 26: Data into Train
# ---------------------------------------------------------------------------

# (a): 156 rows = phase 17's batch 6 times (TRAIN25_STEPS), 12 rows a file
# (312 rows, 24 a file, until phase 32 came)
DATA26_FILES, DATA26_ROWS = 13, 12
SHUFFLE_FILES, SHUFFLE_ROWS, SHUFFLE_BATCH = 64, 4096, 256  # (b): 262,144 rows of 1025 int32 tokens
HASH_MUL = 0x9E3779B97F4A7C15 - (1 << 64)  # (b): a row hash's odd multiplier, as a signed int64


def write_406m_corpus(d: str) -> None:
    """(a): phase 17's (26, 1025) int64 batch ``TRAIN25_STEPS`` times over,
    as 13 .npy files of 12 rows: the trainer's 26-row batches straddle files
    and blocks."""
    tokens = np.concatenate([train_406m_tokens()] * TRAIN25_STEPS)
    assert len(tokens) == DATA26_FILES * DATA26_ROWS
    for i in range(DATA26_FILES):
        np.save(os.path.join(d, f"part-{i:03d}.npy"), tokens[i * DATA26_ROWS:(i + 1) * DATA26_ROWS])


def hash_weights() -> np.ndarray:
    return np.random.RandomState(1).randint(1, 1 << 62, TRAIN_406M.seq_len + 1, dtype=np.int64)


def rows_hash(x, w):
    """Sum of a mixed hash of each row (int64, wrapping): order-free, so a
    permutation of the rows keeps it and a lost or repeated row moves it.
    Runs on numpy arrays and on torch tensors alike."""
    r = (x * w).sum(1)
    r = r ^ (r >> 29)
    return (r * HASH_MUL).sum()


def write_shuffle_corpus(d: str) -> tuple:
    """(b): 64 files of 4096 rows x 1025 int32 tokens from numpy seed 0
    (1.07 GB): (numpy's hash of every row, the corpus's first 256 rows)."""
    rng = np.random.RandomState(0)
    w = hash_weights()
    total = np.zeros(1, dtype=np.int64)
    first = None
    for i in range(SHUFFLE_FILES):
        x = rng.randint(0, TRAIN_406M.vocab_size, (SHUFFLE_ROWS, TRAIN_406M.seq_len + 1)).astype(np.int32)
        np.save(os.path.join(d, f"part-{i:03d}.npy"), x)
        total += rows_hash(x.astype(np.int64), w)
        if first is None:
            first = x[:SHUFFLE_BATCH].astype(np.int64)
    return int(total[0]), first


class StorePeak:
    """Polls the object store's arena use and /dev/shm's on a thread: the
    peak of each while a pipeline runs."""

    def __init__(self):
        self.arena = shm_store.attach_arena(shm_store._write_arena_name)
        self.peak_arena = self.peak_shm = 0
        self.shm0 = shutil.disk_usage("/dev/shm").used
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()

    def _poll(self):
        while not self._stop.wait(0.01):
            self.peak_arena = max(self.peak_arena, self.arena.used)
            self.peak_shm = max(self.peak_shm, shutil.disk_usage("/dev/shm").used - self.shm0)

    def stop(self):
        self._stop.set()
        self._thread.join()


def spilled_objects() -> int:
    from ray_tpu_torch._private.head import _object_metrics

    return int(sum(_object_metrics()["spills"]._snapshot()["data"].values()))


def tokens_to_card(ds, w_card) -> tuple:
    """(b): a Dataset's rows to the card as int64 batches of 256 through
    ``iter_torch_batches`` (the card is its default device): (rows, the rows'
    hash computed on the card, the first batch on the host, seconds from
    the first read to the last batch on the card)."""
    t0 = time.perf_counter()
    n, first = 0, None
    total = torch.zeros((), dtype=torch.int64, device="cuda")
    for batch in ds.iter_torch_batches(batch_size=SHUFFLE_BATCH, dtypes={"tokens": torch.int64}):
        x = batch["tokens"]
        if not x.is_cuda or x.dtype != torch.int64:
            raise AssertionError(f"(b) a batch arrived as {x.dtype} on {x.device}")
        if first is None:
            first = x.cpu()
        total += rows_hash(x, w_card)
        n += x.shape[0]
    torch.cuda.synchronize()
    return n, int(total.item()), first, time.perf_counter() - t0


def shuffle_to_card(card: str) -> None:
    """(b): the 1.07 GB corpus read and sent to the card, then read,
    shuffled globally and sent to the card: every row arrives once in both,
    the shuffled first batch differs from the corpus's; rows/s, GB/s, the
    shuffle's share and the store's peak use."""
    from ray_tpu_torch import data

    corpus = tempfile.mkdtemp(prefix="phase26b_")
    try:
        t0 = time.perf_counter()
        want_hash, first_rows = write_shuffle_corpus(corpus)
        rows = SHUFFLE_FILES * SHUFFLE_ROWS
        nbytes = rows * (TRAIN_406M.seq_len + 1) * 4
        print(f"(b) corpus: {SHUFFLE_FILES} files x {SHUFFLE_ROWS} rows x {TRAIN_406M.seq_len + 1} int32 tokens "
              f"(numpy seed 0), {nbytes / 1e9:.3f} GB, written and hashed in {time.perf_counter() - t0:.1f} s")
        w_card = torch.from_numpy(hash_weights()).cuda()
        spills0 = spilled_objects()
        peak = StorePeak()
        try:
            # plain, shuffled, plain: the share is read against the later,
            # warm plain run
            runs = [tokens_to_card(data.read_numpy(corpus, column="tokens"), w_card),
                    tokens_to_card(data.read_numpy(corpus, column="tokens").random_shuffle(seed=0), w_card),
                    tokens_to_card(data.read_numpy(corpus, column="tokens"), w_card)]
        finally:
            peak.stop()
        shuffled, plain = runs[1], runs[2]
        for label, (n, got_hash, first, secs) in zip(("read", "read + random_shuffle", "read again"), runs):
            if n != rows or got_hash != want_hash:
                raise AssertionError(f"(b) {label}: {n} rows with hash {got_hash} arrived, expected {rows} rows "
                                     f"with numpy's hash {want_hash}")
        if not (torch.equal(runs[0][2], torch.from_numpy(first_rows)) and torch.equal(plain[2], runs[0][2])):
            raise AssertionError("(b) without the shuffle the first batch is not the corpus's first 256 rows")
        if torch.equal(shuffled[2], torch.from_numpy(first_rows)):
            raise AssertionError("(b) the shuffled first batch equals the corpus's first 256 rows")
        arena = peak.arena
        share = (shuffled[3] - plain[3]) / shuffled[3]
        for label, (n, _, _, secs) in zip(("read -> card", "read -> random_shuffle -> card", "read -> card again"),
                                          runs):
            print(f"(b) {label} [{card}]: {n} rows, each once (row count and the card's hash equal numpy's "
                  f"{want_hash}); {secs:.2f} s from the first read to the last batch on the card, "
                  f"{n / secs:.0f} rows/s, {nbytes / secs / 1e9:.3f} GB/s of int32 tokens")
        print(f"(b) the shuffled first batch differs from the corpus's first 256 rows; the shuffle's share of "
              f"the shuffled run {share:.3f} ({shuffled[3] - plain[3]:.2f} s over the later plain read); object "
              f"store: "
              f"arena capacity {arena.capacity / 1e9:.2f} GB, peak arena use {peak.peak_arena / 1e9:.3f} GB, "
              f"peak /dev/shm growth {peak.peak_shm / 1e9:.3f} GB, {spilled_objects() - spills0} objects spilled")
    finally:
        shutil.rmtree(corpus, ignore_errors=True)


def data_into_train(card: str, phase17: dict, phase25: dict) -> dict:
    """Phase 26: (a) phase 25's run fed from a ``read_numpy`` Dataset
    through ``iter_torch_batches``: ``TRAIN25_STEPS`` batches on the card,
    losses equal phase 25's bit for bit, K3/K4/K5 at 24 a step each, the
    card released; (b) ``shuffle_to_card``."""
    from ray_tpu_torch import data

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    free_before = torch.cuda.mem_get_info()[0]
    cache_bytes = max(torch.cuda.memory_reserved() - torch.cuda.memory_allocated(), 64 << 20)
    ray_tpu_torch.init()
    storage = tempfile.mkdtemp(prefix="phase26_")
    try:
        corpus = os.path.join(storage, "tokens")
        os.makedirs(corpus)
        write_406m_corpus(corpus)
        result, t_fit, _ = fit_406m(storage, "dataset", dataset=data.read_numpy(corpus, column="tokens"))
        if result.error is not None:
            raise AssertionError(f"(a) fit() failed: {result.error!r}")
        hist = [h["metrics"] for h in result.metrics_history]
        losses = [m["loss"] for m in hist]
        launches = tuple(hist[-1]["launches"]) if hist else None
        want = expected_flash_launches(TRAIN_406M, TRAIN25_STEPS)
        same25 = losses == phase25["losses"]
        ms = [m["ms"] for m in hist[1:]]
        between = [m["wall"] - prev["wall"] - m["ms"] / 1e3 for prev, m in zip(hist, hist[1:])]
        print(f"(a) TorchTrainer fed data.read_numpy({DATA26_FILES} files x {DATA26_ROWS} rows) through "
              f"iter_torch_batches(batch_size={TRAIN_B}, drop_last=True) [{card}]: {len(hist)} batches of "
              f"{sorted({m['rows'] for m in hist})} rows, on the card {all(m['on_card'] for m in hist)}; losses "
              f"{[f'{x:.6f}' for x in losses]} {'equal' if same25 else 'DIFFER from'} phase 25's bit for bit; "
              f"median step {np.median(ms):.3f} ms against phase 17's {np.median(phase17['step_ms']):.3f} ms "
              f"({np.median(ms) / np.median(phase17['step_ms']):.3f}x); the trainer between two steps "
              f"{np.median(between) * 1e3:.2f} ms (median; report, ack, the next batch from the Dataset to the "
              f"card) against phase 25's {phase25['between_ms']:.2f} ms; fit() to the first report "
              f"{hist[0]['wall'] - t_fit:.2f} s (worker start to loop {hist[0]['enter_wall'] - t_fit:.2f} s, "
              f"model built {hist[0]['build_s']:.2f} s, step 0 {hist[0]['ms']:.1f} ms); K3/K4/K5 launches "
              f"{launches} = {want} expected")
        if [m["step"] for m in hist] != list(range(TRAIN25_STEPS)):
            raise AssertionError(f"(a) reported steps {[m['step'] for m in hist]}, expected 0-{TRAIN25_STEPS - 1}")
        if not all(m["on_card"] and m["rows"] == TRAIN_B for m in hist):
            raise AssertionError("(a) a batch did not arrive on the card with 26 rows")
        if not same25:
            raise AssertionError(f"(a) losses {losses} differ from phase 25's {phase25['losses']}")
        if launches != want:
            raise AssertionError(f"(a) K3/K4/K5 launched {launches} times, expected {want}")
        card_released(free_before, cache_bytes, "after (a)")

        shuffle_to_card(card)
    finally:
        shutil.rmtree(storage, ignore_errors=True)
        ray_tpu_torch.shutdown()
    print(f"phase 26 [{card}]: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=dict(zip(("K3", "K4", "K5"), launches)))


# ---------------------------------------------------------------------------
# phase 27: GPT remat policies and MoE
# ---------------------------------------------------------------------------

POLICIES = ("full", "dots", "attn", "attn_qkv", "big")
GPT27_B, GPT27_TIMED, MOE27_STEPS = 8, 5, 5  # batch 8 x 1024; timed steps per policy; (b)'s steps
# (a): a policy's step-0 gradients may differ from "full"'s by this much,
# as the largest |g - g_full| over max |g_full| of each parameter (bf16
# activations: one bf16 step is 2^-8 = 3.9e-3 of a value); the recompute
# reruns the same operators on the same inputs, so it is 0 where they are
# deterministic
GRAD_POLICY_GAP = 1e-2
# (b): the MoE step 0 on the card (bf16, K3-K5, index dispatch, fused CE)
# against the port's fp32 plain path on the card (einsum attention, the
# reference's einsum dispatch): the loss within this, absolute (it is ~11),
# and the aux loss within this share of its value; bf16 rounds the router's
# logits, which can move a near-tie assignment
MOE_STEP0_TOL = 2e-2
# (b): the index dispatch against the einsum dispatch, both fp32: the same
# products summed in another order
MOE_DISPATCH_RTOL = 1e-5
# (b): GPT-124M with 8 experts in every block (Switch-Base-8's count) and
# the reference's routing defaults: top-2, capacity factor 1.25, aux weight
# 0.01; remat "full"
MOE27 = dataclasses.replace(GPT_124M, n_experts=8)


def gpt27_tokens(seed: int, b: int = GPT27_B) -> torch.Tensor:
    """(b, 1025) int64 tokens on the card from numpy ``seed``."""
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, GPT_124M.vocab_size, (b, GPT_124M.seq_len + 1))).cuda()


def remat_policies(card: str) -> dict:
    """Phase 27 (a): GPT-124M at full width (bf16, fused CE, batch 8 x 1024,
    one set of weights from a CUDA generator seeded 0) takes one
    ``build_train_step`` step under each remat policy: the losses equal bit
    for bit, the gradients within ``GRAD_POLICY_GAP`` of "full"'s, K3/K4/K5
    at 24/12/12 launches a step under "full" and "dots" and 12/12/12 under
    the others; then ``GPT27_TIMED`` steps each, the policies in turns: the
    median step and the peak memory of a step."""
    gc.collect()
    torch.cuda.empty_cache()
    init = gpt_init(GPT_124M, torch.Generator(device="cuda").manual_seed(0))
    tokens = gpt27_tokens(27)
    runs, full_grads = {}, None
    reset_flash_launches()
    for policy in POLICIES:
        cfg = dataclasses.replace(GPT_124M, remat_policy=policy)
        init_fn, step_fn = build_train_step(lambda p, t, cfg=cfg: gpt_loss(cfg, p, t), adamw(1e-4))
        state = init_fn(copy.deepcopy(init))
        before = flash_launches()
        state, loss = step_fn(state, tokens)
        run = runs[policy] = dict(step_fn=step_fn, state=state, loss=loss.item(), ms=[], peak=[],
                                  launches=tuple(a - b for a, b in zip(flash_launches(), before)),
                                  want=expected_flash_launches(cfg, 1))
        grads = [p.grad.detach().clone() for p in state.params.parameters()]
        if full_grads is None:
            full_grads = grads
        run["gap"] = max((g - f).abs().max().item() / max(f.abs().max().item(), 1e-30)
                         for g, f in zip(grads, full_grads))
        del grads
    del init, full_grads
    for _ in range(GPT27_TIMED):
        for policy in POLICIES:
            run = runs[policy]
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            run["state"], loss = run["step_fn"](run["state"], tokens)
            loss.item()  # ends in a host sync
            run["ms"].append((time.perf_counter() - t0) * 1e3)
            run["peak"].append(torch.cuda.max_memory_allocated() - before)
    launches = flash_launches()
    losses = {p: r["loss"] for p, r in runs.items()}
    for policy, run in runs.items():
        print(f"  {policy:9s} step 0 loss {run['loss']!r}; K3/K4/K5 launches a step {run['launches']} "
              f"(expected {run['want']}); gradients' largest gap to full's {run['gap']:.3g}; median step "
              f"{np.median(run['ms']):.3f} ms (steps {[f'{x:.1f}' for x in run['ms']]}); peak memory of a "
              f"step {max(run['peak']) / 1e9:.3f} GB above the {len(POLICIES)} train states")
    first_diff = next((p for p in POLICIES if losses[p] != losses["full"]), None)
    print(f"(a) GPT-124M under each remat policy [{card}]: batch {GPT27_B} x {GPT_124M.seq_len}, "
          f"{GPT27_TIMED} steps each in turns after step 0; step 0 losses "
          + ("equal bit for bit" if first_diff is None else
             f"DIFFER, first {first_diff} {losses[first_diff]!r} against full's {losses['full']!r}")
          + f"; gradient gap limit {GRAD_POLICY_GAP}; K3/K4/K5 launches over the phase {launches}")
    if first_diff is not None:
        raise AssertionError(f"(a) step 0 loss under {first_diff} {losses[first_diff]!r} differs from "
                             f"full's {losses['full']!r}")
    for policy, run in runs.items():
        if run["launches"] != run["want"]:
            raise AssertionError(f"(a) {policy}: K3/K4/K5 launched {run['launches']} in a step, "
                                 f"expected {run['want']}")
        if not run["gap"] <= GRAD_POLICY_GAP:
            raise AssertionError(f"(a) {policy}: step 0 gradients {run['gap']:.3g} from full's "
                                 f"(limit {GRAD_POLICY_GAP})")
    return dict(launches=launches, ms={p: float(np.median(r["ms"])) for p, r in runs.items()},
                peak_gb={p: max(r["peak"]) / 1e9 for p, r in runs.items()})


def moe_dropped_shares(cfg: GPTConfig, params, tokens) -> list:
    """The share of dropped assignments in each layer of one forward,
    read from the routing (``gpt._moe_route``) as it runs."""
    from ray_tpu_torch.models import gpt as gpt_mod

    shares, route = [], gpt_mod._moe_route

    def recording(*args):
        out = route(*args)
        shares.append(1.0 - out[3].float().mean().item())
        return out

    gpt_mod._moe_route = recording
    try:
        with torch.no_grad():
            _, aux = gpt_mod.gpt_hidden(cfg, params, tokens)
    finally:
        gpt_mod._moe_route = route
    return shares, aux.item()


def moe_train(card: str) -> dict:
    """Phase 27 (b): ``MOE27`` (GPT-124M, 8 experts a block, top-2,
    capacity 1.25, aux 0.01, remat "full", bf16) from a CUDA generator
    seeded 0, batch 8 x 1024: the aux loss at init within the reference's
    test bounds (0.5, 6.0); step 0's loss and aux against the fp32 plain
    path on the card (einsum attention and dispatch) within
    ``MOE_STEP0_TOL``, and the fp32 index dispatch against the einsum one;
    then ``MOE27_STEPS`` AdamW steps (lr 1e-4) through ``build_train_step``:
    losses finite and falling, K3/K4/K5 launches as expected, step ms,
    tokens/s, peak memory, and the dropped share per layer."""
    cfg = MOE27
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in params.parameters())
    tokens = gpt27_tokens(28)
    shares, aux0 = moe_dropped_shares(cfg, params, tokens[:, :-1])
    plain = dataclasses.replace(cfg, dtype="float32", attn_impl="xla", fused_loss=False, remat=False)
    with torch.no_grad():
        plain_loss = gpt_loss(plain, params, tokens, moe_dispatch="einsum").item()
        plain_aux = gpt_forward(plain, params, tokens[:, :-1], return_aux=True, moe_dispatch="einsum")[1].item()
        index_loss = gpt_loss(plain, params, tokens).item()
    gc.collect()
    torch.cuda.empty_cache()
    init_fn, step_fn = build_train_step(lambda p, t: gpt_loss(cfg, p, t), adamw(1e-4))
    state = init_fn(params)
    reset_flash_launches()
    losses, step_ms = [], []
    for _ in range(MOE27_STEPS):
        t0 = time.perf_counter()
        state, loss = step_fn(state, tokens)
        losses.append(loss.item())  # ends in a host sync
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = flash_launches()
    want = expected_flash_launches(cfg, MOE27_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = float(np.median(step_ms[1:]))
    print(f"(b) MoE GPT-124M [{card}]: {n_params / 1e9:.3f} B parameters ({cfg.n_experts} experts a block, "
          f"top-{cfg.experts_per_token}, capacity factor {cfg.capacity_factor}, aux weight "
          f"{cfg.moe_aux_weight}), batch {GPT27_B} x {cfg.seq_len}, remat \"full\"; aux at init {aux0!r} "
          f"(bounds 0.5-6.0); step 0 loss {losses[0]!r} and aux {aux0!r} against the fp32 plain path's "
          f"{plain_loss!r} and {plain_aux!r} (tolerance {MOE_STEP0_TOL}); fp32 index dispatch loss "
          f"{index_loss!r} against the einsum's (rtol {MOE_DISPATCH_RTOL}); dropped assignments by layer "
          f"{[f'{s:.4f}' for s in shares]}; losses {[f'{x:.6f}' for x in losses]}; median step {ms:.3f} ms "
          f"(steps {[f'{x:.1f}' for x in step_ms]}), {GPT27_B * cfg.seq_len / (ms / 1e3):.0f} tokens/s; peak "
          f"memory {peak_gb:.2f} GB; K3/K4/K5 launches {launches} = {want} expected")
    if not 0.5 < aux0 < 6.0:
        raise AssertionError(f"(b) aux loss at init {aux0}, outside (0.5, 6.0)")
    if not (abs(losses[0] - plain_loss) <= MOE_STEP0_TOL
            and abs(aux0 - plain_aux) <= MOE_STEP0_TOL * abs(plain_aux)):
        raise AssertionError(f"(b) step 0 loss {losses[0]} / aux {aux0} against the fp32 plain path's "
                             f"{plain_loss} / {plain_aux}")
    if not abs(index_loss - plain_loss) <= MOE_DISPATCH_RTOL * abs(plain_loss):
        raise AssertionError(f"(b) fp32 index dispatch loss {index_loss} against the einsum's {plain_loss}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"(b) losses not finite and falling: {losses}")
    if launches != want:
        raise AssertionError(f"(b) K3/K4/K5 launched {launches} times over {MOE27_STEPS} steps, expected {want}")
    return dict(launches=launches, ms=ms, peak_gb=peak_gb)


# ---------------------------------------------------------------------------
# phase 28: Tune over Train
# ---------------------------------------------------------------------------

TUNE_CFG = dataclasses.replace(GPT_124M, remat_policy="attn")  # dense GPT-124M, batch 8
# every trial's steps (ASHA's max_t, PBT's iterations); 6 until phase 30
# came, 4 until phase 31 came
TUNE_STEPS = 3
PBT_INTERVAL = 2  # (b)'s perturbation interval: a trial checkpoints at its multiples only
TUNE_INNER_STEPS = 2  # (c): the steps of each trainer run inside a trial
TUNE_TIMEOUT_S = 600  # a Tuner run taking longer fails the phase
#: the modules each of the phase's worker processes would import itself:
#: torch, and torch._dynamo, which an optimizer's first add_param_group
#: imports (chip_cuts.py 28 times the phase with and without them)
TUNE_PRELOAD = "torch,torch._dynamo"


def tune_batches() -> np.ndarray:
    """(TUNE_STEPS, 8, 1025) tokens from numpy seed 28: step i trains on
    batch i."""
    rng = np.random.RandomState(28)
    return rng.randint(0, GPT_124M.vocab_size, (TUNE_STEPS, GPT27_B, GPT_124M.seq_len + 1))


def params_hash(module) -> int:
    """A hash of a module's parameters, bit for bit, computed on their
    device: each parameter's float bits weighted by position, summed in
    int64 (wrapping), chained over the parameters in order."""
    h = 0
    for p in module.parameters():
        bits = p.detach().reshape(-1).view(torch.int32).to(torch.int64)
        w = torch.arange(1, bits.numel() + 1, device=bits.device, dtype=torch.int64)
        h = (h * 1_000_003 + int((bits * w).sum().item())) % (1 << 61)
    return h


def gpt_124m_trainable(config: dict) -> None:
    """Phase 28's trainable, run in a trial's process on the card (its
    share bound by the controller): ``TUNE_CFG`` from a CUDA generator
    seeded 0, ``build_train_step(gpt_loss, adamw(config["lr"]))``, step i on
    ``tune_batches()[i]`` up to ``TUNE_STEPS``, ``tune.report`` after each
    step with the loss, the lr, the process's K3/K4/K5 launches counted from
    0 and its card; with ``config["stage"]`` each report at a multiple of
    ``PBT_INTERVAL`` steps carries the train state (``save_state``: the
    model and AdamW's moments) and its params' hash. From a checkpoint (PBT's exploit) it resumes at the saved step
    with the saved moments and ``config["lr"]``, and reports the restored
    params' hash."""
    from ray_tpu_torch import train, tune

    cfg = TUNE_CFG
    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0))
    init_fn, step_fn = build_train_step(lambda p, t: gpt_loss(cfg, p, t), adamw(config["lr"]))
    state = init_fn(params)
    restored = {}
    ckpt = tune.get_checkpoint()
    if ckpt is not None:
        state = train.load_state(ckpt, state)
        for group in state.opt_state.param_groups:  # the saved optimizer state carries the donor's lr
            group["lr"] = config["lr"]
        restored = dict(restored_step=state.step, restored_hash=params_hash(state.params))
    reset_flash_launches()
    batches = tune_batches()
    while state.step < TUNE_STEPS:
        tokens = torch.from_numpy(batches[state.step]).cuda()
        t0 = time.perf_counter()
        state, loss = step_fn(state, tokens)
        metrics = dict(loss=loss.item(), ms=(time.perf_counter() - t0) * 1e3, lr=config["lr"],
                       state_step=state.step, launches=list(flash_launches()), pid=os.getpid(),
                       cards=os.environ.get("CUDA_VISIBLE_DEVICES"), **restored)
        saved = stage = None
        if config.get("stage") and state.step % PBT_INTERVAL == 0:
            stage = tempfile.mkdtemp(dir=config["stage"])
            saved = train.save_state(state, stage)
            metrics["saved_hash"] = params_hash(state.params)
        tune.report(metrics, checkpoint=saved)
        if stage is not None:
            shutil.rmtree(stage)  # committed into the trial directory by now


def tune_losses_here(lr: float, steps: int) -> list:
    """The trainable's first ``steps`` losses, computed in this process."""
    params = gpt_init(TUNE_CFG, torch.Generator(device="cuda").manual_seed(0))
    init_fn, step_fn = build_train_step(lambda p, t: gpt_loss(TUNE_CFG, p, t), adamw(lr))
    state, batches, losses = init_fn(params), tune_batches(), []
    for i in range(steps):
        state, loss = step_fn(state, torch.from_numpy(batches[i]).cuda())
        losses.append(loss.item())
    return losses


def process_launches(history: list) -> tuple:
    """K3/K4/K5 launches of a trial's processes: each report carries its
    process's count, so the last report of each process holds its total."""
    last = {}
    for m in history:
        last[m["pid"]] = m["launches"]
    return tuple(sum(v[i] for v in last.values()) for i in range(3))


def experiment_trials(storage: str, name: str) -> list:
    with open(os.path.join(storage, name, "experiment_state.json")) as f:
        return json.load(f)["trials"]


def fit_in_time(tuner, label: str):
    """``tuner.fit()``, failing the phase past ``TUNE_TIMEOUT_S`` rather
    than waiting for trials forever."""
    def expire(signum, frame):
        raise TimeoutError(f"{label}: trials still running after {TUNE_TIMEOUT_S} s")

    before = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TUNE_TIMEOUT_S)
    try:
        return tuner.fit()
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, before)


def tune_asha(card: str, storage: str) -> tuple:
    """(a): 4 trials, lr from ``loguniform(1e-5, 1e-3)`` (seed 28), under
    ``ASHAScheduler(max_t=TUNE_STEPS, grace_period=2, reduction_factor=2)``, two at a
    time at half a GPU each."""
    from ray_tpu_torch import tune

    t0 = time.perf_counter()
    grid = fit_in_time(tune.Tuner(
        tune.with_resources(gpt_124m_trainable, {"CPU": 1, "GPU": 0.5}),
        param_space={"lr": tune.loguniform(1e-5, 1e-3)},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", num_samples=4, seed=28, max_concurrent_trials=2,
            scheduler=tune.ASHAScheduler(metric="loss", mode="min", max_t=TUNE_STEPS, grace_period=2,
                                         reduction_factor=2)),
        run_config=tune.RunConfig(name="asha", storage_path=storage),
    ), "(a)")
    took = time.perf_counter() - t0
    trials = experiment_trials(storage, "asha")
    histories = [r.metrics_history for r in grid]
    iters = [len(h) for h in histories]
    launches = tuple(sum(process_launches(h)[i] for h in histories) for i in range(3))
    want = tuple(n * sum(iters) for n in expected_flash_launches(TUNE_CFG, 1))
    best = grid.get_best_result()
    got = [m["loss"] for m in best.metrics_history]
    here = tune_losses_here(best.metrics["lr"], len(got))
    cards = sorted({m["cards"] for h in histories for m in h})
    lrs = [f"{h[0]['lr']:.3g}" for h in histories]
    finals = [f"{h[-1]['loss']:.6f}" for h in histories]
    print(f"(a) ASHA over 4 trials of GPT-124M (batch {GPT27_B}, remat \"attn\"), two at a time at GPU 0.5 "
          f"[{card}]: {took:.1f} s; states {[t['state'] for t in trials]}, iterations {iters} (max_t "
          f"{TUNE_STEPS}); lrs {lrs}; final losses {finals}; the trials' cards {cards}; best lr "
          f"{best.metrics['lr']:.4g}, its losses {[f'{x:.6f}' for x in got]} "
          f"{'equal' if got == here else 'DIFFER from'} this process's bit for bit; K3/K4/K5 launches "
          f"{launches} = {want} expected (12 a step each over {sum(iters)} steps); median step "
          f"{np.median([m['ms'] for h in histories for m in h[1:]]):.1f} ms with two trials on the card")
    if set(t["state"] for t in trials) != {"TERMINATED"} or grid.errors:
        raise AssertionError(f"(a) trial states {[t['state'] for t in trials]}, errors {grid.errors}")
    if not min(iters) < TUNE_STEPS:
        raise AssertionError(f"(a) ASHA stopped no trial before max_t: iterations {iters}")
    if got != here:
        raise AssertionError(f"(a) the best trial's losses {got} differ from this process's {here}")
    if launches != want:
        raise AssertionError(f"(a) K3/K4/K5 launched {launches} times over {sum(iters)} steps, expected {want}")
    return launches, took


def tune_pbt(card: str, storage: str) -> tuple:
    """(b): 2 trials (lr 1e-5 and 1e-3) under synchronous
    ``PopulationBasedTraining`` (``perturbation_interval=PBT_INTERVAL``, lr
    perturbed by 0.8 or 1.2, never resampled; asynchronous PBT exploits at
    step 2 only when the worse trial happens to report it second),
    ``TUNE_STEPS`` iterations, the reports at the perturbation steps
    checkpointing the train state."""
    from ray_tpu_torch import tune

    stage = tempfile.mkdtemp(dir=storage, prefix="stage_")
    # every checkpoint is kept: with keep-N a donor's newer commits could
    # delete the one an exploiting trial is about to load
    n_ckpt = 2 * (TUNE_STEPS // PBT_INTERVAL)
    need = n_ckpt * 12 * sum(p.numel() for p in GPT(TUNE_CFG, device="meta").parameters())
    free = shutil.disk_usage(storage).free
    print(f"(b) storage {storage}: {free / 1e9:.1f} GB free; the run keeps {n_ckpt} checkpoints of "
          f"~{need / n_ckpt / 1e9:.2f} GB (12 bytes a parameter)")
    if free < 1.2 * need:
        raise AssertionError(f"(b) {free / 1e9:.1f} GB free: too little for {need / 1e9:.1f} GB of checkpoints")
    t0 = time.perf_counter()
    grid = fit_in_time(tune.Tuner(
        tune.with_resources(gpt_124m_trainable, {"CPU": 1, "GPU": 0.5}),
        param_space={"lr": tune.grid_search([1e-5, 1e-3]), "stage": stage},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", max_concurrent_trials=2,
            scheduler=tune.PopulationBasedTraining(
                metric="loss", mode="min", perturbation_interval=PBT_INTERVAL, seed=28,
                resample_probability=0.0, synch=True,
                hyperparam_mutations={"lr": tune.loguniform(1e-6, 1e-2)})),
        run_config=tune.RunConfig(name="pbt", storage_path=storage),
    ), "(b)")
    took = time.perf_counter() - t0
    trials = experiment_trials(storage, "pbt")
    histories = [r.metrics_history for r in grid]
    exploits = []
    for i, h in enumerate(histories):
        donor = histories[1 - i]
        for prev, m in zip(h, h[1:]):
            if m.get("restored_hash") is not None and m["pid"] != prev["pid"]:
                saved = {d.get("saved_hash") for d in donor if d["state_step"] == m["restored_step"]}
                exploits.append(dict(
                    trial=i, step=m["restored_step"], hash_ok=m["restored_hash"] in saved, lr=m["lr"],
                    perturbed=any(m["lr"] in (d["lr"] * 0.8, d["lr"] * 1.2) for d in donor)))
    launches = tuple(sum(process_launches(h)[i] for h in histories) for i in range(3))
    steps = sum(1 for h in histories for _ in h)
    want = tuple(n * steps for n in expected_flash_launches(TUNE_CFG, 1))
    finals = [f"{h[-1]['loss']:.6f}" for h in histories]
    print(f"(b) synchronous PBT over 2 trials of GPT-124M, perturbation interval {PBT_INTERVAL}, {TUNE_STEPS} iterations, "
          f"a checkpoint of the train state every {PBT_INTERVAL} steps [{card}]: {took:.1f} s; states {[t['state'] for t in trials]}; "
          f"exploits {exploits}; final losses {finals}; K3/K4/K5 launches {launches} = {want} expected over "
          f"{steps} steps")
    if set(t["state"] for t in trials) != {"TERMINATED"} or grid.errors:
        raise AssertionError(f"(b) trial states {[t['state'] for t in trials]}, errors {grid.errors}")
    if not exploits:
        raise AssertionError("(b) no trial exploited another's checkpoint")
    if not all(e["hash_ok"] and e["perturbed"] for e in exploits):
        raise AssertionError(f"(b) an exploit restored other params than the donor's, or an lr that is no "
                             f"perturbation of the donor's: {exploits}")
    if launches != want:
        raise AssertionError(f"(b) K3/K4/K5 launched {launches} times over {steps} steps, expected {want}")
    return launches, took


def gpt_124m_train_loop(config: dict) -> None:
    """(c)'s train loop, run by the ``TorchTrainer`` worker inside a trial:
    ``TUNE_INNER_STEPS`` steps of the trainable's model and batches at
    ``config["lr"]``, then one report with the losses, the worker's
    K3/K4/K5 launches, its card and the cluster's free GPU."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import train

    params = gpt_init(TUNE_CFG, torch.Generator(device="cuda").manual_seed(0))
    init_fn, step_fn = build_train_step(lambda p, t: gpt_loss(TUNE_CFG, p, t), adamw(config["lr"]))
    state, batches, losses = init_fn(params), tune_batches(), []
    reset_flash_launches()
    for i in range(TUNE_INNER_STEPS):
        state, loss = step_fn(state, torch.from_numpy(batches[i]).cuda())
        losses.append(loss.item())
    train.report(dict(loss=losses[-1], losses=losses, lr=config["lr"], launches=list(flash_launches()),
                      cards=os.environ.get("CUDA_VISIBLE_DEVICES"), device=torch.cuda.get_device_name(),
                      free_gpu=rt.available_resources().get("GPU", 0.0)))


def tuner_over_trainer(card: str, storage: str) -> tuple:
    """(c): ``Tuner(TorchTrainer(..., ScalingConfig(num_workers=1,
    use_gpu=True)))`` over a grid of two lrs, one trial at a time (the
    trial holds a CPU, its trainer's worker the GPU)."""
    from ray_tpu_torch import train, tune

    trainer = train.TorchTrainer(
        gpt_124m_train_loop,
        scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
        run_config=train.RunConfig(name="inner", storage_path=storage),
    )
    t0 = time.perf_counter()
    grid = fit_in_time(tune.Tuner(
        trainer,
        param_space={"lr": tune.grid_search([1e-5, 1e-3])},
        tune_config=tune.TuneConfig(metric="loss", mode="min", max_concurrent_trials=1),
        run_config=tune.RunConfig(name="outer", storage_path=storage),
    ), "(c)")
    took = time.perf_counter() - t0
    results = [r.metrics for r in grid]
    best = grid.get_best_result()
    launches = tuple(sum(m["launches"][i] for m in results) for i in range(3))
    want = tuple(n * TUNE_INNER_STEPS * len(results) for n in expected_flash_launches(TUNE_CFG, 1))
    print(f"(c) Tuner over TorchTrainer(ScalingConfig(num_workers=1, use_gpu=True)), lr grid [1e-5, 1e-3], "
          f"{TUNE_INNER_STEPS} steps a trial [{card}]: {took:.1f} s; losses "
          f"{[(m['lr'], [f'{x:.6f}' for x in m['losses']]) for m in results]}; best lr {best.metrics['lr']}; "
          f"the inner workers' cards {[m['cards'] for m in results]} ({results[0]['device']}), the cluster's "
          f"free GPU while they trained {[m['free_gpu'] for m in results]}; K3/K4/K5 launches {launches} = "
          f"{want} expected")
    if grid.errors or len(results) != 2:
        raise AssertionError(f"(c) errors {grid.errors}, results {results}")
    if best.metrics["loss"] != min(m["loss"] for m in results):
        raise AssertionError(f"(c) best result {best.metrics} is not the lower loss")
    if not all(m["free_gpu"] == 0.0 and m["device"] == torch.cuda.get_device_name(0) for m in results):
        raise AssertionError(f"(c) the inner worker did not hold the card: {results}")
    if launches != want:
        raise AssertionError(f"(c) K3/K4/K5 launched {launches} times, expected {want}")
    return launches, took


def tune_over_train(card: str) -> dict:
    """Phase 28: ``ray_tpu_torch.tune`` over the card as one ``GPU``:
    ``tune_asha``, ``tune_pbt`` and ``tuner_over_trainer``. Its cluster's
    preload ends with it (``shutdown``)."""
    gc.collect()
    torch.cuda.empty_cache()
    ray_tpu_torch.init(_system_config={"preload_python_modules": TUNE_PRELOAD})
    storage = tempfile.mkdtemp(prefix="phase28_")
    try:
        asha, asha_s = tune_asha(card, storage)
        pbt, pbt_s = tune_pbt(card, storage)
        inner, inner_s = tuner_over_trainer(card, storage)
    finally:
        shutil.rmtree(storage, ignore_errors=True)
        ray_tpu_torch.shutdown()
    return dict(asha=asha, pbt=pbt, inner=inner, seconds=(asha_s, pbt_s, inner_s))


# ---------------------------------------------------------------------------
# phase 29: RL and RLHF on the card
# ---------------------------------------------------------------------------

RLHF_PROMPTS = 32  # (a)'s trajectories at version 0; (b)'s prompts cycle these
RLHF_SAMPLING = dict(max_tokens=128, temperature=1.0, top_k=0, top_p=1.0)
RLHF_T, RLHF_O = 256, 128  # the learner's padded shapes: longest prompt + max_tokens, max_tokens
#: (a): |learner logprob - behavior logprob| over the unmasked tokens at
#: version 0 — the engine's bf16 paged decode through K1 against the
#: learner's bf16 forward through K3, both scoring fp32 logits — and
#: |mean_ratio - 1|. The max bound is 4x the max measured on the H100
#: (0.0378); an off-by-one index must exceed both the max and the mean bound.
LOGP_GAP_MAX = 0.15
LOGP_GAP_MEAN = 0.05
RATIO_GAP = 0.02
RLHF_LR = 1e-4
RLHF_ITERS = 2  # (b); 8 until phase 30 came, 4 until phase 31 came, 3 until phase 33 came
PPO_ITERS = 3  # (c)
PPO_TOL = 1e-5  # (c): one fp32 update on the card against the CPU's


def rlhf_prompts() -> list:
    """32 prompts of 64-128 ids over the whole vocabulary (numpy seed 29)."""
    rng = np.random.default_rng(29)
    return [rng.integers(0, GPT_124M.vocab_size, int(n)).tolist()
            for n in rng.integers(64, 129, RLHF_PROMPTS)]


def low_id_reward(prompt, tokens) -> float:
    """Phase 29's reward: the share of generated ids below 1024."""
    return sum(1 for t in tokens if t < 1024) / max(len(tokens), 1)


def harvest(worker, n: int, timeout_s: float = 300.0) -> list:
    deadline = time.monotonic() + timeout_s
    trajs = []
    while len(trajs) < n:
        if time.monotonic() > deadline:
            raise AssertionError(f"{len(trajs)} of {n} trajectories within {timeout_s} s")
        trajs += worker.poll()["trajs"]
        time.sleep(0.01)
    return trajs


def rlhf_on_policy(card: str) -> dict:
    """Phase 29 (a): one update at full width, on policy."""
    cfg = GPT_124M
    worker = RolloutWorker(model="gpt", model_cfg=cfg, engine_config=GPT_ENGINE, seed=0)
    group = make_learner_group(cfg, lr=RLHF_LR, seed=0)
    learner = group._local
    eng = worker._engine
    served = eng.runner.params.state_dict()
    for name, value in learner.params.state_dict().items():
        if not torch.equal(value, served[name]):
            raise AssertionError(f"(a): version 0 differs between the learner and the engine at {name}")
    reset_counts(eng)
    before = eng.stats()
    t0 = time.perf_counter()
    worker.submit(rlhf_prompts(), **RLHF_SAMPLING)
    trajs = harvest(worker, RLHF_PROMPTS)
    gen_s = time.perf_counter() - t0
    worker.stop()
    k1, _ = check_counts("(a) rollouts", eng)
    after = eng.stats()
    decode_ms = (after["decode_s"] - before["decode_s"]) / (after["decode_steps"] - before["decode_steps"]) * 1e3
    tokens = sum(len(t["tokens"]) for t in trajs)
    print(f"(a) [{card}]: {len(trajs)} trajectories, {tokens} tokens in {gen_s:.3f} s "
          f"({tokens / gen_s:.1f} tokens/s), decode steps of {decode_ms:.3f} ms (wall, mean), "
          f"K1 {k1} launches")
    rewards = np.asarray([low_id_reward(t["prompt"], t["tokens"]) for t in trajs], np.float32)
    batch = build_batch([(t, 1.0, 0) for t in trajs], group_advantages(rewards), RLHF_T, RLHF_O,
                        RLHF_SAMPLING["temperature"], RLHF_SAMPLING["top_k"], RLHF_SAMPLING["top_p"])
    dev = {k: torch.from_numpy(v).to(learner.device) for k, v in batch.items()}
    mask = (torch.arange(RLHF_O, device=learner.device)[None, :] < dev["out_len"][:, None]) & (dev["token_mask"] > 0)
    with torch.no_grad():
        gap = (policy_logprobs(cfg, learner.params, dev) - dev["behavior_logp"]).abs()[mask]
        late_batch = dict(dev, prompt_len=dev["prompt_len"] + 1)  # read at prompt_len + j
        late = (policy_logprobs(cfg, learner.params, late_batch) - dev["behavior_logp"]).abs()[mask]
    gap_max, gap_mean = gap.max().item(), gap.mean().item()
    late_max, late_mean = late.max().item(), late.mean().item()
    print(f"(a) [{card}]: |learner - behavior logprob| over {int(mask.sum())} tokens: max {gap_max:.6f} "
          f"(bound {LOGP_GAP_MAX}), mean {gap_mean:.6f} (bound {LOGP_GAP_MEAN}); read at prompt_len + j "
          f"(off by one): max {late_max:.6f}, mean {late_mean:.6f}")
    if not (gap_max <= LOGP_GAP_MAX and gap_mean <= LOGP_GAP_MEAN):
        raise AssertionError("(a): the learner's logprobs are off the engine's behavior logprobs")
    if not (late_max > LOGP_GAP_MAX and late_mean > LOGP_GAP_MEAN):
        raise AssertionError("(a): an off-by-one index stays within a bound: the check cannot see it")
    del dev, gap, late
    gc.collect()
    torch.cuda.empty_cache()
    # K3-K5 against their plain versions at the learner's own shape: bf16,
    # (trajectories x heads, T, head_dim), before the launches are counted
    g = torch.Generator(device="cuda").manual_seed(29)
    flash_err = flash_errors(*(torch.randn(RLHF_PROMPTS * cfg.n_heads, RLHF_T, cfg.head_dim, device="cuda",
                                           generator=g, dtype=torch.bfloat16) for _ in range(4)))
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_launches()
    t0 = time.perf_counter()
    metrics = group.update(SampleBatch(batch))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    flash = flash_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"(a) [{card}]: one update {step_ms:.3f} ms, peak {peak:.3f} GB, K3/K4/K5 {flash}, "
          f"mean_ratio {metrics['mean_ratio']:.6f} (bound 1 +- {RATIO_GAP}), loss {metrics['loss']:.6f}, "
          f"grad_norm {metrics['grad_norm']:.4f}, clip_frac {metrics['clip_frac']:.4f}")
    if flash != expected_flash_launches(cfg, 1):
        raise AssertionError(f"(a): K3/K4/K5 {flash} launches in one update")
    if not (abs(metrics["mean_ratio"] - 1.0) <= RATIO_GAP and np.isfinite(metrics["loss"])):
        raise AssertionError(f"(a): update metrics {metrics}")
    del worker, group, learner, eng, served
    gc.collect()
    torch.cuda.empty_cache()
    return dict(k1=k1, flash=flash, flash_err=flash_err, step_ms=step_ms, gen_s=gen_s)


class CardRolloutWorker(RolloutWorker):
    """Phase 29 (b): the port's ``RolloutWorker`` in a GPU-share actor,
    reporting what its process alone sees: K1's launch count (zeroed when
    ``__init__``'s warm-up is done), the engine's decode steps and the
    weight applies from its flight recorder."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        from ray_tpu_torch.ops import paged_attention as pa

        pa.paged_attention_cuda.launches = 0
        self._engine.runner.launches = dict.fromkeys(self._engine.runner.launches, 0)

    def launches(self) -> tuple:
        """(K1 launches, decode steps, ms a decode step, the cards its
        process was bound to), read once the step loop has stopped (a
        running loop could step between the reads)."""
        from ray_tpu_torch.ops import paged_attention as pa

        self._stop.set()
        self._loop.join(timeout=60)
        stats = self._engine.stats()
        return (pa.paged_attention_cuda.launches, self._engine.runner.launches["decode"],
                stats["decode_s"] / max(stats["decode_steps"], 1) * 1e3,
                os.environ.get("CUDA_VISIBLE_DEVICES"))

    def applies(self) -> list:
        from ray_tpu_torch._private import events as ev

        return [(e["version"], e["apply_s"]) for e in ev.snapshot() if e["type"] == "rlhf.sync.apply"]


def rlhf_async_loop(card: str) -> dict:
    """Phase 29 (b): ``rlhf.Algorithm`` with two rollout workers on GPU
    shares and the learner in this process."""
    cfg = GPT_124M
    ray_tpu_torch.init()
    rollout_mod.RolloutWorker = CardRolloutWorker
    algo = None
    try:
        t0 = time.perf_counter()
        algo = RLHFAlgorithm(RLHFConfig(
            model_cfg=cfg, engine_config=GPT_ENGINE, prompts=rlhf_prompts(), reward_fn=low_id_reward,
            num_rollout_workers=2, rollout_inflight=16, train_batch=32, max_staleness=4,
            lr=RLHF_LR, seed=0, **RLHF_SAMPLING,
        ))
        start_s = time.perf_counter() - t0
        step_ms = []
        update = algo.learner_group.update

        def timed_update(batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = update(batch)  # ends in the metrics' copy to the host
            step_ms.append((time.perf_counter() - t) * 1e3)
            return out

        algo.learner_group.update = timed_update
        reset_flash_launches()
        iters, ends = [], [time.time()]
        t0 = time.perf_counter()
        for _ in range(RLHF_ITERS):
            out = algo.train_step()
            if out.get("skipped"):
                raise AssertionError(f"(b): an iteration was skipped: {out}")
            ends.append(time.time())
            out["versions"] = list(algo.stats()["last_batch_versions"])
            iters.append(out)
        loop_s = time.perf_counter() - t0
        flash = flash_launches()
        deadline = time.monotonic() + 60
        while min(algo.rollouts.versions()) < RLHF_ITERS and time.monotonic() < deadline:
            time.sleep(0.1)
        versions = algo.rollouts.versions()
        workers = algo.rollouts._workers
        launches = ray_tpu_torch.get([w.launches.remote() for w in workers], timeout=60)
        applies = ray_tpu_torch.get([w.applies.remote() for w in workers], timeout=60)
        evs = events.snapshot()
    finally:
        if algo is not None:
            algo.shutdown()
        rollout_mod.RolloutWorker = RolloutWorker
        ray_tpu_torch.shutdown()
    pushes = {e["version"]: e for e in evs if e["type"] == "rlhf.sync.push"}
    finishes = [e for e in evs if e["type"] == "rlhf.rollout.finish"]
    steps = sorted(e["ts"] for e in evs if e["type"] == "rlhf.learner.step")
    print(f"(b) [{card}]: Algorithm up in {start_s:.3f} s (2 workers at GPU 0.25, version 0 pushed); "
          f"{RLHF_ITERS} iterations in {loop_s:.3f} s")
    for i, out in enumerate(iters):
        v = out["weights_version"]
        window = [e for e in finishes if ends[i] < e["ts"] <= ends[i + 1]]
        tok_s = sum(e["tokens"] for e in window) / (ends[i + 1] - ends[i])
        push = pushes.get(v, {})
        ages = [v - 1 - x for x in out["versions"]]
        print(f"(b) it {i}: version {v}, learner step {step_ms[i]:.3f} ms, publish "
              f"{push.get('push_s', float('nan')) * 1e3:.3f} ms / {push.get('bytes', 0)} bytes in "
              f"{push.get('chunks', 0)} chunks, consumed versions {sorted(set(out['versions']))} "
              f"(staleness max {max(ages)}, mean {out['mean_staleness']:.3f}, dropped "
              f"{out['dropped_stale']}), rollout {tok_s:.1f} tokens/s, reward {out['mean_reward']:.5f}, "
              f"loss {out['learner/loss']:.6f}")
        if max(ages) > 4 or not np.isfinite(out["learner/loss"]):
            raise AssertionError(f"(b) iteration {i}: {out}")
    for w, (apps, (k1, decode, step_ms_w, cards)) in enumerate(zip(applies, launches)):
        ms = [f"v{v} {s * 1e3:.1f}" for v, s in apps]
        print(f"(b) worker {w}: bound to card {cards}, weights_version {versions[w]}, applies (ms) "
              f"{', '.join(ms)}; K1 {k1} launches over {decode} decode steps of {step_ms_w:.3f} ms (wall, mean)")
        if k1 <= 0 or k1 != cfg.n_layers * decode:
            raise AssertionError(f"(b) worker {w}: K1 {k1} launches over {decode} decode steps")
        if not cards or "," in cards:
            raise AssertionError(f"(b) worker {w}: bound to cards {cards!r}, not to one card")
    print(f"(b) [{card}]: reward by iteration {[round(o['mean_reward'], 5) for o in iters]}; "
          f"learner K3/K4/K5 {flash}")
    if min(versions) < 1:
        raise AssertionError(f"(b): worker weights versions {versions}")
    if not (len(steps) >= 2 and any(steps[0] < e["ts"] < steps[-1] for e in finishes)):
        raise AssertionError("(b): no rollout finished between two learner steps")
    if flash != expected_flash_launches(cfg, RLHF_ITERS):
        raise AssertionError(f"(b): learner K3/K4/K5 {flash} over {RLHF_ITERS} updates")
    return dict(k1=sum(k for k, *_ in launches), flash=flash, loop_s=loop_s, start_s=start_s)


def ppo_on_card(card: str) -> float:
    """Phase 29 (c): PPO on CartPole with the learner (and the local env
    runner) on the card; then one ``Learner.update`` on the card against the
    same update on the CPU."""
    algo = (PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=8, rollout_fragment_length=128)
            .training(train_batch_size=1024, minibatch_size=128, num_epochs=4)
            .debugging(seed=0).build())
    try:
        for i in range(PPO_ITERS):
            t0 = time.perf_counter()
            r = algo.train()
            print(f"(c) [{card}]: iteration {i} {time.perf_counter() - t0:.3f} s, episode return "
                  f"{r['episode_return_mean']}, loss {r['learner/loss']:.6f}")
        cfg, runner = algo.config, algo._local_runner
        weights = host_weights(algo.get_weights())
        batch = runner.sample(16)
        obs_space, act_space = runner.get_spaces()
    finally:
        algo.stop()
    kw = dict(module_factory=lambda: ActorCriticModule(RLModuleSpec(obs_space, act_space, tuple(cfg.hidden))),
              loss_fn=ppo_loss(cfg.clip_param, cfg.vf_clip_param, cfg.vf_loss_coeff, cfg.entropy_coeff),
              lr=cfg.lr, grad_clip=cfg.grad_clip)
    on_card, on_cpu = Learner(**kw), Learner(**kw, device="cpu")
    on_card.set_weights(weights)
    on_cpu.set_weights(weights)
    got, want = on_card.update(batch), on_cpu.update(batch)
    gap = max(abs(got[k] - want[k]) for k in want)
    cpu_weights = on_cpu.get_weights()
    for name, value in on_card.get_weights().items():
        gap = max(gap, (value.cpu() - cpu_weights[name]).abs().max().item())
    print(f"(c) [{card}]: one update on the card against the CPU: max gap {gap:.3e} (bound {PPO_TOL})")
    if not gap <= PPO_TOL:
        raise AssertionError("(c): the card's PPO update differs from the CPU's")
    return gap


def rl_on_card(card: str) -> dict:
    """Phase 29: (a) ``rlhf_on_policy``, (b) ``rlhf_async_loop``, (c)
    ``ppo_on_card``."""
    gc.collect()
    torch.cuda.empty_cache()
    t = [time.perf_counter()]
    a = rlhf_on_policy(card)
    t.append(time.perf_counter())
    b = rlhf_async_loop(card)
    t.append(time.perf_counter())
    ppo_on_card(card)
    t.append(time.perf_counter())
    gc.collect()
    torch.cuda.empty_cache()
    return dict(k1=a["k1"] + b["k1"], flash=tuple(x + y for x, y in zip(a["flash"], b["flash"])),
                flash_err=a["flash_err"],
                seconds=[t1 - t0 for t0, t1 in zip(t, t[1:])])


# ---------------------------------------------------------------------------
# phase 30: the rest of RL on the card
# ---------------------------------------------------------------------------

RL_TOL = 1e-5  # a learner update on the card against the CPU's: |card - cpu| / max(1, |cpu|)
RL_SEED = 30


def timed_updates(algo) -> list:
    """Wrap ``algo.learner_group.update`` to record each update's wall ms
    (from a synced card to the metrics' copy to the host, which ends it)."""
    times = []
    update = algo.learner_group.update

    def timed(batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = update(batch)
        times.append((time.perf_counter() - t) * 1e3)
        return out

    algo.learner_group.update = timed
    return times


def train_iterations(algo, n: int, label: str, card: str, unit: str) -> tuple:
    """``n`` iterations of ``algo.train()``: (results, seconds each, the
    algorithm's timesteps per second over the run — env steps, or the
    dataset rows an offline algorithm trains on)."""
    results, secs = [], []
    steps0 = algo._timesteps_total
    t0 = time.perf_counter()
    for _ in range(n):
        t = time.perf_counter()
        results.append(algo.train())
        secs.append(time.perf_counter() - t)
    rate = (algo._timesteps_total - steps0) / (time.perf_counter() - t0)
    print(f"{label} [{card}]: iterations {[f'{s:.3f}' for s in secs]} s, {rate:.1f} {unit}/s, "
          f"episode return {results[-1].get('episode_return_mean')}")
    return results, secs, rate


def rel_gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want)))) if want.size else 0.0


def learner_gate(algo, batch, label: str, card: str, apply=None, step: int = 0) -> float:
    """The card's update from given weights, batch and draws against the
    CPU's: two ``Learner``s with the algorithm's module, loss (its call
    count set to ``step``), lr and clip, both holding the algorithm's
    learner weights; one update each on ``batch`` (its ``"draw/..."`` keys
    the loss's draws), then ``apply`` (a Polyak or target sync) on each.
    Returns the largest relative gap over the metrics and the weights."""
    src = algo.learner_group._local
    weights = host_weights(src.params)
    twins = []
    for device in (None, "cpu"):
        loss = copy.deepcopy(src._loss_fn)
        if hasattr(loss, "step"):
            loss.step = step
        twin = Learner(lambda: copy.deepcopy(src.module), loss, lr=src.opt.param_groups[0]["lr"],
                       grad_clip=src._grad_clip, device=device)
        twin.set_weights(weights)
        twins.append(twin)
    got, want = (t.update(batch) for t in twins)
    if apply is not None:
        for t in twins:
            t.apply(apply)
    gap = max(rel_gap(got[k], want[k]) for k in want)
    cpu_weights = twins[1].get_weights()
    for name, value in twins[0].get_weights().items():
        gap = max(gap, rel_gap(value.cpu().numpy(), cpu_weights[name].numpy()))
    print(f"{label} [{card}]: one update on the card against the CPU from the same weights, batch and "
          f"draws: largest gap {gap:.3e} over {len(want)} metrics and {len(cpu_weights)} tensors "
          f"(bound {RL_TOL}, relative to max(1, |cpu|))")
    if not gap <= RL_TOL:
        raise AssertionError(f"{label}: the card's update differs from the CPU's by {gap:.3e}")
    return gap


def check_finite(label: str, result: dict, keys) -> None:
    bad = [k for k in keys if k not in result or not np.all(np.isfinite(result[k]))]
    if bad:
        raise AssertionError(f"{label}: missing or non-finite {bad} in {result}")


def normal_draws(rng, **shapes) -> dict:
    return {f"draw/{k}": rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def rl_part(label: str, card: str, build, iters: int, check, gate=None, unit="env steps") -> dict:
    """One part of phase 30: build the algorithm (on the card: ``device``
    left None), time its learner's updates over ``iters`` iterations,
    ``check(algo, results)``, then ``gate(algo)``, the card-versus-CPU
    update check."""
    t0 = time.perf_counter()
    algo = build()
    try:
        times = timed_updates(algo) if hasattr(algo, "learner_group") else []
        results, secs, rate = train_iterations(algo, iters, label, card, unit)
        check(algo, results)
        ms = float(np.median(times)) if times else float("nan")
        if times:
            print(f"{label} [{card}]: {len(times)} learner updates, median {ms:.3f} ms "
                  f"(min {min(times):.3f}, max {max(times):.3f})")
        gap = gate(algo) if gate is not None else None
    finally:
        algo.stop()
    return dict(seconds=time.perf_counter() - t0, iter_s=secs, update_ms=ms, steps_per_s=rate, gap=gap,
                unit=unit)


def dqn_part(card: str) -> dict:
    """(a) DQN on CartPole at ``DQNConfig``'s defaults with prioritized
    replay: 3 iterations of 512 steps (learning starts at 1000, the target
    syncs after 500 steps), then the card-versus-CPU update with a target
    sync."""
    from ray_tpu_torch.rl import DQNConfig
    from ray_tpu_torch.rl.algorithms.dqn import _sync_target

    def check(algo, results):
        r = results[-1]
        check_finite("(a)", r, ("learner/loss", "learner/td_error_mean", "learner/q_mean"))
        w = algo.get_weights()
        synced = all(torch.equal(w[n], w["target_" + n]) for n in w if n.startswith("q."))
        prio = algo.buffer._prio[:len(algo.buffer)]
        print(f"(a) buffer {len(algo.buffer)}, epsilon {r['epsilon']:.4f}, distinct priorities "
              f"{len(np.unique(prio))}, target equal to the online net after the last sync {synced}")
        if len(np.unique(prio)) < 32 or not synced:
            raise AssertionError("(a): no per-sample priorities, or no target sync")

    def gate(algo):
        batch = algo.buffer.sample(algo.config.train_batch_size)
        return learner_gate(algo, batch, "(a) DQN", card, apply=_sync_target)

    return rl_part("(a) DQN, CartPole", card, lambda: DQNConfig().environment("CartPole-v1").training(
        prioritized_replay=True).debugging(seed=RL_SEED).build(), 3, check, gate)


def continuous_part(card: str, label: str, config, draws) -> dict:
    """(b), (c): an off-policy learner on Pendulum at its config's defaults,
    4 iterations of 400 steps (learning starts at 1500: the last iteration
    makes 200 updates, each followed by the Polyak average), then the
    card-versus-CPU update with the Polyak average."""
    def check(algo, results):
        r = results[-1]
        check_finite(label, r, ("learner/loss", "learner/q_loss", "learner/pi_loss"))
        w = algo.get_weights()
        lag = max(float((w[n] - w["target_" + n]).abs().max()) for n in w if n.startswith("q1."))
        print(f"{label}: buffer {r['buffer_size']}, the targets' largest lag behind q1 {lag:.4f}")
        if r["buffer_size"] < 1600 or not 0 < lag < 10:
            raise AssertionError(f"{label}: no learning iteration, or Polyak targets off ({lag})")

    def gate(algo):
        cfg = algo.config
        batch = algo.buffer.sample(cfg.train_batch_size)
        batch.update(draws(np.random.default_rng(RL_SEED), cfg.train_batch_size))
        pairs = (("pi", "target_pi"), ("q1", "target_q1"), ("q2", "target_q2"))
        return learner_gate(algo, batch, label, card, step=1,
                            apply=partial(polyak_update, tau=cfg.tau, pairs=pairs))

    return rl_part(label, card, lambda: config.environment("Pendulum-v1").debugging(seed=RL_SEED).build(),
                   4, check, gate)


def offline_part(card: str, storage: str) -> tuple:
    """(d) BC on scripted-expert CartPole data and CQL on random Pendulum
    data, each recorded here and written to ``.npz``; their configs'
    defaults, 2 iterations and 1; the card-versus-CPU update of each."""
    from ray_tpu_torch.rl.algorithms.bc import BCConfig
    from ray_tpu_torch.rl.algorithms.cql import CQLConfig
    from ray_tpu_torch.rl.offline import OfflineDataset, record_experience

    def expert(obs):
        return 1 if obs[2] + 0.5 * obs[3] > 0 else 0

    t0 = time.perf_counter()
    bc_path = record_experience("CartPole-v1", 4000, policy=expert, seed=RL_SEED).save_npz(
        os.path.join(storage, "cartpole_expert.npz"))
    cql_path = record_experience("Pendulum-v1", 4000, seed=RL_SEED).save_npz(
        os.path.join(storage, "pendulum_random.npz"))
    print(f"(d) recorded 4000 expert CartPole and 4000 random Pendulum transitions to .npz in "
          f"{time.perf_counter() - t0:.2f} s ({os.path.getsize(bc_path)} and {os.path.getsize(cql_path)} bytes)")

    def bc_check(algo, results):
        nll = [r["learner/nll"] for r in results]
        print(f"(d) BC nll by iteration {[f'{x:.4f}' for x in nll]}")
        check_finite("(d) BC", results[-1], ("learner/loss", "learner/nll"))
        if not nll[-1] < nll[0]:
            raise AssertionError(f"(d): BC's nll did not fall: {nll}")

    def bc_gate(algo):
        return learner_gate(algo, OfflineDataset.from_npz(bc_path, seed=1).sample(256), "(d) BC", card)

    def cql_check(algo, results):
        check_finite("(d) CQL", results[-1], ("learner/loss", "learner/q_loss", "learner/cql_penalty"))
        print(f"(d) CQL penalty {results[-1]['learner/cql_penalty']:.4f}")

    def cql_gate(algo):
        cfg, n = algo.config, algo.config.cql_n_actions
        batch = OfflineDataset.from_npz(cql_path, seed=1).sample(cfg.train_batch_size)
        rng = np.random.default_rng(RL_SEED)
        batch.update(normal_draws(rng, next=(256, 1), pi=(256, 1), cql_policy=(n, 256, 1)))
        batch["draw/cql_random"] = rng.uniform(-2, 2, (n, 256, 1)).astype(np.float32)
        pairs = (("q1", "target_q1"), ("q2", "target_q2"))
        return learner_gate(algo, batch, "(d) CQL", card, apply=partial(polyak_update, tau=cfg.tau, pairs=pairs))

    bc = rl_part("(d) BC from .npz", card, lambda: BCConfig().environment("CartPole-v1").training(
        offline_data=bc_path).debugging(seed=RL_SEED).build(), 2, bc_check, bc_gate, unit="dataset rows")
    cql = rl_part("(d) CQL from .npz", card, lambda: CQLConfig().environment("Pendulum-v1").training(
        offline_data=cql_path).debugging(seed=RL_SEED).build(), 1, cql_check, cql_gate, unit="dataset rows")
    return bc, cql


def async_build(config):
    """(e) IMPALA or APPO at its defaults with two env-runner actors at
    ``ENV_RUNNER_GPUS`` of the card and the learner in this process on the
    card."""
    return config.environment("CartPole-v1").env_runners(num_env_runners=2).debugging(seed=RL_SEED).build()


def async_part(card: str, label: str, algo) -> dict:
    """(e) IMPALA or APPO (``async_build``): 2 iterations; then the
    card-versus-CPU update on a sequence batch from a runner."""
    def check(algo, results):
        check_finite(label, results[-1], ("learner/loss", "learner/policy_loss", "learner/vf_loss"))
        steps = [r["num_env_steps_sampled"] for r in results]
        print(f"{label}: env steps consumed by iteration {steps}, two runners at GPU {ENV_RUNNER_GPUS}")
        if min(steps) < algo.config.train_batch_size:
            raise AssertionError(f"{label}: an iteration consumed {steps} env steps")

    def gate(algo):
        batch = ray_tpu_torch.get(algo._runner_actors[0].sample_sequences.remote(
            algo.config.rollout_fragment_length, algo.config.gamma))
        return learner_gate(algo, batch, label, card)

    return rl_part(label, card, lambda: algo, 2, check, gate)


def es_build():
    """(f) ES at ``ESConfig``'s defaults over two env-runner actors on the
    card."""
    from ray_tpu_torch.rl.algorithms.es import ES, ESConfig

    cfg = ESConfig()
    cfg.env, cfg.num_env_runners, cfg.seed = "CartPole-v1", 2, RL_SEED
    return ES(cfg)


def es_part(card: str, algo) -> dict:
    """(f) ES (``es_build``): 2 iterations of 8 antithetic pairs."""

    def check(algo, results):
        r = results[-1]
        check_finite("(f)", r, ("es_reward_pos_mean", "es_reward_neg_mean", "es_update_norm"))
        print(f"(f) theta of {algo._theta.size} float64 values, update norm {r['es_update_norm']:.4f}, "
              f"central return {r['episode_return_central']}")
        if not r["es_update_norm"] > 0 or not np.isfinite(algo._theta).all():
            raise AssertionError(f"(f): no update: {r}")

    return rl_part("(f) ES, two runners", card, lambda: algo, 2, check)


def dreamer_part(card: str) -> dict:
    """(g) Dreamer on MinAtar Breakout at ``DreamerConfig``'s defaults
    (latent 128, batch 128, horizon 8, 16 updates an iteration): 3
    iterations of 400 steps (learning starts at 500); an update's time on
    the card (world model + actor-critic, between two syncs); then one
    ``wm_update`` + ``ac_update`` on the card against the CPU's from the same
    weights, batch and imagination draws, all fixed by the seed: the card
    twin's initial weights and rows sampled before the first update (the
    algorithm's replay draws are unseeded, as the reference's are). Adam's
    first step turns fp32 rounding in small gradients into weight gaps
    that vary with the inputs, up to the bound's order on some batches, so
    the gate's inputs must not vary between runs."""
    from ray_tpu_torch.rl.algorithms.dreamer import DreamerConfig

    def config(device=None):
        return (DreamerConfig().environment("MinAtarBreakout-v0").debugging(seed=RL_SEED)
                .resources(device=device))

    def check(algo, results):
        r = results[-1]
        check_finite("(g)", r, ("world_model_loss", "actor_loss", "critic_loss", "imagined_return_mean"))
        print(f"(g) world model loss by iteration {[round(x.get('world_model_loss', float('nan')), 5) for x in results]}, "
              f"dyn {r['dyn_loss']:.5f}, recon {r['recon_loss']:.5f}")

    def gate(algo):
        from ray_tpu_torch.rl.algorithms.dreamer import _BATCH_KEYS

        cfg = algo.config
        rng = np.random.default_rng(RL_SEED)
        before_learning = -(-cfg.learning_starts // cfg.sample_steps_per_iter) * cfg.sample_steps_per_iter
        idx = rng.integers(0, before_learning, cfg.train_batch_size)
        batch = {k: torch.from_numpy(algo.buffer._store[k][idx]) for k in _BATCH_KEYS}
        u = rng.random((cfg.imagination_horizon, cfg.train_batch_size, 3))
        gumbel = torch.from_numpy(-np.log(-np.log(u)).astype(np.float32))
        ms = timing["ms"] = []
        for _ in range(20):  # an update's time on the card: both halves between two syncs
            torch.cuda.synchronize()
            t = time.perf_counter()
            algo.wm_update({k: v.cuda() for k, v in batch.items()})
            algo.ac_update({k: v.cuda() for k, v in batch.items()}, gumbel.cuda())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        print(f"(g) [{card}]: an update (world model + actor-critic, batch {cfg.train_batch_size}) "
              f"median {np.median(ms):.3f} ms over 20")
        outs, mods, weights = [], [], None
        for device in (None, "cpu"):
            twin = config(device).build()
            try:
                if weights is None:  # the card twin's initial weights, from its seeded generator
                    weights = host_weights(twin.module)
                twin.set_weights(weights)
                dev = twin.device
                wl, parts = twin.wm_update({k: v.to(dev) for k, v in batch.items()})
                al, vl, ret = twin.ac_update({k: v.to(dev) for k, v in batch.items()}, gumbel.to(dev))
                outs.append([wl.item(), al.item(), vl.item(), ret.item()] + [v.item() for v in parts.values()])
                mods.append(host_weights(twin.module))
            finally:
                twin.stop()
        gap = rel_gap(outs[0], outs[1])
        for name in mods[1]:
            gap = max(gap, rel_gap(mods[0][name], mods[1][name]))
        print(f"(g) [{card}]: one wm_update + ac_update on the card against the CPU from the same weights, "
              f"batch and draws: largest gap {gap:.3e} over 8 losses and {len(mods[1])} tensors (bound {RL_TOL})")
        if not gap <= RL_TOL:
            raise AssertionError(f"(g): the card's Dreamer update differs from the CPU's by {gap:.3e}")
        return gap

    timing = {}
    out = rl_part("(g) Dreamer, MinAtar Breakout", card, lambda: config().build(), 3, check, gate)
    out["update_ms"] = float(np.median(timing["ms"]))
    return out


def multi_agent_part(card: str) -> dict:
    """(h) shared-policy PPO on ``EchoCoopEnv`` (2 agents, 32-step
    episodes) at 4 envs x 2 agents, 2 iterations."""
    from ray_tpu_torch.rl.multi_agent import EchoCoopEnv

    def check(algo, results):
        r = results[-1]
        check_finite("(h)", r, ("learner/loss", "learner/policy_loss"))
        print(f"(h) {algo._local_runner.vec.n} slots (4 envs x 2 agents), per-slot episode return "
              f"{[x['episode_return_mean'] for x in results]} (random play 20, the optimum 48)")

    return rl_part("(h) shared-policy PPO, EchoCoopEnv", card, lambda: PPOConfig().environment(
        lambda: EchoCoopEnv(episode_len=32)).env_runners(num_envs_per_env_runner=4, rollout_fragment_length=128)
        .training(train_batch_size=1024, minibatch_size=256, num_epochs=4).debugging(seed=RL_SEED).build(),
        2, check)


def rl_rest_on_card(card: str) -> dict:
    """Phase 30: (a) ``dqn_part``, (b)-(c) ``continuous_part`` for SAC, TD3
    and DDPG, (d) ``offline_part``, (e) ``async_part`` for IMPALA and APPO,
    (f) ``es_part``, (g) ``dreamer_part``, (h) ``multi_agent_part``."""
    from ray_tpu_torch.rl.algorithms.appo import APPOConfig
    from ray_tpu_torch.rl.algorithms.ddpg import DDPGConfig
    from ray_tpu_torch.rl.algorithms.impala import IMPALAConfig
    from ray_tpu_torch.rl.algorithms.sac import SACConfig
    from ray_tpu_torch.rl.algorithms.td3 import TD3Config

    gc.collect()
    torch.cuda.empty_cache()
    parts = {"DQN": dqn_part(card)}
    parts["SAC"] = continuous_part(card, "(b) SAC, Pendulum", SACConfig(),
                                   lambda rng, b: normal_draws(rng, next=(b, 1), pi=(b, 1)))
    for name, config in (("TD3", TD3Config()), ("DDPG", DDPGConfig())):
        parts[name] = continuous_part(card, f"(c) {name}, Pendulum", config,
                                      lambda rng, b: normal_draws(rng, target=(b, 1)))
    storage = tempfile.mkdtemp(prefix="phase30_")
    try:
        parts["BC"], parts["CQL"] = offline_part(card, storage)
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    ray_tpu_torch.init()
    try:
        # the three algorithms are built together, so their six runner
        # actors come up side by side (0.6 of the card), then run in turn
        t0 = time.perf_counter()
        with ThreadPoolExecutor(3) as pool:
            built = list(pool.map(lambda build: build(), (
                lambda: async_build(IMPALAConfig()), lambda: async_build(APPOConfig()), es_build)))
        build_s = time.perf_counter() - t0
        print(f"(e)-(f) IMPALA, APPO and ES built side by side, two runner actors each at GPU "
              f"{ENV_RUNNER_GPUS} [{card}]: {build_s:.1f} s")
        parts["IMPALA"] = async_part(card, "(e) IMPALA, two runners", built[0])
        parts["APPO"] = async_part(card, "(e) APPO, two runners", built[1])
        parts["ES"] = es_part(card, built[2])
    finally:
        ray_tpu_torch.shutdown()
    parts["Dreamer"] = dreamer_part(card)
    parts["PPO multi-agent"] = multi_agent_part(card)
    for name, p in parts.items():
        gap = "-" if p["gap"] is None else f"{p['gap']:.3e}"
        ms = "-" if np.isnan(p["update_ms"]) else f"{p['update_ms']:.3f} ms"
        print(f"phase 30 {name} [{card}]: {p['seconds']:.1f} s; iterations "
              f"{[round(s, 3) for s in p['iter_s']]} s; learner update median {ms}; "
              f"{p['steps_per_s']:.1f} {p['unit']}/s; card vs CPU {gap}")
    gc.collect()
    torch.cuda.empty_cache()
    return parts


# ---------------------------------------------------------------------------
# phase 31: operator tooling over a GPT-124M job
# ---------------------------------------------------------------------------

OPS_SEED = 31
OPS_REQUESTS, OPS_NEW = 16, 64  # (a): greedy requests, new tokens each
OPS_POOL_BATCHES, OPS_POOL_B = 8, 4  # (e): batches of OPS_POOL_B x seq_len ids
OPS_CLI = (  # (c): each exits 0
    ("top", "--once"), ("series", "llm_generated_tokens"), ("waterfall", "--probe", "200"),
    ("alerts", "--eval-once"), ("objects",), ("arena",),
)

# (a): the job's script, run by the job's supervisor with the path of a JSON
# file holding the seed, the engine config, the prompts and the new tokens.
# It attaches to the cluster that runs it and serves from a GPU actor.
OPS_JOB_SCRIPT = '''
import json, os, sys, time

import ray_tpu_torch

conf = json.load(open(sys.argv[1]))
ray_tpu_torch.init(address=os.environ["RAY_TPU_ADDRESS"])


class EngineHost:
    def serve(self, conf):
        import torch

        from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
        from ray_tpu_torch.models.gpt import GPTConfig, gpt_init
        from ray_tpu_torch.ops.paged_attention import paged_attention_cuda
        from ray_tpu_torch.util import metrics

        cfg = GPTConfig(**conf["model"])
        params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(conf["seed"]), "cuda")
        eng = LLMEngine(cfg, params, EngineConfig(**conf["engine"]))
        eng.warmup()
        sp = SamplingParams(max_tokens=conf["new"], temperature=0.0)
        t0 = time.perf_counter()
        reqs = [eng.submit(p, sp) for p in conf["prompts"]]
        while not all(r.finished for r in reqs):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hist = next(m for m in metrics._registry if m.name == "device_step_seconds")._snapshot()
        pcts = {}
        for site in ("decode", "prefill"):
            data = hist["data"][metrics._tag_key({"site": site})]
            pcts[site] = metrics._percentile_summary(hist["boundaries"], data, (0.5, 0.99))
        metrics.sample_series_now()
        metrics.flush()
        return dict(out=[list(r.out) for r in reqs], reasons=[r.finish_reason for r in reqs],
                    wall_s=wall, tokens_per_s=sum(len(r.out) for r in reqs) / wall, stats=eng.stats(),
                    launches=dict(eng.runner.launches), k1=paged_attention_cuda.launches,
                    prof=eng.runner.prof.stats(), pcts=pcts, device=torch.cuda.get_device_name(0))


host = ray_tpu_torch.remote(num_gpus=1)(EngineHost).remote()
result = ray_tpu_torch.get(host.serve.remote(conf), timeout=900)
print("PHASE31_JOB " + json.dumps(result), flush=True)
print(f"tokens/s {result['tokens_per_s']:.2f}; stats {json.dumps(result['stats'])}", flush=True)
ray_tpu_torch.kill(host)
ray_tpu_torch.shutdown()
'''


def ops_prompts() -> list:
    """(a)'s prompts: 16 of 64-256 ids over the whole vocabulary, numpy seed 31."""
    rng = np.random.RandomState(OPS_SEED)
    return [[int(t) for t in rng.randint(0, GPT_124M.vocab_size, n)]
            for n in rng.randint(64, 257, OPS_REQUESTS)]


def decode_prefill_counts() -> dict:
    """The cluster's ``device_step_seconds`` observations by site."""
    data = metrics.collect()["metrics"].get("device_step_seconds", {})
    return {site: int(data.get(metrics._tag_key({"site": site}), [0])[-1]) for site in ("decode", "prefill")}


class StubCollector:
    """An OTLP/HTTP collector on 127.0.0.1 that keeps every POST's path and
    JSON body (the export's HTTP sink, with no network)."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        posts = self.posts = []

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):  # noqa: N802 (BaseHTTPRequestHandler API)
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                posts.append((self.path, json.loads(body)))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def http_json(url: str, timeout: float = 30):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode()


def ops_job(card: str, tmp: str, env: dict) -> dict:
    """(a) the job, (b) the device-step profiler it fed."""
    conf = dict(seed=OPS_SEED, model=dataclasses.asdict(GPT_124M), engine={k: getattr(GPT_ENGINE, k) for k in
                                       ("max_slots", "block_size", "max_blocks_per_seq", "num_blocks",
                                        "prefill_chunk")},
                prompts=ops_prompts(), new=OPS_NEW)
    script, conf_path = os.path.join(tmp, "serve_job.py"), os.path.join(tmp, "job.json")
    Path(script).write_text(OPS_JOB_SCRIPT)
    Path(conf_path).write_text(json.dumps(conf))
    before = decode_prefill_counts()
    t0 = time.perf_counter()
    jid = job.submit_job(f"{sys.executable} {script} {conf_path}", env_vars={"PYTHONPATH": env["PYTHONPATH"]})
    status = job.wait_job(jid, timeout=600)
    job_s = time.perf_counter() - t0
    logs = job.get_job_logs(jid)
    line = next((ln for ln in logs.splitlines() if ln.startswith("PHASE31_JOB ")), None)
    if status != job.SUCCEEDED or line is None:
        raise AssertionError(f"(a) job {jid} ended {status}; its log:\n{logs[-4000:]}")
    r = json.loads(line[len("PHASE31_JOB "):])
    if "tokens/s" not in logs or r["reasons"] != ["length"] * OPS_REQUESTS:
        raise AssertionError(f"(a) the job's log lacks its tokens/s line, or a request ended early: {r['reasons']}")
    dec = r["launches"]["decode"]
    print(f"(a) job {jid} [{card}]: SUCCEEDED in {job_s:.2f} s from submit_job (script attaching through "
          f"RAY_TPU_ADDRESS, a num_gpus=1 actor on {r['device']}: GPT-124M from seed {OPS_SEED}, warmup, "
          f"{OPS_REQUESTS} greedy requests of {OPS_NEW} tokens); {r['tokens_per_s']:.2f} tokens/s over "
          f"{r['wall_s']:.3f} s; stats: steps {r['stats']['steps']}, decode steps {r['stats']['decode_steps']}, "
          f"tokens {r['stats']['tokens_generated']}, preemptions {r['stats']['preemptions']}, retraces "
          f"{r['stats']['retraces']}; K1 {r['k1']} = {GPT_124M.n_layers} x {dec} decode steps")
    if r["k1"] != GPT_124M.n_layers * dec:
        raise AssertionError(f"(a) K1 launched {r['k1']} times over {dec} decode steps")
    params = gpt_init(GPT_124M, torch.Generator(device="cuda").manual_seed(OPS_SEED), "cuda")
    sp = SamplingParams(max_tokens=OPS_NEW, temperature=0.0)
    check_greedy(GPT_124M, params, {i: (p, sp, SimpleNamespace(out=o), o) for i, (p, o) in
                                    enumerate(zip(conf["prompts"], r["out"]))}, "(a) the job's requests",
                 gpt_forward_plain)
    del params
    torch.cuda.empty_cache()
    # (b): every decode and prefill call noted once into the cluster's histogram
    after = decode_prefill_counts()
    grew = {site: after[site] - before[site] for site in after}
    print(f"(b) device-step profiler [{card}]: retraces {r['stats']['retraces']} after warmup and traffic "
          f"(per site {json.dumps({k: v['retraces'] for k, v in r['prof'].items()})}); the cluster's "
          f"device_step_seconds grew by {grew} over the runner's {r['launches']}; "
          + "; ".join(f"{site} p50 {p['p50'] * 1e3:.3f} ms, p99 {p['p99'] * 1e3:.3f} ms over {p['count']}"
                      for site, p in r["pcts"].items()))
    if r["stats"]["retraces"] != 0:
        raise AssertionError(f"(b) retraces after warmup: {r['prof']}")
    if grew != {site: r["launches"][site] for site in grew}:
        raise AssertionError(f"(b) device_step_seconds grew by {grew}, the runner ran {r['launches']}")
    return dict(job_id=jid, k1=r["k1"], decode=after["decode"], seconds=job_s)


def ops_cli(card: str, tmp: str, env: dict, decode_count: int) -> None:
    """(c): the obs CLI in subprocesses against the live cluster."""
    stub = StubCollector()
    out = os.path.join(tmp, "otlp.json")
    cmds = [list(c) for c in OPS_CLI] + [["export", "-o", out, "--post"]]
    t0 = time.perf_counter()
    metrics.sample_series_now()
    metrics.flush()
    try:
        procs = [subprocess.Popen([sys.executable, "-X", "faulthandler", "-m", "ray_tpu_torch.obs", *c],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                  env=dict(env, RAY_TPU_OTLP_ENDPOINT=stub.url) if c[0] == "export" else env)
                 for c in cmds]
        deadline, outs = time.monotonic() + 300, []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                p.send_signal(signal.SIGABRT)  # faulthandler prints where each of its threads waits
                outs.append(p.communicate(timeout=30)[0])
    finally:
        stub.close()
    took = time.perf_counter() - t0
    for c, p, text in zip(cmds, procs, outs):
        head = " | ".join(text.strip().splitlines()[:3])
        print(f"(c) obs {' '.join(c)}: exit {p.returncode}; {head[:300]}")
        if p.returncode != 0:
            raise AssertionError(f"(c) obs {' '.join(c)} exited {p.returncode}:\n{text[-3000:]}")
    doc = json.loads(Path(out).read_text())
    points = [dp for r in doc["resourceMetrics"] for sm in r["scopeMetrics"] for m in sm["metrics"]
              if m["name"] == "ray_tpu_device_step_seconds" for dp in m["histogram"]["dataPoints"]
              if {"key": "site", "value": {"stringValue": "decode"}} in dp["attributes"]]
    got = max((int(dp["count"]) for dp in points), default=None)
    paths = sorted({path for path, _ in stub.posts})
    posted = [m["name"] for path, body in stub.posts if path == "/v1/metrics"
              for r in body["resourceMetrics"] for sm in r["scopeMetrics"] for m in sm["metrics"]]
    print(f"(c) [{card}]: {len(cmds)} commands in {took:.2f} s (side by side); the export's "
          f"device_step_seconds{{site=decode}} reaches {got} = the cluster's {decode_count}; the stub collector "
          f"received POSTs to {paths} ({len(posted)} metrics)")
    if got != decode_count:
        raise AssertionError(f"(c) the export's site=decode count {got}, the cluster's {decode_count}")
    if paths != ["/v1/logs", "/v1/metrics", "/v1/traces"] or "ray_tpu_device_step_seconds" not in posted:
        raise AssertionError(f"(c) the stub collector received {paths}, metrics {posted}")


def ops_dashboard(card: str, url: str, job_id: str) -> None:
    """(d): the dashboard's routes over this cluster."""
    import re

    res = json.loads(http_json(url + "/api/cluster_resources"))
    jobs = json.loads(http_json(url + "/api/jobs"))
    deadline = time.monotonic() + 30
    while True:
        metrics.flush()
        text = http_json(url + "/metrics")
        if 'ray_tpu_core_resource_total{resource="GPU"}' in text or time.monotonic() > deadline:
            break
        time.sleep(0.5)
    gpu_line = next((ln for ln in text.splitlines() if ln.startswith('ray_tpu_core_resource_total{resource="GPU"}')),
                    None)
    board = json.loads(http_json(url + "/api/grafana"))
    exprs = " ".join(p["targets"][0]["expr"] for p in board["panels"])
    names = sorted(metrics.collect()["kinds"])
    bare = [n for n in names if not re.search(rf"ray_tpu_{re.escape(n)}(?:_bucket|_sum|_count)?(?![a-z0-9_])", exprs)]
    mine = next((j for j in jobs if j["job_id"] == job_id), None)
    print(f"(d) dashboard {url} [{card}]: cluster_resources total GPU {res['total'].get('GPU')}; /api/jobs "
          f"{job_id} {mine and mine['status']}; /metrics: {gpu_line}; /api/grafana: {len(board['panels'])} "
          f"panels covering all {len(names) - len(bare)} of {len(names)} metric names the cluster collected")
    if res["total"].get("GPU") != 1.0:
        raise AssertionError(f"(d) /api/cluster_resources {res}")
    if mine is None or mine["status"] != job.SUCCEEDED:
        raise AssertionError(f"(d) /api/jobs {jobs}")
    if gpu_line is None:
        raise AssertionError("(d) /metrics carries no core_resource_total{resource=\"GPU\"}")
    if bare:
        raise AssertionError(f"(d) /api/grafana has no panel for {bare}")


class PoolScorer:
    """(e): GPT-124M's training-path forward (K3 attention) on a share of
    the card, from the seed's weights; ``score`` sums each batch's token
    logprobs."""

    def __init__(self, seed: int):
        self.params = gpt_init(GPT_124M, torch.Generator(device="cuda").manual_seed(seed), "cuda")
        flash_fwd_cuda.launches = 0

    def score(self, tokens) -> float:
        return summed_logprob(self.params, torch.tensor(tokens).cuda())

    def launches(self) -> int:
        return flash_fwd_cuda.launches


def summed_logprob(params, tokens) -> float:
    """The summed logprob of ``tokens[:, 1:]`` under the forward over
    ``tokens`` (fp32 log-softmax of the fp32 logits)."""
    with torch.no_grad():
        logits = gpt_forward(GPT_124M, params, tokens)[:, :-1].float()
        return float(torch.log_softmax(logits, -1).gather(-1, tokens[:, 1:, None]).sum())


def ops_pool(card: str) -> dict:
    """(e): ``ActorPool`` over two half-card actors."""
    rng = np.random.RandomState(OPS_SEED)
    batches = [rng.randint(0, GPT_124M.vocab_size, (OPS_POOL_B, GPT_124M.seq_len)) for _ in range(OPS_POOL_BATCHES)]
    t0 = time.perf_counter()
    actors = [ray_tpu_torch.remote(num_gpus=0.5)(PoolScorer).remote(OPS_SEED) for _ in range(2)]
    pool = ActorPool(actors)
    got = list(pool.map(lambda a, b: a.score.remote(b), batches))
    took = time.perf_counter() - t0
    k3 = ray_tpu_torch.get([a.launches.remote() for a in actors], timeout=120)
    for a in actors:
        ray_tpu_torch.kill(a)
    params = gpt_init(GPT_124M, torch.Generator(device="cuda").manual_seed(OPS_SEED), "cuda")
    flash_fwd_cuda.launches = 0
    want = [summed_logprob(params, torch.from_numpy(b).cuda()) for b in batches]
    here = flash_fwd_cuda.launches
    x = params.lm_head.weight[:4]
    closure_ok, failures = inspect_serializability(lambda: x.sum())
    del params, x
    torch.cuda.empty_cache()
    gap = max(abs(g - w) / max(1.0, abs(w)) for g, w in zip(got, want))
    print(f"(e) ActorPool of 2 actors at num_gpus=0.5 [{card}]: {OPS_POOL_BATCHES} batches of {OPS_POOL_B} x "
          f"{GPT_124M.seq_len} ids scored in {took:.2f} s (actors' start included); summed logprobs "
          f"{[round(g, 2) for g in got]}; largest gap to the in-process forward {gap:.3e} relative to max(1, |ref|) "
          f"(limit {TOL[torch.bfloat16]}); K3 launches in the actors {k3} (in process {here}); a closure over a "
          f"CUDA tensor serializable: {closure_ok}")
    if not all(np.isfinite(got)) or gap > TOL[torch.bfloat16]:
        raise AssertionError(f"(e) summed logprobs {got} against the in-process {want}")
    if sum(k3) != GPT_124M.n_layers * OPS_POOL_BATCHES or min(k3) == 0:
        raise AssertionError(f"(e) K3 launched {k3} times in the actors, expected {GPT_124M.n_layers} a batch "
                             "in each")
    if not closure_ok or failures:
        raise AssertionError(f"(e) a closure over a CUDA tensor inspected as unserializable: {failures}")
    return dict(k3=sum(k3), seconds=took)


def operator_tooling(card: str) -> dict:
    """Phase 31: ``ops_job`` ((a)-(b)), ``ops_cli`` ((c)), ``ops_dashboard``
    ((d)) and ``ops_pool`` ((e)) over one runtime with the card."""
    from ray_tpu_torch._private.runtime import get_ctx

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    ray_tpu_torch.init()
    tmp = tempfile.mkdtemp(prefix="phase31_")
    try:
        if ray_tpu_torch.cluster_resources().get("GPU") != 1.0:
            raise AssertionError(f"init() offers {ray_tpu_torch.cluster_resources()}")
        ctx = get_ctx()
        host, port = ctx.head.listen_tcp("127.0.0.1", 0)
        url = dashboard.start(host="127.0.0.1", port=0)
        root = os.path.dirname(os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)))
        env = dict(os.environ, PYTHONPATH=root, RAY_TPU_ADDRESS=f"{host}:{port}",
                   RAY_TPU_AUTHKEY=ctx.call("auth_info"))
        env.pop("RAY_TPU_OTLP_ENDPOINT", None)
        ran = ops_job(card, tmp, env)
        ops_cli(card, tmp, env, ran["decode"])
        ops_dashboard(card, url, ran["job_id"])
        pooled = ops_pool(card)
    finally:
        dashboard.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        ray_tpu_torch.shutdown()
    return dict(k1=ran["k1"], k3=pooled["k3"], seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# phase 32: the CLI and the autoscaler on the card
# ---------------------------------------------------------------------------

CLI_SEED = 32
CLI_REQUESTS, CLI_NEW = 8, 32  # greedy requests of 64-256 prompt ids, new tokens each
CLI_IDLE_S, CLI_TICK_S = 5.0, 0.5  # (b): the cluster config's idle_timeout_s and update_interval_s
# (b): the cluster config of `up`, written as .json (JSON is YAML too): the
# fake provider, a CPU head, one GPU node type
CLI_CLUSTER = {
    "cluster_name": "p32",
    "provider": {"type": "fake"},
    "head": {"num_cpus": 2},
    "node_types": {"gpu_worker": {"resources": {"GPU": 1, "CPU": 4}, "min_workers": 0, "max_workers": 1}},
    "idle_timeout_s": CLI_IDLE_S,
    "update_interval_s": CLI_TICK_S,
}
# (a): state commands run side by side against the CLI's head, each exits 0
CLI_STATE = (("summary",), ("list", "actors"), ("list", "nodes"), ("node-stats",), ("stacks",))
# a node agent retries a lost head for head_reconnect_grace_s (30 s by
# default) before it exits: the phase's agent waits 1 s
CLI_AGENT_GRACE_S = "1"


def cli_generate(eng: LLMEngine, prompts: list, new: int) -> list:
    """Greedy ``new`` tokens for each prompt, all submitted at once and
    stepped to their ends."""
    sp = SamplingParams(max_tokens=new, temperature=0.0)
    reqs = [eng.submit(p, sp) for p in prompts]
    while not all(r.finished for r in reqs):
        eng.step()
    return [list(r.out) for r in reqs]


class CLIEngineHost:
    """Phase 32's ``num_gpus=1`` actor: GPT-124M in bf16 from a CUDA
    generator seeded ``CLI_SEED``, phase 19's engine config, built and
    warmed up in ``__init__``. It raises without a CUDA device. ``info``
    has its clocks: entering ``__init__`` (its class, and torch with it,
    loaded), the card's context up, the engine built, warmed up."""

    def __init__(self):
        import os

        self.clocks = [time.time()]
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: phase 32's actor serves GPT-124M on the card only")
        self.pid = os.getpid()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        self.clocks.append(time.time())
        params = gpt_init(GPT_124M, torch.Generator(device="cuda").manual_seed(CLI_SEED), "cuda")
        self.engine = LLMEngine(GPT_124M, params, GPT_ENGINE)
        torch.cuda.synchronize()
        self.clocks.append(time.time())
        self.engine.warmup()
        torch.cuda.synchronize()
        self.clocks.append(time.time())

    def info(self) -> dict:
        return dict(node=ray_tpu_torch.get_runtime_context().get_node_id(), pid=self.pid,
                    device=torch.cuda.get_device_name(0), clocks=self.clocks)

    def generate(self, prompts: list, new: int) -> dict:
        """``cli_generate`` with the K1 and decode-step counts set to 0
        just before and read just after."""
        paged_attention_cuda.launches = 0
        self.engine.runner.launches = dict.fromkeys(self.engine.runner.launches, 0)
        out = cli_generate(self.engine, prompts, new)
        return dict(out=out, k1=paged_attention_cuda.launches, decode=self.engine.runner.launches["decode"],
                    **self.info())


def cli_prompts() -> list:
    """8 prompts of 64-256 ids over the whole vocabulary, numpy seed 32."""
    rng = np.random.RandomState(CLI_SEED)
    return [[int(t) for t in rng.randint(0, GPT_124M.vocab_size, n)]
            for n in rng.randint(64, 257, CLI_REQUESTS)]


def cli_reference(prompts: list) -> tuple:
    """The actor's engine in this process: its tokens for ``prompts``, and
    the weights (for the dense forward's check)."""
    params = gpt_init(GPT_124M, torch.Generator(device="cuda").manual_seed(CLI_SEED), "cuda")
    eng = LLMEngine(GPT_124M, params, GPT_ENGINE)
    eng.warmup()
    want = cli_generate(eng, prompts, CLI_NEW)
    del eng
    torch.cuda.empty_cache()
    return want, params


def cli_ready(actor, t_req: float) -> tuple:
    """The actor's ``info`` once it is up, and the seconds from its request
    (``t_req``, wall clock) to its ``__init__`` (the worker's start and the
    class's load), the card's context, the engine's build and warmup."""
    info = ray_tpu_torch.get(actor.info.remote(), timeout=300)
    c = info["clocks"]
    split = dict(ready=c[-1] - t_req, start=c[0] - t_req, cuda=c[1] - c[0], build=c[2] - c[1], warmup=c[3] - c[2])
    return info, split


def cli_split(split: dict) -> str:
    return (f"ready {split['ready']:.2f} s after the request = worker start and class load {split['start']:.2f} s "
            f"+ CUDA context {split['cuda']:.2f} s + GPT-124M built {split['build']:.2f} s + warmup "
            f"{split['warmup']:.2f} s")


class GPUTotal:
    """Polls the attached cluster's ``GPU`` total every 50 ms in a thread:
    the largest value seen, and when it first read above 0."""

    def __init__(self):
        self.most, self.first_up, self.polls = 0.0, None, 0
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self.run, daemon=True)
        self.thread.start()

    def run(self) -> None:
        while not self.stop.is_set():
            gpu = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
            now = time.perf_counter()
            self.polls += 1
            self.most = max(self.most, gpu)
            if gpu > 0:
                self.first_up = self.first_up or now
            self.stop.wait(0.05)

    def close(self) -> None:
        self.stop.set()
        self.thread.join(timeout=10)


def cli_popen(env: dict, log: str, *args) -> subprocess.Popen:
    """``python -m ray_tpu_torch <args>`` with its output in ``log``."""
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-m", "ray_tpu_torch", *args], stdout=f,
                                stderr=subprocess.STDOUT, env=env)


def cli_wait_line(proc: subprocess.Popen, log: str, needle: str, timeout: float = 120) -> str:
    """The first line of ``log`` holding ``needle``; fails if the process
    exits or the time runs out first."""
    deadline = time.monotonic() + timeout
    while True:
        line = next((ln for ln in Path(log).read_text().splitlines() if needle in ln), None)
        if line is not None:
            return line
        if proc.poll() is not None or time.monotonic() > deadline:
            raise AssertionError(f"{' '.join(proc.args[2:])} printed no {needle!r} (exit {proc.poll()}):\n"
                                 + Path(log).read_text()[-3000:])
        time.sleep(0.05)


def cli_run(env: dict, *args, timeout: float = 120) -> str:
    """``python -m ray_tpu_torch <args>`` to its end; fails unless it exits 0
    within ``timeout``. One still running then gets SIGABRT, so faulthandler
    prints where each of its threads waits."""
    p = subprocess.Popen([sys.executable, "-X", "faulthandler", "-m", "ray_tpu_torch", *args],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.send_signal(signal.SIGABRT)
        out, err = p.communicate(timeout=30)
        raise AssertionError(f"ray_tpu_torch {' '.join(args)} still running after {timeout} s:\n{out[-2000:]}\n"
                             f"{err[-6000:]}") from None
    if p.returncode != 0:
        raise AssertionError(f"ray_tpu_torch {' '.join(args)} exited {p.returncode}:\n{out[-2000:]}\n"
                             f"{err[-3000:]}")
    return out


def cli_doc(out: str):
    """The JSON document a command printed: it starts at the first line that
    is ``{``, ``[`` or ``[]`` (a runtime warning before it may hold braces)."""
    lines = out.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln in ("{", "[", "[]"))
    return json.loads("\n".join(lines[start:]))


def cli_status(env: dict, address: str) -> dict:
    return cli_doc(cli_run(env, "status", "--address", address))


def cli_stop(proc: subprocess.Popen, label: str, timeout: float) -> tuple:
    """SIGTERM, then the exit code and the seconds to exit."""
    t0 = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{label} still running {timeout} s after SIGTERM") from None
    return rc, time.perf_counter() - t0


def cli_reap(*procs) -> None:
    """Every process the phase started ends with it."""
    for p in procs:
        if p is not None and p.poll() is None:
            p.kill()
            p.wait(timeout=30)


def check_cli_tokens(got: dict, want: list, params, prompts: list, label: str) -> int:
    """The actor's tokens against the in-process engine's: equal bit for bit,
    or each request's tokens within the bf16 top-2 margin of the dense
    forward (``check_greedy``). Returns the requests that differ."""
    differ = [i for i, (g, w) in enumerate(zip(got["out"], want)) if g != w]
    if len(got["out"]) != len(want) or any(len(o) != CLI_NEW for o in got["out"]):
        raise AssertionError(f"{label}: {len(got['out'])} outputs of lengths {[len(o) for o in got['out']]}")
    if differ:
        sp = SamplingParams(max_tokens=CLI_NEW, temperature=0.0)
        check_greedy(GPT_124M, params, {i: (prompts[i], sp, SimpleNamespace(out=got["out"][i]), None)
                                        for i in differ}, label, gpt_forward_plain)
    if got["k1"] <= 0 or got["k1"] != GPT_124M.n_layers * got["decode"]:
        raise AssertionError(f"{label}: K1 launched {got['k1']} times over {got['decode']} decode steps")
    return len(differ)


def cli_head(card: str, tmp: str, env: dict, prompts: list, gpus: int) -> dict:
    """(a): ``start --head``, ``start --address``, a driver's GPU actor, the
    state CLI and a job, then the head's SIGTERM. While the actor comes up,
    ``cli_reference`` runs here."""
    from ray_tpu_torch.accelerators import gpu as gpu_accel

    t0 = time.perf_counter()
    head = cli_popen(env, os.path.join(tmp, "head.log"), "start", "--head", "--port", "0", "--num-cpus", "4")
    node = watch = None
    try:
        line = cli_wait_line(head, os.path.join(tmp, "head.log"), "head listening on")
        address = line.rsplit(" ", 1)[-1]
        head_s = time.perf_counter() - t0
        doc = cli_status(env, address)
        gpu_key = f"GPU-{gpu_accel.accelerator_type()}"
        res = doc["cluster_resources"]
        print(f"(a) start --head [{card}]: listening on {address} after {head_s:.2f} s; status: cluster "
              f"resources {json.dumps(res)}")
        if res.get("GPU") != float(gpus) or res.get(gpu_key) != float(gpus) or res.get("CPU") != 4.0:
            raise AssertionError(f"(a) the head registered {res}, expected GPU {gpus} and {gpu_key} (detect_num_gpus)")
        node_log = os.path.join(tmp, "node.log")
        node = cli_popen(env, node_log, "start", "--address", address, "--num-cpus", "2",
                         "--labels", json.dumps({"provider_node_id": "p32"}))
        cli_wait_line(node, node_log, "joined")
        nodes = cli_status(env, address)["nodes"]
        alive = [n for n in nodes if n["Alive"]]
        labelled = [n for n in alive if n["Labels"].get("provider_node_id") == "p32"]
        print(f"(a) start --address: status lists {len(alive)} live nodes, labels "
              f"{[n['Labels'] for n in alive]}")
        if len(alive) != 2 or len(labelled) != 1 or labelled[0]["Resources"].get("CPU") != 2.0:
            raise AssertionError(f"(a) status after the join: {nodes}")

        ray_tpu_torch.init(address=address)
        watch = GPUTotal()
        t_req = time.time()
        actor = ray_tpu_torch.remote(num_gpus=1)(CLIEngineHost).remote()
        want, params = cli_reference(prompts)
        info, split = cli_ready(actor, t_req)
        got = ray_tpu_torch.get(actor.generate.remote(prompts, CLI_NEW), timeout=600)
        differ = check_cli_tokens(got, want, params, prompts, "(a) the head's actor")
        head_node = next(n["NodeID"] for n in alive if not n["Labels"])
        print(f"(a) driver attached by address; num_gpus=1 actor (pid {info['pid']}, {info['device']}, GPT-124M "
              f"from seed {CLI_SEED}) {cli_split(split)}, on the "
              f"{'head' if info['node'] == head_node else 'JOINED'} node; {CLI_REQUESTS} greedy requests of "
              f"{CLI_NEW} tokens: {CLI_REQUESTS - differ} equal to the in-process engine's bit for bit, {differ} "
              f"within the top-2 margin; K1 {got['k1']} = {GPT_124M.n_layers} x {got['decode']} decode steps")
        if info["node"] != head_node:
            raise AssertionError(f"(a) the GPU actor ran on {info['node']}, not the head's node {head_node}")

        # the state CLI and a job, side by side
        t2 = time.perf_counter()
        outs = {"timeline": os.path.join(tmp, "timeline.json"), "grafana": os.path.join(tmp, "grafana.json")}
        cmds = [[*c, "--address", address] for c in CLI_STATE] + [
            ["timeline", "--address", address, "--output", outs["timeline"]],
            ["grafana", "-o", outs["grafana"]],
            # the entrypoint takes every argument after the action, so a
            # job command's options come before it
            ["job", "--address", address, "submit", "--", sys.executable, "-c", "print(1)"]]
        with ThreadPoolExecutor(len(cmds)) as pool:
            texts = list(pool.map(lambda c: cli_run(env, *c), cmds))
        jid = texts[-1].strip().splitlines()[-1]
        if job.wait_job(jid, timeout=120) != job.SUCCEEDED:
            raise AssertionError(f"(a) job {jid} ended {job.get_job_status(jid)}")
        status = cli_run(env, "job", "--address", address, "--job-id", jid, "status").strip().splitlines()[-1]
        logs = cli_run(env, "job", "--address", address, "--job-id", jid, "logs")
        cli_s = time.perf_counter() - t2
        summary, actors, listed = cli_doc(texts[0]), cli_doc(texts[1]), cli_doc(texts[2])
        trace = json.loads(Path(outs["timeline"]).read_text())
        board = json.loads(Path(outs["grafana"]).read_text())
        mine = [a for a in actors if a.get("class_name") == "CLIEngineHost"]
        print(f"(a) CLI [{card}]: {' | '.join(' '.join(c[:2]) for c in cmds)}, job status, job logs exit 0 in "
              f"{cli_s:.2f} s (side by side, then the job's two); summary: "
              f"{len(summary['nodes'])} nodes, actors {json.dumps(summary.get('actors', {}))[:160]}; list "
              f"actors: {[(a.get('class_name'), a.get('state')) for a in actors]}; list nodes: {len(listed)}; "
              f"node-stats and stacks {len(texts[3])} and {len(texts[4])} bytes; timeline {len(trace)} events; "
              f"grafana {len(board['panels'])} panels; job {jid} {status}, logs {logs.strip()[:120]!r}")
        if len(listed) != 2 or [a.get("state") for a in mine] != ["ALIVE"] or not trace or not board["panels"]:
            raise AssertionError(f"(a) the CLI's view: nodes {listed}, actors {actors}, {len(trace)} timeline "
                                 f"events, {len(board['panels'])} panels")
        if status != job.SUCCEEDED or logs.splitlines()[:1] != ["1"]:
            raise AssertionError(f"(a) job status {status!r}, logs {logs!r}")
        ray_tpu_torch.kill(actor)
        watch.close()
        ray_tpu_torch.shutdown()
        rc, stop_s = cli_stop(head, "(a) the head", 10)
        agent_rc = node.wait(timeout=30)
        print(f"(a) SIGTERM: the head exited {rc} in {stop_s:.2f} s, the node agent exited {agent_rc} "
              f"(reconnect grace {CLI_AGENT_GRACE_S} s); the GPU total read at most {watch.most} over "
              f"{watch.polls} polls")
        if rc != 0 or agent_rc != 0:
            raise AssertionError(f"(a) the head exited {rc}, the node agent {agent_rc}")
    finally:
        if watch is not None:
            watch.close()
        ray_tpu_torch.shutdown()
        cli_reap(head, node)
    return dict(k1=got["k1"], out=got["out"], most=watch.most, ready_s=split["ready"], cli_s=cli_s,
                want=want, params=params, seconds=time.perf_counter() - t0)


def cli_up(card: str, tmp: str, env: dict, prompts: list, want: list, params, a_out: list) -> dict:
    """(b): ``up`` with the fake provider buys the GPU node on demand and
    reaps it when idle; ``down``. The actor's tokens equal (a)'s."""
    t0 = time.perf_counter()
    cfg_path = os.path.join(tmp, "p32.json")
    Path(cfg_path).write_text(json.dumps(CLI_CLUSTER, indent=2))
    log = os.path.join(tmp, "up.log")
    up = cli_popen(env, log, "up", cfg_path)
    watch = None
    try:
        line = cli_wait_line(up, log, "head listening on")
        address = line.rsplit(" ", 1)[-1]
        before = cli_status(env, address)
        print(f"(b) up {os.path.basename(cfg_path)} [{card}]: {line.strip()} after {time.perf_counter() - t0:.2f} s; "
              f"status before any demand: cluster resources {json.dumps(before['cluster_resources'])}")
        if before["cluster_resources"].get("GPU", 0.0) != 0.0 or len(before["nodes"]) != 1:
            raise AssertionError(f"(b) status before any demand: {before}")
        ray_tpu_torch.init(address=address)
        watch = GPUTotal()
        t1, t_req = time.perf_counter(), time.time()
        actor = ray_tpu_torch.remote(num_gpus=1)(CLIEngineHost).remote()
        info, split = cli_ready(actor, t_req)
        scale_up_s = watch.first_up - t1 if watch.first_up else None
        nodes = ray_tpu_torch.nodes()
        gpu_nodes = [n for n in nodes if n["Alive"] and n["Resources"].get("GPU", 0) > 0]
        head_node = next(n["NodeID"] for n in nodes if not n["Labels"])
        print(f"(b) num_gpus=1 actor requested with no GPU node: the autoscaler bought "
              f"{[(n['Labels'], n['Resources']) for n in gpu_nodes]} {scale_up_s:.2f} s after the request; the "
              f"actor (pid {info['pid']}, {info['device']}) {cli_split(split)}, on node {info['node'][:12]} (the "
              f"head's {head_node[:12]})")
        if len(gpu_nodes) != 1 or gpu_nodes[0]["NodeID"] != info["node"] or info["node"] == head_node:
            raise AssertionError(f"(b) GPU nodes {gpu_nodes}, the actor on {info['node']}, the head {head_node}")
        if "instance_id" not in gpu_nodes[0]["Labels"]:
            raise AssertionError(f"(b) the GPU node carries no instance_id label: {gpu_nodes[0]['Labels']}")
        got = ray_tpu_torch.get(actor.generate.remote(prompts, CLI_NEW), timeout=600)
        differ = check_cli_tokens(got, want, params, prompts, "(b) the autoscaled node's actor")
        print(f"(b) {CLI_REQUESTS} greedy requests on the autoscaled node: {CLI_REQUESTS - differ} equal to the "
              f"in-process engine's bit for bit, {differ} within the top-2 margin; K1 {got['k1']} = "
              f"{GPT_124M.n_layers} x {got['decode']} decode steps")
        # scale-down: one tick sees the node idle, idle_timeout_s later a
        # tick marks it TERMINATING and the next terminates it; the limit
        # adds 0.5 s for the kill and the ticks' own work
        limit = CLI_IDLE_S + 2 * CLI_TICK_S + 0.5
        t2 = time.perf_counter()
        ray_tpu_torch.kill(actor)
        while ray_tpu_torch.cluster_resources().get("GPU", 0.0) > 0:
            if time.perf_counter() - t2 > limit + 30:
                break
            time.sleep(0.05)
        down_s = time.perf_counter() - t2
        watch.close()
        after = cli_status(env, address)
        print(f"(b) actor killed: the idle GPU node was terminated and its GPU gone from the cluster "
              f"{down_s:.2f} s later (limit idle_timeout_s {CLI_IDLE_S} + 2 ticks of {CLI_TICK_S} s + 0.5 s for "
              f"the kill and the ticks' own work = {limit:.1f} s); status: cluster resources "
              f"{json.dumps(after['cluster_resources'])}, {sum(n['Alive'] for n in after['nodes'])} live node(s); the "
              f"GPU total read at most {watch.most} over {watch.polls} polls")
        if after["cluster_resources"].get("GPU", 0.0) != 0.0 or down_s > limit:
            raise AssertionError(f"(b) {down_s:.2f} s after the kill status shows {after['cluster_resources']}")
        ray_tpu_torch.shutdown()
        rc, stop_s = cli_stop(up, "(b) up", 30)
        counts_line = next((ln for ln in Path(log).read_text().splitlines() if "] instances: " in ln), "")
        counts = json.loads(counts_line.split("instances: ", 1)[1]) if counts_line else None
        down = cli_run(env, "down", cfg_path).strip()
        print(f"(b) SIGTERM: up exited {rc} in {stop_s:.2f} s printing {counts_line.strip()!r}; down: {down!r}")
        if rc != 0 or counts != {"TERMINATED": 1}:
            raise AssertionError(f"(b) up exited {rc} with instances {counts}:\n{Path(log).read_text()[-3000:]}")
        if "[p32] terminated 0 instance(s)" not in down:
            raise AssertionError(f"(b) down printed {down!r}")
        if got["out"] != a_out:
            raise AssertionError("(b) the autoscaled node's tokens differ from (a)'s")
    finally:
        if watch is not None:
            watch.close()
        ray_tpu_torch.shutdown()
        cli_reap(up)
    return dict(k1=got["k1"], most=watch.most, scale_up_s=scale_up_s, ready_s=split["ready"], down_s=down_s,
                seconds=time.perf_counter() - t0)


def cli_and_autoscaler(card: str) -> dict:
    """Phase 32: ``cli_head`` ((a)) and ``cli_up`` ((b)), every process a
    ``python -m ray_tpu_torch`` started here, the driver attached by
    address; the in-process engine's tokens (``cli_reference``) are the
    reference."""
    from ray_tpu_torch.accelerators import gpu as gpu_accel

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    gpus = gpu_accel.detect_num_gpus()
    if gpus != torch.cuda.device_count():
        raise AssertionError(f"detect_num_gpus() {gpus}, torch sees {torch.cuda.device_count()} card(s)")
    prompts = cli_prompts()
    tmp = tempfile.mkdtemp(prefix="phase32_")
    root = os.path.dirname(os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)))
    key = os.urandom(16).hex()
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, PYTHONPATH=path, RAY_TPU_AUTHKEY=key, RAY_TPU_HEAD_RECONNECT_GRACE_S=CLI_AGENT_GRACE_S)
    saved_key = os.environ.get("RAY_TPU_AUTHKEY")
    os.environ["RAY_TPU_AUTHKEY"] = key  # the driver attaches with the CLI's key
    try:
        a = cli_head(card, tmp, env, prompts, gpus)
        b = cli_up(card, tmp, env, prompts, a.pop("want"), a.pop("params"), a["out"])
    finally:
        if saved_key is None:
            os.environ.pop("RAY_TPU_AUTHKEY", None)
        else:
            os.environ["RAY_TPU_AUTHKEY"] = saved_key
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    most = max(a["most"], b["most"])
    if most > gpus:
        raise AssertionError(f"the cluster's GPU total reached {most}, above the card count {gpus}")
    return dict(k1=a["k1"] + b["k1"], seconds=time.perf_counter() - t_phase, a=a, b=b)


# ---------------------------------------------------------------------------
# phase 33: a durable GPT-124M workflow
# ---------------------------------------------------------------------------

WF_SEED = 33
WF_REQUESTS, WF_NEW = 8, 32  # greedy requests of 64-256 prompt ids, new tokens each
WF_ID = "gpt124m"
WF_KILL_S = 20.0  # (a): the killed driver's processes must be gone within this
# (a): the card's free memory after the kill may fall short of the level
# before driver 1 by this much: this process's own CUDA context grows as the
# in-process reference loads its kernels (by 0.20 GB on the H100), while the
# killed GPU worker held GPT-124M, its KV pool and a context (over 1 GB)
WF_FREE_SLACK = 512 << 20


def wf_prompt_list() -> list:
    """8 prompts of 64-256 ids over the whole vocabulary, numpy seed 33."""
    rng = np.random.RandomState(WF_SEED)
    return [[int(t) for t in rng.randint(0, GPT_124M.vocab_size, n)] for n in rng.randint(64, 257, WF_REQUESTS)]


@ray_tpu_torch.remote
def wf_prompts() -> list:
    """The workflow's first step (CPU): ``wf_prompt_list()``."""
    return wf_prompt_list()


def wf_clocks_up() -> list:
    """A GPU step's clocks: entering the step (the worker started and the
    step's code, torch with it, loaded), then the card's context up."""
    clocks = [time.time()]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: phase 33's GPU steps run on the card only")
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    clocks.append(time.time())
    return clocks


def wf_weights():
    return gpt_init(GPT_124M, torch.Generator(device="cuda").manual_seed(WF_SEED), "cuda")


@ray_tpu_torch.remote(num_gpus=1)
def wf_generate(prompts: list) -> dict:
    """``num_gpus=1``: GPT-124M (bf16, seed 33) in the paged engine with
    phase 19's config, warmed up, then ``WF_NEW`` greedy tokens a prompt
    (K1 in every decode step); the tokens as plain ints, with the K1 and
    decode-step counts set to 0 just before and read just after, and the
    step's clocks (entered, CUDA context, built, generated)."""
    clocks = wf_clocks_up()
    eng = LLMEngine(GPT_124M, wf_weights(), GPT_ENGINE)
    eng.warmup()
    torch.cuda.synchronize()
    clocks.append(time.time())
    paged_attention_cuda.launches = 0
    eng.runner.launches = dict.fromkeys(eng.runner.launches, 0)
    out = cli_generate(eng, prompts, WF_NEW)
    torch.cuda.synchronize()
    clocks.append(time.time())
    return dict(prompts=prompts, tokens=out, k1=paged_attention_cuda.launches, decode=eng.runner.launches["decode"],
                clocks=clocks, pid=os.getpid(), device=torch.cuda.get_device_name(0))


def continuation_logprob(params, prompt: list, out: list) -> float:
    """The summed logprob of ``out`` after ``prompt`` under teacher forcing:
    one forward over prompt + out (flash attention, K3, on the card), fp32
    log-softmax of the fp32 logits at the positions that predict ``out``."""
    tokens = torch.tensor([prompt + out], device="cuda")
    with torch.no_grad():
        logits = gpt_forward(GPT_124M, params, tokens)[0, len(prompt) - 1 : -1].float()
        return float(torch.log_softmax(logits, -1).gather(-1, tokens[0, len(prompt):, None]).sum())


@ray_tpu_torch.remote(num_gpus=1)
def wf_score(generated: dict, go) -> dict:
    """``num_gpus=1``: each continuation's summed logprob under the same
    weights (``continuation_logprob``), with the K1 and K3 counts set to 0
    just before and read just after, and the step's clocks (entered, CUDA
    context, built, scored)."""
    clocks = wf_clocks_up()
    params = wf_weights()
    torch.cuda.synchronize()
    clocks.append(time.time())
    paged_attention_cuda.launches = flash_fwd_cuda.launches = 0
    scores = [continuation_logprob(params, p, o) for p, o in zip(generated["prompts"], generated["tokens"])]
    torch.cuda.synchronize()
    clocks.append(time.time())
    return dict(scores=scores, k1=paged_attention_cuda.launches, k3=flash_fwd_cuda.launches, forwards=len(scores),
                clocks=clocks, go=go, pid=os.getpid())


@ray_tpu_torch.remote
def wf_finish(generated: dict, scored: dict) -> dict:
    """The continuation's one step (CPU): the workflow's output."""
    return dict(generate=generated, score=scored)


@ray_tpu_torch.remote
def wf_summarize(generated: dict, scored: dict):
    """The workflow's tail step: a continuation of one CPU step."""
    return workflow.continuation(wf_finish.bind(generated, scored))


def wf_dag():
    """prompts -> generate -> score (with the "go" event) -> summarize."""
    generated = wf_generate.bind(wf_prompts.bind())
    return wf_summarize.bind(generated, wf_score.bind(generated, workflow.wait_for_event("go")))


class RunLedger:
    """Phase 33's virtual actor: the workflow runs that finished."""

    def __init__(self):
        self.runs = []

    def record(self, workflow_id: str, tokens: int) -> int:
        self.runs.append([workflow_id, tokens])
        return len(self.runs)

    @workflow.readonly
    def finished(self) -> list:
        return self.runs


def wf_driver(mode: str, storage: str) -> int:
    """A phase-33 driver, this script run as ``--workflow-driver run|resume
    STORAGE`` in a process of its own with its own cluster (``init()``):
    ``run`` starts the workflow (the phase kills it mid-way); ``resume``
    resumes it, resumes it again, records the run in ``RunLedger`` and
    prints a ``RESULT`` line."""
    ray_tpu_torch.init()
    up = time.time()
    if mode == "run":
        workflow.run(wf_dag(), workflow_id=WF_ID, storage=storage)
        return 1  # the phase kills this driver before the workflow can finish
    out = workflow.resume(WF_ID, storage=storage)
    done = time.time()
    n_events = len(workflow.get_events(WF_ID, storage))
    again = workflow.resume(WF_ID, storage=storage)
    ledger = workflow.virtual_actor(RunLedger).get_or_create("runs", storage=storage)
    ledger.record(WF_ID, sum(len(t) for t in out["generate"]["tokens"]))
    res = dict(out=out, up=up, done=done, again=again == out,
               again_events=len(workflow.get_events(WF_ID, storage)) - n_events,
               status=workflow.get_status(WF_ID, storage), output=workflow.get_output(WF_ID, storage) == out,
               finished=workflow.get_actor("runs", RunLedger, storage=storage).finished())
    ray_tpu_torch.shutdown()
    print("RESULT " + json.dumps(res), flush=True)
    return 0


def session_pids(sid: int) -> list[int]:
    """The live processes of session ``sid`` (a driver started with
    ``start_new_session``: its head's template and workers stay in it)."""
    pids = []
    for name in os.listdir("/proc"):
        if name.isdigit() and process_alive(int(name)):
            try:
                if os.getsid(int(name)) == sid:
                    pids.append(int(name))
            except OSError:
                pass  # exited while listed
    return pids


def wf_reference(prompts: list) -> tuple:
    """The workflow's path in this process: the same weights and prompts
    through the engine (K1) and the forward (K3)."""
    params = wf_weights()
    eng = LLMEngine(GPT_124M, params, GPT_ENGINE)
    eng.warmup()
    tokens = cli_generate(eng, prompts, WF_NEW)
    scores = [continuation_logprob(params, p, o) for p, o in zip(prompts, tokens)]
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return tokens, scores


def wf_kill(card: str, storage: str, env: dict, log: str, meanwhile) -> tuple:
    """(a): driver 1 runs the workflow (``meanwhile()`` runs here as it
    comes up); once ``generate``'s commit is in the event log it is
    SIGKILLed, and every process of its session must be gone, the card's
    compute apps and free memory back to what they were before it started
    (this process's alone), and the status still ``RUNNING``."""
    gc.collect()
    torch.cuda.empty_cache()
    free0, apps0 = torch.cuda.mem_get_info()[0], compute_apps()
    t0 = time.time()
    with open(log, "w") as f:
        driver = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--workflow-driver", "run", storage],
                                  stdout=f, stderr=subprocess.STDOUT, env=env, start_new_session=True)
    try:
        here = meanwhile()
        deadline = time.monotonic() + 600
        while True:
            done = [e for e in workflow.get_events(WF_ID, storage)
                    if e["type"] == "step_completed" and "_wf_generate_" in e["step_id"]]
            if done:
                break
            if driver.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"(a) driver 1 exited {driver.poll()} before generate's commit:\n"
                                     + Path(log).read_text()[-3000:])
            time.sleep(0.02)
        before_kill = session_pids(driver.pid)
        os.kill(driver.pid, signal.SIGKILL)
        t_kill = time.time()
        driver.wait(timeout=30)
        deadline = time.monotonic() + WF_KILL_S
        while session_pids(driver.pid) and time.monotonic() < deadline:
            time.sleep(0.05)
        left = session_pids(driver.pid)
        gone_s = time.time() - t_kill
    finally:
        for pid in session_pids(driver.pid):
            os.kill(pid, signal.SIGKILL)
    while True:
        apps, free = compute_apps(), torch.cuda.mem_get_info()[0]
        if (len(apps) <= len(apps0) and free >= free0 - WF_FREE_SLACK) or time.time() - t_kill > WF_KILL_S:
            break
        time.sleep(0.1)
    status = workflow.get_status(WF_ID, storage)
    events = workflow.get_events(WF_ID, storage)
    print(f"(a) driver 1 (pid {driver.pid}, its own cluster) ran workflow {WF_ID!r}; generate committed "
          f"{done[0]['time'] - t0:.2f} s after its start; SIGKILL with {len(before_kill)} processes in its session "
          f"({len(before_kill) - 1} of its head: template and workers); all gone {gone_s:.2f} s later "
          f"({len(left)} left); status {status}; events so far "
          f"{[(e['type'], e['step_id'].split('_', 1)[1].rsplit('_', 1)[0]) for e in events]}; card [{card}]: "
          f"compute apps {len(apps0)} -> {len(apps)}, free {free0 / 1e9:.3f} -> {free / 1e9:.3f} GB")
    if left:
        raise AssertionError(f"(a) processes of the killed driver outlived it by {WF_KILL_S} s: {left}")
    if len(apps) > len(apps0) or free < free0 - WF_FREE_SLACK:
        raise AssertionError(f"(a) the killed driver's processes still hold the card: compute apps {apps} "
                             f"(before {apps0}), free {free / 1e9:.3f} GB (before {free0 / 1e9:.3f} GB)")
    if status != workflow.STATUS_RUNNING:
        raise AssertionError(f"(a) status {status!r} after the kill, expected RUNNING")
    return here, t0, t_kill, done[0]["time"] - t0


def wf_resume(card: str, storage: str, env: dict, log: str, t_kill: float) -> dict:
    """(b): the "go" event, then driver 2, a fresh process with a fresh
    cluster, resumes: no ``generate`` starts again, K1 launches 0 times and
    K3 once a layer a forward, ``SUCCESSFUL``, the output stored, a second
    resume starts no step, one run in ``RunLedger``."""
    workflow.send_event(WF_ID, "go", "go", storage=storage)
    t0 = time.time()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--workflow-driver", "resume", storage],
                          capture_output=True, text=True, env=env, timeout=600)
    Path(log).write_text(proc.stdout + proc.stderr)
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")), None)
    if proc.returncode != 0 or line is None:
        raise AssertionError(f"(b) driver 2 exited {proc.returncode}:\n{(proc.stdout + proc.stderr)[-3000:]}")
    res = json.loads(line[len("RESULT "):])
    out, sc = res["out"], res["out"]["score"]
    after = [e for e in workflow.get_events(WF_ID, storage) if e["time"] > t_kill]
    restarted = [e for e in after if e["type"] == "step_started" and "_wf_generate_" in e["step_id"]]
    with open(os.path.join(storage, "virtual_actors", "runs", "state.pkl"), "rb") as f:
        runs = pickle.load(f)["runs"]
    c = sc["clocks"]
    split = dict(total=res["done"] - t_kill, driver=res["up"] - t0, worker=c[0] - res["up"], cuda=c[1] - c[0],
                 build=c[2] - c[1], step=c[3] - c[2])
    print(f"(b) 'go' sent; driver 2 (a fresh process, its own cluster) resumed: kill -> resume returned "
          f"{split['total']:.2f} s = driver 1 dead and the event sent {t0 - t_kill:.2f} s + driver start and init "
          f"{split['driver']:.2f} s + graph load, event and the score worker's start with torch {split['worker']:.2f} s"
          f" + CUDA context {split['cuda']:.2f} s + GPT-124M built {split['build']:.2f} s + {sc['forwards']} "
          f"forwards {split['step']:.2f} s + the continuation {res['done'] - c[3]:.2f} s; events after the kill "
          f"{[(e['type'], e['step_id'].split('_', 1)[1].rsplit('_', 1)[0]) for e in after]}; status "
          f"{res['status']}; get_output equal {res['output']}; a second resume equal {res['again']}, "
          f"{res['again_events']} events; RunLedger {runs}; score [{card}]: K1 {sc['k1']}, K3 {sc['k3']} = "
          f"{GPT_124M.n_layers} x {sc['forwards']} forwards")
    if restarted:
        raise AssertionError(f"(b) generate started again after the kill: {restarted}")
    if sc["k1"] != 0 or sc["k3"] != GPT_124M.n_layers * sc["forwards"] or sc["forwards"] != WF_REQUESTS:
        raise AssertionError(f"(b) driver 2 launched K1 {sc['k1']} times and K3 {sc['k3']} over {sc['forwards']} "
                             f"forwards (expected 0 and {GPT_124M.n_layers} a forward)")
    if sc["go"] != "go":
        raise AssertionError(f"(b) the score step got the event payload {sc['go']!r}, not 'go'")
    if res["status"] != workflow.STATUS_SUCCESSFUL or not res["output"]:
        raise AssertionError(f"(b) status {res['status']}, get_output equal to resume's: {res['output']}")
    if workflow.get_output(WF_ID, storage) != out:
        raise AssertionError("(b) the stored output differs from what resume returned")
    if not res["again"] or res["again_events"] != 0:
        raise AssertionError(f"(b) a second resume: equal {res['again']}, {res['again_events']} new events")
    if runs != [[WF_ID, WF_REQUESTS * WF_NEW]] or res["finished"] != runs:
        raise AssertionError(f"(b) RunLedger holds {runs} (its readonly read {res['finished']})")
    return dict(out, split=split)


def workflow_on_card(card: str) -> dict:
    """Phase 33: a durable GPT-124M workflow killed after ``generate``'s
    commit (``wf_kill``) and resumed by a fresh driver (``wf_resume``),
    held against the same path in this process (``wf_reference``)."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase33_")
    storage = os.path.join(tmp, "wf")
    root = os.path.dirname(os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p))

    def reference():
        t0 = time.perf_counter()
        return (*wf_reference(wf_prompt_list()), time.perf_counter() - t0)

    try:
        here, t_run, t_kill, commit_s = wf_kill(card, storage, env, os.path.join(tmp, "driver1.log"), reference)
        out = wf_resume(card, storage, env, os.path.join(tmp, "driver2.log"), t_kill)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want_tokens, want_scores, ref_s = here
    gen, scores = out["generate"], out["score"]["scores"]
    gaps = [abs(g - w) / max(1.0, abs(w)) for g, w in zip(scores, want_scores)]
    equal = sum(g == w for g, w in zip(gen["tokens"], want_tokens))
    print(f"(c) against this process [{card}] (the same weights, prompts and kernels; built and run here in "
          f"{ref_s:.2f} s while driver 1 came up): {equal}/{WF_REQUESTS} requests' {WF_NEW} tokens equal bit for bit; "
          f"scores {[round(x, 3) for x in scores]}, largest gap {max(gaps):.3e} relative to max(1, |ref|) "
          f"(limit {TOL[torch.bfloat16]}); generate (driver 1, pid {gen['pid']}, {gen['device']}): K1 {gen['k1']} "
          f"= {GPT_124M.n_layers} x {gen['decode']} decode steps; driver 1's start to generate's commit {commit_s:.2f} "
          f"s = driver start, init, prompts and the generate worker's start with torch "
          f"{gen['clocks'][0] - t_run:.2f} s + CUDA context {gen['clocks'][1] - gen['clocks'][0]:.2f} s + GPT-124M "
          f"built and warmed up {gen['clocks'][2] - gen['clocks'][1]:.2f} s + generated "
          f"{gen['clocks'][3] - gen['clocks'][2]:.2f} s + the commit")
    if equal != WF_REQUESTS or any(len(t) != WF_NEW for t in gen["tokens"]):
        raise AssertionError(f"(c) the workflow's tokens differ from this process's in "
                             f"{WF_REQUESTS - equal} of {WF_REQUESTS} requests")
    if not all(np.isfinite(scores)) or max(gaps) > TOL[torch.bfloat16]:
        raise AssertionError(f"(c) scores {scores} against this process's {want_scores}")
    if gen["k1"] <= 0 or gen["k1"] != GPT_124M.n_layers * gen["decode"]:
        raise AssertionError(f"(c) generate launched K1 {gen['k1']} times over {gen['decode']} decode steps")
    return dict(k1=gen["k1"], k3=out["score"]["k3"], commit_s=commit_s, split=out["split"],
                seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# phase 34: GPT-406M on a device mesh
# ---------------------------------------------------------------------------

MESH34_STEPS = 4  # (a): steps 0-3 of phase 17's run, on the mesh
MOE34_STEPS = 3  # (f): phase 27 (b)'s MoE GPT-124M on the mesh and plain, in turns
RING34_TIMED = 2  # (g): ring and flash mesh steps timed in turns, after a warm-up step of each
CKPT34_CFG = dataclasses.replace(TRAIN_406M, n_layers=4)  # (d): the 406M width at 4 layers
CKPT34_STEPS = 2  # (d): the first fit's steps before its checkpoint; the second fit takes one more


class PlainAttentionCount:
    """Counts calls of the plain attention paths (the einsum and the flash
    path's plain forward and backward) while it is entered: on the card a
    mesh step must call none of them."""

    def __enter__(self):
        self.calls = 0
        self.saved = [(attention_mod, "_xla_attention"), (flash_mod, "flash_fwd_reference"),
                      (flash_mod, "flash_bwd_reference")]
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in self.saved]
        for mod, name, fn in self.saved:
            setattr(mod, name, self._counting(fn))
        return self

    def _counting(self, fn):
        def call(*args, **kwargs):
            self.calls += 1
            return fn(*args, **kwargs)

        return call

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def mesh_state_check(state, mesh, label: str) -> None:
    """Every parameter and every Adam moment a ``DTensor`` on the mesh's
    parameter axes, the moments placed as their parameter."""
    from torch.distributed.tensor import DTensor

    pmesh = param_mesh(mesh)
    bad = [n for n, p in state.params.named_parameters()
           if not (isinstance(p, DTensor) and p.device_mesh == pmesh)]
    for p, s in state.opt_state.state.items():
        for key in ("exp_avg", "exp_avg_sq"):
            m = s[key]
            if not (isinstance(m, DTensor) and m.device_mesh == pmesh and m.placements == p.placements):
                bad.append(key)
    if bad:
        raise AssertionError(f"{label}: not DTensors on the mesh with their parameter's placements: {bad[:5]}")


def step_timed(step_fn, state, tokens):
    """One step, its host time ending in the loss's sync, and its peak
    memory above nothing (the state included)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, loss = step_fn(state, tokens)
    loss = loss.item()
    return state, loss, (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated()


def mesh_train_406m(card: str, phase17: dict, mesh) -> dict:
    """(a) and (b): phase 17's model (seed 0) and batch, one state trained
    by the one-device step and one by ``build_train_step(..., mesh)`` on an
    NCCL mesh of one card, a step of each in turns (step 0 warms both up).
    The mesh's losses equal phase 17's bit for bit (one rank: the same
    kernels in the same order; the gathers, reductions and scaling of a
    one-rank mesh change no value), the plain state's too; K3/K4/K5 launch
    24 times each a mesh step and the plain attention never."""
    cfg = TRAIN_406M
    tokens = torch.from_numpy(train_406m_tokens()).cuda()
    init_p, step_p = build_train_step(lambda p, t: gpt_loss(cfg, p, t), adamw(1e-4))
    init_m, step_m = build_train_step(lambda p, t: gpt_loss(cfg, p, t, mesh), adamw(1e-4), mesh)
    plain = init_p(gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0)))
    t0 = time.perf_counter()
    sharded = init_m(gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0)))
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    mesh_state_check(sharded, mesh, "(a)")
    runs = {"plain": dict(losses=[], ms=[], peak=[]), "mesh": dict(losses=[], ms=[], peak=[])}
    launches, plain_calls = [0, 0, 0], 0
    for i in range(MESH34_STEPS):
        plain, loss, ms, peak = step_timed(step_p, plain, tokens)
        runs["plain"]["losses"].append(loss)
        runs["plain"]["ms"].append(ms)
        runs["plain"]["peak"].append(peak)
        before = flash_launches()
        with PlainAttentionCount() as counted:
            sharded, loss, ms, peak = step_timed(step_m, sharded, tokens)
        launches = [a + b - c for a, b, c in zip(launches, flash_launches(), before)]
        plain_calls += counted.calls
        runs["mesh"]["losses"].append(loss)
        runs["mesh"]["ms"].append(ms)
        runs["mesh"]["peak"].append(peak)
    want17 = phase17["losses"][:MESH34_STEPS]
    L, d, V, s = cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.seq_len
    flops_per_token = 6 * (12 * L * d * d + d * V) + 6 * L * s * d
    for name, r in runs.items():
        ms = float(np.mean(r["ms"][1:]))
        tok_s = TRAIN_B * s / (ms / 1e3)
        print(f"(a) {name} step [{card}]: {ms:.3f} ms (steps {[f'{x:.1f}' for x in r['ms']]}, step 0 the warm-up), "
              f"{tok_s:.0f} tokens/s, MFU {flops_per_token * tok_s / PEAK_OPS_PER_S[torch.bfloat16]:.4f}; peak "
              f"memory {max(r['peak']) / 1e9:.2f} GB (the state included); losses "
              f"{[f'{x:.6f}' for x in r['losses']]}")
    mesh_ms, plain_ms = np.mean(runs["mesh"]["ms"][1:]), np.mean(runs["plain"]["ms"][1:])
    print(f"(a) mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} over {dist.get_backend()} (world "
          f"{dist.get_world_size()}); parameters and Adam moments DTensors on {param_mesh(mesh)}, sharded in "
          f"{shard_s:.3f} s; mesh / plain step {mesh_ms / plain_ms:.4f}; losses equal to phase 17's bit for bit: "
          f"mesh {runs['mesh']['losses'] == want17}, plain {runs['plain']['losses'] == want17}")
    want = expected_flash_launches(cfg, MESH34_STEPS)
    print(f"(b) K3/K4/K5 launches over the {MESH34_STEPS} mesh steps {tuple(launches)} = {want} expected "
          f"(phase 17's per step); plain attention calls {plain_calls}")
    if dist.get_backend() != "nccl":
        raise AssertionError(f"(a) the mesh's group runs {dist.get_backend()}, not nccl")
    if runs["mesh"]["losses"] != want17 or runs["plain"]["losses"] != want17:
        raise AssertionError(f"(a) losses mesh {runs['mesh']['losses']}, plain {runs['plain']['losses']} differ "
                             f"from phase 17's {want17} (one rank does the same arithmetic: bit equality)")
    if tuple(launches) != want or plain_calls != 0:
        raise AssertionError(f"(b) K3/K4/K5 launched {launches} times (expected {want}), the plain attention "
                             f"{plain_calls} times (expected 0)")
    return dict(launches=dict(zip(("K3", "K4", "K5"), launches)), mesh_ms=float(mesh_ms),
                plain_ms=float(plain_ms))


def mesh_allreduce_exact(card: str, mesh) -> None:
    """(c): ``mesh_allreduce`` of integer-valued fp32 on the card over the
    one-card mesh, for each ``ReduceOp``, equal to torch's own reduction
    over axis 0 exactly."""
    from ray_tpu_torch.collective import ReduceOp, mesh_allreduce

    gen = torch.Generator(device="cuda").manual_seed(34)
    x = torch.randint(1, 3, (16, 4096), generator=gen, device="cuda").float()
    x = x * torch.where(torch.rand(x.shape, generator=gen, device="cuda") < 0.5, -1.0, 1.0)
    want = {ReduceOp.SUM: x.sum(0), ReduceOp.PRODUCT: x.prod(0), ReduceOp.MIN: x.amin(0),
            ReduceOp.MAX: x.amax(0)}
    got = {op: mesh_allreduce(x, mesh, op=op) for op in ReduceOp}
    default = mesh_allreduce(x)
    equal = {op.name: bool(torch.equal(got[op], want[op]) and got[op].is_cuda) for op in ReduceOp}
    print(f"(c) mesh_allreduce of a (16, 4096) fp32 tensor of +-1 and +-2 on the card [{card}]: equal to "
          f"x.sum/prod/min/max(0) exactly {equal}; the default mesh's sum {bool(torch.equal(default, want[ReduceOp.SUM]))}")
    if not all(equal.values()) or not torch.equal(default, want[ReduceOp.SUM]):
        raise AssertionError(f"(c) mesh_allreduce differs from torch's reductions: {equal}")


def mesh_checkpoint_loop(config: dict) -> None:
    """(d)'s train loop, run by a ``TorchTrainer`` worker on the card:
    ``CKPT34_CFG`` (seed 0) on a mesh of ``make_mesh()`` (the worker's NCCL
    group of one), phase 17's batch. Without ``config["restore"]`` it takes
    ``CKPT34_STEPS`` steps and reports ``save_pytree_checkpoint`` of the
    sharded train state; with it, it restores that checkpoint into a fresh
    sharded state (``load_pytree_checkpoint(target=...)``) and takes one
    step."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch import train
    from ray_tpu_torch.parallel import train_state_dict
    from ray_tpu_torch.train.integrations import load_pytree_checkpoint, save_pytree_checkpoint

    cfg = CKPT34_CFG
    mesh = make_mesh(MeshConfig())
    init_fn, step_fn = build_train_step(lambda p, t: gpt_loss(cfg, p, t, mesh), adamw(1e-4), mesh)
    state = init_fn(gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0)))
    tokens = torch.from_numpy(train_406m_tokens()).cuda()
    out = dict(backend=dist.get_backend(), world=dist.get_world_size(),
               dtensors=all(isinstance(p, DTensor) for p in state.params.parameters()))
    reset_flash_launches()
    saved = None
    if config.get("restore"):
        t0 = time.perf_counter()
        restored = load_pytree_checkpoint(config["restore"], target=train_state_dict(state))
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        state = state._replace(step=restored["step"])
        state, loss = step_fn(state, tokens)
        out.update(losses=[loss.item()], step=state.step)
    else:
        losses = []
        for _ in range(CKPT34_STEPS):
            state, loss = step_fn(state, tokens)
            losses.append(loss.item())
        t0 = time.perf_counter()
        saved = save_pytree_checkpoint(train_state_dict(state), config["path"])
        out["save_s"] = time.perf_counter() - t0
        out["bytes"] = sum(f.stat().st_size for f in Path(config["path"]).rglob("*") if f.is_file())
        out.update(losses=losses, step=state.step)
    out["launches"] = list(flash_launches())
    train.report(out, checkpoint=saved)


def mesh_checkpoint_here(mesh) -> tuple:
    """(d)'s reference in this process: the worker's model on this
    process's mesh, ``CKPT34_STEPS + 1`` steps; (losses, K3/K4/K5
    launches)."""
    cfg = CKPT34_CFG
    init_fn, step_fn = build_train_step(lambda p, t: gpt_loss(cfg, p, t, mesh), adamw(1e-4), mesh)
    state = init_fn(gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0)))
    tokens = torch.from_numpy(train_406m_tokens()).cuda()
    before, losses = flash_launches(), []
    for _ in range(CKPT34_STEPS + 1):
        state, loss = step_fn(state, tokens)
        losses.append(loss.item())
    return losses, tuple(a - b for a, b in zip(flash_launches(), before))


def mesh_checkpoint_through_trainer(card: str, mesh) -> dict:
    """(d): one ``TorchTrainer`` GPU worker under ``TorchConfig(
    init_distributed=True)`` trains ``CKPT34_CFG`` on its own mesh and
    reports a DCP checkpoint of the sharded state; a second ``fit``
    restores it into a fresh sharded state and takes one step, whose loss
    equals this process's third step bit for bit (the same kernels,
    weights and card)."""
    from ray_tpu_torch import train

    here, here_launches = mesh_checkpoint_here(mesh)
    gc.collect()
    torch.cuda.empty_cache()
    ray_tpu_torch.init()
    storage = tempfile.mkdtemp(prefix="phase34_")
    try:
        def fit(name, **config):
            t0 = time.perf_counter()
            result = train.TorchTrainer(
                mesh_checkpoint_loop, train_loop_config=config,
                scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
                backend_config=train.TorchConfig(init_distributed=True),
                run_config=train.RunConfig(name=name, storage_path=storage),
            ).fit()
            if result.error is not None:
                raise AssertionError(f"(d) {name}: {result.error}")
            return result, time.perf_counter() - t0

        first, first_s = fit("save", path=os.path.join(storage, "stage"))
        second, second_s = fit("restore", restore=first.checkpoint.path)
    finally:
        shutil.rmtree(storage, ignore_errors=True)
        ray_tpu_torch.shutdown()
    a, b = first.metrics, second.metrics
    got = a["losses"] + b["losses"]
    per_step = expected_flash_launches(CKPT34_CFG, 1)
    print(f"(d) TorchTrainer(ScalingConfig(num_workers=1, use_gpu=True), TorchConfig(init_distributed=True)) "
          f"[{card}]: the worker's mesh over {a['backend']} (world {a['world']}), DTensor parameters "
          f"{a['dtensors']}; fit 1 ({first_s:.1f} s): {CKPT34_STEPS} steps of the 406M width at "
          f"{CKPT34_CFG.n_layers} layers, a DCP checkpoint of {a['bytes'] / 1e9:.3f} GB saved in {a['save_s']:.2f} "
          f"s; fit 2 ({second_s:.1f} s): restored in {b['load_s']:.2f} s into a fresh sharded state, one step; "
          f"losses {[f'{x:.6f}' for x in got]} against this process's {[f'{x:.6f}' for x in here]}: "
          f"{'equal bit for bit' if got == here else 'DIFFERENT'}; K3/K4/K5 launches {a['launches']}, "
          f"{b['launches']} in the workers, {here_launches} here")
    if a["backend"] != "nccl" or b["backend"] != "nccl" or a["world"] != 1 or not (a["dtensors"] and b["dtensors"]):
        raise AssertionError(f"(d) the workers' meshes: {a}, {b}")
    if got != here or b["step"] != CKPT34_STEPS + 1:
        raise AssertionError(f"(d) the restored run's losses {got} (step {b['step']}) differ from this process's {here}")
    launches = tuple(x + y for x, y in zip(a["launches"], b["launches"]))
    want = tuple(n * (CKPT34_STEPS + 1) for n in per_step)
    if launches != want or here_launches != want:
        raise AssertionError(f"(d) K3/K4/K5 launched {launches} times in the workers, {here_launches} here, "
                             f"expected {want}")
    return dict(trainer=launches, here=here_launches, bytes=a["bytes"], save_s=a["save_s"], load_s=b["load_s"])


def fit_proof_on_card(card: str) -> dict:
    """(e): ``fit_report(TRAIN_406M, n_devices=8, batch=8)`` on the card:
    rank 0 of an fsdp-8 step under a fake process group. ``argument_bytes``
    equals the count from the rule table's local shards (parameters and two
    Adam moments, a dim over fsdp holding 1/8 of its rows), and
    ``per_chip_bytes`` is measured, above it and below the card's memory."""
    from ray_tpu_torch.parallel.fit_proof import fit_report
    from ray_tpu_torch.parallel.sharding import spec_for_path

    want = 0
    for name, p in GPT(TRAIN_406M, device="meta").named_parameters():
        fsdp = any(e == "fsdp" or (isinstance(e, tuple) and "fsdp" in e) for e in spec_for_path(name))
        want += p.numel() // (8 if fsdp else 1) * p.element_size() * 3
    gc.collect()
    torch.cuda.empty_cache()
    before = flash_launches()
    t0 = time.perf_counter()
    rep = fit_report(TRAIN_406M, n_devices=8, batch=8)
    took = time.perf_counter() - t0
    launches = tuple(a - b for a, b in zip(flash_launches(), before))
    print(f"(e) fit_report(TRAIN_406M, n_devices=8, batch=8) on the card [{card}] ({took:.1f} s): "
          f"{json.dumps(rep)}; argument bytes from the rule table's local shards {want}; K3/K4/K5 launches "
          f"{launches}")
    if rep["argument_bytes"] != want:
        raise AssertionError(f"(e) argument_bytes {rep['argument_bytes']} != the local shards' {want}")
    if not (rep.get("per_chip_bytes") and rep["argument_bytes"] < rep["per_chip_bytes"] < rep["card_memory_bytes"]):
        raise AssertionError(f"(e) per_chip_bytes {rep.get('per_chip_bytes')} not measured between "
                             f"argument_bytes and the card's memory")
    if dist.is_initialized():
        raise AssertionError("(e) fit_report left its fake process group behind")
    return dict(report=rep, launches=launches)


def mesh_moe(card: str, mesh) -> dict:
    """(f): ``MOE27`` (GPT-124M, 8 experts top-2, capacity 1.25, remat
    "full", bf16; phase 27 (b)'s) from seed 0 and phase 27 (b)'s batch (8 x
    1024), one state trained by the one-device step and one by
    ``build_train_step(..., mesh)``, ``MOE34_STEPS`` steps each in turns.
    On one rank the routing's all-gathers and sums over the token axes, the
    experts' gather over ep and the gradient reductions move nothing, so
    the losses equal the plain step's bit for bit; K3/K4/K5 launch as
    ``expected_flash_launches`` says a mesh step."""
    cfg = MOE27
    gc.collect()
    torch.cuda.empty_cache()
    tokens = gpt27_tokens(28)
    init_p, step_p = build_train_step(lambda p, t: gpt_loss(cfg, p, t), adamw(1e-4))
    init_m, step_m = build_train_step(lambda p, t: gpt_loss(cfg, p, t, mesh), adamw(1e-4), mesh)
    plain = init_p(gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0)))
    sharded = init_m(gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0)))
    mesh_state_check(sharded, mesh, "(f)")
    runs = {"plain": dict(losses=[], ms=[], peak=[]), "mesh": dict(losses=[], ms=[], peak=[])}
    launches = [0, 0, 0]
    for _ in range(MOE34_STEPS):
        plain, loss, ms, peak = step_timed(step_p, plain, tokens)
        for key, value in (("losses", loss), ("ms", ms), ("peak", peak)):
            runs["plain"][key].append(value)
        before = flash_launches()
        sharded, loss, ms, peak = step_timed(step_m, sharded, tokens)
        launches = [a + b - c for a, b, c in zip(launches, flash_launches(), before)]
        for key, value in (("losses", loss), ("ms", ms), ("peak", peak)):
            runs["mesh"][key].append(value)
    want = expected_flash_launches(cfg, MOE34_STEPS)
    mesh_ms, plain_ms = np.mean(runs["mesh"]["ms"][1:]), np.mean(runs["plain"]["ms"][1:])
    for name, r in runs.items():
        ms = float(np.mean(r["ms"][1:]))
        print(f"(f) MoE GPT-124M {name} step [{card}]: {ms:.3f} ms (steps {[f'{x:.1f}' for x in r['ms']]}, step 0 "
              f"the warm-up), {GPT27_B * cfg.seq_len / (ms / 1e3):.0f} tokens/s; peak memory "
              f"{max(r['peak']) / 1e9:.2f} GB (both states included); losses {[repr(x) for x in r['losses']]}")
    equal = runs["mesh"]["losses"] == runs["plain"]["losses"]
    print(f"(f) MOE27 ({cfg.n_experts} experts top-{cfg.experts_per_token}, capacity {cfg.capacity_factor}, batch "
          f"{GPT27_B} x {cfg.seq_len}) on the mesh over {dist.get_backend()}: mesh / plain step "
          f"{mesh_ms / plain_ms:.4f}; losses equal to the plain step's bit for bit: {equal}; K3/K4/K5 launches over "
          f"the {MOE34_STEPS} mesh steps {tuple(launches)} = {want} expected")
    if not equal:
        raise AssertionError(f"(f) MoE losses mesh {runs['mesh']['losses']} differ from the plain step's "
                             f"{runs['plain']['losses']} (one rank does the same arithmetic: bit equality)")
    if tuple(launches) != want:
        raise AssertionError(f"(f) K3/K4/K5 launched {launches} times over the MoE mesh steps, expected {want}")
    return dict(launches=tuple(launches), mesh_ms=float(mesh_ms), plain_ms=float(plain_ms))


def mesh_ring(card: str, phase17: dict, mesh) -> dict:
    """(g): phase 17's configuration with ``attn_impl="ring"`` on the mesh
    (one rank: one hop of fp32 partials, no rotation), seed 0 and phase
    17's batch. Step 0's qkv weight gradients lie within ``QKV_GRAD_GAP``
    of phase 17's einsum-path gradients (the loss cannot see attention);
    then a warm-up step and ``RING34_TIMED`` steps each of the ring and the
    flash mesh step, in turns. K3-K5 launch 0 times on the ring's path."""
    cfg = dataclasses.replace(TRAIN_406M, attn_impl="ring")
    gc.collect()
    torch.cuda.empty_cache()
    tokens = torch.from_numpy(train_406m_tokens()).cuda()
    params = gpt_init(cfg, torch.Generator(device="cuda").manual_seed(0))
    before = flash_launches()
    loss0, grads = qkv_grads(cfg, params, tokens, mesh)
    grads_launches = tuple(b - a for a, b in zip(before, flash_launches()))
    gaps = qkv_grad_gaps(grads, [w.cuda() for w in phase17["xla_qkv_grads"]], cfg.d_model)
    del grads
    init_r, step_r = build_train_step(lambda p, t: gpt_loss(cfg, p, t, mesh), adamw(1e-4), mesh)
    init_f, step_f = build_train_step(lambda p, t: gpt_loss(TRAIN_406M, p, t, mesh), adamw(1e-4), mesh)
    ring = init_r(params)
    flash = init_f(gpt_init(TRAIN_406M, torch.Generator(device="cuda").manual_seed(0)))
    runs = {"ring": dict(losses=[], ms=[], peak=[]), "flash": dict(losses=[], ms=[], peak=[])}
    ring_launches = [0, 0, 0]
    for _ in range(1 + RING34_TIMED):
        mark = flash_launches()
        ring, loss, ms, peak = step_timed(step_r, ring, tokens)
        ring_launches = [a + b - c for a, b, c in zip(ring_launches, flash_launches(), mark)]
        for key, value in (("losses", loss), ("ms", ms), ("peak", peak)):
            runs["ring"][key].append(value)
        flash, loss, ms, peak = step_timed(step_f, flash, tokens)
        for key, value in (("losses", loss), ("ms", ms), ("peak", peak)):
            runs["flash"][key].append(value)
    ring_ms, flash_ms = np.mean(runs["ring"]["ms"][1:]), np.mean(runs["flash"]["ms"][1:])
    for name, r in runs.items():
        print(f"(g) 406M {name} mesh step [{card}]: {np.mean(r['ms'][1:]):.3f} ms (steps "
              f"{[f'{x:.1f}' for x in r['ms']]}, step 0 the warm-up); peak memory {max(r['peak']) / 1e9:.2f} GB (both "
              f"states included); losses {[f'{x:.6f}' for x in r['losses']]}")
    print(f"(g) ring attention (attn_impl=\"ring\", {axis_sizes(mesh)}: one hop) at the 406M shape, batch {TRAIN_B}: "
          f"step 0 loss {loss0:.6f} (phase 17's einsum path {phase17['xla_loss']:.6f}); qkv weight gradients against "
          f"phase 17's einsum path, largest relative gap over layers: "
          + ", ".join(f"{n} {g:.3g}" for n, g in gaps.items()) + f" (limit {QKV_GRAD_GAP}); ring / flash mesh step "
          f"{ring_ms / flash_ms:.4f} (+{ring_ms - flash_ms:.1f} ms); K3/K4/K5 launches on the ring's path "
          f"{tuple(ring_launches)} in its steps, {tuple(grads_launches)} in its step-0 gradients (expected 0)")
    if not all(g <= QKV_GRAD_GAP for g in gaps.values()):
        raise AssertionError(f"(g) ring attention's qkv gradients differ from the einsum path's: {gaps}")
    if any(ring_launches) or any(grads_launches):
        raise AssertionError(f"(g) K3-K5 launched on the ring's path: {ring_launches}, {grads_launches}")
    if not all(np.isfinite(runs["ring"]["losses"])):
        raise AssertionError(f"(g) non-finite ring losses {runs['ring']['losses']}")
    return dict(ring_ms=float(ring_ms), flash_ms=float(flash_ms), gaps=gaps)


def axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_on_card(card: str, phase17: dict) -> dict:
    """Phase 34: GPT-406M on a device mesh: (e) the fit proof first (its
    fake process group must be this process's only one), then an NCCL mesh
    of one card for (a)-(d), the MoE GPT-124M (f) and ring attention
    (g)."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    proof = fit_proof_on_card(card)
    mesh = make_mesh(MeshConfig())
    try:
        trained = mesh_train_406m(card, phase17, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        mesh_allreduce_exact(card, mesh)
        ckpt = mesh_checkpoint_through_trainer(card, mesh)
        t0 = time.perf_counter()
        moe = mesh_moe(card, mesh)
        t1 = time.perf_counter()
        ring = mesh_ring(card, phase17, mesh)
        print(f"phase 34 [{card}]: (f) {t1 - t0:.1f} s, (g) {time.perf_counter() - t1:.1f} s")
    finally:
        dist.destroy_process_group()
    return dict(trained=trained, ckpt=ckpt, proof=proof, moe=moe, ring=ring, seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# phase 35: the tensor-parallel engine's runner at tp 1
# ---------------------------------------------------------------------------

TP1_ENGINE = dict(max_slots=S, block_size=BS, max_blocks_per_seq=64, num_blocks=S * 64 + 1, prefill_chunk=256)


class TP1Engine(LLMEngine):
    """``LLMEngine`` over ``llm.multichip``'s runner and pool at tp 1: the
    tp path on a private group of one rank (``EngineConfig(tp=1)`` itself
    takes the single-card pair)."""

    def _substrate(self, model_cfg, params, cache_cfg):
        return self._tp_substrate(model_cfg, params, cache_cfg, 1)


def tp1_requests() -> list:
    """8 (prompt, sampling): prompts of 192-480 ids from numpy seed 35, 32
    new tokens, the first 4 greedy, the rest at temperature 0.8, seed 42."""
    rng = np.random.default_rng(35)
    return [(rng.integers(0, GPTJ_6B.vocab_size, int(n)).tolist(),
             SamplingParams(max_tokens=32) if i < 4 else SamplingParams(max_tokens=32, temperature=0.8, seed=42))
            for i, n in enumerate(rng.integers(192, 481, S))]


def tp1_serve(eng: LLMEngine, requests) -> dict:
    """Serve ``requests`` to the end by ``step()``: tokens, logprobs, step
    times (host clock ending in the step's sync) and the kernels' launches
    since the start."""
    eng.warmup()
    reset_counts(eng)
    before = eng.stats()
    reqs = [eng.submit(list(p), sp) for p, sp in requests]
    while not all(r.finished for r in reqs):
        eng.step()
    st = eng.stats()
    k1, k2 = check_counts("phase 35", eng)
    d = st["decode_steps"] - before["decode_steps"]
    v = st.get("verify_steps", 0) - before.get("verify_steps", 0)
    if not eng.pool.audit()["ok"]:
        raise AssertionError("phase 35: the pool's audit failed")
    return dict(tokens=[list(r.out) for r in reqs], logprobs=[list(r.out_logprobs) for r in reqs], k1=k1, k2=k2,
                decode_ms=(st["decode_s"] - before["decode_s"]) / max(d, 1) * 1e3, decode_steps=d,
                verify_ms=(st.get("verify_s", 0.0) - before.get("verify_s", 0.0)) / max(v, 1) * 1e3,
                verify_steps=v, ledger=eng.hbm_ledger())


def tp1_runner(card: str, params) -> dict:
    """Phase 35: the plain engine and the tp runner at tp 1 over phase 6's
    weights, plain and speculating, in turns (plain, tp, tp, plain)."""
    t_phase = time.perf_counter()
    requests = tp1_requests()
    out = {}
    for spec in (0, 4):
        runs = {"plain": [], "tp1": []}
        for who in ("plain", "tp1", "tp1", "plain"):
            cls = TP1Engine if who == "tp1" else LLMEngine
            eng = cls(GPTJ_6B, params, EngineConfig(spec_k=spec, **TP1_ENGINE))
            if who == "tp1":
                pg = eng.runner.group.coll.pg
                if type(pg).__name__ != "ProcessGroupNCCL" or eng.runner.group.procs:
                    raise AssertionError(f"phase 35: the tp runner's group is {type(pg).__name__} with "
                                         f"{len(eng.runner.group.procs)} followers")
                if eng.runner.params.blocks[0].q.weight.data_ptr() != params.blocks[0].q.weight.data_ptr():
                    raise AssertionError("phase 35: the tp runner copied the weights at tp 1")
            runs[who].append(tp1_serve(eng, requests))
            eng.shutdown()
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        plain, tp1 = runs["plain"][0], runs["tp1"][0]
        for run in runs["plain"][1:] + runs["tp1"]:
            if run["tokens"] != plain["tokens"] or run["logprobs"] != plain["logprobs"]:
                raise AssertionError(f"phase 35 (spec_k={spec}): tokens or logprobs differ between runs")
        led = tp1["ledger"]
        per = led["per_device"]
        want = {k: plain["ledger"][k] for k in ("params_bytes", "pool_bytes", "seq_bytes", "cache_bytes",
                                                "free_bytes", "drafter_bytes")}
        if list(per.values()) != [want]:
            raise AssertionError(f"phase 35: per_device {per} against the plain ledger's {want}")
        label = "spec" if spec else "plain"
        steps = ("verify", tp1["verify_steps"], "K2", tp1["k2"]) if spec else ("decode", tp1["decode_steps"],
                                                                              "K1", tp1["k1"])
        print(f"(35 {label}) GPT-J-6B through the tp runner at tp 1 on a one-rank NCCL group [{card}]: "
              f"{len(requests)} requests, tokens and logprobs equal the plain engine's bit for bit; "
              f"per_device {per}; {steps[2]} {steps[3]} launches = 28 x {steps[1]} {steps[0]} steps "
              f"(K1 {tp1['k1']}, K2 {tp1['k2']}); decode step tp runner "
              f"{[round(r['decode_ms'], 3) for r in runs['tp1']]} ms against plain "
              f"{[round(r['decode_ms'], 3) for r in runs['plain']]} ms in turns"
              + (f"; verify step tp runner {[round(r['verify_ms'], 3) for r in runs['tp1']]} ms against plain "
                 f"{[round(r['verify_ms'], 3) for r in runs['plain']]} ms" if spec else ""))
        out[label] = dict(k1=sum(r["k1"] for r in runs["tp1"]), k2=sum(r["k2"] for r in runs["tp1"]))
    out["seconds"] = time.perf_counter() - t_phase
    return out


def share_bytecode() -> str:
    """Gives this process and every process it starts (workers, drivers,
    CLI processes: they inherit the environment) one bytecode cache in the
    checkout's git-ignored ``ray_tpu_torch/_build/pycache``. Where the
    interpreter is told to write no bytecode (``PYTHONDONTWRITEBYTECODE``)
    and the installed packages ship none, each fresh process compiles torch
    (and sympy, under ``torch._dynamo``) from source; ``chip_start_probe.py``
    times both ways."""
    path = os.path.join(os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)), "_build", "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = path
    sys.dont_write_bytecode = False
    sys.pycache_prefix = path
    return path


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    share_bytecode()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1 device")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, compute capability {torch.cuda.get_device_capability(0)}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {card}")

    phase("2 build")
    # one nvcc per kernel source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(_kernels.build, KERNELS))
    print(f"built {', '.join(KERNELS)} in {time.perf_counter() - t0:.1f} s")
    for src in KERNELS:
        print(_kernels.build_log(src).strip())

    phase("3 K1 vs plain")
    err = check_k1()

    phase("4 K1 timing")
    timing = time_k1()
    timing64 = time_k1(GPT_124M.head_dim)

    phase("5 fp32 identity")
    fp32_identity()
    torch.cuda.empty_cache()

    phase("6 GPT-J-6B serve")
    served = serve_6b(card)

    phase("7 decode profile")
    profile_decode(served.pop("engine"), card)
    torch.cuda.empty_cache()

    phase("8 K2 vs plain")
    err2 = check_k2()

    phase("9 K2 timing")
    timing2 = time_k2(timing["ms"])
    timing2_64 = time_k2(timing64["ms"], GPT_124M.head_dim)

    phase("10 fp32 spec identity")
    fp32_spec_identity()
    torch.cuda.empty_cache()

    phase("11 GPT-J-6B spec serve")
    gptj_params = served.pop("params")  # phase 35 serves them again
    spec = spec_serve_6b(gptj_params, card)

    phase("12 verify profile")
    profile_verify(spec.pop("engine"), card)
    torch.cuda.empty_cache()

    phase("13 flash-attention yardsticks (K3-K5)")
    yard = flash_yardsticks()
    torch.cuda.empty_cache()

    phase("14 K3-K5 vs plain")
    check_flash()
    torch.cuda.empty_cache()

    phase("15 K3-K5 timing")
    flash_timing = time_flash(yard)
    torch.cuda.empty_cache()

    phase("16 fp32 training identity")
    fp32_training_identity()
    torch.cuda.empty_cache()

    phase("17 406M training")
    trained = train_406m(card)
    torch.cuda.empty_cache()

    phase("18 GPT fp32 identity")
    gpt_fp32_identity()
    torch.cuda.empty_cache()

    phase("19 GPT-124M serve")
    gpt_served = serve_gpt(card)

    phase("20 GPT-124M decode and verify profile")
    profile_decode(gpt_served["engine"], card, "GPT-124M decode profile")
    profile_verify(gpt_served.pop("spec_engine"), card, "GPT-124M verify profile")
    torch.cuda.empty_cache()

    phase("21 GPT-124M hot swap")
    swap_engine = gpt_served.pop("engine")
    params_bytes = swap_engine.hbm_ledger()["params_bytes"]
    swapped = hot_swap_gpt(swap_engine, card)
    swap_bytes = (params_bytes, swap_engine.hbm_ledger()["params_bytes"])
    del swap_engine
    gc.collect()
    torch.cuda.empty_cache()

    phase("22 GPT-124M production engine")
    production = production_engine(card, swap_bytes)
    gc.collect()
    torch.cuda.empty_cache()

    phase("23 the runtime on the card")
    runtime = runtime_on_card(card, gpt_served["in_process"])
    gc.collect()
    torch.cuda.empty_cache()

    phase("24 Serve over the engine")
    served24 = serve_on_card(card, (served["tokens_per_s"], served["ttft_ms"]))

    phase("25 Train over the runtime")
    trained25 = train_over_runtime(card, trained)

    phase("26 Data into Train")
    trained26 = data_into_train(card, trained, trained25)

    phase("27 GPT remat policies and MoE")
    t_phase = time.perf_counter()
    remat = remat_policies(card)
    moe = moe_train(card)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 27 [{card}]: {time.perf_counter() - t_phase:.1f} s")

    phase("28 Tune over Train")
    t_phase = time.perf_counter()
    tuned = tune_over_train(card)
    print(f"phase 28 [{card}]: {time.perf_counter() - t_phase:.1f} s ((a) {tuned['seconds'][0]:.1f}, "
          f"(b) {tuned['seconds'][1]:.1f}, (c) {tuned['seconds'][2]:.1f} s of Tuner runs)")

    phase("29 RL and RLHF on the card")
    t_phase = time.perf_counter()
    rl = rl_on_card(card)
    print(f"phase 29 [{card}]: {time.perf_counter() - t_phase:.1f} s ((a) {rl['seconds'][0]:.1f}, "
          f"(b) {rl['seconds'][1]:.1f}, (c) {rl['seconds'][2]:.1f} s)")

    phase("30 the rest of RL on the card")
    t_phase = time.perf_counter()
    rl_rest = rl_rest_on_card(card)
    print(f"phase 30 [{card}]: {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"{k} {v['seconds']:.1f}" for k, v in rl_rest.items()) + " s)")

    phase("31 operator tooling over a GPT-124M job")
    ops = operator_tooling(card)
    print(f"phase 31 [{card}]: {ops['seconds']:.1f} s")

    phase("32 the CLI and the autoscaler on the card")
    cli = cli_and_autoscaler(card)
    print(f"phase 32 [{card}]: {cli['seconds']:.1f} s ((a) {cli['a']['seconds']:.1f} s: actor ready "
          f"{cli['a']['ready_s']:.2f} s, CLI {cli['a']['cli_s']:.2f} s; (b) {cli['b']['seconds']:.1f} s: scale-up "
          f"{cli['b']['scale_up_s']:.2f} s, actor ready {cli['b']['ready_s']:.2f} s, scale-down "
          f"{cli['b']['down_s']:.2f} s)")

    phase("33 a durable GPT-124M workflow")
    wf = workflow_on_card(card)
    sp = wf["split"]
    print(f"phase 33 [{card}]: {wf['seconds']:.1f} s (driver 1's start to generate's commit {wf['commit_s']:.2f} s; "
          f"kill -> resume returned {sp['total']:.2f} s: driver start {sp['driver']:.2f} s, the score worker's start "
          f"with torch {sp['worker']:.2f} s, CUDA context {sp['cuda']:.2f} s, build {sp['build']:.2f} s, step "
          f"{sp['step']:.2f} s)")

    phase("34 GPT-406M on a device mesh")
    meshed = mesh_on_card(card, trained)
    print(f"phase 34 [{card}]: {meshed['seconds']:.1f} s")

    phase("35 the tensor-parallel runner at tp 1")
    tp1 = tp1_runner(card, gptj_params)
    del gptj_params
    print(f"phase 35 [{card}]: {tp1['seconds']:.1f} s")

    kernels = [
        dict(
            name="paged_decode_attention",
            route="cuda",
            source="ray_tpu_torch/ops/csrc/paged_attention.cu",
            replaces="ray_tpu/ops/paged_attention.py:203",
            launches=(served["launches"] + gpt_served["k1"] + swapped["launches"] + production["k1"]
                      + runtime["k1"] + served24["k1_gptj"] + served24["k1_gpt"] + rl["k1"] + ops["k1"]
                      + cli["k1"] + wf["k1"] + tp1["plain"]["k1"] + tp1["spec"]["k1"]),
            max_abs_err=err,
            ms=timing["ms"],
            plain_ms=timing["plain_ms"],
            bound_ms=timing["bound_ms"],
            bound_by="bytes",
            library_ms=timing["library_ms"],
            head_dims=list(DECODE_HEAD_DIMS),
            launches_by_path={"gptj_6b_serve": served["launches"], "gpt_124m_serve": gpt_served["k1"],
                              "gpt_124m_hot_swap": swapped["launches"],
                              "gpt_124m_production": production["k1"], "gpt_124m_actor": runtime["k1"],
                              "gptj_6b_serve_replica": served24["k1_gptj"],
                              "gpt_124m_serve_failover": served24["k1_gpt"],
                              "gpt_124m_rlhf_rollouts": rl["k1"], "gpt_124m_job": ops["k1"],
                              "gpt_124m_cli_actors": cli["k1"], "gpt_124m_workflow": wf["k1"],
                              "gptj_6b_tp1_runner": tp1["plain"]["k1"] + tp1["spec"]["k1"]},
            at_head_dim_64=dict(timing64, bound_by="bytes"),
        ),
        dict(
            name="paged_verify_attention",
            route="cuda",
            source="ray_tpu_torch/ops/csrc/paged_verify_attention.cu",
            replaces="ray_tpu/ops/paged_attention.py:304",
            launches=(spec["launches"] + gpt_served["k2"] + production["k2"] + runtime["k2"] + served24["k2"]
                      + tp1["spec"]["k2"]),
            launches_by_path={"gptj_6b_spec_serve": spec["launches"], "gpt_124m_spec_serve": gpt_served["k2"],
                              "gpt_124m_production": production["k2"], "gpt_124m_actor": runtime["k2"],
                              "gpt_124m_serve_failover": served24["k2"], "gptj_6b_tp1_runner": tp1["spec"]["k2"]},
            max_abs_err=err2,
            ms=timing2["ms"],
            plain_ms=timing2["plain_ms"],
            bound_ms=timing2["bound_ms"],
            bound_by="bytes",
            library_ms=timing2["library_ms"],
            at_head_dim_64=dict(timing2_64, bound_by="bytes"),
        ),
    ]
    for i, (kernel_name, kernel, line) in enumerate((("flash_fwd", "K3", 57), ("flash_bwd_dq", "K4", 137),
                                                     ("flash_bwd_dkv", "K5", 177))):
        by_path = {"gpt_406m_train_step": trained["launches"][kernel],
                   "gpt_406m_torch_trainer": trained25["launches"][kernel],
                   "gpt_406m_trainer_from_dataset": trained26["launches"][kernel],
                   "gpt_124m_remat_policies": remat["launches"][i],
                   "gpt_124m_moe_train": moe["launches"][i],
                   "gpt_124m_tune_asha": tuned["asha"][i],
                   "gpt_124m_tune_pbt": tuned["pbt"][i],
                   "gpt_124m_tuner_over_trainer": tuned["inner"][i],
                   "gpt_124m_rlhf_learner": rl["flash"][i],
                   "gpt_124m_actor_pool": (ops["k3"], 0, 0)[i],
                   "gpt_124m_workflow": (wf["k3"], 0, 0)[i],
                   "gpt_406m_mesh_train_step": meshed["trained"]["launches"][kernel],
                   "gpt_406m_mesh_checkpoint_trainer": meshed["ckpt"]["trainer"][i],
                   "gpt_406m_mesh_checkpoint_here": meshed["ckpt"]["here"][i],
                   "gpt_406m_fit_report": meshed["proof"]["launches"][i],
                   "gpt_124m_moe_mesh_train_step": meshed["moe"]["launches"][i]}
        kernels.append(dict(
            name=kernel_name,
            route="cuda",
            source="ray_tpu_torch/ops/csrc/flash_attention.cu",
            replaces=f"ray_tpu/ops/flash_attention.py:{line}",
            launches=sum(by_path.values()),
            launches_by_path=by_path,
            **flash_timing[kernel],
            max_abs_err_at_rlhf_learner_shape=rl["flash_err"][kernel],
        ))
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--workflow-driver"]:  # phase 33's drivers
        sys.exit(wf_driver(*sys.argv[2:4]))
    sys.exit(main())
