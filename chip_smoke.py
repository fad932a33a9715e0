#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``glom_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                    # every phase: the smoke test
    python3 chip_smoke.py --only k1,train    # device, build and the named phases

Run from the root of a checkout; it builds everything it needs.  Phases,
each printing its JSON lines; any failure raises and exits non-zero.  With
``--only`` the run is partial, exits 3 and prints no ok line.

  device   the card's name and power limit (nvidia-smi);
  build    nvcc builds every kernel in glom_tpu_torch/kernels/csrc/;
  kernels  each kernel against its plain PyTorch version at the flagship
           shapes (b=8, n=256, L=6, d=512), in float32 and bfloat16, with
           times (CUDA events; per call, the median of REPS (10) runs of 5 calls
           after a warm-up) beside the bound and a PyTorch library call
           where one computes the same function: the forward kernels (K1's
           rows as the k1 phase gives them; K4/K5) and the backward ones (K2, K3 of the grouped FF; K6, K7 of
           consensus; K2 hands K3 the hidden and K6 hands K7 its dS', and
           each pair is timed together); K2 also at b=1 and at 49 rows
           (off its 32-row tile); consensus also with attend_self, the
           locality mask, b=1 and n=2304 (b=1, with SDPA's time on those
           inputs; the backward without b=1); and the fused level update
           (K8's rows as the k8 phase gives them); then every kernel at
           glom_tpu's tiny preset (b=8, d=64, h=256) and K1 and K4 at the
           16-wide demo, which the wrappers run zero-padded to d=128, with
           each call's device time from torch.profiler beside SDPA's and the
           bound at the true width;
  k1       (only with --only) K1's rows of the kernels phase alone: the
           bottom-up (g=6, strided view), top-down (g=5) and fuse_ff (g=11)
           calls at b=8, and b=1 and 49 rows (strided views), in float32
           and bfloat16; each with its split count, its bound, the plain
           version's time and a yardstick (two torch.baddbmm calls and an
           exact GELU in full float32 on the same inputs), and at b=8 in
           float32 its error against float64;
  k2       (only with --only) K2's rows of the kernels phase alone, each
           with a yardstick (torch.baddbmm for the pre-activation, torch.bmm
           for dO W2^T, the exact-erf GELU derivative and torch.bmm by W1^T,
           in full float32 on the same inputs);
  k6       (only with --only) K6's rows: at b=8 (in float32 also
           against float64), with attend_self (beside the backward of
           scaled_dot_product_attention), with the locality mask, at n=2304
           (b=1) and at b=1, in float32 and bfloat16: K6 with the dS' it
           hands K7 (held against the plain dS'), K7 on that dS' (its plain
           version the twin on the same dS'), and the pair timed together
           against the TPU kernels' work; each with its bound and a bitwise
           repeat;
  k8       (only with --only) K8's rows of the kernels phase alone: the
           fused level update at b=8 and b=1 (views of one (b, n, L+1, d)
           state), and at b=8 with attend_self and with the locality mask,
           in float32 and bfloat16, against its plain version; each with
           its split counts (K8b's hidden, the consensus keys), its bound,
           a bitwise repeat, and for b=8 and b=1 the plain version's time
           and two yardsticks on the same inputs: the kernels K8 replaces
           (K1 + K1 + K4 and the elementwise tail) and K1 over both nets'
           11 groups in one call + K4 + the tail; at b=8 in float32 its
           error against float64;
  k3       (only with --only) K3's rows: for the bottom-up (g=6, strided
           view) and top-down (g=5) calls at b=8, b=1 and 49 rows, in
           float32 and bfloat16, K2 with the hidden it hands K3, K3 on that
           hidden (its library column: two torch.bmm calls and a column
           sum on the same hidden), and the pair timed together against the
           TPU kernels' work;
  serve    a flagship demo checkpoint (dim 512, 6 levels, 224/14, random
           seeded weights) served over HTTP in-process, every bucket of every
           graph family (/embed, /reconstruct, the index forward and /parse's
           pack) a CUDA graph captured at start-up: /embed with batches
           of 1, 3 and 8, /reconstruct with 2, each with an X-Request-Id;
           shapes, finiteness, the id echoed, one answer against the plain
           path on the card, the kernels' launch counts (through replays),
           no graph captured on the request path (/metrics), the first
           request's trace in /debug/traces with glom_tpu's span names;
           then each bucket (1, 2, 4, 8) of both endpoints and of the index
           forward replayed against the same engine's eager forward (bitwise), the b=1, 4 and 8
           /embed forward eager against replayed, the capture seconds and
           the graph pools' bytes;
  profile  a torch.profiler trace of three b=8 /embed forwards through the
           kernels: the device's busy share and device time by kernel;
  train    the denoising train step at flagship width, b=8, through the
           kernels (Trainer.fit, 10 steps on one resident synthetic batch):
           finite, falling losses; ms per step and images/s against the
           plain ops on the card and, timed only, against ff_fused_bwd=False
           (K1 with the plain float32 VJP of the grouped FF); one step's gradients against the plain
           path; two runs of one step bitwise equal; the launches of all six
           kernels per step; one step's peak device memory, through the
           kernels and through the plain ops; a torch.profiler trace of two
           steps; and the checkpoint the trainer saved, served over HTTP on
           /embed;
  serve_fused  the same checkpoint served with ff_impl="fused" over HTTP,
           from its graphs: /embed with 1 and 8, /reconstruct with 2; the
           answer against the plain path and against the "pallas" engine;
           K8's launches (and none of K1 or K4); the serve phase's metrics,
           trace and graph checks; the b=8 forward's time on the three
           paths; a traced window;
  serve_load  the flagship "pallas" engine under the port's load generator
           (glom_tpu_torch/tools/loadgen.py, a process of its own): a closed
           loop (/embed, batch sizes 1-8, concurrency 8, 3 s) for the
           sustained rate, then an open loop at half its request rate for
           8 s with step 1 of the checkpoint landing 3 s in and
           hot-reloaded (its graphs captured off the request path); both
           loadgen reports (p95/p99 null: tens of requests), the mean of
           each request span, the memory of the two sets; no failed
           request, /healthz at step 1, the answer after the swap bitwise
           the eager forward of step 1's weights, one
           serving_param_reloads; then a second reload (step 2, no load)
           that leaves allocated memory where the first left it;
  train_fused  Trainer.fit at flagship width, b=8, ff_impl="fused" (K8
           forward; K1, K4 again and K2, K3, K6, K7 backward), 5 steps:
           losses, launches per step, gradients against the plain path,
           bitwise repeat, one step's peak device memory, ms per step
           beside the "pallas" step's; then 2
           steps each with remat=True and with fuse_ff=True, held the same
           way;
  train_data  training on data at flagship width, b=8, f32: a seeded uint8
           NHWC dataset of 1024 images at 256x256 as one .npy in build/
           (memory-mapped by the folder stream); the native batcher (it must
           build) held bitwise against the NumPy path over 4 batches; one
           two-view step (InfoNCE, weight 0.1) on "pallas" with the kernel
           backward, on "fused", and with MSE, each against the plain path
           (loss 1e-5, every gradient leaf 1e-4, relative); the two-view
           step's launches (the one-view step's, over 2b rows) and peak
           memory beside the one-view step's; Trainer.fit for 12 steps on
           the folder stream with flip, two views and an EvalSuite every 4
           steps (64 PSNR and 256 probe images of 8 seeded classes; the main
           path: counts set to 0 just before, read just after, each kernel's
           exact count asserted), checkpointed at step 6; a second trainer
           restored from step 6 and fed the run's batches 7-12 must give
           its losses and parameters bitwise; the eval's forwards at its
           chunk of 32 (a probe chunk's embeddings to 12 iterations, a PSNR
           chunk's state and PSNR to the loss timestep under fixed noise)
           against the plain path (1e-4 relative); the probes' float32
           standardize against float64 (64 roundoffs of the mean's
           cancellation), accuracies equal to a float64 probe's, and the
           single-level weights and test logits within 1e-3 of a float64
           solve; the step time, t_data_wait's share of the
           window, the eval seconds, the peak memory; then python -m
           glom_tpu_torch.training.train on the same data (--consistency
           mse --eval-every 5, 10 steps) must exit 0 with finite losses and
           psnr_db records;
  classify the classifier (models/classifier.py) at flagship width, b=8, f32,
           10 classes: logits and one unfrozen step's loss and gradients
           through the kernels against the plain path; 3 Adam steps (the
           main path: K1-K4, K6, K7 counted), ms a step, images/s, peak
           memory; a frozen step under adamw with weight decay: K1 and K4
           only, every backbone leaf bitwise as it was;
  video    models/video.py and training/video.py at flagship width, 8 frames
           of 4 images (examples/video_training.py's bench), 12 iterations
           a frame: each frame's rolled-out state against the plain path;
           one video step's loss and gradients over 4 frames under fixed
           noise against the plain path; 3 f32 steps over the clip (the main
           path, backprop through the carried state), then 3 in bf16 with
           remat; frames/s of the rollout and the step, each step's peak
           memory;
  extract  training/extract.py::extract_embeddings on 64 seeded images in
           batches of 24 (a tail of 16) through a checkpoint written with
           ff_impl="pallas", against the same checkpoint forced to the plain
           path, for the top level and for every level; images/s;
  islands  the index forward (hierarchy/parse.py::make_index_fn) at b=8
           against the plain path, then the islanding post-pass
           (make_pack_fn: 256 fixed propagation steps) on the card with each
           level's threshold at its 30/50/70 % agreement quantile, against
           the host flood fill on the same maps: labels and counts bitwise,
           sizes exact, means within 1e-5 of float64; the pack's time and
           its device operations;
  quant    serving at f32, bf16 and int8 on "pallas" and "fused" (six engines,
           every family captured at start-up; bf16 and int8 at buckets 1
           and 8): each bucket's /embed and /reconstruct replay bitwise its
           eager forward; the b=8 /embed against the plain path in the same
           mode (f32 1e-4, bf16 and int8 1e-2, relative); accuracy_report of
           bf16 and int8 against f32 with glom_tpu's thresholds (a miss is
           recorded); resident parameter bytes, each family's pool bytes,
           /embed b=1 and b=8 replay (device) and served (host) times;
  sessions stateful sessions, warm_iters "auto" (6 of 12), f32 "pallas": 8
           chained frames at b=1 and b=4 against models/video.py's
           rollout_varied (<= 1e-6 relative; bitwise reported), two
           interleaved sessions bitwise their solo runs, a batch change
           restarting cold, a spill on drain restored by a new engine whose
           next warm frame is bitwise the one of the engine that never
           stopped, an int8 session (bf16 state), a fused warm frame (K8
           only), cold and warm frame times, a session's state bytes;
  parse    /parse, /similar and /session/parse at flagship with each level's
           threshold at its 30/50/70 % agreement quantile: /parse at every
           bucket replayed against the eager index forward and pack (labels,
           counts, sizes bitwise, means 1e-5), an index of 64 seeded images,
           /similar on 8 of them at the top level and level 0 against a
           float64 scan of the same vectors (scores 4e-6; each image its own
           float64 top-1; at level 0 its own served top-1), four /session/parse frames against island_deltas on the
           eager labels, then over HTTP an int8 engine with a tenant quota
           (a=0.01:2): every new route once, tenant a's third image 503
           tenant_overloaded; /parse b=1 and b=8 device time, the pack's
           share, and no capture on the request path;
  deploy   safe deploys on one replica at flagship width, f32 "pallas",
           buckets 1 and 8, sessions on, an extra model "b" under "fused":
           a corrupt candidate quarantined before it is resident; a shadow
           (its capture seconds, the longest exclusive hold, /embed b=1 p99
           before and during it, the primary's b=1/b=8 p50/p95 without and
           with it, the divergence gauge against float64, every candidate
           replay bitwise its eager forward); a canary over 32 affinity keys
           (each answer bitwise the assigned version's), a burn-rate
           rollback under candidate:delay with no client error and a pinned
           session restarting cold; a clean candidate auto-promoted with no
           capture; the extra model through K8; three shadow -> rollback
           cycles within 1 % of allocated memory;
  session_tools  python -m glom_tpu_torch.tools.session_check --warm-iters
           2,3,4,6 --frames 8 --batch 2 through the session graphs (exact
           launch counts), then the loadgen's --sessions 4 --frames 8 and
           --tenant a:3 --tenant b:1 against an in-process server;
  faults   data:nan_batch@3 halting a flagship Trainer.fit (b=8, the
           kernel backward) with NonFiniteError at step 3, ckpt_write:torn
           on its last save (the loader falls back to step 1), and
           reload:io_error*3 on an engine's watcher (retries, backoff, then
           the load);
  quality  the quality post-pass graph family at flagship, buckets 1 and 8,
           the default quality_sample 1.0, on "pallas" f32, "fused" f32 and
           "pallas" bf16: each bucket's replay bitwise its eager post-pass,
           the signals against the plain path per column group (f32 1e-3
           max-abs, bf16 1e-2 relative), a sampled b=1 and b=8 /embed
           batch's launches exactly (the forward's and the post-pass's), no
           capture and no failed post-pass, the replay times and pools; a
           shadow deploy's agreement from the candidate's own family; /embed
           b=1 and b=8 p50/p95 with quality_sample 1.0 and 0.0; the quality
           smoke (tools/quality_report.py's loop) at flagship;
  capacity the capacity smoke (tools/capacity.py's loop) at flagship; a
           server under the loadgen's closed loop with the plane ticked on
           the host's clock: capacity_duty_cycle beside the CUDA-event time
           of the replays in its window, no utilization without a ceiling;
           trace_report --suggest-buckets on its trace log; a server on
           that ladder (--buckets-file) with --capacity-ceiling at the
           closed loop's images/s: a utilization in (0, 1.05], no capture;
  bulk     the bulk tier at flagship, f32 "pallas", buckets 1/2/4/8, one
           engine with a job store and its idle thread: an idle-only
           synthetic /embed job of 384 slots (slots/s, each chunk's device
           time by CUDA events, the share of the replay bound of 8 slots a
           b=8 replay, launches exactly K1 24 + K4 12 a bucket replay, no
           capture, the first chunk against the plain path); the
           kill-and-resume smoke (tools/bulk_run.py) bitwise the control with
           no capture; one client's closed loop of 100 requests of 1-7 images
           without and with a 4096-slot job active (answers bitwise,
           bulk_scavenged_slots_total above 0, the idle buckets' launches
           exactly on top of the loop's, the loop's p50/p99) and /embed b=1
           p50/p99 over 100 requests each way; an index job over 64 slots and /similar over
           its sink (each image its own top-1 at level 0); the bucket and
           offset bit check on "pallas" and "fused", reported, with the
           predictions beside the measurements;
  attribution  whyslow's smoke (tools/whyslow.py) at flagship, buckets 1 and
           2: baseline traffic over HTTP, then a canary at fraction 1.0 under
           candidate:delay; exactly one cause, the deploy_canary event at its
           step, queue_wait the majority phase, no capture, the op-diff plane
           None, a byte-identical verdict on re-attribution; the launches of
           the regression window (after the candidate's captures) whole
           replays of K1 24 + K4 12;
  fleet    the port's router (serving/router.py) at flagship, f32 "pallas",
           buckets 1/2/4/8, over two replicas spawned in-process by its
           --spawn path: each replica's memory; an /embed through the router
           bitwise the serving replica's direct answer and within 1e-3 of
           the plain path; a window of routed requests (the main path)
           launching exactly K1 24 + K4 12 a replay plus each sampled
           batch's quality post-pass, no capture; X-Affinity-Key frames on
           one replica each; /embed b=1 p50/p99 direct and through the
           router (100 each, in turns); the loadgen's closed loop through a
           router over one replica and over both; fail-over (a replica's
           server shut down under a client's loop: no failed request, the
           ejection and, after its restart, the re-admission on
           /debug/timeline); a coordinated rollout under that loop (the
           captures, the longest exclusive hold, no new -> old answer by the
           router's admission) and one whose prepare fails through the
           reload fault seam (both stay on the old step); an index job
           sharded over both and /similar's merge (each query its own top-1
           at level 0, glom_tpu's merge rule); the observatory's console;
           two server processes on the one card under the same closed loop,
           the busy share from the replays' CUDA-event times beside each
           loop; loadgen --smoke --fleet (stitched coverage >= 0.95, its
           spans and parent links); capacity and quality_report --smoke
           --fleet;
  train_obs  the trainer with every observability and robustness field on at
           flagship, f32, b=8, "pallas" with the kernel backward (the main
           path: 12 steps and two diagnostics points, exact launches):
           metrics_csv rows equal to the JSONL records, prom_textfile's
           steps_total, train_trace.json's phases, no build in the window; a
           scaled batch's grad_spike bundle (its kernels.json one step's
           launches, its trace two steps' K1-K4, K6, K7); the diagnostics on
           "pallas" and "fused" (K8) within 1e-4 of the plain path; the async
           save bitwise the sync one and a ckpt_write:torn fault raising
           from finish_saves; nan (data:nan_batch), step_time_regression
           (data:delay) and crash bundles; --supervise with data:crash once:
           one restart (supervisor_restarts_io_error 1) and the parameters
           bitwise an unfailed run's; a sticky CUDA error (K1 writing through
           a bad pointer, in a child process) classified cuda_fatal and the
           supervisor giving up at once; the window rate all fields on
           against all off, with the predictions beside the measurements;
  forensics  an engine at flagship, f32 "pallas", buckets 1/8, with
           forensics_dir and warmup_dir: one warm-up bundle a family and
           bucket (each launch table the graph's replay launches; /embed K1
           24 + K4 12; no capture added; warm-up timed against an engine
           without warmup_dir); /embed b=1 and b=8 bitwise their eager
           forwards; an induced slo_burn bundle with attribution.json listed
           on /debug/forensics; a shadow candidate over HTTP (its snapshots
           in the attribution evidence) and a forced rollback's
           deploy_rollback bundle; the op-diff of a bf16 engine's graphs
           naming the quant change at both buckets; the answers again,
           bitwise;
  widths   widths off the kernels' multiples (the wrappers run the kernels
           on zero-padded copies, the consensus scaled by the true width):
           one f32 train step at glom_tpu's tiny preset (b=8, d=64, 3
           levels, 64/8, h=256) on "pallas" with ff_fused_bwd and on
           "fused", launches exact, loss and gradients against the plain
           path, two runs bitwise; /embed on the 16-wide demo checkpoint
           (glom_tpu's DEMO_CONFIG) from graphs at buckets 1 and 8 on
           "pallas" and "fused", launches exact, answers within 1e-3 of the
           plain path; "auto" at the tiny preset picking "pallas"; the
           kernels' digests at flagship (tools/kernel_digest.py);
  chaos    the port's chaos suite (glom_tpu_torch/tools/chaos.py) on the
           card, smoke variants: the five train and reload scenarios and
           replica_kill (all eleven under --only chaos), each scenario's
           outcome, MTTR and wall seconds on a line of its own, every one
           recovered;
  bench    ``python -m glom_tpu_torch.tools.bench`` as a user runs it, at
           flagship with 12 iterations, over legs (a)-(e) in six runs,
           each record on its own line with the card's name and power
           limit: (a) the record configuration, bench's defaults (bf16,
           remat "dots", b=32, K1 forward with the plain FF backward,
           dense consensus), traced;
           (b) (a) through all the kernels (K1-K4, K6, K7), traced; (c) (a)
           fused (K8 and its backward's K1-K7); (d) the plain ops under
           remat "dots" and under "full" (peak memory of each); (e) the
           train phase's configuration (f32, no remat, the kernels, b=8).
           It fails on a leg not ok, an mfu outside (0, 1], a build inside
           a timed window, a kernel of a leg not launched, "dots" peaking
           below "full", (a)'s trace without the step phase, (b)'s without
           K1's kernels, or (after the train phase) (e)'s rate more than
           10 % off the train phase's;
  large    glom_tpu's large preset (BASELINE.json config 4: d=1024, 8 levels,
           384/16, n=576, 16 iterations, random seeded weights, nothing
           cut): (i) K1 (bottom-up g=8 strided, top-down g=7), K4 (b=4; the
           locality mask; n=2304, b=1; d=2048, b=1), K8 (b=4), K2, K3 and
           their pair (bottom-up g=8 strided, top-down g=7; K3 held against
           the float64 sums) and K6, K7 and their pair (b=4; attend_self beside SDPA's
           backward; the locality mask), float32 and bfloat16, each against
           its plain version with its time, bound and library call, as the
           kernels phase's rows (fewer timing samples); (ii) a seeded
           checkpoint served over HTTP on /embed from CUDA graphs at buckets
           1, 2 and 4 on "pallas" f32 (K1 32 + K4 16 launches a forward), on
           "fused" f32 (K8 16) and on "pallas" bf16: answers against the
           plain path, exact launches through the replays, the b=4 replay
           bitwise its eager forward and timed; (iii) python -m
           glom_tpu_torch.tools.bench --config large through every kernel
           (--ff-impl pallas --attention-impl pallas --fused-ff-bwd, leg (b)),
           5 steps, the record with the card's name and power limit; (iv) one
           f32 train step at b=4 of a Trainer with attention_impl="pallas"
           (K4, K6, K7 9 each), ff_fused_bwd=True (K1, K2, K3 18 each) and
           ff_impl="fused" (K8 9, K1 18, K4, K6, K7 9), launches exact, loss
           and gradients against the plain path, two runs of one step
           bitwise; "auto" attention picking "pallas" on the card; and one
           step on "dense" and on "pallas" attention, timed, for the
           crossover's row;
  mesh     multi-GPU training on the one card, flagship f32 b=8, 2 steps:
           (i) a world of one over NCCL through ``python -m
           glom_tpu_torch.training.train --mesh 1 1 1 --num-processes 1
           --coordinator localhost:PORT`` (launches exact); (ii) two ranks
           sharing the card over gloo (NCCL refuses two ranks on one
           device; what gloo does not take on CUDA tensors is staged through
           pinned host copies), each on cuda:0: (2, 1, 1) DP with
           ff_impl="fused" (K8 a rank), (1, 2, 1) TP (K1/K2/K3 at h=1024 a
           rank), (1, 1, 2) ring and Ulysses (n=128 columns a rank), (1, 2,
           1) EP (bottom-up's 6 groups split, top-down's 5 replicated);
           every rank's device, backend, launches a step (exact) and step
           times, and the loss and every parameter within 1e-4 of the
           one-rank step on the card from the same seed, batches and noise;
  pipe     GPipe (parallel/pipeline.py) on ranks sharing the card over gloo,
           flagship f32 b=8, 12 iterations, 2 microbatches (6 iterations a
           stage), the loss at t=7 (mid-chunk on stage 1): (i) two ranks on
           ("pipe",) = (2,) with "pallas" (K1, K4; K2, K3, K6, K7 backward)
           and with "fused" (no stage runs K8): the forward (final and
           captured) within 1e-3 max-abs and 1e-4 relative of the one-rank
           forward, one step of make_step_fn(apply_fn=...) with the loss,
           every parameter and every first moment within 1e-4 of the
           one-rank step, launches exact per rank from the schedule, the
           ranks bitwise alike, a rank's warm step over the one-rank step's;
           (ii) the data-parallel forward (parallel/inference.py) on
           ("data",) = (2,) at b=5 (padded to 6, sliced back) on "pallas" and
           on "fused" (K8 12 a rank), against the one-rank forward; (iii)
           under --only pipe only, (pipe 2, model 2) and (pipe 2, seq 2) on
           four ranks, gated as (i);
  shard_serve  the sharded serving engine (serving/sharded.py) at flagship
           f32 on ranks sharing the card over gloo, rank 0 leading: (i)
           (2, 1, 1) DP on "fused" from graphs (K8 12 an /embed a rank) and
           (1, 2, 1) TP on "pallas", eager (K1 24 at h=1024, K4 12):
           /embed and /reconstruct at b=8 (each with the quality
           post-pass), /parse and the index forward, SHARD_REPS timed
           /embed b=8 calls, one /embed b=1 through the leader's HTTP
           server; every rank's launches of every call exact, the answers
           within 1e-3 of the port's one-rank engine (a DP rank's rows
           bitwise it at bucket 4), no capture on the request path, a hot
           reload served by every rank, the leader's dispatch times; (ii) a
           world of one over NCCL through ``python -m
           glom_tpu_torch.serving.server --mesh-shape 1,1,1`` serving
           /embed (launches exact, within 1e-3); (iii) under --only
           shard_serve only, (1, 2, 1) EP, (1, 1, 2) seq and (2, 2, 1) int8
           TP on four ranks (within 1e-2 normwise of the one-rank int8
           engine).

Then the kernels' summary line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  Float32 matrix products run in full
float32: TF32 is switched off for matmul and cuDNN.
"""

from __future__ import annotations

import contextlib
import csv
import gc
import itertools
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from glom_tpu_torch import checkpoint as ckpt_lib
from glom_tpu_torch.config import GlomConfig, TrainConfig, bench_preset
from glom_tpu_torch.kernels import _build
from glom_tpu_torch.kernels import wrappers as kernel_wrappers
from glom_tpu_torch.kernels import consensus as consensus_kernel
from glom_tpu_torch.kernels import ff as ff_kernel
from glom_tpu_torch.kernels import fused_update as fused_kernel
from glom_tpu_torch.models import glom as glom_model
from glom_tpu_torch.ops import consensus as plain_cons
from glom_tpu_torch.ops import feedforward as plain_ffm
from glom_tpu_torch.ops.consensus import consensus_attention as plain_consensus
from glom_tpu_torch.ops.consensus import l2_normalize
from glom_tpu_torch.ops.feedforward import grouped_ff_apply as plain_ff
from glom_tpu_torch.parallel.placement import gather_to_host
from glom_tpu_torch.profiling import memory_analysis, trace_files
from glom_tpu_torch.serving.engine import DEMO_CONFIG, ServingEngine, make_demo_checkpoint
from glom_tpu_torch.serving.server import make_server
from glom_tpu_torch.training import denoise
from glom_tpu_torch.training.metrics import MetricLogger
from glom_tpu_torch.training.optim import Optimizer
from glom_tpu_torch.training.trainer import Trainer

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = GlomConfig(dim=512, levels=6, image_size=224, patch_size=14)
BATCH = 8
# H100 SXM data-sheet peaks (dense): f32 on the CUDA cores, bf16 on the
# tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
HBM_BYTES_PER_S = 3.35e12
# Each kernel is held against its plain version computed in float32 on the
# same inputs (a bfloat16 input is exact in float32), with limits scaled to
# the output and RTOL by the kernel's type:
#   normwise     ||got - want|| <= RTOL ||want||           (Frobenius norms)
#   elementwise  |got - want| <= RTOL (min(1, max|want|) + |want|)
# float32 differs by summation order only; a bfloat16 output is rounded once,
# by at most 2**-8 of each value.  K6 adds its key term to a larger value
# term, so the key term is also held on its own:
#   ||got - want|| <= RTOL ||key term|| + u ||want||
# with u the output type's unit roundoff (2**-24, 2**-8).
RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# the tensor cores' dense TF32 rate; the float32 kernels take three TF32
# passes a product (3xTF32), bounding them at 3 * FLOPs over this rate
TF32_FLOPS = 495e12
# embeddings after 12 iterations, kernels vs the plain path, float32
SERVE_ATOL = 1e-3
REPS, INNER = 10, 5
# one train step's gradients, kernels vs the plain path, float32: relative
# (Frobenius) error per parameter leaf
GRAD_RTOL = 1e-4
TRAIN_STEPS = 10
FUSED_TRAIN_STEPS = 5
KNOB_TRAIN_STEPS = 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Per-call time of ``fn()``: the median over REPS samples, each a run
    of INNER calls between two CUDA events, after a warm-up.  Queuing INNER
    calls back to back keeps the host's launch gaps out of the device time;
    one more call queued before the start event keeps the card busy while
    the host prepares the first timed one, whose preparation would otherwise
    count as device time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn()
        start.record()
        for _ in range(INNER):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / INNER)
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bounds(flops: float, nbytes: float, dtype) -> dict:
    """The bound (the function's own: its type's peak rate) and, for a
    float32 kernel, the bound of its method, 3xTF32 on the tensor cores."""
    bms, by = bound_ms(flops, nbytes, dtype)
    tf32 = (max(3 * flops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
            if dtype == torch.float32 else None)
    return {"bound_ms": bms, "bound_by": by, "bound_3xtf32_ms": tf32,
            "peak_flops": PEAK_FLOPS[dtype], "gflop": flops / 1e9}


def f32(tree):
    """A tensor or a dict of tensors in float32."""
    return glom_model.tree_map(lambda t: t.float(), tree) if isinstance(tree, dict) else tree.float()


def compare(got: torch.Tensor, want: torch.Tensor, dtype, what: str, part=None) -> dict:
    """``got`` (the kernel's, in ``dtype``) against ``want`` (the plain
    version in float32) under the limits stated at RTOL; ``part``, a term of
    ``want`` held on its own."""
    rtol = RTOL[dtype]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    top = float(w.abs().max())
    err_norm, want_norm = float(torch.linalg.vector_norm(diff)), float(torch.linalg.vector_norm(w))
    err = {"max_abs_err": float(diff.max()), "norm_rel_err": err_norm / max(want_norm, 1e-30),
           "want_rms": want_norm / w.numel() ** 0.5, "want_max": top, "rtol": rtol}
    ok = (bool(torch.isfinite(g).all()) and err_norm <= rtol * want_norm
          and bool((diff <= rtol * (min(1.0, top) + w.abs())).all()))
    if part is not None:
        part_norm = float(torch.linalg.vector_norm(part.float()))
        u = torch.finfo(dtype).eps / 2
        err.update({"part_rms": part_norm / w.numel() ** 0.5,
                    "part_rel_err": err_norm / max(part_norm, 1e-30),
                    "part_limit": rtol + u * want_norm / max(part_norm, 1e-30)})
        ok = ok and err["part_rel_err"] <= err["part_limit"]
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version: {err}")
    return err


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in kernel_wrappers().values():
        fn.launches = 0


def launch_counts() -> dict:
    """``{kernel: launches}`` since the last :func:`reset_launches`."""
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def phase_build() -> None:
    t0 = time.perf_counter()
    per_source = _build.build_all()
    ptxas = {}
    for name, src in _build.sources().items():
        log = os.path.join(_build.BUILD_DIR, f"{name}-{_build._digest(src)}.log")
        with open(log) as f:
            text = f.read()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        # (kernel, template arguments: element type and width) of each
        # function that spills, and the registers of each
        kernel = r"([a-z_]+_kernel)I(\w+?)E"

        def label(m):
            return f"{m[0]}<{m[1].replace('13__nv_bfloat16', 'bf16').replace('Li', ',')}>"

        spilling = [f"{label(m)} {m[2]} B"
                    for m in re.findall(r"Function properties for \S*?" + kernel +
                                        r"\S*\s+\d+ bytes stack frame, (\d+) bytes spill stores",
                                        text) if int(m[2])]
        per_kernel = {}
        for fn, body in re.findall(r"Compiling entry function '(\S+)'(.*?)(?=Compiling entry|\Z)",
                                   text, re.S):
            m = re.search(kernel, fn)
            used = re.search(r"Used (\d+) registers", body)
            if m and used:
                per_kernel[label((m[1], m[2]))] = int(used[1])
        ptxas[name] = {"max_registers": max(regs, default=0), "spills": spilling,
                       "registers": per_kernel}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": per_source, "ptxas": ptxas,
          "flags": " ".join(_build.NVCC_FLAGS)})


def grouped_ff_f64(params, x):
    """The grouped FF's output computed in float64 on the same inputs: the
    exact value against which K1 and its float32 plain version are both
    measured."""
    x64 = x.double()
    w1, b1, w2, b2 = (params[k].double() for k in ("w1", "b1", "w2", "b2"))
    pre = torch.einsum("bngd,gdh->bngh", x64, w1) + b1
    hid = 0.5 * pre * (1.0 + torch.erf(pre * 2.0 ** -0.5))
    return torch.einsum("bngh,ghd->bngd", hid, w2) + b2


def k1_case(params, x, dtype, label, *, exact=False):
    """K1 (the grouped FF forward) against its plain version computed in
    float32 on the same inputs, with its split count, bound, the plain
    version's time and a yardstick: two torch.baddbmm calls and the exact
    GELU in full float32 on the same inputs arranged (groups, rows, d)
    outside the timing (three calls, never called by the port; no single
    PyTorch call computes K1, so library_ms stays null).  ``exact``: also
    the kernel's and the float32 plain version's error against float64,
    the kernel's held within compare()'s limits."""
    rows, gr, d, h, item = ff_dims(params, x)
    got = ff_kernel.grouped_ff(params, x)
    want = plain_ff(f32(params), x.float())
    torch.cuda.synchronize()
    err = compare(got, want, dtype, f"grouped_ff {label}")
    flops = 4.0 * rows * gr * d * h
    nbytes = item * (2 * rows * gr * d + gr * (2 * d * h + h + d))
    row = {"kernel": "grouped_ff", "case": label, "dtype": str(dtype).replace("torch.", ""),
           "shape": list(x.shape), "splits": ff_kernel.planned_splits(x.device, rows, gr, d, h, dtype),
           **err, "bitwise_repeat": torch.equal(got, ff_kernel.grouped_ff(params, x))}
    if not row["bitwise_repeat"]:
        raise AssertionError(f"grouped_ff {label}: two calls differ")
    if exact:
        want64 = grouped_ff_f64(params, x)
        row["vs_f64"] = {"kernel": error_vs([got], [want64], dtype),
                         "plain_f32": error_vs([want], [want64], dtype)}
        vs = row["vs_f64"]["kernel"]
        if not (vs["norm_rel_err"] <= RTOL[dtype] and vs["limit_share"] <= 1.0):
            raise AssertionError(f"grouped_ff {label}: off the float64 values by {vs}")
        del want64
    del got, want
    xg = x.float().reshape(rows, gr, d).transpose(0, 1).contiguous()
    w1, b1, w2, b2 = (params[k].float() for k in ("w1", "b1", "w2", "b2"))
    b1, b2 = b1[:, None, :], b2[:, None, :]
    row.update({
        "kernel_ms": time_ms(lambda: ff_kernel.grouped_ff(params, x)),
        "plain_ms": time_ms(lambda: plain_ff(params, x)),
        "yardstick_ms": time_ms(lambda: torch.baddbmm(
            b2, F.gelu(torch.baddbmm(b1, xg, w1), approximate="none"), w2)),
        "yardstick": "torch.baddbmm, F.gelu(approximate='none'), torch.baddbmm in full float32 "
                     "on the same inputs arranged (groups, rows, d)",
        "library_ms": None, **bounds(flops, nbytes, dtype)})
    return row


def k1_inputs(cast, x):
    """K1's cases: ``(label, params, x)`` for the main path's two calls at
    b=8 (the bottom-up strided view, g=6, and the top-down input, g=5), the
    fuse_ff call (both nets as one call of 11 groups), then b=1 and 49 rows
    (off the 64-row tile) as strided views."""
    pos = cast["pos_emb"][None, :, None, :]
    bu, td = cast["bottom_up"], cast["top_down"]
    td_in = x[..., 2:, :] + pos
    both = {k: torch.cat([bu[k], td[k]]) for k in ("w1", "b1", "w2", "b2")}
    return (("bottom_up (strided view, g=6)", bu, x[..., :-1, :]),
            ("top_down (g=5)", td, td_in),
            ("fuse_ff (g=11)", both, torch.cat([x[..., :-1, :], td_in], dim=-2)),
            ("bottom_up b=1 (strided view, g=6)", bu, x[:1, :, :-1, :]),
            ("bottom_up 49 rows (strided view, g=6)", bu, x[:1, :49, :-1, :]))


def k1_rows(cast, x, dtype):
    """K1's rows in ``dtype``, one a case of k1_inputs; the b=8 cases in
    float32 also against float64."""
    return [k1_case(p, xx, dtype, label, exact=dtype == torch.float32 and xx.shape[0] == BATCH)
            for label, p, xx in k1_inputs(cast, x)]


def sdpa_call(levels, dtype):
    """SDPA on the attend_self=True variant of ``levels`` (the consensus
    kernels' library call), as a function."""
    q = levels.transpose(1, 2)
    k = l2_normalize(levels.float()).to(dtype).transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(q, k, q)


def sdpa_backward_call(levels, g, dtype):
    """SDPA's backward (dQ, dK, dV) on the attend_self=True variant of
    ``levels`` with the cotangent ``g``, as a function (the consensus
    backward kernels' library call)."""
    q = levels.transpose(1, 2).detach().requires_grad_(True)
    k = l2_normalize(levels.float()).to(dtype).transpose(1, 2).detach().requires_grad_(True)
    v = levels.transpose(1, 2).detach().requires_grad_(True)
    o = F.scaled_dot_product_attention(q, k, v)
    go = g.transpose(1, 2)
    return lambda: torch.autograd.grad(o, (q, k, v), go, retain_graph=True)


def consensus_case(levels, dtype, label, *, attend_self=False, mask=None, library=None):
    """K4 against its plain version computed in float32.  ``library``
    (default: attend_self=True without a mask, the one variant
    scaled_dot_product_attention computes exactly) also times SDPA on that
    variant of the same inputs: the same shapes and work."""
    out, lse = consensus_kernel.consensus_attention(
        levels, attend_self=attend_self, non_local_mask=mask)
    ref, ref_lse = plain_consensus(levels.float(), attend_self=attend_self, non_local_mask=mask)
    torch.cuda.synchronize()
    err = compare(out, ref, dtype, f"consensus {label}")
    lse_err = compare(lse, ref_lse, torch.float32, f"consensus lse {label}")
    b, n, L, d = levels.shape
    item = levels.element_size()
    flops = 4.0 * b * L * n * n * d
    nbytes = 2 * item * b * n * L * d + 4 * b * L * n + (n * n if mask is not None else 0)
    row = {"case": label, "dtype": str(dtype).replace("torch.", ""),
           "shape": list(levels.shape), **err, "lse_max_abs_err": lse_err["max_abs_err"],
           "kernel_ms": time_ms(lambda: consensus_kernel.consensus_attention(
               levels, attend_self=attend_self, non_local_mask=mask)),
           "plain_ms": time_ms(lambda: plain_consensus(
               levels, attend_self=attend_self, non_local_mask=mask)),
           "library_ms": None, **bounds(flops, nbytes, dtype)}
    if library is None:
        library = attend_self and mask is None
    if library:
        row["library_ms"] = time_ms(sdpa_call(levels, dtype))
        row["library"] = "torch.nn.functional.scaled_dot_product_attention"
        row["library_case"] = "attend_self=True"
    return row


def ff_dims(params, x):
    """``(rows, groups, d, h, element bytes)`` of a grouped-FF call."""
    b, n, gr, d = x.shape
    return b * n, gr, d, params["w1"].shape[-1], x.element_size()


def k2_case(params, x, g, dtype, label):
    """K2 (dX) against its plain version, the hidden it stores for K3 against
    the plain hidden: ``(row, hidden)``.  The row times K2 with the stores
    (the main path's call, ``kernel_ms``) and without them; ``hidden`` is
    what K3 then reads."""
    rows, gr, d, h, item = ff_dims(params, x)
    p32, x32, g32 = f32(params), x.float(), g.float()
    got, hidden = ff_kernel.grouped_ff_dx(params, x, g, keep_hidden=True)
    want = plain_ffm.grouped_ff_dx(p32, x32, g32)
    torch.cuda.synchronize()
    err = compare(got, want, dtype, f"grouped_ff_dx {label}")
    row = {"kernel": "grouped_ff_dx", "case": label, "dtype": str(dtype).replace("torch.", ""),
           "shape": list(x.shape), "splits": ff_kernel.planned_dx_splits(x.device, rows, gr, d, h, dtype),
           **err}
    for name, u, v in zip(("hid", "dh"), hidden, plain_ffm.grouped_ff_hidden(p32, x32, g32)):
        row[f"{name}_norm_rel_err"] = compare(u, v, torch.float32,
                                              f"grouped_ff_dx {label} {name}")["norm_rel_err"]
    handoff_bytes = 2 * 4 * gr * rows * h   # hid and dh, f32, written once
    row["kernel_ms"] = time_ms(lambda: ff_kernel.grouped_ff_dx(params, x, g, keep_hidden=True))
    row["kernel_ms_no_handoff"] = time_ms(lambda: ff_kernel.grouped_ff_dx(params, x, g))
    flops = 6.0 * rows * gr * d * h
    nbytes = item * (3 * rows * gr * d + gr * (2 * d * h + h)) + handoff_bytes
    row.update({"handoff_bytes": handoff_bytes,
                "plain_ms": time_ms(lambda: plain_ffm.grouped_ff_dx(params, x, g)),
                **bounds(flops, nbytes, dtype)})
    # the yardstick on the same inputs in full float32 (x and dO cast outside
    # the timing for bf16): the pre-activation by one baddbmm, dO W2^T by one
    # bmm, the exact-erf GELU's derivative, and the product by W1^T
    xg = x.float().reshape(rows, gr, d).transpose(0, 1)
    gg = g.float().reshape(rows, gr, d).transpose(0, 1)
    w1, b1, w2 = (p32[k] for k in ("w1", "b1", "w2"))
    w1t, w2t = w1.transpose(1, 2), w2.transpose(1, 2)

    def yardstick():
        pre = torch.baddbmm(b1[:, None, :], xg, w1)
        cdf = 0.5 * (1.0 + torch.erf(pre * 2.0 ** -0.5))
        pdf = torch.exp(-0.5 * pre * pre) * (2.0 * np.pi) ** -0.5
        return torch.bmm(torch.bmm(gg, w2t) * (cdf + pre * pdf), w1t)

    yard = yardstick().transpose(0, 1).reshape(want.shape)
    row["library_vs_plain"] = compare(yard, want, torch.float32,
                                      f"grouped_ff_dx {label} yardstick")["norm_rel_err"]
    row["library_ms"] = time_ms(yardstick)
    row["library"] = ("torch.baddbmm (x W1 + b1), torch.bmm (dO W2^T), the exact-erf GELU "
                      "derivative and torch.bmm by W1^T, in full float32, on the same inputs")
    return row, hidden


def grouped_ff_dw_f64(params, x, g):
    """``(dW1, db1, dW2)`` of the grouped FF computed in float64 (the
    formulas of plain.grouped_ff_dw, the cotangent cast to ``x``'s type
    first): the exact sums against which K3 and its float32 plain version
    are both measured."""
    x64, g64 = x.double(), g.to(x.dtype).double()
    w1, b1, w2 = (params[k].double() for k in ("w1", "b1", "w2"))
    pre = torch.einsum("bngd,gdh->bngh", x64, w1) + b1
    cdf = 0.5 * (1.0 + torch.erf(pre * 2.0 ** -0.5))
    pdf = torch.exp(-0.5 * pre * pre) / (2.0 * np.pi) ** 0.5
    dh = torch.einsum("bngd,ghd->bngh", g64, w2) * (cdf + pre * pdf)
    return (torch.einsum("bngd,bngh->gdh", x64, dh), dh.sum(dim=(0, 1)),
            torch.einsum("bngh,bngd->ghd", pre * cdf, g64))


def error_vs(got, exact, dtype) -> dict:
    """The worst over outputs of ``got`` against ``exact`` (float64):
    normwise relative error, and the largest share of compare()'s
    elementwise limit that any element uses."""
    out = {"norm_rel_err": 0.0, "limit_share": 0.0}
    for u, w in zip(got, exact):
        diff = (u.double() - w).abs()
        limit = RTOL[dtype] * (min(1.0, float(w.abs().max())) + w.abs())
        out["norm_rel_err"] = max(out["norm_rel_err"],
                                  float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(w)))
        out["limit_share"] = max(out["limit_share"], float((diff / limit).max()))
    return out


def k3_case(params, x, g, hidden, dtype, label, k2_ms, *, exact_gate=False):
    """K3 (dW) against the reference plain.grouped_ff_dw; the worst of its
    three outputs.  K3 reads ``hidden`` (K2's) and does 4 units of
    rows*d*h*groups FLOPs, reading x, dO and the hidden; its plain version
    is the twin on the same hidden, and its library time two torch.bmm
    calls in full float32 and the column sum of dH on the same hidden.
    ``k2_ms``: the time of the K2 it needs, beside it.  ``exact_gate``: hold
    the outputs against the float64 sums instead, under the same limits
    (the reference plain version's error against them is reported): over
    thousands of rows the float32 plain version's own rounding can reach
    the elementwise limit on small entries."""
    rows, gr, d, h, item = ff_dims(params, x)
    outputs = gr * (2 * d * h + h)
    hid, dh = hidden
    call = lambda: ff_kernel.grouped_ff_dw(params, x, g, hidden)
    plain = lambda: plain_ffm.grouped_ff_dw_from_hidden(x, g, hid, dh, dtype)
    flops = 4.0 * rows * gr * d * h
    nbytes = item * (2 * rows * gr * d + outputs) + 2 * 4 * gr * rows * h
    got = call()
    want = plain_ffm.grouped_ff_dw(f32(params), x.float(), g.float())
    torch.cuda.synchronize()
    # both against the exact sums: over thousands of rows the float32 plain
    # version's own rounding is of the order of the kernel's
    exact = grouped_ff_dw_f64(params, x, g)
    vs_f64 = {"kernel": error_vs(got, exact, dtype), "plain_f32": error_vs(want, exact, dtype)}
    ref = [w.float() for w in exact] if exact_gate else want
    errs = [compare(u, v, dtype, f"grouped_ff_dw {label} {k}")
            for k, u, v in zip(("w1", "b1", "w2"), got, ref)]
    del exact, ref
    row = {"kernel": "grouped_ff_dw", "case": label, "dtype": str(dtype).replace("torch.", ""),
           "shape": list(x.shape), **max(errs, key=lambda e: e["norm_rel_err"]),
           "gate": "float64" if exact_gate else "plain",
           "bitwise_repeat": all(torch.equal(u, v) for u, v in zip(got, call())),
           "vs_f64": vs_f64, "splits": ff_kernel.planned_dw_splits(x.device, rows, gr, d, h, dtype),
           "kernel_ms": time_ms(call), "k2_ms": k2_ms, "plain_ms": time_ms(plain),
           "library_ms": None, **bounds(flops, nbytes, dtype)}
    if not row["bitwise_repeat"]:
        raise AssertionError(f"grouped_ff_dw {label}: two calls differ")
    if exact_gate:
        row["vs_plain"] = {"max_abs_err": max(float((u.float() - v).abs().max())
                                              for u, v in zip(got, want)),
                           "norm_rel_err": max(rel_err(u, v) for u, v in zip(got, want))}
    # the yardstick on the same hidden: dW1 = X^T dH and dW2 = H^T dO as
    # batched products over the groups, in full float32 (x and dO cast
    # outside the timing for bf16), and db1 = dH summed over rows
    xg = x.float().reshape(rows, gr, d).transpose(0, 1)
    gg = g.float().reshape(rows, gr, d).transpose(0, 1)
    row["library_ms"] = time_ms(lambda: (torch.bmm(xg.transpose(1, 2), dh), dh.sum(dim=1),
                                         torch.bmm(hid.transpose(1, 2), gg)))
    row["library"] = ("two torch.bmm calls in full float32 (X^T dH, H^T dO) and dH.sum over "
                      "rows, on the same hidden")
    return row


def pair_case(params, x, g, dtype, label, k2_ms, k3_ms):
    """K2 + K3 as the backward runs them (K2 handing K3 the hidden), timed
    together, against the bound of the work dX and dW need: 10 units of
    rows*d*h*groups FLOPs (x W1, dO W2^T, dH W1^T, X^T dH, H^T dO; the TPU
    kernels do 14, their K3 forming the hidden again), reading x, dO and the
    weights and writing dX and dW once."""
    rows, gr, d, h, item = ff_dims(params, x)
    call = lambda: ff_kernel.grouped_ff_dw(
        params, x, g, ff_kernel.grouped_ff_dx(params, x, g, keep_hidden=True)[1])
    flops = 10.0 * rows * gr * d * h
    nbytes = item * (3 * rows * gr * d + 2 * gr * (2 * d * h + h))
    # the library call: the plain float32 FF VJP (autograd through the
    # einsums on cuBLAS; the fused_bwd=False backward), one call, on the
    # same inputs cast to float32 outside the timing
    p32, x32, g32 = f32(params), x.float(), g.float()
    return {"kernel": "grouped_ff_dx+grouped_ff_dw", "case": label,
            "dtype": str(dtype).replace("torch.", ""), "shape": list(x.shape),
            "kernel_ms": time_ms(call), "k2_ms": k2_ms, "k3_ms": k3_ms,
            "work": "10 units, what dX and dW need (the TPU kernels do 14)",
            "library_ms": time_ms(lambda: ff_kernel.plain_vjp(p32, x32, g32)),
            "library": "ff.plain_vjp in float32: autograd through grouped_ff_apply's einsums "
                       "(cuBLAS), one call, on the same inputs",
            **bounds(flops, nbytes, dtype)}


def consensus_bwd_f64(levels, g, attend_self=False, mask=None):
    """``(dKV, dQ)`` of consensus attention in float64, the forward's out,
    lse and delta included: the exact values against which K6, K7 and their
    float32 plain versions are measured."""
    x, gd = levels.double(), g.to(levels.dtype).double()
    n, d = x.shape[1], x.shape[-1]
    k = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    sim = torch.einsum("bild,bjld->blij", x, k) * d ** -0.5
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    if not attend_self:
        sim = sim.masked_fill(eye, -5e-4)
    if mask is not None:
        sim = sim.masked_fill(mask.bool(), -torch.finfo(torch.float32).max)
    p = torch.softmax(sim, dim=-1)
    out = torch.einsum("blij,bjld->bild", p, x)
    delta = (gd * out).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (torch.einsum("bild,bjld->blij", gd, x) - delta)
    if not attend_self:
        ds = ds.masked_fill(eye, 0.0)
    dk = torch.einsum("blij,bild->bjld", ds, x) * d ** -0.5
    dkv = plain_cons.l2_normalize_vjp(x, dk) + torch.einsum("blij,bild->bjld", p, gd)
    return dkv, torch.einsum("blij,bjld->bild", ds, k) * d ** -0.5


def consensus_bwd_case(levels, g, dtype, label, *, attend_self=False, mask=None, exact=False):
    """K6 (dKV, storing the dS' it hands K7), K7 (dQ, a product of that dS'
    and the levels) and the pair as consensus_backward runs them, against
    their plain versions; three rows.  K6's key term, which its output adds
    to the larger value term, is also held on its own, and dS' against the
    plain dS'.  The library time is SDPA's backward (dQ, dK, dV) on the
    attend_self=True case, the one variant SDPA computes exactly: the work
    of the pair.  ``exact``: also K6's and K7's error against float64,
    beside the float32 plain versions'."""
    kw = dict(attend_self=attend_self, non_local_mask=mask)
    with torch.no_grad():
        out, lse = consensus_kernel.consensus_attention(levels, **kw)
    delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1).unsqueeze(-1).contiguous()
    b, n, L, d = levels.shape
    item = levels.element_size()
    unit = 2.0 * b * L * n * n * d                 # one (n, n, d) product a (b, l) pair
    side = 8 * b * L * n + (n * n if mask is not None else 0)   # lse, delta, the mask
    ds_bytes = 4 * b * L * n * (-(-n // 32) * 32)
    library = library_note = None
    if attend_self and mask is None:
        q = levels.transpose(1, 2).detach().requires_grad_(True)
        k = l2_normalize(levels.float()).to(dtype).transpose(1, 2).detach().requires_grad_(True)
        v = levels.transpose(1, 2).detach().requires_grad_(True)
        try:
            o = F.scaled_dot_product_attention(q, k, v)
            go = g.transpose(1, 2)
            library = time_ms(lambda: torch.autograd.grad(o, (q, k, v), go, retain_graph=True))
        except RuntimeError as e:   # no SDPA backend takes this width
            library_note = f"none: {e}"
        del q, k, v
    dkv_call = lambda: consensus_kernel.consensus_dkv(levels, g, lse, delta, keep_ds=True, **kw)
    got_dkv, ds = dkv_call()
    dq_call = lambda: consensus_kernel.consensus_dq(levels, g, lse, delta, ds=ds, **kw)
    pair_call = lambda: consensus_kernel.consensus_dq(levels, g, lse, delta, ds=dkv_call()[1],
                                                      **kw)
    got_dq = dq_call()
    key_term, _ = plain_cons.consensus_dkv_terms(levels.float(), g.float(), lse, delta, **kw)
    want_dkv = plain_cons.consensus_dkv(levels.float(), g.float(), lse, delta, **kw)
    want_dq = plain_cons.consensus_dq(levels.float(), g.float(), lse, delta, **kw)
    torch.cuda.synchronize()
    common = {"case": label, "dtype": str(dtype).replace("torch.", ""),
              "shape": list(levels.shape)}
    k6 = {"kernel": "consensus_dkv", **common,
          **compare(got_dkv, want_dkv, dtype, f"consensus_dkv {label}", part=key_term)}
    k7 = {"kernel": "consensus_dq", **common,
          **compare(got_dq, want_dq, dtype, f"consensus_dq {label}")}
    want_ds = plain_cons.consensus_ds(levels.float(), g.float(), lse, delta, **kw)
    k6["ds_norm_rel_err"] = compare(ds, want_ds, torch.float32,
                                    f"consensus_dkv {label} dS'")["norm_rel_err"]
    k6["ds_bytes"] = ds_bytes
    del want_ds
    k6["bitwise_repeat"] = torch.equal(got_dkv, dkv_call()[0])
    k7["bitwise_repeat"] = torch.equal(got_dq, dq_call())
    if not (k6["bitwise_repeat"] and k7["bitwise_repeat"]):
        raise AssertionError(f"consensus backward {label}: two calls differ")
    if exact:
        dkv64, dq64 = consensus_bwd_f64(levels, g, attend_self, mask)
        k6["vs_f64"] = {"kernel": error_vs([got_dkv], [dkv64], dtype),
                        "plain_f32": error_vs([want_dkv], [dkv64], dtype)}
        k7["vs_f64"] = {"kernel": error_vs([got_dq], [dq64], dtype),
                        "plain_f32": error_vs([want_dq], [dq64], dtype)}
        del dkv64, dq64
    del key_term, want_dkv, want_dq
    k6.update({"kernel_ms": time_ms(dkv_call),
               "plain_ms": time_ms(lambda: plain_cons.consensus_dkv(levels, g, lse, delta, **kw)),
               "library_ms": library, "work_units": 4,
               **bounds(4 * unit, 3 * item * b * n * L * d + side + ds_bytes, dtype)})
    k7.update({"kernel_ms": time_ms(dq_call),
               "plain_ms": time_ms(lambda: plain_cons.consensus_dq_from_ds(levels, ds)),
               "library_ms": library, "work_units": 1,
               **bounds(unit, 2 * item * b * n * L * d + ds_bytes, dtype)})
    pair = {"kernel": "consensus_dkv+consensus_dq", **common, "kernel_ms": time_ms(pair_call),
            "k6_ms": k6["kernel_ms"], "k7_ms": k7["kernel_ms"], "library_ms": library,
            "work": "5 units, what dQ, dK and dV need (the TPU kernels do 7)",
            **bounds(5 * unit, 4 * item * b * n * L * d + side, dtype)}
    for row in (k6, k7, pair):
        if library is not None:
            row["library"] = ("backward of torch.nn.functional.scaled_dot_product_attention "
                              "(dQ, dK, dV)")
        elif library_note is not None:
            row["library"] = library_note
    return [k6, k7, pair]


def k6_rows(levels, g, big, g_big, mask, dtype, *, b1=True):
    """K6, K7 and the pair (consensus_bwd_case) in ``dtype``: b=8 (in
    float32 also against float64), attend_self (with SDPA's backward),
    the locality mask, n=2304 at b=1, and b=1."""
    rows = consensus_bwd_case(levels, g, dtype, "attend_self=False",
                              exact=dtype == torch.float32)
    rows += consensus_bwd_case(levels, g, dtype, "attend_self=True", attend_self=True)
    rows += consensus_bwd_case(levels, g, dtype, "local_consensus_radius=2", mask=mask)
    rows += consensus_bwd_case(big, g_big, dtype, "n=2304 (384/8), b=1")
    if b1:
        rows += consensus_bwd_case(levels[:1], g[:1].contiguous(), dtype, "b=1")
    return rows


def fused_update_f64(bu, td, levels, bottom, pos, mask=None, attend_self=False):
    """The level update computed in float64 on the same inputs: the exact
    value against which K8 and its float32 plain version are both
    measured."""
    def ff(p, x):
        p = {k: v.double() for k, v in p.items()}
        pre = torch.einsum("bngd,gdh->bngh", x, p["w1"]) + p["b1"]
        hid = 0.5 * pre * (1.0 + torch.erf(pre * 2.0 ** -0.5))
        return torch.einsum("bngh,ghd->bngd", hid, p["w2"]) + p["b2"]

    lv = levels.double()
    b, n, L, d = lv.shape
    lwi = torch.cat([bottom.double(), lv], dim=-2)
    terms = ff(bu, lwi[..., :-1, :]) + F.pad(ff(td, lwi[..., 2:, :] + pos.double()), (0, 0, 0, 1))
    del lwi
    keys = lv / lv.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    sim = torch.einsum("bild,bjld->blij", lv, keys) * d ** -0.5
    if not attend_self:
        sim = sim.masked_fill(torch.eye(n, dtype=torch.bool, device=lv.device), -5e-4)
    if mask is not None:
        sim = sim.masked_fill(mask.bool(), -torch.finfo(torch.float32).max)
    cons = torch.einsum("blij,bjld->bild", torch.softmax(sim, -1), lv)
    return (lv + terms + cons) / fused_kernel.update_divisors(L, torch.float64, lv.device)


def k1_k4_update(both, levels, bottom, pos, mask=None, attend_self=False):
    """The update through K1 over both nets' 2L-1 groups in one call (the
    fuse_ff call, ``both``: the two nets' weights concatenated outside the
    timing), K4, and the elementwise tail (cat, pos add, pad, sum, divide):
    the yardstick of K8's design on the same inputs."""
    L = levels.shape[2]
    lwi = torch.cat([bottom, levels], dim=-2)
    y = ff_kernel.grouped_ff(both, torch.cat([lwi[..., :-1, :], lwi[..., 2:, :] + pos], dim=-2))
    cons, _ = consensus_kernel.consensus_attention(levels, attend_self=attend_self,
                                                   non_local_mask=mask)
    td = F.pad(y[..., L:, :], (0, 0, 0, 1))
    return (levels + y[..., :L, :] + td + cons) / fused_kernel.update_divisors(
        L, levels.dtype, levels.device)


def fused_case(params, levels, bottom, dtype, label, *, attend_self=False, mask=None,
               timings=True, exact=False):
    """K8 against its plain version (plain_update: the unfused composition in
    float32 on the same inputs, rounded once to their type); with
    ``timings`` also the plain version's time and two yardsticks on the same
    inputs: the kernels K8 replaces, the unfused composition through K1
    (bottom-up), K1 (top-down), K4 and the elementwise tail
    (``unfused_kernels_ms``), and K1 over both nets' 11 groups in one call,
    K4 and the tail (``k1_g11_k4_ms``).  No single PyTorch call computes a
    whole level update, so library_ms is null.  ``exact``: also the error of
    K8 and of its float32 plain version against float64, K8's held within
    compare()'s limits."""
    bu, td = params["bottom_up"], params["top_down"]
    pos = params["pos_emb"][None, :, None, :]
    kw = dict(attend_self=attend_self, non_local_mask=mask)
    out = fused_kernel.fused_level_update(bu, td, levels, bottom, pos, **kw)
    ref = fused_kernel.plain_update(bu, td, levels, bottom, pos, mask, attend_self=attend_self)
    torch.cuda.synchronize()
    err = compare(out, ref, dtype, f"fused_level_update {label}")
    b, n, L, d = levels.shape
    h = bu["w1"].shape[-1]
    item = levels.element_size()
    flops = 4.0 * b * n * d * h * (2 * L - 1) + 4.0 * b * L * n * n * d
    weights = (2 * L - 1) * (2 * d * h + h + d)
    nbytes = item * (2 * b * n * L * d + b * n * d + n * d + weights) + (
        n * n if mask is not None else 0)
    row = {"case": label, "dtype": str(dtype).replace("torch.", ""), "shape": list(levels.shape),
           "splits": fused_kernel.planned_splits(levels.device, b, n, L, d, h, dtype),
           "key_splits": consensus_kernel.planned_splits(levels.device, b, n, L, d, dtype),
           **err, "bitwise_repeat": torch.equal(
               out, fused_kernel.fused_level_update(bu, td, levels, bottom, pos, **kw)),
           "kernel_ms": time_ms(
               lambda: fused_kernel.fused_level_update(bu, td, levels, bottom, pos, **kw)),
           "plain_ms": None, "unfused_kernels_ms": None, "k1_g11_k4_ms": None, "library_ms": None,
           **bounds(flops, nbytes, dtype)}
    if not row["bitwise_repeat"]:
        raise AssertionError(f"fused_level_update {label}: two calls differ")
    if exact:
        want64 = fused_update_f64(bu, td, levels, bottom, pos, mask, attend_self)
        row["vs_f64"] = {"kernel": error_vs([out], [want64], dtype),
                         "plain_f32": error_vs([ref], [want64], dtype)}
        vs = row["vs_f64"]["kernel"]
        if not (vs["norm_rel_err"] <= RTOL[dtype] and vs["limit_share"] <= 1.0):
            raise AssertionError(f"fused_level_update {label}: off the float64 values by {vs}")
        del want64
    del out, ref
    if timings:
        both = {k: torch.cat([bu[k], td[k]]) for k in ("w1", "b1", "w2", "b2")}
        row["plain_ms"] = time_ms(lambda: fused_kernel.plain_update(
            bu, td, levels, bottom, pos, mask, attend_self=attend_self))
        row["unfused_kernels_ms"] = time_ms(lambda: fused_kernel.reference_update(
            bu, td, levels, bottom, pos, mask, attend_self=attend_self,
            ff_fn=ff_kernel.grouped_ff, consensus_fn=consensus_kernel.consensus_attention))
        row["k1_g11_k4_ms"] = time_ms(lambda: k1_k4_update(both, levels, bottom, pos, mask,
                                                           attend_self))
    return row


def k8_rows(cast, x, mask, dtype):
    """K8's rows in ``dtype`` on views of the (b, n, L+1, d) state ``x``: b=8
    (in float32 also against float64), b=1, then b=8 with attend_self and
    with the locality mask (checked, and timed without the yardsticks)."""
    with torch.inference_mode():
        return [fused_case(cast, x[..., 1:, :], x[..., :1, :], dtype, "b=8",
                           exact=dtype == torch.float32),
                fused_case(cast, x[:1, :, 1:, :], x[:1, :, :1, :], dtype, "b=1"),
                fused_case(cast, x[..., 1:, :], x[..., :1, :], dtype, "b=8, attend_self=True",
                           attend_self=True, timings=False),
                fused_case(cast, x[..., 1:, :], x[..., :1, :], dtype,
                           "b=8, local_consensus_radius=2", mask=mask, timings=False)]


K8_NOTE = ("no single PyTorch call computes a whole level update; unfused_kernels_ms is K1 + "
           "K1 + K4 and the elementwise tail on the same inputs, k1_g11_k4_ms K1 over both "
           "nets' 11 groups in one call, K4 and the tail")
# K8's stages, all launched by its C entry glom_fused_update
K8_STAGES = ("td_input_kernel (levels[l+1] + pos in f32)",
             "hidden_kernel (K8a: both nets' hidden, 2L-1 groups)",
             "consensus_kernel<T, D, float> (K4's kernel, f32 output)",
             "update_kernel (K8b: both nets' second layer and the update)",
             "update_reduce_kernel (K8b's splits, where it splits)")


def flagship_inputs(device):
    """The kernels phase's seeded weights and inputs at the flagship shapes:
    ``(params, lwi (b, n, L+1, d), levels, big (1, 2304, L, d), mask, g_ff,
    g_lv, g_big)``."""
    gen = torch.Generator().manual_seed(0)
    c = FLAGSHIP
    n, L, d = c.num_patches, c.levels, c.dim
    params = glom_model.init(gen, c, device)
    lwi = torch.randn((BATCH, n, L + 1, d), generator=gen).to(device)
    levels = torch.randn((BATCH, n, L, d), generator=gen).to(device)
    big = torch.randn((1, 2304, L, d), generator=gen).to(device)   # 384/8
    mask = glom_model.resolve_locality_mask(
        GlomConfig(dim=d, levels=L, image_size=224, patch_size=14,
                   local_consensus_radius=2), device)
    g_ff = torch.randn((BATCH, n, L, d), generator=gen).to(device)
    g_lv = torch.randn((BATCH, n, L, d), generator=gen).to(device)
    g_big = torch.randn((1, 2304, L, d), generator=gen).to(device)
    return params, lwi, levels, big, mask, g_ff, g_lv, g_big


def ff_bwd_inputs(cast, x, g):
    """The grouped-FF backward's cases: ``(label, params, x, dO)`` for the
    main path's two calls (the bottom-up strided view, g=6, and the top-down
    input, g=5), then b=1 (256 rows) and 49 rows (off a 32-row tile), both
    as strided views."""
    pos = cast["pos_emb"][None, :, None, :]
    bu, td = cast["bottom_up"], cast["top_down"]
    return (("bottom_up (strided view, g=6)", bu, x[..., :-1, :], g),
            ("top_down (g=5)", td, (x[..., 2:, :] + pos).contiguous(), g[..., 1:, :].contiguous()),
            ("bottom_up b=1 (strided view, g=6)", bu, x[:1, :, :-1, :], g[:1]),
            ("bottom_up 49 rows (strided view, g=6)", bu, x[:1, :49, :-1, :],
             g[:1, :49].contiguous()))


def k2_rows(cast, x, g, dtype):
    """K2's rows in ``dtype``, one a case of ff_bwd_inputs."""
    return [k2_case(p, xx, gg, dtype, label)[0] for label, p, xx, gg in ff_bwd_inputs(cast, x, g)]


def k3_rows(cast, x, g, dtype, cases=4):
    """The first ``cases`` of ff_bwd_inputs in ``dtype``: for each, K2 (the
    hidden it hands K3), K3 and the pair; three rows a case."""
    rows = []
    for label, p, xx, gg in ff_bwd_inputs(cast, x, g)[:cases]:
        k2, hidden = k2_case(p, xx, gg, dtype, label)
        k3 = k3_case(p, xx, gg, hidden, dtype, label, k2["kernel_ms"])
        del hidden
        rows += [k2, k3, pair_case(p, xx, gg, dtype, label, k2["kernel_ms"], k3["kernel_ms"])]
    return rows


def phase_only(device, name: str) -> None:
    """``--only k1`` (K1's rows), ``--only k2`` (K2's), ``--only k3`` (K3's:
    K2, K3 and the pair a case), ``--only k6`` (K6's: K6, K7 and the pair a
    case) or ``--only k8`` (K8's) in float32 and
    bfloat16, for timing a kernel or a variant of it without the rest of the
    kernels phase."""
    params, lwi, levels, big, mask, g_ff, g_lv, g_big = flagship_inputs(device)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        cast = glom_model.tree_map(lambda p: p.to(dtype), params)
        if name == "k6":
            rows += k6_rows(levels.to(dtype), g_lv.to(dtype), big.to(dtype), g_big.to(dtype),
                            mask, dtype)
        elif name == "k1":
            rows += k1_rows(cast, lwi.to(dtype), dtype)
        elif name == "k8":
            rows += k8_rows(cast, lwi.to(dtype), mask, dtype)
        else:
            fn = k2_rows if name == "k2" else k3_rows
            rows += fn(cast, lwi.to(dtype), g_ff.to(dtype), dtype)
    kernel = {"k1": "grouped_ff", "k2": "grouped_ff_dx", "k3": "grouped_ff_dw",
              "k6": "consensus_dkv+consensus_dq", "k8": "fused_level_update"}[name]
    extra = {"stages": K8_STAGES, "library_note": K8_NOTE} if name == "k8" else {}
    emit({"phase": name, "kernel": kernel, **extra, "rows": rows})


def phase_kernels(device) -> dict:
    params, lwi, levels, big, mask, g_ff, g_lv, g_big = flagship_inputs(device)
    ff_rows, cons_rows, bwd_rows, fused_rows = [], [], [], []
    ff_kernel.grouped_ff.launches = 0
    consensus_kernel.consensus_attention.launches = 0
    for dtype in (torch.float32, torch.bfloat16):
        cast = glom_model.tree_map(lambda p: p.to(dtype), params)
        x = lwi.to(dtype)
        ff_rows += k1_rows(cast, x, dtype)
        lv = levels.to(dtype)
        cons_rows.append(consensus_case(lv, dtype, "attend_self=False"))
        cons_rows.append(consensus_case(lv, dtype, "attend_self=True", attend_self=True))
        cons_rows.append(consensus_case(lv, dtype, "local_consensus_radius=2", mask=mask))
        cons_rows.append(consensus_case(big.to(dtype), dtype, "n=2304 (384/8), b=1", library=True))
        cons_rows.append(consensus_case(lv[:1], dtype, "b=1"))
        g = g_ff.to(dtype)
        # K2, K3 and the pair on the main path's two calls, then K2 at b=1 and 49 rows
        bwd_rows += k3_rows(cast, x, g, dtype, cases=2)
        bwd_rows += [k2_case(p, xx, gg, dtype, label)[0]
                     for label, p, xx, gg in ff_bwd_inputs(cast, x, g)[2:]]
        bwd_rows += k6_rows(lv, g_lv.to(dtype), big.to(dtype), g_big.to(dtype), mask, dtype,
                            b1=False)
        # K8 reads levels and the tokens as views of one (b, n, L+1, d) state
        fused_rows += k8_rows(cast, x, mask, dtype)
    # launches of this phase: one checked call and 3 + REPS * INNER timed ones a row
    emit({"phase": "kernels", "kernel": "grouped_ff",
          "launches": ff_kernel.grouped_ff.launches, "rows": ff_rows})
    emit({"phase": "kernels", "kernel": "consensus_attention",
          "launches": consensus_kernel.consensus_attention.launches, "rows": cons_rows})
    for name in BACKWARD + PAIRS:
        emit({"phase": "kernels", "kernel": name, "rows": [
            {k: v for k, v in r.items() if k != "kernel"} for r in bwd_rows if r["kernel"] == name]})
    emit({"phase": "kernels", "kernel": "fused_level_update", "stages": K8_STAGES,
          "rows": fused_rows, "library_note": K8_NOTE})
    # the main path's case, float32; SDPA computes only the attend_self=True
    # variant exactly, so consensus's library times come from that row (same
    # shapes and work)
    main = {"grouped_ff": ff_rows[0], "consensus_attention": cons_rows[0],
            "fused_level_update": fused_rows[0], "consensus_blocked": cons_rows[3]}
    library = {"grouped_ff": None, "consensus_attention": cons_rows[1]["library_ms"],
               "fused_level_update": None}
    for name in BACKWARD + PAIRS:
        rows = [r for r in bwd_rows if r["kernel"] == name]
        main[name] = rows[0]
        library[name] = next((r.get("library_ms") for r in rows
                              if r.get("library_ms") is not None), None)
    # the same kernels at widths off their multiples (the wrappers pad)
    return main, library, narrow_kernel_rows(device)


BACKWARD = ("grouped_ff_dx", "grouped_ff_dw", "consensus_dkv", "consensus_dq")
# the backward pairs as the step runs them: K2 handing K3 the hidden, K6
# handing K7 its dS'
PAIRS = ("grouped_ff_dx+grouped_ff_dw", "consensus_dkv+consensus_dq")


def post(url: str, payload: dict, headers=None):
    """POST ``payload``; returns ``(json body, response headers)``."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read()), resp.headers


def get(url: str, raw: bool = False):
    with urllib.request.urlopen(url, timeout=60) as resp:
        body = resp.read()
    return body.decode() if raw else json.loads(body)


# glom_tpu's span names of one request's trace (glom_tpu/obs/tracing.py)
REQUEST_SPANS = {"request", "parse", "queue_wait", "batch_assembly", "bucket_select", "pad",
                 "execute", "respond"}
GRAPH_BUCKETS = (1, 2, 4, 8)


def graph_report(engine, c, seed: int) -> dict:
    """Every (family, bucket) of ``engine``'s forwards (/embed, /reconstruct
    and the index forward /parse and /similar run) served from its captured graph
    against the eager forward of the same engine and weights on the same
    padded inputs: bitwise equal, as the same kernels run in the same order.
    Then the b=1, 4 and 8 /embed forward, eager against replayed (host clock
    to the answer on the host, the median of 5 after a warm-up), the start-up
    capture seconds and the graph pools' bytes."""
    rng = np.random.default_rng(seed)
    shape = (c.channels, c.image_size, c.image_size)
    # the forward families (/parse's pack is held by the parse phase)
    checked = ("embed", "reconstruct", "index")
    for endpoint in checked:
        for b in GRAPH_BUCKETS:
            x = rng.standard_normal((b,) + shape).astype(np.float32)
            replayed, eager = engine.run(endpoint, x), engine.run_eager(endpoint, x)
            if not np.array_equal(replayed, eager):
                raise AssertionError(
                    f"{endpoint} b={b}: the replayed graph differs from the eager forward by "
                    f"{float(np.abs(replayed - eager).max())}")
    forward_ms = {}
    for b in (1, 4, 8):
        x = rng.standard_normal((b,) + shape).astype(np.float32)
        forward_ms[f"b{b}"] = {"eager": served_ms(lambda: engine.run_eager("embed", x)),
                               "replayed": served_ms(lambda: engine.run("embed", x))}
    caches = engine.caches
    return {"bitwise_equal": {ep: list(GRAPH_BUCKETS) for ep in checked},
            "embed_forward_ms": forward_ms,
            "capture_seconds": {ep: cache.warmup_seconds for ep, cache in caches.items()},
            "warmup_seconds": engine.registry.snapshot().get("serving_warmup_seconds"),
            "pool_bytes": engine.graph_pool_bytes(),
            "launches_per_replay": {ep: cache.launches_per_replay()
                                    for ep, cache in caches.items()}}


def served_ms(fn) -> float:
    """Host clock per call of ``fn`` (a forward to its answer on the host):
    the median of 5 after a warm-up."""
    times = []
    for _ in range(6):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def sampled_batches(engine, batches: int) -> int:
    """How many of ``batches`` primary batches the quality sampler took: all
    of them at the default quality_sample=1.0 (checked), each one replay of
    the ``quality`` family after its answers were out."""
    summary = engine.quality.summary()
    if summary["sample_fraction"] == 1.0 and not (
            summary["decided"] == summary["sampled"] == batches):
        raise AssertionError(f"quality sampling: {summary['decided']} decided, "
                             f"{summary['sampled']} sampled of {batches} batches")
    return summary["sampled"]


def wait_quality(engine, observed: int, timeout_s: float = 120.0) -> None:
    """Until the quality plane has observed ``observed`` requests: the
    post-pass of a sampled batch runs on the endpoint's worker after the
    batch's answers are out.  A post-pass that fails fails the phase."""
    deadline = time.monotonic() + timeout_s
    while engine.quality.observed < observed:
        failures = engine.registry.snapshot().get("quality_post_pass_failures")
        if failures or time.monotonic() > deadline:
            raise AssertionError(f"quality post-pass: {engine.quality.observed} of {observed} "
                                 f"observed, {failures} failed")
        time.sleep(0.002)


def phase_serve(device) -> dict:
    c = FLAGSHIP
    ckpt = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    make_demo_checkpoint(ckpt, config=c, seed=0)
    engine = ServingEngine(ckpt, device=device, ff_impl="pallas", attention_impl="pallas")
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    shape = (c.channels, c.image_size, c.image_size)
    imgs = {k: rng.standard_normal((k,) + shape).astype(np.float32) for k in (1, 2, 3, 8)}
    plan = (("embed", 1), ("embed", 3), ("embed", 8), ("reconstruct", 2))
    ff_kernel.grouped_ff.launches = 0
    consensus_kernel.consensus_attention.launches = 0
    health, requests, outs, served = serve_requests(engine, plan, imgs)
    launches = {"grouped_ff": ff_kernel.grouped_ff.launches,
                "consensus_attention": consensus_kernel.consensus_attention.launches}
    assert health["ff_impl"] == "pallas" and health["attention_impl"] == "pallas", health

    # every request was a replay; each counts its graph's launches, and each
    # request's batch was sampled (the default quality_sample=1.0) and
    # replayed the quality family after its answer
    iters, t = engine.embed_iters, engine.reconstruct_timestep
    sampled, q_it = sampled_batches(engine, len(plan)), engine._program.quality_iters
    expected = {"grouped_ff": 3 * 2 * iters + 2 * t + sampled * 2 * q_it,
                "consensus_attention": 3 * iters + t + sampled * q_it}
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")

    # one /embed answer against the plain path (dense ops) on the card
    plain_cfg = GlomConfig(**{**engine.config.to_json_dict(),
                              "ff_impl": "dense", "attention_impl": "dense"})
    with torch.inference_mode():
        x = torch.from_numpy(imgs[3]).to(device)
        plain = glom_model.apply(engine.params["glom"], x, config=plain_cfg,
                                 iters=iters).mean(dim=1).cpu().numpy()
    embed_err = float(np.abs(outs[("embed", 3)] - plain).max())
    if not embed_err <= SERVE_ATOL:
        raise AssertionError(f"/embed differs from the plain path by {embed_err} > {SERVE_ATOL}")

    x8 = torch.from_numpy(imgs[8]).to(device)
    embed_b8_ms = {"kernels": embed_forward_ms(engine, x8, engine.config),
                   "plain": embed_forward_ms(engine, x8, plain_cfg)}
    emit({"phase": "serve", "config": {"dim": c.dim, "levels": c.levels,
                                       "image_size": c.image_size, "patch_size": c.patch_size,
                                       "iters": iters, "reconstruct_timestep": t},
          "setup_seconds": setup_s, "requests": requests,
          "buckets_run": {"embed": [1, 4, 8], "reconstruct": [2]},
          "launches": launches,
          "launches_per_bucket": {"embed": {"grouped_ff": 2 * iters, "consensus_attention": iters},
                                  "reconstruct": {"grouped_ff": 2 * t, "consensus_attention": t},
                                  "quality": {"grouped_ff": 2 * q_it,
                                              "consensus_attention": q_it}},
          "quality_sampled_batches": sampled,
          "embed_vs_plain_max_abs_err": embed_err, "embed_atol": SERVE_ATOL,
          "embed_b8_forward_ms": embed_b8_ms, **served,
          "graphs": graph_report(engine, c, seed=10)})
    phase_profile(lambda: glom_model.apply(engine.params["glom"], x8, config=engine.config,
                                           iters=iters).mean(dim=1).cpu())
    return launches


def phase_profile(forward, runs: int = 3, *, phase: str = "profile", grad: bool = False) -> None:
    """A torch.profiler trace of ``runs`` calls of ``forward`` (b=8 /embed
    forwards, or with ``grad`` train steps) through the kernels: the
    device's busy share of the window (the sum of kernel times on the one
    stream over the host-clock window, which the profiler itself lengthens)
    and device time by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(not grad):
        forward()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(runs):
                forward()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # the kernels themselves, not the host-side ops that launched them
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = sorted(kernels, key=device_us, reverse=True)
    busy_ms = sum(device_us(e) for e in rows) / 1e3
    emit({"phase": phase, "runs": runs, "window_ms": window_ms, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / window_ms,
          "by_name": [{"name": e.key[:80], "count": e.count, "device_ms": device_us(e) / 1e3}
                      for e in rows[:16]]})


def serve_requests(engine, plan, imgs):
    """Run ``engine`` behind the HTTP server on a free port, read /healthz,
    and post ``imgs[k]`` to each ``(endpoint, k)`` of ``plan``, each with an
    ``X-Request-Id``.  Every answer must have the endpoint's shape, be finite
    and echo its request id (header and body).  Then /metrics must show no
    graph captured on the request path, and the first request's trace in
    /debug/traces must hold every span of ``REQUEST_SPANS``.  Returns
    ``(health, one record a request, {(endpoint, k): answer}, what the
    metrics and the trace showed)`` and leaves nothing running."""
    c = engine.config
    engine.start()
    server = make_server(engine, port=0)
    thread = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05})
    thread.start()
    try:
        base = "http://127.0.0.1:%d" % server.server_address[1]
        health = get(base + "/healthz")
        requests, outs = [], {}
        for i, (endpoint, k) in enumerate(plan):
            rid = f"chip-smoke-{endpoint}-{k}-{i}"
            t = time.perf_counter()
            reply, headers = post(f"{base}/{endpoint}", {"images": imgs[k].tolist()},
                                  {"X-Request-Id": rid})
            wall_ms = (time.perf_counter() - t) * 1e3
            if headers.get("X-Request-Id") != rid or reply.get("request_id") != rid:
                raise AssertionError(f"request id {rid} not echoed: header "
                                     f"{headers.get('X-Request-Id')}, body {reply.get('request_id')}")
            out = np.asarray(reply["embeddings" if endpoint == "embed" else "images"], np.float32)
            want = ((k, c.levels, c.dim) if endpoint == "embed"
                    else (k, c.channels, c.image_size, c.image_size))
            assert out.shape == want, (endpoint, out.shape, want)
            assert np.isfinite(out).all(), f"{endpoint} k={k}: non-finite output"
            outs[(endpoint, k)] = out
            requests.append({"endpoint": endpoint, "k": k, "shape": list(out.shape),
                             "step": reply["step"], "server_latency_ms": reply["latency_ms"],
                             "client_wall_ms": wall_ms})
        metrics = get(base + "/metrics", raw=True)
        captures = metric_value(metrics, "glom_serving_graph_captures_total")
        if captures:
            raise AssertionError(f"{captures} graph captures on the request path after warm-up")
        first = f"chip-smoke-{plan[0][0]}-{plan[0][1]}-0"
        spans = trace_spans(base, first)
        if not REQUEST_SPANS <= spans:
            raise AssertionError(f"trace {first}: spans {sorted(spans)} lack "
                                 f"{sorted(REQUEST_SPANS - spans)}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        engine.shutdown(drain=True)
    return health, requests, outs, {"graph_captures_after_warmup": captures or 0,
                                    "trace": {"request_id": first, "spans": sorted(spans)}}


def metric_value(text: str, name: str):
    """The value of sample ``name`` in a Prometheus text body, or None."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return None


def trace_spans(base: str, trace_id: str, timeout_s: float = 10.0) -> set:
    """The span names of ``trace_id``'s completed record in /debug/traces,
    polled until it lands (the root span ends after the reply is written)."""
    deadline = time.monotonic() + timeout_s
    while True:
        for rec in get(base + "/debug/traces?since=0")["traces"]:
            if rec["trace_id"] == trace_id:
                return {s["name"] for s in rec["spans"]}
        if time.monotonic() > deadline:
            raise AssertionError(f"trace {trace_id} never reached /debug/traces")
        time.sleep(0.05)


def embed_forward_ms(engine, x8, cfg) -> float:
    """One b=8 /embed forward of ``engine``'s weights under ``cfg`` (12
    iterations), eager, host clock to the result on the host (``served_ms``)."""
    with torch.inference_mode():
        return served_ms(lambda: glom_model.apply(engine.params["glom"], x8, config=cfg,
                                                  iters=engine.embed_iters).mean(dim=1).cpu())


def phase_serve_fused(device) -> dict:
    """The flagship demo checkpoint served with ff_impl="fused": every
    iteration one launch of K8, none of K1 or K4 (the main path of this
    phase: counts set to 0 just before the requests, read just after)."""
    c = FLAGSHIP
    ckpt = os.path.join(ROOT, "build", "chip_smoke_ckpt")   # phase_serve wrote it
    if ckpt_lib.latest_step(ckpt) is None:   # run alone (--only serve_fused)
        make_demo_checkpoint(ckpt, config=c, seed=0)
    engine = ServingEngine(ckpt, device=device, ff_impl="fused", attention_impl="pallas")
    rng = np.random.default_rng(2)
    shape = (c.channels, c.image_size, c.image_size)
    imgs = {k: rng.standard_normal((k,) + shape).astype(np.float32) for k in (1, 2, 8)}
    plan = (("embed", 1), ("embed", 8), ("reconstruct", 2))
    reset_launches()
    health, requests, outs, served = serve_requests(engine, plan, imgs)
    launches = launch_counts()
    iters, t = engine.embed_iters, engine.reconstruct_timestep
    sampled, q_it = sampled_batches(engine, len(plan)), engine._program.quality_iters
    want = {k: 0 for k in launches}
    want["fused_level_update"] = 2 * iters + t + sampled * q_it
    if launches != want:
        raise AssertionError(f"fused serving launches {launches}, expected {want}")
    assert health["ff_impl"] == "fused", health

    # the k=8 /embed answer against the plain path and the "pallas" engine's
    plain_cfg = GlomConfig(**{**engine.config.to_json_dict(),
                              "ff_impl": "dense", "attention_impl": "dense"})
    pallas_engine = ServingEngine(ckpt, device=device, ff_impl="pallas", attention_impl="pallas",
                                  warmup=False)
    x8 = torch.from_numpy(imgs[8]).to(device)
    with torch.inference_mode():
        plain = glom_model.apply(engine.params["glom"], x8, config=plain_cfg,
                                 iters=iters).mean(dim=1).cpu().numpy()
    err_plain = float(np.abs(outs[("embed", 8)] - plain).max())
    err_pallas = float(np.abs(outs[("embed", 8)] - pallas_engine.run_eager("embed", imgs[8])).max())
    recon_err = float(np.abs(outs[("reconstruct", 2)]
                             - pallas_engine.run_eager("reconstruct", imgs[2])).max())
    if not max(err_plain, err_pallas, recon_err) <= SERVE_ATOL:
        raise AssertionError(f"fused serving differs: plain {err_plain}, pallas engine "
                             f"{err_pallas}, reconstruct {recon_err} > {SERVE_ATOL}")

    emit({"phase": "serve_fused", "config": {"dim": c.dim, "levels": c.levels,
                                             "image_size": c.image_size,
                                             "patch_size": c.patch_size, "iters": iters,
                                             "reconstruct_timestep": t, "ff_impl": "fused"},
          "requests": requests, "launches": launches, **served,
          "launches_per_forward": {"embed": {"fused_level_update": iters, "grouped_ff": 0,
                                             "consensus_attention": 0},
                                   "reconstruct": {"fused_level_update": t},
                                   "quality": {"fused_level_update": q_it}},
          "quality_sampled_batches": sampled,
          "embed_vs_plain_max_abs_err": err_plain, "embed_vs_pallas_engine_max_abs_err": err_pallas,
          "reconstruct_vs_pallas_engine_max_abs_err": recon_err, "atol": SERVE_ATOL,
          "embed_b8_forward_ms": {"fused": embed_forward_ms(engine, x8, engine.config),
                                  "pallas_kernels": embed_forward_ms(engine, x8, pallas_engine.config),
                                  "plain": embed_forward_ms(engine, x8, plain_cfg)},
          "graphs": graph_report(engine, c, seed=11)})
    phase_profile(lambda: glom_model.apply(engine.params["glom"], x8, config=engine.config,
                                           iters=iters).mean(dim=1).cpu(),
                  phase="serve_fused_profile")
    return launches


# serve_load: the closed loop that finds the sustained rate, then the open
# loop at half of it with a hot reload in the middle.  It is a smoke check of
# the load generator and of a reload under load, not a tail measurement: its
# windows answer tens of requests, so the report's p95/p99 are null (the
# loadgen's MIN_TAIL_SAMPLES); PERF.md section 4 defines the longer leg.
LOAD_BATCH_SIZES = tuple(range(1, 9))
LOAD_CONCURRENCY = 8
LOAD_CLOSED_S = 2.0
LOAD_OPEN_S = 6.0
LOAD_RELOAD_AT_S = 2.0
# a second reload may leave allocated memory this far from the first's
RELOAD_MEMORY_MARGIN = 16 * 2 ** 20
LOAD_SPANS = ("request", "parse", "queue_wait", "batch_assembly", "pad", "execute", "respond")


def run_loadgen(base: str, *args) -> dict:
    """``python -m glom_tpu_torch.tools.loadgen`` in a process of its own
    (the server's process keeps its interpreter lock to itself); its
    report.  Exit 1 (a request failed) still reports."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)}
    proc = subprocess.run(
        [sys.executable, "-m", "glom_tpu_torch.tools.loadgen", "--url", base,
         "--batch-sizes", ",".join(map(str, LOAD_BATCH_SIZES)), *map(str, args)],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    if proc.returncode not in (0, 1):
        raise RuntimeError(f"loadgen exited {proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout)


def span_means(before: dict, after: dict) -> dict:
    """Mean milliseconds of each request span between two registry
    snapshots."""
    out = {}
    for span in LOAD_SPANS:
        key = f"serving_{span}_ms"
        n = after.get(key + "_count", 0.0) - before.get(key + "_count", 0.0)
        out[span] = ((after.get(key + "_sum", 0.0) - before.get(key + "_sum", 0.0)) / n
                     if n else None)
    return out


def settled_memory(device) -> dict:
    gc.collect()
    torch.cuda.synchronize(device)
    return {"allocated": torch.cuda.memory_allocated(device),
            "reserved": torch.cuda.memory_reserved(device)}


def phase_serve_load(device) -> dict:
    """The flagship "pallas" engine behind the HTTP server under
    ``glom_tpu_torch/tools/loadgen.py``, run as a process of its own: a
    closed loop (/embed, batch sizes 1-8, concurrency 8, 3 s) for the
    sustained rate, then an open loop at 50 % of its request rate for 8 s,
    during which step 1 of the checkpoint lands and the watcher reloads it.
    No request may fail, /healthz must reach step 1, the answers after the
    swap must equal the eager forward of step 1's weights bit for bit, and
    ``serving_param_reloads`` must be 1.  A second reload, to step 2 with no
    load, must leave allocated memory where the first left it: a reload
    does not leak."""
    c = FLAGSHIP
    ckpt = os.path.join(ROOT, "build", "chip_smoke_load_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    make_demo_checkpoint(ckpt, config=c, seed=0)
    engine = ServingEngine(ckpt, device=device, ff_impl="pallas", attention_impl="pallas",
                           reload_poll_s=0.25)
    engine.start()
    server = make_server(engine, port=0)
    thread = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05})
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    probe = np.random.default_rng(5).standard_normal(
        (3, c.channels, c.image_size, c.image_size)).astype(np.float32)
    try:
        before, _ = post(base + "/embed", {"images": probe.tolist()})
        reset_launches()
        snap0 = engine.registry.snapshot()
        closed = run_loadgen(base, "--concurrency", LOAD_CONCURRENCY,
                             "--duration", LOAD_CLOSED_S)
        snap1 = engine.registry.snapshot()
        rate = 0.5 * closed["throughput_req_per_s"]
        memory = {"before_reload": settled_memory(device),
                  "pool_bytes_step0": engine.graph_pool_bytes()}
        torch.cuda.reset_peak_memory_stats(device)
        step0_set = weakref.ref(engine.serving)
        count0 = engine.request_count

        def land_step_1():
            # LOAD_RELOAD_AT_S into the open loop's traffic (the loadgen
            # builds its bodies before its first request)
            deadline = time.monotonic() + 120
            while engine.request_count == count0 and time.monotonic() < deadline:
                time.sleep(0.05)
            time.sleep(LOAD_RELOAD_AT_S)
            make_demo_checkpoint(ckpt, config=c, seed=1, step=1)

        writer = threading.Thread(target=land_step_1)
        writer.start()
        open_report = run_loadgen(base, "--rate", rate, "--duration", LOAD_OPEN_S)
        writer.join()
        snap2 = engine.registry.snapshot()
        reloaded = poll_step(base, 1)
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated(device)
        after, _ = post(base + "/embed", {"images": probe.tolist()})
        metrics = get(base + "/metrics", raw=True)
        eager = engine.run_eager("embed", probe)
        memory.update({"peak_allocated_during_reload": peak,
                       "after_reload_1": settled_memory(device),
                       "pool_bytes_step1": engine.graph_pool_bytes(),
                       "params_bytes": sum(p.numel() * p.element_size() for p in
                                           glom_model.tree_leaves(engine.params))})
        step1_set = weakref.ref(engine.serving)
        make_demo_checkpoint(ckpt, config=c, seed=2, step=2)
        reloaded_2 = poll_step(base, 2)
        memory["after_reload_2"] = settled_memory(device)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        engine.shutdown(drain=True)
    served = np.asarray(after["embeddings"], np.float32)
    failed = {k: r[k] for r in (closed, open_report)
              for k in ("requests_error", "requests_shed", "request_id_mismatches") if r[k]}
    grown = memory["after_reload_2"]["allocated"] - memory["after_reload_1"]["allocated"]
    checks = {
        "no_failed_request": not failed,
        "healthz_step_1": reloaded == 1 and after["step"] == 1,
        "answer_after_swap_equals_eager_step_1": bool(np.array_equal(served, eager)),
        "answer_changed": not np.array_equal(served, np.asarray(before["embeddings"], np.float32)),
        "step_0_set_freed": step0_set() is None,
        "serving_param_reloads_1": metric_value(metrics, "glom_serving_param_reloads_total") == 1,
        "no_graph_capture_on_request_path":
            not metric_value(metrics, "glom_serving_graph_captures_total"),
        "kernels_launched": launches["grouped_ff"] > 0 and launches["consensus_attention"] > 0,
        "second_reload_step_2": reloaded_2 == 2 and step1_set() is None,
        "second_reload_keeps_allocated_memory": abs(grown) <= RELOAD_MEMORY_MARGIN,
    }
    emit({"phase": "serve_load", "config": {"dim": c.dim, "levels": c.levels, "ff_impl": "pallas",
                                            "endpoint": "embed",
                                            "batch_sizes": list(LOAD_BATCH_SIZES)},
          "closed_loop": closed, "open_loop": open_report, "open_rate_req_per_s": rate,
          "sustained_imgs_per_s": closed["throughput_imgs_per_s"],
          "span_mean_ms": {"closed_loop": span_means(snap0, snap1),
                           "open_loop": span_means(snap1, snap2)},
          "quality_sample": engine.quality.sampler.fraction,
          "reload_at_s": LOAD_RELOAD_AT_S, "launches": launches, "memory": memory,
          "allocated_growth_reload_2": grown, "failed": failed, "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"serve_load: {[k for k, ok in checks.items() if not ok]} failed")
    return launches


def poll_step(base: str, step: int, timeout_s: float = 60.0) -> int:
    """/healthz's step once it reaches ``step`` (or the last one read when
    ``timeout_s`` passes)."""
    deadline = time.monotonic() + timeout_s
    while True:
        got = get(base + "/healthz")["step"]
        if got >= step or time.monotonic() > deadline:
            return got
        time.sleep(0.1)


def fit_run(config, device, img, ckpt=None, steps=TRAIN_STEPS):
    """``Trainer.fit`` for ``steps`` steps on one resident batch, logging
    every step; returns ``(trainer, records)``."""
    import io

    stream = io.StringIO()
    tc = TrainConfig(batch_size=BATCH, steps=steps, log_every=1, seed=0,
                     checkpoint_dir=ckpt, checkpoint_every=steps if ckpt else 0)
    trainer = Trainer(config, tc, device=device, logger=MetricLogger(stream=stream))
    trainer.fit(itertools.repeat(img))
    return trainer, [json.loads(line) for line in stream.getvalue().splitlines()]


def phase_train(device) -> dict:
    """The denoising train step at flagship width, b=8: the kernels' path
    (the main path: counts set to 0 just before Trainer.fit, read just
    after) against the plain path on the card."""
    c = GlomConfig(**{**FLAGSHIP.to_json_dict(), "ff_impl": "pallas", "ff_fused_bwd": True,
                      "attention_impl": "pallas"})
    plain_cfg = GlomConfig(**{**c.to_json_dict(), "ff_impl": "dense", "attention_impl": "dense"})
    gen = torch.Generator().manual_seed(1)
    shape = (BATCH, c.channels, c.image_size, c.image_size)
    img = torch.randn(shape, generator=gen).to(device)
    ckpt = os.path.join(ROOT, "build", "chip_smoke_train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)

    reset_launches()
    kern, kern_log = fit_run(c, device, img, ckpt)
    launches = launch_counts()
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    t = denoise.resolve_loss_timestep(kern.train_cfg, c.default_iters)
    want = {"fused_level_update": 0, "grouped_ff": 2 * t, "grouped_ff_dx": 2 * t,
            "grouped_ff_dw": 2 * t, "consensus_attention": t, "consensus_dkv": t,
            "consensus_dq": t}
    if per_step != want:
        raise AssertionError(f"train-step launches per step {per_step}, expected {want}")
    _, plain_log = fit_run(plain_cfg, device, img)
    # the yardstick, timed and not asserted: K1 forward with the plain
    # (cuBLAS, full float32) VJP behind it instead of K2 + K3
    vjp_cfg = GlomConfig(**{**c.to_json_dict(), "ff_fused_bwd": False})
    _, vjp_log = fit_run(vjp_cfg, device, img)

    losses = [r["loss"] for r in kern_log if "loss" in r]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses not finite and falling: {losses}")

    ms = {"kernels": log_step_ms(kern_log), "plain": log_step_ms(plain_log),
          "kernels_plain_ff_vjp": log_step_ms(vjp_log)}

    # one step's gradients, kernels against the plain path, same params and noise
    params = kern.state.params
    noise = torch.randn(shape, generator=gen).to(device)

    grad = grads_vs_plain(c, kern.train_cfg, params, img, noise)

    # two runs of one step from the same state and noise: the same bits
    step = denoise.make_step_fn(c, kern.train_cfg, kern.optimizer)
    (s1, m1), (s2, m2) = step(kern.state, img, noise=noise), step(kern.state, img, noise=noise)
    bitwise = all(torch.equal(a, b) for a, b in zip(glom_model.tree_leaves(s1.params),
                                                    glom_model.tree_leaves(s2.params)))
    bitwise = bitwise and torch.equal(m1["loss"], m2["loss"])
    if not bitwise:
        raise AssertionError("two runs of one train step differ")
    del s1, s2, m1, m2
    memory = {"kernels": step_memory(step, kern.state, img, noise),
              "plain": step_memory(denoise.make_step_fn(plain_cfg, kern.train_cfg, kern.optimizer),
                                   kern.state, img, noise)}

    emit({"phase": "train", "config": {**{k: c.to_json_dict()[k] for k in (
              "dim", "levels", "image_size", "patch_size", "ff_impl", "ff_fused_bwd",
              "attention_impl")}, "batch": BATCH, "iters": c.default_iters, "loss_timestep": t,
              "optimizer": "adam", "lr": kern.train_cfg.learning_rate},
          "steps": TRAIN_STEPS, "losses": losses,
          "plain_losses": [r["loss"] for r in plain_log if "loss" in r],
          "step_ms": ms, "images_per_s": {k: 1e3 * BATCH / v for k, v in ms.items()},
          "step_ms_note": "median over steps 2..10 of one-step host-clock windows; "
                          "kernels_plain_ff_vjp: ff_fused_bwd=False (K1 forward, the plain "
                          "float32 VJP of the grouped FF), timed only",
          "launches": launches, "launches_per_step": per_step,
          "grad_vs_plain": grad,
          "bitwise_repeat": bitwise, "step_memory": memory,
          "step_memory_note": "torch.cuda.max_memory_allocated over one step (forward, backward, "
                              "Adam) from the trained state; resident: allocated before it"})
    phase_profile(lambda: step(kern.state, img, noise=noise)[1]["loss"].item(), runs=2,
                  phase="train_profile", grad=True)
    serve_trained(ckpt, device, kern)
    return launches, ms


def step_memory(step, state, img, noise) -> dict:
    """One call of ``step`` from ``state``: the peak of device memory
    allocated during it, what was allocated before it, and the difference
    (``profiling.memory_analysis``), in bytes."""
    return memory_analysis(step, state, img, noise=noise)


def grads_vs_plain(config, train_cfg, params, img, noise):
    """One step's loss and gradients through ``config``'s path against the
    plain path's, same params and noise: the worst leaf's relative error."""
    plain_cfg = GlomConfig(**{**config.to_json_dict(), "ff_impl": "dense",
                              "attention_impl": "dense", "remat": False, "fuse_ff": False})

    def grads(cfg):
        return denoise.loss_and_grads(denoise.make_loss_fn(cfg, train_cfg), params, img,
                                      noise=noise)

    (loss_k, gk), (loss_p, gp) = grads(config), grads(plain_cfg)
    return {"loss_kernels": loss_k.item(), "loss_plain": loss_p.item(),
            **leaves_vs_plain(gk, gp, "gradient")}


def leaves_vs_plain(grads_k: dict, grads_p: dict, what: str) -> dict:
    """Every leaf of the gradient tree ``grads_k`` (through the kernels)
    within GRAD_RTOL of ``grads_p``'s (the plain path), relative
    (Frobenius); the worst leaf and its error."""
    gk, gp = (ckpt_lib.flatten({"": glom_model.tree_map(lambda t: t.detach().cpu(), g)})
              for g in (grads_k, grads_p))
    rel = {n[1:]: float(np.linalg.norm(gk[n] - gp[n]) / max(np.linalg.norm(gp[n]), 1e-30))
           for n in gp}
    worst = max(rel, key=rel.get)
    if not rel[worst] <= GRAD_RTOL:
        raise AssertionError(f"{what}: {worst} differs from the plain path by {rel[worst]}")
    return {"worst_leaf": worst, "worst_rel_err": rel[worst], "rtol": GRAD_RTOL}


def log_step_ms(log):
    """Host clock a step from the one-step logging windows; the first warms up."""
    return statistics.median(1e3 * BATCH / r["imgs_per_sec"] for r in log[1:] if "imgs_per_sec" in r)


def phase_train_fused(device, pallas_step_ms) -> dict:
    """The train step with ff_impl="fused" at flagship width, b=8: K8 in the
    forward; in the backward K1 and K4 again, then K2, K3, K6, K7 (the main
    path of this phase: counts set to 0 just before Trainer.fit, read just
    after).  Then remat=True and fuse_ff=True, two steps each."""
    base = {**FLAGSHIP.to_json_dict(), "ff_fused_bwd": True}
    c = GlomConfig(**{**base, "ff_impl": "fused"})
    gen = torch.Generator().manual_seed(1)
    shape = (BATCH, c.channels, c.image_size, c.image_size)
    img = torch.randn(shape, generator=gen).to(device)
    noise = torch.randn(shape, generator=gen).to(device)

    def counted_fit(cfg, steps):
        reset_launches()
        trainer, log = fit_run(cfg, device, img, steps=steps)
        launches = launch_counts()
        return trainer, log, launches, {k: v / steps for k, v in launches.items()}

    kern, log, launches, per_step = counted_fit(c, FUSED_TRAIN_STEPS)
    t = denoise.resolve_loss_timestep(kern.train_cfg, c.default_iters)
    want = {"fused_level_update": t, "grouped_ff": 2 * t, "grouped_ff_dx": 2 * t,
            "grouped_ff_dw": 2 * t, "consensus_attention": t, "consensus_dkv": t,
            "consensus_dq": t}
    if per_step != want:
        raise AssertionError(f"fused train-step launches per step {per_step}, expected {want}")
    losses = [r["loss"] for r in log if "loss" in r]
    if len(losses) != FUSED_TRAIN_STEPS or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"fused train losses not finite and falling: {losses}")
    grad = grads_vs_plain(c, kern.train_cfg, kern.state.params, img, noise)
    step = denoise.make_step_fn(c, kern.train_cfg, kern.optimizer)
    (s1, m1), (s2, m2) = step(kern.state, img, noise=noise), step(kern.state, img, noise=noise)
    bitwise = all(torch.equal(a, b) for a, b in zip(glom_model.tree_leaves(s1.params),
                                                    glom_model.tree_leaves(s2.params)))
    if not (bitwise and torch.equal(m1["loss"], m2["loss"])):
        raise AssertionError("two runs of one fused train step differ")
    del s1, s2, m1, m2
    memory = step_memory(step, kern.state, img, noise)

    # the step's other knobs through the kernels: remat on top of the fused
    # step (each K8 runs again in the backward), and fuse_ff, which defeats
    # the fused step and runs both nets as one K1 / K2 / K3 call of 11 groups
    knobs = {}
    for name, cfg, want_k in (
        ("remat", GlomConfig(**{**base, "ff_impl": "fused", "remat": True}),
         {**want, "fused_level_update": 2 * t}),
        ("fuse_ff", GlomConfig(**{**base, "ff_impl": "pallas", "attention_impl": "pallas",
                                  "fuse_ff": True}),
         {"fused_level_update": 0, "grouped_ff": t, "grouped_ff_dx": t, "grouped_ff_dw": t,
          "consensus_attention": t, "consensus_dkv": t, "consensus_dq": t}),
    ):
        tr, klog, _, kper = counted_fit(cfg, KNOB_TRAIN_STEPS)
        if kper != want_k:
            raise AssertionError(f"{name} launches per step {kper}, expected {want_k}")
        klosses = [r["loss"] for r in klog if "loss" in r]
        if not all(np.isfinite(klosses)):
            raise AssertionError(f"{name} losses not finite: {klosses}")
        knobs[name] = {"launches_per_step": kper, "losses": klosses,
                       "step_ms": log_step_ms(klog),
                       "grad_vs_plain": grads_vs_plain(cfg, tr.train_cfg, kern.state.params, img,
                                                       noise)}

    ms = log_step_ms(log)
    emit({"phase": "train_fused", "config": {**{k: c.to_json_dict()[k] for k in (
              "dim", "levels", "image_size", "patch_size", "ff_impl", "ff_fused_bwd",
              "attention_impl")}, "batch": BATCH, "iters": c.default_iters, "loss_timestep": t},
          "steps": FUSED_TRAIN_STEPS, "losses": losses,
          "step_ms": {"fused": ms, **({} if pallas_step_ms is None else {
              "pallas_kernels": pallas_step_ms["kernels"], "plain": pallas_step_ms["plain"]})},
          "images_per_s": 1e3 * BATCH / ms,
          "step_ms_note": "median over the steps after the first of one-step host-clock windows",
          "launches": launches, "launches_per_step": per_step, "grad_vs_plain": grad,
          "bitwise_repeat": True, "step_memory": memory, "knobs": knobs})
    phase_profile(lambda: step(kern.state, img, noise=noise)[1]["loss"].item(), runs=2,
                  phase="train_fused_profile", grad=True)
    return launches


def serve_trained(ckpt, device, trainer) -> None:
    """The checkpoint the trainer saved, served over HTTP on /embed."""
    engine = ServingEngine(ckpt, device=device, ff_impl="pallas", attention_impl="pallas")
    c = engine.config
    imgs = np.random.default_rng(1).standard_normal(
        (2, c.channels, c.image_size, c.image_size)).astype(np.float32)
    _, (reply,), outs, _ = serve_requests(engine, (("embed", 2),), {2: imgs})
    out = outs[("embed", 2)]
    with torch.inference_mode():
        want = glom_model.apply(trainer.state.params["glom"], torch.from_numpy(imgs).to(device),
                                config=engine.config).mean(dim=1).cpu().numpy()
    err = float(np.abs(out - want).max())
    if reply["step"] != trainer.state.step or out.shape != want.shape or not err <= SERVE_ATOL:
        raise AssertionError(f"served trained checkpoint: step {reply['step']}, shape "
                             f"{out.shape}, error {err}")
    emit({"phase": "serve_trained", "checkpoint_step": reply["step"], "shape": list(out.shape),
          "max_abs_err_vs_trained_params": err, "atol": SERVE_ATOL,
          "server_latency_ms": reply["server_latency_ms"]})


# The train_data phase: a seeded uint8 NHWC dataset of DATA_IMAGES images
# (one .npy, memory-mapped by the folder stream), two views a step, a held-out
# suite of EVAL_PSNR_IMAGES PSNR images and EVAL_PROBE_IMAGES probe images of
# EVAL_CLASSES classes, DATA_STEPS steps evaluated every DATA_EVAL_EVERY and
# checkpointed at DATA_CKPT_AT, and the CLI's run
DATA_IMAGES, DATA_SIDE = 1024, 256
EVAL_PSNR_IMAGES, EVAL_PROBE_IMAGES, EVAL_CLASSES = 64, 256, 8
DATA_STEPS, DATA_EVAL_EVERY, DATA_CKPT_AT = 12, 4, 6
NATIVE_BATCHES = 4
# one two-view loss against the plain path's, float32, relative
LOSS_RTOL = 1e-5
# the probe's float32 standardize against float64, elementwise in units of
# float32's roundoff u: |x32 - x64| <= PROBE_STD_ULPS u (max|f| / std) (1 + |x64|),
# the cancellation of a feature's mean from values max|f| over its spread
PROBE_STD_ULPS = 64
# the single-level probe's float32 ridge weights and test logits against a
# float64 solve of the same standardized features, relative (Frobenius); the
# weights read 4.1e-5 on the H100.  The all-levels probe (L*d features over
# fewer train rows: rank-deficient) is printed, not held
PROBE_RTOL = 1e-3
CLI_STEPS, CLI_EVAL_EVERY = 10, 5
CLI_TIMEOUT_S = 600


def data_dataset(seed: int = 0) -> str:
    """The seeded dataset, written as one .npy into build/ (ignored by git)."""
    directory = os.path.join(ROOT, "build", "chip_smoke_data")
    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    rng = np.random.default_rng(seed)
    np.save(os.path.join(directory, "images.npy"),
            rng.integers(0, 256, (DATA_IMAGES, DATA_SIDE, DATA_SIDE, 3), dtype=np.uint8))
    return directory


def class_images(n: int, seed: int, c: GlomConfig):
    """``n`` images of EVAL_CLASSES classes, each a fixed random pattern plus
    noise, and their labels (numpy, from ``seed``)."""
    rng = np.random.default_rng(seed)
    shape = (c.channels, c.image_size, c.image_size)
    patterns = rng.uniform(-1.0, 1.0, (EVAL_CLASSES,) + shape).astype(np.float32)
    labels = np.arange(n) % EVAL_CLASSES
    return (patterns[labels] + 0.25 * rng.standard_normal((n,) + shape, dtype=np.float32),
            labels)


class Recorded:
    """A batch iterator that keeps a copy of every batch it hands out."""

    def __init__(self, it):
        self.it, self.batches = it, []

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self.it)
        self.batches.append(np.array(batch))
        return batch


def full_losses(trainer) -> list:
    """The trainer's step losses at full precision (the log rounds them)."""
    losses, step = [], trainer._step

    def recorded(state, x, **kw):
        state, metrics = step(state, x, **kw)
        losses.append(metrics["loss"])
        return state, metrics

    trainer._step = recorded
    return losses


def two_view_vs_plain(config, train_cfg, params, img, noise, want_launches) -> dict:
    """One two-view loss and its gradients through ``config``'s kernels
    against the plain path's: the loss within LOSS_RTOL, each leaf within
    GRAD_RTOL, and the kernels' launches (the plain path makes none)
    ``want_launches``."""
    reset_launches()
    grad = grads_vs_plain(config, train_cfg, params, img, noise)
    launches = launch_counts()
    if launches != want_launches:
        raise AssertionError(f"two-view loss and gradients launched {launches}, expected "
                             f"{want_launches}")
    rel = abs(grad["loss_kernels"] - grad["loss_plain"]) / abs(grad["loss_plain"])
    if not rel <= LOSS_RTOL:
        raise AssertionError(f"two-view loss {grad['loss_kernels']} vs plain "
                             f"{grad['loss_plain']}: relative {rel}")
    return {**grad, "loss_rel_err": rel, "loss_rtol": LOSS_RTOL, "launches": launches}


def rel_err(got, want) -> float:
    """``||got - want|| / ||want||`` (Frobenius), in float64; tensors, arrays
    or numbers."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def probe_vs_f64(suite, params) -> dict:
    """The suite's probes as it runs them (float32) against float64, apart
    from the eval module: the standardize against one in float64 (within
    PROBE_STD_ULPS roundoffs), the accuracies equal to those of a float64
    standardize and solve, and for the single-level probe the weights and
    test logits within PROBE_RTOL of a float64 solve of the same
    standardized features."""
    from glom_tpu_torch.training import eval as eval_lib

    feats, n = suite._chunked_embed(params["glom"], suite.probe_images)
    labels = torch.from_numpy(suite.probe_labels[:n]).to(feats.device)
    k = min(suite._probe_split, n - 1)
    onehot = F.one_hot(labels[:k], suite.num_classes).double()
    u = 2.0 ** -24
    out = {}
    for name, f in (("level", feats[:, suite._level]), ("all_levels", feats.reshape(n, -1))):
        acc32 = eval_lib.linear_probe(f[:k], labels[:k], f[k:], labels[k:],
                                      num_classes=suite.num_classes)
        x, xt = eval_lib.standardize(f[:k], f[k:])
        f64 = f.double()
        mean, std = f64[:k].mean(0), torch.std(f64[:k], dim=0, correction=0) + 1e-6
        x64, xt64 = (f64[:k] - mean) / std, (f64[k:] - mean) / std
        scale = f64.abs().amax(0) / std
        std_ulps = max(float(((a.double() - b).abs() / (u * scale * (1 + b.abs()))).max())
                       for a, b in ((x, x64), (xt, xt64)))
        w32 = eval_lib.ridge_weights(x, onehot.float(), 1e-3)
        w_same = eval_lib.ridge_weights(x.double(), onehot, 1e-3)
        w64 = eval_lib.ridge_weights(x64, onehot, 1e-3)
        acc64 = tuple(float(torch.mean((torch.argmax(a @ w64, -1) == y).double()))
                      for a, y in ((x64, labels[:k]), (xt64, labels[k:])))
        res = {"features": int(f.shape[1]), "train_rows": k, "acc_f32": list(acc32),
               "acc_f64": list(acc64), "standardize_err_ulps": std_ulps,
               "weights_rel_err": rel_err(w32, w_same),
               "test_logits_rel_err": rel_err(xt @ w32, xt.double() @ w_same),
               "weights_rel_err_vs_f64_standardize": rel_err(w32, w64),
               "held": name == "level"}
        out[name] = res
        if list(acc32) != list(acc64):
            raise AssertionError(f"{name} probe: float32 accuracies {acc32} vs float64 {acc64}")
        if not std_ulps <= PROBE_STD_ULPS:
            raise AssertionError(f"{name} probe: the standardize against float64 {res}")
        if res["held"] and not max(res["weights_rel_err"],
                                   res["test_logits_rel_err"]) <= PROBE_RTOL:
            raise AssertionError(f"{name} probe: the float32 solve against float64 {res}")
    return {**out, "std_ulps_limit": PROBE_STD_ULPS, "rtol": PROBE_RTOL}


def eval_vs_plain(config, suite, params, noise_std: float, timestep: int, seed: int = 4) -> dict:
    """The held-out suite's forwards at its chunk (no_grad), through
    ``config``'s kernels against the plain path on the same params: the
    probe's pooled embeddings of one chunk (to the suite's iterations), and
    on a chunk of the PSNR images under one fixed noise tensor the state
    the decoder reads (to ``timestep``) and the PSNR.  Each within GRAD_RTOL
    relative to its norm, and the kernel forwards launch K1 twice and K4
    once an iteration."""
    from glom_tpu_torch.training import eval as eval_lib

    plain_cfg = GlomConfig(**{**config.to_json_dict(), "ff_impl": "dense",
                              "attention_impl": "dense"})
    dev = params["glom"]["pos_emb"].device
    chunk = suite.chunk
    probe = torch.from_numpy(suite.probe_images[:chunk]).to(dev)
    imgs = torch.from_numpy(suite.psnr_images[:chunk]).to(dev)
    noise = torch.randn(imgs.shape, generator=torch.Generator().manual_seed(seed)).to(dev)
    iters = suite.iters or config.default_iters

    def forwards(cfg):
        emb = eval_lib.embed_levels(params["glom"], probe, config=cfg, iters=suite.iters)
        with torch.no_grad():
            state = glom_model.apply(params["glom"], imgs + noise * noise_std, config=cfg,
                                     iters=timestep)
        psnr = eval_lib.make_psnr_fn(cfg, noise_std=noise_std, iters=suite.iters,
                                     timestep=timestep)(params, imgs, noise=noise)
        return emb, state, psnr

    reset_launches()
    got = forwards(config)
    launches = launch_counts()
    want_launches = {k: 0 for k in launches}
    want_launches["grouped_ff"] = 2 * (iters + 2 * timestep)
    want_launches["consensus_attention"] = iters + 2 * timestep
    if launches != want_launches:
        raise AssertionError(f"the eval forwards launched {launches}, expected {want_launches}")
    want = forwards(plain_cfg)
    errs = {name: rel_err(g, w) for name, g, w in zip(("probe_embeddings", "psnr_state", "psnr"),
                                                       got, want)}
    if not max(errs.values()) <= GRAD_RTOL:
        raise AssertionError(f"the eval forwards against the plain path: {errs}")
    return {"chunk": chunk, "probe_iters": iters, "psnr_timestep": timestep,
            "rel_err": errs, "rtol": GRAD_RTOL, "psnr_kernels": float(got[2]),
            "psnr_plain": float(want[2]), "launches": launches}


def phase_train_data(device) -> dict:
    """Training on data at flagship width, b=8: the native batcher against
    the NumPy path, the two-view objective through the kernels against the
    plain path, Trainer.fit on the folder stream with two views and the
    held-out suite (the main path: counts set to 0 just before, read just
    after), a stop at step 6 and a resume that retakes steps 7-12 bitwise,
    and the CLI's run on the same data."""
    from glom_tpu_torch import native
    from glom_tpu_torch.training.data import folder_batches, make_batches
    from glom_tpu_torch.training.eval import EvalSuite

    t0 = time.monotonic()
    root = data_dataset()
    c = GlomConfig(**{**FLAGSHIP.to_json_dict(), "ff_impl": "pallas", "ff_fused_bwd": True,
                      "attention_impl": "pallas"})
    # 1. the native batcher, which must build here (nvcc needs a host
    # compiler); built afresh, so that this machine's g++ and libjpeg decide
    # what it reports, not a library copied with the checkout
    shutil.rmtree(os.path.join(ROOT, "glom_tpu_torch", "native", "build"), ignore_errors=True)
    if native.load() is None:
        raise AssertionError("the native batcher did not build (g++) on the card's machine")
    fast = folder_batches(root, BATCH, c.image_size, seed=3)
    slow = folder_batches(root, BATCH, c.image_size, seed=3, use_native=False)
    for i in range(NATIVE_BATCHES):
        if not np.array_equal(next(fast), next(slow)):
            raise AssertionError(f"native batch {i} differs from the NumPy path's")
    emit({"phase": "train_data_native", "loaded": True, "has_jpeg": native.has_jpeg(),
          "dataset": [DATA_IMAGES, DATA_SIDE, DATA_SIDE, 3], "batches_bitwise": NATIVE_BATCHES,
          "setup_s": time.monotonic() - t0})

    # 2. two views through the kernels against the plain path
    tc = TrainConfig(batch_size=BATCH, consistency="infonce", consistency_weight=0.1, seed=0)
    trainer = Trainer(c, tc, device=device)
    params = trainer.state.params
    img = torch.from_numpy(next(fast)).to(device)
    gen = torch.Generator().manual_seed(2)
    noise = torch.randn((2,) + tuple(img.shape), generator=gen).to(device)
    fused = GlomConfig(**{**c.to_json_dict(), "ff_impl": "fused", "attention_impl": "dense"})
    mse = TrainConfig(batch_size=BATCH, consistency="mse", consistency_weight=0.1, seed=0)
    t = denoise.resolve_loss_timestep(tc, c.default_iters)
    per_step = {"fused_level_update": 0, "grouped_ff": 2 * t, "grouped_ff_dx": 2 * t,
                "grouped_ff_dw": 2 * t, "consensus_attention": t, "consensus_dkv": t,
                "consensus_dq": t}
    # "fused": K8 forward; its gradient runs the unfused kernels
    fused_step = {**per_step, "fused_level_update": t}
    vs_plain = {"pallas_infonce": two_view_vs_plain(c, tc, params, img, noise, per_step),
                "fused_infonce": two_view_vs_plain(fused, tc, params, img, noise, fused_step),
                "pallas_mse": two_view_vs_plain(c, mse, params, img, noise, per_step)}
    step = denoise.make_step_fn(c, tc, trainer.optimizer)
    reset_launches()
    step(trainer.state, img, noise=noise)
    torch.cuda.synchronize()
    one_step = launch_counts()
    if one_step != per_step:
        raise AssertionError(f"two-view step launches {one_step}, expected {per_step}")
    memory = step_memory(step, trainer.state, img, noise)
    one_view = step_memory(denoise.make_step_fn(c, TrainConfig(batch_size=BATCH),
                                                trainer.optimizer),
                           trainer.state, img, noise[0])
    del trainer, params, step
    emit({"phase": "train_data_two_views", "batch": BATCH, "rows_a_forward": 2 * BATCH,
          "vs_plain": vs_plain, "launches_one_step": one_step,
          "launches_note": "one two-view step: the one-view step's launches, each over 2b rows",
          "step_memory": {"two_views": memory, "one_view": one_view}})

    # 3. Trainer.fit on the folder stream: two views, eval every 4 steps
    psnr_imgs, _ = class_images(EVAL_PSNR_IMAGES, 11, c)
    probe_imgs, probe_labels = class_images(EVAL_PROBE_IMAGES, 12, c)
    suite = EvalSuite(c, psnr_imgs, probe_images=probe_imgs, probe_labels=probe_labels,
                      num_classes=EVAL_CLASSES, noise_std=tc.noise_std)
    ckpt = os.path.join(ROOT, "build", "chip_smoke_train_data_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)

    def fit_cfg(**kw):
        return TrainConfig(batch_size=BATCH, steps=DATA_STEPS, log_every=1,
                           eval_every=DATA_EVAL_EVERY, consistency="infonce",
                           consistency_weight=0.1, seed=0, **kw)

    import io

    log = io.StringIO()
    whole = Trainer(c, fit_cfg(checkpoint_dir=ckpt, checkpoint_every=DATA_CKPT_AT),
                    device=device, logger=MetricLogger(stream=log))
    whole.set_eval_suite(suite)
    losses = full_losses(whole)
    stream = Recorded(make_batches("folder", BATCH, c.image_size, c.channels, 5, root,
                                   augment="flip"))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        whole.fit(stream)
    finally:
        stream.it.close()
    launches = launch_counts()
    fit_peak = torch.cuda.max_memory_allocated()
    # launches: the steps', plus each eval's forwards (K1 twice and K4 once an
    # iteration): the PSNR chunks to the loss timestep, the probe's to 12
    chunk = suite.chunk
    evals = DATA_STEPS // DATA_EVAL_EVERY
    eval_iters = evals * (EVAL_PSNR_IMAGES // chunk * t + EVAL_PROBE_IMAGES // chunk
                          * c.default_iters)
    want = {k: DATA_STEPS * v for k, v in per_step.items()}
    want["grouped_ff"] += 2 * eval_iters
    want["consensus_attention"] += eval_iters
    if launches != want:
        raise AssertionError(f"train_data fit launches {launches}, expected {want}")
    records = [json.loads(line) for line in log.getvalue().splitlines()]
    steps_log = [r for r in records if "loss" in r]
    eval_log = [r for r in records if "eval_psnr_db" in r]
    loss_values = [float(v) for v in losses]
    if (len(loss_values) != DATA_STEPS or not all(np.isfinite(loss_values))
            or len(eval_log) != evals
            or not all(np.isfinite(list(r.values())).all() for r in eval_log)):
        raise AssertionError(f"train_data fit: losses {loss_values}, evals {eval_log}")

    # stop at step 6, resume in a new trainer on the unbroken run's batches 7-12
    resumed = Trainer(c, fit_cfg(), device=device, logger=MetricLogger(stream=io.StringIO()))
    resumed.set_eval_suite(suite)
    if resumed.restore(ckpt, step=DATA_CKPT_AT) != DATA_CKPT_AT:
        raise AssertionError("the resume did not restore step 6")
    tail = full_losses(resumed)
    resumed.fit(iter(stream.batches[DATA_CKPT_AT:]))
    bitwise = (len(tail) == DATA_STEPS - DATA_CKPT_AT
               and all(torch.equal(a, b) for a, b in zip(tail, losses[DATA_CKPT_AT:]))
               and all(torch.equal(a, b) for a, b in zip(
                   glom_model.tree_leaves(resumed.state.params),
                   glom_model.tree_leaves(whole.state.params))))
    if not bitwise:
        raise AssertionError(f"resumed losses {[float(v) for v in tail]} differ from the "
                             f"unbroken run's {loss_values[DATA_CKPT_AT:]}")
    eval_check = eval_vs_plain(c, suite, whole.state.params, tc.noise_std, t)
    probe = probe_vs_f64(suite, whole.state.params)
    windows = [r for r in steps_log if "t_window" in r]
    wait, window = sum(r["t_data_wait"] for r in windows), sum(r["t_window"] for r in windows)
    steady = [r for r in steps_log[1:] if "t_eval" not in r]
    del resumed
    shutil.rmtree(ckpt, ignore_errors=True)
    emit({"phase": "train_data", "config": {"batch": BATCH, "views": 2,
                                            "consistency": "infonce", "weight": 0.1,
                                            "augment": "flip", "eval_every": DATA_EVAL_EVERY,
                                            "loss_timestep": t, "suite_chunk": chunk},
          "losses": loss_values, "eval": eval_log, "launches": launches,
          "resume_bitwise": bitwise, "resumed_from": DATA_CKPT_AT,
          "step_ms": statistics.median(1e3 * BATCH / r["imgs_per_sec"] for r in steady),
          "step_ms_note": "median over one-step windows after the first, eval windows left out",
          "data_wait_share": wait / window, "t_data_wait_s": wait, "t_window_s": window,
          "eval_s": [r["t_eval"] for r in steps_log if "t_eval" in r],
          "fit_peak_memory_bytes": fit_peak, "eval_vs_plain": eval_check,
          "probe_vs_f64": probe})

    # 4. the CLI, as a user runs it
    cli_log = os.path.join(root, "cli.jsonl")
    cmd = [sys.executable, "-m", "glom_tpu_torch.training.train", "--data", "folder",
           "--data-dir", root, "--consistency", "mse", "--eval-every", str(CLI_EVAL_EVERY),
           "--steps", str(CLI_STEPS), "--log-every", "1", "--ff-impl", "pallas",
           "--attention-impl", "pallas", "--fused-ff-bwd", "--log-file", cli_log]
    t_cli = time.monotonic()
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=CLI_TIMEOUT_S)
    cli_s = time.monotonic() - t_cli
    if res.returncode != 0:
        raise AssertionError(f"the training CLI exited {res.returncode}: {res.stderr[-3000:]}")
    with open(cli_log) as f:
        cli = [json.loads(line) for line in f]
    cli_losses = [r["loss"] for r in cli if "loss" in r]
    cli_psnr = [r["psnr_db"] for r in cli if "psnr_db" in r]
    if (len(cli_losses) != CLI_STEPS or not all(np.isfinite(cli_losses))
            or len(cli_psnr) != CLI_STEPS // CLI_EVAL_EVERY or not all(np.isfinite(cli_psnr))):
        raise AssertionError(f"the training CLI: losses {cli_losses}, psnr_db {cli_psnr}")
    emit({"phase": "train_data_cli", "argv": cmd[3:], "exit": res.returncode,
          "losses": cli_losses, "psnr_db": cli_psnr, "seconds": cli_s})
    shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "train_data_done", "seconds": time.monotonic() - t0})
    return launches


# The slice's paths beside the denoising step: the classifier (CLASSIFY_STEPS
# steps at b=8 over CLASSIFY_CLASSES classes), video (examples/video_training.py's
# bench sizes: VIDEO_FRAMES frames of VIDEO_BATCH images; the gradient check on
# the first VIDEO_GRAD_FRAMES), extraction (EXTRACT_IMAGES seeded images in
# batches of EXTRACT_BATCH, the last a shorter tail) and the islanding post-pass
# (thresholds at each level's ISLAND_QUANTILES of agreement)
CLASSIFY_CLASSES, CLASSIFY_STEPS = 10, 3
VIDEO_FRAMES, VIDEO_BATCH, VIDEO_GRAD_FRAMES, VIDEO_STEPS = 8, 4, 4, 3
EXTRACT_IMAGES, EXTRACT_BATCH = 64, 24
ISLAND_QUANTILES = (0.3, 0.5, 0.7)
# a path through the kernels against the plain path on the same inputs and
# params, float32: relative (Frobenius), the train phase's rule
PATH_RTOL = 1e-4
# the pack's island means against a float64 mean of the same cells
ISLAND_MEAN_ATOL = 1e-5


def kernel_config(**kw) -> GlomConfig:
    """Flagship through the kernels: K1 and K4 forward, K2, K3, K6, K7 backward."""
    return GlomConfig(**{**FLAGSHIP.to_json_dict(), "ff_impl": "pallas", "ff_fused_bwd": True,
                         "attention_impl": "pallas", **kw})


def plain_of(config: GlomConfig) -> GlomConfig:
    return GlomConfig(**{**config.to_json_dict(), "ff_impl": "dense", "attention_impl": "dense"})


def want_launches(fwd: int, bwd: int = 0) -> dict:
    """The launches of ``fwd`` forward iterations on "pallas" (K1 twice, K4
    once each) and ``bwd`` backward ones (K2 and K3 twice, K6 and K7 once)."""
    return {"fused_level_update": 0, "grouped_ff": 2 * fwd, "grouped_ff_dx": 2 * bwd,
            "grouped_ff_dw": 2 * bwd, "consensus_attention": fwd, "consensus_dkv": bwd,
            "consensus_dq": bwd}


def check_launches(what: str, got: dict, want: dict) -> dict:
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")
    return got


def vs_plain(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """``got`` (through the kernels) within PATH_RTOL of ``want`` (the plain
    path), finite; the relative error."""
    err = rel_err(got, want)
    if not (bool(torch.isfinite(got).all()) and err <= PATH_RTOL):
        raise AssertionError(f"{what}: {err} from the plain path (limit {PATH_RTOL})")
    return err


def loss_and_leaves_vs_plain(loss_k, grads_k, loss_p, grads_p, what: str) -> dict:
    """A loss within LOSS_RTOL and every gradient leaf within GRAD_RTOL of
    the plain path's (relative)."""
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    if not loss_rel <= LOSS_RTOL:
        raise AssertionError(f"{what}: loss {float(loss_k)} vs plain {float(loss_p)} "
                             f"({loss_rel})")
    return {"loss_kernels": float(loss_k), "loss_plain": float(loss_p), "loss_rel_err": loss_rel,
            "loss_rtol": LOSS_RTOL, **leaves_vs_plain(grads_k, grads_p, what)}


def host_ms(fn):
    """``(ms, fn())`` on the host's clock between two synchronizations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def timed_steps(step, state, *args, steps: int, **kw):
    """``steps`` calls ``state, metrics = step(state, *args, **kw)``:
    ``(state, [ms], [loss])``, each on the host's clock, the losses finite."""
    ms, losses = [], []
    for _ in range(steps):
        t, (state, metrics) = host_ms(lambda: step(state, *args, **kw))
        ms.append(t)
        losses.append(metrics["loss"].item())
    if not all(np.isfinite(losses)):
        raise AssertionError(f"losses not finite: {losses}")
    return state, ms, losses


def phase_classify(device) -> dict:
    """The classifier at flagship width, b=8, f32, 12 iterations: logits and
    one unfrozen step's loss and gradients through the kernels against the
    plain path; the main path, CLASSIFY_STEPS unfrozen Adam steps (counts set
    to 0 just before, read just after), timed, with one step's peak memory;
    a frozen step under adamw with weight decay, which must launch no
    backward kernel and leave every backbone leaf bitwise as it was."""
    from glom_tpu_torch.models import classifier
    from glom_tpu_torch.training.optim import Optimizer

    c = kernel_config()
    plain = plain_of(c)
    iters = c.default_iters
    gen = torch.Generator().manual_seed(2)
    params = classifier.init(gen, c, CLASSIFY_CLASSES, device)
    imgs = torch.randn((BATCH, c.channels, c.image_size, c.image_size), generator=gen).to(device)
    labels = (torch.arange(BATCH) % CLASSIFY_CLASSES).to(device)

    with torch.inference_mode():
        reset_launches()
        logits = classifier.apply(params, imgs, config=c)
        fwd = check_launches("classifier logits", launch_counts(), want_launches(iters))
        logits_err = vs_plain(logits, classifier.apply(params, imgs, config=plain),
                              "classifier logits")

    def loss_grads(cfg):
        live = glom_model.tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, _ = classifier.make_loss_fn(cfg)(live, imgs, labels)
        return loss.detach(), classifier.grads_of(loss, live)

    grad = loss_and_leaves_vs_plain(*loss_grads(c), *loss_grads(plain), "classifier step")

    opt = Optimizer(1e-4)
    step = classifier.make_train_step(c, opt)

    def step3(carry):
        p, s, m = step(carry[0], carry[1], imgs, labels)
        return (p, s), m

    reset_launches()
    (p, s), ms, losses = timed_steps(step3, (params, opt.init(params)), steps=CLASSIFY_STEPS)
    launches = check_launches("classifier steps", launch_counts(),
                              want_launches(iters * CLASSIFY_STEPS, iters * CLASSIFY_STEPS))
    memory = memory_analysis(step, p, s, imgs, labels)
    del p, s

    frozen_opt = Optimizer(1e-3, weight_decay=0.1)
    frozen = classifier.make_train_step(c, frozen_opt, freeze_backbone=True)
    fs = frozen_opt.init(params)
    reset_launches()
    frozen_ms, (fp, fs, fm) = host_ms(lambda: frozen(params, fs, imgs, labels))
    frozen_launches = check_launches("frozen classifier step", launch_counts(),
                                     want_launches(iters))
    unchanged = all(torch.equal(a, b) for a, b in zip(glom_model.tree_leaves(params["glom"]),
                                                      glom_model.tree_leaves(fp["glom"])))
    if not unchanged or torch.equal(fp["head"]["w"], params["head"]["w"]):
        raise AssertionError(f"frozen step: backbone unchanged {unchanged}, head moved "
                             f"{not torch.equal(fp['head']['w'], params['head']['w'])}")
    step_ms = statistics.median(ms[1:])
    emit({"phase": "classify", "config": {"dim": c.dim, "levels": c.levels, "batch": BATCH,
                                          "iters": iters, "classes": CLASSIFY_CLASSES,
                                          "ff_impl": c.ff_impl, "attention_impl": c.attention_impl},
          "logits_rel_err": logits_err, "logits_rtol": PATH_RTOL, "forward_launches": fwd,
          "step_vs_plain": grad, "steps": CLASSIFY_STEPS, "losses": losses, "step_ms": ms,
          "ms_per_step": step_ms, "images_per_s": 1e3 * BATCH / step_ms,
          "step_ms_note": "host clock between synchronizations; ms_per_step the median "
                          "after the first", "launches": launches,
          "launches_per_step": {k: v // CLASSIFY_STEPS for k, v in launches.items()},
          "step_memory": memory, "frozen": {"launches": frozen_launches, "ms": frozen_ms,
                                            "backbone_bitwise_unchanged": unchanged,
                                            "loss": fm["loss"].item(), "weight_decay": 0.1}})
    return launches


def phase_video(device) -> dict:
    """Video at flagship width, 12 iterations a frame, VIDEO_FRAMES frames of
    VIDEO_BATCH images: each frame's rolled-out state through the kernels
    against the plain path (f32); one video train step's loss and gradients
    over VIDEO_GRAD_FRAMES frames under fixed noise against the plain path;
    the main path, VIDEO_STEPS f32 train steps over the whole clip (counts set
    to 0 just before, read just after), timed with their peak memory; then
    the rollout and the step timed in bf16 with remat."""
    from glom_tpu_torch.models import video
    from glom_tpu_torch.training import video as tvideo
    from glom_tpu_torch.training.optim import Optimizer

    c = kernel_config()
    plain = plain_of(c)
    iters = c.default_iters
    tc = TrainConfig(batch_size=VIDEO_BATCH, learning_rate=1e-3, iters=iters, noise_std=0.3)
    opt = Optimizer(tc.learning_rate)
    state = denoise.init_state(torch.Generator().manual_seed(3), c, opt, device=device)
    gen = torch.Generator().manual_seed(4)
    shape = (VIDEO_FRAMES, VIDEO_BATCH, c.channels, c.image_size, c.image_size)
    clip = torch.randn(shape, generator=gen).to(device)
    noise = torch.randn(shape, generator=gen).to(device)
    glom = state.params["glom"]
    frames_total = VIDEO_FRAMES * VIDEO_BATCH

    with torch.inference_mode():
        reset_launches()
        _, states = video.rollout(glom, clip, config=c, return_states=True)
        roll = check_launches("rollout", launch_counts(), want_launches(iters * VIDEO_FRAMES))
        _, plain_states = video.rollout(glom, clip, config=plain, return_states=True)
        frame_err = [vs_plain(k, p, f"rollout frame {i}")
                     for i, (k, p) in enumerate(zip(states, plain_states))]
    del states, plain_states

    short, short_noise = clip[:VIDEO_GRAD_FRAMES], noise[:VIDEO_GRAD_FRAMES]

    def video_grads(cfg):
        return denoise.loss_and_grads(tvideo.make_video_loss_fn(cfg, tc), state.params, short,
                                      noise=short_noise)

    reset_launches()
    kern = video_grads(c)
    n_short = iters * VIDEO_GRAD_FRAMES
    grad_launches = check_launches("video loss and gradients", launch_counts(),
                                   want_launches(n_short, n_short))
    grad = loss_and_leaves_vs_plain(*kern, *video_grads(plain), "video step")
    del kern

    def rollout_ms(cfg):
        """Three rollouts of the clip, each on the host's clock; the first
        of a configuration takes its one-time costs."""
        with torch.inference_mode():
            return [host_ms(lambda: video.rollout(glom, clip, config=cfg))[0] for _ in range(3)]

    n_clip = iters * VIDEO_FRAMES
    timings = {"float32": {"rollout_ms": rollout_ms(c)}}
    step = tvideo.make_video_train_step(c, tc, opt)
    reset_launches()
    s, ms, losses = timed_steps(step, state, clip, noise=noise, steps=VIDEO_STEPS)
    launches = check_launches("video steps", launch_counts(),
                              want_launches(n_clip * VIDEO_STEPS, n_clip * VIDEO_STEPS))
    timings["float32"].update({"step_ms": ms, "losses": losses,
                               "step_memory": memory_analysis(step, s, clip, noise=noise)})
    del s

    # bf16 compute with remat: the forward's K1 and K4 run again in the backward;
    # the bf16 rollout runs first, so that the step's first time holds remat's
    # one-time cost and not bf16's
    cb = kernel_config(compute_dtype="bfloat16", remat=True)
    timings["bfloat16_remat"] = {"rollout_ms": rollout_ms(cb)}
    step_b = tvideo.make_video_train_step(cb, tc, opt)
    reset_launches()
    s, ms_b, losses_b = timed_steps(step_b, state, clip, noise=noise, steps=VIDEO_STEPS)
    check_launches("bf16 remat video steps", launch_counts(),
                   want_launches(2 * n_clip * VIDEO_STEPS, n_clip * VIDEO_STEPS))
    timings["bfloat16_remat"].update({"step_ms": ms_b, "losses": losses_b,
                                      "step_memory": memory_analysis(step_b, s, clip,
                                                                     noise=noise)})
    del s
    for t in timings.values():
        t.update({"rollout_frames_per_s": 1e3 * frames_total / statistics.median(
                      t["rollout_ms"][1:]),
                  "step_frames_per_s": 1e3 * frames_total / statistics.median(t["step_ms"][1:])})
    emit({"phase": "video", "config": {"dim": c.dim, "levels": c.levels, "frames": VIDEO_FRAMES,
                                       "batch": VIDEO_BATCH, "iters": iters,
                                       "noise_std": tc.noise_std},
          "rollout_launches": roll, "rollout_frame_rel_err": frame_err, "rtol": PATH_RTOL,
          "grad_frames": VIDEO_GRAD_FRAMES, "step_vs_plain": grad,
          "grad_launches": grad_launches, "launches": launches, "steps": VIDEO_STEPS,
          "timings": timings,
          "timing_note": "host clock between synchronizations; frames/s = frames x batch over "
                         "the median after the first; step_memory: one step's peak"})
    return launches


def phase_extract(device) -> dict:
    """Embedding extraction at flagship width: a checkpoint written with
    ff_impl="pallas", loaded as the CLI loads it, and extract_embeddings on
    EXTRACT_IMAGES seeded images (the main path: counts set to 0 just before
    the top-level run, read just after) against the same checkpoint forced
    to the plain path, for the top level and for every level; images/s."""
    from glom_tpu_torch.training import extract

    ckpt = os.path.join(ROOT, "build", "chip_smoke_extract_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    make_demo_checkpoint(ckpt, config=kernel_config(), seed=5)
    step, config, _, params = denoise.load_checkpoint_state(ckpt, device=device)
    shutil.rmtree(ckpt, ignore_errors=True)
    if (config.ff_impl, config.attention_impl) != ("pallas", "pallas"):
        raise AssertionError(f"the checkpoint's config: {config.ff_impl}, "
                             f"{config.attention_impl}")
    imgs = np.random.default_rng(6).standard_normal(
        (EXTRACT_IMAGES, config.channels, config.image_size, config.image_size)).astype(np.float32)
    batches = [imgs[i:i + EXTRACT_BATCH] for i in range(0, EXTRACT_IMAGES, EXTRACT_BATCH)]
    n_fwd = config.default_iters * len(batches)
    rows, launches = {}, None
    for name, kw in (("level", {"level": -1}), ("all_levels", {"all_levels": True})):
        reset_launches()
        got = extract.extract_embeddings(params["glom"], config, batches, **kw)
        counted = check_launches(f"extract {name}", launch_counts(), want_launches(n_fwd))
        launches = launches or counted
        want = extract.extract_embeddings(params["glom"], plain_of(config), batches, **kw)
        shape = (EXTRACT_IMAGES,) + ((config.levels,) if name == "all_levels" else ()) + (
            config.dim,)
        if got.shape != shape or got.dtype != np.float32:
            raise AssertionError(f"extract {name}: {got.shape} {got.dtype}, expected {shape}")
        err = vs_plain(torch.from_numpy(got), torch.from_numpy(want), f"extract {name}")
        ms = {path: host_ms(lambda: extract.extract_embeddings(params["glom"], cfg, batches,
                                                               **kw))[0]
              for path, cfg in (("kernels", config), ("plain", plain_of(config)))}
        rows[name] = {"rel_err": err, "shape": list(shape), "ms": ms,
                      "images_per_s": {k: 1e3 * EXTRACT_IMAGES / v for k, v in ms.items()}}
    emit({"phase": "extract", "checkpoint_step": step, "images": EXTRACT_IMAGES,
          "batches": [len(b) for b in batches], "iters": config.default_iters,
          "rtol": PATH_RTOL, "launches": launches, **rows,
          "ms_note": "host clock over extract_embeddings on the 64 images (each batch's "
                     "embeddings back on the host), after the counted and compared runs"})
    return launches


def device_ops(fn) -> int:
    """The device operations (kernels, copies, fills) of one call of ``fn``,
    from a torch.profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def phase_islands(device) -> dict:
    """GLOM's islands at flagship width, b=8: the index forward (the main
    path: counts set to 0 just before, read just after) against the plain
    path; then make_pack_fn on the card, with each level's threshold at its
    ISLAND_QUANTILES of agreement, against the host flood fill on the same
    agreement maps: labels and counts bitwise, sizes exact, means within
    ISLAND_MEAN_ATOL of a float64 mean of the same cells; the pack's time
    and its device operations."""
    from glom_tpu_torch.hierarchy import parse
    from glom_tpu_torch.models.islands import label_islands
    from glom_tpu_torch.obs.quality import agreement_maps

    c = kernel_config()
    side, n, L, d = c.num_patches_side, c.num_patches, c.levels, c.dim
    gen = torch.Generator().manual_seed(7)
    params = {"glom": glom_model.init(gen, c, device)}
    imgs = torch.randn((BATCH, c.channels, c.image_size, c.image_size), generator=gen).to(device)
    with torch.inference_mode():
        reset_launches()
        levels = parse.make_index_fn(c, None)(params, imgs)
        launches = check_launches("index forward", launch_counts(),
                                  want_launches(c.default_iters))
        index_err = vs_plain(levels, parse.make_index_fn(plain_of(c), None)(params, imgs),
                             "index forward")
        agree = agreement_maps(levels, side)[1]
    agree_np = agree.cpu().numpy()
    states = levels.double().cpu().numpy()
    cases = []
    for q in ISLAND_QUANTILES:
        thr = tuple(float(torch.quantile(agree[:, lv].flatten(), q)) for lv in range(L))
        pack = parse.make_pack_fn(c, thr)
        with torch.inference_mode():
            rows = pack(levels).cpu().numpy()
            pack_ms = time_ms(lambda: pack(levels))
            ops = device_ops(lambda: pack(levels))
        labels = rows[:, :L * n].reshape(BATCH, L, side, side)
        counts = rows[:, L * n:L * n + L]
        sizes = rows[:, L * n + L:2 * L * n + L].reshape(BATCH, L, n)
        means = rows[:, 2 * L * n + L:].reshape(BATCH, L, n, d)
        mean_err, islands = 0.0, []
        for i in range(BATCH):
            for lv in range(L):
                want, want_sizes = label_islands(agree_np[i, lv], thr[lv])
                k = len(want_sizes)
                if not (np.array_equal(labels[i, lv], want) and counts[i, lv] == k
                        and np.array_equal(sizes[i, lv, :k], want_sizes)
                        and not sizes[i, lv, k:].any() and not means[i, lv, k:].any()):
                    raise AssertionError(f"islands q={q} image {i} level {lv}: the pack's "
                                         f"labelling differs from the host flood fill")
                sums = np.zeros((k + 1, d))
                np.add.at(sums, want.ravel(), states[i, :, lv])
                ref = sums[1:] / want_sizes[:, None]
                mean_err = max(mean_err, float(np.abs(means[i, lv, :k] - ref).max(initial=0.0)))
                islands.append(k)
        if not mean_err <= ISLAND_MEAN_ATOL:
            raise AssertionError(f"islands q={q}: means {mean_err} from float64")
        cases.append({"quantile": q, "thresholds": thr,
                      "above_share": float((agree >= torch.tensor(
                          thr, device=agree.device)[None, :, None, None]).float().mean()),
                      "islands_min": min(islands), "islands_max": max(islands),
                      "islands_mean": float(np.mean(islands)), "mean_max_abs_err": mean_err,
                      "pack_ms": pack_ms, "pack_device_ops": ops})
    emit({"phase": "islands", "batch": BATCH, "side": side, "levels": L, "dim": d,
          "propagation_steps": n, "index_rel_err": index_err, "rtol": PATH_RTOL,
          "launches": launches, "row_width": parse.parse_row_width(L, side, d),
          "mean_atol": ISLAND_MEAN_ATOL, "cases": cases,
          "pack_ms_note": "CUDA events, the median of REPS runs of 5 calls; device ops from a "
                          "torch.profiler trace of one call"})
    return launches


# quant, sessions and parse: the serving request path at reduced precision,
# with state, and the part-whole endpoints, every family captured at start-up
QUANT_MODES = ("f32", "bf16", "int8")
# the reduced modes capture buckets 1 and 8 only (the phase's time)
QUANT_BUCKETS = {"f32": GRAPH_BUCKETS, "bf16": (1, 8), "int8": (1, 8)}
# a path through the kernels against the plain path in bf16 (normwise)
BF16_PATH_RTOL = 1e-2
QUANT_PROBE = 4
SESSION_FRAMES = 8
SESSION_STATE_RTOL = 1e-6
INDEX_IMAGES = 64
SIMILAR_QUERIES = 8
PARSE_FRAMES = 4
# the parse engine's threshold of level l sits at its PARSE_QUANTILES[l % 3]
# agreement quantile
PARSE_QUANTILES = (0.3, 0.5, 0.7)
# /similar's float32 scan against a float64 scan of the same index vectors:
# the scores' rounding over 512-wide dot products of unit vectors
SIMILAR_F32_ATOL = 4e-6


def flagship_ckpt(name: str, seed: int, **kw) -> str:
    """A fresh flagship demo checkpoint under build/ (random seeded weights)."""
    ckpt = os.path.join(ROOT, "build", name)
    shutil.rmtree(ckpt, ignore_errors=True)
    make_demo_checkpoint(ckpt, config=kernel_config(**kw), seed=seed)
    return ckpt


def free_engines(*engines) -> None:
    for engine in engines:
        engine.shutdown(drain=False)
    gc.collect()
    torch.cuda.empty_cache()


def replay_ms(cache, bucket: int) -> float:
    """Device time of one replay of ``cache``'s graph at ``bucket`` (CUDA
    events, time_ms): the forward alone, without the copies in and out."""
    graph = cache._graphs[bucket].graph
    return time_ms(graph.replay)


def plain_embed_fn(engine):
    """``engine``'s /embed forward on the plain path in the engine's own
    quant mode (the same weights, dequantized the same way)."""
    from glom_tpu_torch.serving import engine as engine_mod
    from glom_tpu_torch.serving import quant

    cfg = plain_of(engine.serve_config)
    fns = glom_model.resolve_step_fns(cfg, engine.device)
    return quant.quantized_forward(engine_mod.make_embed_fn(cfg, engine.embed_iters, fns),
                                   engine.quant)


def phase_quant(device) -> dict:
    """Serving at f32, bf16 and int8 on "pallas" and on "fused", each an
    engine with every family captured at start-up (the reduced modes at
    buckets 1 and 8): every bucket's /embed and /reconstruct replay bitwise
    its eager forward; the b=8 /embed through the kernels against the plain
    path in the same mode (f32: PATH_RTOL; bf16 and int8: the bf16 rule,
    1e-2); accuracy_report of bf16 and int8 against f32 on the pallas path
    with glom_tpu's thresholds (a miss is recorded, a finding, not a
    failure); the resident parameter bytes, each family's pool bytes, and
    /embed b=1 and b=8 replayed (device time of the graph by CUDA events,
    and the host's wall clock to the answer).  The main path: one b=8
    /embed replay an engine (counts set to 0 just before, read just after)."""
    from glom_tpu_torch.serving import quant

    ckpt = flagship_ckpt("chip_smoke_quant_ckpt", seed=12)
    c = kernel_config()
    shape = (c.channels, c.image_size, c.image_size)
    rng = np.random.default_rng(13)
    x = {b: rng.standard_normal((b,) + shape).astype(np.float32) for b in GRAPH_BUCKETS}
    iters = c.default_iters
    rows, total = {}, {k: 0 for k in kernel_wrappers()}
    for impl in ("pallas", "fused"):
        for mode in QUANT_MODES:
            buckets = QUANT_BUCKETS[mode]
            t0 = time.perf_counter()
            engine = ServingEngine(ckpt, device=device, ff_impl=impl, quant=mode,
                                   buckets=buckets, reload_poll_s=0)
            setup_s = time.perf_counter() - t0
            for endpoint in ("embed", "reconstruct"):
                for b in buckets:
                    if not np.array_equal(engine.run(endpoint, x[b]),
                                          engine.run_eager(endpoint, x[b])):
                        raise AssertionError(f"quant {mode} {impl} {endpoint} b={b}: the replay "
                                             f"differs from the eager forward")
            reset_launches()
            got = engine.run("embed", x[8])
            launches = launch_counts()
            want = ({**want_launches(0), "fused_level_update": iters} if impl == "fused"
                    else want_launches(iters))
            check_launches(f"quant {mode} {impl} /embed b=8", launches, want)
            for k, n in launches.items():
                total[k] += n
            with torch.inference_mode():
                plain = plain_embed_fn(engine)(
                    engine.params, torch.from_numpy(x[8]).to(device)).cpu()
            err = rel_err(torch.from_numpy(got), plain)
            rtol = PATH_RTOL if mode == "f32" else BF16_PATH_RTOL
            if not (np.isfinite(got).all() and err <= rtol):
                raise AssertionError(f"quant {mode} {impl}: /embed {err} from the plain path "
                                     f"(limit {rtol})")
            embed = engine.caches["embed"]
            rows[f"{impl}/{mode}"] = {
                "buckets": list(buckets), "setup_seconds": setup_s,
                "bitwise_replay": {"embed": list(buckets), "reconstruct": list(buckets)},
                "embed_b8_vs_plain_rel_err": err, "rtol": rtol,
                "param_bytes": engine.param_bytes(), "pool_bytes": engine.graph_pool_bytes(),
                # what one /parse or /similar replay of the index forward launches
                "index_launches_per_replay_b8": engine.caches["index"].launches_per_replay()
                .get(8),
                "embed_replay_device_ms": {f"b{b}": replay_ms(embed, b) for b in (1, 8)},
                "embed_served_ms": {f"b{b}": served_ms(lambda: engine.run("embed", x[b]))
                                    for b in (1, 8)},
                "launches_main": launches}
            free_engines(engine)
    _, config, train_cfg, params = denoise.load_checkpoint_state(ckpt, device="cpu")
    report = quant.accuracy_report(config, train_cfg, params, x[QUANT_PROBE], device=device)
    accuracy = {mode: {k: r[k] for k in ("worst_cosine", "worst_max_abs_rel", "thresholds",
                                         "pass")}
                | {"embed_levels": {lv: r["embed"][lv] for lv in r["embed"]},
                   "reconstruct": r["reconstruct"]}
                for mode, r in report.items()}
    emit({"phase": "quant", "config": {"dim": c.dim, "levels": c.levels, "iters": iters,
                                       "image_size": c.image_size, "patch_size": c.patch_size},
          "engines": rows, "accuracy": accuracy, "accuracy_probe": QUANT_PROBE,
          "launches": total,
          "time_note": "embed_replay_device_ms: CUDA events over graph replays (time_ms); "
                       "embed_served_ms: host clock of engine.run to the answer on the host, "
                       "the median of 5 after a warm-up"})
    shutil.rmtree(ckpt, ignore_errors=True)
    return total


def session_chain(engine, sid: str, frames) -> list:
    return [engine.session_embed(sid, f) for f in frames]


def rollout_embeddings(engine, frames, schedule, params=None) -> list:
    """The chained frames eagerly through models/video.py::rollout_varied,
    one frame a call with the carried state: each frame's mean embeddings."""
    from glom_tpu_torch.models import video

    params = engine.params["glom"] if params is None else params
    out, state = [], None
    with torch.inference_mode():
        for frame, it in zip(frames, schedule):
            state = video.rollout_varied(params, [torch.from_numpy(frame).to(engine.device)],
                                         [it], config=engine.serve_config, levels=state)
            out.append(state.mean(dim=1).float().cpu())
    return out


def chain_vs_rollout(got, want, what: str) -> dict:
    errs = [rel_err(torch.from_numpy(g), w) for (g, _), w in zip(got, want)]
    if not max(errs) <= SESSION_STATE_RTOL:
        raise AssertionError(f"{what}: frames {errs} from the rollout (limit "
                             f"{SESSION_STATE_RTOL})")
    return {"max_rel_err": max(errs),
            "bitwise": all(np.array_equal(g, w.numpy()) for (g, _), w in zip(got, want))}


def phase_sessions(device) -> dict:
    """Stateful sessions at flagship width, f32, "pallas", warm_iters="auto"
    (6 of 12): SESSION_FRAMES chained frames through session_embed at b=1 and
    b=4 (the main path: counts set to 0 just before, read just after)
    against models/video.py::rollout_varied([12, 6, 6, ...]) run eagerly on
    the same frames; two sessions at b=4 with their frames interleaved, each
    bitwise its solo run; a batch change restarting cold; a spill on drain
    restored by a new engine, whose next warm frame is bitwise the one of
    the engine that never stopped; an int8 session of four frames (a bf16
    state) against the rollout of the dequantized weights; a fused session's
    warm frame (K8 only); the cold and warm frame times and a session's
    state bytes."""
    from glom_tpu_torch.serving import quant

    ckpt = flagship_ckpt("chip_smoke_sessions_ckpt", seed=14)
    spill = os.path.join(ROOT, "build", "chip_smoke_spill")
    shutil.rmtree(spill, ignore_errors=True)
    c = kernel_config()
    shape = (c.channels, c.image_size, c.image_size)
    rng = np.random.default_rng(15)
    engine = ServingEngine(ckpt, device=device, warm_iters="auto", reload_poll_s=0,
                           session_spill_dir=spill)
    cold_it, warm_it = engine._session_cold_iters, engine._session_warm_iters
    schedule = [cold_it] + [warm_it] * (SESSION_FRAMES - 1)
    frames = {b: [rng.standard_normal((b,) + shape).astype(np.float32)
                  for _ in range(SESSION_FRAMES)] for b in (1, 4)}
    reset_launches()
    chains = {b: session_chain(engine, f"chain-b{b}", frames[b]) for b in (1, 4)}
    launches = check_launches("session frames", launch_counts(),
                              want_launches(2 * sum(schedule)))
    vs_rollout = {}
    for b in (1, 4):
        infos = [info for _, info in chains[b]]
        if [i["cold"] for i in infos] != [True] + [False] * (SESSION_FRAMES - 1):
            raise AssertionError(f"session b={b}: {infos}")
        vs_rollout[f"b{b}"] = chain_vs_rollout(chains[b], rollout_embeddings(
            engine, frames[b], schedule), f"session b={b}")

    # two sessions at one bucket, frames alternating: each as alone
    a, bb = frames[4][:4], [f[::-1].copy() for f in frames[4][:4]]
    mixed = {"a": [], "b": []}
    for fa, fb in zip(a, bb):
        mixed["a"].append(engine.session_embed("mix-a", fa)[0])
        mixed["b"].append(engine.session_embed("mix-b", fb)[0])
    alone = {"a": [engine.session_embed("solo-a", f)[0] for f in a],
             "b": [engine.session_embed("solo-b", f)[0] for f in bb]}
    for k in ("a", "b"):
        if not all(np.array_equal(m, s) for m, s in zip(mixed[k], alone[k])):
            raise AssertionError(f"interleaved session {k} differs from its solo run")

    out, info = engine.session_embed("chain-b4", frames[1][0])
    if not (info["cold"] and info.get("restart") == "batch_changed"):
        raise AssertionError(f"batch change: {info}")

    # timing: warm frames continue a session, cold ones reset it first
    timing = {}
    for b in (1, 4):
        x = frames[b][0]
        engine.session_embed(f"time-b{b}", x)
        warm_ms = served_ms(lambda: engine.session_embed(f"time-b{b}", x))

        def cold():
            engine.session_reset(f"time-b{b}")
            engine.session_embed(f"time-b{b}", x)

        timing[f"b{b}"] = {"warm_served_ms": warm_ms, "cold_served_ms": served_ms(cold),
                           "warm_replay_device_ms": replay_ms(engine.caches["session_warm"], b),
                           "cold_replay_device_ms": replay_ms(engine.caches["session_cold"], b)}
    state_bytes = {f"b{b}": engine.sessions.get(f"time-b{b}").nbytes for b in (1, 4)}
    per_frame = {"warm": engine.caches["session_warm"].launches_per_replay().get(1),
                 "cold": engine.caches["session_cold"].launches_per_replay().get(1)}

    # spill on drain, restore in a new engine: the next warm frame is the one
    # of an engine that never stopped
    spill_frames = frames[4][:3] + [frames[4][5]]
    for f in spill_frames[:3]:
        engine.session_embed("spilled", f)
        engine.session_embed("kept", f)
    never_stopped = engine.session_embed("kept", spill_frames[3])[0]
    pools = engine.graph_pool_bytes()
    captures = engine.registry.snapshot().get("serving_graph_captures", 0)
    free_engines(engine)
    booted = ServingEngine(ckpt, device=device, warm_iters="auto", reload_poll_s=0,
                           session_spill_dir=spill, buckets=(4,))
    restored = booted.registry.snapshot().get("serving_session_restores")
    out, info = booted.session_embed("spilled", spill_frames[3])
    if info["cold"] or info["frames"] != 4 or not np.array_equal(out, never_stopped):
        raise AssertionError(f"restored session: {info}, bitwise "
                             f"{np.array_equal(out, never_stopped)}")
    free_engines(booted)

    # int8: a bf16 state on the card
    q = ServingEngine(ckpt, device=device, warm_iters="auto", reload_poll_s=0, quant="int8",
                      buckets=(1,))
    q_frames = frames[1][:4]
    q_chain = session_chain(q, "int8", q_frames)
    q_state = q.sessions.get("int8").levels
    if q_state.dtype != torch.bfloat16:
        raise AssertionError(f"int8 session state is {q_state.dtype}")
    q_vs = chain_vs_rollout(q_chain, rollout_embeddings(
        q, q_frames, schedule[:4], params=quant.dequantize_tree(q.params)["glom"]),
        "int8 session")
    free_engines(q)

    # fused: a warm frame is warm_iters launches of K8
    fz = ServingEngine(ckpt, device=device, warm_iters="auto", reload_poll_s=0,
                       ff_impl="fused", buckets=(1,))
    session_chain(fz, "fused", frames[1][:2])
    reset_launches()
    fz.session_embed("fused", frames[1][2])
    check_launches("fused warm frame", launch_counts(),
                   {**want_launches(0), "fused_level_update": warm_it})
    fused_per_frame = fz.caches["session_warm"].launches_per_replay().get(1)
    free_engines(fz)
    shutil.rmtree(spill, ignore_errors=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    emit({"phase": "sessions", "config": {"dim": c.dim, "levels": c.levels},
          "cold_iters": cold_it, "warm_iters": warm_it, "frames": SESSION_FRAMES,
          "launches": launches, "launches_per_frame": {"pallas": per_frame,
                                                      "fused_warm": fused_per_frame},
          "vs_rollout": vs_rollout, "rtol": SESSION_STATE_RTOL,
          "interleaved_bitwise_solo": True, "batch_change_restart": "batch_changed",
          "spill_restored_sessions": restored, "restored_frame_bitwise": True,
          "int8_state_dtype": "bfloat16", "int8_vs_rollout": q_vs,
          "state_bytes": state_bytes, "timing": timing, "pool_bytes": pools,
          "graph_captures_after_warmup": captures,
          "time_note": "*_served_ms: host clock of session_embed to the answer on the host, "
                       "the median of 5 after a warm-up (cold: a reset, then the frame); "
                       "*_replay_device_ms: CUDA events over graph replays (time_ms)"})
    if captures:
        raise AssertionError(f"{captures} graph captures on the session path")
    return launches


def split_rows(rows, L, n):
    """Packed parse rows -> (labels, counts, sizes, means)."""
    return (rows[:, :L * n], rows[:, L * n:L * n + L], rows[:, L * n + L:2 * L * n + L],
            rows[:, 2 * L * n + L:])


def rows_vs_eager(got, want, L, n, what: str) -> float:
    """Labels, counts and sizes bitwise, means within ISLAND_MEAN_ATOL."""
    g, w = split_rows(got, L, n), split_rows(want, L, n)
    if not all(np.array_equal(a, b) for a, b in zip(g[:3], w[:3])):
        raise AssertionError(f"{what}: labels, counts or sizes differ from the eager path")
    err = float(np.abs(g[3] - w[3]).max())
    if not err <= ISLAND_MEAN_ATOL:
        raise AssertionError(f"{what}: means {err} from the eager path")
    return err


def similar_report(engine, corpus, picks, index_dir, L) -> dict:
    """/similar on ``corpus[picks]`` (every slot ranked) at the top level and
    at level 0, against a float64 scan of the same index vectors and of the
    same queries: every served score within SIMILAR_F32_ATOL of the float64
    one, the served top-1 the float64 top-1 up to that rounding, and each
    image the float64 top-1 of its own query (the index holds its vectors:
    cosine 1).  At level 0 each image must be the served top-1 too; at the
    top level a served self-match is recorded, not required, since images
    whose patch means agree within float32 rounding tie in the float32 scan
    (glom_tpu's scan is float32 as well)."""
    from glom_tpu_torch.hierarchy.index import assemble_level

    def unit(x):
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)

    states = engine.run("index", corpus[picks])
    report = {}
    for level in (L - 1, 0):
        results, info = engine.similar(corpus[picks], level=level, k=INDEX_IMAGES)
        entries = unit(assemble_level(index_dir, level, total=INDEX_IMAGES).astype(np.float64))
        ranks, gaps, err = [], [], 0.0
        for i, slot in enumerate(picks):
            q = states[i, :, level, :]
            if level == L - 1:
                q = q.mean(axis=0, keepdims=True)
            f64 = np.einsum("qd,ked->kqe", unit(q.astype(np.float64)), entries)
            f64 = f64.reshape(INDEX_IMAGES, -1).max(axis=1)
            served = {r["slot"]: r["score"] for r in results[i]}
            err = max(err, max(abs(served[k] - f64[k]) for k in range(INDEX_IMAGES)))
            others = np.delete(f64, slot)
            if not (int(np.argmax(f64)) == slot and f64[slot] > others.max()):
                raise AssertionError(f"/similar level {level}: image {slot} is not its own "
                                     f"float64 top-1")
            if f64[results[i][0]["slot"]] < f64.max() - 2 * SIMILAR_F32_ATOL:
                raise AssertionError(f"/similar level {level}: served top-1 "
                                     f"{results[i][0]} against the float64 scan")
            ranks.append([r["slot"] for r in results[i]].index(slot))
            gaps.append(float(f64[slot] - others.max()))
        if not err <= SIMILAR_F32_ATOL:
            raise AssertionError(f"/similar level {level}: scores {err} from float64")
        if level == 0 and any(ranks):
            raise AssertionError(f"/similar level 0: self ranks {ranks}")
        report[f"level_{info['level']}"] = {
            "served_self_rank": ranks, "top1_self": ranks.count(0),
            "float64_self_gap_min": min(gaps), "score_max_abs_err_vs_f64": err}
    return report


def parse_device_ms(engine, bucket: int) -> dict:
    """Device time of /parse at ``bucket`` (CUDA events): the index graph's
    replay, the copy of its output into the pack's input and the pack's
    replay; and the pack's replay alone."""
    index = engine.caches["index"]._graphs[bucket]
    pack = engine.caches["parse"]._graphs[(bucket, "float32")]

    def whole():
        index.graph.replay()
        pack.static_in.copy_(index.static_out)
        pack.graph.replay()

    with torch.inference_mode():   # the static buffers are inference tensors
        total, pack_ms = time_ms(whole), time_ms(pack.graph.replay)
    return {"device_ms": total, "pack_device_ms": pack_ms, "pack_share": pack_ms / total}


def phase_parse(device) -> dict:
    """The part-whole endpoints at flagship width, f32, "pallas", with
    warm_iters and an index: the threshold of level l at the
    PARSE_QUANTILES[l % 3] quantile of its agreement on a probe batch; /parse
    at every bucket replayed against the eager index forward and eager pack
    (labels, counts, sizes bitwise, means within 1e-5); an index of 64
    seeded images written from the index graphs with
    hierarchy/index.py::write_index_parts, then /similar on 8 of them at the
    top level and at level 0 (similar_report); /session/parse over four
    frames, the first reporting every island appeared and the deltas of
    each against island_deltas on the eagerly computed labels (the main
    path: counts set to 0 before a b=8 /parse and the four frames, read
    after); then over HTTP, an int8 engine with --tenant-quota a=0.01:2:
    one request each to /parse, /similar, /session/embed, /session/parse,
    /session/reset, tenant a's third image 503 tenant_overloaded and an
    unknown tenant through; /parse b=1 and b=8 times (device by CUDA events,
    the pack's share, host wall), and no capture on the request path."""
    from glom_tpu_torch.hierarchy import parse
    from glom_tpu_torch.hierarchy.index import write_index_parts
    from glom_tpu_torch.obs.quality import agreement_maps
    from glom_tpu_torch.serving import server as server_mod

    ckpt = flagship_ckpt("chip_smoke_parse_ckpt", seed=16)
    index_dir = os.path.join(ROOT, "build", "chip_smoke_index")
    shutil.rmtree(index_dir, ignore_errors=True)
    c = kernel_config()
    side, n, L, d = c.num_patches_side, c.num_patches, c.levels, c.dim
    shape = (c.channels, c.image_size, c.image_size)
    rng = np.random.default_rng(17)
    probe = rng.standard_normal((BATCH,) + shape).astype(np.float32)
    _, _, _, params = denoise.load_checkpoint_state(ckpt, device=device)
    with torch.inference_mode():
        agree = agreement_maps(parse.make_index_fn(c, None)(
            params, torch.from_numpy(probe).to(device)), side)[1]
    thr = tuple(float(torch.quantile(agree[:, lv].flatten(), PARSE_QUANTILES[lv % 3]))
                for lv in range(L))
    del params, agree
    t0 = time.perf_counter()
    engine = ServingEngine(ckpt, device=device, warm_iters="auto", reload_poll_s=0,
                           parse_thresholds=thr, index_dir=index_dir)
    setup_s = time.perf_counter() - t0
    mean_err = {}
    for b in GRAPH_BUCKETS:
        x = rng.standard_normal((b,) + shape).astype(np.float32)
        mean_err[f"b{b}"] = rows_vs_eager(engine.run("parse", x), engine.run_eager("parse", x),
                                          L, n, f"/parse b={b}")

    # the main path: a b=8 /parse and four /session/parse frames
    frames = [rng.standard_normal((1,) + shape).astype(np.float32) for _ in range(PARSE_FRAMES)]
    schedule = [engine._session_cold_iters] + [engine._session_warm_iters] * (PARSE_FRAMES - 1)
    reset_launches()
    rows8 = engine.run("parse", probe)
    session_out = [engine.session_parse("parse-cam", f) for f in frames]
    launches = check_launches("parse path", launch_counts(),
                              want_launches(c.default_iters + sum(schedule)))
    counts = split_rows(rows8, L, n)[1]
    # the session's labels, eagerly: the rollout's state through the pack
    from glom_tpu_torch.models import video

    prev, state, deltas_ok = None, None, []
    with torch.inference_mode():
        for (rows, info), f, it in zip(session_out, frames, schedule):
            state = video.rollout_varied(engine.params["glom"],
                                         [torch.from_numpy(f).to(device)], [it],
                                         config=engine.serve_config, levels=state)
            want_rows = engine._pack_fn(state).cpu().numpy()
            rows_vs_eager(rows, want_rows, L, n, "/session/parse")
            labels = np.rint(want_rows[:, :L * n]).astype(np.int32).reshape(L, side, side)
            want = [parse.island_deltas(prev, labels)]
            if info["deltas"] != want:
                raise AssertionError(f"/session/parse frame {info['frames']}: deltas differ")
            if prev is None and any(dl["vanished"] or dl["moved"] or dl["stable"]
                                    for dl in info["deltas"][0]):
                raise AssertionError("the first parse frame must report every island appeared")
            deltas_ok.append({k: sum(len(dl[k]) for dl in info["deltas"][0])
                              for k in ("appeared", "vanished", "moved", "stable")})
            prev = labels

    # the index: 64 seeded images through the index graphs, then /similar
    corpus = np.random.default_rng(18).standard_normal(
        (INDEX_IMAGES,) + shape).astype(np.float32)
    for lo in range(0, INDEX_IMAGES, BATCH):
        write_index_parts(index_dir, lo, lo + BATCH, engine.run("index", corpus[lo:lo + BATCH]))
    picks = list(range(0, INDEX_IMAGES, INDEX_IMAGES // SIMILAR_QUERIES))
    similar = similar_report(engine, corpus, picks, index_dir, L)
    timing = {}
    for b in (1, 8):
        x = probe[:b]
        timing[f"b{b}"] = {**parse_device_ms(engine, b),
                           "served_ms": served_ms(lambda: engine.run("parse", x)),
                           "eager_served_ms": served_ms(lambda: engine.run_eager("parse", x)),
                           "index_replay_device_ms": replay_ms(engine.caches["index"], b)}
    captures = engine.registry.snapshot().get("serving_graph_captures", 0)
    pools = engine.graph_pool_bytes()
    free_engines(engine)

    # over HTTP: int8, a tenant quota, every new route once
    args = server_mod.parse_args(["--checkpoint-dir", ckpt, "--quant", "int8", "--tenant-quota",
                                  "a=0.01:2", "--warm-iters", "auto", "--buckets", "1",
                                  "--reload-poll-s", "0", "--index-dir", index_dir,
                                  "--parse-thresholds", ",".join(str(t) for t in thr)])
    http_engine = server_mod.engine_from_args(args)
    http_engine.start()
    server = make_server(http_engine, port=0)
    thread = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05})
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    img = {"images": corpus[:1].tolist()}
    replies = {}
    try:
        def call(path, payload, tenant):
            req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json",
                                                  "X-Tenant": tenant})
            try:
                with urllib.request.urlopen(req, timeout=300) as resp:
                    return resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        replies["parse"] = call("/parse", img, "a")
        replies["similar"] = call("/similar", {**img, "k": 2}, "a")
        replies["session_embed_a"] = call("/session/embed", {**img, "session": "h"}, "a")
        replies["session_embed"] = call("/session/embed", {**img, "session": "h"}, "z")
        replies["session_parse"] = call("/session/parse", {**img, "session": "h"}, "z")
        replies["session_reset"] = call("/session/reset", {"session": "h"}, "z")
        http_health = get(base + "/healthz")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        http_captures = http_engine.registry.snapshot().get("serving_graph_captures", 0)
        free_engines(http_engine)
    codes = {k: v[0] for k, v in replies.items()}
    want_codes = {"parse": 200, "similar": 200, "session_embed_a": 503, "session_embed": 200,
                  "session_parse": 200, "session_reset": 200}
    if codes != want_codes or replies["session_embed_a"][1].get("error") != "tenant_overloaded":
        raise AssertionError(f"HTTP codes {codes}, expected {want_codes}: {replies}")
    if not (replies["session_parse"][1]["frames"] == 2 and replies["session_reset"][1]["reset"]
            and len(replies["parse"][1]["islands"][0]) == L):
        raise AssertionError(f"HTTP replies: {replies}")
    if captures or http_captures:
        raise AssertionError(f"graph captures on the request path: {captures}, {http_captures}")
    shutil.rmtree(index_dir, ignore_errors=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    emit({"phase": "parse", "config": {"dim": d, "levels": L, "side": side,
                                       "iters": c.default_iters},
          "thresholds": thr, "quantiles": [PARSE_QUANTILES[lv % 3] for lv in range(L)],
          "setup_seconds": setup_s, "replay_vs_eager_mean_max_abs_err": mean_err,
          "mean_atol": ISLAND_MEAN_ATOL, "islands_b8": {"min": int(counts.min()),
                                                        "max": int(counts.max())},
          "launches": launches, "session_parse_deltas": deltas_ok, "similar": similar,
          "index_images": INDEX_IMAGES, "timing": timing, "pool_bytes": pools,
          "http": {"codes": codes, "quant": http_health["quant"],
                   "tenants": http_health["tenants"]},
          "graph_captures_after_warmup": captures,
          "time_note": "device_ms: CUDA events over the index replay, the copy into the pack "
                       "and the pack replay (time_ms); served_ms: host clock of engine.run to "
                       "the rows on the host, the median of 5 after a warm-up"})
    return launches


# The bench phase's legs, each one run of ``python -m glom_tpu_torch.tools.bench``
# at flagship with 12 iterations: (leg, what it shows, flags, the kernels it
# must launch in its window).  "trace" marks a leg run with --profile-dir.
# -- deploys, the session tools, fault injection ---------------------------------
DEPLOY_BUCKETS = (1, 8)
DEPLOY_KEYS = 32
# the shadow's divergence gauge (rounded to 6 digits) against float64 on the host
DIVERGENCE_ATOL = 1e-6
# allocated memory after a shadow -> rollback cycle, against before the first
MEMORY_CYCLE_RTOL = 0.01
MEMORY_CYCLES = 3
SHADOW_BATCHES = 4
LATENCY_SAMPLES = {1: 40, 8: 20}
SESSION_SWEEP = "2,3,4,6"
SESSION_TOOL_FRAMES = 8
FAULT_TRAIN_STEPS = 4


def perturbed_step(ckpt: str, step: int, seed: int, src: int = 0, scale: float = 1e-3) -> None:
    """Step ``step`` of ``ckpt``: step ``src``'s parameters plus seeded noise
    (its other trees dropped: a server reads only ``params``)."""
    tree = ckpt_lib.unflatten(ckpt_lib.load_arrays(ckpt, src))["params"]
    rng = np.random.default_rng(seed)
    flat = ckpt_lib.flatten({"params": tree})
    noisy = {k: (v + scale * rng.standard_normal(v.shape)).astype(v.dtype)
             for k, v in flat.items()}
    ckpt_lib.save(ckpt, step, ckpt_lib.unflatten(noisy))


def embed_ms(engine, x, n: int, starts=None, **kw) -> list:
    """Host clock of ``n`` /embed submissions one after another, ms each
    (``starts`` collects each one's start on the host's clock)."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        engine.submit("embed", x, **kw).result(timeout=120)
        out.append((time.perf_counter() - t0) * 1e3)
        if starts is not None:
            starts.append(t0)
    return out


def timed(obj, name: str, log: list) -> None:
    """Wrap ``obj.name`` so each call appends ``(start, end)`` on the host's
    clock to ``log``; ``del obj.name`` unwraps an instance attribute."""
    fn = getattr(obj, name)

    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            log.append((t0, time.perf_counter()))

    setattr(obj, name, wrapper)


def pct(xs, q):
    ordered = sorted(xs)
    return ordered[min(len(ordered) - 1, max(0, int(np.ceil(q / 100 * len(ordered))) - 1))]


def latency_block(xs) -> dict:
    return {"n": len(xs), "p50": pct(xs, 50), "p95": pct(xs, 95), "p99": pct(xs, 99),
            "max": max(xs)}


def stop_shadow_thread(engine) -> None:
    engine.deploy._stop.set()
    with engine.deploy._shadow_cv:
        engine.deploy._shadow_cv.notify_all()
    engine.deploy._shadow_thread.join(timeout=30)
    engine.deploy._stop.clear()


def set_bytes(serving) -> dict:
    from glom_tpu_torch.serving import quant

    return {"params": quant.tree_nbytes(serving.params),
            "pools": {name: cache.pool_bytes() for name, cache in serving.caches.items()}}


def phase_deploy(device) -> dict:
    """Safe deploys on one replica at flagship width, f32 "pallas", buckets 1
    and 8, warm_iters "auto", with an extra model "b" (the flagship under
    ff_impl="fused", its own checkpoint) and the SLO p95<200ms on 2 s
    windows (deploy windows of 1 s, 4 events, promote after 2): (A) a
    candidate written with ckpt_write:bitflip armed is quarantined by
    /admin/deploy/shadow (a null step, idle, allocated memory unchanged);
    (B) a shadow of step 2 (step 0's weights plus seeded noise): its capture
    seconds, the longest exclusive hold of the device lock, /embed b=1 p99
    before and during begin_shadow, the primary's /embed b=1 and b=8
    p50/p95 without and with the shadow, then SHADOW_BATCHES mirrored b=8
    batches pumped by hand (the main path: counts set to 0 before a
    primary batch and its shadow replay, each with its quality pass; the
    shadow's agreement gauge from the candidate's own quality family): each
    batch's
    deploy_shadow_divergence against the float64 divergence of the two
    sets' eager answers, every candidate bucket bitwise its eager forward,
    the primary's answers bitwise as before the shadow; (C) a canary at 0.5
    over 32 X-Affinity-Keys, each answer bitwise the eager forward of the
    version assign names, a session pinned to the candidate, then
    candidate:delay armed until the burn-rate rollback, with no client
    error, the next answers the primary's and the pinned session restarting
    cold (version_retired); (D) a clean step 3 canaried until the
    auto-promote: step 3 serves, its answers bitwise the candidate's, no
    capture by the promote, serving_graph_captures 0, the promote's wall
    time; (E) /embed with "model": "b" bitwise b's eager forward, K8's
    launches counted; then MEMORY_CYCLES shadow -> rollback cycles holding
    allocated memory within 1 % of before the first."""
    from glom_tpu_torch.obs.slo import parse_slo
    from glom_tpu_torch.resilience import faultinject
    from glom_tpu_torch.serving import compile_cache, deploy

    ckpt = flagship_ckpt("chip_smoke_deploy_ckpt", seed=16)
    ckpt_b = flagship_ckpt("chip_smoke_deploy_b", seed=17, ff_impl="fused")
    c = kernel_config()
    shape = (c.channels, c.image_size, c.image_size)
    rng = np.random.default_rng(18)
    x = {b: rng.standard_normal((b,) + shape).astype(np.float32) for b in DEPLOY_BUCKETS}
    iters = c.default_iters
    t0 = time.perf_counter()
    engine = ServingEngine(
        ckpt, device=device, buckets=DEPLOY_BUCKETS, reload_poll_s=0, max_wait_ms=1.0,
        warm_iters="auto", extra_models={"b": ckpt_b},
        # a shadow's latency holds the candidate's forward and its quality
        # pass (glom_tpu times both), queued behind the primary's forward and
        # quality pass on one card: about 110 ms at b=8 under load, inside
        # this bound, while candidate:delay's 250 ms per batch crosses it
        slos=[parse_slo("p95<200ms", short_window_s=2.0, long_window_s=4.0, min_events=4,
                        burn_threshold=2.0)],
        deploy_window_s=1.0, deploy_min_events=4, deploy_promote_after=2)
    setup_s = time.perf_counter() - t0
    engine.start(watch=False)
    server = make_server(engine)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = "http://{}:{}".format(*server.server_address[:2])
    out = {"setup_seconds": setup_s, "buckets": list(DEPLOY_BUCKETS),
           "primary_bytes": set_bytes(engine.serving),
           "extra_model_bytes": set_bytes(engine.models.get("b").caches)}
    try:
        before = {b: engine.run("embed", x[b]) for b in DEPLOY_BUCKETS}

        # (A) a corrupt candidate never becomes resident
        with faultinject.injected("ckpt_write:bitflip"):
            make_demo_checkpoint(ckpt, config=c, seed=19, step=1)
        mem0 = settled_memory(device)["allocated"]
        body, _ = post(base + "/admin/deploy/shadow", {})
        mem1 = settled_memory(device)["allocated"]
        quarantined = [f for f in os.listdir(ckpt) if f.endswith(".corrupt")]
        if body["candidate_step"] is not None or engine.deploy.phase != "idle" \
                or not quarantined or mem1 != mem0:
            raise AssertionError(f"corrupt candidate: {body}, {quarantined}, {mem0} -> {mem1}")
        out["corrupt"] = {"reply": body, "quarantined": quarantined,
                          "allocated_before": mem0, "allocated_after": mem1}

        # (B) the shadow: its capture off the request path, beside live traffic
        perturbed_step(ckpt, 2, seed=20)
        lat_before = embed_ms(engine, x[1], 60)
        quiet = {b: embed_ms(engine, x[b], LATENCY_SAMPLES[b]) for b in DEPLOY_BUCKETS}
        engine._device_lock.longest_exclusive_s = 0.0
        made = compile_cache.captures_made()
        during, starts, stop = [], [], threading.Event()
        restores, captures = [], []
        timed(engine, "_restore_set", restores)
        timed(engine, "_warm_set", captures)

        def drive():
            while not stop.is_set():
                during.extend(embed_ms(engine, x[1], 1, starts=starts))

        loader = threading.Thread(target=drive)
        loader.start()
        t0 = time.perf_counter()
        body, _ = post(base + "/admin/deploy/shadow", {"step": 2})
        shadow_s = time.perf_counter() - t0
        stop.set()
        loader.join()
        del engine._restore_set, engine._warm_set
        # where the slowest request of the window sat: inside the restore
        # (host reads, CRCs, the copy to the card) or the captures
        slowest = int(np.argmax(during))
        s0, s1 = starts[slowest], starts[slowest] + during[slowest] / 1e3
        window = {"restore_s": restores[0][1] - restores[0][0],
                  "capture_s": captures[0][1] - captures[0][0],
                  "slowest_request_ms": during[slowest],
                  "slowest_overlaps_restore_s": max(0.0, min(s1, restores[0][1])
                                                    - max(s0, restores[0][0])),
                  "slowest_overlaps_captures_s": max(0.0, min(s1, captures[0][1])
                                                     - max(s0, captures[0][0]))}
        cand = engine.deploy.candidate(2)
        if body["candidate_step"] != 2 or cand is None:
            raise AssertionError(f"shadow: {body}")
        shadowed = {b: embed_ms(engine, x[b], LATENCY_SAMPLES[b]) for b in DEPLOY_BUCKETS}
        out["shadow"] = {
            "capture_seconds": shadow_s, "captures": compile_cache.captures_made() - made,
            "begin_shadow_window": window,
            "longest_exclusive_hold_s": engine._device_lock.longest_exclusive_s,
            "candidate_bytes": set_bytes(cand.caches),
            "embed_b1_before_begin_shadow_ms": latency_block(lat_before),
            "embed_b1_during_begin_shadow_ms": latency_block(during),
            "primary_embed_ms": {f"b{b}": {"without_shadow": latency_block(quiet[b]),
                                           "with_shadow": latency_block(shadowed[b])}
                                 for b in DEPLOY_BUCKETS},
            "shadow_dropped": engine.registry.snapshot().get("deploy_shadow_dropped", 0)}
        stop_shadow_thread(engine)
        with engine.deploy._shadow_cv:
            engine.deploy._shadow_q.clear()
        for ep in ("embed", "reconstruct"):
            for b in DEPLOY_BUCKETS:
                cache = cand.caches.caches[ep]
                if not np.array_equal(cache(cand.params, x[b]), cache.eager(cand.params, x[b])):
                    raise AssertionError(f"candidate {ep} b={b}: replay differs from eager")
        divergences, agreements, main = [], [], {k: 0 for k in kernel_wrappers()}
        for i in range(SHADOW_BATCHES):
            xb = np.random.default_rng(30 + i).standard_normal((8,) + shape).astype(np.float32)
            observed = engine.quality.observed
            reset_launches()
            got = engine.submit("embed", xb).result(timeout=120)
            # the primary's quality pass runs after its answer: wait for it
            wait_quality(engine, observed + 1)
            with engine.deploy._shadow_cv:
                item = engine.deploy._shadow_q.popleft() if engine.deploy._shadow_q else None
            if item is None:
                raise AssertionError(f"shadow batch {i}: nothing mirrored (phase "
                                     f"{engine.deploy.phase}, {engine.deploy.last_report})")
            if not engine.deploy.process_shadow(*item):
                raise AssertionError("shadow: the mirrored batch did not run")
            # the primary's forward and quality pass, the candidate's forward
            # and its own quality pass (the shadow's agreement and residual)
            launches = check_launches("primary b=8 + its shadow, each with its quality pass",
                                      launch_counts(), want_launches(4 * iters))
            own = cand.caches.caches["quality"].eager(cand.params, xb)
            agreement = engine.registry.snapshot()["deploy_shadow_agreement"]
            if agreement != round(float(own[:, :c.levels].mean()), 6):
                raise AssertionError(f"shadow batch {i}: deploy_shadow_agreement {agreement}, "
                                     f"the candidate's own post-pass {own[:, :c.levels].mean()}")
            agreements.append(agreement)
            for k, n in launches.items():
                main[k] += n
            want, _ = deploy._cosine_divergence(
                engine.run_eager("embed", xb),
                cand.caches.caches["embed"].eager(cand.params, xb))
            gauge = engine.registry.snapshot()["deploy_shadow_divergence"]
            if not (np.array_equal(got, engine.run_eager("embed", xb))
                    and abs(gauge - want) <= DIVERGENCE_ATOL):
                raise AssertionError(f"shadow batch {i}: gauge {gauge}, float64 {want}")
            divergences.append({"gauge": gauge, "float64": want})
        for b in DEPLOY_BUCKETS:
            if not np.array_equal(engine.run("embed", x[b]), before[b]):
                raise AssertionError(f"primary b={b}: answers moved during the shadow")
        out["shadow"]["divergence"] = divergences
        out["shadow"]["agreement"] = agreements

        # (C) canary at 0.5, then a burn-rate rollback (no auto-promote while
        # the keys are checked: the windows would count their clean outcomes)
        engine.deploy.promote_after = 10 ** 6
        body, _ = post(base + "/admin/deploy/canary", {"fraction": 0.5})
        if body["phase"] != "canary":
            raise AssertionError(f"canary: {body}")
        eager = {0: engine.run_eager("embed", x[1]),
                 2: cand.caches.caches["embed"].eager(cand.params, x[1])}
        sides = {}
        for i in range(DEPLOY_KEYS):
            key = f"key-{i}"
            version = engine.deploy.assign(key) or 0
            resp, _ = post(base + "/embed", {"images": x[1].tolist()}, {"X-Affinity-Key": key})
            if resp["step"] != version or not np.array_equal(
                    np.asarray(resp["embeddings"], np.float32), eager[version]):
                raise AssertionError(f"canary key {key}: step {resp['step']}, assigned "
                                     f"{version}, bitwise mismatch")
            sides[key] = version
        pinned = next(f"sess-{i}" for i in range(256)
                      if engine.deploy.assign(f"sess-{i}") == 2)
        infos = [engine.session_embed(pinned, x[1])[1] for _ in range(2)]
        if [(i["step"], i["cold"]) for i in infos] != [(2, True), (2, False)]:
            raise AssertionError(f"pinned session: {infos}")
        cand_keys = [k for k, v in sides.items() if v == 2]
        # the controller reads idle as soon as it takes the candidate, before
        # its report is written: wait for the rollback call to return
        codes, rollbacks, t0 = [], [], time.perf_counter()
        timed(engine.deploy, "rollback", rollbacks)
        with faultinject.injected("candidate:delay*100"):
            for i in itertools.count():
                if rollbacks or time.perf_counter() - t0 > 60:
                    break
                try:
                    resp, _ = post(base + "/embed", {"images": x[1].tolist()},
                                   {"X-Affinity-Key": cand_keys[i % len(cand_keys)]})
                    codes.append(200)
                except urllib.error.HTTPError as e:
                    codes.append(e.code)
        del engine.deploy.rollback
        report = engine.deploy.last_report
        if engine.deploy.phase != "idle" or report["action"] != "rolled_back" or set(codes) != {200}:
            raise AssertionError(f"rollback: {engine.deploy.phase}, {report}, codes {codes}")
        after = [post(base + "/embed", {"images": x[1].tolist()}, {"X-Affinity-Key": k})[0]
                 for k in cand_keys[:4]]
        if any(r["step"] != 0 or not np.array_equal(np.asarray(r["embeddings"], np.float32),
                                                    eager[0]) for r in after):
            raise AssertionError("after the rollback: answers are not the primary's")
        _, info = engine.session_embed(pinned, x[1])
        if not (info["cold"] and info.get("restart") == "version_retired" and info["step"] == 0):
            raise AssertionError(f"pinned session after the rollback: {info}")
        out["canary"] = {"keys": DEPLOY_KEYS, "on_candidate": len(cand_keys),
                         "rollback": {k: report[k] for k in ("reason", "pins",
                                                              "phase_at_rollback")}
                         | {k: report.get(k) for k in ("slo", "burn_rate_short")},
                         "requests_until_rollback": len(codes), "client_errors": 0,
                         "pinned_session_after": info}

        # (D) a clean candidate auto-promotes; the promote captures nothing
        engine.deploy.promote_after = 2
        perturbed_step(ckpt, 3, seed=21)
        body, _ = post(base + "/admin/deploy/canary", {"fraction": 0.5, "step": 3})
        cand3 = engine.deploy.candidate(3)
        if body["candidate_step"] != 3 or cand3 is None:
            raise AssertionError(f"canary of step 3: {body}")
        made = compile_cache.captures_made()
        promotes = []
        timed(engine.deploy, "promote", promotes)
        keys3 = [f"key-{i}" for i in range(256) if engine.deploy.assign(f"key-{i}") == 3]
        t0 = time.perf_counter()
        for i in itertools.count():
            if promotes or time.perf_counter() - t0 > 60:   # the promote call returned
                break
            post(base + "/embed", {"images": x[1].tolist()},
                 {"X-Affinity-Key": keys3[i % len(keys3)]})
        del engine.deploy.promote
        report = engine.deploy.last_report
        resp, _ = post(base + "/embed", {"images": x[1].tolist()})
        captures = engine.registry.snapshot().get("serving_graph_captures", 0)
        if (report["action"] != "promoted" or engine.step != 3 or engine.serving is not cand3.caches
                or compile_cache.captures_made() != made or captures
                or resp["step"] != 3
                or not all(np.array_equal(
                    np.asarray(resp["embeddings"], np.float32) if b == 1 else engine.run(
                        "embed", x[b]), cand3.caches.caches["embed"].eager(cand3.params, x[b]))
                    for b in DEPLOY_BUCKETS)):
            raise AssertionError(f"promote: {report}, step {engine.step}, captures "
                                 f"{compile_cache.captures_made() - made}/{captures}")
        out["promote"] = {"report": {k: report[k] for k in ("step", "from_step")},
                          "wall_ms": [(t1 - t0) * 1e3 for t0, t1 in promotes],
                          "captures_by_promote": 0,
                          "serving_graph_captures": captures,
                          "requests_until_promote": i}

        # (E) the extra model, through K8
        b = engine.models.get("b")
        resp, _ = post(base + "/embed", {"images": x[1].tolist(), "model": "b"})
        reset_launches()
        got = engine.submit("embed", x[8], model="b").result(timeout=120)
        launches_b = check_launches("extra model b /embed b=8", launch_counts(),
                                    {**want_launches(0), "fused_level_update": iters})
        for k, n in launches_b.items():
            main[k] += n
        if resp.get("model") != "b" or not (
                np.array_equal(np.asarray(resp["embeddings"], np.float32),
                               b.caches.caches["embed"].eager(b.params, x[1]))
                and np.array_equal(got, b.caches.caches["embed"].eager(b.params, x[8]))):
            raise AssertionError("extra model b: an answer differs from its eager forward")
        out["extra_model"] = {"launches_b8": launches_b, "bitwise_eager": [1, 8]}

        # retiring frees the card: shadow -> rollback cycles (the displaced
        # step-0 set and every reference of this phase released first)
        del cand, cand3, b
        engine.finalize_reload()
        perturbed_step(ckpt, 4, seed=22)
        base_mem = settled_memory(device)["allocated"]
        cycles = []
        for _ in range(MEMORY_CYCLES):
            post(base + "/admin/deploy/shadow", {"step": 4})
            resident = settled_memory(device)["allocated"]
            post(base + "/admin/deploy/rollback", {})
            cycles.append({"with_candidate": resident,
                           "after_rollback": settled_memory(device)["allocated"]})
        drift = abs(cycles[-1]["after_rollback"] - base_mem) / base_mem
        if drift > MEMORY_CYCLE_RTOL:
            raise AssertionError(f"shadow -> rollback cycles: allocated {base_mem} -> {cycles}")
        out["memory_cycles"] = {"before": base_mem, "cycles": cycles, "rel_drift": drift,
                                "rtol": MEMORY_CYCLE_RTOL}
    finally:
        server.shutdown()
        server.server_close()
        free_engines(engine)
    emit({"phase": "deploy", "config": {"dim": c.dim, "levels": c.levels, "iters": iters},
          "launches": main, **out,
          "time_note": "host clock (time.perf_counter) throughout: *_ms lists and blocks are "
                       "engine.submit to the answer on the host; capture_seconds is the "
                       "/admin/deploy/shadow call; promote wall_ms is DeployController.promote"})
    shutil.rmtree(ckpt, ignore_errors=True)
    shutil.rmtree(ckpt_b, ignore_errors=True)
    return main


def phase_session_tools(device) -> dict:
    """The session tools at flagship width: python -m
    glom_tpu_torch.tools.session_check --warm-iters 2,3,4,6 --frames 8
    --batch 2 on a "pallas" checkpoint (the main path: counts set to 0 just
    before, read just after; every frame a graph replay), its verdict and
    each sweep value's distance and p50/p95; then the port's load generator
    against an in-process server: --sessions 4 --frames 8, and --tenant a:3
    --tenant b:1 (tenant a's quota 50 images/s), p50/p95 per frame kind and
    per tenant."""
    import contextlib
    import io

    from glom_tpu_torch.tools import session_check

    ckpt = flagship_ckpt("chip_smoke_session_tools_ckpt", seed=23)
    c = kernel_config()
    report_path = os.path.join(ROOT, "build", "chip_smoke_session_check.json")
    reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):     # its report is read from the file
        rc = session_check.main(["--checkpoint-dir", ckpt, "--warm-iters", SESSION_SWEEP,
                                 "--frames", str(SESSION_TOOL_FRAMES), "--batch", "2",
                                 "--report", report_path, "--device", str(device)])
    launches = launch_counts()
    with open(report_path) as f:
        report = json.load(f)
    cold, frames = report["cold_iters"], SESSION_TOOL_FRAMES
    sweep = [int(w) for w in SESSION_SWEEP.split(",")]
    # each cache's capture runs its forward once eagerly: the cold cache
    # (capture + frame 0), the full cache (capture + frames-1), and each warm
    # value's (capture + frames-1)
    fwd = 2 * cold + cold * frames + sum(w * frames for w in sweep)
    check_launches("session_check", launches, want_launches(fwd))
    if rc not in (0, 1) or len(report["sweep"]) != len(sweep):
        raise AssertionError(f"session_check exited {rc}: {report}")

    engine = ServingEngine(ckpt, device=device, buckets=(1, 8), reload_poll_s=0,
                           warm_iters="auto", tenant_quotas={"a": "50:50"})
    engine.start(watch=False)
    server = make_server(engine)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = "http://{}:{}".format(*server.server_address[:2])
    try:
        sessions = run_loadgen(base, "--sessions", 4, "--frames", SESSION_TOOL_FRAMES)
        tenants = run_loadgen(base, "--tenant", "a:3", "--tenant", "b:1", "--requests", 40,
                              "--concurrency", 4)
    finally:
        server.shutdown()
        server.server_close()
        free_engines(engine)
    if sessions["requests_error"] or sessions["session"]["affinity"]["violations"] \
            or tenants["requests_error"]:
        raise AssertionError(f"loadgen: {sessions}, {tenants}")
    emit({"phase": "session_tools", "config": {"dim": c.dim, "levels": c.levels},
          "session_check": {"exit_code": rc, **{k: report[k] for k in (
              "cold_iters", "frames", "batch", "threshold", "burn_in", "best_warm_iters",
              "half_target_iters", "half_target_met", "latency_ratio")},
              "sweep": report["sweep"]},
          "launches": launches,
          "loadgen_sessions": {"session": sessions["session"],
                               "latency_ms": sessions["latency_ms"]},
          "loadgen_tenants": {"per_tenant": tenants["per_tenant"],
                              "latency_ms": tenants["latency_ms"]},
          "time_note": "session_check: host clock around one graph-cache call a frame "
                       "(answer on the host); loadgen: HTTP round trips from its own process"})
    shutil.rmtree(ckpt, ignore_errors=True)
    return launches


def phase_faults(device) -> dict:
    """Fault injection on the card: Trainer.fit at flagship width, b=8, f32,
    "pallas" with the kernel backward and halt_on_nan, on the synthetic
    stream with data:nan_batch@3 and ckpt_write:torn@2 armed, a checkpoint a
    step (the main path: counts set to 0 just before, read just after): it
    raises NonFiniteError at step 3 after three steps' launches of K1-K4,
    K6 and K7; the loader then falls back from the torn step 2 to step 1;
    then a serving engine on that directory with reload:io_error*3 armed: a
    poll retries and backs off (the sleeps recorded) and fails, the next
    loads the newer step."""
    import io

    from glom_tpu_torch.resilience import faultinject
    from glom_tpu_torch.training.data import make_batches
    from glom_tpu_torch.training.trainer import NonFiniteError

    c = kernel_config()
    ckpt = os.path.join(ROOT, "build", "chip_smoke_faults_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    tc = TrainConfig(batch_size=BATCH, steps=FAULT_TRAIN_STEPS, log_every=1, seed=0,
                     halt_on_nan=True, checkpoint_dir=ckpt, checkpoint_every=1)
    stream = io.StringIO()
    trainer = Trainer(c, tc, device=device, logger=MetricLogger(stream=stream))
    batches = make_batches("synthetic", BATCH, c.image_size, seed=0, prefetch=0)
    reset_launches()
    with faultinject.injected("data:nan_batch@3;ckpt_write:torn@2") as plan:
        try:
            trainer.fit(batches)
        except NonFiniteError as e:
            halted = str(e)
        else:
            raise AssertionError("data:nan_batch@3: the trainer did not halt")
        fired = plan.summary()
    launches = launch_counts()
    t = denoise.resolve_loss_timestep(trainer.train_cfg, c.default_iters)
    check_launches("three train steps", launches, {
        "fused_level_update": 0, "grouped_ff": 6 * t, "grouped_ff_dx": 6 * t,
        "grouped_ff_dw": 6 * t, "consensus_attention": 3 * t, "consensus_dkv": 3 * t,
        "consensus_dq": 3 * t})
    if "at step 3" not in halted:
        raise AssertionError(f"halted: {halted}")
    step, _, _, _ = denoise.load_checkpoint_state(ckpt, device="cpu")
    quarantined = sorted(f for f in os.listdir(ckpt) if f.endswith(".corrupt"))
    if step != 1 or not quarantined:
        raise AssertionError(f"torn step 2: the loader took {step}, quarantined {quarantined}")

    slept = []
    engine = ServingEngine(ckpt, device=device, buckets=(1,), reload_poll_s=0,
                           sleep=slept.append)
    perturbed_step(ckpt, 5, seed=24, src=1)
    with faultinject.injected("reload:io_error*3"):
        first = engine.check_reload()
        second = engine.check_reload()
    failures = engine.registry.snapshot().get("serving_reload_failures")
    if first or not second or engine.step != 5 or failures != 3 or len(slept) != 2:
        raise AssertionError(f"reload:io_error*3: {first}, {second}, step {engine.step}, "
                             f"failures {failures}, sleeps {slept}")
    free_engines(engine)
    emit({"phase": "faults", "config": {"dim": c.dim, "levels": c.levels, "batch": BATCH},
          "nan_batch": {"halted": halted, "launches": launches, "plan": fired},
          "torn_save": {"loaded_step": step, "quarantined": quarantined},
          "reload_io_error": {"first_check": first, "second_check": second,
                              "reload_failures": failures, "backoff_sleeps_s": slept,
                              "step": 5}})
    shutil.rmtree(ckpt, ignore_errors=True)
    return launches


# -- the quality and capacity planes ------------------------------------------
QUALITY_BUCKETS = (1, 8)
# (ff_impl, quant) of the quality phase's engines
QUALITY_CASES = (("pallas", "f32"), ("fused", "f32"), ("pallas", "bf16"))
# /embed requests of each size, one after another: the latency plan run with
# quality_sample 1.0 and 0.0
QUALITY_PLAN = {1: 40, 8: 20}


def signal_groups(mat, L: int) -> dict:
    """A (b, 3L+1) quality signal matrix by column group."""
    return {"agreement": mat[:, :L], "entropy": mat[:, L:2 * L], "norm": mat[:, 2 * L:3 * L],
            "residual": mat[:, 3 * L:]}


def plain_quality_fn(engine):
    """``engine``'s quality post-pass on the plain path in the engine's own
    quant mode (the same weights, dequantized the same way)."""
    from glom_tpu_torch.obs.quality import make_quality_fn
    from glom_tpu_torch.serving import quant

    cfg = plain_of(engine.serve_config)
    consensus_fn, ff_fn, fused_fn = glom_model.resolve_step_fns(cfg, engine.device)
    return quant.quantized_forward(
        make_quality_fn(cfg, engine.train_cfg, None, consensus_fn=consensus_fn, ff_fn=ff_fn,
                        fused_fn=fused_fn), engine.quant)


def quality_engine_report(engine, impl: str, mode: str, x: dict, *, timing: bool) -> tuple:
    """One quality-phase engine: every bucket's quality replay bitwise its
    eager post-pass; the b=8 signals against the plain path per column group
    (f32: max-abs SERVE_ATOL; bf16: BF16_PATH_RTOL of the group's largest
    value); the launches one replay records; then the main path, a b=1 and a
    b=8 /embed batch each sampled and post-passed (counts set to 0 just
    before, read just after the post-pass): the /embed forward's and the
    quality replay's launches exactly; the replay times (CUDA events) and
    the pools.  Returns ``(report, main-path launches)``."""
    c = engine.config
    L, iters, q_it = c.levels, engine.embed_iters, engine._program.quality_iters
    quality = engine.caches["quality"]
    for b in QUALITY_BUCKETS:
        if not np.array_equal(engine.run("quality", x[b]), engine.run_eager("quality", x[b])):
            raise AssertionError(f"quality {impl}/{mode} b={b}: the replay differs from the "
                                 f"eager post-pass")
    got = engine.run("quality", x[8])
    with torch.inference_mode():
        plain = plain_quality_fn(engine)(engine.params,
                                         torch.from_numpy(x[8]).to(engine.device)).cpu().numpy()
    errors = {}
    for name, g in signal_groups(got, L).items():
        w = signal_groups(plain, L)[name]
        err = float(np.abs(g - w).max())
        errors[name] = err if mode == "f32" else err / float(np.abs(w).max())
    limit = SERVE_ATOL if mode == "f32" else BF16_PATH_RTOL
    if not (np.isfinite(got).all() and max(errors.values()) <= limit):
        raise AssertionError(f"quality {impl}/{mode}: signals from the plain path {errors} "
                             f"(limit {limit})")
    per_quality = ({**want_launches(0), "fused_level_update": q_it} if impl == "fused"
                   else want_launches(q_it))
    per_embed = ({**want_launches(0), "fused_level_update": iters} if impl == "fused"
                 else want_launches(iters))
    recorded = quality.launches_per_replay()
    for b in QUALITY_BUCKETS:
        if {**{k: 0 for k in per_quality}, **recorded[b]} != per_quality:
            raise AssertionError(f"quality {impl}/{mode} b={b}: a replay records {recorded[b]}, "
                                 f"expected {per_quality}")
    engine.start(watch=False)
    main = {k: 0 for k in kernel_wrappers()}
    for b in QUALITY_BUCKETS:
        observed = engine.quality.observed
        reset_launches()
        engine.submit("embed", x[b]).result(timeout=120)
        wait_quality(engine, observed + 1)
        launches = check_launches(f"quality {impl}/{mode} /embed b={b} and its post-pass",
                                  launch_counts(),
                                  {k: per_embed[k] + per_quality[k] for k in per_embed})
        for k, n in launches.items():
            main[k] += n
    snap = engine.registry.snapshot()
    if snap.get("serving_graph_captures") or snap.get("quality_post_pass_failures"):
        raise AssertionError(f"quality {impl}/{mode}: captures "
                             f"{snap.get('serving_graph_captures')}, post-pass failures "
                             f"{snap.get('quality_post_pass_failures')}")
    report = {"signals_vs_plain": errors, "limit": limit,
              "signals_vs_plain_rule": "max-abs" if mode == "f32" else "max-abs / max|plain|",
              "bitwise_replay": list(QUALITY_BUCKETS),
              "launches_per_quality_replay": per_quality,
              "launches_main": main, "signals_b8_mean": {
                  k: float(v.mean()) for k, v in signal_groups(got, L).items()},
              "quality_capture_seconds": quality.warmup_seconds,
              "pool_bytes": engine.graph_pool_bytes(), "param_bytes": engine.param_bytes(),
              "quality_replay_device_ms": {f"b{b}": replay_ms(quality, b)
                                           for b in QUALITY_BUCKETS},
              "graph_captures": snap.get("serving_graph_captures", 0),
              "post_pass_failures": snap.get("quality_post_pass_failures", 0)}
    if timing:
        report["embed_replay_device_ms"] = {f"b{b}": replay_ms(engine.caches["embed"], b)
                                            for b in QUALITY_BUCKETS}
    return report, main


def embed_plan_ms(engine, x: dict) -> dict:
    """QUALITY_PLAN's /embed requests through ``engine.submit``, one after
    another (host clock, submit to the answer; after two warm-up requests a
    size): p50/p95 by size."""
    out = {}
    for b, n in QUALITY_PLAN.items():
        embed_ms(engine, x[b], 2)
        out[f"b{b}"] = latency_block(embed_ms(engine, x[b], n))
    return out


def phase_quality(device) -> dict:
    """The quality plane at flagship width, buckets 1 and 8, quality_sample
    at the default 1.0: engines on "pallas" f32, "fused" f32 and "pallas"
    bf16 (quality_engine_report: each quality replay bitwise its eager
    post-pass, the signals against the plain path, exact launches a sampled
    batch, no capture and no failed post-pass, replay times and pools); on
    the f32 "pallas" engine a shadow deploy of another checkpoint step whose
    deploy_shadow_agreement must be the candidate's own post-pass; the
    /embed b=1 and b=8 latency plan with quality_sample 1.0 and 0.0; and the
    quality smoke (tools/quality_report.py's loop) at flagship."""
    from glom_tpu_torch.tools import quality_report

    ckpt = flagship_ckpt("chip_smoke_quality_ckpt", seed=25)
    c = kernel_config()
    shape = (c.channels, c.image_size, c.image_size)
    rng = np.random.default_rng(26)
    x = {b: rng.standard_normal((b,) + shape).astype(np.float32) for b in QUALITY_BUCKETS}
    engines, total, latency = {}, {k: 0 for k in kernel_wrappers()}, {}
    for impl, mode in QUALITY_CASES:
        t0 = time.perf_counter()
        engine = ServingEngine(ckpt, device=device, ff_impl=impl, quant=mode,
                               buckets=QUALITY_BUCKETS, reload_poll_s=0)
        setup_s = time.perf_counter() - t0
        report, main = quality_engine_report(engine, impl, mode, x,
                                             timing=(impl, mode) == ("pallas", "f32"))
        report["setup_seconds"] = setup_s
        for k, n in main.items():
            total[k] += n
        if (impl, mode) == ("pallas", "f32"):
            latency["quality_sample_1.0"] = embed_plan_ms(engine, x)
            report["shadow"] = shadow_agreement(engine, ckpt, c, x[8])
        engines[f"{impl}/{mode}"] = report
        free_engines(engine)
    off = ServingEngine(ckpt, device=device, buckets=QUALITY_BUCKETS, reload_poll_s=0,
                        quality_sample=0.0)
    off.start(watch=False)
    latency["quality_sample_0.0"] = embed_plan_ms(off, x)
    if "quality" in off.caches or off.quality.observed:
        raise AssertionError("quality_sample=0.0 built a quality family or sampled")
    off_pools = off.graph_pool_bytes()
    free_engines(off)
    t0 = time.perf_counter()
    smoke = quality_report.run_smoke(str(device), checkpoint_dir=ckpt, buckets=QUALITY_BUCKETS)
    smoke_s = time.perf_counter() - t0
    if smoke["smoke"] != "ok":
        raise AssertionError(f"quality smoke at flagship: {smoke}")
    emit({"phase": "quality", "config": {"dim": c.dim, "levels": c.levels, "iters":
                                         c.default_iters, "buckets": list(QUALITY_BUCKETS),
                                         "quality_sample": 1.0},
          "engines": engines, "embed_latency_ms": latency, "plan": QUALITY_PLAN,
          "pool_bytes_quality_sample_0": off_pools, "smoke": smoke, "smoke_seconds": smoke_s,
          "launches": total,
          "time_note": "quality/embed_replay_device_ms: CUDA events over graph replays "
                       "(time_ms); embed_latency_ms: host clock of engine.submit to the answer, "
                       "requests one after another, the batch's post-pass running on the "
                       "worker after its answer (so it delays the next request)"})
    shutil.rmtree(ckpt, ignore_errors=True)
    return total


def shadow_agreement(engine, ckpt: str, c, x8) -> dict:
    """A shadow deploy of step 1 (other seeded weights) on ``engine``: one
    mirrored b=8 batch pumped by hand; deploy_shadow_agreement must be the
    candidate's own quality family's agreement on it (its replay bitwise its
    eager post-pass), not the primary's."""
    make_demo_checkpoint(ckpt, config=c, seed=27, step=1)
    if engine.deploy.begin_shadow(step=1) != 1:
        raise AssertionError("quality shadow: step 1 did not become the candidate")
    try:
        stop_shadow_thread(engine)
        with engine.deploy._shadow_cv:
            engine.deploy._shadow_q.clear()
        cand = engine.deploy.candidate(1)
        observed = engine.quality.observed
        engine.submit("embed", x8).result(timeout=120)
        wait_quality(engine, observed + 1)
        with engine.deploy._shadow_cv:
            item = engine.deploy._shadow_q.popleft()
        if not engine.deploy.process_shadow(*item):
            raise AssertionError("quality shadow: the mirrored batch did not run")
        cache = cand.caches.caches["quality"]
        own = cache.eager(cand.params, x8)
        if cache is engine.caches["quality"] or not np.array_equal(cache(cand.params, x8), own):
            raise AssertionError("quality shadow: the candidate's family is not its own")
        L = c.levels
        gauge = engine.registry.snapshot()["deploy_shadow_agreement"]
        primary = float(engine.run_eager("quality", x8)[:, :L].mean())
        if gauge != round(float(own[:, :L].mean()), 6):
            raise AssertionError(f"quality shadow: deploy_shadow_agreement {gauge}, the "
                                 f"candidate's post-pass {own[:, :L].mean()}")
        return {"deploy_shadow_agreement": gauge, "candidate_post_pass": float(
            own[:, :L].mean()), "primary_post_pass": primary,
            "candidate_quality_pool_bytes": cache.pool_bytes()}
    finally:
        engine.deploy.abort()


CAPACITY_LADDER = 2
CAPACITY_CLOSED_S = 2.0
CAPACITY_CEILING_S = 1.5
# a utilization against this run's own closed-loop rate: above 0, and at most
# the rate itself with a margin for the windows' edges
UTIL_MAX = 1.05


@contextlib.contextmanager
def replay_events(engine):
    """CUDA events around every graph replay while the block runs, and the
    engine's execute-span total before and after: yields a dict filled at
    exit with the window's host seconds, the execute span's milliseconds and
    the replays' milliseconds by family (the endpoints' and the quality
    post-pass's), twice: between the events around each replay (which also
    hold any wait of the device for the host to launch the replay once the
    start event has run), and as each (family, bucket) graph's replay time
    alone (time_ms) times the replays the window made of it."""
    from glom_tpu_torch.serving import compile_cache

    events, original = [], compile_cache._Graph.replay

    def replay(graph):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        original(graph)
        end.record()
        events.append((graph, start, end))

    rec = {}
    span0 = engine.registry.snapshot().get("serving_execute_ms_sum", 0.0)
    t0 = time.monotonic()
    compile_cache._Graph.replay = replay
    try:
        yield rec
    finally:
        compile_cache._Graph.replay = original
    window_s = time.monotonic() - t0
    torch.cuda.synchronize()
    family = {id(g): (name, str(key)) for name, cache in engine.caches.items()
              for key, g in cache._graphs.items()}
    by_family, per_replay, made = {}, [], {}
    for graph, start, end in events:
        name, key = family.get(id(graph), ("other", "?"))
        ms = start.elapsed_time(end)
        by_family[name] = by_family.get(name, 0.0) + ms
        per_replay.append([name, key, round(ms, 3)])
        made[(name, key)] = made.get((name, key), 0) + 1
    # the window's traffic is /embed: its family and the quality family,
    # both keyed by bucket
    alone = {(name, key): replay_ms(engine.caches[name], int(key)) for name, key in made
             if key.isdigit()}
    alone_by_family = {}
    for (name, key), ms in alone.items():
        alone_by_family[name] = alone_by_family.get(name, 0.0) + made[(name, key)] * ms
    span_ms = engine.registry.snapshot().get("serving_execute_ms_sum", 0.0) - span0
    endpoint_ms = sum(v for k, v in by_family.items() if k != "quality")
    rec.update({"window_s": window_s, "execute_span_ms": span_ms, "replays": len(events),
                "replay_device_ms": by_family, "per_replay": per_replay,
                "replay_alone_ms": {f"{name}/{key}": ms for (name, key), ms in alone.items()},
                "replays_timed_alone_ms": alone_by_family,
                "duty_from_replays_timed_alone": sum(alone_by_family.values()) / 1e3 / window_s,
                "duty_from_execute_span": span_ms / 1e3 / window_s,
                "duty_from_endpoint_replays": endpoint_ms / 1e3 / window_s,
                "duty_from_all_replays": sum(by_family.values()) / 1e3 / window_s})


def phase_capacity(device) -> dict:
    """The capacity plane at flagship width: (1) the capacity smoke
    (tools/capacity.py's loop, buckets 1 and 8): a burst recommends
    scale_up within the persist windows, capacity_pressure fires once,
    quiescence flips to scale_down, /capacity and /debug/series over HTTP,
    no utilization without a ceiling, no capture; (2) a "pallas" server
    with a trace log under the loadgen's closed loop (its own process, batch
    sizes 1-8, concurrency 8; the main path: counts set to 0 just before,
    read just after), the plane ticked on the host's clock before and after:
    capacity_duty_cycle beside the CUDA-event time of the replays in that
    window, and no capacity_utilization; the same loop against a server
    started with --quality-sample 0; (3) trace_report --suggest-buckets
    on that trace log; (4) a server started with --buckets-file on its
    ladder and --capacity-ceiling at (2)'s closed-loop images/s, under a
    shorter closed loop: a utilization in (0, UTIL_MAX], no capture after
    warm-up."""
    from glom_tpu_torch.serving import server as server_mod
    from glom_tpu_torch.tools import capacity as capacity_tool

    ckpt = flagship_ckpt("chip_smoke_capacity_ckpt", seed=28)
    c = kernel_config()
    t0 = time.perf_counter()
    smoke = capacity_tool.run_smoke(str(device), checkpoint_dir=ckpt, buckets=QUALITY_BUCKETS)
    smoke_s = time.perf_counter() - t0
    if smoke["smoke"] != "ok":
        raise AssertionError(f"capacity smoke at flagship: {smoke}")

    log = os.path.join(ROOT, "build", "chip_smoke_capacity_trace.jsonl")
    if os.path.exists(log):
        os.remove(log)
    engine = ServingEngine(ckpt, device=device, reload_poll_s=0, trace_log=log,
                           capacity_policy="p95_ms<250,duty<0.85,shed<0.01")
    engine.start(watch=False)
    server = make_server(engine, port=0)
    thread = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05})
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    prime = {"images": np.random.default_rng(29).standard_normal(
        (1, c.channels, c.image_size, c.image_size)).astype(np.float32).tolist()}
    try:
        # one request before the first tick: the window's first point must
        # hold the serving series the plane takes deltas of
        post(base + "/embed", prime)
        engine.capacity.tick()
        reset_launches()
        with replay_events(engine) as window:
            closed = run_loadgen(base, "--concurrency", LOAD_CONCURRENCY,
                                 "--duration", CAPACITY_CLOSED_S)
            time.sleep(1.0)      # the plane samples at most once a second
            engine.capacity.tick()
        launches = launch_counts()
        summary = engine.capacity.summary()
        cap = get(base + "/capacity")
        names = get(base + "/debug/series")["names"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        free_engines(engine)
    signals = summary["signals"]
    rate = closed["throughput_imgs_per_s"]
    if closed["requests_error"] or not signals.get("duty") or signals.get("util") is not None \
            or "capacity_utilization" in names or cap["role"] != "replica":
        raise AssertionError(f"capacity under load: {closed}, {summary}")
    if not (launches["grouped_ff"] and launches["consensus_attention"]):
        raise AssertionError(f"capacity under load: launches {launches}")

    # the same closed loop against a server with --quality-sample 0: what the
    # default sampling costs the loop's images/s, in the same call
    args = server_mod.parse_args(["--checkpoint-dir", ckpt, "--quality-sample", "0",
                                  "--reload-poll-s", "0"])
    engine = server_mod.engine_from_args(args, device=device)
    engine.start(watch=False)
    server = make_server(engine, port=0)
    thread = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05})
    thread.start()
    try:
        unsampled = run_loadgen("http://127.0.0.1:%d" % server.server_address[1],
                                "--concurrency", LOAD_CONCURRENCY, "--duration",
                                CAPACITY_CLOSED_S)
        sampled_none = "quality" not in engine.caches and not engine.quality.observed
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        free_engines(engine)
    if unsampled["requests_error"] or not sampled_none:
        raise AssertionError(f"--quality-sample 0: {unsampled}, quality family or samples left")

    proc = subprocess.run([sys.executable, "-m", "glom_tpu_torch.tools.trace_report", log,
                           "--suggest-buckets", "--ladder-size", str(CAPACITY_LADDER)],
                          capture_output=True, text=True, timeout=300, cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": os.pathsep.join(
                              p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)})
    if proc.returncode:
        raise AssertionError(f"trace_report --suggest-buckets exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    ladder = json.loads(proc.stdout)
    ladder_file = os.path.join(ROOT, "build", "chip_smoke_ladder.json")
    with open(ladder_file, "w") as f:
        json.dump(ladder, f)

    args = server_mod.parse_args(["--checkpoint-dir", ckpt, "--buckets-file", ladder_file,
                                  "--capacity-ceiling", repr(rate), "--reload-poll-s", "0"])
    engine = server_mod.engine_from_args(args, device=device)
    engine.start(watch=False)
    server = make_server(engine, port=0)
    thread = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05})
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        post(base + "/embed", prime)
        engine.capacity.tick()
        again = run_loadgen(base, "--concurrency", LOAD_CONCURRENCY,
                            "--duration", CAPACITY_CEILING_S)
        time.sleep(1.0)
        engine.capacity.tick()
        ceiling_summary = engine.capacity.summary()
        ceiling_cap = get(base + "/capacity")
        captures = engine.registry.snapshot().get("serving_graph_captures", 0)
        buckets = list(engine.buckets)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        free_engines(engine)
    util = ceiling_summary["signals"].get("util")
    if (buckets != ladder["suggested_buckets"] or captures or again["requests_error"]
            or util is None or not 0 < util <= UTIL_MAX
            or ceiling_cap["recommendation"]["signals"].get("ceiling_imgs_per_sec") != rate):
        raise AssertionError(f"--buckets-file / --capacity-ceiling: buckets {buckets}, ladder "
                             f"{ladder}, captures {captures}, util {util}, {again}")
    emit({"phase": "capacity", "config": {"dim": c.dim, "levels": c.levels,
                                          "ff_impl": "pallas", "quality_sample": 1.0},
          "smoke": smoke, "smoke_seconds": smoke_s,
          "closed_loop": {k: closed[k] for k in ("mode", "requests_ok", "images_ok",
                                                  "throughput_imgs_per_s", "latency_ms")},
          "closed_loop_quality_sample_0": {k: unsampled[k] for k in (
              "requests_ok", "images_ok", "throughput_imgs_per_s", "latency_ms")},
          "capacity_signals": signals, "duty_window": window,
          "suggested": ladder, "ladder_file_buckets": buckets,
          "ceiling_imgs_per_s": rate, "ceiling_closed_loop": {
              k: again[k] for k in ("requests_ok", "throughput_imgs_per_s", "latency_ms")},
          "utilization": util, "utilization_max": UTIL_MAX,
          "graph_captures_after_warmup": captures, "launches": launches,
          "time_note": "duty_window: capacity_duty_cycle is the execute span's milliseconds "
                       "over the plane's window (two ticks on the host's clock); the replays' "
                       "device milliseconds are CUDA events around every graph replay in the "
                       "same window (endpoints, and the quality post-pass the span leaves out)"})
    shutil.rmtree(ckpt, ignore_errors=True)
    return launches


# the bulk phase: an idle-only job at flagship, buckets 1/2/4/8
BULK_IDLE_SLOTS = 384
# the kill-and-resume job: not a multiple of the largest bucket (8)
BULK_RESUME_SLOTS = 37
# the job kept active under the closed loop (two shards: one can be
# scavenged while the idle thread runs the other), cancelled after it
BULK_LOAD_SLOTS = 4096
BULK_PLAN_REQUESTS = 100
BULK_B1_REQUESTS = 100
BULK_TIMEOUT_S = 300.0
# the predictions of PERF.md §6 for the bulk tier with the slots drawn
# ahead on the runner's host thread and the idle buckets' grace after online
# work, from the /embed b=8 replay of about 25.4 ms and the host work
# measured beside it: a chunk costs its replay, the cache call's copies, the
# stack and the part write with the cursor, about 29-35 ms, so 230-280
# slots/s; a closed loop meets no idle replay but at its first request, so
# its p50 rises by the host threads' competition alone
BULK_PREDICTED = {"idle_slots_per_s": [230.0, 280.0], "share_of_replay_bound": [0.73, 0.88],
                  "b1_p50_rise_ms": [0.0, 3.0], "b1_p99_rise_ms": [0.0, 30.0],
                  "loop_p50_rise_ms": [0.0, 3.0], "loop_p99_rise_ms": [0.0, 30.0],
                  "scavenged_answers": "bitwise", "pool_bytes": "unchanged"}


def wait_job(engine, name: str, timeout_s: float = BULK_TIMEOUT_S) -> float:
    """Seconds until bulk job ``name`` is done on ``engine``; a bulk bucket
    that raised fails the phase."""
    t0 = time.perf_counter()
    while engine.bulk.status(name)["status"] != "done":
        errors = engine.registry.snapshot().get("bulk_batch_errors_total")
        if errors or time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"bulk job {name}: {engine.bulk.status(name)}, {errors} "
                                 f"bucket errors")
        time.sleep(0.001)
    return time.perf_counter() - t0


def bucket_offset_bits(engine, family: str, ds) -> dict:
    """One slot at every row offset of buckets 1, 2, 4 and 8 beside other
    slots, against its answer at bucket 8, offset 0: the max-abs difference
    of each (bucket, offset), and whether each is bitwise."""
    ref = engine.run(family, ds.read(0, 8))[0]
    slot = ds.read(0, 1)[0]
    worst = {}
    for bucket in GRAPH_BUCKETS:
        for off in range(bucket):
            imgs = ds.read(8 + off, 8 + off + bucket).copy()
            imgs[off] = slot
            worst[f"b{bucket}/o{off}"] = float(np.abs(engine.run(family, imgs)[off] - ref).max())
    return {"max_abs_vs_b8_o0": worst,
            "bitwise": sorted(k for k, v in worst.items() if v == 0.0),
            "bitwise_within_each_bucket": {
                f"b{b}": len({worst[f"b{b}/o{o}"] for o in range(b)}) == 1
                for b in GRAPH_BUCKETS}}


def phase_bulk(device) -> dict:
    """The bulk tier at flagship width, f32 "pallas", buckets 1/2/4/8 (one
    engine with a job store, its idle thread running): (1) an idle-only
    synthetic /embed job of BULK_IDLE_SLOTS slots (the main path: counts set
    to 0 just before the submit, read when it is done): slots/s on the host's
    clock, each chunk's device time by CUDA events around its replay, the
    share of the replay bound (8 slots a b=8 replay), launches exactly K1 24
    + K4 12 a bucket replay, no capture, the first chunk bitwise the engine's
    own replay and within SERVE_ATOL of the plain path; (2) the kill-and-
    resume smoke (tools/bulk_run.py) at flagship: bitwise the control, no
    capture; (3) a closed loop of one client, BULK_PLAN_REQUESTS requests of
    1-7 images, without and then with a BULK_LOAD_SLOTS-slot job active: the
    answers bitwise, bulk_scavenged_slots_total above 0, the loop's launches
    those of the run without a job plus K1 24 + K4 12 for each idle bucket
    the job ran meanwhile, the loop's p50/p99 and /embed b=1 p50/p99 over
    BULK_B1_REQUESTS (host clock) with and without the job; (4) an index job over INDEX_IMAGES slots, then
    /similar over its sink (similar_report: each image its own top-1 at
    level 0); (5) the bucket and offset bit check on "pallas" (/embed and the
    index forward) and "fused" (/embed), reported."""
    from glom_tpu_torch.bulk.jobs import BulkJobSpec, ChunkSink, SlotDataset
    from glom_tpu_torch.tools import bulk_run

    ckpt = flagship_ckpt("chip_smoke_bulk_ckpt", seed=31)
    work = os.path.join(ROOT, "build", "chip_smoke_bulk")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "index"))
    c = kernel_config()
    L = c.levels
    engine = ServingEngine(ckpt, device=device, buckets=GRAPH_BUCKETS, reload_poll_s=0,
                           bulk_dir=os.path.join(work, "store"),
                           index_dir=os.path.join(work, "index"))
    engine.start(watch=False)
    pools_before = engine.graph_pool_bytes()
    report = {}
    try:
        # (1) idle buckets alone
        idle = {"name": "idle", "dataset": f"synthetic:{BULK_IDLE_SLOTS}", "transform": "embed",
                "sink": os.path.join(work, "idle_out"), "seed": 32}
        reset_launches()
        with replay_events(engine) as window:
            t0 = time.perf_counter()
            engine.bulk.submit(idle)
            wait_job(engine, "idle")
            idle_s = time.perf_counter() - t0
            launches = launch_counts()
        chunks = window["per_replay"]
        check_launches("bulk idle job", launches, want_launches(c.default_iters * len(chunks)))
        out = ChunkSink(idle["sink"]).assemble(BULK_IDLE_SLOTS)
        ds = SlotDataset(BulkJobSpec(**idle, image_size=c.image_size))
        first = engine.run("embed", ds.read(0, 8))
        with torch.inference_mode():
            plain = plain_embed_fn(engine)(engine.params,
                                           torch.from_numpy(ds.read(0, 8)).to(device)).cpu()
        plain_err = float((torch.from_numpy(out[:8]) - plain).abs().max())
        snap = engine.registry.snapshot()
        if (out.shape != (BULK_IDLE_SLOTS, L, c.dim) or not np.isfinite(out).all()
                or out[:8].tobytes() != first.tobytes() or plain_err > SERVE_ATOL
                or snap.get("bulk_idle_slots_total") != BULK_IDLE_SLOTS
                or snap.get("bulk_scavenged_slots_total") or snap.get("serving_graph_captures")
                or len(chunks) != -(-BULK_IDLE_SLOTS // 8)):
            raise AssertionError(f"bulk idle job: shape {out.shape}, plain {plain_err}, "
                                 f"{len(chunks)} chunks, {snap}")
        b8_ms = replay_ms(engine.caches["embed"], 8)
        # a chunk's host work, piece by piece (host clock, the median of 5
        # after a warm-up): the eight slots' draws, the cache call around the
        # replay (the copies in and out), and the part write with the
        # cursor's advance into a scratch store
        from glom_tpu_torch.bulk.jobs import JobStore

        scratch = JobStore(os.path.join(work, "scratch_store"))
        scratch.submit(BulkJobSpec(name="s", dataset="synthetic:48", sink=work, seed=0,
                                   image_size=c.image_size), total=48)
        sink, cursor = ChunkSink(os.path.join(work, "scratch_out")), [0]

        def commit():
            sink.write(cursor[0], cursor[0] + 8, out[:8])
            scratch.advance("s", 0, cursor[0] + 8)
            cursor[0] += 8

        x8 = ds.read(0, 8)
        host = {"read_8_slots": served_ms(lambda: ds.read(8, 16)),
                "cache_call_b8": served_ms(lambda: engine.run("embed", x8)),
                "part_write_and_advance": served_ms(commit)}
        rate = BULK_IDLE_SLOTS / idle_s
        bound_rate = 8 / (b8_ms / 1e3)
        chunk_ms = [ms for _, _, ms in chunks]
        report["idle"] = {
            "slots": BULK_IDLE_SLOTS, "seconds": idle_s, "slots_per_s": rate,
            "replay_bound_slots_per_s": bound_rate, "share_of_replay_bound": rate / bound_rate,
            "embed_b8_replay_ms": b8_ms, "chunks": len(chunks),
            "chunk_device_ms": {"median": statistics.median(chunk_ms), "min": min(chunk_ms),
                                "max": max(chunk_ms), "all": chunk_ms},
            "chunk_host_ms_mean": (idle_s * 1e3 - sum(chunk_ms)) / len(chunks),
            "chunk_host_ms_parts": host,
            "device_busy_share": sum(chunk_ms) / (idle_s * 1e3),
            "first_chunk_vs_plain_max_abs_err": plain_err, "atol": SERVE_ATOL,
            "launches": launches}
        emit({"phase": "bulk", "part": "idle", **report["idle"]})
        main_launches = launches

        # (2) kill and resume, bitwise
        smoke = bulk_run.run_smoke(str(device), checkpoint_dir=ckpt, buckets=GRAPH_BUCKETS,
                                   total=BULK_RESUME_SLOTS, workdir=work)
        ref, got = smoke.pop("outputs")
        if smoke["smoke"] != "ok" or not np.isfinite(ref).all():
            raise AssertionError(f"bulk kill-and-resume at flagship: {smoke}")
        smoke["control_first_chunk_bitwise_this_engine"] = ref[:8].tobytes() == engine.run(
            "embed", SlotDataset(BulkJobSpec(
                name="smoke", dataset=f"synthetic:{BULK_RESUME_SLOTS}", sink=work,
                seed=bulk_run.SMOKE_SEED, image_size=c.image_size)).read(0, 8)).tobytes()
        report["kill_and_resume"] = smoke
        emit({"phase": "bulk", "part": "kill_and_resume", **smoke})

        # (3) scavenging under a closed loop of one client
        rng = np.random.default_rng(33)
        shape = (c.channels, c.image_size, c.image_size)
        plan = [rng.standard_normal((int(k),) + shape).astype(np.float32)
                for k in rng.integers(1, 8, BULK_PLAN_REQUESTS)]
        x1 = rng.standard_normal((1,) + shape).astype(np.float32)

        def idle_slots():
            return engine.registry.snapshot().get("bulk_idle_slots_total", 0)

        def loop(job=None):
            """The plan's answers, each answer's host-clock ms, the loop's
            launches and the idle buckets the job ran meanwhile (the job
            paused, its chunks in flight settled, at both edges of the
            count; each idle bucket a whole chunk of GRAPH_BUCKETS[-1]
            slots while no shard reaches its end)."""
            observed = engine.quality.observed
            if job:
                engine.bulk.pause(job, wait=True)
            reset_launches()
            idle0 = idle_slots()
            if job:
                engine.bulk.resume(job)
            answers, ms = [], []
            for x in plan:
                t0 = time.perf_counter()
                answers.append(engine.submit("embed", x).result(timeout=120))
                ms.append((time.perf_counter() - t0) * 1e3)
            wait_quality(engine, observed + len(plan))
            if job:
                engine.bulk.pause(job, wait=True)
                ends = [s for s in engine.bulk.status(job)["shards"] if s["cursor"] >= s["hi"]]
                if ends:
                    raise AssertionError(f"bulk: a shard of {job!r} ended in the loop {ends}")
            launches, idle = launch_counts(), idle_slots() - idle0
            if job:
                engine.bulk.resume(job)
            if idle % GRAPH_BUCKETS[-1]:
                raise AssertionError(f"bulk: {idle} idle slots in the loop, not whole buckets")
            return answers, ms, launches, idle // GRAPH_BUCKETS[-1]

        none_answers, none_ms, none_launches, _ = loop()
        none_b1 = embed_ms(engine, x1, BULK_B1_REQUESTS)
        load = {"name": "load", "dataset": f"synthetic:{BULK_LOAD_SLOTS}", "transform": "embed",
                "sink": os.path.join(work, "load_out"), "seed": 34}
        half = BULK_LOAD_SLOTS // 2
        engine.bulk.submit({**load, "shard": [0, half]})
        engine.bulk.submit({**load, "shard": [half, BULK_LOAD_SLOTS]})
        job_answers, job_ms, job_launches, idle_buckets = loop("load")
        observed = engine.quality.observed
        job_b1 = embed_ms(engine, x1, BULK_B1_REQUESTS)
        # neither the last request's post-pass nor a chunk of the job may
        # replay inside the index job's count below
        wait_quality(engine, observed + BULK_B1_REQUESTS)
        status = engine.bulk.pause("load", wait=True)
        engine.bulk.cancel("load")
        snap = engine.registry.snapshot()
        per_replay = want_launches(c.default_iters)
        expected = {k: none_launches[k] + idle_buckets * per_replay[k] for k in none_launches}
        mismatched = [i for i, (a, b) in enumerate(zip(none_answers, job_answers))
                      if a.tobytes() != b.tobytes()]
        scavenged = snap.get("bulk_scavenged_slots_total", 0)
        if (mismatched or not scavenged or job_launches != expected
                or status["status"] == "done" or snap.get("serving_graph_captures")):
            raise AssertionError(f"bulk scavenging: answers differ at {mismatched}, scavenged "
                                 f"{scavenged}, launches {job_launches} against {expected}, "
                                 f"job {status['status']}")
        report["scavenging"] = {
            "requests": BULK_PLAN_REQUESTS, "images": sum(len(x) for x in plan),
            "answers_bitwise_without_job": True, "bulk_scavenged_slots_total": scavenged,
            "bulk_idle_slots_total_all_phase": snap.get("bulk_idle_slots_total"),
            "idle_buckets_during_loop": idle_buckets,
            "launches_without_job": none_launches, "launches_with_job": job_launches,
            "load_job_done_before_cancel": status["done"],
            "loop_ms_without_job": latency_block(none_ms),
            "loop_ms_with_job": latency_block(job_ms),
            "loop_p50_rise_ms": pct(job_ms, 50) - pct(none_ms, 50),
            "loop_p99_rise_ms": pct(job_ms, 99) - pct(none_ms, 99),
            "embed_b1_ms_without_job": latency_block(none_b1),
            "embed_b1_ms_with_idle_job": latency_block(job_b1),
            "b1_p50_rise_ms": pct(job_b1, 50) - pct(none_b1, 50),
            "b1_p99_rise_ms": pct(job_b1, 99) - pct(none_b1, 99)}
        emit({"phase": "bulk", "part": "scavenging", **report["scavenging"]})

        # (4) the index build, then /similar over it
        index_dir = os.path.join(work, "index")
        spec = {"name": "index", "dataset": f"synthetic:{INDEX_IMAGES}", "transform": "index",
                "sink": index_dir, "seed": 35}
        reset_launches()
        engine.bulk.submit(spec)
        index_s = wait_job(engine, "index")
        index_launches = launch_counts()
        replays = -(-INDEX_IMAGES // 8)
        check_launches("bulk index job", index_launches,
                       want_launches(c.default_iters * replays))
        corpus = SlotDataset(BulkJobSpec(**spec, image_size=c.image_size)).read(0, INDEX_IMAGES)
        picks = [int(p) for p in np.random.default_rng(36).choice(INDEX_IMAGES, SIMILAR_QUERIES,
                                                                   replace=False)]
        report["index"] = {"slots": INDEX_IMAGES, "seconds": index_s, "launches": index_launches,
                           "similar": similar_report(engine, corpus, picks, index_dir, L)}
        emit({"phase": "bulk", "part": "index", **report["index"]})

        # (5) the bucket and offset bit check
        bits_ds = SlotDataset(BulkJobSpec(name="bits", dataset="synthetic:24", sink=work,
                                          seed=37, image_size=c.image_size))
        report["bits"] = {"pallas/embed": bucket_offset_bits(engine, "embed", bits_ds),
                          "pallas/index": bucket_offset_bits(engine, "index", bits_ds)}
        report["pool_bytes_unchanged"] = engine.graph_pool_bytes() == pools_before
    finally:
        free_engines(engine)
    fused = ServingEngine(ckpt, device=device, ff_impl="fused", buckets=GRAPH_BUCKETS,
                          reload_poll_s=0, quality_sample=0)
    try:
        report["bits"]["fused/embed"] = bucket_offset_bits(fused, "embed", bits_ds)
    finally:
        free_engines(fused)
    emit({"phase": "bulk", "part": "bits", **report["bits"]})
    emit({"phase": "bulk", "card": nvidia_smi(),
          "config": {"dim": c.dim, "levels": L, "ff_impl": "pallas", "buckets": GRAPH_BUCKETS},
          "predicted": BULK_PREDICTED,
          "measured": {"idle_slots_per_s": report["idle"]["slots_per_s"],
                       "share_of_replay_bound": report["idle"]["share_of_replay_bound"],
                       "b1_p50_rise_ms": report["scavenging"]["b1_p50_rise_ms"],
                       "b1_p99_rise_ms": report["scavenging"]["b1_p99_rise_ms"],
                       "loop_p50_rise_ms": report["scavenging"]["loop_p50_rise_ms"],
                       "loop_p99_rise_ms": report["scavenging"]["loop_p99_rise_ms"],
                       "scavenged_answers": "bitwise",
                       "pool_bytes_unchanged": report["pool_bytes_unchanged"]},
          "launches": main_launches,
          "time_note": "slots_per_s: host clock from the submit to the job's done; "
                       "chunk_device_ms: CUDA events around each chunk's graph replay; "
                       "embed_b8_replay_ms: time_ms of the b=8 graph alone; b1 latencies: "
                       "host clock of engine.submit to the answer, one after another"})
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    return main_launches


def phase_attribution(device) -> dict:
    """whyslow's smoke (tools/whyslow.py) at flagship on "pallas", buckets 1
    and 2, through the kernels: baseline traffic over HTTP from four
    clients, then a canary at fraction 1.0 under candidate:delay; exactly
    one cause, the deploy_canary event at its step, queue_wait the majority
    phase, no capture on the request path, the op-diff plane None (the
    candidate's graphs come from the primary's program) and a byte-identical verdict on
    re-attribution.  The main path is the regression window: the counts
    are set to 0 once the candidate's graphs are captured and read after the
    smoke, so they hold replays alone (each /embed replay and each quality
    post-pass of 12 iterations: K1 24 + K4 12), and each count must be a
    whole, nonzero number of replays."""
    from glom_tpu_torch.tools import whyslow

    ckpt = flagship_ckpt("chip_smoke_attribution_ckpt", seed=38)
    t0 = time.perf_counter()
    report = whyslow.run_smoke(str(device), checkpoint_dir=ckpt, on_canary=reset_launches)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    per_replay = want_launches(kernel_config().default_iters)
    replays = {k: launches[k] // n for k, n in per_replay.items() if n}
    if (report["smoke"] != "ok"
            or any(launches[k] % n or not launches[k] for k, n in per_replay.items() if n)
            or any(launches[k] for k, n in per_replay.items() if not n)):
        raise AssertionError(f"attribution smoke at flagship: {report['checks']}, "
                             f"{report['requests']}, {report['verdict']['verdict']}, "
                             f"launches {launches} against {per_replay} a replay")
    verdict = report["verdict"]
    emit({"phase": "attribution", "card": nvidia_smi(), "seconds": seconds,
          "checks": report["checks"], "requests": report["requests"],
          "verdict": verdict["verdict"], "confidence": verdict["confidence"],
          "knee": verdict["knee"], "regression": verdict["regression"],
          "phases": verdict["phases"][:4], "causes": verdict["causes"],
          "op_diff": verdict["op_diff"], "launches": launches,
          "replays_in_window": replays})
    shutil.rmtree(ckpt, ignore_errors=True)
    return launches


# -- the fleet ------------------------------------------------------------------
FLEET_HOP_REQUESTS = 20
# clients of the fail-over and rollout loops: in this process, each parse of
# a 3 MB body holds the interpreter lock, and four clients starved the
# rollout's captures (110 s, a 6.6 s exclusive hold on the H100; two: 27.6-
# 42.6 s; PERF.md)
FLEET_CLIENTS = 1
FLEET_LOOP_S = 2.0
FLEET_AFFINITY_KEYS = 3
FLEET_AFFINITY_FRAMES = 8
FLEET_QUERIES = 4
FLEET_INDEX_SLOTS = 32
FLEET_TIMEOUT_S = 300.0
# the predictions written into PERF.md before the phase's first run
FLEET_PREDICTED = {"hop_p50_ms": [1.0, 5.0], "one_process_ratio": [0.9, 1.1],
                   "two_process_ratio": [1.5, 2.0], "replica_gb": [2.6, 3.0],
                   "phase_seconds": 150.0}


class FleetClients:
    """``n`` client threads posting ``body`` to ``url``'s /embed one after
    another until stopped: every answer's ``(sent, received, step,
    X-Served-By)`` on the host's clock, and every failure."""

    def __init__(self, url: str, body: bytes, n: int = FLEET_CLIENTS):
        self.url, self.body = url, body
        self.answers, self.errors = [], []
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, daemon=True) for _ in range(n)]
        for t in self._threads:
            t.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            req = urllib.request.Request(f"{self.url}/embed", data=self.body,
                                         headers={"Content-Type": "application/json"})
            sent = time.monotonic()
            try:
                with urllib.request.urlopen(req, timeout=FLEET_TIMEOUT_S) as r:
                    served = r.headers.get("X-Served-By")
                    step = json.loads(r.read())["step"]
                self.answers.append((sent, time.monotonic(), step, served))
            except Exception as e:  # recorded: the phase asserts there are none
                self.errors.append(repr(e))

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=FLEET_TIMEOUT_S)


def new_to_old(answers) -> list:
    """The answers that went back to an older step than one already
    received: each ``(sent, received, step, ...)`` sent after another's
    answer of a newer step had arrived.  A coordinated rollout leaves none
    (glom_tpu/serving/router.py: no client reads step N and is then served
    N-1 by a later request)."""
    received = sorted((r, step) for _, r, step, *_ in answers)
    out, newest, i = [], None, 0
    for sent, _, step, *_ in sorted(answers):
        while i < len(received) and received[i][0] < sent:
            newest = received[i][1] if newest is None else max(newest, received[i][1])
            i += 1
        if newest is not None and step < newest:
            out.append((sent, step, newest))
    return out


def merge_similar(answers, k: int):
    """glom_tpu's merge of per-replica /similar answers
    (glom_tpu/serving/router.py::FleetRouter.similar_fanout): per image, the
    candidates deduped by slot keeping the best score, ranked by (-score,
    slot), cut to k."""
    merged = None
    for payload in answers:
        if merged is None:
            merged = [dict() for _ in payload["results"]]
        for best, hits in zip(merged, payload["results"]):
            for hit in hits:
                slot, score = int(hit["slot"]), float(hit["score"])
                if slot not in best or score > best[slot]:
                    best[slot] = score
    return [[{"slot": s, "score": v} for s, v in sorted(best.items(),
                                                         key=lambda kv: (-kv[1], kv[0]))[:k]]
            for best in merged]


def fleet_closed_loop(url: str) -> dict:
    """The loadgen's closed loop against ``url`` (its own process, /embed,
    batch sizes 1-8, concurrency 8, FLEET_LOOP_S)."""
    return run_loadgen(url, "--concurrency", LOAD_CONCURRENCY, "--duration", FLEET_LOOP_S)


def bucket_replays(snapshots) -> dict:
    """Replays made per bucket between ``(before, after)`` registry
    snapshot pairs (one a replica): the per-bucket execute span counts."""
    out = {}
    for before, after in snapshots:
        for b in GRAPH_BUCKETS:
            key = f"serving_execute_ms_b{b}_count"
            out[b] = out.get(b, 0) + int(after.get(key, 0.0) - before.get(key, 0.0))
    return out


def busy_share(replays: dict, replay_alone_ms: dict, window_s: float) -> float:
    """The card's busy share over a loop: each bucket's replays (the /embed
    graph and, every batch being sampled at quality_sample 1.0, its quality
    post-pass) times that graph's replay time alone (CUDA events), over the
    loop's wall seconds."""
    return sum(n * replay_alone_ms[b] for b, n in replays.items()) / 1e3 / window_s


def start_server_process(ckpt: str, log_path: str):
    """``python -m glom_tpu_torch.serving.server`` on the card in a process
    of its own, on a free port, its output into ``log_path``."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)}
    with open(log_path, "w") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "glom_tpu_torch.serving.server", "--checkpoint-dir", ckpt,
             "--device", "cuda", "--port", "0", "--reload-poll-s", "0",
             "--buckets", ",".join(map(str, GRAPH_BUCKETS))],
            stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=env)


def served_url(proc, log_path: str) -> str:
    """The base URL of a server process once its ``serving`` line is out."""
    deadline = time.monotonic() + FLEET_TIMEOUT_S
    while time.monotonic() < deadline:
        with open(log_path) as f:
            lines = f.read().splitlines()
        for line in lines:
            if line.startswith("{") and '"serving"' in line:
                rec = json.loads(line)
                return f"http://{rec['host']}:{rec['port']}"
        if proc.poll() is not None:
            raise AssertionError(f"server process exited {proc.returncode}: "
                                 f"{lines[-20:]}")
        time.sleep(0.2)
    raise AssertionError("server process did not start serving in time")


def phase_fleet(device) -> dict:
    """The fleet at flagship width, f32 "pallas", buckets 1/2/4/8: the port's
    router (``glom_tpu_torch/serving/router.py``) in front of two replicas
    spawned in-process by its ``--spawn`` path (``_spawn_fleet``; each its
    own batcher, graph sets and parameters, one job store each, one shared
    index).  Each replica's memory (allocated on the card, its pools and
    parameters).  (1) an /embed through the router bitwise the direct answer
    of the replica that served it (``X-Served-By``) and within SERVE_ATOL of
    the plain path; (2) the main path, a window of routed requests (counts
    set to 0 just before, read just after): the launches exactly the served
    replays times K1 24 + K4 12, plus each sampled batch's quality post-pass
    (K1 2q + K4 q), no capture; (3) FLEET_AFFINITY_KEYS keys of
    FLEET_AFFINITY_FRAMES frames each with X-Affinity-Key, each key on one
    replica; (4) the hop: /embed b=1 p50/p99 direct and through the router,
    FLEET_HOP_REQUESTS each, in turns; (5) a closed loop (the loadgen, c=8,
    batch sizes 1-8) through a router over one replica and over both; (6)
    fail-over: r1's HTTP server shut down under FLEET_CLIENTS clients, no
    request fails, the router's timeline shows the ejection, and after the
    server restarts on its port, the re-admission; (7) a coordinated rollout
    to a new step under the clients: both replicas prepare off the request
    path (the captures made and the longest exclusive hold), and ordered by
    dispatch no answer goes from the new step back to the old (no request
    sent after a new-step answer arrived is answered from the old step);
    then a rollout whose r1 prepare fails through the port's ``reload``
    fault seam leaves both on the old step; (8) an index job submitted
    through the router, sharded over both replicas, then /similar through
    the router: each of FLEET_QUERIES images its own top-1 at level 0, and
    the merged top-k glom_tpu's merge of the two replicas' own answers; (9)
    the fleet observatory's console lists both replicas at the serving step;
    (10) two replicas as server processes on the one card behind a router:
    the same closed loop, with the card's busy share from the replays'
    CUDA-event times beside each loop's; (11) ``loadgen --smoke --fleet`` at
    flagship: the stitched trace's coverage at least 0.95, its spans and
    parent links; (12) ``capacity --smoke --fleet`` and ``quality_report
    --smoke --fleet`` at flagship."""
    from glom_tpu_torch.bulk.jobs import BulkJobSpec, SlotDataset
    from glom_tpu_torch.obs.observatory import FleetObservatory, TailSampler
    from glom_tpu_torch.resilience import faultinject
    from glom_tpu_torch.serving import compile_cache
    from glom_tpu_torch.serving import router as router_mod
    from glom_tpu_torch.tools import capacity as capacity_tool
    from glom_tpu_torch.tools import loadgen
    from glom_tpu_torch.tools import quality_report

    t_phase = time.perf_counter()
    ckpt = flagship_ckpt("chip_smoke_fleet_ckpt", seed=40)
    work = os.path.join(ROOT, "build", "chip_smoke_fleet")
    shutil.rmtree(work, ignore_errors=True)
    index_dir = os.path.join(work, "index")
    os.makedirs(index_dir)
    c = kernel_config()
    iters = c.default_iters
    shape = (c.channels, c.image_size, c.image_size)
    rng = np.random.default_rng(41)
    out = {"phase": "fleet", "card": nvidia_smi(), "predicted": FLEET_PREDICTED}
    parts, t_part = {}, [time.perf_counter()]

    def part_done(name: str) -> None:
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    # -- the fleet: two replicas through the router's --spawn path ----------
    mem0 = settled_memory(device)
    args = type("SpawnArgs", (), {
        "checkpoint_dir": ckpt, "demo": False, "buckets": ",".join(map(str, GRAPH_BUCKETS)),
        "max_wait_ms": 5.0, "quant": "f32", "warm_iters": None, "device": str(device),
        "bulk_dir": os.path.join(work, "store"), "index_dir": index_dir,
        "parse_thresholds": None, "host": "127.0.0.1"})()
    t0 = time.perf_counter()
    urls, members = router_mod._spawn_fleet(2, args)
    spawn_s = time.perf_counter() - t0
    mem1 = settled_memory(device)
    engines = [eng for eng, _ in members]
    # each replica's own bytes: its graph pools and its parameters (the
    # card's reserved total also moves with earlier phases' freed pools)
    out["memory"] = {
        "per_replica": [{"bytes": sum(b or 0 for b in eng.graph_pool_bytes().values())
                         + eng.param_bytes(),
                         "pool_bytes": eng.graph_pool_bytes(), "param_bytes": eng.param_bytes()}
                        for eng in engines],
        "allocated_for_two_replicas": mem1["allocated"] - mem0["allocated"],
        "spawn_seconds": spawn_s}
    router = router_mod.FleetRouter(urls, health_interval_s=0.2,
                                    request_timeout_s=FLEET_TIMEOUT_S,
                                    admin_timeout_s=FLEET_TIMEOUT_S)
    router.start()
    front = router_mod.make_router_server(router)
    threading.Thread(target=front.serve_forever, daemon=True).start()
    base = "http://{}:{}".format(*front.server_address[:2])
    servers = [srv for _, srv in members]
    try:
        # (1) answers
        x3 = rng.standard_normal((3,) + shape).astype(np.float32)
        via, headers = post(base + "/embed", {"images": x3.tolist()})
        name = headers["X-Served-By"]
        direct, _ = post(urls[int(name[1:])] + "/embed", {"images": x3.tolist()})
        if via["embeddings"] != direct["embeddings"]:
            raise AssertionError("/embed through the router differs from the replica's answer")
        plain_cfg = plain_of(engines[0].config)
        with torch.inference_mode():
            plain = glom_model.apply(engines[0].params["glom"], torch.from_numpy(x3).to(device),
                                     config=plain_cfg, iters=iters).mean(dim=1).cpu().numpy()
        err = float(np.abs(np.asarray(via["embeddings"], np.float32) - plain).max())
        if not err <= SERVE_ATOL:
            raise AssertionError(f"/embed through the router: {err} from the plain path")
        out["answers"] = {"served_by": name, "bitwise_replica": True,
                          "vs_plain_max_abs_err": err, "atol": SERVE_ATOL}
        part_done("spawn_and_answers")

        # (2) the main path: a window of routed requests
        plan = (1, 3, 8, 2, 5, 1, 4, 8, 7, 6)
        bodies = {b: {"images": rng.standard_normal((b,) + shape).astype(np.float32).tolist()}
                  for b in set(plan)}
        # (1)'s two requests went to the serving replica: their post-passes
        # end before the window opens
        wait_quality(engines[int(name[1:])], 2)
        q0 = [eng.quality.summary() for eng in engines]
        made = compile_cache.captures_made()
        reset_launches()
        served_by = []
        for b in plan:
            _, headers = post(base + "/embed", bodies[b])
            served_by.append(headers["X-Served-By"])
        for i, (eng, s0) in enumerate(zip(engines, q0)):
            wait_quality(eng, s0["observed"] + served_by.count(f"r{i}"))
        launches = launch_counts()
        sampled = sum(eng.quality.summary()["sampled"] - s0["sampled"]
                      for eng, s0 in zip(engines, q0))
        if sampled != len(plan):     # quality_sample 1.0: every batch
            raise AssertionError(f"fleet: {sampled} of {len(plan)} batches sampled")
        q_it = engines[0]._program.quality_iters
        want = want_launches(iters * len(plan) + q_it * sampled)
        check_launches("fleet: the routed window", launches, want)
        if compile_cache.captures_made() != made:
            raise AssertionError("fleet: a graph was captured on the request path")
        main_launches = dict(launches)
        out["main_path"] = {"requests": list(plan), "served_by": served_by,
                            "replays": len(plan), "quality_replays": sampled,
                            "quality_iters": q_it, "launches": launches,
                            "per_replay": want_launches(iters)}
        part_done("main_path")

        # (3) affinity
        affinity = {}
        for k in range(FLEET_AFFINITY_KEYS):
            key = f"session-{k}"
            affinity[key] = sorted({post(base + "/embed", bodies[1], {"X-Affinity-Key": key})[1][
                "X-Served-By"] for _ in range(FLEET_AFFINITY_FRAMES)})
        if any(len(v) != 1 for v in affinity.values()):
            raise AssertionError(f"fleet: a session split across replicas: {affinity}")
        out["affinity"] = affinity
        part_done("affinity")

        # (4) the router hop: /embed b=1, direct and through the router, in
        # turns, the body encoded once (as the loadgen sends it)
        hop = {"direct": [], "router": []}
        b1 = json.dumps(bodies[1]).encode()
        for _ in range(FLEET_HOP_REQUESTS):
            for way, url in (("direct", urls[0]), ("router", base)):
                req = urllib.request.Request(url + "/embed", data=b1,
                                             headers={"Content-Type": "application/json"})
                t0 = time.perf_counter()
                with urllib.request.urlopen(req, timeout=FLEET_TIMEOUT_S) as r:
                    json.loads(r.read())
                hop[way].append((time.perf_counter() - t0) * 1e3)
        out["hop_ms"] = {way: latency_block(xs) for way, xs in hop.items()}
        out["hop_ms"]["p50_rise"] = pct(hop["router"], 50) - pct(hop["direct"], 50)
        out["hop_ms"]["p99_rise"] = pct(hop["router"], 99) - pct(hop["direct"], 99)
        emit({"phase": "fleet", "part": "hop", "card": out["card"], **out["hop_ms"]})
        part_done("hop")

        # (5) replicas in one process: a router over one replica, then over both
        replay_alone = {b: replay_ms(engines[0].caches["embed"], b)
                        + replay_ms(engines[0].caches["quality"], b) for b in GRAPH_BUCKETS}
        solo = router_mod.FleetRouter(urls[:1], health_interval_s=0.2,
                                      request_timeout_s=FLEET_TIMEOUT_S)
        solo.start()
        solo_front = router_mod.make_router_server(solo)
        threading.Thread(target=solo_front.serve_forever, daemon=True).start()
        loops = {}
        try:
            for label, url in (("one_replica", "http://{}:{}".format(
                    *solo_front.server_address[:2])), ("two_replicas_one_process", base)):
                snaps = [eng.registry.snapshot() for eng in engines]
                rep = fleet_closed_loop(url)
                pairs = list(zip(snaps, [eng.registry.snapshot() for eng in engines]))
                replays = bucket_replays(pairs)
                loops[label] = {"imgs_per_s": rep["throughput_imgs_per_s"],
                                "req_per_s": rep["throughput_req_per_s"],
                                "latency_ms": rep["latency_ms"], "errors": rep["requests_error"],
                                "per_replica": {k: v["requests_ok"] for k, v in
                                                (rep.get("per_replica") or {}).items()},
                                "replays_by_bucket": replays,
                                "busy_share": busy_share(replays, replay_alone,
                                                         rep["wall_seconds"])}
        finally:
            solo.shutdown()
            solo_front.shutdown()
            solo_front.server_close()
        loops["replay_alone_ms"] = replay_alone
        loops["one_process_ratio"] = (loops["two_replicas_one_process"]["imgs_per_s"]
                                      / loops["one_replica"]["imgs_per_s"])
        emit({"phase": "fleet", "part": "one_process", "card": out["card"], **loops})
        out["loops"] = loops
        part_done("one_process_loops")

        # (6) fail-over under the clients, then the re-admission
        clients = FleetClients(base, b1)
        time.sleep(1.0)
        host, port = servers[1].server_address[:2]
        servers[1].shutdown()
        servers[1].server_close()
        time.sleep(2.0)
        servers[1] = make_server(engines[1], host, port)
        threading.Thread(target=servers[1].serve_forever, daemon=True).start()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not any(
                e["event"] == "readmission" for e in router.timeline()):
            time.sleep(0.1)
        time.sleep(1.0)
        clients.stop()
        events = [e for e in router.timeline() if e["event"] in ("ejection", "readmission")]
        if clients.errors or [e["event"] for e in events] != ["ejection", "readmission"]:
            raise AssertionError(f"fleet fail-over: {clients.errors[:3]}, events {events}")
        timeline = get(base + "/debug/timeline")
        if not {"ejection", "readmission"} <= {e["event"] for e in timeline["events"]}:
            raise AssertionError("fleet: /debug/timeline lacks the ejection or re-admission")
        out["fail_over"] = {"answers": len(clients.answers), "errors": 0,
                            "events": [{k: e[k] for k in ("event", "replica")} for e in events],
                            "served_by": {r: [a[3] for a in clients.answers].count(r)
                                          for r in ("r0", "r1")}}
        part_done("fail_over")

        # (7) a coordinated rollout under the clients, then one that fails
        for eng in engines:
            eng._device_lock.longest_exclusive_s = 0.0
        made = compile_cache.captures_made()
        clients = FleetClients(base, b1)
        time.sleep(1.0)
        make_demo_checkpoint(ckpt, config=c, seed=42, step=1)
        t0 = time.perf_counter()
        report, _ = post(base + "/rollout", {})
        rollout_s = time.perf_counter() - t0
        time.sleep(1.0)
        clients.stop()
        steps = [a[2] for a in sorted(clients.answers)]
        back = new_to_old(clients.answers)
        if (report.get("status") != "committed" or report.get("step") != 1 or clients.errors
                or back or not steps or steps[0] != 0 or steps[-1] != 1
                or {eng.step for eng in engines} != {1}):
            raise AssertionError(f"fleet rollout: {report}, errors {clients.errors[:3]}, "
                                 f"new -> old {back[:3]}, steps {[e.step for e in engines]}")
        out["rollout"] = {"report": report, "seconds": rollout_s, "answers": len(steps),
                          "old_answers": steps.count(0), "new_answers": steps.count(1),
                          "new_to_old": 0,
                          "captures": compile_cache.captures_made() - made,
                          "longest_exclusive_hold_s": [eng._device_lock.longest_exclusive_s
                                                       for eng in engines]}
        make_demo_checkpoint(ckpt, config=c, seed=43, step=2)
        original = engines[1].stage_reload

        def seamed_stage(step=None):
            # r1's prepare passes through the reload fault seam (the engine
            # polls it only on a prepare that discovers its step)
            if faultinject.fire("reload") is not None:
                engines[1]._reload_failure("stage", faultinject.FaultError("injected"))
                return None
            return original(step)

        engines[1].stage_reload = seamed_stage
        try:
            with faultinject.injected("reload:io_error"):
                try:
                    post(base + "/rollout", {"step": 2})
                    failed = None
                except urllib.error.HTTPError as e:
                    failed = e.code, json.loads(e.read())
        finally:
            del engines[1].stage_reload
        if (failed is None or failed[0] != 502 or failed[1].get("status") != "aborted"
                or {eng.step for eng in engines} != {1}
                or any(eng._staged is not None for eng in engines)):
            raise AssertionError(f"fleet: a failed prepare did not abort: {failed}, steps "
                                 f"{[eng.step for eng in engines]}")
        out["rollout_fault"] = {"status": failed[0], "report": failed[1],
                                "steps": [eng.step for eng in engines]}
        part_done("rollouts")

        # (8) an index job sharded over both replicas, then /similar
        spec = {"name": "index", "dataset": f"synthetic:{FLEET_INDEX_SLOTS}",
                "transform": "index", "sink": index_dir, "seed": 35}
        t0 = time.perf_counter()
        submitted, _ = post(base + "/admin/jobs/submit", spec)
        deadline = time.monotonic() + FLEET_TIMEOUT_S
        while router.job_status("index")["status"] != "done":
            if time.monotonic() > deadline:
                raise AssertionError(f"fleet index job: {router.job_status('index')}")
            time.sleep(0.1)
        index_s = time.perf_counter() - t0
        corpus = SlotDataset(BulkJobSpec(**spec, image_size=c.image_size)).read(
            0, FLEET_INDEX_SLOTS)
        picks = [int(p) for p in rng.choice(FLEET_INDEX_SLOTS, FLEET_QUERIES, replace=False)]
        query = {"images": corpus[picks].tolist(), "level": 0, "k": 10}
        merged, headers = post(base + "/similar", query)
        own = [post(u + "/similar", query)[0] for u in urls]
        tops = [hits[0]["slot"] for hits in merged["results"]]
        if tops != picks or merged["results"] != merge_similar(own, 10) \
                or headers.get("X-Served-By") != "r0,r1":
            raise AssertionError(f"fleet /similar: top-1 {tops} for {picks}, "
                                 f"merge equal {merged['results'] == merge_similar(own, 10)}")
        out["similar"] = {"owners": submitted["owners"], "index_seconds": index_s,
                          "top1_self": len(picks), "merge_equals_glom_tpus_rule": True,
                          "served_by": headers.get("X-Served-By")}
        part_done("similar")

        # (9) the observatory's console
        observatory = FleetObservatory(base, sampler=TailSampler(0.0, seed=0),
                                       http_timeout_s=FLEET_TIMEOUT_S)
        observatory.poll_once()
        console = [{k: r[k] for k in ("name", "healthy", "step")}
                   for r in observatory.console()["replicas"]]
        if console != [{"name": f"r{i}", "healthy": True, "step": 1} for i in range(2)]:
            raise AssertionError(f"fleet observatory console: {console}")
        out["console_replicas"] = console
        part_done("console")
    finally:
        router.shutdown()
        front.shutdown()
        front.server_close()
        for srv in servers:
            srv.shutdown()
            srv.server_close()
        free_engines(*engines)

    # (10) two replica processes on the one card
    files = [os.path.join(work, f"server{i}.log") for i in range(2)]
    procs = [start_server_process(ckpt, f) for f in files]
    try:
        purls = [served_url(p, f) for p, f in zip(procs, files)]
        prouter = router_mod.FleetRouter(purls, health_interval_s=0.2,
                                         request_timeout_s=FLEET_TIMEOUT_S)
        prouter.start()
        pfront = router_mod.make_router_server(prouter)
        threading.Thread(target=pfront.serve_forever, daemon=True).start()
        try:
            snaps = [get(u + "/debug/forensics")["registry"] for u in purls]
            rep = fleet_closed_loop("http://{}:{}".format(*pfront.server_address[:2]))
            pairs = list(zip(snaps, [get(u + "/debug/forensics")["registry"] for u in purls]))
            replays = bucket_replays(pairs)
            out["loops"]["two_replica_processes"] = {
                "imgs_per_s": rep["throughput_imgs_per_s"],
                "req_per_s": rep["throughput_req_per_s"],
                "latency_ms": rep["latency_ms"], "errors": rep["requests_error"],
                "per_replica": {k: v["requests_ok"]
                                for k, v in (rep.get("per_replica") or {}).items()},
                "replays_by_bucket": replays,
                "busy_share": busy_share(replays, out["loops"]["replay_alone_ms"],
                                         rep["wall_seconds"])}
            out["loops"]["two_process_ratio"] = (
                rep["throughput_imgs_per_s"] / out["loops"]["one_replica"]["imgs_per_s"])
        finally:
            prouter.shutdown()
            pfront.shutdown()
            pfront.server_close()
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    part_done("two_processes")
    emit({"phase": "fleet", "part": "two_processes", "card": out["card"],
          **out["loops"]["two_replica_processes"],
          "two_process_ratio": out["loops"]["two_process_ratio"]})
    if any(out["loops"][k]["errors"] for k in ("one_replica", "two_replicas_one_process",
                                               "two_replica_processes")):
        raise AssertionError(f"fleet closed loops: {out['loops']}")

    # (11) the stitched trace at flagship
    smoke = loadgen.run_smoke(str(device), fleet=True, checkpoint_dir=ckpt)
    if smoke["smoke"] != "ok":
        raise AssertionError(f"loadgen --smoke --fleet at flagship: {smoke['checks']}, "
                             f"coverage {smoke['trace_coverage']}")
    out["stitched"] = {k: smoke[k] for k in ("trace_coverage", "min_coverage", "hop_links",
                                             "trace_span_names", "checks")}
    part_done("stitched")

    # (12) the tools' fleet legs
    legs = {}
    for name, tool in (("capacity", capacity_tool), ("quality_report", quality_report)):
        t0 = time.perf_counter()
        rep = tool.run_smoke(str(device), checkpoint_dir=ckpt, buckets=(1,), fleet=True)
        if rep["smoke"] != "ok":
            raise AssertionError(f"{name} --smoke --fleet at flagship: {rep['checks']}")
        legs[name] = {"seconds": time.perf_counter() - t0, "checks": rep["checks"]}
    out["tool_fleet_legs"] = legs
    part_done("tool_legs")
    out["part_seconds"] = parts
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    shutil.rmtree(ckpt, ignore_errors=True)
    shutil.rmtree(work, ignore_errors=True)
    return main_launches


# -- observability and robustness: the trainer's fields, the supervisor, the
# engine's forensics and warm-up bundles -----------------------------------
TRAIN_OBS_STEPS = 12
TRAIN_OBS_LOG_EVERY = 2
TRAIN_OBS_DIAG_EVERY = 6
# the batch scaled by TRAIN_OBS_SPIKE_SCALE: a grad_spike bundle at the end of
# its window, whose trace holds the next two steps
TRAIN_OBS_SPIKE_AT = 6
TRAIN_OBS_SPIKE_SCALE = 1e3
# the diagnostics, the kernels' path against the plain path: relative
# (to max(|plain|, 0.01))
DIAG_RTOL = 1e-4
# data:delay on the last four of these batches (after one warm step): the
# step-time regression trigger over eight baseline windows
STEP_TIME_STEPS = 13
# the per-window rate with every field on against all off: log_every 10,
# windows 2 and 3 of each run
OVERHEAD_STEPS = 30
OVERHEAD_LOG_EVERY = 10
# the main kernel of each wrapper on the "pallas" train path, by the name a
# profiler trace gives it
TRACE_KERNELS = {"grouped_ff": "ff_hidden_kernel", "grouped_ff_dx": "ff_bwd_dx_kernel",
                 "grouped_ff_dw": "ff_bwd_dw_kernel", "consensus_attention": "consensus_kernel",
                 "consensus_dkv": "consensus_bwd_dkv_kernel",
                 "consensus_dq": "consensus_bwd_dq_kernel"}
# the predictions written into PERF.md before the first card run
TRAIN_OBS_PREDICTED = {"diag_point_ms": [25.0, 35.0], "sync_save_s": [0.5, 2.0],
                       "async_save_s": [0.0, 0.15], "obs_on_over_off_rate": [0.98, 1.02],
                       "capture_ms": [0.0, 50.0]}
FORENSICS_BUCKETS = (1, 8)
FORENSICS_PREDICTED = {"warmup_with_over_without": [0.95, 1.05]}
# a child that launches K1 with a bad output pointer: what a sticky CUDA
# error raises, and the supervisor giving up on it
STICKY_CHILD = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from glom_tpu_torch.kernels import _common, ff
from glom_tpu_torch.resilience import supervisor

b, n, g, d, h = 1, 64, 2, 128, 512
x = torch.randn(b, n, g, d, device="cuda")
w1, b1 = torch.randn(g, d, h, device="cuda"), torch.randn(g, h, device="cuda")
w2, b2 = torch.randn(g, h, d, device="cuda"), torch.randn(g, d, device="cuda")
hid = torch.empty((g, b * n, h), dtype=torch.float32, device="cuda")
out = {}
try:
    code = ff._kernel()(x.data_ptr(), ff._row_stride(x), x.stride(2), w1.data_ptr(),
                        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), 16, None, hid.data_ptr(),
                        b * n, g, d, h, 1, _common.DTYPE_CODES[x.dtype],
                        torch.cuda.current_stream().cuda_stream)
    out["launch_code"] = int(code)
    torch.cuda.synchronize()
    out["raised"] = None
except Exception as e:
    out.update(raised=type(e).__name__, mro=[c.__name__ for c in type(e).__mro__],
               message=str(e).splitlines()[0], reason=supervisor.classify_failure(e))
attempts, sleeps = [], []

def fit():
    attempts.append(1)
    return float((torch.ones(1, device="cuda") * 2).sum())

try:
    supervisor.Supervisor(fit, sleep=sleeps.append).run()
    out["giveup"] = None
except supervisor.GiveUp as e:
    out["giveup"] = str(e)[:160]
except Exception as e:
    out["giveup"] = f"not a GiveUp: {type(e).__name__}: {e}"
out.update(attempts=len(attempts), sleeps=sleeps)
print(json.dumps(out), flush=True)
'''


def spiked_batches(seed: int, at: int, scale: float, image_size: int):
    """The synthetic stream with batch ``at`` (1-based) scaled by ``scale``."""
    from glom_tpu_torch.training.data import synthetic_batches

    for i, batch in enumerate(synthetic_batches(BATCH, image_size, 3, seed=seed), 1):
        yield batch * scale if i == at else batch


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def trace_kernel_counts(path: str) -> dict:
    """Each wrapper's main kernel's launches in a Chrome trace (TRACE_KERNELS)."""
    events = read_json(path)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {w: sum(1 for n in names if k in n) for w, k in TRACE_KERNELS.items()}


def trace_launch_gap(path: str) -> dict:
    """Kernel records against their launches in a Chrome trace: the host's
    ``cudaLaunchKernel`` calls, the device's kernel records, and the first
    of each (us), which say whether the device side lost records."""
    events = read_json(path)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and "LaunchKernel" in e.get("name", "")]
    return {"kernel_records": len(kernels), "launch_calls": len(launches),
            "first_kernel_ts": min((e["ts"] for e in kernels), default=None),
            "first_launch_ts": min((e["ts"] for e in launches), default=None)}


def rel_to(got: dict, want: dict) -> float:
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 0.01) for k in want)


def window_step_ms(rec: dict) -> float:
    """One logged window's train time a step, ms (eval, checkpoint, diag
    and exporter writes left out, as imgs_per_sec counts)."""
    return 1e3 * BATCH / rec["imgs_per_sec"]


def obs_fit(c, device, tc, batches):
    """``Trainer.fit`` of ``tc`` on ``batches``; ``(trainer, records)``."""
    import io

    stream = io.StringIO()
    trainer = Trainer(c, tc, device=device, logger=MetricLogger(stream=stream))
    trainer.fit(batches)
    return trainer, [json.loads(line) for line in stream.getvalue().splitlines()]


def only_bundle(root: str, prefix: str) -> str:
    names = sorted(n for n in os.listdir(root) if n.startswith(prefix + "-"))
    if len(names) != 1:
        raise AssertionError(f"{root}: bundles {sorted(os.listdir(root))}, expected one "
                             f"{prefix}-*")
    return os.path.join(root, names[0])


def bundle_kernels(bundle: str, want: dict, what: str) -> dict:
    """A bundle's step snapshot: the launch table equals ``want`` (the
    wrappers' launches one step makes) and the cost is there."""
    got = read_json(os.path.join(bundle, "kernels.json"))
    check_launches(f"{what} bundle's kernels.json", got, {k: v for k, v in want.items() if v})
    if not read_json(os.path.join(bundle, "cost_analysis.json"))["flops"] > 0:
        raise AssertionError(f"{what}: no cost analysis")
    return got


def phase_train_obs(device) -> dict:
    """The trainer with every observability and robustness field on, at
    flagship width, f32, b=8, "pallas" with the kernel backward and no
    remat: metrics_csv, prom_textfile, trace_dir, diag_every, a forensics
    dir with a traced trigger, async checkpoints and log_every (the main
    path: the counts set to 0 just before Trainer.fit and read just after:
    K1-K4, K6 and K7 for 12 steps, and K1 + K4 for two diagnostics points).
    The CSV rows are the JSONL records, the textfile's steps_total the
    steps, train_trace.json the loop's phases; a scaled batch writes a
    grad_spike bundle whose kernels.json is one step's launches and whose
    trace holds two steps' launches of K1-K4, K6 and K7; no build or
    rebuild in the window.  Then the diagnostics on "pallas" and "fused"
    (K8) against the plain path; the async save bitwise the sync one, and a
    ckpt_write fault raising from finish_saves; nan (data:nan_batch),
    step_time_regression (data:delay) and crash bundles; the supervised CLI
    restarting once on data:crash and ending bitwise on an unfailed run's
    parameters; what a sticky CUDA error raises in a child process, and the
    supervisor giving up on it at once; the window rate with every field on
    against all off."""
    import contextlib
    import dataclasses
    import io

    from glom_tpu_torch.obs.diagnostics import flatten_diagnostics, make_diagnostics_fn
    from glom_tpu_torch.resilience import faultinject
    from glom_tpu_torch.training import train as train_cli
    from glom_tpu_torch.training.data import fault_injected, synthetic_batches

    t_phase = time.perf_counter()
    c = kernel_config()
    work = os.path.join(ROOT, "build", "chip_smoke_train_obs")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    def d(name):
        return os.path.join(work, name)

    t = denoise.resolve_loss_timestep(TrainConfig(), c.default_iters)
    per_step = want_launches(t, t)
    diag_point = want_launches(c.default_iters + 1)   # the forward and one more iteration
    n_diag = TRAIN_OBS_STEPS // TRAIN_OBS_DIAG_EVERY
    tc = TrainConfig(batch_size=BATCH, steps=TRAIN_OBS_STEPS, log_every=TRAIN_OBS_LOG_EVERY,
                     seed=0, metrics_csv=d("m.csv"), prom_textfile=d("m.prom"),
                     trace_dir=d("trace"), diag_every=TRAIN_OBS_DIAG_EVERY,
                     forensics_dir=d("f"), forensics_trace_steps=2, checkpoint_dir=d("ck"),
                     checkpoint_every=TRAIN_OBS_DIAG_EVERY, async_checkpoint=True)
    stream = io.StringIO()
    trainer = Trainer(c, tc, device=device, logger=MetricLogger(stream=stream))
    builds = _build.events()
    reset_launches()
    trainer.fit(spiked_batches(0, TRAIN_OBS_SPIKE_AT, TRAIN_OBS_SPIKE_SCALE, c.image_size))
    launches = launch_counts()
    check_launches("the main run", launches, {
        k: TRAIN_OBS_STEPS * per_step[k] + n_diag * diag_point[k] for k in per_step})
    records = [json.loads(line) for line in stream.getvalue().splitlines()]
    # no kernel built in the window and no rebuild after the first step (a
    # library's first load there is the recompile monitor's baseline)
    if (_build.events()["builds"] != builds["builds"]
            or any(r.get("event") == "recompile" for r in records)):
        raise AssertionError(f"a build in the window: {builds} -> {_build.events()}")
    # the records: CSV rows, the textfile, the phase trace
    with open(d("m.csv")) as f:
        rows = list(csv.DictReader(f))
    same = len(rows) == len(records) and all(
        (float(row[k]) == float(v)) if not isinstance(v, str) else row[k] == v
        for row, rec in zip(rows, records) for k, v in rec.items())
    with open(d("m.prom")) as f:
        steps_total = metric_value(f.read(), "glom_steps_total")
    spans = {e["name"] for e in read_json(os.path.join(d("trace"), "train_trace.json"))[
        "traceEvents"] if e.get("ph") == "X"}
    want_spans = {"data_wait", "h2d", "step", "log_sync", "diag", "checkpoint"}
    windows = [r for r in records if "window_steps" in r]
    diags = [r for r in records if "island_agreement" in r]
    if not (same and steps_total == TRAIN_OBS_STEPS and want_spans <= spans
            and len(windows) == TRAIN_OBS_STEPS // TRAIN_OBS_LOG_EVERY and len(diags) == n_diag):
        raise AssertionError(f"records: csv {len(rows)} rows vs {len(records)} records "
                             f"(equal {same}), steps_total {steps_total}, spans {sorted(spans)}, "
                             f"{len(windows)} windows, {len(diags)} diagnostics")
    # the traced grad_spike bundle
    spike = only_bundle(d("f"), "grad_spike")
    manifest = read_json(os.path.join(spike, "manifest.json"))
    spike_kernels = bundle_kernels(spike, per_step, "grad_spike")
    traced = trace_kernel_counts(os.path.join(spike, "trace", "trace.json"))
    want_traced = {w: 2 * per_step[w] for w in TRACE_KERNELS}
    if manifest.get("trace_state") != "complete" or traced != want_traced:
        raise AssertionError(f"grad_spike trace: state {manifest.get('trace_state')}, kernels "
                             f"{traced}, expected {want_traced}; "
                             f"{trace_launch_gap(os.path.join(spike, 'trace', 'trace.json'))}")
    spike_step = manifest["step"]
    traced_ms = window_step_ms(next(r for r in windows if r["step"] == spike_step + 2))
    untraced_ms = statistics.median(window_step_ms(r) for r in windows
                                    if r["step"] not in (spike_step + 2, 2))
    capture_ms, _ = host_ms(lambda: trainer._forensics.capture("nan", 10 ** 6, {}, trace=False))

    # the diagnostics: the kernels' path against the plain path on the same
    # parameters and batch, "pallas" (K1 + K4) and "fused" (K8, then K1 + K4)
    params = trainer.state.params["glom"]
    x = torch.from_numpy(next(synthetic_batches(BATCH, c.image_size, 3, seed=11))).to(device)
    plain_diag = make_diagnostics_fn(plain_of(c), device=device)
    want = flatten_diagnostics(plain_diag(params, x))
    plain_ms, _ = host_ms(lambda: flatten_diagnostics(plain_diag(params, x)))
    diag_rows = {}
    for impl, cfg, launched in (
            ("pallas", c, diag_point),
            ("fused", kernel_config(ff_impl="fused"),
             {**want_launches(1), "fused_level_update": c.default_iters})):
        fn = make_diagnostics_fn(cfg, device=device)
        flatten_diagnostics(fn(params, x))   # warm
        reset_launches()
        got = flatten_diagnostics(fn(params, x))
        check_launches(f"a diagnostics point on {impl}", launch_counts(), launched)
        ms, _ = host_ms(lambda: flatten_diagnostics(fn(params, x)))
        err = rel_to(got, want)
        if not err <= DIAG_RTOL:
            raise AssertionError(f"diagnostics on {impl}: {err} from the plain path")
        diag_rows[impl] = {"ms": ms, "rel_err": err, "launches": launched}

    # the async save against the sync save of the same step, and a torn write
    async_s, _ = host_ms(lambda: trainer.save(d("async")))
    drain_s, _ = host_ms(trainer.finish_saves)
    trainer.train_cfg = dataclasses.replace(tc, async_checkpoint=False)
    sync_s, _ = host_ms(lambda: trainer.save(d("sync")))
    trainer.train_cfg = tc
    step = int(trainer.state.step)
    a, s = ckpt_lib.load_arrays(d("async"), step), ckpt_lib.load_arrays(d("sync"), step)
    bitwise = sorted(a) == sorted(s) and all(np.array_equal(a[k], s[k]) for k in s)
    with faultinject.injected(f"ckpt_write:torn@{step}"):
        trainer.save(d("torn"))
        try:
            trainer.finish_saves()
            torn = None
        except ckpt_lib.CorruptCheckpointError as e:
            torn = str(e)
    window_ckpt_ms = [1e3 * r["t_checkpoint"] for r in windows if "t_checkpoint" in r]
    if not bitwise or torn is None:
        raise AssertionError(f"async save bitwise {bitwise}, torn write raised {torn}")
    del trainer, params

    # the other triggers, each its own trainer
    def trig_cfg(name, steps, **kw):
        return TrainConfig(batch_size=BATCH, steps=steps, log_every=1, seed=0,
                           forensics_dir=d(name), **kw)

    with faultinject.injected("data:nan_batch@2"):
        obs_fit(c, device, trig_cfg("f_nan", 3),
                fault_injected(synthetic_batches(BATCH, c.image_size, 3, seed=1)))
    nan_kernels = bundle_kernels(only_bundle(d("f_nan"), "nan"), per_step, "nan")
    slow = Trainer(c, trig_cfg("f_slow", STEP_TIME_STEPS), device=device,
                   logger=MetricLogger(stream=io.StringIO()))
    stream_slow = synthetic_batches(BATCH, c.image_size, 3, seed=2)
    slow.step(next(stream_slow))   # warm: the baseline windows are steady steps
    delayed = STEP_TIME_STEPS - 1
    with faultinject.injected(f"data:delay@{delayed - 3}*4"):
        slow.fit(fault_injected(stream_slow))
    slow_bundle = only_bundle(d("f_slow"), "step_time_regression")
    slow_detail = read_json(os.path.join(slow_bundle, "manifest.json"))["detail"]
    bundle_kernels(slow_bundle, per_step, "step_time_regression")
    del slow

    def crashing():
        for i, batch in enumerate(synthetic_batches(BATCH, c.image_size, 3, seed=3), 1):
            if i == 3:
                raise ValueError("a data worker died mid-fit")
            yield batch

    try:
        obs_fit(c, device, trig_cfg("f_crash", 4), crashing())
        raise AssertionError("the crash did not surface")
    except ValueError:
        pass
    crash = only_bundle(d("f_crash"), "crash")
    bundle_kernels(crash, per_step, "crash")
    if "a data worker died" not in read_json(os.path.join(crash, "manifest.json"))[
            "detail"]["traceback"]:
        raise AssertionError("the crash bundle carries no traceback")

    # the supervised CLI: data:crash at the third batch, one restart, the
    # parameters of an unfailed run of the same steps (the synthetic stream
    # restarts on a resume in both packages: the unfailed run is one stopped
    # at the last checkpoint before the crash and resumed)
    argv = ["--dim", str(c.dim), "--levels", str(c.levels), "--image-size", str(c.image_size),
            "--patch-size", str(c.patch_size), "--batch-size", str(BATCH), "--log-every", "1",
            "--ff-impl", "pallas", "--fused-ff-bwd", "--attention-impl", "pallas",
            "--checkpoint-every", "2", "--device", str(device)]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        with faultinject.injected("data:crash@3"):
            train_cli.main(argv + ["--steps", "4", "--supervise", "--checkpoint-dir", d("sup"),
                                   "--forensics-dir", d("f_sup")])
        sup_s = time.perf_counter() - t0
        train_cli.main(argv + ["--steps", "2", "--checkpoint-dir", d("ref")])
        train_cli.main(argv + ["--steps", "4", "--checkpoint-dir", d("ref")])
    restart = read_json(os.path.join(only_bundle(d("f_sup"), "crash_restart"), "metrics.json"))
    got = ckpt_lib.load_arrays(d("sup"), 4)
    ref = ckpt_lib.load_arrays(d("ref"), 4)
    keys = sorted(k for k in ref if k.startswith("params"))
    sup_bitwise = all(np.array_equal(got[k], ref[k]) for k in keys)
    if not (sup_bitwise and restart.get("supervisor_restarts") == 1.0
            and restart.get("supervisor_restarts_io_error") == 1.0):
        raise AssertionError(f"supervised run: bitwise {sup_bitwise}, counters "
                             f"{ {k: v for k, v in restart.items() if 'supervisor' in k} }")

    # a sticky CUDA error, in a process of its own: it poisons the context
    res = subprocess.run([sys.executable, "-c", STICKY_CHILD, ROOT], capture_output=True,
                         text=True, timeout=180, cwd=ROOT)
    sticky = json.loads([ln for ln in res.stdout.splitlines() if ln.startswith("{")][-1]) \
        if res.returncode == 0 and "{" in res.stdout else {"stderr": res.stderr[-2000:]}
    if not (sticky.get("reason") == "cuda_fatal" and sticky.get("giveup")
            and sticky.get("attempts") == 1 and sticky.get("sleeps") == []):
        raise AssertionError(f"sticky CUDA error: {sticky}")

    # the window rate with every field on against all off, A B B A
    def rate(kind: str, k: int) -> float:
        kw = {} if kind == "off" else _obs_fields_on(d(f"over{k}"))
        if kind == "on_no_checkpoint":
            kw.update(checkpoint_dir=None, checkpoint_every=0)
        _, recs = obs_fit(c, device, TrainConfig(batch_size=BATCH, steps=OVERHEAD_STEPS,
                                                 log_every=OVERHEAD_LOG_EVERY, seed=0, **kw),
                          synthetic_batches(BATCH, c.image_size, 3, seed=4))
        wins = [r["imgs_per_sec"] for r in recs if "window_steps" in r][1:]
        return statistics.mean(wins)

    # in turns; on_no_checkpoint: every field on but the (async) checkpoints,
    # whose writer thread runs beside the next window
    rates = {"off": [], "on": [], "on_no_checkpoint": []}
    for k, kind in enumerate(("off", "on", "on_no_checkpoint", "on_no_checkpoint", "on",
                              "off")):
        rates[kind].append(rate(kind, k))
    on_over_off = statistics.mean(rates["on"]) / statistics.mean(rates["off"])
    no_ckpt_over_off = (statistics.mean(rates["on_no_checkpoint"])
                        / statistics.mean(rates["off"]))

    out = {"phase": "train_obs", "card": nvidia_smi(),
           "config": {"dim": c.dim, "levels": c.levels, "batch": BATCH, "dtype": "float32",
                      "ff_impl": "pallas", "ff_fused_bwd": True, "attention_impl": "pallas",
                      "steps": TRAIN_OBS_STEPS, "log_every": TRAIN_OBS_LOG_EVERY,
                      "diag_every": TRAIN_OBS_DIAG_EVERY},
           "launches": launches, "launches_per_step": per_step,
           "launches_per_diag_point": diag_point,
           "records": {"jsonl": len(records), "csv_rows": len(rows), "steps_total": steps_total,
                       "spans": sorted(spans)},
           "grad_spike": {"bundle": os.path.basename(spike), "kernels": spike_kernels,
                          "trace_kernels_two_steps": traced, "traced_step_ms": traced_ms,
                          "untraced_step_ms_median": untraced_ms},
           "capture_ms_no_trace": capture_ms,
           "diagnostics": {"plain_ms": plain_ms, **diag_rows, "rtol": DIAG_RTOL},
           "checkpoint": {"async_save_s": async_s / 1e3, "async_drain_s": drain_s / 1e3,
                          "sync_save_s": sync_s / 1e3, "in_fit_t_checkpoint_ms": window_ckpt_ms,
                          "bitwise": bitwise, "torn_write_raised": torn[:120]},
           "nan": {"kernels": nan_kernels},
           "step_time_regression": {"bundle": os.path.basename(slow_bundle),
                                    "detail": slow_detail},
           "crash": os.path.basename(crash),
           "supervised": {"seconds": sup_s, "bitwise_vs_unfailed": sup_bitwise,
                          "restart_counters": {k: v for k, v in restart.items()
                                               if k.startswith("supervisor")}},
           "sticky_cuda_error": sticky,
           "rate_imgs_per_s": rates, "obs_on_over_off": on_over_off,
           "obs_on_no_checkpoint_over_off": no_ckpt_over_off,
           "predicted": TRAIN_OBS_PREDICTED, "seconds": time.perf_counter() - t_phase}
    emit(out)
    shutil.rmtree(work, ignore_errors=True)
    return launches


def _obs_fields_on(root: str) -> dict:
    """Every observability field on, with no trigger firing."""
    os.makedirs(root, exist_ok=True)
    return dict(metrics_csv=os.path.join(root, "m.csv"),
                prom_textfile=os.path.join(root, "m.prom"),
                trace_dir=os.path.join(root, "trace"), diag_every=OVERHEAD_LOG_EVERY,
                forensics_dir=os.path.join(root, "f"), checkpoint_dir=os.path.join(root, "ck"),
                checkpoint_every=OVERHEAD_LOG_EVERY, async_checkpoint=True)


def phase_forensics(device) -> dict:
    """The engine's forensics at flagship, f32 "pallas", buckets 1 and 8:
    the warm-up bundles (one a family and bucket, each launch table the
    graph's replay launches, no capture added; warm-up timed against an
    engine without warmup_dir); answers on /embed b=1 and b=8 (the main path:
    the counts set to 0 just before and read just after: K1 24 + K4 12 a
    replay) bitwise their eager forwards; an induced slo_burn bundle with
    attribution.json, listed on /debug/forensics; a shadow candidate through
    /admin/deploy/* (its graph snapshots beside the primary's in the
    attribution evidence) and a forced rollback writing deploy_rollback; the
    op-diff of a bf16 engine's graphs against the f32 engine's naming the
    quant change at both buckets; the answers again, bitwise the first."""
    from glom_tpu_torch.obs import attribution
    from glom_tpu_torch.obs.slo import parse_slo
    from glom_tpu_torch.serving import compile_cache

    t_phase = time.perf_counter()
    c = kernel_config()
    ckpt = flagship_ckpt("chip_smoke_forensics_ckpt", seed=40)
    work = os.path.join(ROOT, "build", "chip_smoke_forensics")
    shutil.rmtree(work, ignore_errors=True)
    fdir, wdir = os.path.join(work, "f"), os.path.join(work, "w")
    common = dict(device=device, buckets=FORENSICS_BUCKETS, reload_poll_s=0)

    def warmed(**kw):
        """An engine, its warm-up seconds and the captures it made."""
        n = compile_cache.captures_made()
        eng = ServingEngine(ckpt, **common, **kw)
        return (eng, eng.registry.snapshot()["serving_warmup_seconds"],
                compile_cache.captures_made() - n)

    # warm-up without warmup_dir and with it, in turns after a first engine
    # (the process's first captures pay for what later ones reuse)
    warm = {"first": [], "without": [], "with": []}
    caps = {"without": set(), "with": set()}
    for k, kind in enumerate(("first", "without", "with", "without")):
        kw = {"warmup_dir": os.path.join(work, f"w{k}")} if kind == "with" else {}
        eng, seconds, made = warmed(**kw)
        warm[kind].append(seconds)
        caps.setdefault(kind, set()).add(made)
        free_engines(eng)
    slo = [parse_slo("p95<100ms", short_window_s=5.0, long_window_s=10.0, min_events=4,
                     burn_threshold=2.0)]
    engine, seconds, made = warmed(forensics_dir=fdir, warmup_dir=wdir, slos=slo)
    warm["with"].append(seconds)
    caps["with"].add(made)
    warm_without = statistics.mean(warm["without"])
    warm_with = statistics.mean(warm["with"])
    caps_without, caps_with = sorted(caps["without"]), sorted(caps["with"])
    families = sorted(engine.caches)
    want_bundles = sorted(f"{f}-b{b}" for f in families for b in FORENSICS_BUCKETS)
    if sorted(os.listdir(wdir)) != want_bundles or caps_with != caps_without:
        raise AssertionError(f"warm-up bundles {sorted(os.listdir(wdir))}, expected "
                             f"{want_bundles}; captures {caps_with} vs {caps_without}")
    tables = {}
    for f in families:
        cache = engine.caches[f]
        per_replay = cache.launches_per_replay()
        for b in FORENSICS_BUCKETS:
            got = read_json(os.path.join(wdir, f"{f}-b{b}", "kernels.json"))
            # the graph's key is its bucket (parse's: bucket/state dtype)
            label = next((k for k in per_replay if str(k).split("/")[0] == str(b)), None)
            want_table = per_replay[label] if cache.graphed else {}
            if got != want_table:
                raise AssertionError(f"warm-up bundle {f}-b{b}: {got}, the graph {label} "
                                     f"launches {want_table}")
            tables[f"{f}-b{b}"] = got
    embed_table = {k: v for k, v in want_launches(c.default_iters).items() if v}
    if tables["embed-b8"] != embed_table or tables["embed-b1"] != embed_table:
        raise AssertionError(f"/embed's launch table {tables['embed-b8']}, expected "
                             f"{embed_table}")

    rng = np.random.default_rng(40)
    xs = {b: rng.standard_normal((b, c.channels, c.image_size, c.image_size)).astype(np.float32)
          for b in FORENSICS_BUCKETS}
    reset_launches()
    before = {b: engine.run("embed", xs[b]) for b in FORENSICS_BUCKETS}
    launches = launch_counts()
    check_launches("/embed b=1 and b=8", launches,
                   {k: len(FORENSICS_BUCKETS) * v for k, v in
                    want_launches(c.default_iters).items()})
    for b in FORENSICS_BUCKETS:
        if not np.array_equal(before[b], engine.run_eager("embed", xs[b])):
            raise AssertionError(f"/embed b={b}: the replay is not bitwise its eager forward")

    srv = make_server(engine)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = "http://{}:{}".format(*srv.server_address[:2])
    try:
        # an induced slo_burn: the firing outcome pays the capture
        outcome_ms = []
        for i in range(12):
            t0 = time.perf_counter()
            engine.observe_outcome("embed", 900.0, False, trace_id=f"burn-{i}")
            outcome_ms.append((time.perf_counter() - t0) * 1e3)
        listed = [b["name"] for b in get(base + "/debug/forensics")["bundles"]]
        burn = only_bundle(fdir, "slo_burn")
        burn_files = sorted(os.listdir(burn))
        if os.path.basename(burn) not in listed or "attribution.json" not in burn_files \
                or "kernels.json" not in burn_files:
            raise AssertionError(f"slo_burn: listed {listed}, files {burn_files}")
        burn_kernels = read_json(os.path.join(burn, "kernels.json"))
        check_launches("the slo_burn bundle's snapshot", burn_kernels, embed_table)

        # a shadow candidate through /admin/deploy/*, then a forced rollback
        perturbed_step(ckpt, 2, seed=41)
        shadow, _ = post(base + "/admin/deploy/shadow", {"step": 2})
        evidence = attribution.collect_engine_evidence(engine)
        snaps = evidence.get("snapshots") or {}
        deploy_diff = attribution.diff_snapshots(snaps.get("before"), snaps.get("after"))
        rolled, _ = post(base + "/admin/deploy/rollback", {})
        rollback = only_bundle(fdir, "deploy_rollback")
        listed = [b["name"] for b in get(base + "/debug/forensics")["bundles"]]
        if (shadow.get("candidate_step") != 2 or sorted(snaps.get("after") or {}) !=
                list(FORENSICS_BUCKETS) or os.path.basename(rollback) not in listed):
            raise AssertionError(f"deploy: {shadow}, snapshots {sorted(snaps)}, rollback "
                                 f"{rolled}, listed {listed}")
    finally:
        srv.shutdown()
        srv.server_close()

    # the op-diff over a quant change: a bf16 engine's graphs against these
    bf16 = ServingEngine(ckpt, **common, quant="bf16", quality_sample=0.0)
    quant_diff = attribution.diff_snapshots(engine.caches["embed"].snapshots,
                                            bf16.caches["embed"].snapshots)
    free_engines(bf16)
    rows = {r["bucket"]: r for r in (quant_diff or {}).get("buckets", [])}
    if sorted(rows) != list(FORENSICS_BUCKETS) or any(
            r.get("quant") != {"before": "f32", "after": "bf16"} for r in rows.values()):
        raise AssertionError(f"the op-diff over f32 -> bf16: {quant_diff}")

    after = {b: engine.run("embed", xs[b]) for b in FORENSICS_BUCKETS}
    if engine.caches["embed"].poll_captures() != 0 or not all(
            np.array_equal(after[b], before[b]) for b in FORENSICS_BUCKETS):
        raise AssertionError("answers after the bundles and the deploy differ from before, "
                             "or the request path captured")
    free_engines(engine)
    emit({"phase": "forensics", "card": nvidia_smi(),
          "config": {"dim": c.dim, "levels": c.levels, "dtype": "float32", "ff_impl": "pallas",
                     "attention_impl": "pallas", "buckets": list(FORENSICS_BUCKETS)},
          "warmup_s": {"runs": warm, "without_warmup_dir": warm_without,
                       "with_warmup_dir": warm_with, "ratio": warm_with / warm_without},
          "warmup_bundles": tables, "captures": {"without": caps_without, "with": caps_with},
          "launches": launches, "bitwise_eager": list(FORENSICS_BUCKETS),
          "slo_burn": {"bundle": os.path.basename(burn), "files": burn_files,
                       "kernels": burn_kernels, "outcome_ms_max": max(outcome_ms),
                       "outcome_ms_median": statistics.median(outcome_ms)},
          "deploy": {"shadow": shadow, "op_diff_candidate": deploy_diff,
                     "rollback": os.path.basename(rollback), "listed": listed},
          "op_diff_f32_to_bf16": quant_diff, "answers_after_bitwise": True,
          "predicted": FORENSICS_PREDICTED, "seconds": time.perf_counter() - t_phase})
    shutil.rmtree(ckpt, ignore_errors=True)
    shutil.rmtree(work, ignore_errors=True)
    return launches


_TRAIN_KERNELS = {"grouped_ff", "grouped_ff_dx", "grouped_ff_dw", "consensus_attention",
                  "consensus_dkv", "consensus_dq"}
BENCH_LEGS = (
    ("a", "the record configuration: bench's defaults (bf16, remat dots, b=32, K1 forward, "
          "plain FF backward, dense consensus)", ["trace"], {"grouped_ff"}),
    ("b", "all the kernels", ["--ff-impl", "pallas", "--attention-impl", "pallas",
                              "--fused-ff-bwd", "trace"], _TRAIN_KERNELS),
    ("c", "fused", ["--ff-impl", "fused", "--fused-ff-bwd"],
     _TRAIN_KERNELS | {"fused_level_update"}),
    ("d_dots", "the remat repair: plain ops, dots", ["--ff-impl", "dense",
                                                     "--remat-policy", "dots"], set()),
    ("d_full", "the remat repair: plain ops, full", ["--ff-impl", "dense",
                                                     "--remat-policy", "full"], set()),
    ("e", "the train phase's configuration", ["--fp32", "--no-remat", "--ff-impl", "pallas",
                                              "--attention-impl", "pallas", "--fused-ff-bwd",
                                              "--batch-size", str(BATCH)], _TRAIN_KERNELS),
)
# K1's two kernels (csrc/grouped_ff.cu), the name (b)'s trace must hold
K1_KERNELS = ("ff_hidden_kernel", "ff_out_kernel")
# (e)'s rate against the train phase's 1000 * BATCH / step_ms
BENCH_TIE_RTOL = 0.10
BENCH_LEG_TIMEOUT_S = 300
# the timed steps of each leg (bench's default on a card is 20): fewer, to
# keep the whole script inside its time limit
BENCH_LEG_STEPS = ["--steps", "6"]


def bench_leg(flags) -> dict:
    """One run of the bench as a user runs it; its one JSON record."""
    cmd = [sys.executable, "-m", "glom_tpu_torch.tools.bench", *flags]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=BENCH_LEG_TIMEOUT_S)
    records = [line for line in res.stdout.splitlines() if line.startswith("{")]
    if res.returncode != 0 or len(records) != 1:
        raise AssertionError(f"{' '.join(cmd[1:])}: exit {res.returncode}, {len(records)} "
                             f"records\n{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
    return json.loads(records[0])


def trace_summary(logdir: str, steps: int = 3):
    """``(event names, summary)`` of the newest trace in ``logdir``: the CUDA
    kernels' device time a step (their summed durations over ``steps``), by
    name for the eight largest, and the device's busy share of the window
    from the first ``step`` region's start to the last kernel's end."""
    files = trace_files(logdir)
    if not files:
        return set(), {}
    with open(files[-1]) as f:
        events = json.load(f)["traceEvents"]
    by_name, end = {}, 0.0
    for e in events:
        if e.get("cat") == "kernel":
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
            end = max(end, e["ts"] + e["dur"])
    starts = [e["ts"] for e in events if e.get("name") == "step" and e.get("ph") == "X"]
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {e.get("name", "") for e in events}, {
        "kernel_ms_per_step": busy / 1e3 / steps,
        "busy_share": busy / (end - min(starts)) if starts and end > min(starts) else None,
        "top_kernels_ms_per_step": [{"name": k[:80], "ms": v / 1e3 / steps} for k, v in top]}


def phase_bench(smi: str, pallas_step_ms=None) -> dict:
    """``python -m glom_tpu_torch.tools.bench`` at flagship, 12 iterations,
    over the legs of :data:`BENCH_LEGS`: each leg's record on its own line
    with the card's name and power limit; every leg ok, its mfu in (0, 1],
    no build in its window and its kernels launched; the dense leg's peak
    memory under "dots" not below "full"; (a)'s trace naming the step phase,
    (b)'s naming K1's kernels; and, after the train phase, (e)'s rate within
    BENCH_TIE_RTOL of that phase's."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bench_")
    records, traces, device = {}, {}, {}
    try:
        for leg, what, flags, kernels in BENCH_LEGS:
            logdir = os.path.join(tmp, leg)
            argv = [f for f in flags if f != "trace"] + BENCH_LEG_STEPS
            if "trace" in flags:
                argv += ["--profile-dir", logdir]
            rec = bench_leg(argv)
            emit({"phase": "bench", "leg": leg, "what": what, "argv": argv, "record": rec,
                  "nvidia_smi": smi})
            launched = set(rec["launches_per_step"])
            if not (rec["status"] == "ok" and rec["mfu"] is not None and 0 < rec["mfu"] <= 1
                    and rec["builds_in_window"] == 0 and launched >= kernels):
                raise AssertionError(f"bench leg {leg}: status {rec['status']}, mfu {rec['mfu']}, "
                                     f"builds_in_window {rec['builds_in_window']}, launched "
                                     f"{sorted(launched)}, expected {sorted(kernels)}")
            records[leg] = rec
            if "trace" in flags:
                traces[leg], device[leg] = trace_summary(logdir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dots, full = records["d_dots"], records["d_full"]
    if dots["peak_memory_bytes"] < full["peak_memory_bytes"]:
        raise AssertionError(f"remat dots peaked at {dots['peak_memory_bytes']} bytes, below "
                             f"full's {full['peak_memory_bytes']}: dots keeps nothing")
    k1_in = {leg: sorted(k for k in K1_KERNELS if any(k in n for n in names))
             for leg, names in traces.items()}
    if "step" not in traces["a"] or not k1_in["b"]:
        raise AssertionError(f"traces: 'step' in (a) {'step' in traces['a']}, K1's kernels in "
                             f"(b) {k1_in['b']}")
    tie = None
    if pallas_step_ms is not None:
        want = 1e3 * BATCH / pallas_step_ms["kernels"]
        tie = {"bench_imgs_per_s": records["e"]["value"], "train_phase_imgs_per_s": want,
               "ratio": records["e"]["value"] / want, "rtol": BENCH_TIE_RTOL}
        if not abs(tie["ratio"] - 1) <= BENCH_TIE_RTOL:
            raise AssertionError(f"bench leg e against the train phase: {tie}")
    summary = {
        "phase": "bench_summary",
        "imgs_per_s": {leg: r["value"] for leg, r in records.items()},
        "mfu": {leg: r["mfu"] for leg, r in records.items()},
        "peak_memory_bytes": {leg: r["peak_memory_bytes"] for leg, r in records.items()},
        "dots_over_full_peak_memory": dots["peak_memory_bytes"] / full["peak_memory_bytes"],
        "trace": {leg: {"step": "step" in names, "k1_kernels": k1_in[leg], **device[leg]}
                  for leg, names in traces.items()},
        "tie_to_train_phase": tie,
    }
    emit(summary)
    return summary


# large: glom_tpu's large preset (BASELINE.json config 4, bench.py --config
# large), at full width: d=1024, 8 levels, 384/16 (n=576), 16 iterations
LARGE_KW, LARGE_ITERS, LARGE_BATCH, _ = bench_preset("large")
LARGE = GlomConfig(**LARGE_KW)
LARGE_BUCKETS = (1, 2, 4)
# the bench leg: every kernel at the large preset (K1 forward, K2 + K3
# backward, K4 + K6 + K7), a few steps
LARGE_BENCH_FLAGS = ["--config", "large", "--steps", "5", "--warmup", "2", "--ff-impl", "pallas",
                     "--attention-impl", "pallas", "--fused-ff-bwd"]
# the training configurations whose gradient runs the backward kernels at
# d=1024, with their launches per step at loss timestep t: K6 and K7 for
# attention on the kernels; K2 and K3 for the FF's kernel backward; K8, then
# K1, K4, K6 and K7 again in its backward, for the fused step
LARGE_TRAINED = (
    ("attention_pallas", dict(attention_impl="pallas"),
     lambda t: {"consensus_attention": t, "consensus_dkv": t, "consensus_dq": t}),
    ("ff_fused_bwd", dict(ff_impl="pallas", ff_fused_bwd=True),
     lambda t: {"grouped_ff": 2 * t, "grouped_ff_dx": 2 * t, "grouped_ff_dw": 2 * t}),
    ("fused", dict(ff_impl="fused"),
     lambda t: {"fused_level_update": t, "grouped_ff": 2 * t, "consensus_attention": t,
                "consensus_dkv": t, "consensus_dq": t}),
)
# the large kernel rows' timing: fewer samples than the flagship rows (each
# call takes milliseconds), to keep the script inside its time limit
LARGE_REPS, LARGE_INNER = 3, 2


@contextlib.contextmanager
def timing_samples(reps: int, inner: int):
    """time_ms with ``reps`` samples of ``inner`` calls inside the block."""
    global REPS, INNER
    saved = REPS, INNER
    REPS, INNER = reps, inner
    try:
        yield
    finally:
        REPS, INNER = saved


def large_inputs(device):
    """The large preset's seeded weights and inputs: ``(params, lwi (4, 576,
    9, 1024), big (1, 2304, 8, 1024), wide (1, 576, 8, 2048), mask, g_ff,
    g_lv)``; g_ff and g_lv, (4, 576, 8, 1024), are the backward kernels'
    cotangents."""
    gen = torch.Generator().manual_seed(21)
    c = LARGE
    n, L, d = c.num_patches, c.levels, c.dim
    params = glom_model.init(gen, c, device)
    lwi = torch.randn((LARGE_BATCH, n, L + 1, d), generator=gen).to(device)
    big = torch.randn((1, 2304, L, d), generator=gen).to(device)   # 768/16
    wide = torch.randn((1, n, L, 2 * d), generator=gen).to(device)
    mask = glom_model.resolve_locality_mask(
        GlomConfig(**{**LARGE_KW, "local_consensus_radius": 2}), device)
    g_ff = torch.randn((LARGE_BATCH, n, L, d), generator=gen).to(device)
    g_lv = torch.randn((LARGE_BATCH, n, L, d), generator=gen).to(device)
    return params, lwi, big, wide, mask, g_ff, g_lv


def large_kernel_rows(device) -> dict:
    """K1 (bottom-up g=8 strided, top-down g=7), K4 (b=4; the locality mask;
    n=2304, b=1; d=2048, b=1) and K8 (b=4) at the large preset; K2, K3 and
    the pair on the model's two FF calls (bottom-up g=8 strided, top-down
    g=7); K6, K7 and the pair at b=4 (attend_self=False, attend_self=True
    beside SDPA's backward, the locality mask); f32 and bf16, each against
    its plain version with its time, bound and library call, as the kernels
    phase holds them at flagship (K3 held against the float64 sums, its
    plain version's error against them beside it)."""
    params, lwi, big, wide, mask, g_ff, g_lv = large_inputs(device)
    rows = {"grouped_ff": [], "consensus_attention": [], "fused_level_update": [],
            **{name: [] for name in BACKWARD + PAIRS}}
    with timing_samples(LARGE_REPS, LARGE_INNER):
        for dtype in (torch.float32, torch.bfloat16):
            cast = glom_model.tree_map(lambda p: p.to(dtype), params)
            x = lwi.to(dtype)
            pos = cast["pos_emb"][None, :, None, :]
            rows["grouped_ff"] += [
                k1_case(cast["bottom_up"], x[..., :-1, :], dtype,
                        "large bottom_up (strided view, g=8)"),
                k1_case(cast["top_down"], x[..., 2:, :] + pos, dtype, "large top_down (g=7)")]
            lv = x[..., 1:, :]
            rows["consensus_attention"] += [
                consensus_case(lv, dtype, "large b=4", library=True),
                consensus_case(lv, dtype, "large b=4, local_consensus_radius=2", mask=mask),
                consensus_case(big.to(dtype), dtype, "large n=2304 (768/16), b=1", library=True),
                consensus_case(wide.to(dtype), dtype, "d=2048, n=576, b=1", library=True)]
            with torch.inference_mode():
                rows["fused_level_update"].append(
                    fused_case(cast, lv, x[..., :1, :], dtype, "large b=4"))
            g = g_ff.to(dtype)
            for label, p, xx, gg in (
                    ("large bottom_up (strided view, g=8)", cast["bottom_up"], x[..., :-1, :], g),
                    ("large top_down (g=7)", cast["top_down"], (x[..., 2:, :] + pos).contiguous(),
                     g[..., 1:, :].contiguous())):
                k2, hidden = k2_case(p, xx, gg, dtype, label)
                k3 = k3_case(p, xx, gg, hidden, dtype, label, k2["kernel_ms"], exact_gate=True)
                del hidden
                pair = pair_case(p, xx, gg, dtype, label, k2["kernel_ms"], k3["kernel_ms"])
                for r in (k2, k3, pair):
                    rows[r["kernel"]].append(r)
            gl = g_lv.to(dtype)
            for r in (consensus_bwd_case(lv, gl, dtype, "large b=4")
                      + consensus_bwd_case(lv, gl, dtype, "large b=4, attend_self=True",
                                           attend_self=True)
                      + consensus_bwd_case(lv, gl, dtype, "large b=4, local_consensus_radius=2",
                                           mask=mask)):
                rows[r["kernel"]].append(r)
            del cast, x, lv, g, gl
    for kernel, r in rows.items():
        emit({"phase": "large", "part": "kernels", "kernel": kernel, "rows": r,
              **({"stages": K8_STAGES, "library_note": K8_NOTE}
                 if kernel == "fused_level_update" else {})})
    return rows


def replays_ms(cache, bucket: int, reps: int = 3) -> float:
    """Device time of one replay of ``cache``'s graph at ``bucket``: CUDA
    events around ``reps`` replays after one more, the mean (a large-preset
    replay takes up to 0.2 s, too long for time_ms's 123)."""
    graph = cache._graphs[bucket].graph
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def large_serving(device) -> dict:
    """A seeded large-preset checkpoint served on /embed from the engine's
    CUDA graphs at buckets 1, 2 and 4, over HTTP: "pallas" in f32 (K1 32 and
    K4 16 launches a forward), "fused" in f32 (K8 16), "pallas" in bf16;
    each answer against the plain path on the card in the engine's mode (f32
    within SERVE_ATOL, bf16 within BF16_PATH_RTOL relative), the launches
    counted through the replays (the main path: counts set to 0 just before
    the requests, read just after), the b=4 replay bitwise its eager
    forward and timed."""
    c = LARGE
    ckpt = os.path.join(ROOT, "build", "chip_smoke_large_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    make_demo_checkpoint(ckpt, config=c, seed=0)
    ckpt_s = time.perf_counter() - t0
    rng = np.random.default_rng(21)
    shape = (c.channels, c.image_size, c.image_size)
    imgs = {k: rng.standard_normal((k,) + shape).astype(np.float32) for k in LARGE_BUCKETS}
    plan = tuple(("embed", k) for k in LARGE_BUCKETS)
    it = LARGE_ITERS
    legs, launches = {}, {}
    try:
        for name, kw, per_forward in (
                ("pallas_f32", dict(ff_impl="pallas", attention_impl="pallas"),
                 {"grouped_ff": 2 * it, "consensus_attention": it}),
                ("fused_f32", dict(ff_impl="fused", attention_impl="pallas"),
                 {"fused_level_update": it}),
                ("pallas_bf16", dict(ff_impl="pallas", attention_impl="pallas", quant="bf16"),
                 {"grouped_ff": 2 * it, "consensus_attention": it})):
            t0 = time.perf_counter()
            engine = ServingEngine(ckpt, device=device, buckets=LARGE_BUCKETS, iters=it,
                                   quality_sample=0.0, **kw)
            start_s = time.perf_counter() - t0
            reset_launches()
            health, requests, outs, served = serve_requests(engine, plan, imgs)
            got = launch_counts()
            want = {k: per_forward.get(k, 0) * len(plan) for k in got}
            check_launches(f"large serving {name}", got, want)
            errs = {}
            with torch.inference_mode():
                for k in LARGE_BUCKETS:
                    plain = plain_embed_fn(engine)(engine.params,
                                                   torch.from_numpy(imgs[k]).to(device)).cpu()
                    errs[k] = (float((torch.from_numpy(outs[("embed", k)]) - plain).abs().max())
                               if engine.quant == "f32" else
                               rel_err(torch.from_numpy(outs[("embed", k)]), plain))
            limit = SERVE_ATOL if engine.quant == "f32" else BF16_PATH_RTOL
            if not max(errs.values()) <= limit:
                raise AssertionError(f"large serving {name}: /embed from the plain path by "
                                     f"{errs} (limit {limit})")
            b4 = imgs[LARGE_BUCKETS[-1]]
            bitwise = bool(np.array_equal(engine.run("embed", b4), engine.run_eager("embed", b4)))
            if not bitwise:
                raise AssertionError(f"large serving {name}: the b=4 replay differs from its "
                                     f"eager forward")
            legs[name] = {
                "health": {k: health.get(k) for k in ("ff_impl", "attention_impl", "quant")},
                "start_seconds": start_s, "requests": requests, "launches": got,
                "launches_per_forward": per_forward, "embed_vs_plain": errs,
                "embed_vs_plain_kind": "max_abs" if engine.quant == "f32" else "rel",
                "limit": limit, "b4_replay_bitwise_eager": bitwise,
                "embed_replay_ms": {LARGE_BUCKETS[-1]: replays_ms(engine.caches["embed"],
                                                                  LARGE_BUCKETS[-1])},
                "pool_bytes": engine.graph_pool_bytes(), **served}
            if name != "pallas_bf16":
                for k, v in got.items():
                    launches[k] = launches.get(k, 0) + v
            free_engines(engine)
            del engine
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    emit({"phase": "large", "part": "serving", "config": {
        "dim": c.dim, "levels": c.levels, "image_size": c.image_size,
        "patch_size": c.patch_size, "num_patches": c.num_patches, "iters": it,
        "buckets": list(LARGE_BUCKETS)}, "checkpoint_seconds": ckpt_s, "legs": legs})
    return launches


def large_training(device) -> tuple:
    """One denoising train step at the large preset, b=4, f32, for each of
    LARGE_TRAINED's configurations (attention on the kernels, the FF's kernel
    backward, the fused step): the Trainer's step with every count set to 0
    just before it and read just after (the main path: exact launches a
    step), the step's loss and gradients against the plain path's (the same
    params, image and noise), and two runs of one step from the same state
    bitwise.  Beside it, for the measured crossover's row: what "auto"
    picks at the large preset on this card (it must be "pallas", as
    ``glom_tpu``'s rule picks), and one step on "dense" and on "pallas"
    attention (the first configuration against the plain path), timed,
    gating nothing.  Returns ``(report, launches)``, the launches summed
    over the configurations."""
    gen = torch.Generator().manual_seed(22)
    shape = (LARGE_BATCH, LARGE.channels, LARGE.image_size, LARGE.image_size)
    img = torch.randn(shape, generator=gen).to(device)
    noise = torch.randn(shape, generator=gen).to(device)
    tc = TrainConfig(batch_size=LARGE_BATCH, iters=LARGE_ITERS)
    t = denoise.resolve_loss_timestep(tc, LARGE_ITERS)
    report, launches, step_ms = {}, {}, {}
    for name, kw, want_fn in LARGE_TRAINED:
        c = GlomConfig(**{**LARGE_KW, **kw})
        trainer = Trainer(c, tc, device=device)
        reset_launches()
        metrics = trainer.step(img, noise=noise)
        torch.cuda.synchronize()
        got = launch_counts()
        want = {k: want_fn(t).get(k, 0) for k in got}
        check_launches(f"large train step {name}", got, want)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        grad = grads_vs_plain(c, tc, trainer.state.params, img, noise)
        step = denoise.make_step_fn(c, tc, trainer.optimizer)
        (s1, m1), (s2, m2) = (step(trainer.state, img, noise=noise),
                              step(trainer.state, img, noise=noise))
        bitwise = all(torch.equal(a, b) for a, b in zip(glom_model.tree_leaves(s1.params),
                                                        glom_model.tree_leaves(s2.params)))
        if not (bitwise and torch.equal(m1["loss"], m2["loss"])):
            raise AssertionError(f"large train step {name}: two runs of one step differ")
        del s1, s2, m1, m2
        step_ms[name] = host_ms(lambda: step(trainer.state, img, noise=noise))[0]
        if name == "attention_pallas":
            plain = denoise.make_step_fn(plain_of(c), tc, trainer.optimizer)
            plain(trainer.state, img, noise=noise)
            step_ms["dense"] = host_ms(lambda: plain(trainer.state, img, noise=noise))[0]
            del plain
        report[name] = {"config": kw, "loss": float(metrics["loss"]), "launches": got,
                        "grad_vs_plain": grad, "bitwise_repeat": bitwise,
                        "step_ms": step_ms[name]}
        del trainer, step
        gc.collect()
        torch.cuda.empty_cache()
    auto = glom_model.resolve_auto_attention(GlomConfig(**{**LARGE_KW, "attention_impl": "auto"}),
                                             device)
    if auto != "pallas":
        raise AssertionError(f"attention_impl='auto' at the large preset picks {auto!r}, where "
                             f"glom_tpu's rule picks its kernels")
    report["crossover_check"] = {
        "n": LARGE.num_patches, "h100_row": glom_model.ATTENTION_CROSSOVER_N["H100"],
        "auto_picks": auto, "dense_step_ms": step_ms["dense"],
        "pallas_step_ms": step_ms["attention_pallas"],
        "note": "one f32 train step (forward and backward, Adam), FF on the plain ops in both, "
                "after a warm one, on the host's clock; timed, gates nothing"}
    return {"loss_timestep": t, "batch": LARGE_BATCH, "iters": LARGE_ITERS, **report}, launches


def phase_large(device, smi: str) -> tuple:
    """The large preset through the port on one card: (i) the kernel rows,
    (ii) serving /embed from CUDA graphs on "pallas" and "fused", (iii)
    ``python -m glom_tpu_torch.tools.bench --config large`` through every
    kernel (K1-K4, K6, K7), its record with the card's name and power
    limit, (iv) a train step of each configuration whose gradient runs the
    backward kernels at d=1024.
    Returns the serving path's launches, the kernel rows and the train
    steps' launches."""
    seconds = {}
    t0 = time.perf_counter()
    rows = large_kernel_rows(device)
    seconds["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches = large_serving(device)
    seconds["serving"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kern = bench_leg(LARGE_BENCH_FLAGS)
    if not (kern["status"] == "ok" and kern["mfu"] is not None and 0 < kern["mfu"] <= 1
            and kern["builds_in_window"] == 0 and kern["attention_impl"] == "pallas"
            and kern["batch"] == LARGE_BATCH
            and all(kern["launches_per_step"].get(k, 0) > 0
                    for k in ("grouped_ff", "consensus_attention") + BACKWARD)):
        raise AssertionError(f"large bench leg (b): {kern}")
    emit({"phase": "large", "part": "bench", "legs": {
        "b": {"argv": LARGE_BENCH_FLAGS, "record": kern}}, "nvidia_smi": smi})
    seconds["bench"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report, train_launches = large_training(device)
    seconds["train"] = time.perf_counter() - t0
    emit({"phase": "large", "part": "train", **report, "part_seconds": seconds})
    return launches, rows, train_launches


# -- widths off the kernels' multiples: the tiny preset and the demo ------------
# glom_tpu's tiny preset (bench.py --config tiny: d=64, 3 levels, 64/8, n=64,
# h=256), which the kernels run zero-padded to d=128, and the 16-wide demo
# model (make_demo_checkpoint's DEMO_CONFIG: 3 levels, 16/8, n=4, h=64)
TINY_KW, TINY_ITERS, TINY_BATCH, _ = bench_preset("tiny")
TINY = GlomConfig(**TINY_KW)
# the tiny train steps whose gradients run the kernels at d=64, with their
# launches a step at loss timestep t (as LARGE_TRAINED)
TINY_TRAINED = (
    ("pallas_ff_fused_bwd", dict(ff_impl="pallas", ff_fused_bwd=True, attention_impl="pallas"),
     lambda t: want_launches(t, t)),
    ("fused", dict(ff_impl="fused"),
     lambda t: {**want_launches(t, t), "fused_level_update": t, "grouped_ff_dx": 0,
                "grouped_ff_dw": 0}),
)
DEMO_BUCKETS = (1, 8)


def device_time(fn, calls: int = 20) -> dict:
    """``fn``'s device work a call from a torch.profiler trace of ``calls``
    calls: every device operation's time (kernels, the pad copies and fills
    included) and their count.  A call of a few microseconds of device work
    is bound by the host's issue rate, which CUDA events around back-to-back
    calls measure instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
             for e in ops)
    return {"device_ms": us / 1e3 / calls, "device_ops": sum(e.count for e in ops) / calls}


def narrow_inputs(device, c: GlomConfig, b: int, seed: int):
    """Seeded weights of ``c`` and ``(b, n, L+1, d)`` state, FF and level
    cotangents on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    n, L, d = c.num_patches, c.levels, c.dim
    params = glom_model.init(gen, c, device)
    lwi = torch.randn((b, n, L + 1, d), generator=gen).to(device)
    g_ff = torch.randn((b, n, L, d), generator=gen).to(device)
    g_lv = torch.randn((b, n, L, d), generator=gen).to(device)
    return params, lwi, g_ff, g_lv


def with_device_time(row: dict, call, library=None) -> dict:
    """``row`` with its call's device time (device_time), and its library
    call's where it has one."""
    row.update({f"kernel_{k}": v for k, v in device_time(call).items()})
    if library is not None:
        row.update({f"library_{k}": v for k, v in device_time(library).items()})
    return row


def narrow_kernel_rows(device) -> dict:
    """Every kernel at the tiny preset (b=8, d=64, h=256; the wrappers pad
    d to 128) and K1 and K4 at the demo's d=16 (b=8, h=64), in float32 and
    bfloat16, each against its plain version at the usual limits, with its
    CUDA-event time, its plain version's, its bound at the true width, its
    library call where one exists (SDPA for K4 and K6 + K7, the plain f32
    FF VJP for K2 + K3) and, from torch.profiler, the device time of a call
    (the pad copies and the slice included) beside SDPA's."""
    rows = {name: [] for name in ("grouped_ff", "consensus_attention", "fused_level_update")
            + BACKWARD + PAIRS}
    tiny = narrow_inputs(device, TINY, TINY_BATCH, 23)
    demo = narrow_inputs(device, DEMO_CONFIG, TINY_BATCH, 24)
    for dtype in (torch.float32, torch.bfloat16):
        for tag, (params, lwi, g_ff, g_lv), everything in (("tiny", tiny, True),
                                                            ("demo d=16", demo, False)):
            cast = glom_model.tree_map(lambda p: p.to(dtype), params)
            x = lwi.to(dtype)
            pos = cast["pos_emb"][None, :, None, :]
            bu, td = cast["bottom_up"], cast["top_down"]
            xb, xt = x[..., :-1, :], (x[..., 2:, :] + pos).contiguous()
            lv = x[..., 1:, :]
            g = len(bu["b2"])
            rows["grouped_ff"].append(with_device_time(
                k1_case(bu, xb, dtype, f"{tag} b=8 bottom_up (strided view, g={g})"),
                lambda: ff_kernel.grouped_ff(bu, xb)))
            for attend_self in (False, True):
                label = f"{tag} b=8" + (", attend_self=True" if attend_self else "")
                rows["consensus_attention"].append(with_device_time(
                    consensus_case(lv, dtype, label, attend_self=attend_self, library=attend_self),
                    lambda: consensus_kernel.consensus_attention(lv, attend_self=attend_self),
                    sdpa_call(lv, dtype) if attend_self else None))
            if not everything:
                continue
            rows["grouped_ff"].append(with_device_time(
                k1_case(td, xt, dtype, f"{tag} b=8 top_down (g={g - 1})"),
                lambda: ff_kernel.grouped_ff(td, xt)))
            with torch.inference_mode():
                rows["fused_level_update"].append(with_device_time(
                    fused_case(cast, lv, x[..., :1, :], dtype, f"{tag} b=8"),
                    lambda: fused_kernel.fused_level_update(bu, td, lv, x[..., :1, :], pos)))
            gf = g_ff.to(dtype)
            for label, p, xx, gg in ((f"{tag} b=8 bottom_up (strided view, g={g})", bu, xb, gf),
                                     (f"{tag} b=8 top_down (g={g - 1})", td, xt,
                                      gf[..., 1:, :].contiguous())):
                k2, hidden = k2_case(p, xx, gg, dtype, label)
                k3 = k3_case(p, xx, gg, hidden, dtype, label, k2["kernel_ms"])
                del hidden
                pair = pair_case(p, xx, gg, dtype, label, k2["kernel_ms"], k3["kernel_ms"])
                p32, x32, g32 = f32(p), xx.float(), gg.float()
                with_device_time(pair, lambda: ff_kernel.grouped_ff_backward(p, xx, gg),
                                 lambda: ff_kernel.plain_vjp(p32, x32, g32))
                for r in (k2, k3, pair):
                    rows[r["kernel"]].append(r)
            gl = g_lv.to(dtype)
            for attend_self in (False, True):
                label = f"{tag} b=8" + (", attend_self=True" if attend_self else "")
                bwd = consensus_bwd_case(lv, gl, dtype, label, attend_self=attend_self)
                pair = next(r for r in bwd if r["kernel"] == "consensus_dkv+consensus_dq")
                with torch.no_grad():
                    out, lse = consensus_kernel.consensus_attention(lv, attend_self=attend_self)
                with_device_time(pair, lambda: consensus_kernel.consensus_backward(
                    lv, None, out, lse, gl, attend_self=attend_self),
                    sdpa_backward_call(lv, gl, dtype) if attend_self else None)
                for r in bwd:
                    rows[r["kernel"]].append(r)
    for kernel, r in rows.items():
        emit({"phase": "kernels", "part": "narrow", "kernel": kernel, "rows": r,
              **({"stages": K8_STAGES, "library_note": K8_NOTE}
                 if kernel == "fused_level_update" else {})})
    return rows


def phase_widths(device) -> dict:
    """The main paths at widths off the kernels' multiples, through the
    wrappers' zero padding: (i) one f32 train step at the tiny preset (b=8,
    d=64) of a Trainer on "pallas" with ff_fused_bwd and on "fused" (the
    main path: counts set to 0 just before, read just after), launches
    exact, loss and gradients within GRAD_RTOL of the plain path, two runs
    of one step bitwise; (ii) /embed on the 16-wide demo checkpoint from
    the engine's graphs at buckets 1 and 8 over HTTP on "pallas" and on
    "fused" (launches exact, each answer within SERVE_ATOL of the plain
    path); (iii) "auto" at the tiny preset picks the kernels; (iv) the
    kernels' digests at flagship shapes (tools/kernel_digest.py), for a
    comparison with another checkout on the same card.  Returns the
    launches of (i) and (ii)."""
    from glom_tpu_torch.tools import kernel_digest

    launches, report = {}, {}
    gen = torch.Generator().manual_seed(25)
    shape = (TINY_BATCH, TINY.channels, TINY.image_size, TINY.image_size)
    img = torch.randn(shape, generator=gen).to(device)
    noise = torch.randn(shape, generator=gen).to(device)
    tc = TrainConfig(batch_size=TINY_BATCH, iters=TINY_ITERS)
    t = denoise.resolve_loss_timestep(tc, TINY_ITERS)
    for name, kw, want_fn in TINY_TRAINED:
        c = GlomConfig(**{**TINY_KW, **kw})
        trainer = Trainer(c, tc, device=device)
        reset_launches()
        metrics = trainer.step(img, noise=noise)
        torch.cuda.synchronize()
        got = launch_counts()
        check_launches(f"tiny train step {name}", got, {k: want_fn(t).get(k, 0) for k in got})
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        grad = grads_vs_plain(c, tc, trainer.state.params, img, noise)
        step = denoise.make_step_fn(c, tc, trainer.optimizer)
        (s1, m1), (s2, m2) = (step(trainer.state, img, noise=noise),
                              step(trainer.state, img, noise=noise))
        bitwise = all(torch.equal(a, b) for a, b in zip(glom_model.tree_leaves(s1.params),
                                                        glom_model.tree_leaves(s2.params)))
        if not (bitwise and torch.equal(m1["loss"], m2["loss"])):
            raise AssertionError(f"tiny train step {name}: two runs of one step differ")
        report[name] = {"config": kw, "loss": float(metrics["loss"]), "launches": got,
                        "grad_vs_plain": grad, "bitwise_repeat": bitwise,
                        "step_ms": host_ms(lambda: step(trainer.state, img, noise=noise))[0]}
        del trainer, step, s1, s2
    emit({"phase": "widths", "part": "train", "config": TINY_KW, "batch": TINY_BATCH,
          "iters": TINY_ITERS, "loss_timestep": t, **report})
    ckpt = os.path.join(ROOT, "build", "chip_smoke_demo16_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    make_demo_checkpoint(ckpt, seed=0)
    rng = np.random.default_rng(26)
    legs = {}
    try:
        for name, kw in (("pallas", dict(ff_impl="pallas", attention_impl="pallas")),
                         ("fused", dict(ff_impl="fused", attention_impl="pallas"))):
            engine = ServingEngine(ckpt, device=device, buckets=DEMO_BUCKETS, quality_sample=0.0,
                                   **kw)
            c, it = engine.config, engine.embed_iters
            if c.dim != 16:
                raise AssertionError(f"the demo checkpoint is {c.dim} wide, not glom_tpu's 16")
            imgs = {k: rng.standard_normal((k, c.channels, c.image_size, c.image_size)).astype(
                np.float32) for k in DEMO_BUCKETS}
            plan = tuple(("embed", k) for k in DEMO_BUCKETS)
            per_forward = ({"grouped_ff": 2 * it, "consensus_attention": it} if name == "pallas"
                           else {"fused_level_update": it})
            reset_launches()
            health, requests, outs, served = serve_requests(engine, plan, imgs)
            got = check_launches(f"demo /embed {name}", launch_counts(),
                                 {k: per_forward.get(k, 0) * len(plan)
                                  for k in kernel_wrappers()})
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
            with torch.inference_mode():
                errs = {k: float((torch.from_numpy(outs[("embed", k)]) - plain_embed_fn(engine)(
                    engine.params, torch.from_numpy(imgs[k]).to(device)).cpu()).abs().max())
                        for k in DEMO_BUCKETS}
            if not max(errs.values()) <= SERVE_ATOL:
                raise AssertionError(f"demo /embed {name}: {errs} from the plain path "
                                     f"(limit {SERVE_ATOL})")
            legs[name] = {"health": {k: health.get(k) for k in ("ff_impl", "attention_impl",
                                                                 "dim")},
                          "requests": requests, "launches": got, "embed_vs_plain": errs,
                          "limit": SERVE_ATOL, **served}
            free_engines(engine)
            del engine
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    emit({"phase": "widths", "part": "demo", "config": {
        "dim": c.dim, "levels": c.levels, "image_size": c.image_size, "patch_size": c.patch_size,
        "iters": it, "buckets": list(DEMO_BUCKETS)}, "legs": legs})
    auto = glom_model.resolve_auto_attention(GlomConfig(**{**TINY_KW, "attention_impl": "auto"}),
                                             device)
    if auto != "pallas":
        raise AssertionError(f"attention_impl='auto' at the tiny preset picks {auto!r}, where "
                             f"glom_tpu's rule picks its kernels")
    emit({"phase": "widths", "part": "auto", "n": TINY.num_patches, "dim": TINY.dim,
          "h100_row": glom_model.ATTENTION_CROSSOVER_N["H100"], "auto_picks": auto})
    emit({"phase": "widths", "part": "kernel_digest", "shapes": "flagship (d=512)",
          "digests": kernel_digest.digests(device)})
    return launches


# the chaos scenarios the full script runs (their smoke variants): the five
# train and reload scenarios and replica_kill; --only chaos runs all eleven
CHAOS_FULL_RUN = ("torn_ckpt_write", "corrupt_restore", "nan_batch", "reload_io_error",
                  "train_crash", "replica_kill")


def phase_chaos(device, everything: bool = False) -> dict:
    """The port's chaos suite (glom_tpu_torch/tools/chaos.py) on the card,
    smoke variants, in this process: CHAOS_FULL_RUN, or with ``everything``
    all eleven scenarios; each scenario's outcome, MTTR and wall seconds on
    a line of its own; every one must recover.  The loops run the plain
    ops, as glom_tpu's defaults do: no kernel launches."""
    from glom_tpu_torch.tools import chaos

    names = chaos.PORTED if everything else CHAOS_FULL_RUN
    reset_launches()
    t0 = time.perf_counter()
    results = chaos.run(names, soak=False, device=str(device), quiet=True)
    seconds = time.perf_counter() - t0
    got = launch_counts()
    for rec in results:
        emit({"phase": "chaos", **{k: v for k, v in rec.items() if k != "traceback"}})
    failed = [r for r in results if r["outcome"] != "recovered"]
    emit({"phase": "chaos", "mode": "smoke", "recovered": len(results) - len(failed),
          "total": len(results), "seconds": seconds})
    if failed:
        raise AssertionError(f"chaos: {[r['scenario'] for r in failed]} did not recover:\n"
                             + "\n".join(r.get("traceback", r.get("error", "")) for r in failed))
    return got


# -- the mesh phase: multi-GPU training on one card ------------------------

# one rank of the two that share the card over gloo: each case a Trainer on
# the (2, 1, 1) / (1, 2, 1) / (1, 1, 2) mesh at flagship width, MESH_STEPS
# steps on the batches and noise the parent wrote (chip_smoke.mesh_run);
# rank 0 saves the losses, grad norms, gathered parameters and first
# moments, every rank prints its launches a step and its step times
MESH_RANK_CHILD = r'''
import io, json, os, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist
from chip_smoke import mesh_run, mesh_snapshot
from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.kernels import wrappers
from glom_tpu_torch.parallel.mesh import initialize_distributed
from glom_tpu_torch.training.metrics import MetricLogger
from glom_tpu_torch.training.trainer import Trainer

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
work, rank = sys.argv[2], int(sys.argv[3])
spec = json.load(open(os.path.join(work, "spec.json")))
# gloo named for CUDA tensors: both ranks run on the one card
device = initialize_distributed("file://" + os.path.join(work, "store"), 2, rank,
                                device="cuda:0", backend="gloo", timeout_s=300)
data = np.load(os.path.join(work, "batches.npz"))
for case in spec["cases"]:
    config = GlomConfig(**case["config"])
    train = TrainConfig(**case["train"], mesh_shape=tuple(case["mesh"]))
    trainer = Trainer(config, train, device=device, logger=MetricLogger(stream=io.StringIO()))
    fns = wrappers()
    for fn in fns.values():
        fn.launches = 0
    run = mesh_run(trainer, data, device)
    steps = len(data["imgs"])
    launches = {k: fn.launches for k, fn in fns.items()}
    flat = mesh_snapshot(trainer)
    if rank == 0:
        np.savez(os.path.join(work, case["name"] + ".npz"), loss=np.asarray(run["loss"]),
                 grad_norm=np.asarray(run["grad_norm"]), **flat)
    print(json.dumps({"case": case["name"], "rank": rank, "mesh": case["mesh"],
                      "device": torch.cuda.get_device_name(device), "backend": dist.get_backend(),
                      "coords": trainer.mesh.coords, "launches": launches,
                      "launches_per_step": {k: v / steps for k, v in launches.items()}, **run,
                      "local_w1": {net: list(trainer.state.params["glom"][net]["w1"].shape)
                                   for net in ("bottom_up", "top_down")}}), flush=True)
    del trainer, flat
    torch.cuda.empty_cache()
dist.destroy_process_group()
'''

# a world of one over NCCL through the training CLI (--mesh 1 1 1
# --num-processes 1 --coordinator localhost:PORT): the backend it started,
# then the launches of the CLI's steps
MESH_NCCL_CHILD = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import torch.distributed as dist
from glom_tpu_torch.kernels import wrappers
from glom_tpu_torch.training import train

seen = []
_init = dist.init_process_group

def init(*args, **kwargs):
    _init(*args, **kwargs)
    seen.append({"backend": dist.get_backend(), "world": dist.get_world_size()})

dist.init_process_group = init
final = train.main(sys.argv[2:])
print(json.dumps({"process_group": seen, "final": final,
                  "launches": {k: fn.launches for k, fn in wrappers().items()}}), flush=True)
'''

MESH_STEPS = 2
MESH_TIMEOUT_S = 600
MESH_RTOL = 1e-4


def mesh_kernels(**kw) -> dict:
    return {**FLAGSHIP.to_json_dict(), "ff_impl": "pallas", "ff_fused_bwd": True,
            "attention_impl": "pallas", **kw}


# (name, mesh, config, train, launches a step on each rank at loss timestep t)
MESH_CASES = (
    ("dp_fused", (2, 1, 1), mesh_kernels(ff_impl="fused"), dict(param_sharding="replicated"),
     lambda t: {**want_launches(t, t), "fused_level_update": t}),
    ("tp", (1, 2, 1), mesh_kernels(), dict(param_sharding="tp"), lambda t: want_launches(t, t)),
    ("ring", (1, 1, 2), mesh_kernels(attention_impl="ring"), dict(param_sharding="replicated"),
     lambda t: {**want_launches(t, t), "consensus_attention": 0, "consensus_dkv": 0,
                "consensus_dq": 0}),
    ("ulysses", (1, 1, 2), mesh_kernels(attention_impl="ulysses"),
     dict(param_sharding="replicated"),
     lambda t: {**want_launches(t, t), "consensus_attention": 0, "consensus_dkv": 0,
                "consensus_dq": 0}),
    ("ep", (1, 2, 1), mesh_kernels(), dict(param_sharding="ep"), lambda t: want_launches(t, t)),
)
# written before the first run on the card (PERF.md §6, the mesh entry): a rank's step
# time over the one-rank step's, with the gloo staging through the host
MESH_PREDICTED = {"tp_over_one_rank": [2.0, 5.0], "ring_over_one_rank": [1.5, 4.0],
                  "dp_fused_over_one_rank": [1.0, 2.0], "rel_err": 1e-5, "seconds": [60, 120]}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_run(trainer, data, device) -> dict:
    """A step of ``trainer`` on each of ``data``'s batches with its noise:
    the loss and the logged grad norm of each step, and the step times."""
    run = {"loss": [], "grad_norm": [], "step_ms": []}
    for k in range(len(data["imgs"])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.step(data["imgs"][k], noise=torch.from_numpy(data["noise"][k]).to(device))
        run["loss"].append(float(m["loss"]))
        run["grad_norm"].append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        run["step_ms"].append((time.perf_counter() - t0) * 1e3)
    return run


def mesh_snapshot(trainer) -> dict:
    """The trainer's parameters and Adam's first moments (``(1 - b1)`` times
    a weighted sum of the steps' gradients, so a gradient scaled wrong shows
    there, where Adam's update hides it), gathered and flat."""
    state = trainer.state
    return ckpt_lib.flatten({
        name: gather_to_host(tree, trainer.mesh, trainer._specs)
        for name, tree in (("params", state.params), ("mu", state.opt_state["mu"]))})


def mesh_reference(case, data, device) -> tuple:
    """The one-rank Trainer on the card from the same seed, batches and noise
    (ring and Ulysses are the consensus kernels on one rank): its run
    (:func:`mesh_run`) and its snapshot after the steps."""
    name, _, cfg, tc, _ = case
    cfg = {**cfg, "attention_impl": "pallas"} if cfg["attention_impl"] in ("ring", "ulysses") \
        else cfg
    trainer = Trainer(GlomConfig(**cfg), TrainConfig(batch_size=BATCH, **tc), device=device,
                      logger=MetricLogger(stream=open(os.devnull, "w")))
    run = mesh_run(trainer, data, device)
    after = mesh_snapshot(trainer)
    del trainer
    torch.cuda.empty_cache()
    return run, after



def phase_mesh(device) -> dict:
    """Multi-GPU training on the one card: (i) a world of one over NCCL
    through ``python -m glom_tpu_torch.training.train --mesh 1 1 1
    --num-processes 1 --coordinator localhost:PORT`` (the production
    backend's start-up and collectives; flagship, b=8, 2 steps on the
    kernels, launches exact); (ii) two ranks sharing the card over gloo
    (NCCL refuses two ranks on one device), each running the kernels on
    cuda:0, the collectives gloo does not take on CUDA tensors staged
    through pinned host copies: (2, 1, 1) DP with ``ff_impl="fused"`` (K8 a
    rank), (1, 2, 1) TP (K1/K2/K3 at h=1024 a rank), (1, 1, 2) ring and
    Ulysses (n=128 columns a rank) and (1, 2, 1) EP (bottom-up's 6 groups
    split, top-down's 5 replicated), flagship f32 b=8, MESH_STEPS steps
    each; every rank's launches a step exact, and each step's loss and
    logged grad norm, every parameter after the steps and each of Adam's
    first moments within MESH_RTOL of the one-rank step on the card from
    the same seed, batches and noise.  Returns the launches of (i) and
    (ii), every rank and case."""
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="mesh-")
    rng = np.random.default_rng(31)
    shape = (MESH_STEPS, BATCH, 3, FLAGSHIP.image_size, FLAGSHIP.image_size)
    data = {"imgs": rng.standard_normal(shape).astype(np.float32),
            "noise": rng.standard_normal(shape).astype(np.float32)}
    np.savez(os.path.join(work, "batches.npz"), **data)
    cases = [{"name": name, "mesh": list(mesh), "config": cfg,
              "train": dict(batch_size=BATCH, **tc)} for name, mesh, cfg, tc, _ in MESH_CASES]
    with open(os.path.join(work, "spec.json"), "w") as f:
        json.dump({"cases": cases}, f)
    torch.cuda.empty_cache()
    t = denoise.resolve_loss_timestep(TrainConfig(), FLAGSHIP.default_iters)
    env = {**os.environ, "OMP_NUM_THREADS": "4"}
    nccl_argv = ["--mesh", "1", "1", "1", "--num-processes", "1", "--process-id", "0",
                 "--coordinator", f"localhost:{free_port()}", "--steps", str(MESH_STEPS),
                 "--batch-size", str(BATCH), "--log-every", "1", "--ff-impl", "pallas",
                 "--fused-ff-bwd", "--attention-impl", "pallas"]
    nccl = subprocess.run([sys.executable, "-c", MESH_NCCL_CHILD, ROOT, *nccl_argv],
                          capture_output=True, text=True, timeout=MESH_TIMEOUT_S, env=env)
    ranks = [subprocess.Popen([sys.executable, "-c", MESH_RANK_CHILD, ROOT, work, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=MESH_TIMEOUT_S) for p in ranks]
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
    if nccl.returncode != 0:
        raise AssertionError(f"mesh: the NCCL world of one failed:\n{nccl.stderr[-3000:]}")
    lines = nccl.stdout.strip().splitlines()
    one = json.loads(lines[-1])
    # the CLI's records, one a step (--log-every 1): the step time of each
    records = [json.loads(line) for line in lines[:-1] if line.startswith("{\"step\"")]
    one["step_ms"] = [1e3 * BATCH / r["imgs_per_sec"] for r in records if "imgs_per_sec" in r]
    if one["process_group"] != [{"backend": "nccl", "world": 1}]:
        raise AssertionError(f"mesh: the CLI started {one['process_group']}, not NCCL of one")
    want_one = {k: MESH_STEPS * v for k, v in want_launches(t, t).items()}
    check_launches("mesh (i) NCCL world of one", one["launches"], want_one)
    if not np.isfinite(one["final"]["loss"]):
        raise AssertionError(f"mesh (i): loss {one['final']}")
    emit({"phase": "mesh", "part": "nccl_world_of_one", "argv": nccl_argv, **one})
    for r, (out, err) in enumerate(outs):
        if ranks[r].returncode != 0:
            raise AssertionError(f"mesh: gloo rank {r} failed:\n{err[-4000:]}")
    records = [json.loads(line) for out, _ in outs for line in out.splitlines()
               if line.startswith("{")]
    total = dict(one["launches"])
    for case in MESH_CASES:
        name, mesh, cfg, tc, want = case
        recs = [r for r in records if r["case"] == name]
        if sorted(r["rank"] for r in recs) != [0, 1]:
            raise AssertionError(f"mesh {name}: ranks {[r['rank'] for r in recs]}")
        for r in recs:
            check_launches(f"mesh {name} rank {r['rank']} a step", r["launches_per_step"],
                           {k: float(v) for k, v in want(t).items()})
            if r["backend"] != "gloo" or r["device"] != torch.cuda.get_device_name(0):
                raise AssertionError(f"mesh {name}: {r['backend']} on {r['device']}")
            for k, v in r["launches"].items():
                total[k] = total.get(k, 0) + v
        ref, after = mesh_reference(case, data, device)
        got = np.load(os.path.join(work, f"{name}.npz"))
        # each step's loss and global grad norm, each parameter, and each
        # first moment: Adam's update is near lr * sign(g), which a gradient
        # scaled by a constant leaves as it is, but the moment is linear in g
        errs = {f"{k}[{i}]": rel_err(got[k][i], ref[k][i])
                for k in ("loss", "grad_norm") for i in range(MESH_STEPS)}
        errs.update({k: rel_err(got[k], v) for k, v in after.items()})
        worst = max(errs, key=errs.get)
        rec = {"phase": "mesh", "case": name, "mesh": list(mesh),
               "param_sharding": tc["param_sharding"], "attention_impl": cfg["attention_impl"],
               "ff_impl": cfg["ff_impl"], "loss": ref["loss"], "grad_norm": ref["grad_norm"],
               "loss_rel_err": max(errs[f"loss[{i}]"] for i in range(MESH_STEPS)),
               "grad_norm_rel_err": max(errs[f"grad_norm[{i}]"] for i in range(MESH_STEPS)),
               "worst_param_rel_err": max(v for k, v in errs.items() if k.startswith("params")),
               "worst_moment_rel_err": max(v for k, v in errs.items() if k.startswith("mu")),
               "worst": worst, "worst_rel_err": errs[worst],
               "one_rank_step_ms": ref["step_ms"],
               "ranks": [{k: r[k] for k in ("rank", "device", "backend", "coords",
                                            "launches_per_step", "step_ms", "local_w1")}
                         for r in sorted(recs, key=lambda r: r["rank"])],
               "rank_over_one_rank": max(r["step_ms"][-1] for r in recs) / ref["step_ms"][-1],
               "staging": "gloo for CUDA tensors: all_gather, all_to_all and the ring's "
                          "shift through pinned host copies; all_reduce on the CUDA tensors"}
        emit(rec)
        bad = {k: v for k, v in errs.items() if not v <= MESH_RTOL}     # NaN fails too
        if bad:
            raise AssertionError(f"mesh {name}: {bad} from the one-rank step "
                                 f"(limit {MESH_RTOL})")
    shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "mesh", "predicted": MESH_PREDICTED, "launches": total,
          "seconds": time.perf_counter() - t0})
    return total


# -- the pipe phase: GPipe over ranks sharing the card ------------------------

# one rank of a world of ranks sharing cuda:0 over gloo: each case of its
# world builds its mesh, draws the flagship weights from PIPE_SEED and runs
# (pipe) the pipelined forward and two train steps through
# make_step_fn(apply_fn=...) or (dp) the data-parallel forward, every count
# reset just before and read just after each call; rank 0 saves what the
# parent holds against the one-rank path, every rank prints its record with
# a digest of its outputs (the ranks must agree bitwise)
PIPE_RANK_CHILD = r"""
import hashlib, json, os, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist
from glom_tpu_torch import checkpoint as ckpt_lib
from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.kernels import wrappers
from glom_tpu_torch.models.glom import tree_map
from glom_tpu_torch.parallel import make_mesh, make_pipelined_apply
from glom_tpu_torch.parallel.inference import make_data_parallel_forward
from glom_tpu_torch.parallel.mesh import initialize_distributed
from glom_tpu_torch.training import denoise
from glom_tpu_torch.training.optim import Optimizer

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
work, rank, world = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
spec = json.load(open(os.path.join(work, "spec.json")))
device = initialize_distributed("file://" + os.path.join(work, f"store{world}"), world, rank,
                                device="cuda:0", backend="gloo", timeout_s=300)
data = np.load(os.path.join(work, "batches.npz"))
fns = wrappers()


def counted(fn):
    for w in fns.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, {k: w.launches for k, w in fns.items()}


def digest(*arrays):
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


for case in [c for c in spec["cases"] if c["world"] == world]:
    config = GlomConfig(**case["config"])
    mesh = make_mesh(case["mesh"], case["axes"])
    rec = {"case": case["name"], "rank": rank, "coords": mesh.coords,
           "device": torch.cuda.get_device_name(device), "backend": dist.get_backend()}
    optimizer = Optimizer(spec["lr"])
    state = denoise.init_state(torch.Generator().manual_seed(spec["seed"]), config, optimizer,
                               device=device)
    img = torch.from_numpy(data["imgs"][:case["batch"]]).to(device)
    if case["kind"] == "dp":
        fn = make_data_parallel_forward(mesh, config, iters=spec["iters"])
        with torch.no_grad():
            out, ms, launches = counted(lambda: fn(state.params["glom"], img))
        out = out.cpu().numpy()
        rec.update(forward_ms=ms, launches_forward=launches, shape=list(out.shape),
                   digest=digest(out))
        if rank == 0:
            np.save(os.path.join(work, case["name"] + ".npy"), out)
    else:
        pp = make_pipelined_apply(mesh, config, **case["pipeline"])
        with torch.no_grad():
            out, ms, launches = counted(lambda: pp(state.params["glom"], img, iters=spec["iters"],
                                                   capture_timestep=spec["t"]))
        final, cap = (o.cpu().numpy() for o in out)
        del out
        rec.update(forward_ms=ms, launches_forward=launches, digest_forward=digest(final, cap))
        if rank == 0:
            np.savez(os.path.join(work, case["name"] + "_fwd.npz"), final=final, captured=cap)
        del final, cap
        step = denoise.make_step_fn(config, TrainConfig(batch_size=case["batch"]), optimizer,
                                    apply_fn=pp)
        noise = torch.from_numpy(data["noise"][:case["batch"]]).to(device)
        (new, m), ms, launches = counted(lambda: step(state, img, noise=noise))
        # a second step, warm, for the time
        _, ms2, _ = counted(lambda: step(new, img, noise=noise))
        host = lambda tree: tree_map(lambda t: t.detach().cpu().numpy(), tree)
        flat = ckpt_lib.flatten({"params": host(new.params), "mu": host(new.opt_state["mu"])})
        rec.update(step_ms=[ms, ms2], launches_step=launches, loss=float(m["loss"]),
                   grad_norm=float(m["grad_norm"]),
                   digest_step=digest(*(flat[k] for k in sorted(flat))))
        if rank == 0:
            np.savez(os.path.join(work, case["name"] + "_step.npz"), loss=float(m["loss"]),
                     grad_norm=float(m["grad_norm"]), **flat)
        del new, m, flat
    print(json.dumps(rec), flush=True)
    del state
    torch.cuda.empty_cache()
dist.destroy_process_group()
"""

PIPE_ITERS, PIPE_T, PIPE_M = 12, 7, 2
PIPE_SEED, PIPE_LR = 5, 1e-3
PIPE_DP_BATCH = 5
PIPE_TIMEOUT_S = 300
PIPE_FWD_RTOL = 1e-4
# (name, world, mesh, axes, config, pipeline kwargs or None for the DP forward)
PIPE_CASES = (
    ("pipe_pallas", 2, (2,), ("pipe",), mesh_kernels(), dict(num_microbatches=PIPE_M)),
    ("pipe_fused", 2, (2,), ("pipe",), mesh_kernels(ff_impl="fused"),
     dict(num_microbatches=PIPE_M)),
    ("dp_pallas", 2, (2,), ("data",), mesh_kernels(), None),
    ("dp_fused", 2, (2,), ("data",), mesh_kernels(ff_impl="fused"), None),
    # --only pipe: four ranks
    ("pipe_model", 4, (2, 2), ("pipe", "model"), mesh_kernels(),
     dict(num_microbatches=PIPE_M, model_axis="model")),
    ("pipe_seq", 4, (2, 2), ("pipe", "seq"), mesh_kernels(),
     dict(num_microbatches=PIPE_M, seq_axis="seq")),
)
# written before the first run on the card (PERF.md §6, the pipeline entry): a rank's warm
# step over the one-rank step's (the one-rank step stops at t=7; the
# pipelined forward runs all 12 iterations), and the phase's seconds
PIPE_PREDICTED = {"pipe_pallas_over_one_rank": [3.5, 8.0], "pipe_fused_over_one_rank": [2.5, 6.0],
                  "pipe_model_over_one_rank": [10.0, 40.0],
                  "pipe_seq_over_one_rank": [10.0, 40.0], "seconds": [25, 60],
                  "seconds_only_pipe": [50, 120]}


def pipe_launches(stage: int, mesh_axes) -> tuple:
    """``(forward, step)`` launches of a rank at ``stage``, worked out from the
    schedule: each stage runs its M microbatches through k = 12/S
    iterations (K1 twice and K4 once each: no stage runs K8); in the step's
    backward a stage before the capture's back-propagates all k iterations
    of each microbatch, the capture's stage the first cap_off, a later one
    none.  The ring (a seq axis) is torch code: no K4, K6, K7."""
    S = 2
    k = PIPE_ITERS // S
    cap_stage, cap_off = (PIPE_T - 1) // k, PIPE_T - ((PIPE_T - 1) // k) * k
    bwd = PIPE_M * (k if stage < cap_stage else cap_off if stage == cap_stage else 0)
    fwd, step = want_launches(PIPE_M * k), want_launches(PIPE_M * k, bwd)
    if "seq" in mesh_axes:
        none = {"consensus_attention": 0, "consensus_dkv": 0, "consensus_dq": 0}
        fwd, step = {**fwd, **none}, {**step, **none}
    return fwd, step


def dp_launches(config: dict) -> dict:
    """A data rank's launches: 12 iterations on its rows, K8 alone on "fused"."""
    if config["ff_impl"] == "fused":
        return {**want_launches(0), "fused_level_update": PIPE_ITERS}
    return want_launches(PIPE_ITERS)


def pipe_reference(config: GlomConfig, data, b: int, device, *, step: bool):
    """The one-rank path on the card from the same seed and batch: the
    forward (to PIPE_T and on to PIPE_ITERS), and with ``step`` two steps
    of ``make_step_fn`` (its flat params and first moments after the first,
    the second's time)."""
    optimizer = Optimizer(PIPE_LR)
    state = denoise.init_state(torch.Generator().manual_seed(PIPE_SEED), config, optimizer,
                               device=device)
    img = torch.from_numpy(data["imgs"][:b]).to(device)
    with torch.no_grad():
        if not step:
            return glom_model.apply(state.params["glom"], img, config=config, iters=PIPE_ITERS)
        fwd = glom_model.apply(state.params["glom"], img, config=config, iters=PIPE_ITERS,
                               capture_timestep=PIPE_T)
    noise = torch.from_numpy(data["noise"][:b]).to(device)
    step_fn = denoise.make_step_fn(config, TrainConfig(batch_size=b), optimizer)
    _, (new, m) = host_ms(lambda: step_fn(state, img, noise=noise))
    ms2, _ = host_ms(lambda: step_fn(new, img, noise=noise))
    host = lambda tree: glom_model.tree_map(lambda t: t.detach().cpu().numpy(), tree)
    flat = ckpt_lib.flatten({"params": host(new.params), "mu": host(new.opt_state["mu"])})
    return fwd, float(m["loss"]), float(m["grad_norm"]), flat, ms2


def run_pipe_world(work: str, world: int) -> list:
    """The ranks of one world, each a process on cuda:0; their records."""
    env = {**os.environ, "OMP_NUM_THREADS": "4"}
    ranks = [subprocess.Popen([sys.executable, "-c", PIPE_RANK_CHILD, ROOT, work, str(r),
                               str(world)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(world)]
    try:
        outs = [p.communicate(timeout=PIPE_TIMEOUT_S) for p in ranks]
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (_, err) in enumerate(outs):
        if ranks[r].returncode != 0:
            raise AssertionError(f"pipe: rank {r} of {world} failed:\n{err[-4000:]}")
    return [json.loads(line) for out, _ in outs for line in out.splitlines()
            if line.startswith("{")]


def phase_pipe(device, everything: bool = False) -> dict:
    """GPipe over ranks sharing the card (NCCL refuses two ranks on one
    device; gloo stages the state's sends through pinned host copies), at
    flagship f32 b=8, 12 iterations, M=2 (k=6), the loss at t=7 (stage 1,
    mid-chunk): (i) two ranks on ("pipe",) = (2,) with "pallas" (K1, K4; K2,
    K3, K6, K7 backward) and with "fused" (no stage runs K8): the forward
    (final and captured) within 1e-3 max-abs and 1e-4 relative of the
    one-rank forward, one step of ``make_step_fn(apply_fn=...)`` with the
    loss, every parameter and every first moment within 1e-4 of the
    one-rank step from the same seed and noise, every rank's launches exact
    from the schedule, the ranks bitwise alike; (ii) the data-parallel
    forward on ("data",) = (2,) at b=5 (padded to 6, sliced back) on
    "pallas" and on "fused" (K8), against the one-rank forward; (iii) with
    ``everything`` (``--only pipe``) (pipe 2, model 2) and (pipe 2, seq 2)
    on four ranks, gated as (i).  Returns every rank's launches, summed."""
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="pipe-")
    rng = np.random.default_rng(37)
    shape = (BATCH, 3, FLAGSHIP.image_size, FLAGSHIP.image_size)
    data = {"imgs": rng.standard_normal(shape).astype(np.float32),
            "noise": rng.standard_normal(shape).astype(np.float32)}
    np.savez(os.path.join(work, "batches.npz"), **data)
    cases = [c for c in PIPE_CASES if everything or c[1] == 2]
    spec = {"seed": PIPE_SEED, "lr": PIPE_LR, "iters": PIPE_ITERS, "t": PIPE_T,
            "cases": [{"name": name, "world": world, "mesh": list(mesh), "axes": list(axes),
                       "config": cfg, "kind": "dp" if kw is None else "pipe", "pipeline": kw,
                       "batch": PIPE_DP_BATCH if kw is None else BATCH}
                      for name, world, mesh, axes, cfg, kw in cases]}
    with open(os.path.join(work, "spec.json"), "w") as f:
        json.dump(spec, f)
    torch.cuda.empty_cache()
    records = []
    for world in sorted({c[1] for c in cases}):
        records += run_pipe_world(work, world)
    total = {}
    for name, world, mesh, axes, cfg, kw in cases:
        recs = sorted((r for r in records if r["case"] == name), key=lambda r: r["rank"])
        if [r["rank"] for r in recs] != list(range(world)):
            raise AssertionError(f"pipe {name}: ranks {[r['rank'] for r in recs]}")
        for r in recs:
            if r["backend"] != "gloo" or r["device"] != torch.cuda.get_device_name(0):
                raise AssertionError(f"pipe {name}: {r['backend']} on {r['device']}")
            if kw is None:
                check_launches(f"pipe {name} rank {r['rank']} forward", r["launches_forward"],
                               dp_launches(cfg))
            else:
                fwd, step = pipe_launches(r["coords"]["pipe"], axes)
                check_launches(f"pipe {name} rank {r['rank']} forward", r["launches_forward"],
                               fwd)
                check_launches(f"pipe {name} rank {r['rank']} step", r["launches_step"], step)
            for key in ("launches_forward", "launches_step"):
                for k, v in r.get(key, {}).items():
                    total[k] = total.get(k, 0) + v
        digests = {key: {r[key] for r in recs} for key in ("digest", "digest_forward",
                                                             "digest_step") if key in recs[0]}
        if any(len(v) != 1 for v in digests.values()):
            raise AssertionError(f"pipe {name}: the ranks disagree ({digests})")
        config = GlomConfig(**cfg)
        rec = {"phase": "pipe", "case": name, "mesh": dict(zip(axes, mesh)),
               "ff_impl": cfg["ff_impl"], "attention_impl": cfg["attention_impl"],
               "ranks": [{k: r[k] for k in ("rank", "coords", "device", "backend",
                                            "launches_forward", "launches_step", "forward_ms",
                                            "step_ms") if k in r} for r in recs],
               "staging": "gloo for CUDA tensors: the stage-to-stage sends and the all-gathers "
                          "through pinned host copies; broadcast and all_reduce on the CUDA "
                          "tensors"}
        if kw is None:
            want = pipe_reference(config, data, PIPE_DP_BATCH, device, step=False)
            got = torch.from_numpy(np.load(os.path.join(work, f"{name}.npy")))
            errs = {"out": (float((got - want.cpu()).abs().max()), rel_err(got, want.cpu()))}
            rec.update(batch=PIPE_DP_BATCH, shape=recs[0]["shape"])
        else:
            fwd, loss, norm, flat, one_ms = pipe_reference(config, data, BATCH, device,
                                                           step=True)
            got = np.load(os.path.join(work, f"{name}_fwd.npz"))
            errs = {key: (float((torch.from_numpy(got[key]) - w.cpu()).abs().max()),
                          rel_err(got[key], w.cpu()))
                    for key, w in zip(("final", "captured"), fwd)}
            stepped = np.load(os.path.join(work, f"{name}_step.npz"))
            step_errs = {"loss": rel_err(stepped["loss"], loss),
                         "grad_norm": rel_err(stepped["grad_norm"], norm)}
            step_errs.update({k: rel_err(stepped[k], v) for k, v in flat.items()})
            worst = max(step_errs, key=step_errs.get)
            rec.update(
                batch=BATCH, iters=PIPE_ITERS, microbatches=PIPE_M, loss_timestep=PIPE_T,
                loss=loss, loss_rel_err=step_errs["loss"],
                grad_norm_rel_err=step_errs["grad_norm"],
                worst_param_rel_err=max(v for k, v in step_errs.items()
                                        if k.startswith("params")),
                worst_moment_rel_err=max(v for k, v in step_errs.items() if k.startswith("mu")),
                worst=worst, worst_rel_err=step_errs[worst], one_rank_step_ms=one_ms,
                rank_over_one_rank=max(r["step_ms"][1] for r in recs) / one_ms)
            bad = {k: v for k, v in step_errs.items() if not v <= MESH_RTOL}   # NaN fails too
            if bad:
                raise AssertionError(f"pipe {name}: {bad} from the one-rank step "
                                     f"(limit {MESH_RTOL})")
        rec["forward_max_abs_err"] = {k: v[0] for k, v in errs.items()}
        rec["forward_rel_err"] = {k: v[1] for k, v in errs.items()}
        emit(rec)
        bad = {k: v for k, v in errs.items() if not (v[0] <= SERVE_ATOL and v[1] <= PIPE_FWD_RTOL)}
        if bad:
            raise AssertionError(f"pipe {name}: forward {bad} from the one-rank forward "
                                 f"(limits {SERVE_ATOL} max-abs, {PIPE_FWD_RTOL} relative)")
        torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "pipe", "predicted": PIPE_PREDICTED, "launches": total,
          "seconds": time.perf_counter() - t0})
    return total


# -- the shard_serve phase: the sharded serving engine on ranks sharing the card

# one rank of a shard_serve world sharing cuda:0 over gloo: each case of its
# world builds its mesh engine from the case's checkpoint; rank 0 runs
# shard_leader, the others follow; every rank logs each cache call of the
# mesh (family, rows, the launches from a count set to 0 just before it and
# read just after, the header's and the row gather's host ms) and prints its
# record
SHARD_RANK_CHILD = r"""
import contextlib, json, os, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from chip_smoke import shard_leader
from glom_tpu_torch.kernels import wrappers
from glom_tpu_torch.parallel.mesh import initialize_distributed
from glom_tpu_torch.serving import compile_cache, sharded
from glom_tpu_torch.serving.engine import ServingEngine

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
work, rank, world = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
spec = json.load(open(os.path.join(work, "spec.json")))
# gloo named for CUDA tensors: every rank runs on the one card
device = initialize_distributed("file://" + os.path.join(work, f"store{world}"), world, rank,
                                device="cuda:0", backend="gloo", timeout_s=300)
fns = wrappers()
log = []
real_announce, real_gather = sharded.MeshDispatch.announce, sharded.MeshDispatch.gather


@contextlib.contextmanager
def announce(self, set_id, family, imgs, eager):
    rec = {"set": set_id, "family": family, "rows": int(imgs.shape[0]), "gather_ms": 0.0}
    t0 = time.perf_counter()
    with real_announce(self, set_id, family, imgs, eager):
        # inside the leader's lock: no other mesh call runs until this ends
        rec["header_ms"] = (time.perf_counter() - t0) * 1e3
        for fn in fns.values():
            fn.launches = 0
        yield
    rec["ms"] = (time.perf_counter() - t0) * 1e3
    rec["launches"] = {k: fn.launches for k, fn in fns.items()}
    log.append(rec)


def gather(self, host):
    t0 = time.perf_counter()
    out = real_gather(self, host)
    gathered.append((time.perf_counter() - t0) * 1e3)
    return out


gathered = []
sharded.MeshDispatch.announce, sharded.MeshDispatch.gather = announce, gather
for case in spec["cases"]:
    if case["world"] != world:
        continue
    del log[:]
    engine = ServingEngine(case["ckpt"], device=device, reload_poll_s=0, max_wait_ms=0.0,
                           mesh_shape=tuple(case["mesh"]), **case["engine"])
    rec = {"case": case["name"], "rank": rank, "backend": dist.get_backend(),
           "device": torch.cuda.get_device_name(device), "coords": engine.mesh.coords,
           "graphed": engine.caches["embed"].graphed,
           "local_w1": {net: list((engine.params["glom"][net]["w1"]["int8_q"]
                                   if case["engine"].get("quant") == "int8"
                                   else engine.params["glom"][net]["w1"]).shape)
                        for net in ("bottom_up", "top_down")}}
    if engine.is_leader:
        rec.update(shard_leader(engine, case, work))
    else:
        steps, captures = [], []
        real_run = engine.follow_run

        def follow_run(set_id, family, imgs, eager):
            c0 = compile_cache.captures_made()
            real_run(set_id, family, imgs, eager)
            steps.append(engine._follower_sets[set_id].step)
            captures.append(compile_cache.captures_made() - c0)

        engine.follow_run = follow_run
        rec["calls_run"] = engine.follow()
        rec.update(steps=steps, request_path_captures=sum(captures))
    # the gather's time, matched to each call in order
    for call in log:
        call["gather_ms"] = gathered.pop(0) if gathered else 0.0
    del gathered[:]
    rec["calls"] = list(log)
    print(json.dumps(rec), flush=True)
    del engine
    torch.cuda.empty_cache()
dist.destroy_process_group()
"""

SHARD_TIMEOUT_S = 600
SHARD_REPS = 5
SHARD_SEED = 41
# (name, world, mesh, engine arguments, the answers' limit against the one-rank
# engine: "bitwise" for a data rank's rows, else max-abs SERVE_ATOL (f32) or
# normwise RTOL[bf16] (int8); full run?)
SHARD_CASES = (
    ("dp_fused", 2, (2, 1, 1), dict(ff_impl="fused", buckets=(2, 4, 8)), "bitwise", True),
    ("tp", 2, (1, 2, 1), dict(ff_impl="pallas", attention_impl="pallas", param_sharding="tp",
                              buckets=(1, 2, 4, 8)), "f32", True),
    ("ep", 2, (1, 2, 1), dict(ff_impl="pallas", attention_impl="pallas", param_sharding="ep",
                              buckets=(1, 2, 4, 8)), "f32", False),
    ("seq", 2, (1, 1, 2), dict(ff_impl="pallas", attention_impl="pallas",
                               buckets=(1, 2, 4, 8)), "f32", False),
    ("int8_tp", 4, (2, 2, 1), dict(ff_impl="pallas", attention_impl="pallas",
                                   param_sharding="tp", quant="int8", buckets=(2, 4, 8)),
     "bf16", False),
)
# written before the first run on the card (PERF.md §6, PR 26): a rank's /embed
# b=8 host time over the one-rank engine's, and the leader's dispatch (the
# header, the images and the row gather, host ms a call)
SHARD_PREDICTED = {"dp_fused_over_one_rank": [1.0, 2.5], "tp_over_one_rank": [3.0, 15.0],
                   "dispatch_ms_a_call": [1.0, 30.0], "seconds_full_run": [30, 60]}


def shard_launches(config: dict, iters: int) -> dict:
    """A rank's launches for one call of ``iters`` iterations on its shard:
    K8 alone under DP "fused", else K1 twice and K4 once an iteration."""
    if config.get("ff_impl") == "fused":
        return {**want_launches(0), "fused_level_update": iters}
    return want_launches(iters)


def shard_leader(engine, case: dict, work: str) -> dict:
    """Rank 0 of a shard_serve case (run in its rank process): /embed and
    /reconstruct at b=8 through ``submit`` and the batch (each sampled batch
    replays the quality family), /parse and the index forward through the
    engine, SHARD_REPS timed /embed b=8 calls, one /embed b=1 through the
    leader's HTTP server, then the port's one-rank engine (buckets 1, 4, 8,
    step 0) on the same images, then a hot reload to a perturbed step 1 and
    one more /embed b=8 on it; the errors, times, captures and health."""
    from glom_tpu_torch.serving.compile_cache import captures_made

    c = engine.config
    rng = np.random.default_rng(SHARD_SEED)
    x8 = rng.standard_normal((BATCH, c.channels, c.image_size, c.image_size)).astype(np.float32)
    c0 = captures_made()
    out = {}
    for ep in ("embed", "reconstruct"):
        fut = engine.submit(ep, x8)
        engine.process_once(ep)
        out[ep] = fut.result(timeout=0)
    out["parse"] = engine.run("parse", x8)
    out["index"] = engine.run("index", x8)
    mesh_ms = []
    for _ in range(SHARD_REPS):
        t0 = time.perf_counter()
        engine.run("embed", x8)
        mesh_ms.append((time.perf_counter() - t0) * 1e3)
    engine.start()
    server = make_server(engine, port=0)
    thread = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05})
    thread.start()
    try:
        base = "http://127.0.0.1:%d" % server.server_address[1]
        reply, _ = post(base + "/embed", {"images": x8[:1].tolist()})
        http_b1 = np.asarray(reply["embeddings"], np.float32)
        # the sampled batches' quality post-passes (the worker's, after the
        # answer) are done before anything else launches a kernel here
        wait_quality(engine, 3)
        health = get(base + "/healthz")
    finally:
        server.shutdown()
        thread.join()
        server.server_close()
    request_path_captures = captures_made() - c0
    kw = {k: v for k, v in case["engine"].items() if k not in ("param_sharding", "buckets")}
    one = ServingEngine(case["ckpt"], device=engine.device, reload_poll_s=0, quality_sample=0,
                        buckets=(1, 4, 8), **kw)
    try:
        ref = {ep: one.run(ep, x8) for ep in ("embed", "reconstruct", "parse", "index")}
        one_ms = []
        for _ in range(SHARD_REPS):
            t0 = time.perf_counter()
            one.run("embed", x8)
            one_ms.append((time.perf_counter() - t0) * 1e3)
        ref_b1 = one.run("embed", x8[:1])
        per = BATCH // engine.mesh.size("data")
        rows = {ep: np.concatenate([one.run(ep, x8[i:i + per]) for i in range(0, BATCH, per)])
                for ep in ("embed", "reconstruct", "parse")} if per < BATCH else ref
    finally:
        one.shutdown(drain=False)
    errs = {ep: float(np.abs(out[ep] - ref[ep]).max()) for ep in ("embed", "reconstruct",
                                                                   "index")}
    rels = {ep: rel_err(out[ep], ref[ep]) for ep in ("embed", "reconstruct", "index")}
    bitwise = {ep: bool(np.array_equal(out[ep], rows[ep])) for ep in ("embed", "reconstruct")}
    # /parse: labels, counts and sizes bitwise, the means up to the order of
    # the pack's atomic sums (ISLAND_MEAN_ATOL)
    g, w = (split_rows(r, c.levels, c.num_patches) for r in (out["parse"], rows["parse"]))
    parse_vs = {"labels_counts_sizes_bitwise": all(np.array_equal(a, b)
                                                   for a, b in zip(g[:3], w[:3])),
                "means_max_abs_err": float(np.abs(g[3] - w[3]).max())}
    # a hot reload to step 1, served by every rank
    perturbed_step(case["ckpt"], 1, seed=SHARD_SEED + 2)
    reloaded = engine.check_reload()
    after = engine.run("embed", x8)
    captures = engine.registry.snapshot().get("serving_graph_captures", 0) + sum(
        cache.poll_captures() for cache in engine.caches.values())
    engine.shutdown(drain=True)
    return {"iters": {"embed": engine.embed_iters, "reconstruct": engine.reconstruct_timestep,
                      "index": engine.embed_iters, "parse": engine.embed_iters,
                      "quality": engine._program.quality_iters},
            "max_abs_err": errs, "rel_err": rels, "bitwise_vs_one_rank": bitwise,
            "parse_vs_one_rank": parse_vs,
            "http_b1_max_abs_err": float(np.abs(http_b1 - ref_b1).max()),
            "http_b1_shape": list(http_b1.shape), "parse_shape": list(out["parse"].shape),
            "one_rank_b1": ref_b1.tolist(),
            "mesh_embed_b8_ms": mesh_ms, "one_rank_embed_b8_ms": one_ms,
            "reloaded": bool(reloaded), "step_after": int(engine.step),
            "after_finite": bool(np.isfinite(after).all()),
            "after_differs": float(np.abs(after - out["embed"]).max()),
            "request_path_captures": int(request_path_captures),
            "serving_graph_captures": int(captures), "health": {
                k: health[k] for k in ("status", "mesh", "param_sharding", "mesh_dispatch",
                                       "quant", "ff_impl")}}


def run_shard_world(work: str, world: int) -> list:
    """The ranks of one shard_serve world, each a process on cuda:0; their
    records."""
    env = {**os.environ, "OMP_NUM_THREADS": "4"}
    ranks = [subprocess.Popen([sys.executable, "-c", SHARD_RANK_CHILD, ROOT, work, str(r),
                               str(world)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(world)]
    try:
        outs = [p.communicate(timeout=SHARD_TIMEOUT_S) for p in ranks]
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (_, err) in enumerate(outs):
        if ranks[r].returncode != 0:
            raise AssertionError(f"shard_serve: rank {r} of {world} failed:\n{err[-4000:]}")
    return [json.loads(line) for out, _ in outs for line in out.splitlines()
            if line.startswith("{")]


def shard_nccl_server(ckpt: str, log_path: str):
    """``python -m glom_tpu_torch.serving.server --mesh-shape 1,1,1`` over
    NCCL: a world of one through the CLI, in a process of its own."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)}
    with open(log_path, "w") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "glom_tpu_torch.serving.server", "--checkpoint-dir", ckpt,
             "--device", "cuda", "--port", "0", "--reload-poll-s", "0", "--buckets", "1,8",
             "--quality-sample", "0", "--mesh-shape", "1,1,1", "--coordinator",
             f"localhost:{free_port()}", "--num-processes", "1", "--process-id", "0"],
            stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=env)


def phase_shard_serve(device, everything: bool = False) -> dict:
    """The sharded serving engine (serving/sharded.py) at flagship f32 on
    ranks sharing the card over gloo, each on cuda:0, rank 0 leading: (i)
    (2, 1, 1) DP on "fused" from graphs (K8 12 an /embed a rank, on its 4
    rows) and (1, 2, 1) TP on "pallas", eager (K1 24 at h=1024, K4 12):
    /embed and /reconstruct at b=8 (with the quality post-pass), /parse and
    the index forward, one /embed b=1 through the leader's HTTP server, each
    rank's launches of every call exact, the answers within SERVE_ATOL of the
    port's one-rank engine on the card (a DP rank's rows bitwise the
    one-rank engine at bucket 4), no capture on the request path, a hot
    reload served by every rank; (ii) a world of one over NCCL through
    ``python -m glom_tpu_torch.serving.server --mesh-shape 1,1,1`` serving
    /embed; (iii) with ``everything`` (``--only shard_serve``) also (1, 2, 1)
    EP, (1, 1, 2) seq and (2, 2, 1) int8 TP on four ranks.  Returns every
    rank's launches, summed."""
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="shard-")
    cases = [c for c in SHARD_CASES if everything or c[5]]
    spec = {"cases": []}
    for name, world, mesh, kw, _, _ in cases:
        ckpt = flagship_ckpt(f"shard_serve_{name}", SHARD_SEED)
        spec["cases"].append({"name": name, "world": world, "mesh": list(mesh), "engine": kw,
                              "ckpt": ckpt})
    with open(os.path.join(work, "spec.json"), "w") as f:
        json.dump(spec, f)
    nccl_ckpt = flagship_ckpt("shard_serve_nccl", SHARD_SEED)
    nccl_log = os.path.join(work, "nccl.log")
    nccl = shard_nccl_server(nccl_ckpt, nccl_log)
    torch.cuda.empty_cache()
    try:
        records = []
        for world in sorted({c[1] for c in cases}):
            records += run_shard_world(work, world)
        # (ii) the NCCL world of one: /embed b=1 against the DP leader's
        # one-rank reference of the same image and weights (step 0)
        url = served_url(nccl, nccl_log)
        before = get(url + "/healthz")
        x1 = np.random.default_rng(SHARD_SEED).standard_normal(
            (BATCH, 3, FLAGSHIP.image_size, FLAGSHIP.image_size)).astype(np.float32)[:1]
        reply, _ = post(url + "/embed", {"images": x1.tolist()})
        after = get(url + "/healthz")
    finally:
        nccl.send_signal(signal.SIGTERM)
        try:
            nccl.wait(timeout=120)
        finally:
            if nccl.poll() is None:
                nccl.kill()
                nccl.wait()
    if nccl.returncode != 0:
        raise AssertionError(f"shard_serve: the NCCL server exited {nccl.returncode}")
    for case in spec["cases"]:
        shutil.rmtree(case["ckpt"], ignore_errors=True)
    shutil.rmtree(nccl_ckpt, ignore_errors=True)
    total = {k: 0 for k in want_launches(0)}
    leaders = {}
    for name, world, mesh, kw, limit, _ in cases:
        recs = sorted((r for r in records if r["case"] == name), key=lambda r: r["rank"])
        if [r["rank"] for r in recs] != list(range(world)):
            raise AssertionError(f"shard_serve {name}: ranks {[r['rank'] for r in recs]}")
        lead = recs[0]
        leaders[name] = lead
        for r in recs:
            if r["backend"] != "gloo" or r["device"] != torch.cuda.get_device_name(0):
                raise AssertionError(f"shard_serve {name}: {r['backend']} on {r['device']}")
            if len(r["calls"]) != len(lead["calls"]):
                raise AssertionError(f"shard_serve {name}: rank {r['rank']} ran "
                                     f"{len(r['calls'])} calls, the leader {len(lead['calls'])}")
            for call in r["calls"]:
                check_launches(f"shard_serve {name} rank {r['rank']} {call['family']}",
                               call["launches"],
                               shard_launches(kw, lead["iters"][call["family"]]))
                for k, v in call["launches"].items():
                    total[k] += v
            if r["rank"] and (r["request_path_captures"] or lead["step_after"] not in r["steps"]):
                raise AssertionError(f"shard_serve {name} rank {r['rank']}: captures "
                                     f"{r['request_path_captures']}, steps {set(r['steps'])}")
            if r["graphed"] != (name == "dp_fused"):
                raise AssertionError(f"shard_serve {name}: graphed {r['graphed']}")
        bad = []
        if not (lead["reloaded"] and lead["step_after"] == 1 and lead["after_finite"]
                and lead["after_differs"] > 0):
            bad.append("reload")
        if lead["request_path_captures"] or lead["serving_graph_captures"]:
            bad.append("captures")
        if lead["health"]["status"] != "ok" or lead["health"]["mesh"] != dict(
                zip(("data", "model", "seq"), mesh)):
            bad.append("health")
        if limit == "bitwise" and not (
                all(lead["bitwise_vs_one_rank"].values())
                and lead["parse_vs_one_rank"]["labels_counts_sizes_bitwise"]
                and lead["parse_vs_one_rank"]["means_max_abs_err"] <= ISLAND_MEAN_ATOL):
            bad.append(f"bitwise {lead['bitwise_vs_one_rank']} {lead['parse_vs_one_rank']}")
        if limit == "bf16":
            if not max(lead["rel_err"].values()) <= RTOL[torch.bfloat16]:
                bad.append(f"rel_err {lead['rel_err']}")
        elif not (max(lead["max_abs_err"].values()) <= SERVE_ATOL
                  and lead["http_b1_max_abs_err"] <= SERVE_ATOL):
            bad.append(f"max_abs_err {lead['max_abs_err']} / http {lead['http_b1_max_abs_err']}")
        # the timed /embed b=8 calls: the second to the (SHARD_REPS + 1)-th
        timed = slice(1, 1 + SHARD_REPS)
        emb = [cl for cl in lead["calls"] if cl["family"] == "embed"][timed]
        dispatch_ms = [cl["header_ms"] + cl["gather_ms"] for cl in emb]
        follower_ms = [[cl["ms"] for cl in r["calls"] if cl["family"] == "embed"][timed]
                       for r in recs[1:]]
        emit({"phase": "shard_serve", "case": name, "mesh": dict(zip(("data", "model", "seq"),
                                                                     mesh)),
              "engine": kw, "ranks": [{k: r[k] for k in ("rank", "coords", "device", "backend",
                                                         "graphed", "local_w1")}
                                      for r in recs],
              "calls_a_rank": len(lead["calls"]),
              "launches_a_call": {fam: shard_launches(kw, it)
                                  for fam, it in lead["iters"].items()},
              **{k: lead[k] for k in ("max_abs_err", "rel_err", "bitwise_vs_one_rank",
                                      "parse_vs_one_rank",
                                      "http_b1_max_abs_err", "http_b1_shape", "parse_shape",
                                      "mesh_embed_b8_ms", "one_rank_embed_b8_ms", "reloaded",
                                      "step_after", "request_path_captures",
                                      "serving_graph_captures", "health")},
              "mesh_over_one_rank": statistics.median(lead["mesh_embed_b8_ms"])
              / statistics.median(lead["one_rank_embed_b8_ms"]),
              "leader_dispatch_ms": dispatch_ms, "follower_embed_ms": follower_ms,
              "staging": "gloo on the host: headers, images and the row gather; under TP, "
                         "EP and seq the forward's all-reduces and gathers on CUDA tensors"})
        if bad:
            raise AssertionError(f"shard_serve {name}: {bad}")
    # (ii) checked: NCCL, a world of one, the replay's launches, the answer
    # against the TP leader's one-rank engine on the same image and weights
    got = np.asarray(reply["embeddings"], np.float32)
    nccl_err = float(np.abs(got - np.asarray(leaders["tp"]["one_rank_b1"], np.float32)).max())
    mesh = after.get("mesh_dispatch") or {}
    launched = {k: after["kernel_launches"][k] - before["kernel_launches"][k]
                for k in before["kernel_launches"]}
    nccl_rec = {"phase": "shard_serve", "part": "nccl_world_of_one", "mesh": after["mesh"],
                "backend": mesh.get("backend"), "graphs": mesh.get("graphs"),
                "launches": launched, "shape": list(got.shape), "step": reply["step"],
                "max_abs_err": nccl_err}
    emit(nccl_rec)
    if (mesh.get("backend") != "nccl" or after["mesh"] != {"data": 1, "model": 1, "seq": 1}
            or launched != {"grouped_ff": 2 * FLAGSHIP.default_iters,
                            "consensus_attention": FLAGSHIP.default_iters,
                            "fused_level_update": 0}
            or got.shape != (1, FLAGSHIP.levels, FLAGSHIP.dim) or not nccl_err <= SERVE_ATOL):
        raise AssertionError(f"shard_serve: the NCCL world of one: {nccl_rec}")
    for k, v in launched.items():
        total[k] += v
    shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "shard_serve", "predicted": SHARD_PREDICTED, "launches": total,
          "seconds": time.perf_counter() - t0})
    return total


PHASES = ("kernels", "k1", "k2", "k3", "k6", "k8", "serve", "train", "serve_fused", "serve_load",
          "train_fused", "train_data", "classify", "video", "extract", "islands", "quant",
          "sessions", "parse", "deploy", "session_tools", "faults", "quality", "capacity",
          "bulk", "attribution", "fleet", "train_obs", "forensics", "widths", "chaos", "bench",
          "large", "mesh", "pipe", "shard_serve")


def parse_args(argv):
    import argparse

    p = argparse.ArgumentParser(description="Drive glom_tpu_torch on one NVIDIA GPU.")
    p.add_argument("--only", default=None,
                   help="comma-separated phases to run after device and build, for "
                        f"iterating on one part: {', '.join(PHASES)} (k1: K1's rows alone; "
                        "k2: K2's; k3: K3's, each with the K2 it needs and the pair; k6: K6's, "
                        "each with the K7 on its dS' and the pair; k8: K8's; train_data: "
                        "the data streams, two views, eval and resume; classify, video, "
                        "extract, islands: the classifier, video, extraction and islanding "
                        "paths; quant, sessions, parse: serving at f32/bf16/int8, stateful "
                        "sessions, /parse, /similar and /session/parse; deploy, "
                        "session_tools, faults: shadow/canary/promote/rollback and extra "
                        "models, session_check and the loadgen's session and tenant modes, "
                        "fault injection; quality, capacity: the quality post-pass family, "
                        "its shadow agreement and smoke, the capacity smoke, duty cycle, "
                        "--suggest-buckets and --capacity-ceiling; bulk, attribution: the "
                        "bulk tier (an idle job, kill and resume, scavenging, the index "
                        "build, the bucket bit check) and whyslow's smoke; fleet: the router "
                        "over two replicas (answers, launches, affinity, the hop, fail-over, "
                        "rollouts, /similar, the observatory, two server processes, the "
                        "stitched trace, the tools' fleet legs); train_obs: the trainer with "
                        "every observability field on (records, diagnostics, async saves, "
                        "bundles and their traces, the supervisor, a sticky CUDA error); "
                        "forensics: the engine's warm-up, slo_burn and deploy_rollback "
                        "bundles and the op-diff; bench: the "
                        "bench's legs, tied to train's rate when train runs first; large: the "
                        "large preset's kernel rows, serving, bench leg and train steps; "
                        "widths: the tiny preset's train steps and the 16-wide demo's /embed "
                        "through the padded kernels, 'auto' and the kernel digests; chaos: all "
                        "eleven scenarios of the port's chaos suite, six in the full run; pipe: "
                        "GPipe and the DP forward on ranks sharing the card, with the "
                        "four-rank (pipe, model) and (pipe, seq) cases only here; "
                        "shard_serve: the sharded serving engine on ranks sharing the card, "
                        "with EP, seq and the four-rank int8 TP cases only here). "
                        "A partial run exits 3 and prints no ok line")
    args = p.parse_args(argv)
    if args.only is not None:
        args.only = [name for name in args.only.split(",") if name]
        unknown = sorted(set(args.only) - set(PHASES))
        if unknown or not args.only:
            p.error(f"--only takes phases among {PHASES}, got {args.only}")
    return args


# the classifier, video, extraction, islanding, quantized, session, parse,
# deploy, session-tool, fault, quality, capacity, bulk, attribution, fleet,
# trainer-observability, engine-forensics, narrow-width, chaos, mesh,
# pipeline and sharded-serving paths, in the full run's order
SLICE_PHASES = {"classify": phase_classify, "video": phase_video, "extract": phase_extract,
                "islands": phase_islands, "quant": phase_quant, "sessions": phase_sessions,
                "parse": phase_parse, "deploy": phase_deploy,
                "session_tools": phase_session_tools, "faults": phase_faults,
                "quality": phase_quality, "capacity": phase_capacity, "bulk": phase_bulk,
                "attribution": phase_attribution, "fleet": phase_fleet,
                "train_obs": phase_train_obs, "forensics": phase_forensics,
                "widths": phase_widths, "chaos": phase_chaos, "mesh": phase_mesh,
                "pipe": phase_pipe, "shard_serve": phase_shard_serve}


def run_only(device, names) -> int:
    """Device, build and the named phases only; never the ok line."""
    pallas_step_ms = None
    for name in names:
        if name == "kernels":
            phase_kernels(device)
        elif name in ("k1", "k2", "k3", "k6", "k8"):
            phase_only(device, name)
        elif name == "serve":
            phase_serve(device)
        elif name == "train":
            _, pallas_step_ms = phase_train(device)
        elif name == "serve_fused":
            phase_serve_fused(device)
        elif name == "serve_load":
            phase_serve_load(device)
        elif name == "train_fused":
            phase_train_fused(device, pallas_step_ms)
        elif name == "train_data":
            phase_train_data(device)
        elif name == "chaos":
            phase_chaos(device, everything=True)
        elif name == "pipe":
            phase_pipe(device, everything=True)
        elif name == "shard_serve":
            phase_shard_serve(device, everything=True)
        elif name in SLICE_PHASES:
            SLICE_PHASES[name](device)
        elif name == "bench":
            phase_bench(nvidia_smi(), pallas_step_ms)
        elif name == "large":
            phase_large(device, nvidia_smi())
    print(nvidia_smi(), flush=True)
    emit({"partial_run": names, "note": "--only: a partial run, not the smoke test; exit 3"})
    return 3


def main(argv=()) -> int:
    args = parse_args(list(argv))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32": {"matmul": False, "cudnn": False}})
    phase_build()
    if args.only is not None:
        return run_only(device, args.only)
    seconds = {}

    def timed_phase(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    main_rows, library, narrow_rows = timed_phase("kernels", phase_kernels, device)
    launches = timed_phase("serve", phase_serve, device)
    train_launches, pallas_step_ms = timed_phase("train", phase_train, device)
    fused_serve_launches = timed_phase("serve_fused", phase_serve_fused, device)
    timed_phase("serve_load", phase_serve_load, device)
    fused_train_launches = timed_phase("train_fused", phase_train_fused, device, pallas_step_ms)
    data_launches = timed_phase("train_data", phase_train_data, device)
    slice_launches = {name: timed_phase(name, phase, device)
                      for name, phase in SLICE_PHASES.items()}
    timed_phase("bench", phase_bench, smi, pallas_step_ms)
    large_launches, large_rows, large_train_launches = timed_phase("large", phase_large, device,
                                                                   smi)
    # each phase's host seconds: the run must end inside its time limit
    emit({"phase_seconds": seconds})
    # launches: the serving path's count for the forward kernels (K8: the
    # fused serving path's), the train path's for the backward ones;
    # launches_train: the train path's for all (K8: the fused train path's);
    # launches_train_fused: the fused train path's for all; launches_classify,
    # _video, _extract, _islands, _quant, _sessions, _parse, _deploy,
    # _session_tools, _faults, _quality, _capacity, _bulk, _attribution, _fleet,
    # _train_obs, _forensics, _widths, _chaos, _mesh, _pipe, _shard_serve: each of those
    # paths' main run (_mesh, _pipe and _shard_serve: every rank's, summed); launches_large:
    # the large preset's serving run ("pallas" and "fused" in f32);
    # launches_large_train: its three train steps (one a configuration)
    launches.update({k: train_launches[k] for k in BACKWARD})
    launches["fused_level_update"] = fused_serve_launches["fused_level_update"]
    train_launches["fused_level_update"] = fused_train_launches["fused_level_update"]
    summary = []
    for name, source, replaces in (
        ("fused_level_update", "glom_tpu_torch/kernels/csrc/fused_update.cu",
         "glom_tpu/kernels/fused_update_pallas.py:231 (_kernel :64)"),
        ("grouped_ff", "glom_tpu_torch/kernels/csrc/grouped_ff.cu",
         "glom_tpu/kernels/ff_pallas.py:124"),
        ("consensus_attention", "glom_tpu_torch/kernels/csrc/consensus.cu",
         "glom_tpu/kernels/consensus_pallas.py:217 and :153"),
        ("grouped_ff_dx", "glom_tpu_torch/kernels/csrc/grouped_ff_bwd.cu",
         "glom_tpu/kernels/ff_pallas.py:274 (_bwd_dx_kernel :190)"),
        ("grouped_ff_dw", "glom_tpu_torch/kernels/csrc/grouped_ff_bwd.cu",
         "glom_tpu/kernels/ff_pallas.py:295 (_bwd_dw_kernel :212)"),
        ("consensus_dkv", "glom_tpu_torch/kernels/csrc/consensus_bwd.cu",
         "glom_tpu/kernels/consensus_pallas.py:414 (_bwd_dkv_kernel :285)"),
        ("consensus_dq", "glom_tpu_torch/kernels/csrc/consensus_bwd.cu",
         "glom_tpu/kernels/consensus_pallas.py:434 (_bwd_dq_kernel :334)"),
    ):
        row = main_rows[name]
        summary.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "launches_train": train_launches[name],
                        "launches_train_fused": fused_train_launches[name],
                        "launches_train_data": data_launches[name],
                        **{f"launches_{path}": counts[name]
                           for path, counts in slice_launches.items()},
                        "launches_large": large_launches.get(name, 0),
                        "launches_large_train": large_train_launches.get(name, 0),
                        "unfused_kernels_ms": row.get("unfused_kernels_ms"),
                        "max_abs_err": row["max_abs_err"],
                        "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "bound_3xtf32_ms": row["bound_3xtf32_ms"],
                        "library_ms": library[name], "case": row["case"],
                        "dtype": row["dtype"],
                        "library_case": None if library[name] is None else (
                            "attend_self=True" if name == "consensus_attention" else
                            "attend_self=True; SDPA's backward (dQ, dK, dV) against K6 + K7")})
        if name == "grouped_ff":
            summary[-1].update({k: row[k] for k in ("splits", "yardstick_ms", "yardstick",
                                                    "vs_f64")})
        if name == "fused_level_update":
            summary[-1].update({"stages": K8_STAGES, "note": K8_NOTE,
                                **{k: row[k] for k in ("splits", "key_splits", "k1_g11_k4_ms",
                                                       "vs_f64")}})
        if name in ("consensus_dkv", "consensus_dq"):
            summary[-1].update({k: row[k] for k in ("vs_f64", "work_units") if k in row})
        if name == "consensus_dq":
            pair = main_rows["consensus_dkv+consensus_dq"]
            summary[-1]["k6_plus_k7"] = {k: pair[k] for k in (
                "case", "dtype", "work", "kernel_ms", "k6_ms", "k7_ms", "bound_ms", "bound_by",
                "bound_3xtf32_ms")}
        if name == "grouped_ff_dx":
            summary[-1]["library_case"] = main_rows[name].get("library")
        if name == "grouped_ff_dw":
            pair = main_rows["grouped_ff_dx+grouped_ff_dw"]
            summary[-1]["library_case"] = main_rows[name].get("library")
            summary[-1]["k2_plus_k3"] = {k: pair[k] for k in (
                "case", "dtype", "work", "kernel_ms", "k2_ms", "k3_ms", "bound_ms", "bound_by",
                "bound_3xtf32_ms", "library_ms", "library")}
        # the tiny preset's and the demo's rows in float32 (the wrappers pad d
        # to 128), with the device time of a call beside SDPA's
        summary[-1]["narrow"] = [{k: r.get(k) for k in (
            "case", "dtype", "shape", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
            "bound_by", "bound_3xtf32_ms", "library_ms", "kernel_device_ms", "library_device_ms")}
            for r in narrow_rows[name] if r["dtype"] == "float32"]
        if name in large_rows:
            # the large preset's rows in float32 (K4's n=2304 (K5) and d=2048
            # rows among them)
            summary[-1]["large"] = [{k: r.get(k) for k in (
                "case", "dtype", "shape", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
                "bound_by", "bound_3xtf32_ms", "library_ms", "yardstick_ms",
                "unfused_kernels_ms")} for r in large_rows[name] if r["dtype"] == "float32"]
        if name == "consensus_attention":
            # the same kernel in glom_tpu's blocked regime (K5, n > 1024)
            k5 = main_rows["consensus_blocked"]
            summary[-1]["k5"] = {
                "replaces": "glom_tpu/kernels/consensus_pallas.py:198 (_forward_blocked :153)",
                "case": k5["case"], "dtype": k5["dtype"], "max_abs_err": k5["max_abs_err"],
                "ms": k5["kernel_ms"], "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
                "bound_by": k5["bound_by"], "bound_3xtf32_ms": k5["bound_3xtf32_ms"],
                "library_ms": k5["library_ms"], "library_case": "attend_self=True, same inputs"}
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
