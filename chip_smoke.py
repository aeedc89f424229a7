#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--calls-per-window N]

Phases, in order; any failure ends the run with a non-zero exit code:

1. build: compile the port's CUDA sources (tse1m_tpu_torch/cluster/kernels/
   csrc/) at first use and time it, and meanwhile, on a thread, its
   native host layer with g++ (tse1m_tpu_torch/native/decode.cc,
   encode.cc into the gitignored build/tse1m_tpu_torch/native/): a
   library that does not build or load fails the run, since the
   extraction and the delta encoding would otherwise fall back to numpy
   unseen;
2. kernel checks: hold each kernel against its plain PyTorch version on the
   card, bit for bit (tolerance: exact).  The MinHash and bin-min kernels
   at the main-path chunk shape (250,368 rows x 64 ids, H=128, B=16) and at
   edge shapes (for the MinHash kernels also the default run's 507,704
   delta rows, N off their 8-row unit, S = 1, 13 and 300 at 4 warps a
   block, 1,000 at 2, 2,000 and the widest S accepted at 1, H/B = 1 to 32,
   k = 1-4 at offsets 0 and 0xFFFFFF00, ids and byte runs off 16-byte
   alignment; an S too wide for shared memory must be refused before
   launch); the
   rANS kernel at the lanes the default 1M run codes (its
   rep and counts lanes, encoded here by the port's host codec), each alone
   and both in one launch, at the edge shapes of the CPU tests, and with
   lanes of different lengths and plane counts in one launch, their words
   at odd offsets inside one staged buffer; the top-k kernel at cell (g)'s
   shape (64 queries over 1,000,448 columns, k=10), at the CPU tests'
   edges, and at 72 and 128 queries, H = 16 and 128 and column counts that
   are not a multiple of its 256-column tile (nor of 4); an H whose count
   block does not fit in shared memory must be refused at launch; then the
   warm path's launch patterns: the two MinHash kernels and the bin-min
   kernel at the pow2 novel batches of 1, 2, 4 ... 65,536 rows x 64 ids,
   and the top-k kernel on a 16,384-column chunk whose incoming state is
   the previous chunk's, and on a shard's tail chunk of 77 rows padded
   with ROW_INF columns;
3. main path, on 1,000,000 planted sessions x 64 ids.  First, 20,000-row
   slices must give the same labels on the card as on the CPU: through
   each MinHash kernel on the plain wire, through every lane of wire v3
   (``encoding="delta", prefilter="on", entropy="force"``) under kminhash
   and cminhash, and through weighted rows on the plain wire.  Then the
   cells, each driven with the launch counts set to 0 just before and read
   just after:
   (a) the plain wire at 10 bits (sub-byte chunks -> the uint32 kernel) and
   (b) at 24 bits (byte chunks -> the packed kernel): each run must move
       its kernel's launch count (and only its), match the plain signatures
       and band keys over all rows, and reach ARI >= 0.98;
   (d) a forced wire v3 run on 100,000 sessions (every chunk and lane coded,
       the 24-bit full lane as three byte planes plus its offset): labels
       equal to the plain wire's, one rANS launch a coded chunk and one for
       all the metadata lanes;
   (c) the default ``ClusterParams`` at 1M rows, the path users get: the
       prefilter, the delta lane and the rANS lanes engage; launches of the
       rANS kernel (one, for the rep and counts lanes together) and the
       uint32 MinHash kernel only;
       signatures of every kept row equal to the plain version's; labels
       equal to the 10-bit plain run's element for element; ARI >= 0.98;
   (e) (c) with ``scheme="cminhash"``: the bin-min kernel on the full lane
       and on the delta rows, no MinHash kernel; signatures of every kept
       row equal to the plain version's; ARI >= 0.98;
   (f) ``scheme="weighted"`` over 200,000 sessions of their own, replica-
       expanded by their synthesized hit counts: the bin-min kernel only
       among the hashing kernels, signatures equal to the plain version's,
       ARI printed;
   (g) ``topk_agreement`` of 64 queries drawn from (a)'s 1M signatures,
       k=10: one launch of the top-k kernel, its state equal to the plain
       version's, each query's first hit at 128 agreements;
3b. the warm path through a signature store (``ClusterParams.sig_store``)
   under the gitignored build/warm_smoke/.  First, 20,000-row slices
   under kminhash, cminhash and weighted give the same labels on the card
   as on the CPU through a populate (union), an accreted +4% run (merge)
   and a shuffled copy (union), and ``minhash_novel_rows`` at K = 1, 3, 8,
   9, 37 and wire_quant_bits 0, 10, -1 the CPU's signatures.  Then
   ``synth_session_sets(1_050_000, seed=0)``, each run driven with the
   launch counts set to 0 just before and read just after:
   (1) the first 1,000,000 rows populate the store: union, hit rate 0,
       the MinHash kernel launched, labels equal a storeless run at (a)'s
       plain 10-bit wire;
   (2) all 1,050,000 rows (a 4.76% tail): merge, at most 50,000 novel
       rows, kernel launches only for their chunks, under a tenth of run
       1's wire, labels equal a storeless run's;
   (3) the same rows again: merge, no novel row, no launch, run 2's labels;
   (4) a seeded permutation of them: union, hit rate >= 0.95, labels equal
       a storeless run's over the permuted rows;
   (5) ``bulk_topk_store`` of 64 queries drawn from the store, k=10, in
       16,384-column chunks: one top-k launch a chunk, ranks equal to
       ``topk_agreement``'s over the store's signatures in scan order, each
       first hit at 128 agreements; the same without overlap;
   one ``warm_path`` JSON line with each run's wall, stages and cache
   keys, the store's bytes on disk, peak device memory and the card;
3c. serving: a copy of the store as run (1) left it (build/serve_smoke/,
   gitignored) opened by ``ServeDaemon(device=cuda)`` behind a
   ``ServeServer`` on 127.0.0.1, driven by a ``ServeClient`` over TCP,
   each kind of request with the launch counts set to 0 just before and
   read just after: the 50,000-row tail ingested in 4,096-row batches
   with request ids, every ack ok, the first 6 alone (the MinHash kernel
   at least once a batch with novel rows, no other kernel), the other 7
   while two more clients on their own threads send scan-mode ``topk``
   requests of 8 stored vectors back to back and ``query`` requests of 64
   10 ms apart (each scan equal to ``score_topk_host`` over the first m
   shards, m between the reader's shard counts when it went out and when
   it came back; each query label a hub of the row's final cluster; the
   MinHash kernel at least once a batch with novel rows, the top-k kernel
   once a chunk of every scan, at least one scan overlapping the ingest);
   batch 0's request id again, replayed with no new row and no launch;
   1,024 query vectors (512 stored, 512 held out) in 16 requests, the
   stored ones known with the storeless oracle's labels, no launch;
   ``topk`` k=10 of 64 stored
   vectors in candidates mode (no launch) and scan mode (the top-k kernel
   once a 16,384-column chunk; scores and digest ids equal
   ``score_topk_host``'s over the store's signatures); quiesce, status.
   Then in process: all 1,050,000 rows known with the labels of the
   storeless run of (2) (its oracle), element for element, and the
   tail's stored signatures equal ``scheme_host_signatures`` of the
   quantized tail bit for bit; one ``serve`` JSON line with the open
   wall, ingest rows/s and seconds a batch (alone and under load, with
   the concurrent requests' p50/p99), p50/p99 a verb, the scan's
   wall and chunks, the launches, peak device memory, the store's bytes
   and the card;
3d. resilience at 1M x 64 sessions, under the gitignored build/resil_smoke/
   with TSE1M_ROUTER_CAL pointing at build/resil_smoke/cal.json for this
   phase only (the file is removed after (r3)), each run's launch counts
   and degradation events set to 0 just before it and read just after:
   (r1) ``python -m tse1m_tpu_torch cluster --n 1000000 --checkpoint-dir``
       in a child process under a fault plan that SIGKILLs its second
       shard save (cell (c)'s plan: the full lane's shard, then the delta
       lane's): it must die by -9 with shard 0 done and the delta shard's
       temp file left; then ``cluster_sessions_resumable`` at the defaults
       in this process resumes it: (c)'s labels, the MinHash kernel only
       for the delta rows and the rANS kernel as often as in (c) (the full
       lane re-shipped and decoded, not hashed), the directory empty
       after;
   (r2) ``cluster_sessions_resumable`` at (a)'s params with
       ``pipeline._chunk_minhash`` wrapped so that, from the first whole
       chunk until the next one, each call runs with the allocator capped
       (``set_per_process_memory_fraction``) at what is reserved plus a
       budget between what half a chunk's compute and a whole one's take
       (both measured first): torch's own out-of-memory must halve the
       chunk, the manifest keep its step and 4 chunks, the labels equal
       (a)'s and cal.json hold the surviving step x 256 B;
   (r3) a storeless run at (a)'s params under that cal.json: more than 4
       launches of the MinHash kernel, one a calibrated chunk; (a)'s
       labels;
   (r4) (b)'s params under a plan that stalls one staged copy (3 s past a
       1 s budget) and two compute waits (4 s past a 2 s budget): one
       ``stall_retry`` and two ``device_retry`` events, no failover, (b)'s
       labels, the packed kernel 4 times plus once a rerun chunk;
   one ``resilience`` JSON line with each run's wall, launches, events and
   stages, the child's wall and return code, the shard bytes on disk, the
   calibrated step, peak device memory and the card; the ``kernels`` line
   adds each kernel's launches there under ``resilience_launches``;
3e. the sharded serving plane over phase 3b's 1,050,000 rows at full width,
   under the gitignored build/sharded_smoke/: the 1M base rows split by
   ``digest_range_ids(row_digests(rows), 4)`` and each range populated
   into ``root/range_000N`` with ``cluster_sessions(sig_store=...)`` at
   the 10-bit kminhash policy (the MinHash kernel); a replica of range 1
   pulled then; the uninterrupted oracle in process over copies of the
   four stores: a ``ShardRouter`` over four ``LocalTransport(ServeDaemon(
   device=cuda))`` (the daemon's default state commit, every 8
   generations: the oracle reads its index and store, never its state
   files, and the children's per-generation commits are what the
   failover round holds) routes the 50,000-row tail in
   4,096-row batches (the MinHash kernel at least once a shard slice with
   novel rows, the rANS kernel at most once a slice where the entropy
   gate codes a chunk padded to a power of two, no other kernel),
   quiesces and queries all 1,050,000 rows
   through the router; then the failover round in child processes: four
   ``python -m tse1m_tpu_torch serve --root R --range N`` on the card and
   a ``serve-router --root R --shards 4`` driven by a ``ServeClient``, the
   same tail routed with the same request ids while shard 0 runs under a
   plan that SIGKILLs it at ``serve.ingest.commit`` on its third commit
   (a watcher respawns it; the respawn claims lease epoch 2) and the
   router's plan drops shard 2's answer of batch 8 (its ack replayed from
   the shard's journal): every batch acked, no acked row lost, every
   label equal to the oracle round's element for element, the index and
   store rows the oracle's (none absorbed twice), one replayed ack in the
   router's status; then, with the children up, the replica is exactly
   the writer's unpulled generations stale, pulled and refreshed to 0,
   its labels shard 1's, its scan on the card (the top-k kernel once a
   chunk) equal to ``score_topk_host`` over range 1's store, its ingest
   refused; ``backfill --sig-store R/range_0002`` in process (the top-k
   kernel) equal to ``score_topk_host`` and ``backfill --port-file`` of
   the router equal to each store's host top-k merged by (-count, digest),
   the union's; last, a daemon on range 0's old lease epoch appends zero
   rows.  One ``serve_sharded`` JSON line (populate s per range, routed
   rows/s of both rounds, the failover s from the kill to the
   replacement's first ack, the replica's pull s and bytes and staleness,
   both backfills' pairs_scored_s, the launches, peak device memory in
   this process, the card); the ``kernels`` line adds each kernel's
   launches there under ``sharded_launches``; the children's transcripts
   go to build/sharded_smoke/*.log;
3f. device tooling at the main path's full width, under the gitignored
   build/tool_smoke/: (c) again as ``python -m tse1m_tpu_torch cluster
   --n 1000000 --profile --ari-sample 0`` in a child process on the card:
   its n_clusters, ARI and wire keys equal phase 3's unprofiled (c), its
   ``profile_000.json`` beside ``run_manifest.json`` has the JAX package's
   keys, a live sampler's samples with ``cluster`` among its planes and
   collapsed stacks, every lock-wait site one of JAX's lock names, and its
   torch.profiler Chrome trace under ``device_trace/`` launches the
   MinHash kernel and the rANS kernel as often as (c) did; (c) once more
   in this process under the same wrapper (sampler, lock-wait recorder,
   device trace), with (c)'s labels and launches, its wall against phase
   3's plain (c), run in this process too: the profiler's own cost, with
   no fresh process in the way; (w2) again, in
   process, over a copy of the store as run (1) left it, inside
   ``profiling.device_trace`` (merge, its labels the storeless run's, the
   trace's MinHash launches the run's); then after one warm-up each, under
   ``lint.runtime.sanitized(0)`` (no build; host waits counted by their
   innermost port frame): (b)'s 24-bit run ((b)'s labels, the packed
   kernel), (w3)'s all-hit run ((2)'s labels, no launch) and (w5)'s
   64-query scan (the warm-up's ranks, the top-k kernel once a chunk);
   last the sanitizer's self-check on the card (a wait seen from this
   thread and from a second one).  One ``profile`` JSON line: for (c) and
   (w2) the traced window, the device busy share (the union of kernel,
   copy and fill intervals over the window; for (c) also over the cluster
   wall), device seconds split by the pipeline's profiler regions into
   decode, MinHash, the LSH tail with the fetch back, and other, each
   bucket's ``op/kernel`` names, H2D and D2H copies and bytes (also for
   the in-process (c) under the wrapper); the child's wall against phase
   3's (c), the in-process walls and the wrapper's ratio to the plain run, the
   stages of each, the child's sampler planes and lock sites; each sanitized run's build count, sync sites, wall and
   launches; the self-check; the card;
3g. the mesh on one card, over phase 3's 1,000,000 x 64 items (128
   hashes, 16 bands), under the gitignored build/mesh_smoke/; each timed
   run after a 4,096-row warm-up, its launch counts, collective stats and
   peak memory set to 0 just before and read just after:
   (m1) a world of 1 on NCCL in this process (``file://`` rendezvous):
       ``cluster_sessions(items, ClusterParams(prefilter="off"), mesh=)``
       through the 24-bit pack (the packed kernel once) and through a
       pre-sharded feed (the uint32 kernel once), each equal to (b)'s
       labels (the unquantized single-device run), then
       ``destroy_process_group()``;
   (m4) 4 ranks sharing the card over gloo, spawned from this script
       (``--mesh-rank``), each loading the built libraries: first they
       probe which collectives gloo takes on CUDA tensors (the Mesh stages
       none through host memory, so every one must be taken), then the
       same call over their 250,000 rows each, the packed kernel once a
       rank, every rank's labels equal to (b)'s; then four
       ``python -m tse1m_tpu_torch cluster --n 1000000 --ari-sample 0``
       children under the TSE1M_* variables: their merged
       ``run_manifest.json`` has four fragments, each with (b)'s
       n_clusters and ARI;
   (m3c) 3 ranks, ``scheme="cminhash"``: 16 bands pad one dummy band,
       1,000,000 rows pad two zero rows; the bin-min kernel once a rank;
       the labels equal the single-device cminhash run's (unquantized,
       prefilter off);
   (h-m2) after phase 4b: two ranks run ``all`` over phase 4's study (999,049
       builds) under the TSE1M_* variables and TSE1M_BACKEND=auto; rank 0
       writes phase 4's single-rank file set, its CSVs byte for byte; each
       driver's manifest notes that ``auto`` gave the device engine in a
       world of 2; no built library changed from before (m4) to after
       (h-m2) (no rank rebuilt one, none left a lock); every rank runs
       ``all``'s correctness steps, as every process running the JAX
       package's ``all`` does.  Then one ``correctness_steps_s`` JSON
       line: the graftlint and graftspec walls of each ``all`` of the
       script (the golden study's, (h)'s, 4c's, (h-m2)'s rank 0's);
       phase 4d runs in this process while (h-m2)'s ranks do, so
       (h-m2)'s wall is with 4d beside it;
   One ``mesh`` JSON line: the gloo probe, for each cell the world size,
   backend, wall and per rank the four stages, the bytes and seconds of
   the key ``all_to_all``, the signature gather and the ``pmin``s, the
   propagation's iterations, the launches and peak device memory; (h-m2)'s
   ``all`` wall beside phase 4's; the card; the ``kernels`` line adds each
   kernel's launches there under ``mesh_launches``;
3h. the pod on one card, over phase 3b's 1,050,000 x 64 sessions (128
   hashes, 16 bands), under the gitignored build/pod_smoke/: each cell is
   two child processes of this script under
   TSE1M_NUM_PROCESSES/TSE1M_PROCESS_ID, heartbeats every 0.2 s and a 5 s
   loss timeout, each loading the built libraries:
   (p2) ``--pod-rank`` children, each running ``run_pod_cluster`` (the
       ``cluster --sig-store`` command's pod route, no torch.distributed
       world) over phase 3b's rows as the ``pod-cluster`` step of a
       manifest fragment closed as the command closes its step
       (``close_cluster_step``), its launch counts and peak device memory
       set to 0 just before and read just after; the reference is the
       single-device, unquantized storeless run of the same rows
       (``params_for(-1)``):
       cold over the first 1,000,000 rows into a fresh root, then warm
       over all 1,050,000 against it: both processes ok, each one's labels
       the reference's element for element, the cold hit rate 0 and the
       warm one phase 3b's run 2's, a MinHash launch for each chunk of a
       process's novel tail and no other hashing, the merged
       ``run_manifest.json`` of both fragments at the membership epoch;
   (p-kill) process 1 SIGKILLed at ``pipeline.h2d``, (p-lead) process 0
       SIGKILLed there, (p-zombie) process 1 wedged there by the
       ``zombie`` kind and woken once the survivor has advanced the epoch
       and exited: the three pods at once, each process the ``cluster``
       command itself (``--pod-cli``: ``tse1m_tpu_torch.__main__.main``,
       its ``_cluster_labels`` wrapped to keep the labels and counts)
       over 100,000 of its own sessions (cut from 1M) with ``--sig-store``
       and a TSE1M_COORDINATOR in the environment; every process that
       reports took the pod route and never had a torch.distributed
       world; the survivor fails over at epoch 1 (``host_lost``,
       ``pod_failover``, ``epoch_advance``, ``shard_range_reassigned``,
       and ``leader_promoted`` when process 0 died, in the manifest the
       command merged) with the labels of the command's sessions
       clustered without the store; the zombie exits 1 with
       ``LeaseSupersededError`` (``lease_superseded`` in its fragment),
       no labels, and the root's files outside ``pod/`` byte for byte as
       the survivor left them.
   One ``pod`` JSON line: each cell's wall, hit rate, novel and appended
   rows, exchanged bytes and epoch, and per process the walls of probe,
   load, MinHash, exchange, append and the LSH tail, its start, launches
   and peak device memory; the failover cells' survivor exit times, its
   timeline from spawn (imports done, labels back, the command returned)
   and degradation counts; the card; the ``kernels`` line adds each kernel's
   launches in (p2)'s four processes under ``pod_launches``;
3i. the schedule explorer (tse1m_tpu_torch/trace/) on the card:
   ``explore("serve")`` and ``explore("router")``, 16 seeded PCT schedules
   and the depth-3 exhaustive enumeration each, with ``signer="device"``:
   the daemons' novel rows MinHashed on the card from the threads the
   scheduler serializes (the router's query fan-out on child threads it
   steps), then the committed ``serve`` and ``store`` strings replayed;
   each run's launch counts set to 0 just before and read just after:
   every schedule holds the scenario's invariants (labels equal to the
   host clustering of each generation, monotone snapshots; the router's
   no double absorb, one ack per request id, stable routed labels) and
   the lockset detector finds no race; one MinHash launch (kernel 1 or 3,
   by the slice's wire width) for each 4-row batch slice with novel rows,
   in every schedule, and no other kernel.  One ``trace`` JSON line
   (schedules, distinct traces, races, launches, walls, the card); the
   ``kernels`` line adds each kernel's launches there under
   ``trace_launches``;
4. the RQ path (torch ops, no kernel of its own): the frozen golden study
   (tests/goldens/generate_goldens.py) and its corpus CSV through the
   port's six drivers on the card, run as ``all`` runs them, all eight
   committed artifacts equal to tests/goldens/synth8/ byte for byte, and
   its 22 figures drawn where matplotlib imports, or else (the card's
   machine has none) no PDF written and every one of them listed under
   ``figures_skipped`` in the drivers' manifests; then
   a study of the paper's scale (446 projects x 1,600 days, ~1M fuzzing
   builds, cutoff 2026-01-01) generated, written to sqlite under the
   gitignored build/ with its corpus CSV, extracted on the numpy path (the
   native decoder off, the yardstick of phase 4b), and the fused six-RQ
   suite and the six single calls on the card held against
   TorchBackend("cpu") on the same arrays (exact, Spearman and mean
   within 2e-5); the extraction, each RQ and the suite timed warm (median
   of 5 until phase 3e and of 3 until phase 3g joined the script, now
   one warm call each), printed as one ``rq_path`` JSON line with the row counts, peak
   device memory, host generation and write times and the card's name
   and power limit; then ``all`` once over that study on the card with
   the corpus CSV's G1/G2 groups, ``all``'s correctness steps first:
   ``graftlint`` (the port's lint over tse1m_tpu_torch/, no new or
   baselined finding, and the sanitizer's self-check on the card, a wait
   seen from two threads) and ``graftspec`` (the three protocol specs
   model-checked, the three mutants caught and replayed), both ok, with
   neither jax nor pandas imported, one ``correctness`` JSON line (files,
   findings new, baselined and suppressed by rule, the lint's wall and
   cache hit rate, each spec's states, the mutants caught, the steps'
   walls, the card); every step ok in run_manifest.json,
   every driver's manifest naming TorchBackend on the card, each
   artifact's row count the one the single calls' results imply; each
   driver's wall and phases printed as one ``rq_drivers`` JSON line with
   the card's name and power limit (the drivers extract through the
   native decoder, as a user's ``all`` does);
4c. the auto router (``backend = auto``) over phase 4's 1M-build study and
   its extraction: ``get_backend(Config(backend="auto"), "cuda")`` gives
   ``AutoBackend`` with the probed dispatch round trip; three rounds of
   the six RQ calls and ``rq_suite``, each routed result held against
   phase 4's TorchBackend("cuda") results (exact; Spearman and mean
   within 2e-5), the engine and wall of each call and ``calibration()``
   printed; then the ``all`` command (the CLI's ``main``, in this
   process) over the golden study under TSE1M_BACKEND=auto: every step
   ok, the eight goldens
   byte for byte, each driver's manifest naming ``auto`` on the card with
   its ``router_calibration``.  One ``auto_router`` JSON line.  Every other
   phase pins TSE1M_BACKEND=jax_tpu (the device engine), since
   program/envFile.ini ships ``auto``; (h-m2) runs under ``auto``, which
   in its world of 2 ranks must give the device engine, noted in each
   manifest;
4b. the study arrives, under the gitignored build/load_smoke/: phase 4's
   study written as the collectors' CSVs (``to_csv_dir``) and loaded by
   ``python -m tse1m_tpu_torch ingest`` in a child process; meanwhile
   written as a pg_dump (COPY blocks with comment, SET, CREATE and ALTER noise, the
   analyzer's 'Success' for 'Finish', NULL arrays, YAML cells with a tab, a
   newline and a backslash, and a block of a table outside the study) and
   loaded by a child ``restore``: every table's rows as written, the
   escapes and the canonical result restored, ``projects`` derived; both
   copies extracted by the native decoder (``native_decode``) to phase
   4's numpy arrays, numbers element for element and text by value, the
   restored copy timed alone (one call) against phase 4's numpy
   extraction, and a child ``stats`` of phase 4's file and of both
   copies, the same lines, the three children running while this process
   extracts the ingested copy (the suite over the restored copy's arrays
   is not run again: that equality and phase 4's suite checks hold it);
   the native delta grouper's
   ``rep_of`` at (c)'s 647,790 kept rows equal to numpy's ``_group_rows``,
   both timed (cell (c) of phase 3 runs through the native grouper: its
   labels and launch counts are checked there as before, its encode stage
   printed here); one ``study_load`` JSON line with the rows, each step's
   wall, the extraction and grouping walls native and numpy, and the
   card's name and power limit.  Postgres is not driven: no server runs
   on the card's machine;
4d. the collectors (``collect/``, no pandas, PyYAML, requests or selenium
   on the card's machine), after phase 4b, beside (h-m2)'s world (it
   stops if a rank fails, and kills its own children if it fails), under
   the gitignored
   build/collect_smoke/, over a fixture made here from seed 0: a local
   git oss-fuzz checkout of 30 projects (their project.yaml files in every
   form of the YAML subset, four malformed; 8 add a seed corpus; their
   history written by one ``git fast-import``), a GCS listing of 4 pages
   of 1,000 objects holding 3,000 build logs (2-20 KB, the fuzzing,
   coverage and error kinds, some absent), 30 x 60 days of coverage
   reports in the three families with days missing, GitHub's answers for
   the corpus commits, and 1,000 issue pages from a page client of this
   script scraped in two windows by ``scrape_issues``.  ``collect
   projects --no-clone`` and ``collect issues`` (merge and normalize) run
   as children; the GCS (2 pages a batch), buildlogs (8 workers),
   coverage and corpus drivers run here over DirFetcher; GCS, buildlogs
   and coverage again through HttpFetcher and the package's urllib
   session (127.0.0.1 in ``no_proxy`` meanwhile) against a loopback
   ``http.server`` child serving the same
   tree (scripted 429 with Retry-After: 1 and 503s, and 404s): its CSVs
   equal DirFetcher's byte for byte and its retries the script's; the
   study ingested by a child ``ingest``, ``rq1`` on the card equal to
   ``rq1 --device cpu`` file for file; GCS, buildlogs and ingest again
   under a seeded fault plan (``http.fetch`` raise, connection_drop and
   delay, ``checkpoint.csv.flush`` torn_write, ``db.execute``
   connection_drop): the CSVs and the study equal the fault-free run's;
   ``python -m tse1m_tpu_torch.bench diff``, ``gate`` (its verdict on the
   committed rounds, exit 1) and ``keys`` as children.  Without git on
   PATH the project and corpus steps are left to the CPU tests and the
   line says so.  One ``collect`` JSON line with each step's wall and
   rows, the retries and the faults fired, git's presence and the card;
5. timing: each kernel beside its plain version (CUDA events around
   ``--calls-per-window`` back-to-back calls, 5 by default, median of 20
   windows after warm-up; 1 times each call alone, as earlier versions of
   this script did, wrapper's host work included; the plain
   versions one call a window, the rANS lanes' and (g)'s chunk's the one
   call phase 2 and cell (g) time with CUDA events as they run it for
   their checks) at the main-path shapes, with its bound,
   and the bin-min kernel beside ``scatter_reduce_`` (its library
   yardstick); the uint32 MinHash kernel also at (c)'s 507,704 delta
   rows; the rANS kernel at the rep lane alone and at (c)'s one launch,
   with the SM clock read by nvidia-smi meanwhile and the cycles a step it
   gives; the top-k kernel whole and each of its passes alone; both
   MinHash kernels at the 65,536-row pow2 novel batch and the top-k kernel
   at the scan's first 16,384-column chunk, each beside its bound (in the
   ``kernels`` line under ``warm_shapes``, with the warm path's launches
   under ``warm_launches`` and phase 3c's ingest and scan launches under
   ``serve_launches``);
6. the card's name and power limit from nvidia-smi; jax, jaxlib,
   pandas, yaml, requests and selenium never imported by this process.

The second-to-last lines are the ``kernels`` JSON and the card; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import glob
import http.server
import io
import json
import os
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tse1m_tpu_torch import (SignatureStore, adjusted_rand_index,
                             bulk_topk_store, expand_weighted, row_digests,
                             score_topk_host, store_scan_locator,
                             synth_session_hitcounts, synth_session_sets,
                             topk_agreement)
from tse1m_tpu_torch.analysis import RQ_DRIVERS, run_rqs
from tse1m_tpu_torch.analysis.corpus import g4_prepost, load_corpus_groups
from tse1m_tpu_torch.backend import AutoBackend, TorchBackend, get_backend
from tse1m_tpu_torch import native
from tse1m_tpu_torch.cluster import encode, entropy, kernels, pipeline
from tse1m_tpu_torch.cluster.checkpoint import ClusterCheckpoint
from tse1m_tpu_torch.cluster.encode import (pack_chunk, pack_delta_meta,
                                            quantize_ids)
from tse1m_tpu_torch.cluster.kernels import _build
from tse1m_tpu_torch.cluster.kernels import cminhash as kcm
from tse1m_tpu_torch.cluster.kernels import minhash as kmod
from tse1m_tpu_torch.cluster.kernels import rans as krans
from tse1m_tpu_torch.cluster.kernels import score as ksc
from tse1m_tpu_torch.cluster.minhash import mul_u32
from tse1m_tpu_torch.cluster.observability import StageRecorder
from tse1m_tpu_torch.cluster.schemes import (make_params,
                                             scheme_host_signatures)
from tse1m_tpu_torch.cluster.store import digest_range_ids
from tse1m_tpu_torch.config import Config as StudyConfig
from tse1m_tpu_torch.data import columnar
from tse1m_tpu_torch.data.columnar import BytesColumn, CodedColumn, StudyArrays
from tse1m_tpu_torch.data.synth import SynthSpec, generate_study
from tse1m_tpu_torch.db import connect
from tse1m_tpu_torch.device import U32_MASK, as_u32_numpy, u32_tensor, widen
from tse1m_tpu_torch.lint import runtime as sanitizer
from tse1m_tpu_torch.parallel import make_mesh, multihost
from tse1m_tpu_torch.observability import (degradation_counts,
                                           pop_degradation_events, profiling)
from tse1m_tpu_torch.observability.merge import fragment_manifest_path
from tse1m_tpu_torch.resilience import FaultPlan
from tse1m_tpu_torch.trace import explore as texplore
from tse1m_tpu_torch.resilience.coordinator import (LeaseSupersededError,
                                                    RangeLeaseGuard,
                                                    read_lease)
from tse1m_tpu_torch.serve import (LocalTransport, ServeClient, ServeDaemon,
                                   ServeReplica, ServeServer, ShardRouter,
                                   replica_staleness, stream_shards)

N_SESSIONS = 1_000_000
N_FORCED = 100_000
N_SMALL = 20_000
N_WEIGHTED = 200_000          # cell (f): the host prefilter over ~43M ids
N_QUERIES = 64                # cell (g): the JAX bench's topk shape
TOPK_K = 10
SET_SIZE = 64
N_HASHES = 128
N_BANDS = 16
CHUNK_ROWS = 250_368          # the plain path's chunk: 4 chunks of 1M rows
DELTA_ROWS = 507_704          # cell (c)'s delta rows: its largest kernel 1
# The warm path (phase 3b): yesterday's 1M sessions, then a day's 50,000
# new ones (4.76%, under ClusterParams.merge_max_novel's 5%).
WARM_ROWS = 1_050_000
WARM_BASE = 1_000_000
WARM_SMALL_TAIL = 800         # +4% on the 20,000-row card-vs-CPU slices
NOVEL_K = (1, 3, 8, 9, 37)    # minhash_novel_rows batch sizes
POW2_MAX = 65_536             # the largest pow2 novel batch checked
SCAN_CHUNK = 16_384           # bulk_topk_store's chunk columns
ARI_MIN = 0.98
# H100 SXM peaks at the 700 W limit.  HBM: 3.35 TB/s (NVIDIA data sheet).
# Integer: the data sheet's 67 TFLOP/s float32 is 132 SMs x 128 FMA lanes x
# 2 flops x a 1.98 GHz clock; a 32-bit integer multiply-add (IMAD) and a
# 32-bit min (IMNMX) each issue at 64 lanes a clock an SM (CUDA C++
# Programming Guide, arithmetic throughput for compute capability 9.0), a
# quarter of the float32 flop rate.  IMAD runs on the FMA pipe and IMNMX on
# the ALU pipe, so the two can overlap: the least time is the larger pipe's
# count over this rate.
HBM_BYTES_PER_S = 3.35e12
INT32_PIPE_OPS_PER_S = 67e12 / 4
# rANS decode: per symbol and plane, at least the slot mask, the state
# shift, the cumulative-frequency subtract and the renormalization compare
# issue on the ALU pipe (the multiply-add goes to the FMA pipe).
RANS_ALU_OPS_PER_SYMBOL = 4
# Back-to-back kernel calls a timing window (phase 5), by default.
KERNEL_INNER = 5
ROOT = os.path.dirname(os.path.abspath(__file__))

MINHASH_SOURCE = "tse1m_tpu_torch/cluster/kernels/csrc/minhash.cu"
KERNELS = {
    "minhash_and_keys": dict(
        wrapper=kmod.minhash_and_keys, plain=kmod.minhash_and_keys_plain,
        source=MINHASH_SOURCE,
        replaces="tse1m_tpu/cluster/minhash_pallas.py:27"),
    "cminhash_binmin": dict(
        wrapper=kcm.cminhash_binmin, plain=kcm.cminhash_binmin_plain,
        source="tse1m_tpu_torch/cluster/kernels/csrc/cminhash.cu",
        replaces="tse1m_tpu/cluster/minhash_pallas.py:133"),
    "minhash_and_keys_packed": dict(
        wrapper=kmod.minhash_and_keys_packed,
        plain=kmod.minhash_and_keys_packed_plain, source=MINHASH_SOURCE,
        replaces="tse1m_tpu/cluster/minhash_pallas.py:236"),
    "rans_decode": dict(
        wrapper=krans.rans_decode, plain=krans.rans_decode_plain,
        source="tse1m_tpu_torch/cluster/kernels/csrc/rans.cu",
        replaces="tse1m_tpu/cluster/kernels/rans.py:80"),
    "topk_chunk": dict(
        wrapper=ksc.topk_chunk, plain=ksc.topk_chunk_plain,
        source="tse1m_tpu_torch/cluster/kernels/csrc/score.cu",
        replaces="tse1m_tpu/cluster/kernels/score.py:155"),
}
WIRE_V3_FORCED = dict(encoding="delta", prefilter="on", entropy="force")


def log(msg: str) -> None:
    print(msg, flush=True)


T_START = time.perf_counter()
# Never imported by this process: the card's machine has none of them.
FORBIDDEN_MODULES = ("jax", "jaxlib", "pandas", "yaml", "requests",
                     "selenium")


def phase(msg: str) -> None:
    """A phase's header, with the seconds since the script started."""
    log(f"{msg} [{time.perf_counter() - T_START:.1f} s in]")


def max_abs_err(got: tuple, want: tuple) -> int:
    """Largest |kernel - plain| over the outputs, as uint32."""
    return max(int((widen(g) - widen(w)).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def check_kernel(name: str, args: tuple, label: str, want=None) -> int:
    """Kernel vs plain on the card, bit for bit (``want``: the plain
    version's output on ``args``, when already computed); returns the max
    abs err."""
    k = KERNELS[name]
    got = k["wrapper"](*args)
    if want is None:
        want = k["plain"](*args)
    if name == "rans_decode":
        got, want = (got,), (want,)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err or not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name} [{label}] differs from its plain "
                             f"version: max abs err {err}")
    log(f"  {name} [{label}]: bit-identical")
    return err


def u32_ids(rng, shape, high: int = 1 << 32) -> np.ndarray:
    return rng.integers(0, high, size=shape, dtype=np.uint64).astype(np.uint32)


def packed_args(rng, n: int, s: int, k: int, offset: int, consts, dev,
                lead: int = 0):
    """Packed-kernel arguments; with ``lead`` the payload starts that many
    bytes into its buffer, so its byte runs sit off 16-byte alignment."""
    vals = u32_ids(rng, (n, s), 1 << (8 * k))
    payload = np.ascontiguousarray(
        vals.astype("<u4")[..., None].view(np.uint8)[..., :k]).reshape(-1)
    buf = torch.from_numpy(np.concatenate([np.zeros(lead, np.uint8),
                                           payload])).to(dev)
    return (buf[lead:], (n, s), k, offset, *consts)


def minhash_checks(dev, consts) -> dict:
    """Phase 2, MinHash: main-path shapes (the plain path's chunk and the
    default run's 507,704 delta rows, so persistent warps walk many units
    and the last is ragged), then the edges: N off the 8-row unit, one id
    a row and S off 4, band widths H/B = 1 to 32 (the kernel's register
    groups of a band's hashes), ids and byte runs off 16-byte alignment,
    k = 1-4 at offsets 0 and 0xFFFFFF00, S = 300 (opt-in shared memory),
    S = 1,000, 2,000 and the widest accepted (2 and 1 warps a block), and
    an S too wide for shared memory, refused before launch."""
    rng = np.random.default_rng(0)
    errs = {}
    a, b = consts
    main_ids = u32_tensor(u32_ids(rng, (CHUNK_ROWS, SET_SIZE)), dev)
    errs["minhash_and_keys"] = check_kernel(
        "minhash_and_keys", (main_ids, a, b, N_BANDS),
        f"{CHUNK_ROWS}x{SET_SIZE}, full uint32 range")
    errs["minhash_and_keys_packed"] = check_kernel(
        "minhash_and_keys_packed",
        (*packed_args(rng, CHUNK_ROWS, SET_SIZE, 3, 123_456, consts, dev),
         N_BANDS), f"{CHUNK_ROWS}x{SET_SIZE}, k=3, offset 123456")
    delta_ids = u32_tensor(u32_ids(rng, (DELTA_ROWS, SET_SIZE)), dev)
    check_kernel("minhash_and_keys", (delta_ids, a, b, N_BANDS),
                 f"{DELTA_ROWS}x{SET_SIZE} (the default run's delta rows)")
    del main_ids, delta_ids
    a32, b32 = (t[:32].contiguous() for t in consts)
    for n, s in ((1000, SET_SIZE), (1, SET_SIZE), (33, 13), (1000, 1),
                 (33, 1)):
        high = u32_tensor(u32_ids(rng, (n, s)) | np.uint32(1 << 31), dev)
        check_kernel("minhash_and_keys", (high, a, b, N_BANDS),
                     f"N={n}, S={s}, ids >= 2^31")
        check_kernel("minhash_and_keys", (high, a32, b32, 8),
                     f"N={n}, S={s}, H=32, B=8, ids >= 2^31")
    for h, nb in ((32, 32), (128, 128), (128, 32), (128, 8), (128, 4)):
        ah, bh = (t[:h].contiguous() for t in consts)
        high = u32_tensor(u32_ids(rng, (1000, SET_SIZE)) | np.uint32(1 << 31),
                          dev)
        check_kernel("minhash_and_keys", (high, ah, bh, nb),
                     f"N=1000, H={h}, B={nb} (H/B = {h // nb})")
        check_kernel("minhash_and_keys_packed",
                     (*packed_args(rng, 1000, SET_SIZE, 3, 0xFFFFFF00,
                                   (ah, bh), dev), nb),
                     f"N=1000, k=3, H={h}, B={nb} (H/B = {h // nb})")
    for s in (13, SET_SIZE):
        flat = u32_tensor(u32_ids(rng, (1 + 1000 * s,)), dev)
        check_kernel("minhash_and_keys",
                     (flat[1:].view(1000, s), a, b, N_BANDS),
                     f"N=1000, S={s}, ids 4 bytes off 16-byte alignment")
    # S=300 takes 114 KB of shared memory a block: the opt-in launch path.
    wide = u32_tensor(u32_ids(rng, (100, 300)), dev)
    check_kernel("minhash_and_keys", (wide, a, b, N_BANDS), "N=100, S=300")
    # Wider rows take 2 warps a block (S = 1,000) or 1 (S = 2,000 and the
    # widest S the wrapper accepts, found by its own carve-up, so a drift
    # from the kernel's shows as a refused launch).  2,115 rows are 264
    # whole 8-row units and a ragged one: more than one a warp on the card.
    widest = {k: max(s for s in range(1, 4096)
                     if kmod.block_smem(s, N_HASHES, k)[0]) for k in (3, 4)}
    for s in (1000, 2000, widest[4]):
        warps = kmod.block_smem(s, N_HASHES, 4)[0]
        ids = u32_tensor(u32_ids(rng, (2115, s)) | np.uint32(1 << 31), dev)
        check_kernel("minhash_and_keys", (ids, a, b, N_BANDS),
                     f"N=2115, S={s}, {warps} warps a block")
    for k, s, off in ((4, 1000, 0), (4, 2000, 0xFFFFFF00),
                      (4, widest[4], 7), (3, 1000, 0xFFFFFF00),
                      (3, 2000, 0), (3, widest[3], 0xFFFFFF00)):
        warps = kmod.block_smem(s, N_HASHES, k)[0]
        check_kernel("minhash_and_keys_packed",
                     (*packed_args(rng, 2115, s, k, off, consts, dev),
                      N_BANDS),
                     f"N=2115, S={s}, k={k}, offset {off}, {warps} warps a "
                     "block")
    for k, n, s, off, lead in (
            (1, 1000, SET_SIZE, 0, 0), (1, 1000, SET_SIZE, 0xFFFFFF00, 0),
            (2, 1000, SET_SIZE, 0, 0), (2, 777, SET_SIZE, 65_000, 0),
            (2, 1000, SET_SIZE, 0xFFFFFF00, 0), (3, 1, SET_SIZE, 7, 0),
            (3, 1000, SET_SIZE, 0, 0), (3, 1000, SET_SIZE, 0xFFFFFF00, 0),
            (4, 1000, SET_SIZE, 0, 0), (4, 1000, SET_SIZE, 0xFFFFFF00, 0),
            (3, 33, 13, 5, 0), (3, 33, 13, 5, 5),
            (3, 1000, 13, 0xFFFFFF00, 3), (2, 33, 1, 9, 1),
            (3, 100, 300, 0, 0)):
        check_kernel("minhash_and_keys_packed",
                     (*packed_args(rng, n, s, k, off, consts, dev, lead),
                      N_BANDS),
                     f"N={n}, S={s}, k={k}, offset {off}"
                     + (f", byte runs {lead} B off 16-byte alignment"
                        if lead else ""))
    # Not even one warp's stages of 4,000 ids a row fit in a block's shared
    # memory: refused before launch.
    kernels.reset_launch_counts()
    try:
        kmod.minhash_and_keys(u32_tensor(u32_ids(rng, (8, 4000)), dev), a, b,
                              N_BANDS)
    except ValueError as e:
        log(f"  minhash_and_keys at S=4000 refused: {e}")
    else:
        raise AssertionError("minhash_and_keys launched at S=4000")
    if kernels.launch_counts()["minhash_and_keys"]:
        raise AssertionError("the refused shape counted a launch")
    return errs


def rans_args(lane: entropy.EntropyLane, dev) -> tuple:
    """(planes, n, shift) of a coded lane, its arrays copied to ``dev``."""
    dtypes = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32}
    arrays = [torch.from_numpy(a.view(dtypes[a.dtype])).to(dev)
              for a in lane.wire_arrays()]
    planes = [arrays[3 * p:3 * p + 3] for p in range(len(lane.planes))]
    return planes, lane.n, 8 if lane.bits > entropy._DIRECT_BITS_MAX else 0


def default_run_lanes(items) -> dict:
    """The host half of the default 1M run, as cluster_sessions plans it:
    the prefilter's keep mask, the wire plan over the kept rows and the
    coded lanes.  Returns the keep mask, the coded lanes by name and the
    number of rANS launches the run must make (one for the coded metadata
    lanes together, one a coded chunk)."""
    params = pipeline.ClusterParams(n_hashes=N_HASHES, n_bands=N_BANDS)
    keep = pipeline._prefilter_mask(items, params)
    _, enc, _ = pipeline._plan_wire(items[keep], params,
                                    pipeline._quant_bits(items, params))
    meta = pack_delta_meta(enc, entropy=params.entropy)
    chunks = pipeline._row_chunks(
        enc.full_rows, pipeline._stream_plan(enc.full_rows, params))
    coded = {name: lane.ent for name, lane in
             zip(("rep", "counts", "pos", "val"), (*meta.lanes(), meta.val))
             if lane.ent is not None}
    n_coded_chunks = sum(pack_chunk(c, entropy=params.entropy).ent
                         is not None for c in chunks)
    # One launch decodes every coded metadata lane; each coded chunk of the
    # full lane has its own.
    launches = int(bool(coded)) + n_coded_chunks
    log(f"  default run plan: {int(keep.sum())} rows kept, {enc.n_full} "
        f"full + {enc.n_delta} delta, coded lanes "
        + ", ".join(f"{k} ({v.n} x {v.bits} bits, {len(v.planes)} planes)"
                    for k, v in coded.items())
        + f", {n_coded_chunks} of {len(chunks)} full-lane chunks coded")
    if set(coded) != {"rep", "counts"} or n_coded_chunks:
        raise AssertionError("the default run codes other lanes than rep and "
                             f"counts: {sorted(coded)}, {n_coded_chunks}")
    return {"keep": keep, "lanes": coded, "launches": launches,
            "n_delta": enc.n_delta}


def skewed(rng, n: int, bits: int) -> np.ndarray:
    v = rng.geometric(0.2, size=n).astype(np.uint64) * 2654435761
    return (v % (1 << bits)).astype(np.uint32) if bits < 32 else \
        v.astype(np.uint32)


def check_lanes(lanes: list, label: str, wants: list | None = None) -> int:
    """The batched rANS launch vs the plain version, lane by lane, bit for
    bit (``wants``: a lane's plain output where already computed, else
    None); one launch for up to 8 lanes.  Returns the max abs err."""
    kernels.reset_launch_counts()
    got = krans.rans_decode_lanes(lanes)
    launches = kernels.launch_counts()["rans_decode"]
    wants = wants or [None] * len(lanes)
    want = [w if w is not None else krans.rans_decode_lanes_plain([lane])[0]
            for lane, w in zip(lanes, wants)]
    torch.cuda.synchronize()
    coded = sum(n > 0 for _, n, _ in lanes)
    if launches != -(-coded // 8):
        raise AssertionError(f"{coded} lanes took {launches} launches")
    err = max(max_abs_err((g,), (w,)) for g, w in zip(got, want))
    if err or not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"rans_decode_lanes [{label}] differs from its "
                             f"plain version: max abs err {err}")
    log(f"  rans_decode_lanes [{label}]: {len(lanes)} lanes in {launches} "
        "launch(es), each bit-identical")
    return err


def staged(lanes: list, dev, gaps=(1, 3, 5, 2, 7)) -> list:
    """The lanes' word arrays placed in one int16 buffer, each after a gap
    of a few words, so they start at 2-byte offsets that are not 16-byte
    aligned (x0 and freqs stay where they are)."""
    words = [w for planes, _, _ in lanes for w, _, _ in planes]
    offsets, at = [], 0
    for i, w in enumerate(words):
        at += gaps[i % len(gaps)]
        offsets.append(at)
        at += w.numel()
    buf = torch.zeros(at, dtype=torch.int16, device=dev)
    views = []
    for w, off in zip(words, offsets):
        buf[off:off + w.numel()] = w
        views.append(buf[off:off + w.numel()])
    views = iter(views)
    return [([(next(views), x0, f) for _, x0, f in planes], n, shift)
            for planes, n, shift in lanes]


def rans_checks(plan: dict, dev) -> int:
    """Phase 2, rANS: the default run's coded lanes, each alone and both in
    one launch; the CPU tests' edge shapes (direct planes up to 4,096
    symbols, byte planes, step boundaries, a one-symbol alphabet, an empty
    lane); then lanes of different lengths and plane counts in one launch,
    their words at odd offsets inside one staged buffer."""
    err = 0
    main = {name: rans_args(lane, dev) for name, lane in plan["lanes"].items()}
    # A main lane's plain decode takes seconds (a launch of torch ops a
    # step): computed once, it is held against every launch that decodes
    # that lane, staged at odd offsets or not; its time is phase 5's
    # plain_ms for the lane (PLAIN_MS).
    plain = {}
    for name, args in main.items():
        plain[name], PLAIN_MS[f"rans_decode:{name}"] = timed_once(
            lambda args=args: KERNELS["rans_decode"]["plain"](*args))
    for name, args in main.items():
        err = max(err, check_kernel("rans_decode", args,
                                    f"1M default run's {name} lane, "
                                    f"{args[1]} symbols", want=plain[name]))
    err = max(err, check_lanes(list(main.values()),
                               "1M default run's " + " + ".join(main)
                               + " lanes in one launch",
                               wants=list(plain.values())))
    rng = np.random.default_rng(1)
    edges = [(1, 4097), (5, 4097), (12, 4097), (13, 1000), (18, 1000),
             (24, 1000), (32, 1000), (5, 1), (5, 31), (5, 32), (5, 33),
             (18, 33)]
    edge_args = []
    for bits, n in edges:
        lane = entropy.encode_lane(skewed(rng, n, bits), bits, force=True)
        edge_args.append(rans_args(lane, dev))
        err = max(err, check_kernel("rans_decode", edge_args[-1],
                                    f"{bits}-bit lane, n={n}"))
    lane = entropy.encode_lane(np.full(100, 3, np.uint32), 5, force=True)
    edge_args.append(rans_args(lane, dev))
    err = max(err, check_kernel("rans_decode", edge_args[-1],
                                "one-symbol alphabet"))
    lane = entropy.encode_lane(np.zeros(0, np.uint32), 18, force=True)
    kernels.reset_launch_counts()
    if krans.rans_decode(*rans_args(lane, dev)).numel() or \
            kernels.launch_counts()["rans_decode"]:
        raise AssertionError("an empty lane launched the rANS kernel")
    edge_args.append(rans_args(lane, dev))
    odd = sum(int(w.numel() % 8 != 0) for planes, _, _ in edge_args
              for w, _, _ in planes)
    mixed = [edge_args[i] for i in (2, 4, 7, 10, 12, 13)] + [main["counts"]]
    err = max(err, check_lanes(
        staged(mixed, dev), "1 to 3 planes, n = 0 to 4,097 and the counts "
        "lane in one launch, words at odd offsets in one staged buffer",
        wants=[None] * (len(mixed) - 1) + [plain["counts"]]))
    err = max(err, check_lanes(
        staged(edge_args, dev, gaps=(3,)),
        f"all {len(edge_args)} edge lanes, words 6 bytes into their slots, "
        f"{odd} word arrays not a multiple of 16 bytes"))
    return err


def umax_id(a0: torch.Tensor, b0: torch.Tensor) -> int:
    """The id the one permutation maps to UMAX: (UMAX - b0) * a0^-1."""
    a, b = int(widen(a0)[0]), int(widen(b0)[0])
    return ((U32_MASK - b) * pow(a, -1, 1 << 32)) % (1 << 32)


def cminhash_checks(dev) -> int:
    """Phase 2, bin-min: cell (e)'s chunk shape over the full uint32 range
    (a row holding the id that permutes to UMAX, a row of nothing else),
    then H not a power of two, weighted replica widths, one row, one id a
    row."""
    rng = np.random.default_rng(2)
    err = 0
    for n, s, h, scheme in ((CHUNK_ROWS, SET_SIZE, N_HASHES, "cminhash"),
                            (1001, 13, 96, "cminhash"),
                            (5000, 216, N_HASHES, "weighted"),
                            (1, SET_SIZE, N_HASHES, "weighted"),
                            (33, 1, 96, "cminhash")):
        a0, b0 = make_params(scheme, h, 0).to(dev).arrays[:2]
        x = u32_ids(rng, (n, s))
        if n > 2:
            x[0, 0] = x[1, :] = umax_id(a0, b0)
            x[2] |= np.uint32(1 << 31)
        err = max(err, check_kernel(
            "cminhash_binmin", (u32_tensor(x, dev), a0, b0, h),
            f"{scheme} N={n}, S={s}, H={h}, ids >= 2^31 and the UMAX id"))
    return err


def topk_args(store: np.ndarray, queries: np.ndarray, dev, base: int = 0,
              state=None, n_cols: int | None = None) -> tuple:
    """(q, s_t, rowids, topc, topr) as topk_agreement stages them (or, with
    ``n_cols``, as bulk_topk_store stages a chunk of that many columns)."""
    n = store.shape[0]
    s_t, rid = ksc._stage_block(store, base, n_cols or -(-n // 512) * 512,
                                dev)
    q = u32_tensor(ksc._pad_queries(queries), dev)
    return (q, s_t, rid, *(state or ksc._init_state(q.shape[0], dev)))


def exact_topk_args(store: np.ndarray, queries: np.ndarray, dev,
                    base: int = 0, state=None) -> tuple:
    """(q, s_t, rowids, topc, topr) of a chunk of exactly the store's rows,
    not padded to a multiple of 512 columns."""
    n = store.shape[0]
    q = u32_tensor(ksc._pad_queries(queries), dev)
    s_t = u32_tensor(np.ascontiguousarray(store.T), dev)
    rid = torch.arange(base, base + n, dtype=torch.int32,
                       device=dev).reshape(1, n)
    return (q, s_t, rid, *(state or ksc._init_state(q.shape[0], dev)))


def topk_checks(dev) -> int:
    """Phase 2, top-k: cell (g)'s shape over a 4-value alphabet (counts
    near 32 of 128, so the top k end inside a crowd of ties), then the CPU
    tests' edges and the count pass's query groups, hash counts and ragged
    column counts, each chained into a second chunk as its incoming
    state."""
    rng = np.random.default_rng(3)
    store = u32_ids(rng, (N_SESSIONS, N_HASHES), 4)
    queries = store[rng.choice(N_SESSIONS, N_QUERIES, replace=False)]
    err = check_kernel("topk_chunk",
                       (*topk_args(store, queries, dev), TOPK_K),
                       f"{N_QUERIES} queries x {N_SESSIONS} rows, k=10, "
                       "4-value alphabet")
    del store
    for qn, n, h, k, high in ((5, 1000, 16, 7, 3), (8, 1000, 16, 128, 3),
                              (8, 5, 16, 10, 3), (3, 513, 128, 1, 1 << 32),
                              (7, 0, 16, 5, 3)):
        store = u32_ids(rng, (n, h), high)
        queries = u32_ids(rng, (qn, h), high)
        if n > 10:
            store[7] = store[9] = queries[0]
        args = topk_args(store, queries, dev)
        label = f"Q={qn}, N={n}, H={h}, k={k}"
        err = max(err, check_kernel("topk_chunk", (*args, k), label))
        state = ksc.topk_chunk_plain(*args, k)
        more = u32_ids(rng, (n + 100, h), high)
        err = max(err, check_kernel(
            "topk_chunk", (*topk_args(more, queries, dev, n, state), k),
            label + ", chained into a second chunk"))
    # The redesigned count pass: two 64-query groups (72 and 128 queries),
    # H = 16 and 128, column counts off its 256-column tile and off 4 (the
    # wrapper pads those), a tile count not a multiple of the grid.
    for qn, n, h, k in ((72, 1000, 128, 10), (128, 1000, 128, 10),
                        (5, 1001, 16, 7), (128, 3001, 16, 20),
                        (64, 70_003, 128, 10)):
        store = u32_ids(rng, (n, h), 4)
        queries = u32_ids(rng, (qn, h), 4)
        store[7] = store[9] = queries[qn - 1]
        args = exact_topk_args(store, queries, dev)
        label = f"Q={qn}, N={n} (exact columns), H={h}, k={k}"
        err = max(err, check_kernel("topk_chunk", (*args, k), label))
        state = ksc.topk_chunk_plain(*args, k)
        more = u32_ids(rng, (n + 37, h), 4)
        err = max(err, check_kernel(
            "topk_chunk", (*exact_topk_args(more, queries, dev, n, state), k),
            label + ", chained into a second chunk"))
    # H = 300 needs more shared memory than a count block may have: the
    # launch is refused, and no error is left behind for the next launch.
    try:
        ksc.topk_chunk(*topk_args(u32_ids(rng, (64, 300), 4),
                                  u32_ids(rng, (8, 300), 4), dev), 5)
    except RuntimeError as e:
        log(f"  topk_chunk at H=300 refused: {str(e).splitlines()[0]}")
    else:
        raise AssertionError("topk_chunk launched at H=300")
    err = max(err, check_kernel("topk_chunk", (*args, k),
                                label + ", after the refusal"))
    args = (*topk_args(store, queries, dev), 0)
    kernels.reset_launch_counts()
    got = ksc.topk_chunk(*args)
    if kernels.launch_counts()["topk_chunk"] or not all(
            torch.equal(g, w)
            for g, w in zip(got, ksc.topk_chunk_plain(*args))):
        raise AssertionError("k=0 launched the top-k kernel or differs")
    return err


def novel_shape_checks(dev, consts) -> int:
    """Phase 2, the warm path's MinHash shapes: minhash_novel_rows pads a
    novel batch to a power of two, so the two MinHash kernels and the
    bin-min kernel launch at 1, 2, 4 ... 65,536 rows x 64 ids."""
    rng = np.random.default_rng(5)
    a0, b0 = make_params("cminhash", N_HASHES, 0).to(dev).arrays[:2]
    err = 0
    for e in range(POW2_MAX.bit_length()):
        n = 1 << e
        ids = u32_tensor(u32_ids(rng, (n, SET_SIZE)), dev)
        label = f"N={n} (pow2 novel batch), S={SET_SIZE}"
        err = max(err, check_kernel("minhash_and_keys",
                                    (ids, *consts, N_BANDS), label))
        err = max(err, check_kernel(
            "minhash_and_keys_packed",
            (*packed_args(rng, n, SET_SIZE, 3, 123_456, consts, dev),
             N_BANDS), label + ", k=3"))
        err = max(err, check_kernel("cminhash_binmin",
                                    (ids, a0, b0, N_HASHES), label))
    return err


def scan_chunk_checks(dev) -> int:
    """Phase 2, the scan's launches: a 16,384-column chunk whose incoming
    state is the previous chunk's output, and a shard's tail chunk of 77
    rows padded with ROW_INF columns to 16,384."""
    rng = np.random.default_rng(6)
    store = u32_ids(rng, (3 * SCAN_CHUNK, N_HASHES), 4)
    queries = store[rng.choice(store.shape[0], N_QUERIES, replace=False)]
    args = topk_args(store[:SCAN_CHUNK], queries, dev, n_cols=SCAN_CHUNK)
    err = check_kernel("topk_chunk", (*args, TOPK_K),
                       f"{N_QUERIES} queries x {SCAN_CHUNK} columns, the "
                       "empty state")
    state = ksc.topk_chunk(*args, TOPK_K)
    args = topk_args(store[SCAN_CHUNK:2 * SCAN_CHUNK], queries, dev,
                     SCAN_CHUNK, state, SCAN_CHUNK)
    err = max(err, check_kernel(
        "topk_chunk", (*args, TOPK_K),
        f"{N_QUERIES} queries x {SCAN_CHUNK} columns, the previous chunk's "
        "state"))
    state = ksc.topk_chunk(*args, TOPK_K)
    tail = topk_args(store[2 * SCAN_CHUNK:2 * SCAN_CHUNK + 77], queries, dev,
                     2 * SCAN_CHUNK, state, SCAN_CHUNK)
    err = max(err, check_kernel(
        "topk_chunk", (*tail, TOPK_K),
        f"a tail chunk of 77 rows and {SCAN_CHUNK - 77} ROW_INF columns, "
        "the chained state"))
    return err


def params_for(quant_bits: int,
               scheme: str = "kminhash") -> pipeline.ClusterParams:
    return pipeline.ClusterParams(n_hashes=N_HASHES, n_bands=N_BANDS,
                                  encoding="pack24", entropy="off",
                                  prefilter="off", wire_quant_bits=quant_bits,
                                  scheme=scheme)


def small_input_check(items, truth, dev) -> None:
    """Phase 3, first: labels of a 20,000-row slice on the card equal the
    CPU's (plain versions), through each MinHash kernel, through every wire
    v3 lane under kminhash and cminhash, and through weighted rows.  Also
    warms the card up."""
    small = items[:N_SMALL]
    weighted = expand_weighted(small, synth_session_hitcounts(
        small, truth[:N_SMALL]))
    cases = [("plain wire, wire_quant_bits=10", small, params_for(10)),
             ("plain wire, wire_quant_bits=-1", small, params_for(-1)),
             ("wire v3 forced", small, pipeline.ClusterParams(
                 n_hashes=N_HASHES, n_bands=N_BANDS, **WIRE_V3_FORCED)),
             ("cminhash, wire v3 forced", small, pipeline.ClusterParams(
                 n_hashes=N_HASHES, n_bands=N_BANDS, scheme="cminhash",
                 **WIRE_V3_FORCED)),
             (f"weighted ({weighted.shape[1]} replica ids a row), plain "
              "wire, wire_quant_bits=10", weighted,
              params_for(10, "weighted"))]
    for label, rows, params in cases:
        on_card = pipeline.cluster_sessions(rows, params, device=dev)
        on_cpu = pipeline.cluster_sessions(rows, params, device="cpu")
        if not np.array_equal(on_card, on_cpu):
            raise AssertionError(f"card and CPU labels differ on "
                                 f"{N_SMALL} rows ({label})")
        log(f"  {N_SMALL} rows, {label}: card labels == CPU labels")


def drive(items, params, dev) -> dict:
    """Drive cluster_sessions once, the launch counts set to 0 just before
    and read just after."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    labels, sig, keys = pipeline.cluster_sessions(
        items, params, device=dev, return_signatures=True)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    info = dict(pipeline.last_run_info)
    log(f"  wall {wall:.3f} s, launches {counts}, encoding "
        f"{info['encoding']}, chunk bits {info['chunk_bits']}, wire "
        f"{info['wire_mb']} MiB ({info['wire_bytes']} B), prefilter dropped "
        f"{info['prefilter_rows_dropped']}, wire v3 saved "
        f"{info['wire_v3_saved_mb']} MiB, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  stages {json.dumps(info['stages'])}")
    return {"labels": labels, "sig": sig, "keys": keys, "counts": counts,
            "wall_s": wall, "info": info}


def check_signatures(run: dict, rows, hp, dev) -> torch.Tensor:
    """The run's signatures and keys equal the plain version's of its
    scheme over the rows that went to the card, as the wire plan quantized
    them.  Returns the signatures."""
    qbits = run["info"]["wire_quant_bits"]
    planned = u32_tensor(quantize_ids(rows, qbits) if qbits else rows, dev)
    plain = (kmod.minhash_and_keys_plain if hp.scheme == "kminhash"
             else kcm.cminhash_and_keys_plain)
    want = plain(planned, *hp.arrays, N_BANDS)
    del planned
    torch.cuda.synchronize()
    # The run's signatures and keys go here, so later runs' peak device
    # memory does not count them.
    sig, keys = run.pop("sig"), run.pop("keys")
    if not (torch.equal(sig, want[0]) and torch.equal(keys, want[1])):
        raise AssertionError("signatures/keys differ from the plain version")
    log(f"  signatures and keys of all {len(rows)} rows that went to the "
        "card bit-identical to the plain version")
    return sig


def check_ari(labels, truth) -> float:
    ari = adjusted_rand_index(labels, truth)
    log(f"  ARI vs planted {ari:.6f}")
    if not (labels.shape == truth.shape and ari >= ARI_MIN):
        raise AssertionError(f"ARI {ari} below {ARI_MIN}")
    return ari


def expect_launches(counts: dict, want: dict) -> None:
    """Each kernel in ``want`` launched as often as given there (an int:
    exactly; a (least, most) pair: within, most None for no bound); the
    rest never."""
    for name, n in counts.items():
        w = want.get(name, 0)
        if isinstance(w, tuple):
            ok = n >= w[0] and (w[1] is None or n <= w[1])
        else:
            ok = n == w
        if not ok:
            raise AssertionError(f"launches {counts}, expected {want}")


def run_plain(items, truth, quant_bits: int, kernel: str, hp, dev):
    """Phase 3, one plain-wire 1M run through one MinHash kernel; its
    signatures go to the host (cell (g)'s store)."""
    log(f"  plain wire, wire_quant_bits={quant_bits}:")
    run = drive(items, params_for(quant_bits), dev)
    expect_launches(run["counts"], {kernel: (1, None)})
    run["sig"] = as_u32_numpy(check_signatures(run, items, hp, dev))
    run["ari"] = check_ari(run["labels"], truth)
    return run


def run_forced(dev) -> dict:
    """Phase 3: wire v3 forced on 100,000 planted sessions of their own (a
    slice of the 1M set would cut its planted clusters): every chunk and
    lane coded; labels equal to the plain wire's."""
    small, small_truth = synth_session_sets(N_FORCED, SET_SIZE, seed=0)
    log(f"  wire v3 forced, {N_FORCED} rows:")
    run = drive(small, pipeline.ClusterParams(
        n_hashes=N_HASHES, n_bands=N_BANDS, **WIRE_V3_FORCED), dev)
    info = run["info"]
    # One launch per full-lane chunk and one for the metadata lanes (rep,
    # counts, pos, val), all coded.
    expect_launches(run["counts"], {
        "minhash_and_keys": (2, None),
        "rans_decode": len(info["chunk_bits"]) + 1})
    if not (info["encoding"] == "delta" and info["prefilter_rows_dropped"]):
        raise AssertionError(f"forced run did not take wire v3: {info}")
    plain = pipeline.cluster_sessions(small, params_for(0), device=dev)
    if not np.array_equal(run["labels"], plain):
        raise AssertionError("forced wire v3 labels differ from the plain "
                             "wire's")
    log("  labels == the plain wire's")
    run["ari"] = check_ari(run["labels"], small_truth)
    return run


def run_default(items, truth, plan: dict, plain_labels, hp, dev) -> dict:
    """Phase 3: default ClusterParams at 1M rows, the path users get."""
    log("  default ClusterParams (wire v3 auto):")
    run = drive(items, pipeline.ClusterParams(n_hashes=N_HASHES,
                                              n_bands=N_BANDS), dev)
    info = run["info"]
    if not (info["encoding"] == "delta"
            and info["prefilter_rows_dropped"] > 0):
        raise AssertionError(f"default run did not take wire v3: {info}")
    # The full lane's chunks and the delta rows each go to the uint32
    # kernel; every chunk is decoded, so the packed kernel never runs.
    expect_launches(run["counts"], {"minhash_and_keys": (2, None),
                                    "rans_decode": plan["launches"]})
    check_signatures(run, items[plan["keep"]], hp, dev)
    if not np.array_equal(run["labels"], plain_labels):
        raise AssertionError("default-run labels differ from the 10-bit "
                             "plain wire's")
    log("  labels == the 10-bit plain wire run's, element for element")
    run["ari"] = check_ari(run["labels"], truth)
    return run


def run_cminhash(items, truth, plan: dict, dev) -> dict:
    """Phase 3, cell (e): default ClusterParams with scheme="cminhash" at
    1M rows.  The prefilter and the wire plan do not depend on the scheme,
    so the keep mask and the coded lanes are (c)'s."""
    log("  cminhash, default ClusterParams (wire v3 auto):")
    params = pipeline.ClusterParams(n_hashes=N_HASHES, n_bands=N_BANDS,
                                    scheme="cminhash")
    run = drive(items, params, dev)
    info = run["info"]
    if not (info["encoding"] == "delta"
            and info["prefilter_rows_dropped"] > 0):
        raise AssertionError(f"cminhash run did not take wire v3: {info}")
    # One bin-min launch a full-lane chunk and one for the delta rows.
    expect_launches(run["counts"], {
        "cminhash_binmin": len(info["chunk_bits"]) + 1,
        "rans_decode": plan["launches"]})
    check_signatures(run, items[plan["keep"]],
                     make_params("cminhash", N_HASHES, 0).to(dev), dev)
    run["ari"] = check_ari(run["labels"], truth)
    return run


def run_weighted(dev) -> dict:
    """Phase 3, cell (f): scheme="weighted" over 200,000 sessions of their
    own, expanded by their synthesized hit counts (the replica rows the
    JAX command line builds)."""
    small, small_truth = synth_session_sets(N_WEIGHTED, SET_SIZE, seed=0)
    rows = expand_weighted(small, synth_session_hitcounts(small, small_truth))
    log(f"  weighted, default ClusterParams, {N_WEIGHTED} sessions as "
        f"{rows.shape[1]} replica ids a row ({rows.nbytes / 2**20:.1f} MiB):")
    params = pipeline.ClusterParams(n_hashes=N_HASHES, n_bands=N_BANDS,
                                    scheme="weighted")
    run = drive(rows, params, dev)
    info = run["info"]
    expect_launches(run["counts"], {
        "cminhash_binmin": len(info["chunk_bits"])
        + (info["encoding"] == "delta"),
        "rans_decode": (0, None)})
    keep = pipeline._prefilter_mask(rows, params)
    check_signatures(run, rows if keep is None else rows[keep],
                     make_params("weighted", N_HASHES, 0).to(dev), dev)
    run["ari"] = adjusted_rand_index(run["labels"], small_truth)
    log(f"  ARI vs planted {run['ari']:.6f} (printed, not gated)")
    return run


def run_topk(store: np.ndarray, dev) -> dict:
    """Phase 3, cell (g): topk_agreement of 64 queries drawn (seed 1) from
    (a)'s 1M signatures, k=10; then its state held against the plain
    version's on the same staged chunk."""
    rng = np.random.default_rng(1)
    queries = store[rng.choice(store.shape[0], N_QUERIES, replace=False)]
    log(f"  topk_agreement, {N_QUERIES} queries x {store.shape[0]} "
        f"signatures, k={TOPK_K}:")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    counts, rows = topk_agreement(queries, store, TOPK_K, device=dev)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    log(f"  wall {wall:.3f} s, launches {launches}")
    expect_launches(launches, {"topk_chunk": 1})
    if not (counts.shape == (N_QUERIES, TOPK_K)
            and (counts[:, 0] == N_HASHES).all() and (rows >= 0).all()):
        raise AssertionError("a query's first hit is not a full agreement")
    args = (*topk_args(store, queries, dev), TOPK_K)
    got = ksc.topk_chunk(*args)
    want, PLAIN_MS["topk_chunk"] = timed_once(
        lambda: ksc.topk_chunk_plain(*args))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("top-k state differs from the plain version's")
    if not all(np.array_equal(a, b) for a, b in zip(
            (counts, rows), ksc._finalize(*want, N_QUERIES, TOPK_K))):
        raise AssertionError("topk_agreement differs from the plain state")
    log(f"  state == the plain version's; first hits 128 agreements, "
        f"k-th hit counts {int(counts[:, -1].min())}-"
        f"{int(counts[:, -1].max())}")
    return {"counts": launches, "wall_s": wall, "args": args}


WARM_DIR = os.path.join(ROOT, "build", "warm_smoke")  # gitignored


def store_params(store: str, quant_bits: int = 0,
                 scheme: str = "kminhash") -> pipeline.ClusterParams:
    """Default ClusterParams with a signature store."""
    return pipeline.ClusterParams(n_hashes=N_HASHES, n_bands=N_BANDS,
                                  wire_quant_bits=quant_bits, scheme=scheme,
                                  sig_store=store)


def warm_small_check(items, truth, dev) -> None:
    """Phase 3b, first: 20,000-row slices under each scheme give the same
    labels, through the same modes, on the card as on the CPU: a store
    populated (union), an accreted +4% run (merge), a shuffled copy
    (union).  Then minhash_novel_rows at K = 1, 3, 8, 9 and 37 (padded to
    1, 4, 8, 16 and 64 rows) at wire_quant_bits 0, 10 and -1 gives the
    CPU's signatures bit for bit."""
    n = N_SMALL + WARM_SMALL_TAIL
    small = items[:n]
    perm = np.random.default_rng(2).permutation(n)
    rows_of = {"kminhash": small, "cminhash": small,
               "weighted": expand_weighted(small, synth_session_hitcounts(
                   small, truth[:n]))}
    for scheme, rows in rows_of.items():
        runs = (("populate", rows[:N_SMALL], "union"),
                ("accreted +4%", rows, "merge"),
                ("shuffled", rows[perm], "union"))
        labels = ([], [])
        for got_labels, where in zip(labels, ("card", "cpu")):
            d = fresh_dir(os.path.join(WARM_DIR, f"{scheme}_{where}"))
            for label, r, mode in runs:
                got_labels.append(pipeline.cluster_sessions(
                    r, store_params(d, scheme=scheme),
                    device=dev if where == "card" else "cpu"))
                got = pipeline.last_run_info["cache_mode"]
                if got != mode:
                    raise AssertionError(f"{scheme} {label} on {where}: "
                                         f"cache_mode {got}, not {mode}")
        for (label, r, mode), a, b in zip(runs, *labels):
            if not np.array_equal(a, b):
                raise AssertionError(f"card and CPU labels differ: {scheme}"
                                     f", {label} ({len(r)} rows, {mode})")
            log(f"  {scheme}, {label} ({len(r)} rows x {r.shape[1]} ids, "
                f"{mode}): card labels == CPU labels")
        for wq in (0, 10, -1):
            # The width a store of these rows would hold (store runs take
            # no calibrated floor).
            params = store_params(WARM_DIR, wq, scheme)
            qbits = pipeline._quant_bits(rows[:N_SMALL], params)
            for k in NOVEL_K:
                novel = rows[N_SMALL:N_SMALL + k]
                got = pipeline.minhash_novel_rows(novel, params, qbits,
                                                  device=dev)
                want = pipeline.minhash_novel_rows(novel, params, qbits,
                                                   device="cpu")
                if not np.array_equal(got, want):
                    raise AssertionError(f"minhash_novel_rows differs: "
                                         f"{scheme}, K={k}, bits {qbits}")
        log(f"  {scheme}: minhash_novel_rows at K = {NOVEL_K}, "
            "wire_quant_bits 0, 10, -1: bit-identical to the plain version")


def warm_run(items, params, dev, label: str) -> dict:
    """One store run, the launch counts set to 0 just before and read just
    after, its peak device memory taken from a reset."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    labels = pipeline.cluster_sessions(items, params, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    info = dict(pipeline.last_run_info)
    run = {"wall_s": wall, "launches": counts,
           "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
           **{k: info.get(k) for k in (
               "cache_mode", "cache_hit_rate", "cache_novel_rows",
               "cache_store_rows", "wire_mb", "wire_quant_bits",
               "chunk_bits")},
           "stages": info["stages"]}
    log(f"  {label}: wall {wall:.3f} s, {run['cache_mode']}, hit rate "
        f"{run['cache_hit_rate']}, novel {run['cache_novel_rows']}, wire "
        f"{run['wire_mb']} MiB, launches {counts}")
    log(f"    stages {json.dumps(info['stages'])}")
    return {"labels": labels, "run": run}


def expect_equal_to_storeless(labels, items, dev, label: str) -> tuple:
    """Labels equal a storeless run of the same rows at (a)'s plain 10-bit
    wire, element for element; returns that run's wall and labels."""
    t0 = time.perf_counter()
    want = pipeline.cluster_sessions(items, params_for(0), device=dev)
    wall = time.perf_counter() - t0
    if not np.array_equal(labels, want):
        raise AssertionError(f"{label}: labels differ from a storeless run "
                             f"({int((labels != want).sum())} rows)")
    log(f"  {label}: labels == a storeless plain-wire run's, element for "
        f"element (that run {wall:.3f} s)")
    return wall, want


def scan_run(store, queries, dev, overlap: bool) -> tuple:
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = bulk_topk_store(store, queries, TOPK_K, device=dev,
                          chunk_rows=SCAN_CHUNK, overlap=overlap)
    wall = time.perf_counter() - t0
    return out, wall, kernels.launch_counts()


def warm_scan(store_dir: str, dev) -> dict:
    """Phase 3b, run 5: bulk_topk_store of 64 queries drawn (seed 1) from
    the store's signatures, k=10, 16,384-column chunks: one launch a chunk,
    ranks equal topk_agreement's over the signatures in scan order, each
    query's first hit a full agreement; the same without overlap."""
    store = SignatureStore.open_existing(store_dir)
    n = store.n_rows
    loc = store_scan_locator(store, np.arange(n))
    sigs = store.load_signatures(loc[:, 0], loc[:, 1])
    rng = np.random.default_rng(1)
    queries = sigs[rng.choice(n, N_QUERIES, replace=False)]
    chunks = sum(-(-int(e["rows"]) // SCAN_CHUNK) for e in store.shards)
    (counts, rows), wall, launches = scan_run(store, queries, dev, True)
    log(f"  run 5, scan of {n} rows in {len(store.shards)} shards: wall "
        f"{wall:.3f} s, launches {launches}")
    expect_launches(launches, {"topk_chunk": chunks})
    want = topk_agreement(queries, sigs, TOPK_K, device=dev)
    if not all(np.array_equal(a, b) for a, b in zip((counts, rows), want)):
        raise AssertionError("bulk_topk_store differs from topk_agreement "
                             "over the signatures in scan order")
    if not (counts[:, 0] == N_HASHES).all():
        raise AssertionError("a query's first hit is not a full agreement")
    (c2, r2), wall2, launches2 = scan_run(store, queries, dev, False)
    expect_launches(launches2, {"topk_chunk": chunks})
    if not (np.array_equal(c2, counts) and np.array_equal(r2, rows)):
        raise AssertionError("the scan without overlap differs")
    log(f"  ranks == topk_agreement's over the {n} signatures in scan "
        f"order; first hits 128 agreements; without overlap {wall2:.3f} s, "
        "the same ranks")
    return {"run": {"wall_s": wall, "wall_s_no_overlap": wall2,
                    "launches": launches["topk_chunk"], "chunks": chunks,
                    "rows": n, "shards": len(store.shards)},
            "args": topk_args(sigs[:SCAN_CHUNK], queries, dev,
                              n_cols=SCAN_CHUNK)}


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def warm_phase(dev) -> dict:
    """Phase 3b: the warm path at 1,050,000 sessions x 64 ids (a day's
    re-cluster: yesterday's 1M sessions and 50,000 new ones), through a
    signature store under the gitignored build/warm_smoke/."""
    t_phase = time.perf_counter()
    items, truth = synth_session_sets(WARM_ROWS, SET_SIZE, seed=0)
    warm_small_check(items, truth, dev)
    store = fresh_dir(os.path.join(WARM_DIR, "store"))
    params = store_params(store)
    runs, oracle_s = {}, []
    r = warm_run(items[:WARM_BASE], params, dev, f"run 1, populate "
                 f"{WARM_BASE} rows")
    runs["populate"] = r["run"]
    if not (r["run"]["cache_mode"] == "union"
            and r["run"]["cache_hit_rate"] == 0.0):
        raise AssertionError(f"populate: {r['run']}")
    expect_launches(r["run"]["launches"], {"minhash_and_keys": (1, None),
                                           "rans_decode": (0, None)})
    oracle_s.append(expect_equal_to_storeless(
        r["labels"], items[:WARM_BASE], dev, "run 1")[0])
    # Phase 3c serves a copy of the store as run 1 left it; phase 3f
    # merges the tail into another.
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    shutil.copytree(store, SERVE_STORE)
    shutil.rmtree(TOOL_DIR, ignore_errors=True)
    shutil.copytree(store, TOOL_STORE)
    r2 = warm_run(items, params, dev, f"run 2, accreted to {WARM_ROWS} rows")
    runs["accreted"] = run2 = r2["run"]
    tail = WARM_ROWS - WARM_BASE
    if not (run2["cache_mode"] == "merge"
            and 0 < run2["cache_novel_rows"] <= tail
            and run2["wire_mb"] <= 0.1 * runs["populate"]["wire_mb"]):
        raise AssertionError(f"accreted run: {run2}")
    # The novel rows' chunks, each to the uint32 kernel, and nothing else.
    expect_launches(run2["launches"], {
        "minhash_and_keys": len(run2["chunk_bits"]),
        "rans_decode": (0, None)})
    wall, oracle = expect_equal_to_storeless(r2["labels"], items, dev,
                                             "run 2")
    oracle_s.append(wall)
    r3 = warm_run(items, params, dev, "run 3, all hits")
    runs["all_hit"] = r3["run"]
    if not (r3["run"]["cache_mode"] == "merge"
            and r3["run"]["cache_novel_rows"] == 0):
        raise AssertionError(f"all-hit run: {r3['run']}")
    expect_launches(r3["run"]["launches"], {})
    if not np.array_equal(r3["labels"], r2["labels"]):
        raise AssertionError("all-hit labels differ from run 2's")
    log("  run 3: no kernel launched; labels == run 2's")
    perm = np.random.default_rng(3).permutation(WARM_ROWS)
    r4 = warm_run(items[perm], params, dev, "run 4, union of a permutation")
    runs["union"] = r4["run"]
    if not (r4["run"]["cache_mode"] == "union"
            and r4["run"]["cache_hit_rate"] >= 0.95):
        raise AssertionError(f"union run: {r4['run']}")
    oracle_s.append(expect_equal_to_storeless(r4["labels"], items[perm], dev,
                                              "run 4")[0])
    scan = warm_scan(store, dev)
    runs["scan"] = scan["run"]
    line = {"runs": runs, "storeless_oracle_s": oracle_s,
            "store_bytes": dir_bytes(store),
            "peak_device_gib": max(runs[k]["peak_device_gib"] for k in (
                "populate", "accreted", "all_hit", "union")),
            "phase_s": time.perf_counter() - t_phase,
            "card": card_name_and_limit()}
    print(json.dumps({"warm_path": line}))
    return {"launches": {
        "minhash_and_keys": runs["populate"]["launches"]["minhash_and_keys"]
        + run2["launches"]["minhash_and_keys"],
        "topk_chunk": scan["run"]["launches"]}, "scan_args": scan["args"],
        "items": items, "oracle": oracle,
        "hit_rate": run2["cache_hit_rate"]}


SERVE_DIR = os.path.join(ROOT, "build", "serve_smoke")  # gitignored
SERVE_STORE = os.path.join(SERVE_DIR, "store")
SERVE_BATCH = 4_096           # phase 3c: rows an ingest request
SERVE_QUERY_REQUESTS = 16     # phase 3c: 1,024 query vectors in requests of 64
SERVE_SOLO_BATCHES = 6        # phase 3c: tail batches ingested alone; the
                              # rest under concurrent scans and queries
SERVE_SCAN_QUERIES = 8        # phase 3c: vectors a concurrent scan request
LONG_REQUEST_S = 300.0        # client socket timeout of phase 3c's requests


def counted(fn):
    """``fn()`` with the launch counts set to 0 just before and read just
    after; returns (result, counts, wall)."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launch_counts(), time.perf_counter() - t0


def scan_oracle(daemon, queries: np.ndarray) -> tuple:
    """score_topk_host over every committed store row in scan order, as
    the topk verb answers: digest ids, hits sorted by (-count, digest
    hex), ("", -1) padding.  The queries are signed on the host and split
    over threads (numpy releases the GIL), 8 to a call."""
    store = daemon.reader
    loc = store_scan_locator(store, np.arange(store.n_rows))
    sigs = store.load_signatures(loc[:, 0], loc[:, 1])
    hp = make_params("kminhash", N_HASHES, 0)
    qs = scheme_host_signatures(quantize_ids(queries, daemon.qbits), hp)
    with ThreadPoolExecutor(8) as ex:
        parts = list(ex.map(lambda lo: score_topk_host(
            qs[lo:lo + 8], sigs, TOPK_K), range(0, qs.shape[0], 8)))
    scores, ids = [], []
    for counts, rows in zip(np.concatenate([p[0] for p in parts]),
                            np.concatenate([p[1] for p in parts])):
        ok = rows >= 0
        dg = store.load_digests(loc[rows[ok], 0], loc[rows[ok], 1])
        hits = sorted(zip(counts[ok].tolist(),
                          ["%016x%016x" % (int(a), int(b)) for a, b in dg]),
                      key=lambda h: (-h[0], h[1]))
        pad = TOPK_K - len(hits)
        scores.append([c for c, _ in hits] + [-1] * pad)
        ids.append([h for _, h in hits] + [""] * pad)
    return scores, ids


def serve_requests(client, daemon, items, oracle) -> dict:
    """Phase 3c's requests over TCP, each kind driven with the launch
    counts set to 0 just before and read just after: the tail's ingest in
    4,096-row batches, one batch's replay, 1,024 queries, topk in both
    modes, quiesce and status."""
    tail = items[WARM_BASE:]
    launches, batch_s, acks = {}, [], []
    batches = list(enumerate(range(0, tail.shape[0], SERVE_BATCH)))

    def ingest(part):
        for i, lo in part:
            t0 = time.perf_counter()
            ack = client.ingest(tail[lo:lo + SERVE_BATCH],
                                request_id=f"tail-{i:04d}",
                                timeout_s=LONG_REQUEST_S)
            batch_s.append(time.perf_counter() - t0)
            n = min(SERVE_BATCH, tail.shape[0] - lo)
            if not (ack["ok"] and ack["acked"] == n
                    and not ack.get("replayed")):
                raise AssertionError(f"ingest batch {i}: {ack}")
            acks.append(ack)

    solo = batches[:SERVE_SOLO_BATCHES]
    _, launches["ingest"], ingest_s = counted(lambda: ingest(solo))
    # The MinHash kernel once a batch with novel rows (one chunk each);
    # nothing else: a 10-bit policy, no coded chunk, no scan.
    expect_launches(launches["ingest"], {"minhash_and_keys": (
        sum(a["novel"] > 0 for a in acks), None)})
    solo_rows = sum(a["acked"] for a in acks)
    log(f"  ingest of {solo_rows} rows in {len(acks)} batches alone: "
        f"{ingest_s:.3f} s, {sum(a['novel'] for a in acks)} novel rows, "
        f"launches {launches['ingest']}")
    under = ingest_under_load(client.port, daemon, items, oracle,
                              lambda: ingest(batches[SERVE_SOLO_BATCHES:]),
                              acks)
    launches["ingest_scan"] = under.pop("launches")
    novel_batches = sum(a["novel"] > 0 for a in acks)
    novel_rows = sum(a["novel"] for a in acks)
    rows_before = (daemon.store.n_rows, daemon.status()["rows"])
    replay, launches["replay"], _ = counted(lambda: client.ingest(
        tail[:SERVE_BATCH], request_id="tail-0000",
        timeout_s=LONG_REQUEST_S))
    expect_launches(launches["replay"], {})
    if not (replay.get("replayed") and replay["acked"] == SERVE_BATCH
            and (daemon.store.n_rows, daemon.status()["rows"])
            == rows_before):
        raise AssertionError(f"replay of batch 0: {replay}")
    log("  replay of batch 0's request_id: replayed, no new row, no launch")

    rng = np.random.default_rng(4)
    idx = rng.choice(WARM_ROWS, SERVE_QUERY_REQUESTS * 32, replace=False)
    held = synth_session_sets(SERVE_QUERY_REQUESTS * 32, SET_SIZE,
                              seed=1)[0]
    vectors = np.stack([items[idx], held], axis=1).reshape(-1, SET_SIZE)

    def query():
        out = [client.query(v, timeout_s=LONG_REQUEST_S) for v in
               np.split(vectors, SERVE_QUERY_REQUESTS)]
        return (np.concatenate([r["labels"] for r in out]),
                np.concatenate([r["known"] for r in out]))

    (labels, known), launches["query"], query_s = counted(query)
    expect_launches(launches["query"], {})
    stored = np.arange(vectors.shape[0]) % 2 == 0
    if not (known[stored].all()
            and np.array_equal(labels[stored], oracle[idx])):
        raise AssertionError("query answers differ from the oracle's")
    log(f"  {vectors.shape[0]} query vectors in {SERVE_QUERY_REQUESTS} "
        f"requests: {query_s:.3f} s; stored ones known with the storeless "
        f"oracle's labels, {int(known[~stored].sum())} of the held-out "
        "known; no launch")

    queries = items[np.random.default_rng(1).choice(
        WARM_ROWS, N_QUERIES, replace=False)]
    cand, launches["candidates"], cand_s = counted(lambda: client.topk(
        queries, k=TOPK_K, mode="candidates", timeout_s=LONG_REQUEST_S))
    expect_launches(launches["candidates"], {})
    scan, launches["scan"], scan_s = counted(lambda: client.topk(
        queries, k=TOPK_K, mode="scan", timeout_s=LONG_REQUEST_S))
    chunks = sum(-(-int(e["rows"]) // SCAN_CHUNK)
                 for e in daemon.reader.shards)
    expect_launches(launches["scan"], {"topk_chunk": chunks})
    want = scan_oracle(daemon, queries)
    if not (scan["scores"].tolist() == want[0] and scan["ids"] == want[1]
            and (scan["scores"][:, 0] == N_HASHES).all()
            and (scan["labels"][scan["scores"] >= 0] >= 0).all()):
        raise AssertionError("the scan differs from score_topk_host over "
                             "the store's signatures")
    if not (cand["scores"][:, 0] == N_HASHES).all() or \
            [r[0] for r in cand["ids"]] != [r[0] for r in scan["ids"]]:
        raise AssertionError("a candidate answer misses its self-hit")
    log(f"  topk k={TOPK_K} of {N_QUERIES} vectors: candidates "
        f"{cand_s:.3f} s, no launch; scan {scan_s:.3f} s over "
        f"{daemon.reader.n_rows} rows, {chunks} chunks, launches "
        f"{launches['scan']}; scores and digest ids == score_topk_host's")
    if not client.quiesce(timeout_s=LONG_REQUEST_S)["ok"]:
        raise AssertionError("quiesce failed")
    status = client.status()
    # In process, after the status, so the verbs' histograms hold the TCP
    # requests only: the same snapshot answers the same.
    local = daemon.query(vectors)
    if not (np.array_equal(labels, local["labels"])
            and np.array_equal(known, local["known"])
            and replay["labels"] == daemon.query(
                tail[:SERVE_BATCH])["labels"].tolist()):
        raise AssertionError("TCP answers differ from the daemon's in "
                             "process")
    log("  the queries' and the replay's labels over TCP == the daemon's "
        "in process")
    return {"launches": launches, "batch_s": batch_s, "ingest_s": ingest_s,
            "solo_rows": solo_rows, "under_load": under,
            "novel_rows": novel_rows, "novel_batches": novel_batches,
            "query_s": query_s, "candidates_s": cand_s, "scan_s": scan_s,
            "chunks": chunks, "status": status}


def shard_chunks(store, n_shards: int) -> int:
    """Scan chunks over the first ``n_shards`` shards in scan order."""
    return sum(-(-int(e["rows"]) // SCAN_CHUNK) for e in sorted(
        store.shards, key=lambda e: int(e["id"]))[:n_shards])


def prefix_scan_oracles(daemon, queries: np.ndarray, n_lo: int,
                        n_hi: int) -> dict:
    """For each m in [n_lo, n_hi], the topk verb's scan answer over the
    store's first m shards in scan order, from ``score_topk_host`` a shard
    (the queries split over threads), merged by (-count, scan row) as the
    kernel ranks: {m: (scores, ids)}."""
    store = daemon.reader
    store.refresh()
    shards = sorted(store.shards, key=lambda e: int(e["id"]))[:n_hi]
    hp = make_params("kminhash", N_HASHES, 0)
    qs = scheme_host_signatures(quantize_ids(queries, daemon.qbits), hp)
    parts, base = [], 0
    with ThreadPoolExecutor(8) as ex:
        for e in shards:
            sigs = np.asarray(store._sig_mmap(int(e["id"])))
            got = list(ex.map(lambda qi: score_topk_host(
                qs[qi:qi + 1], sigs, TOPK_K), range(qs.shape[0])))
            c = np.concatenate([g[0] for g in got])
            r = np.concatenate([g[1] for g in got]).astype(np.int64)
            parts.append((c, np.where(r >= 0, r + base, -1)))
            base += int(e["rows"])
    out = {}
    for m in range(n_lo, n_hi + 1):
        scores, ids = [], []
        for qi in range(qs.shape[0]):
            hits = sorted((int(c[qi, j]), int(r[qi, j]))
                          for c, r in parts[:m] for j in range(TOPK_K)
                          if r[qi, j] >= 0)
            hits.sort(key=lambda h: (-h[0], h[1]))
            hits = hits[:TOPK_K]
            rows = np.array([r for _, r in hits], np.int64)
            loc = store_scan_locator(store, rows)
            dg = store.load_digests(loc[:, 0], loc[:, 1])
            named = sorted(zip([c for c, _ in hits],
                               ["%016x%016x" % (int(a), int(b))
                                for a, b in dg]),
                           key=lambda h: (-h[0], h[1]))
            pad = TOPK_K - len(named)
            scores.append([c for c, _ in named] + [-1] * pad)
            ids.append([h for _, h in named] + [""] * pad)
        out[m] = (scores, ids)
    return out


def ingest_under_load(port: int, daemon, items, oracle, ingest,
                      acks: list) -> dict:
    """The tail's remaining batches while two more clients, each on its
    own thread and connection, send scan-mode ``topk`` requests (kernel 5
    from a request thread while kernel 1 runs on the ingest thread) and
    ``query`` requests 10 ms apart.  Each scan must equal
    ``score_topk_host`` over the first m shards for an m between the shard
    counts the reader held when its request went out and when its answer
    came back; each query label is a hub of the row's final cluster (the
    oracle's label is at most it, and the two rows share a cluster), as
    the JAX package's concurrency test holds.  The launch counts cover
    the whole run: kernel 1 at least once a batch with novel rows, kernel
    5 once a chunk of every scan, within the bounds its shard counts
    give.  ``ingest`` appends each batch's ack to ``acks``."""
    first = len(acks)
    rng = np.random.default_rng(7)
    scan_q = items[rng.choice(WARM_BASE, SERVE_SCAN_QUERIES, replace=False)]
    stop, errors = threading.Event(), []
    scans, queries = [], []
    window = {}

    def scanner():
        with ServeClient(port=port) as c:
            while not stop.is_set():
                n0 = len(daemon.reader.shards)
                t0 = time.perf_counter()
                ans = c.topk(scan_q, k=TOPK_K, mode="scan",
                             timeout_s=LONG_REQUEST_S)
                t1 = time.perf_counter()
                scans.append((n0, len(daemon.reader.shards), t0, t1, ans))

    def querier():
        qrng = np.random.default_rng(8)
        with ServeClient(port=port) as c:
            while not stop.is_set():
                idx = qrng.choice(WARM_BASE, 64, replace=False)
                t0 = time.perf_counter()
                res = c.query(items[idx], timeout_s=LONG_REQUEST_S)
                queries.append((idx, time.perf_counter() - t0, res))
                time.sleep(0.01)

    def guarded(fn):
        def run():
            try:
                fn()
            except Exception as e:  # noqa: BLE001 - relayed below
                errors.append(e)
                stop.set()
        return run

    def drive():
        threads = [threading.Thread(target=guarded(f), daemon=True)
                   for f in (scanner, querier)]
        for th in threads:
            th.start()
        try:
            window["t0"] = time.perf_counter()
            ingest()
            window["t1"] = time.perf_counter()
        finally:
            stop.set()
            for th in threads:
                th.join(timeout=LONG_REQUEST_S)
        if errors:
            raise errors[0]

    _, counts, wall = counted(drive)
    inside = [s for s in scans
              if s[2] < window["t1"] and s[3] > window["t0"]]
    if not inside or not queries:
        raise AssertionError(f"{len(inside)} scans overlapped the ingest, "
                             f"{len(queries)} queries ran")
    oracles = prefix_scan_oracles(daemon, scan_q, min(s[0] for s in scans),
                                  max(s[1] for s in scans))
    lo = hi = 0
    for n0, n1, _, _, ans in scans:
        got = (ans["scores"].tolist(), ans["ids"])
        match = [m for m in range(n0, n1 + 1) if oracles[m] == got]
        if not match:
            raise AssertionError(f"a scan under ingest (shards {n0}-{n1}) "
                                 "differs from score_topk_host over every "
                                 "prefix it could have read")
        lo += shard_chunks(daemon.reader, min(match))
        hi += shard_chunks(daemon.reader, max(match))
    for idx, _, res in queries:
        lab = np.asarray(res["labels"], np.int64)
        if not (np.asarray(res["known"]).all()
                and (oracle[idx] <= lab).all()
                and np.array_equal(oracle[lab], oracle[idx])):
            raise AssertionError("a query under ingest answered a label "
                                 "outside the row's final cluster")
    novel = sum(a["novel"] > 0 for a in acks[first:])
    expect_launches(counts, {"minhash_and_keys": (novel, None),
                             "topk_chunk": (lo, hi)})
    rows = sum(a["acked"] for a in acks[first:])
    scan_ms = [1e3 * (s[3] - s[2]) for s in scans]
    query_ms = [1e3 * q[1] for q in queries]
    log(f"  ingest of {rows} rows in {len(acks) - first} batches "
        f"under load: {window['t1'] - window['t0']:.3f} s; {len(scans)} "
        f"scans ({len(inside)} overlapping the ingest), each == score_topk_host "
        f"over a prefix of shards it could read; {len(queries)} query "
        f"requests, every label a hub of the row's final cluster; "
        f"launches {counts}")
    return {"launches": counts, "rows": rows,
            "wall_s": window["t1"] - window["t0"], "scans": len(scans),
            "scans_overlapping": len(inside),
            "scan_p50_ms": percentile(scan_ms, 50),
            "scan_p99_ms": percentile(scan_ms, 99),
            "query_requests": len(queries),
            "query_p50_ms": percentile(query_ms, 50),
            "query_p99_ms": percentile(query_ms, 99)}


def percentile(values: list, q: float) -> float:
    """The q-th percentile of ``values`` (linear between order
    statistics, numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def serve_phase(warm: dict, dev) -> dict:
    """Phase 3c: the serving daemon over a copy of phase 3b's populated
    store (1,000,000 rows), behind a ServeServer on 127.0.0.1, driven by
    a ServeClient; then, in process, every label against the storeless
    oracle of all 1,050,000 rows and the tail's stored signatures against
    the host's."""
    t_phase = time.perf_counter()
    items, oracle = warm["items"], warm["oracle"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    daemon = ServeDaemon(SERVE_STORE, params=pipeline.ClusterParams(
        n_hashes=N_HASHES, n_bands=N_BANDS), device=dev).start()
    open_s = time.perf_counter() - t0
    if daemon.status()["rows"] != WARM_BASE or daemon.qbits != 10:
        raise AssertionError(f"daemon opened {daemon.status()['rows']} "
                             f"rows at {daemon.qbits} bits")
    log(f"  daemon open and recover: {open_s:.3f} s, {WARM_BASE} rows")
    server = ServeServer(daemon, host="127.0.0.1", port=0)
    listener = threading.Thread(target=server.serve_forever,
                                kwargs={"poll_interval": 0.05},
                                daemon=True)
    listener.start()
    try:
        with ServeClient(port=server.port) as client:
            got = serve_requests(client, daemon, items, oracle)
            client.shutdown()
        st = got["status"]
        if not (st["ok"] and st["rows"] == WARM_ROWS
                and st["uncommitted_generations"] == 0):
            raise AssertionError(f"status after quiesce: {st}")
        res = daemon.query(items)
        if not (res["known"].all() and np.array_equal(res["labels"],
                                                      oracle)):
            raise AssertionError("post-quiesce labels differ from the "
                                 "storeless oracle's")
        log(f"  after quiesce: all {WARM_ROWS} rows known, labels == the "
            "storeless oracle's, element for element")
        tail = items[WARM_BASE:]
        hit, sh, rw = daemon.store.bulk_probe(row_digests(tail))
        want = scheme_host_signatures(quantize_ids(tail, daemon.qbits),
                                      make_params("kminhash", N_HASHES, 0))
        if not (hit.all() and np.array_equal(
                daemon.store.load_signatures(sh, rw), want)):
            raise AssertionError("the tail's stored signatures differ from "
                                 "scheme_host_signatures'")
        log(f"  the tail's {tail.shape[0]} stored signatures == "
            "scheme_host_signatures of the quantized tail, bit for bit")
    finally:
        server.server_close()
        daemon.stop()
        listener.join(timeout=30)
    peak = torch.cuda.max_memory_allocated() / 2**30
    bs = got["batch_s"][:SERVE_SOLO_BATCHES]
    under = got["under_load"]
    under_bs = got["batch_s"][SERVE_SOLO_BATCHES:]
    lat = {verb: {k: snap[k] for k in ("count", "p50_ms", "p99_ms",
                                       "max_ms")}
           for verb, snap in st["latency_by_verb"].items()}
    line = {"open_s": open_s, "rows_at_open": WARM_BASE,
            "ingest": {"rows": got["solo_rows"],
                       "batches": len(bs), "batch_rows": SERVE_BATCH,
                       "wall_s": got["ingest_s"],
                       "rows_per_s": got["solo_rows"] / got["ingest_s"],
                       "s_per_batch": statistics.mean(bs),
                       "s_per_batch_max": max(bs)},
            "tail": {"rows": int(items.shape[0] - WARM_BASE),
                     "novel_rows": got["novel_rows"],
                     "novel_batches": got["novel_batches"]},
            "ingest_under_load": {
                **under, "batches": len(under_bs),
                "rows_per_s": under["rows"] / under["wall_s"],
                "s_per_batch": statistics.mean(under_bs),
                "s_per_batch_max": max(under_bs)},
            "query": {"vectors": SERVE_QUERY_REQUESTS * 64,
                      "requests": SERVE_QUERY_REQUESTS,
                      "wall_s": got["query_s"]},
            "topk": {"k": TOPK_K, "queries": N_QUERIES,
                     "candidates_wall_s": got["candidates_s"],
                     "scan_wall_s": got["scan_s"],
                     "scan_chunks": got["chunks"]},
            "latency_by_verb": lat, "launches": got["launches"],
            "peak_device_gib": peak, "store_rows": st["store_rows"],
            "store_bytes": dir_bytes(SERVE_STORE),
            "phase_s": time.perf_counter() - t_phase,
            "card": card_name_and_limit()}
    print(json.dumps({"serve": line}), flush=True)
    return line


SHARD_DIR = os.path.join(ROOT, "build", "sharded_smoke")  # gitignored
SHARD_ROOT = os.path.join(SHARD_DIR, "root")
SHARDS = 4                    # phase 3e: digest ranges, one daemon each
SHARD_KILL_AFTER = 2          # phase 3e: shard 0 dies at its third commit
SHARD_DROP_BATCH = 8          # phase 3e: the router loses shard 2's ack of
                              # this batch (the lost-ack window)
SHARD_QUERY_ROWS = 16_384     # phase 3e: rows a routed query request


def shard_params() -> pipeline.ClusterParams:
    return pipeline.ClusterParams(n_hashes=N_HASHES, n_bands=N_BANDS)


def range_dir(root: str, sid: int) -> str:
    return os.path.join(root, f"range_{sid:04d}")


def routed_query(query, items) -> tuple:
    """(labels, known) of ``items`` through ``query``, in requests of
    SHARD_QUERY_ROWS rows."""
    labels, known = [], []
    for lo in range(0, items.shape[0], SHARD_QUERY_ROWS):
        r = query(items[lo:lo + SHARD_QUERY_ROWS])
        labels.append(np.asarray(r["labels"], np.int64))
        known.append(np.asarray(r["known"], bool))
    return np.concatenate(labels), np.concatenate(known)


def add_counts(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def sharded_populate(base, dev) -> dict:
    """Phase 3e, step 1: the 1M base rows split by digest range, each range
    populated into its own store at the 10-bit kminhash policy."""
    owner = digest_range_ids(row_digests(base), SHARDS)
    fresh_dir(SHARD_DIR)
    walls, launches = [], {}
    for sid in range(SHARDS):
        rows = base[owner == sid]
        d = range_dir(SHARD_ROOT, sid)
        _, counts, wall = counted(lambda: pipeline.cluster_sessions(
            rows, store_params(d, quant_bits=10), device=dev))
        info = pipeline.last_run_info
        store = SignatureStore.open_existing(d)
        if not (info["cache_mode"] == "union"
                and info["cache_hit_rate"] == 0.0
                and store.policy["quant_bits"] == 10
                and store.policy["scheme"] == "kminhash"
                and 0 < store.n_rows <= rows.shape[0]):
            raise AssertionError(f"range {sid} populate: {info}, policy "
                                 f"{store.policy}, {store.n_rows} rows")
        expect_launches(counts, {"minhash_and_keys": (1, None)})
        add_counts(launches, counts)
        walls.append(wall)
        log(f"  range {sid}: {rows.shape[0]} rows populated in {wall:.3f} s "
            f"({store.n_rows} stored), launches {counts}")
    return {"populate_s": walls, "owner": owner, "launches": launches,
            "range_rows": [int((owner == s).sum()) for s in range(SHARDS)]}


def sharded_oracle(items, dev) -> dict:
    """Phase 3e, step 2: the uninterrupted round in process, over copies of
    the four stores: a ShardRouter over four LocalTransport(ServeDaemon)
    on the card routes the tail in 4,096-row batches (the MinHash kernel
    at least once a shard slice with novel rows, the rANS kernel at most
    once, no other kernel), then quiesce and every row queried through
    the router."""
    oroot = os.path.join(SHARD_DIR, "oracle")
    shutil.copytree(SHARD_ROOT, oroot)
    tail = items[WARM_BASE:]
    # The default state commit: no oracle check reads a state file, and
    # the per-generation durability is the failover children's, held there.
    daemons = {sid: ServeDaemon(range_dir(oroot, sid), params=shard_params(),
                                device=dev).start()
               for sid in range(SHARDS)}
    router = ShardRouter({sid: LocalTransport(d)
                          for sid, d in daemons.items()})
    launches, novel_slices = {}, 0
    try:
        t0 = time.perf_counter()
        for i, lo in enumerate(range(0, tail.shape[0], SERVE_BATCH)):
            batch = tail[lo:lo + SERVE_BATCH]
            before = [d.store.n_rows for d in daemons.values()]
            ack, counts, _ = counted(lambda: router.ingest(
                batch, timeout=LONG_REQUEST_S, request_id=f"b{i:04d}"))
            grown = sum(d.store.n_rows > b
                        for d, b in zip(daemons.values(), before))
            if not (ack["ok"] and ack["acked"] == batch.shape[0]):
                raise AssertionError(f"oracle batch {i}: {ack}")
            # A slice's novel rows pad to a power of two with copies of
            # row 0; the plain lane's entropy gate may code such a chunk,
            # which the rANS kernel then decodes.
            expect_launches(counts, {"minhash_and_keys": (grown, None),
                                     "rans_decode": (0, grown)})
            novel_slices += grown
            add_counts(launches, counts)
        ingest_s = time.perf_counter() - t0
        router.quiesce(timeout=LONG_REQUEST_S)
        t0 = time.perf_counter()
        labels, known = routed_query(router.query, items)
        query_s = time.perf_counter() - t0
        if not known.all():
            raise AssertionError("oracle round: a routed row is unknown")
        rows = sum(int(d._index.n_rows) for d in daemons.values())
        store_rows = sum(int(d.store.n_rows) for d in daemons.values())
    finally:
        router.close()
        for d in daemons.values():
            d.stop()
    if rows != items.shape[0]:
        raise AssertionError(f"oracle round: {rows} index rows")
    log(f"  oracle round in process: {tail.shape[0]} tail rows routed in "
        f"{ingest_s:.3f} s ({novel_slices} slices with novel rows, "
        f"launches {launches}); {items.shape[0]} rows queried in "
        f"{query_s:.3f} s, all known; {store_rows} store rows")
    return {"labels": labels, "rows": rows, "store_rows": store_rows,
            "ingest_s": ingest_s, "query_s": query_s,
            "launches": launches, "novel_slices": novel_slices}


def spawn_child(args: list, log_name: str, plan: str | None = None):
    env = dict(os.environ)
    env.pop("TSE1M_FAULT_PLAN", None)
    if plan:
        env["TSE1M_FAULT_PLAN"] = plan
    with open(os.path.join(SHARD_DIR, log_name), "w") as f:
        return subprocess.Popen([sys.executable, "-m", "tse1m_tpu_torch",
                                 *args], env=env, cwd=ROOT, stdout=f,
                                stderr=subprocess.STDOUT)


def wait_port(proc, port_file: str, what: str) -> int:
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    while time.monotonic() < deadline:
        if os.path.exists(port_file):
            with open(port_file, encoding="utf-8") as f:
                txt = f.read().strip()
            if txt:
                return int(txt)
        if proc.poll() is not None:
            raise AssertionError(f"{what} exited (rc {proc.returncode}) "
                                 "before it bound its port")
        time.sleep(0.05)
    raise AssertionError(f"{what} wrote no port file in "
                         f"{CHILD_TIMEOUT_S} s")


def start_shard(sid: int, plan: str | None = None):
    """``serve --root R --range sid`` in a child process on the card."""
    port_file = os.path.join(SHARD_ROOT, f"serve_{sid:04d}.port")
    if os.path.exists(port_file):  # never race a stale port
        os.remove(port_file)
    return spawn_child(["serve", "--root", SHARD_ROOT, "--range", str(sid)],
                       f"shard_{sid}_{time.monotonic_ns()}.log", plan)


def shard_port(proc, sid: int) -> int:
    return wait_port(proc, os.path.join(SHARD_ROOT, f"serve_{sid:04d}.port"),
                     f"shard {sid}")


def stop_child(proc) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def host_topk(store, qbits: int, queries: np.ndarray) -> tuple:
    """score_topk_host over every row of ``store`` in scan order, answered
    as the topk verb answers: digest ids, hits sorted by (-count, digest
    hex), ("", -1) padding.  The queries are signed on the host and split
    over threads (numpy releases the GIL), 8 to a call."""
    loc = store_scan_locator(store, np.arange(store.n_rows))
    sigs = store.load_signatures(loc[:, 0], loc[:, 1])
    hp = make_params("kminhash", N_HASHES, 0)
    qs = scheme_host_signatures(quantize_ids(queries, qbits), hp)
    with ThreadPoolExecutor(8) as ex:
        parts = list(ex.map(lambda lo: score_topk_host(
            qs[lo:lo + 8], sigs, TOPK_K), range(0, qs.shape[0], 8)))
    scores, ids = [], []
    for counts, rows in zip(np.concatenate([p[0] for p in parts]),
                            np.concatenate([p[1] for p in parts])):
        ok = rows >= 0
        dg = store.load_digests(loc[rows[ok], 0], loc[rows[ok], 1])
        hits = sorted(zip(counts[ok].tolist(),
                          ["%016x%016x" % (int(a), int(b)) for a, b in dg]),
                      key=lambda h: (-h[0], h[1]))
        pad = TOPK_K - len(hits)
        scores.append([c for c, _ in hits] + [-1] * pad)
        ids.append([h for _, h in hits] + [""] * pad)
    return scores, ids


def merged_topk(per_store: list) -> tuple:
    """Each store's host top-k merged as the router merges them: every
    hit of every store by (-count, digest hex), the first k kept."""
    scores, ids = [], []
    for q in range(len(per_store[0][0])):
        hits = sorted(((c, h) for s, i in per_store
                       for c, h in zip(s[q], i[q]) if c >= 0),
                      key=lambda t: (-t[0], t[1]))[:TOPK_K]
        pad = TOPK_K - len(hits)
        scores.append([c for c, _ in hits] + [-1] * pad)
        ids.append([h for _, h in hits] + [""] * pad)
    return scores, ids


def run_backfill(args: list) -> dict:
    """``python -m tse1m_tpu_torch backfill`` in this process; its summary
    line."""
    from tse1m_tpu_torch.__main__ import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["backfill", *args])
    if rc != 0:
        raise AssertionError(f"backfill {args}: exit {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def sharded_failover(items, owner_all, oracle: dict, replica, dev) -> dict:
    """Phase 3e, steps 3-5, over the populated stores: four shard children
    and a router child on the card, shard 0 SIGKILLed at its third commit
    and respawned at the next lease epoch, the router losing one shard
    ack; then, with the children still up, the replica's pull and checks
    and both backfills; last, a daemon on the old epoch's lease."""
    tail = items[WARM_BASE:]
    kill_plan = os.path.join(SHARD_DIR, "kill_plan.json")
    FaultPlan.from_dict({"rules": [{
        "site": "serve.ingest.commit", "kind": "kill",
        "after_calls": SHARD_KILL_AFTER, "times": 1}]}).save(kill_plan)
    # The router's forward seat counts answered forwards: four a batch.
    drop_plan = os.path.join(SHARD_DIR, "drop_plan.json")
    FaultPlan.from_dict({"rules": [{
        "site": "serve.router.forward", "kind": "connection_drop",
        "after_calls": SHARDS * SHARD_DROP_BATCH + 2, "times": 1}]}
    ).save(drop_plan)
    # The children start at once and bind in parallel.
    procs = [start_shard(0, kill_plan)] + [start_shard(sid)
                                           for sid in range(1, SHARDS)]
    victim, out, respawned = procs[0], {}, {}
    router_port_file = os.path.join(SHARD_DIR, "router.port")
    router = spawn_child(["serve-router", "--root", SHARD_ROOT, "--shards",
                          str(SHARDS), "--port-file", router_port_file],
                         "router.log", drop_plan)
    procs.append(router)

    def watch_and_respawn():
        try:
            victim.wait(timeout=CHILD_TIMEOUT_S)
            respawned["killed_at"] = time.perf_counter()
            respawned["proc"] = start_shard(0)
            shard_port(respawned["proc"], 0)
            respawned["bound_at"] = time.perf_counter()
        except Exception as e:  # noqa: BLE001 - raised by the main thread
            respawned["error"] = e

    watcher = threading.Thread(target=watch_and_respawn, daemon=True)
    try:
        t0 = time.perf_counter()
        for sid in range(SHARDS):
            shard_port(procs[sid], sid)
        # The lease shard 0 holds before the kill: the zombie's, at the end.
        old_lease = read_lease(SHARD_ROOT, 0)
        if not (old_lease and old_lease["epoch"] == 1
                and old_lease["owner"] == victim.pid):
            raise AssertionError(f"shard 0's lease before the kill: "
                                 f"{old_lease}")
        client = ServeClient(port=wait_port(router, router_port_file,
                                            "serve-router"))
        start_s = time.perf_counter() - t0
        watcher.start()
        acks, acked_at = [], []
        t0 = time.perf_counter()
        for i, lo in enumerate(range(0, tail.shape[0], SERVE_BATCH)):
            ack = client.ingest(tail[lo:lo + SERVE_BATCH],
                                timeout_s=LONG_REQUEST_S,
                                request_id=f"b{i:04d}")
            acked_at.append(time.perf_counter())
            if not (ack["ok"] and ack["acked"] == len(tail[lo:lo
                                                           + SERVE_BATCH])):
                raise AssertionError(f"routed batch {i}: {ack}")
            acks.append(ack)
        ingest_s = time.perf_counter() - t0
        watcher.join(timeout=CHILD_TIMEOUT_S)
        if watcher.is_alive() or "error" in respawned:
            raise AssertionError(f"shard 0 was not respawned: {respawned}")
        procs.append(respawned["proc"])
        if victim.returncode != -9:
            raise AssertionError(f"shard 0 exited {victim.returncode}, not "
                                 "by SIGKILL at its third commit")
        epochs = [read_lease(SHARD_ROOT, s)["epoch"] for s in range(SHARDS)]
        if epochs != [2] + [1] * (SHARDS - 1):
            raise AssertionError(f"lease epochs {epochs}")
        # Kill to the replacement's first ack: the killed batch's ack.
        failover_s = acked_at[SHARD_KILL_AFTER] - respawned["killed_at"]
        respawn_s = respawned["bound_at"] - respawned["killed_at"]
        log(f"  failover round: shard 0 SIGKILLed at its third commit, "
            f"respawned at epoch 2 in {respawn_s:.3f} s; "
            f"kill to the replacement's first ack {failover_s:.3f} s; "
            f"{tail.shape[0]} rows routed in {ingest_s:.3f} s")
        replayed = [i for i, a in enumerate(acks) if a.get("replayed")]
        if replayed != [SHARD_DROP_BATCH]:
            raise AssertionError(f"replayed acks at batches {replayed}, "
                                 f"expected [{SHARD_DROP_BATCH}]")
        client.quiesce(timeout_s=LONG_REQUEST_S)
        t0 = time.perf_counter()
        labels, known = routed_query(
            lambda v: client.query(v, timeout_s=LONG_REQUEST_S), items)
        query_s = time.perf_counter() - t0
        lost = int((~known).sum())
        if lost:
            raise AssertionError(f"{lost} acked rows lost to the failover")
        if not np.array_equal(labels, oracle["labels"]):
            raise AssertionError(
                f"router labels differ from the uninterrupted round's in "
                f"{int((labels != oracle['labels']).sum())} rows")
        status = client.status()
        rows = sum(int(s["rows"]) for s in status["shard_status"].values())
        store_rows = sum(int(s["store_rows"])
                         for s in status["shard_status"].values())
        if not (status["ok"] and status["router_replayed_acks"] >= 1
                and rows == oracle["rows"]
                and store_rows == oracle["store_rows"]):
            raise AssertionError(f"router status {status['ok']}, replayed "
                                 f"{status['router_replayed_acks']}, rows "
                                 f"{rows}/{oracle['rows']}, store rows "
                                 f"{store_rows}/{oracle['store_rows']}")
        log(f"  after quiesce: 0 acked rows lost, {items.shape[0]} labels "
            f"== the uninterrupted round's (queried in {query_s:.3f} s), "
            f"{rows} index and {store_rows} store rows as the oracle's (no "
            f"row absorbed twice), {status['router_replayed_acks']} "
            f"replayed ack (batch {SHARD_DROP_BATCH})")
        out.update(start_s=start_s, ingest_s=ingest_s, failover_s=failover_s,
                   respawn_s=respawn_s,
                   query_s=query_s, replayed_acks=status[
                       "router_replayed_acks"], rows=rows,
                   store_rows=store_rows)
        out["replica"] = sharded_replica(items, owner_all, replica, dev)
        out["backfill"] = sharded_backfill(items, router_port_file, dev)
        client.shutdown()
        client.close()
        for sid in range(SHARDS):
            with open(os.path.join(SHARD_ROOT, f"serve_{sid:04d}.port")) as f:
                with ServeClient(port=int(f.read().strip())) as c:
                    c.shutdown()
        for proc in procs:
            if proc.wait(timeout=CHILD_TIMEOUT_S) != 0 and proc is not victim:
                raise AssertionError(f"a child exited {proc.returncode}")
    finally:
        for proc in procs + [respawned.get("proc")]:
            if proc is not None:
                stop_child(proc)
        if watcher.is_alive():
            watcher.join(timeout=5)
    out["zombie"] = zombie_check(old_lease, dev)
    return out


def sharded_replica(items, owner_all, replica, dev) -> dict:
    """Phase 3e, step 4: the replica of range 1, opened after the populate
    and stale by every generation the writer has committed since, pulled
    once from the live writer and refreshed; its labels those of shard 1
    (asked directly), its scan on the card (the top-k kernel) equal to
    score_topk_host over the range's store, its ingest refused."""
    src = range_dir(SHARD_ROOT, 1)
    with open(os.path.join(src, "store_manifest.json")) as f:
        writer_gen = int(json.load(f)["generation"])
    behind = writer_gen - int(replica.store.generation)
    before = replica_staleness(src, replica)
    if not (before == behind > 0):
        raise AssertionError(f"replica staleness {before}, {behind} "
                             "generations unpulled")
    t0 = time.perf_counter()
    pulled = stream_shards(src, replica.store.directory)
    pull_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not replica.refresh():
        raise AssertionError("the refresh adopted nothing")
    refresh_s = time.perf_counter() - t0
    after = replica_staleness(src, replica)
    if after != 0:
        raise AssertionError(f"staleness {after} after a pull and refresh")
    rows1 = items[owner_all == 1]
    with open(os.path.join(SHARD_ROOT, "serve_0001.port")) as f:
        with ServeClient(port=int(f.read().strip())) as c:
            want, known = routed_query(
                lambda v: c.query(v, timeout_s=LONG_REQUEST_S), rows1)
    got, got_known = routed_query(replica.query, rows1)
    if not (known.all() and got_known.all() and np.array_equal(got, want)):
        raise AssertionError("the replica's labels differ from shard 1's")
    queries = rows1[np.random.default_rng(5).choice(rows1.shape[0],
                                                    N_QUERIES, replace=False)]
    res, counts, scan_s = counted(lambda: replica.topk(queries, k=TOPK_K,
                                                       mode="scan"))
    chunks = shard_chunks(replica.store, len(replica.store.shards))
    expect_launches(counts, {"topk_chunk": chunks})
    scores, ids = host_topk(replica.store, replica.qbits, queries)
    if not (res["scores"] == scores and res["ids"] == ids):
        raise AssertionError("the replica's scan differs from "
                             "score_topk_host over range 1's store")
    try:
        replica.ingest(rows1[:4])
    except RuntimeError as e:
        if "read replica" not in str(e):
            raise
    else:
        raise AssertionError("the replica took an ingest")
    log(f"  replica of range 1: {before} generations stale, pulled "
        f"{pulled['bytes_copied']} B ({pulled['shards_copied']} shards) in "
        f"{pull_s:.3f} s, refreshed in {refresh_s:.3f} s, stale 0; "
        f"{rows1.shape[0]} labels == shard 1's; scan of {N_QUERIES} "
        f"queries on the card == score_topk_host ({chunks} top-k launches, "
        f"{scan_s:.3f} s); ingest refused")
    return {"staleness_before": before, "staleness_after": after,
            "pull_s": pull_s, "pull_bytes": pulled["bytes_copied"],
            "pull_shards": pulled["shards_copied"], "refresh_s": refresh_s,
            "rows": int(replica.store.n_rows), "scan_s": scan_s,
            "launches": counts}


def sharded_backfill(items, router_port_file: str, dev) -> dict:
    """Phase 3e, step 5: ``backfill --sig-store R/range_0002`` in process
    (the top-k kernel, counted) equal to score_topk_host over that store;
    ``backfill --port-file <router>`` equal to each store's host top-k
    merged by (-count, digest), the union's top-k."""
    queries = items[np.random.default_rng(6).choice(items.shape[0],
                                                    N_QUERIES, replace=False)]
    npy = os.path.join(SHARD_DIR, "backfill_q.npy")
    np.save(npy, queries)
    d2 = range_dir(SHARD_ROOT, 2)
    local, counts, _ = counted(lambda: run_backfill([
        "--sig-store", d2, "--npy", npy, "--k", str(TOPK_K), "--batch",
        str(N_QUERIES), "--device", str(dev)]))
    store2 = SignatureStore.open_existing(d2)
    expect_launches(counts, {"topk_chunk": shard_chunks(
        store2, len(store2.shards))})
    per_store = [host_topk(SignatureStore.open_existing(
        range_dir(SHARD_ROOT, s)), 10, queries) for s in range(SHARDS)]
    if (local["results"]["scores"], local["results"]["ids"]) != \
            per_store[2]:
        raise AssertionError("backfill --sig-store differs from "
                             "score_topk_host over range 2's store")
    routed = run_backfill(["--port-file", router_port_file, "--npy", npy,
                           "--k", str(TOPK_K), "--batch", str(N_QUERIES),
                           "--timeout", str(LONG_REQUEST_S)])
    if (routed["results"]["scores"], routed["results"]["ids"]) != \
            merged_topk(per_store):
        raise AssertionError("backfill through the router differs from the "
                             "host top-k over the union of the stores")
    log(f"  backfill --sig-store range 2: {local['pairs_scored_s']:.1f} "
        f"pairs/s ({local['store_rows']} rows, launches {counts}) == "
        f"score_topk_host; through the router: "
        f"{routed['pairs_scored_s']:.1f} pairs/s ({routed['store_rows']} "
        "rows) == the union's host top-k")
    return {"sig_store": {k: local[k] for k in (
                "queries", "store_rows", "pairs_scored", "wall_s",
                "pairs_scored_s")}, "launches": counts,
            "router": {k: routed[k] for k in (
                "queries", "store_rows", "pairs_scored", "wall_s",
                "pairs_scored_s")}}


def zombie_check(old_lease: dict, dev) -> dict:
    """Phase 3e, last: a daemon started on range 0's old lease, the killed
    writer's exact epoch-1 record read before the kill, is fenced at its
    first batch: zero rows appended.  Only the respawn's epoch-2 claim
    changed the lease file since, so that claim is what fences it; a guard
    built from the current record verifies."""
    cur = read_lease(SHARD_ROOT, 0)
    if not (cur and cur["epoch"] == old_lease["epoch"] + 1):
        raise AssertionError(f"range 0's lease {cur} does not follow "
                             f"{old_lease}")
    RangeLeaseGuard(SHARD_ROOT, 0, epoch=cur["epoch"], owner=cur["owner"],
                    nonce=cur["nonce"]).verify()
    d0 = range_dir(SHARD_ROOT, 0)
    rows_before = SignatureStore.open_existing(d0).n_rows
    fresh = synth_session_sets(512, SET_SIZE, seed=99)[0]
    zombie = ServeDaemon(d0, params=shard_params(), state_commit_every=1,
                         device=dev, lease_guard=RangeLeaseGuard(
                             SHARD_ROOT, 0, epoch=old_lease["epoch"],
                             owner=old_lease["owner"],
                             nonce=old_lease["nonce"])).start()
    try:
        zombie.ingest(fresh, timeout=LONG_REQUEST_S)
    except LeaseSupersededError:
        pass
    else:
        raise AssertionError("a daemon on the old epoch's lease ingested")
    finally:
        zombie.stop(commit=False)
    rows_after = SignatureStore.open_existing(d0).n_rows
    if rows_after != rows_before or zombie._ingest_error is None:
        raise AssertionError(f"the fenced daemon appended "
                             f"{rows_after - rows_before} rows")
    log("  a daemon on range 0's old epoch: fenced at its first batch, 0 "
        "rows appended")
    return {"rows_appended": rows_after - rows_before}


def sharded_phase(warm: dict, dev) -> dict:
    """Phase 3e: the sharded serving plane at full width on one card."""
    t_phase = time.perf_counter()
    items = warm["items"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pop = sharded_populate(items[:WARM_BASE], dev)
    owner_all = digest_range_ids(row_digests(items), SHARDS)
    replica_dir = os.path.join(SHARD_DIR, "replica_0001")
    stream_shards(range_dir(SHARD_ROOT, 1), replica_dir)
    replica = ServeReplica(replica_dir, params=shard_params(), device=dev)
    oracle = sharded_oracle(items, dev)
    got = sharded_failover(items, owner_all, oracle, replica, dev)
    launches = {}
    for counts in (pop["launches"], oracle["launches"],
                   got["replica"]["launches"], got["backfill"]["launches"]):
        add_counts(launches, counts)
    tail_rows = int(items.shape[0] - WARM_BASE)
    line = {"shards": SHARDS, "rows": int(items.shape[0]),
            "range_rows": pop["range_rows"], "populate_s": pop["populate_s"],
            "batch_rows": SERVE_BATCH,
            "oracle": {"ingest_s": oracle["ingest_s"],
                       "rows_per_s": tail_rows / oracle["ingest_s"],
                       "query_s": oracle["query_s"],
                       "novel_slices": oracle["novel_slices"]},
            "failover_round": {"children_start_s": got["start_s"],
                               "ingest_s": got["ingest_s"],
                               "rows_per_s": tail_rows / got["ingest_s"],
                               "query_s": got["query_s"],
                               "failover_s": got["failover_s"],
                               "respawn_s": got["respawn_s"],
                               "replayed_acks": got["replayed_acks"],
                               "lost_acked": 0,
                               "rows": got["rows"],
                               "store_rows": got["store_rows"]},
            "replica": {k: v for k, v in got["replica"].items()
                        if k != "launches"},
            "backfill": {k: v for k, v in got["backfill"].items()
                         if k != "launches"},
            "zombie_rows_appended": got["zombie"]["rows_appended"],
            "launches": launches,
            "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
            "phase_s": time.perf_counter() - t_phase,
            "card": card_name_and_limit()}
    print(json.dumps({"serve_sharded": line}), flush=True)
    return line


RESIL_DIR = os.path.join(ROOT, "build", "resil_smoke")  # gitignored
RESIL_CAL = os.path.join(RESIL_DIR, "cal.json")
CHILD_TIMEOUT_S = 300


@contextlib.contextmanager
def environment(**values):
    """os.environ with ``values`` set (None: removed), restored after."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def resil_run(label: str, fn, dev) -> dict:
    """One phase 3d run: the launch counts and the degradation events set
    to 0 just before ``fn()`` and read just after, its wall, stages and
    peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pop_degradation_events()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    labels = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    events = pop_degradation_events()
    info = dict(pipeline.last_run_info)
    run = {"wall_s": wall, "launches": counts,
           "events": [(e["kind"], e["site"], e["detail"]) for e in events],
           "event_counts": degradation_counts(events),
           "chunk_halvings": info.get("chunk_halvings"),
           "chunk_bits": info.get("chunk_bits"),
           "stages": info.get("stages"),
           "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"  {label}: wall {wall:.3f} s, launches {counts}, events "
        f"{run['event_counts']}, peak device memory "
        f"{run['peak_device_gib']:.2f} GiB")
    return {"labels": labels, "run": run}


def expect_labels(got, want, label: str) -> None:
    if not np.array_equal(got, want):
        raise AssertionError(f"{label}: labels differ")
    log(f"  {label}: labels == the undisturbed run's, element for element")


def killed_child(ck: str) -> dict:
    """(r1), first half: ``cluster --checkpoint-dir`` at 1M in a child
    process, SIGKILLed by the fault plane at its second shard save (cell
    (c)'s plan: the full lane, then the delta lane)."""
    plan = os.path.join(RESIL_DIR, "kill_plan.json")
    FaultPlan.from_dict({"rules": [{
        "site": "checkpoint.cluster.save", "kind": "kill",
        "after_calls": 1, "times": 1}]}).save(plan)
    env = dict(os.environ, TSE1M_FAULT_PLAN=plan,
               TSE1M_RESULT_DIR=os.path.join(RESIL_DIR, "results"))
    cmd = [sys.executable, "-m", "tse1m_tpu_torch", "cluster", "--n",
           str(N_SESSIONS), "--seed", "0", "--checkpoint-dir", ck,
           "--ari-sample", "0"]
    t0 = time.perf_counter()
    child = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                           text=True, timeout=CHILD_TIMEOUT_S)
    wall = time.perf_counter() - t0
    with open(os.path.join(RESIL_DIR, "child.log"), "w") as f:
        f.write(child.stdout + child.stderr)
    meta = ClusterCheckpoint.peek_meta(ck) or {}
    orphan = os.path.join(ck, "shard_00001.npz.tmp.npz")
    log(f"  (r1) child: return code {child.returncode} after {wall:.3f} s; "
        f"manifest chunks_done {meta.get('chunks_done')} of "
        f"{meta.get('n_chunks')}, orphan {os.path.exists(orphan)}")
    if not (child.returncode == -9 and meta.get("chunks_done") == [0]
            and meta.get("n_chunks") == 2 and meta.get("encoding") == "delta"
            and os.path.exists(orphan)):
        raise AssertionError(f"the child was not killed at its delta shard "
                             f"save: rc {child.returncode}, {meta}; "
                             f"{child.stderr[-2000:]}")
    return {"wall_s": wall, "returncode": child.returncode,
            "shard_bytes": dir_bytes(ck)}


def chunk_need_bytes(rows: np.ndarray, params, hp, dev) -> int:
    """Device memory (reserved by the allocator) one chunk's compute takes
    above what is reserved before it: a plain-wire chunk of ``rows``
    (already quantized), staged and hashed as the stream does."""
    wire = pack_chunk(rows)
    arrays_d = pipeline._put(wire.wire_arrays(), dev,
                             torch.cuda.current_stream(dev))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = pipeline._chunk_minhash(arrays_d, wire, hp, params,
                                  StageRecorder(), dev, False)
    torch.cuda.synchronize()
    need = torch.cuda.max_memory_reserved(dev) - base
    del out, arrays_d
    torch.cuda.empty_cache()
    return need


class MemoryCap:
    """Wraps ``pipeline._chunk_minhash``: from the first whole chunk's call
    until the next whole chunk's, each call runs with the allocator capped
    at the memory reserved when it starts plus ``budget`` bytes
    (``torch.cuda.set_per_process_memory_fraction``, after
    ``empty_cache``), so the whole chunk meets torch's own out-of-memory
    and the halved sub-chunks the ladder sends run under the same cap."""

    def __init__(self, real, budget: int, whole_rows: int, dev):
        self.real, self.budget, self.whole = real, budget, whole_rows
        self.dev = dev
        self.total = torch.cuda.get_device_properties(dev).total_memory
        self.state = "armed"
        self.capped_calls, self.ooms = [], 0

    def __call__(self, arrays_d, wire, *args, **kwargs):
        rows = int(wire.shape[0])
        if self.state == "armed" and rows == self.whole:
            self.state = "capped"
        elif self.state == "capped" and rows >= self.whole \
                and self.capped_calls:
            self.state = "done"
        if self.state != "capped":
            return self.real(arrays_d, wire, *args, **kwargs)
        self.capped_calls.append(rows)
        torch.cuda.empty_cache()
        frac = min(1.0, (torch.cuda.memory_reserved(self.dev) + self.budget)
                   / self.total)
        torch.cuda.set_per_process_memory_fraction(frac, self.dev)
        try:
            return self.real(arrays_d, wire, *args, **kwargs)
        except torch.cuda.OutOfMemoryError:
            self.ooms += 1
            raise
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0, self.dev)


def resilience_phase(items, labels: dict, default_run: dict, dev) -> dict:
    """Phase 3d: the long run's supervision at 1M x 64 sessions, under the
    gitignored build/resil_smoke/ and its own machine calibration
    (TSE1M_ROUTER_CAL points at build/resil_smoke/cal.json for this phase
    only, and the file is removed after it)."""
    t_phase = time.perf_counter()
    fresh_dir(RESIL_DIR)
    os.makedirs(RESIL_DIR)
    runs: dict = {}
    line: dict = {}
    with environment(TSE1M_ROUTER_CAL=RESIL_CAL, TSE1M_FAULT_PLAN=None):
        # (r1) a real kill of a child, then the resume in this process.
        ck = os.path.join(RESIL_DIR, "ck")
        line["child"] = killed_child(ck)
        c_counts = default_run["counts"]
        want = {"minhash_and_keys": c_counts["minhash_and_keys"]
                - len(default_run["info"]["chunk_bits"]),
                "rans_decode": c_counts["rans_decode"]}
        r = resil_run("(r1) resume",
                      lambda: pipeline.cluster_sessions_resumable(
                          items, pipeline.ClusterParams(n_hashes=N_HASHES,
                                                        n_bands=N_BANDS),
                          checkpoint_dir=ck, device=dev), dev)
        runs["r1_resume"] = r["run"]
        expect_labels(r["labels"], labels["c"], "(r1) resume vs (c)")
        expect_launches(r["run"]["launches"], want)
        if os.listdir(ck):
            raise AssertionError(f"(r1): left {os.listdir(ck)} behind")
        log(f"  (r1): launches {want} as predicted from (c)'s; the "
            "checkpoint directory is empty")

        # (r2) a real torch out-of-memory on the resumable plain wire.
        params = params_for(0)
        hp = make_params("kminhash", N_HASHES, 0).to(dev)
        q = quantize_ids(items[:CHUNK_ROWS], 10)
        half = pipeline._halved_step(CHUNK_ROWS, params)
        whole_need = chunk_need_bytes(q, params, hp, dev)
        half_need = chunk_need_bytes(q[:half], params, hp, dev)
        if not half_need < whole_need:
            raise AssertionError(f"(r2): a half chunk needs {half_need} B, "
                                 f"a whole one {whole_need} B")
        budget = (half_need + whole_need) // 2
        log(f"  (r2): a whole chunk's compute reserves {whole_need} B, a "
            f"half ({half} rows) {half_need} B; cap budget {budget} B")
        ck2 = os.path.join(RESIL_DIR, "ck_oom")
        cap = MemoryCap(pipeline._chunk_minhash, budget, CHUNK_ROWS, dev)
        pipeline._chunk_minhash = cap
        try:
            r = resil_run("(r2) resumable under the cap",
                          lambda: pipeline.cluster_sessions_resumable(
                              items, params, checkpoint_dir=ck2,
                              cleanup=False, device=dev), dev)
        finally:
            pipeline._chunk_minhash = cap.real
        run2 = runs["r2_oom"] = r["run"]
        run2.update(capped_calls=cap.capped_calls, ooms_in_compute=cap.ooms,
                    whole_need_bytes=whole_need, half_need_bytes=half_need,
                    budget_bytes=budget)
        meta = ClusterCheckpoint.peek_meta(ck2) or {}
        halvings = [e for e in run2["events"] if e[0] == "chunk_halving"]
        with open(RESIL_CAL) as f:
            cal_bytes = json.load(f)["wire"]["chunk_bytes"]["value"]
        surviving = halvings[-1][2]["to_rows"] if halvings else None
        log(f"  (r2): capped calls {cap.capped_calls}, out-of-memory in "
            f"compute {cap.ooms}, halvings {run2['chunk_halvings']}, "
            f"manifest step {meta.get('step')} chunks "
            f"{meta.get('chunks_done')}, calibrated chunk {cal_bytes} B")
        if not (run2["chunk_halvings"] >= 1 and halvings
                and meta.get("step") == CHUNK_ROWS
                and meta.get("chunks_done") == [0, 1, 2, 3]
                and cal_bytes == surviving * SET_SIZE * 4):
            raise AssertionError(f"(r2): {run2}, {meta}, {cal_bytes}")
        expect_labels(r["labels"], labels["a"], "(r2) vs (a)")
        expect_launches(run2["launches"], {"minhash_and_keys": (4, None)})
        line["shard_bytes_r2"] = dir_bytes(ck2)
        fresh_dir(ck2)

        # (r3) the next run starts below the ceiling.
        cal_step = pipeline._stream_plan(quantize_ids(items, 10), params)
        r = resil_run(f"(r3) storeless at the calibrated step {cal_step}",
                      lambda: pipeline.cluster_sessions(items, params,
                                                        device=dev), dev)
        runs["r3_calibrated"] = r["run"]
        expect_labels(r["labels"], labels["a"], "(r3) vs (a)")
        n_chunks = -(-N_SESSIONS // cal_step)
        if not n_chunks > 4:
            raise AssertionError(f"(r3): {n_chunks} chunks at {cal_step}")
        expect_launches(r["run"]["launches"], {"minhash_and_keys": n_chunks})
        line["calibrated_step"] = cal_step
        os.remove(RESIL_CAL)

        # (r4) stalls and device retries on the 24-bit wire.
        stall_plan = FaultPlan.from_dict({"rules": [
            {"site": "pipeline.h2d", "kind": "stall", "stall_s": 3.0,
             "times": 1},
            {"site": "pipeline.compute", "kind": "stall", "stall_s": 4.0,
             "times": 2}]})
        with environment(TSE1M_WATCHDOG_MIN_BUDGET_S="1",
                         TSE1M_WATCHDOG_COMPUTE_BUDGET_S="2"), \
                stall_plan.active():
            r = resil_run("(r4) stalls on the 24-bit wire",
                          lambda: pipeline.cluster_sessions(
                              items, params_for(-1), device=dev), dev)
        run4 = runs["r4_stalls"] = r["run"]
        counts4 = run4["event_counts"]
        if counts4 != {"stall_retry": 1, "device_retry": 2}:
            raise AssertionError(f"(r4): events {counts4}")
        expect_labels(r["labels"], labels["b"], "(r4) vs (b)")
        expect_launches(run4["launches"], {"minhash_and_keys_packed": 4 + 2})
    line.update(runs=runs, peak_device_gib=max(
        run["peak_device_gib"] for run in runs.values()),
        phase_s=time.perf_counter() - t_phase, card=card_name_and_limit())
    print(json.dumps({"resilience": line}, default=str), flush=True)
    total: dict = {}
    for run in runs.values():
        for name, n in run["launches"].items():
            total[name] = total.get(name, 0) + n
    return {"line": line, "launches": total}


TOOL_DIR = os.path.join(ROOT, "build", "tool_smoke")  # gitignored
# (w1)'s store as run 1 left it, copied in phase 3b for (w2)'s traced rerun.
TOOL_STORE = os.path.join(TOOL_DIR, "store")
# The JAX package's lock names (tse1m_tpu/trace/sync.py's callers): the
# sites lock_wait_seconds may report, the per-metric ones by prefix.
LOCK_SITES = frozenset({
    "SpanRing", "StageRecorder", "observability._degradation_lock",
    "MetricsRegistry", "Sampler", "SlowRequestLog", "ShardRouter",
    "AdmissionController", "SloTracker"})
LOCK_SITE_PREFIXES = ("Counter.", "Gauge.", "LatencyRecorder.")
# dump_profile's keys in the JAX package (tse1m_tpu/observability/
# profiling.py:dump_profile), "extra" with the step.
PROFILE_KEYS = ("pid", "uptime_s", "trace_id", "profiling_enabled",
                "sampler", "collapsed_stacks", "lock_wait_sites",
                "slow_requests", "slow_requests_total", "extra")
WIRE_KEYS = ("encoding", "prefilter_rows_dropped", "wire_quant_bits",
             "chunk_bits", "wire_mb", "wire_v3_saved_mb")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# The pipeline's torch.profiler regions (cluster/pipeline.py) -> the split
# of device time: wire decode, MinHash, the LSH tail and the fetch back.
REGION_BUCKETS = {"tse1m.decode": "decode", "tse1m.minhash": "minhash",
                  "tse1m.lsh": "lsh_fetch", "tse1m.fetch": "lsh_fetch"}


def short_name(name: str) -> str:
    """A kernel's name without its template arguments, parameters and
    namespaces; copies and fills keep theirs."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    head = name.replace("(anonymous namespace)::", "")
    head = head.removeprefix("void ").split("(")[0].split("<")[0]
    return head.rsplit("::", 1)[-1]


def union_us(intervals: list) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def trace_summary(path: str) -> dict:
    """Phase 3f: the device side of a Chrome trace from
    ``profiling.device_trace``.  The window is the trace's span; busy is
    the union of kernel, copy and fill intervals; each device event goes
    to the pipeline region around the host call that launched it (joined
    by correlation id), else to ``other``, and is listed as ``op/kernel``
    (the torch op that launched it, by external id, and the kernel's short
    name; a kernel of the port's extension has no torch op); H2D and D2H
    copies counted with their bytes."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    launches = {e["args"]["correlation"]: (e["pid"], e["tid"], e["ts"])
                for e in events if e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})}
    ops = {e["args"]["External id"]: e["name"] for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    regions: dict = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] in REGION_BUCKETS:
            regions.setdefault((e["pid"], e["tid"]), []).append(
                (e["ts"], e["ts"] + e["dur"], REGION_BUCKETS[e["name"]]))
    split = {b: 0.0 for b in ("decode", "minhash", "lsh_fetch", "other")}
    names = {b: {} for b in split}
    copies = {"h2d": [0, 0], "d2h": [0, 0]}
    for e in device:
        bucket = "other"
        where = launches.get(e["args"].get("correlation"))
        if where is not None:
            inner = [r for r in regions.get(where[:2], ())
                     if r[0] <= where[2] <= r[1]]
            if inner:
                bucket = min(inner, key=lambda r: r[1] - r[0])[2]
        split[bucket] += e["dur"]
        op = ops.get(e["args"].get("External id"))
        n = f"{op}/{short_name(e['name'])}" if op else short_name(e["name"])
        names[bucket][n] = names[bucket].get(n, 0) + 1
        for way, tag in (("h2d", "HtoD"), ("d2h", "DtoH")):
            if e["name"].startswith(f"Memcpy {tag}"):
                copies[way][0] += 1
                copies[way][1] += int(e["args"].get("bytes", 0))
    window_us = t1 - t0
    busy_us = union_us([(e["ts"], e["ts"] + e["dur"]) for e in device])
    kernel_names = [e["name"] for e in device if e.get("cat") == "kernel"]
    return {
        "window_s": window_us * 1e-6, "device_busy_s": busy_us * 1e-6,
        "busy_share": busy_us / window_us,
        "device_s": {b: t * 1e-6 for b, t in split.items()},
        "ops": {b: dict(sorted(v.items(), key=lambda kv: -kv[1]))
                for b, v in names.items()},
        "h2d": {"copies": copies["h2d"][0], "bytes": copies["h2d"][1]},
        "d2h": {"copies": copies["d2h"][0], "bytes": copies["d2h"][1]},
        "kernels": len(kernel_names),
        "minhash_keys_kernel": sum("minhash_keys_kernel" in n
                                   for n in kernel_names),
        "rans_decode_kernel": sum("rans_decode_kernel" in n
                                  for n in kernel_names),
    }


def named_site(site: str) -> bool:
    return site in LOCK_SITES or site.startswith(LOCK_SITE_PREFIXES)


def profiled_child(default: dict) -> dict:
    """Phase 3f, (c) under ``--profile``: ``python -m tse1m_tpu_torch
    cluster --n 1000000 --profile`` at the default params on the card, in
    a child process; its report equals phase 3's unprofiled (c), its
    profile has the JAX package's keys and a live sampler's snapshot, its
    lock sites are JAX's names, and its Chrome trace launches kernels 1
    and 4 as (c) did."""
    res = fresh_dir(os.path.join(TOOL_DIR, "results"))
    env = dict(os.environ, TSE1M_RESULT_DIR=res, TSE1M_SIG_STORE="")
    for name in ("TSE1M_FAULT_PLAN", "TSE1M_PROFILING"):
        env.pop(name, None)
    cmd = [sys.executable, "-m", "tse1m_tpu_torch", "cluster", "--n",
           str(N_SESSIONS), "--seed", "0", "--profile", "--ari-sample", "0"]
    t0 = time.perf_counter()
    child = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                           text=True, timeout=CHILD_TIMEOUT_S)
    wall = time.perf_counter() - t0
    with open(os.path.join(TOOL_DIR, "child.log"), "w") as f:
        f.write(child.stdout + child.stderr)
    if child.returncode != 0:
        raise AssertionError(f"cluster --profile exited {child.returncode}: "
                             f"{child.stderr[-2000:]}")
    report = json.loads(child.stdout.strip().splitlines()[-1])
    info = default["info"]
    want = {"device": torch.cuda.get_device_name(0),
            "n_clusters": int(np.unique(default["labels"]).size),
            "ari_vs_planted": round(float(default["ari"]), 5),
            **{k: json.loads(json.dumps(info[k])) for k in WIRE_KEYS}}
    got = {k: report.get(k) for k in want}
    if got != want:
        raise AssertionError(f"profiled (c) differs from phase 3's: {got} "
                             f"vs {want}")
    log(f"  (c) under --profile: child {wall:.3f} s, cluster wall "
        f"{report['cluster_wall_s']} s (unprofiled {default['wall_s']:.3f} "
        f"s); n_clusters, ARI and wire keys == phase 3's")
    if sorted(os.listdir(res)) != ["device_trace", "profile_000.json",
                                   "run_manifest.json"]:
        raise AssertionError(f"result dir holds {sorted(os.listdir(res))}")
    with open(os.path.join(res, "profile_000.json")) as f:
        prof = json.load(f)
    sampler = prof.get("sampler") or {}
    if not (set(PROFILE_KEYS) <= set(prof)
            and prof["extra"] == {"step": "cluster", "n": N_SESSIONS}
            and sampler.get("samples", 0) > 0
            and "cluster" in sampler.get("plane_self", {})
            and prof["collapsed_stacks"]):
        raise AssertionError(f"profile_000.json: keys {sorted(prof)}, "
                             f"sampler {sampler}")
    sites = [r["site"] for r in prof["lock_wait_sites"]]
    if not all(named_site(s) for s in sites):
        raise AssertionError(f"lock sites outside JAX's names: {sites}")
    (trace_name,) = os.listdir(os.path.join(res, "device_trace"))
    trace_path = os.path.join(res, "device_trace", trace_name)
    summary = trace_summary(trace_path)
    traced = {"minhash_and_keys": summary["minhash_keys_kernel"],
              "rans_decode": summary["rans_decode_kernel"]}
    if traced != {k: default["counts"][k] for k in traced}:
        raise AssertionError(f"the trace launched {traced}, (c) "
                             f"{default['counts']}")
    log(f"  trace {trace_name} ({os.path.getsize(trace_path)} B): "
        f"minhash_keys_kernel x{traced['minhash_and_keys']}, "
        f"rans_decode_kernel x{traced['rans_decode']} (as in (c)); device "
        f"busy {summary['busy_share']:.4%} of {summary['window_s']:.3f} s")
    log(f"  sampler: {sampler['samples']} samples, planes "
        f"{sampler['plane_self']}; lock sites {sites}")
    return {"child_wall_s": wall, "cluster_wall_s": report["cluster_wall_s"],
            "unprofiled_wall_s": default["wall_s"],
            "wall_ratio": report["cluster_wall_s"] / default["wall_s"],
            "busy_share_of_cluster_wall": (summary["device_busy_s"]
                                           / report["cluster_wall_s"]),
            "stages": {k: v for k, v in report.items()
                       if k.startswith("stage_")},
            "sampler": {"samples": sampler["samples"],
                        "plane_self": sampler["plane_self"]},
            "lock_wait_sites": prof["lock_wait_sites"],
            "trace_bytes": os.path.getsize(trace_path), "trace": summary}


def profiled_in_process(items, default: dict, dev) -> dict:
    """Phase 3f: (c) again in this process under ``cluster --profile``'s
    wrapper (the sampler, the lock-wait recorder, the build histograms, a
    device trace), with (c)'s labels and launches; its wall against phase
    3's plain (c), also run in this process: the profiler's own cost, with
    no fresh process in the way."""
    params = pipeline.ClusterParams(n_hashes=N_HASHES, n_bands=N_BANDS)
    profiling.install_compile_listener()
    profiling.enable_lock_wait(True)
    profiling.start_sampler()
    try:
        with profiling.device_trace(os.path.join(TOOL_DIR, "c_trace")) as tr:
            run = drive(items, params, dev)
    finally:
        profiling.stop_sampler()
        profiling.enable_lock_wait(False)
    del run["sig"], run["keys"]
    if not (np.array_equal(run["labels"], default["labels"])
            and run["counts"] == default["counts"]):
        raise AssertionError(f"(c) in process under the wrapper: launches "
                             f"{run['counts']} or labels differ")
    summary = trace_summary(tr["path"])
    runs = {"plain": {"wall_s": default["wall_s"],
                      "stages": default["info"]["stages"]},
            "wrapper": {"wall_s": run["wall_s"],
                        "stages": run["info"]["stages"]}}
    ratios = {"wrapper": runs["wrapper"]["wall_s"] / runs["plain"]["wall_s"]}
    log(f"  (c) in process under the wrapper: wall "
        f"{runs['wrapper']['wall_s']:.3f} s, {ratios['wrapper']:.3f}x phase "
        f"3's plain (c) ({runs['plain']['wall_s']:.3f} s); (c)'s labels and "
        f"launches; device busy {summary['busy_share']:.4%} of "
        f"{summary['window_s']:.3f} s under the wrapper")
    return {"runs": runs, "ratios": ratios, "trace": summary}


def traced_merge(warm: dict, dev) -> dict:
    """Phase 3f, (w2) under ``device_trace``: phase 3b's accreted merge
    again, in process, over a copy of the store as run 1 left it."""
    params = store_params(TOOL_STORE)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with profiling.device_trace(os.path.join(TOOL_DIR, "w2_trace")) as tr:
        t0 = time.perf_counter()
        labels = pipeline.cluster_sessions(warm["items"], params, device=dev)
        wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    info = dict(pipeline.last_run_info)
    if not (info["cache_mode"] == "merge"
            and 0 < info["cache_novel_rows"] <= WARM_ROWS - WARM_BASE):
        raise AssertionError(f"traced (w2): {info}")
    if not np.array_equal(labels, warm["oracle"]):
        raise AssertionError("traced (w2) labels differ from the storeless "
                             "run's")
    summary = trace_summary(tr["path"])
    if summary["minhash_keys_kernel"] != counts["minhash_and_keys"]:
        raise AssertionError(f"the (w2) trace launched "
                             f"{summary['minhash_keys_kernel']}, the run "
                             f"{counts}")
    log(f"  (w2) under device_trace: wall {wall:.3f} s, merge, "
        f"{info['cache_novel_rows']} novel rows, launches {counts}, labels "
        f"== the storeless run's; device busy {summary['busy_share']:.4%} "
        f"of {summary['window_s']:.3f} s")
    return {"wall_s": wall, "launches": counts, "stages": info["stages"],
            "trace": summary}


def sanitized_rerun(label: str, fn, want_launches: dict, dev) -> tuple:
    """One warm-up call, then ``fn()`` under ``sanitized(0)`` with the
    launch counts set to 0 just before and read just after; returns its
    output and the report."""
    fn()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with sanitizer.sanitized(compile_budget=0) as san:
        out = fn()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    expect_launches(counts, want_launches)
    rep = san.as_dict()
    if not rep["sanitizer_transfer_guard"]:
        raise AssertionError(f"{label}: the sync guard was off on the card")
    log(f"  {label} under sanitized(0): wall {wall:.3f} s, builds "
        f"{rep['sanitizer_compile_count']}, launches {counts}, sync sites "
        f"{rep['sanitizer_sync_sites']}")
    return out, {**rep, "wall_s": wall, "launches": counts}


def sanitized_phase(items, plain24: dict, warm: dict, dev) -> dict:
    """Phase 3f: (b)'s 24-bit run (kernel 3), (w3)'s all hits and (w5)'s
    64-query scan (kernel 5), each warm under ``sanitized(0)``."""
    out = {}
    labels, out["b"] = sanitized_rerun(
        "(b) 24-bit, 1M", lambda: pipeline.cluster_sessions(
            items, params_for(-1), device=dev),
        {"minhash_and_keys_packed": (1, None)}, dev)
    if not np.array_equal(labels, plain24["labels"]):
        raise AssertionError("sanitized (b) labels differ from phase 3's")
    params = store_params(TOOL_STORE)
    labels, out["w3"] = sanitized_rerun(
        "(w3) all hits", lambda: pipeline.cluster_sessions(
            warm["items"], params, device=dev), {}, dev)
    if not (pipeline.last_run_info["cache_novel_rows"] == 0
            and np.array_equal(labels, warm["oracle"])):
        raise AssertionError("sanitized (w3): novel rows or labels")
    store = SignatureStore.open_existing(TOOL_STORE)
    loc = store_scan_locator(store, np.arange(store.n_rows))
    pick = np.sort(np.random.default_rng(1).choice(store.n_rows, N_QUERIES,
                                                   replace=False))
    queries = store.load_signatures(loc[pick, 0], loc[pick, 1])
    chunks = sum(-(-int(e["rows"]) // SCAN_CHUNK) for e in store.shards)
    first = bulk_topk_store(store, queries, TOPK_K, device=dev,
                            chunk_rows=SCAN_CHUNK)
    (counts, rows), out["w5"] = sanitized_rerun(
        "(w5) 64-query scan", lambda: bulk_topk_store(
            store, queries, TOPK_K, device=dev, chunk_rows=SCAN_CHUNK),
        {"topk_chunk": chunks}, dev)
    if not (np.array_equal(counts, first[0]) and np.array_equal(rows,
                                                                first[1])
            and (counts[:, 0] == N_HASHES).all()):
        raise AssertionError("sanitized (w5) ranks differ or a first hit "
                             "is not a full agreement")
    return out


def tooling_phase(items, default: dict, plain24: dict, warm: dict,
                  dev) -> dict:
    """Phase 3f: device tooling at the main path's full width; one
    ``profile`` JSON line."""
    t_phase = time.perf_counter()
    line = {"c": profiled_child(default),
            "c_in_process": profiled_in_process(items, default, dev),
            "w2": traced_merge(warm, dev),
            "sanitized": sanitized_phase(items, plain24, warm, dev)}
    check = sanitizer.self_check(dev)
    log(f"  self_check on the card: {check}")
    if not (check["sanitizer_available"] and check["sanitizer_sync_seen"]
            and check["sanitizer_compile_count"] == 0):
        raise AssertionError(f"sanitizer self-check failed: {check}")
    shutil.rmtree(TOOL_STORE, ignore_errors=True)
    line.update(self_check=check, phase_s=time.perf_counter() - t_phase,
                card=card_name_and_limit())
    print(json.dumps({"profile": line}), flush=True)
    return line


# Plain versions' times taken where an earlier phase runs them on phase
# 5's inputs anyway (phase 2's rANS lanes, cell (g)'s top-k chunk): phase 5
# reports these, as time_ms(..., warmup=0, reps=1) would measure them,
# instead of running a plain version of seconds a second time.
PLAIN_MS: dict = {}


def timed_once(fn) -> tuple:
    """(fn(), the card's ms for that one call): CUDA events around it, as
    ``time_ms(fn, warmup=0, reps=1)`` times it."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def time_ms(fn, warmup: int = 3, reps: int = 20, inner: int = 1) -> float:
    """Median over ``reps`` windows of the card's time a call, CUDA events
    around ``inner`` back-to-back calls a window.  Kernels are timed with
    ``inner`` > 1, so the wrapper's host work overlaps the kernel before it
    and the window holds the kernels, not the host's enqueue."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def minhash_bound(n: int, s: int, in_bytes_per_id: int) -> tuple:
    """Least time for the work: ids read once, signatures and keys written
    once; per (row, id, hash) one IMAD and one IMNMX, per signature value in
    the band fold one multiply (FMA pipe) and one XOR (ALU pipe), the two
    pipes running side by side at INT32_PIPE_OPS_PER_S each."""
    nbytes = (n * s * in_bytes_per_id + 2 * N_HASHES * 4
              + n * (N_HASHES + N_BANDS) * 4)
    ops_per_pipe = n * s * N_HASHES + n * N_HASHES
    return _larger(nbytes / HBM_BYTES_PER_S * 1e3,
                   ops_per_pipe / INT32_PIPE_OPS_PER_S * 1e3)


def rans_bound(lane: entropy.EntropyLane) -> tuple:
    """Least time for one lane's decode: words, states and frequencies read
    once, the [n] uint32 symbols written once; RANS_ALU_OPS_PER_SYMBOL ALU
    operations per symbol and plane."""
    nbytes = lane.nbytes + 4 * lane.n
    ops = RANS_ALU_OPS_PER_SYMBOL * lane.n * len(lane.planes)
    return _larger(nbytes / HBM_BYTES_PER_S * 1e3,
                   ops / INT32_PIPE_OPS_PER_S * 1e3)


def cminhash_bound(n: int, s: int) -> tuple:
    """Least time for the bin-min: ids read once, a0 and b0 read once, the
    [N, H] bins and [N] row minima written once; per id one IMAD (FMA pipe)
    and one min (ALU pipe), the remainder not counted."""
    nbytes = n * s * 4 + 2 * 4 + n * (N_HASHES + 1) * 4
    return _larger(nbytes / HBM_BYTES_PER_S * 1e3,
                   n * s / INT32_PIPE_OPS_PER_S * 1e3)


def topk_bound(args: tuple, n_rows: int) -> tuple:
    """Least time for one top-k chunk: queries, the transposed store, the
    row ids and the incoming state read once, the state written once; per
    (query, valid row, hash) one compare and one add, counted as issuing
    side by side on two integer pipes (the lower of the two readings: 0.98
    ms at cell (g) if they share one pipe)."""
    q, s_t, rid, topc, topr, _ = args
    nbytes = sum(t.numel() * 4 for t in (q, s_t, rid, topc, topr)) \
        + 2 * topc.numel() * 4
    ops_per_pipe = N_QUERIES * n_rows * q.shape[1]
    return _larger(nbytes / HBM_BYTES_PER_S * 1e3,
                   ops_per_pipe / INT32_PIPE_OPS_PER_S * 1e3)


def _larger(t_bytes: float, t_ops: float) -> tuple:
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def binmin_library(ids: torch.Tensor, a0: torch.Tensor, b0: torch.Tensor):
    """The one PyTorch call that computes the bin-min: scatter_reduce_
    (amin) of the widened permuted ids into [N, H] int64 filled with UMAX.
    Returns it as a thunk over precomputed ids and bins (a yardstick
    only; the port never calls it)."""
    u64 = (mul_u32(widen(ids), widen(a0)) + widen(b0)) & U32_MASK
    bins = u64 % N_HASHES
    shape = (ids.shape[0], N_HASHES)
    return lambda: torch.full(shape, U32_MASK, dtype=torch.int64,
                              device=ids.device).scatter_reduce_(
                                  1, bins, u64, "amin")


def sm_clock_mhz(fn, seconds: float = 1.0) -> tuple:
    """Run ``fn`` back to back for ``seconds`` while nvidia-smi samples the
    SM clock every 20 ms; returns (median, least, most) MHz."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "20"], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.3)
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate()
    mhz = [int(v) for v in out.split() if v.isdigit()]
    if not mhz:
        raise AssertionError("nvidia-smi gave no SM clock")
    return statistics.median(mhz), min(mhz), max(mhz)


def rans_timing(plan: dict, dev, inner: int) -> dict:
    """Phase 5, rANS: (c)'s lanes alone and in their one launch, with the
    SM clock read meanwhile and the cycles a step it gives."""
    lanes = {name: rans_args(lane, dev) for name, lane in
             plan["lanes"].items()}
    batch = list(lanes.values())
    out = {"batched_ms": time_ms(lambda: krans.rans_decode_lanes(batch),
                                 inner=inner)}
    mhz, lo, hi = sm_clock_mhz(lambda: krans.rans_decode_lanes(batch))
    out["sm_mhz"] = mhz
    steps = max(-(-n // entropy.N_STREAMS) for _, n, _ in batch)
    b_ms = sum(rans_bound(lane)[0] for lane in plan["lanes"].values())
    log(f"  rans_decode_lanes: {' + '.join(lanes)} in one launch "
        f"{out['batched_ms']:.4f} ms ({steps} steps on the longest chain: "
        f"{out['batched_ms'] * 1e-3 * mhz * 1e6 / steps:.1f} cycles a step "
        f"at the SM clock of {mhz} MHz, read {lo}-{hi} MHz; bound "
        f"{b_ms:.6f} ms by bytes)")
    return out


def topk_pass_timing(args: tuple, inner: int) -> dict:
    """Phase 5, top-k: each pass alone at cell (g)'s chunk (the scratch as
    the wrapper allocates it; the select pass reads one count pass's
    counts and histogram)."""
    q, s_t, rid, topc, topr, k = args
    qp, h = q.shape
    counts = torch.empty((qp, s_t.shape[1]), dtype=torch.int16,
                         device=q.device)
    hist = torch.zeros((qp, h + 1), dtype=torch.int32, device=q.device)
    outc, outr = torch.empty_like(topc), torch.empty_like(topr)
    ext = _build.load_extension()

    def run(passes: int):
        ext.topk_chunk(q, s_t, rid, topc, topr, k, counts, hist, outc, outr,
                       passes)

    # The count pass adds into the histogram; its values do not change
    # the count pass's work, so it is timed without zeroing.
    count_ms = time_ms(lambda: run(1), inner=inner)
    hist.zero_()
    run(1)
    select_ms = time_ms(lambda: run(2), inner=inner)
    log(f"  topk_chunk passes: count {count_ms:.4f} ms, select "
        f"{select_ms:.4f} ms")
    return {"count_ms": count_ms, "select_ms": select_ms}


def timing(items, plan: dict, dev, consts, topk: dict, scan_args: tuple,
           inner: int) -> dict:
    """Phase 5: the MinHash and bin-min kernels at the plain path's first
    chunk, the uint32 MinHash kernel also at the default run's delta rows
    (its largest launch there), the rANS kernel at the default run's rep
    and counts lanes (each alone and both in one launch), the top-k kernel
    at cell (g)'s chunk (whole and by pass); then the warm path's shapes:
    both MinHash kernels at the largest pow2 novel batch (65,536 rows) and
    the top-k kernel at the scan's first 16,384-column chunk."""
    chunk = items[:CHUNK_ROWS]
    ids = u32_tensor(quantize_ids(chunk, 10), dev)
    wire = pack_chunk(chunk)
    if wire.bits != 24:
        raise AssertionError(f"first chunk ships {wire.bits}-bit ids, not 24")
    payload = torch.from_numpy(wire.payload).to(dev)
    a0, b0 = make_params("cminhash", N_HASHES, 0).to(dev).arrays[:2]
    # The plain rANS decode takes seconds a lane (a launch of torch ops per
    # step), the plain top-k seconds a chunk (a launch of torch ops per
    # selection step and tile); phase 2 and cell (g) ran and timed them on
    # these inputs already (PLAIN_MS), so those times are reported; the
    # scan chunk's gets no warm-up.
    cases = {
        "minhash_and_keys": ((ids, *consts, N_BANDS),
                             minhash_bound(CHUNK_ROWS, SET_SIZE, 4), 1, 10),
        "cminhash_binmin": ((ids, a0, b0, N_HASHES),
                            cminhash_bound(CHUNK_ROWS, SET_SIZE), 1, 10),
        "minhash_and_keys_packed": (
            (payload, wire.shape, 3, wire.offset, *consts, N_BANDS),
            minhash_bound(CHUNK_ROWS, SET_SIZE, 3), 1, 10),
        "minhash_and_keys:delta": (
            (u32_tensor(quantize_ids(items[:plan["n_delta"]], 10), dev),
             *consts, N_BANDS),
            minhash_bound(plan["n_delta"], SET_SIZE, 4), 1, 10),
    }
    for name, lane in plan["lanes"].items():
        cases[f"rans_decode:{name}"] = (rans_args(lane, dev),
                                        rans_bound(lane), 0, 1)
    cases["topk_chunk"] = (topk["args"], topk_bound(topk["args"],
                                                    N_SESSIONS), 0, 1)
    novel = items[:POW2_MAX]
    novel_wire = pack_chunk(novel)
    if novel_wire.bits != 24:
        raise AssertionError(f"novel batch ships {novel_wire.bits}-bit ids")
    cases["minhash_and_keys:novel"] = (
        (u32_tensor(quantize_ids(novel, 10), dev), *consts, N_BANDS),
        minhash_bound(POW2_MAX, SET_SIZE, 4), 1, 10)
    cases["minhash_and_keys_packed:novel"] = (
        (torch.from_numpy(novel_wire.payload).to(dev), novel_wire.shape, 3,
         novel_wire.offset, *consts, N_BANDS),
        minhash_bound(POW2_MAX, SET_SIZE, 3), 1, 10)
    scan = (*scan_args, TOPK_K)
    cases["topk_chunk:scan"] = (scan, topk_bound(scan, SCAN_CHUNK), 0, 1)
    library = {"cminhash_binmin": binmin_library(ids, a0, b0)}
    out = {}
    for case, (args, (b_ms, by), plain_warmup, plain_reps) in cases.items():
        name = case.split(":")[0]
        k = KERNELS[name]
        ms = time_ms(lambda: k["wrapper"](*args), inner=inner)
        plain_ms = PLAIN_MS.get(case)
        if plain_ms is None:
            plain_ms = time_ms(lambda: k["plain"](*args),
                               warmup=plain_warmup, reps=plain_reps)
        lib_ms = time_ms(library[name], inner=inner) \
            if name in library else None
        out[case] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": by, "library_ms": lib_ms}
        steps = ""
        if case.startswith("rans"):
            steps = f", {-(-args[1] // entropy.N_STREAMS)} serial steps"
        lib = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
        log(f"  {case}: {ms:.4f} ms (plain {plain_ms:.3f} ms{lib}, bound "
            f"{b_ms:.6f} ms by {by}{steps})")
    out["rans_decode:rep"].update(rans_timing(plan, dev, inner))
    rep = out["rans_decode:rep"]
    steps = -(-plan["lanes"]["rep"].n // entropy.N_STREAMS)
    rep["cycles_per_step"] = rep["ms"] * 1e-3 * rep["sm_mhz"] * 1e6 / steps
    log(f"  rans_decode:rep: {rep['cycles_per_step']:.1f} cycles a step at "
        f"{rep['sm_mhz']} MHz")
    out["topk_chunk"].update(topk_pass_timing(topk["args"], inner))
    return out


RQ_DIR = os.path.join(ROOT, "build", "rq_smoke")  # gitignored
# The frozen golden study (tests/goldens/generate_goldens.py:33) and its
# eight committed artifacts (generate_goldens.py:37-46).
GOLDEN_SPEC = dict(n_projects=8, days=400, seed=42, fuzz_rate=1.2,
                   ineligible_fraction=0.0)
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens", "synth8")
GOLDEN_FILES = (
    "rq1/rq1_detection_rate_stats.csv",
    "rq1/rq1_raw_issues_for_analysis.csv",
    "rq2/coverage_by_session_index.csv",
    "rq3/all_coverage_change_analysis.csv",
    "rq3/detected_coverage_changes.csv",
    "rq4/bug/rq4_g1_g2_detection_trend.csv",
    "rq4/bug/rq4_gc_introduction_iteration.csv",
    "rq4/coverage/g2_g1_trend_stats.csv",
)
# Each driver's manifest, under the result directory.
# The figures the golden study draws in test mode (every data gate open),
# besides one per-project chart under rq2/projects/ per |corr| > 0.5.
GOLDEN_FIGURES = (
    "rq1/rq1_detection_rate.pdf", "rq2/all_project_corr_hist.pdf",
    "rq2/average_median_lineplot.pdf", "rq2/session_coverage_boxplot.pdf",
    "rq2/session_coverage_distribution_trend.pdf",
    "rq3/coverage_diff_boxplot.pdf", "rq3/coverage_diff_histograms.pdf",
    "rq3/detected.pdf", "rq3/non_detected.pdf",
    "rq4/bug/rq4_g1_g2_detection_trend.pdf",
    "rq4/bug/rq4_gc_bug_detection_venn.pdf",
    "rq4/bug/rq4_gc_detection_trend.pdf",
    "rq4/coverage/coverage_delta_timeseries_linear.pdf",
    "rq4/coverage/g2_g1_boxplot_comparison.pdf",
)
DRIVER_MANIFESTS = {
    "rq1": "rq1/rq1_manifest.json",
    "rq2a": "rq3/rq2_changepoints_manifest.json",
    "rq2b": "rq2/rq2_trends_manifest.json",
    "rq3": "rq3/rq3_manifest.json",
    "rq4a": "rq4/bug/rq4a_manifest.json",
    "rq4b": "rq4/coverage/rq4b_manifest.json",
}
# ~1M fuzzing builds, the JAX bench's extraction and RQ-suite study
# (bench.py:31-50, 81-117) and the reference's 1.19M build logs.
RQ_SPEC = dict(n_projects=446, days=1600, fuzz_rate=1.4,
               ineligible_fraction=0.0, seed=0)
RQ_CUTOFF = "2026-01-01"
RQ_MIN_PROJECTS = 100
# Warm calls timed a measurement (medians of 5 until phase 3e joined the
# script, of 3 until phase 3g did: cut to keep the script inside its time
# limit on a slow host).
RQ_REPS = 1
RQS = ("rq1", "rq2cp", "rq2tr", "rq3", "rq4a", "rq4b")
# Float32 sums in another order: within rtol = atol = 2e-5 (the repo's
# cross-engine tolerance); every other field exact.
RQ_CLOSE = {("rq2tr", "spearman"), ("rq2tr", "mean")}
RQ_TOL = 2e-5


def card_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def fresh_sqlite(path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    for suffix in ("", "-wal", "-shm"):
        if os.path.exists(path + suffix):
            os.remove(path + suffix)


def run_drivers(cfg, dev, transcript: str):
    """``run_rqs`` over all six drivers, as ``all`` runs them, with their
    printed transcript sent to a file beside the study."""
    with open(transcript, "w") as f, contextlib.redirect_stdout(f):
        return run_rqs(cfg, device=dev)


# ``all``'s steps: the correctness plane's two, then the six drivers.
CORRECTNESS_STEPS = ("graftlint", "graftspec")
ALL_STEPS = [*CORRECTNESS_STEPS, *RQ_DRIVERS]
# Each ``all``'s two correctness steps' walls (s), for the
# ``correctness_steps_s`` line: what the steps cost an ``all`` on this host.
CORRECTNESS_WALLS: dict = {}


def check_all_steps(run: dict, label: str) -> dict:
    """Every step of one ``all`` ok, in ``all``'s order, in its
    run_manifest.json (``run``); its correctness steps' walls noted under
    ``label``; returns the steps by name."""
    steps = {s["name"]: s for s in run["steps"]}
    bad = {n: s.get("error") for n, s in steps.items() if s["status"] != "ok"}
    if list(steps) != ALL_STEPS or bad:
        raise AssertionError(f"all ({label}): steps {list(steps)}, not ok: "
                             f"{bad}")
    CORRECTNESS_WALLS[label] = {n: steps[n]["wall_s"]
                                for n in CORRECTNESS_STEPS}
    return steps


def check_drivers_ran(out: str, dev, label: str) -> dict:
    """Every step of ``all`` ok in run_manifest.json, and each driver's
    manifest naming TorchBackend on the card; returns run_manifest.json."""
    with open(os.path.join(out, "run_manifest.json")) as f:
        run = json.load(f)
    check_all_steps(run, label)
    for name, rel in DRIVER_MANIFESTS.items():
        with open(os.path.join(out, rel)) as f:
            m = json.load(f)
        if (m["backend"], m["device"]) != ("torch_cuda",
                                          torch.cuda.get_device_name(dev)):
            raise AssertionError(f"{name} ran on {m['backend']} "
                                 f"{m['device']}")
    return run


def fresh_dir(path: str) -> str:
    """``path`` emptied: no artifact of an earlier run can pass a check."""
    shutil.rmtree(path, ignore_errors=True)
    return path


def rq_golden(dev) -> dict:
    """The frozen golden study through the port's six drivers on the card,
    run as ``all`` runs them: its eight artifacts equal the committed
    goldens byte for byte, its figures drawn or listed as skipped."""
    path = os.path.join(RQ_DIR, "golden.sqlite")
    corpus = os.path.join(RQ_DIR, "golden_corpus.csv")
    out = fresh_dir(os.path.join(RQ_DIR, "golden_out"))
    fresh_sqlite(path)
    study = generate_study(SynthSpec(**GOLDEN_SPEC))
    study.to_db(path)
    study.write_corpus_csv(corpus)
    cfg = StudyConfig(sqlite_path=path, result_dir=out, test_mode=True,
                      corpus_csv=corpus)
    runner = run_drivers(cfg, dev, os.path.join(RQ_DIR, "golden_all.log"))
    if runner.exit_code():
        raise AssertionError(f"golden all: {runner.summary()}")
    check_drivers_ran(out, dev, "golden")
    for rel in GOLDEN_FILES:
        with open(os.path.join(out, rel), "rb") as f:
            got = f.read()
        with open(os.path.join(GOLDEN_DIR, rel), "rb") as f:
            want = f.read()
        if got != want:
            raise AssertionError(f"{rel} differs from the golden")
    log(f"  golden study through the six drivers on the card: all "
        f"{len(GOLDEN_FILES)} files equal tests/goldens/synth8/ byte for "
        "byte")
    return check_golden_figures(out)


def check_golden_figures(out: str) -> dict:
    """Where matplotlib imports, the golden study's figures are drawn and
    no manifest lists a skipped one; where it does not (the card's
    machine), no PDF is written and the drivers' manifests list every one
    of them under ``figures_skipped``."""
    from tse1m_tpu_torch.analysis.common import pyplot

    try:
        pyplot()
    except ImportError:
        drawn = False
    else:
        drawn = True
    pdfs = sorted(os.path.relpath(os.path.join(d, f), out)
                  for d, _, files in os.walk(out) for f in files
                  if f.endswith(".pdf"))
    skipped = set()
    for rel in DRIVER_MANIFESTS.values():
        with open(os.path.join(out, rel)) as f:
            skipped |= {os.path.join(os.path.dirname(rel), name) for name
                        in json.load(f).get("figures_skipped", [])}
    projects = [p for p in (pdfs if drawn else sorted(skipped))
                if p.startswith("rq2/projects/")]
    if drawn:
        small = [p for p in pdfs
                 if os.path.getsize(os.path.join(out, p)) < 1024]
        if not (set(GOLDEN_FIGURES) <= set(pdfs) and projects and not small
                and not skipped):
            raise AssertionError(f"golden figures: drawn {pdfs}, too small "
                                 f"{small}, skipped {sorted(skipped)}")
        log(f"  matplotlib imports: the golden study's {len(pdfs)} figures "
            "drawn, none skipped")
    else:
        if pdfs or not (set(GOLDEN_FIGURES) <= skipped and projects):
            raise AssertionError(f"golden figures without matplotlib: PDFs "
                                 f"{pdfs}, skipped {sorted(skipped)}")
        log(f"  no matplotlib here: no PDF written, the {len(skipped)} "
            "figures listed as skipped in the drivers' manifests")
    return {"matplotlib": drawn, "figures": len(pdfs) if drawn
            else len(skipped)}


def correctness_line(run: dict) -> dict:
    """(h)'s ``graftlint`` and ``graftspec`` records, both ok: the port's
    lint clean over its files with every suppression counted by rule, the
    sanitizer's self-check on the card, each spec's states, every mutant
    caught; JAX and pandas never imported in this process.  Prints the
    ``correctness`` line."""
    steps = {s["name"]: s for s in run["steps"]}
    lint = steps["graftlint"]["result"]
    spec = steps["graftspec"]["result"]
    runtime = lint["runtime"]
    if not (lint["ok"] and lint["new_findings"] == 0
            and lint["baselined"] == 0 and runtime["sanitizer_available"]
            and runtime.get("sanitizer_sync_seen")):
        raise AssertionError(f"graftlint at (h): {lint}")
    if not (all(r["ok"] and r["complete"] for r in spec["specs"])
            and all(m["caught"] and m["replayed"]
                    for m in spec["mutants"].values())):
        raise AssertionError(f"graftspec at (h): {spec}")
    loaded = sorted(m for m in FORBIDDEN_MODULES if m in sys.modules)
    if loaded:
        raise AssertionError(f"the port imported {loaded}")
    line = {
        "graftlint": {
            "files": lint["graph_files"], "new": lint["new_findings"],
            "baselined": lint["baselined"], "suppressed": lint["suppressed"],
            "suppressed_by_rule": lint["suppressed_by_rule"],
            "lint_wall_s": lint["wall_s"],
            "cache_hit_rate": lint["cache_hit_rate"],
            "step_wall_s": steps["graftlint"]["wall_s"],
            "sanitizer_sync_seen": runtime["sanitizer_sync_seen"]},
        "graftspec": {
            "states": {r["spec"]: r["states"] for r in spec["specs"]},
            "mutants_caught": sum(m["caught"]
                                  for m in spec["mutants"].values()),
            "mutants": len(spec["mutants"]),
            "step_wall_s": steps["graftspec"]["wall_s"]},
        "jax_or_pandas_imported": loaded, "card": card_name_and_limit()}
    log(f"  graftlint at (h): {line['graftlint']['files']} files, 0 new, 0 "
        f"baselined, {lint['suppressed']} suppressed, lint "
        f"{lint['wall_s']:.3f} s (cache hit rate {lint['cache_hit_rate']}); "
        f"graftspec: states {line['graftspec']['states']}, "
        f"{line['graftspec']['mutants_caught']}/"
        f"{line['graftspec']['mutants']} mutants caught; no jax, no pandas")
    print(json.dumps({"correctness": line}), flush=True)
    return line


def csv_rows(path: str, header: bool = True) -> int:
    with open(path, newline="") as f:
        return sum(1 for _ in csv.reader(f)) - int(header)


def rq_drivers(dev, path: str, corpus: str, arrays, got: dict,
               limit_ns: int) -> dict:
    """Phase 4's last step: ``all`` once on the card over the 446-project
    study at RQ_CUTOFF and RQ_MIN_PROJECTS, with the corpus CSV's G1/G2
    groups; every step ok, and each artifact's row count the one the
    single calls' results imply; returns the ``rq_drivers`` report."""
    out = fresh_dir(os.path.join(RQ_DIR, "all_out"))
    cfg = StudyConfig(sqlite_path=path, limit_date=RQ_CUTOFF, result_dir=out,
                      corpus_csv=corpus,
                      min_projects_per_iteration=RQ_MIN_PROJECTS)
    t0 = time.perf_counter()
    run_drivers(cfg, dev, os.path.join(RQ_DIR, "all.log"))
    all_s = time.perf_counter() - t0
    run = check_drivers_ran(out, dev, "h")
    correctness_line(run)
    # The rows each artifact must hold, from the backend's own results on
    # the same arrays; RQ4a's and the introduction CSV's from the corpus
    # CSV's groups.
    groups = load_corpus_groups(corpus, set(arrays.projects))
    pidx = arrays.project_index()
    cg1, cg2 = (groups.indices(k, pidx) for k in ("group1", "group2"))
    rq4a = TorchBackend(dev).rq4a_detection_trend(
        arrays, limit_ns, cg1, cg2, RQ_MIN_PROJECTS)
    cp = got["rq2cp"]
    want = {
        "rq1/rq1_detection_rate_stats.csv": got["rq1"].iterations.size,
        "rq1/rq1_raw_issues_for_analysis.csv": int(got["rq1"].linked.sum()),
        "rq3/all_coverage_change_analysis.csv": cp.project_idx.size,
        "rq2/coverage_by_session_index.csv": got["rq2tr"].matrix.shape[1],
        "rq3/detected_coverage_changes.csv": got["rq3"].det_diff_percent.size,
        "rq3/non_detected_coverage_changes.csv":
            got["rq3"].nondet_diff_percent.size,
        "rq4/bug/rq4_g1_g2_detection_trend.csv": rq4a.iterations.size,
        "rq4/bug/rq4_gc_introduction_iteration.csv": len(g4_prepost(
            arrays, limit_ns, groups, cfg.analysis_iterations
        ).intro_iteration),
        "rq4/coverage/g2_g1_trend_stats.csv": got["rq4b"].matrix.shape[1],
    }
    rows = {rel: csv_rows(os.path.join(out, rel),
                          header=not rel.startswith("rq2/"))
            for rel in want}
    per_project = os.path.join(out, "rq3", "change_analysis")
    n_files = len(os.listdir(per_project))
    rows["rq3/change_analysis/*.csv"] = sum(
        csv_rows(os.path.join(per_project, f))
        for f in os.listdir(per_project))
    want["rq3/change_analysis/*.csv"] = cp.project_idx.size
    wrong = {rel: (rows[rel], n) for rel, n in want.items()
             if rows[rel] != int(n)}
    if wrong or n_files != np.unique(cp.project_idx).size:
        raise AssertionError(f"all: rows (got, want) {wrong}, "
                             f"{n_files} change_analysis files")
    drivers = {}
    for name, rel in DRIVER_MANIFESTS.items():
        with open(os.path.join(out, rel)) as f:
            phases = json.load(f)["timings"]
        drivers[name] = {"wall_s": next(s["wall_s"] for s in run["steps"]
                                        if s["name"] == name),
                         "phases_s": phases}
    log(f"  all on the card in {all_s:.3f} s, every step ok, "
        f"{sum(rows.values()):,} artifact rows as the results imply "
        f"({n_files} change_analysis files); " + ", ".join(
            f"{n} {d['wall_s']:.3f} s" for n, d in drivers.items()))
    report = {"all_s": all_s, "drivers": drivers, "rows": rows,
              "change_analysis_files": n_files,
              "groups": {k: len(v) for k, v in groups.groups.items()},
              "card": card_name_and_limit()}
    print(json.dumps({"rq_drivers": report}), flush=True)
    return report


def rq_calls(backend, arrays, limit_ns: int, g1, g2) -> dict:
    return {
        "rq1": lambda: backend.rq1_detection(arrays, limit_ns,
                                             RQ_MIN_PROJECTS),
        "rq2cp": lambda: backend.rq2_change_points(arrays, limit_ns),
        "rq2tr": lambda: backend.rq2_trends(arrays, limit_ns),
        "rq3": lambda: backend.rq3_coverage_at_detection(arrays, limit_ns),
        "rq4a": lambda: backend.rq4a_detection_trend(
            arrays, limit_ns, g1, g2, RQ_MIN_PROJECTS),
        "rq4b": lambda: backend.rq4b_group_trends(arrays, limit_ns, g1, g2),
        "suite": lambda: backend.rq_suite(arrays, limit_ns, RQ_MIN_PROJECTS,
                                          g1, g2),
    }


def rq_compare(got, want, rq: str, label: str,
               close: set = RQ_CLOSE) -> float:
    """Every field and dtype of ``got`` against ``want``: exact, or within
    RQ_TOL for the fields in ``close``.  Returns the largest share of its
    tolerance (|x - y| over RQ_TOL * (1 + |y|)) that such a value used."""
    worst = 0.0
    for f in want.__dataclass_fields__:
        x, y = getattr(got, f), getattr(want, f)
        if not isinstance(y, np.ndarray):
            if x != y:
                raise AssertionError(f"{label} {rq}.{f} differs")
            continue
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{label} {rq}.{f}: {x.dtype}{x.shape} vs "
                                 f"{y.dtype}{y.shape}")
        if (rq, f) in close:
            ok = np.allclose(x, y, rtol=RQ_TOL, atol=RQ_TOL, equal_nan=True)
        else:
            ok = np.array_equal(x, y, equal_nan=x.dtype.kind == "f")
        if not ok:
            raise AssertionError(f"{label} {rq}.{f} differs beyond its "
                                 "tolerance")
        both = ~(np.isnan(x) | np.isnan(y))
        if (rq, f) in close and both.any():
            share = np.abs(x - y)[both] / (RQ_TOL * (1 + np.abs(y[both])))
            worst = max(worst, float(share.max()))
    return worst


def median_wall(fn, reps: int = RQ_REPS) -> tuple:
    """(median host wall of ``reps`` calls, the last call's result), each
    call ending with the card idle (every RQ call ends with its
    device-to-host copy)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def wall_s(fn, reps: int = RQ_REPS) -> float:
    """Median host wall of ``reps`` warm calls."""
    return median_wall(fn, reps)[0]


def device_busy_share(fn) -> float | None:
    """Share of one warm call's wall the card spent in kernels and copies,
    by torch.profiler; None when the trace holds no device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(getattr(e, "self_device_time_total", 0)
                  for e in prof.key_averages())
    return busy_us * 1e-6 / wall if busy_us else None


@contextlib.contextmanager
def numpy_extraction():
    """``StudyArrays.from_db`` on its numpy path: the native decoder off."""
    real = columnar._native_db_path
    columnar._native_db_path = lambda db: None
    try:
        yield
    finally:
        columnar._native_db_path = real


def rq_phase(dev) -> dict:
    """Phase 4: the golden study on the card, then the 1M-build study:
    generated and written to sqlite, extracted on the numpy path, the
    suite and the six single calls on the card held against
    TorchBackend("cpu"), and timed.  Returns what phase 4b holds its
    loaded copies against: the study, its file, the numpy arrays and
    their extraction wall, the card's suite results."""
    t_phase = time.perf_counter()
    golden_figures = rq_golden(dev)
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    path = os.path.join(RQ_DIR, "study.sqlite")
    fresh_sqlite(path)
    t0 = time.perf_counter()
    study = generate_study(SynthSpec(**RQ_SPEC))
    gen_s = time.perf_counter() - t0
    rows = {t: len(next(iter(getattr(study, t).values())))
            for t in ("buildlog_data", "total_coverage", "issues")}
    t0 = time.perf_counter()
    study.to_db(path)
    write_s = time.perf_counter() - t0
    corpus = os.path.join(RQ_DIR, "study_corpus.csv")
    study.write_corpus_csv(corpus)
    log(f"  1M-build study: {rows} rows generated in {gen_s:.3f} s, "
        f"written to sqlite in {write_s:.3f} s")
    cfg = StudyConfig(sqlite_path=path, limit_date=RQ_CUTOFF)

    def extract():
        with numpy_extraction(), connect(path) as db:
            return StudyArrays.from_db(db, cfg)

    extract_s, arrays = median_wall(extract)
    extracted = {t: len(getattr(arrays, t))
                 for t in ("fuzz", "covb", "issues", "cov")}
    log(f"  extracted {arrays.n_projects} projects, {extracted} rows, in "
        f"{extract_s:.3f} s on the numpy path (warm calls timed: {RQ_REPS})")
    limit_ns = int(np.datetime64(RQ_CUTOFF, "ns").astype(np.int64))
    g1 = np.arange(0, arrays.n_projects, 2)
    g2 = np.arange(1, arrays.n_projects, 2)
    card = rq_calls(TorchBackend(dev), arrays, limit_ns, g1, g2)
    cpu = rq_calls(TorchBackend("cpu"), arrays, limit_ns, g1, g2)
    t0 = time.perf_counter()
    fused = card["suite"]()
    cold_suite_s = time.perf_counter() - t0
    got = {rq: card[rq]() for rq in RQS}
    fused_cpu = cpu["suite"]()
    want = {rq: cpu[rq]() for rq in RQS}
    worst = 0.0
    for rq in RQS:
        worst = max(worst, rq_compare(fused[rq], fused_cpu[rq], rq,
                                      "suite, card vs CPU"),
                    rq_compare(got[rq], want[rq], rq, "card vs CPU"))
        rq_compare(fused[rq], got[rq], rq, "card suite vs single calls")
    log(f"  suite and six single calls on the card == TorchBackend('cpu') "
        f"(exact; Spearman and mean within rtol = atol = {RQ_TOL}, at most "
        f"{worst:.3f} of it); the card's suite == its single calls")
    times = {rq: wall_s(fn) for rq, fn in card.items()}
    cpu_times = {rq: wall_s(fn, reps=1) for rq, fn in cpu.items()}
    busy = device_busy_share(card["suite"])
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
    log("  warm s on the card (CPU, one call): " + ", ".join(
        f"{rq} {times[rq]:.4f} ({cpu_times[rq]:.4f})" for rq in times))
    report = {
        "study": RQ_SPEC, "cutoff": RQ_CUTOFF,
        "min_projects": RQ_MIN_PROJECTS, "rows_generated": rows,
        "rows_extracted": extracted, "n_projects": arrays.n_projects,
        "generate_s": gen_s, "write_s": write_s, "extract_s": extract_s,
        "suite_cold_s": cold_suite_s,
        "card_s": times, "cpu_s": cpu_times,
        "suite_device_busy_share": busy,
        "peak_device_gib": peak, "tolerance_share_vs_cpu": worst,
        "reps": RQ_REPS, "golden_figures": golden_figures,
        "phase_s": time.perf_counter() - t_phase,
        "card": card_name_and_limit(),
    }
    print(json.dumps({"rq_path": report}), flush=True)
    drivers = rq_drivers(dev, path, corpus, arrays, got, limit_ns)
    return {"study": study, "path": path, "cfg": cfg, "arrays": arrays,
            "corpus": corpus, "all_out": os.path.join(RQ_DIR, "all_out"),
            "all_s": drivers["all_s"],
            "extract_s": extract_s, "suite": fused, "limit_ns": limit_ns,
            "card_results": got, "g1": g1, "g2": g2}


# Phase 3g: the mesh on one card.
MESH_DIR = os.path.join(ROOT, "build", "mesh_smoke")  # gitignored
MESH_RANKS = 4                # (m4): gloo ranks sharing the card
ALL_RANKS = 2                 # (h-m2): ranks running all (fewer than (m4)'s
                              # for the script's time)
MESH_CMIN_RANKS = 3           # (m3c): 16 bands pad one, 1M rows pad two
MESH_WARM_ROWS = 4_096        # each world's warm-up run, before the timed one
MESH_TIMEOUT_S = 300


def gloo_cuda_probe(mesh) -> dict:
    """Which of the collectives ``Mesh`` calls the gloo group takes on
    CUDA tensors: the Mesh stages none of them through host memory, so
    each must be taken."""
    dist = torch.distributed
    dev, w = mesh.device, mesh.size
    trials = {
        "all_reduce_sum_int32": lambda: dist.all_reduce(
            torch.ones(8, dtype=torch.int32, device=dev)),
        "all_reduce_min_int64": lambda: dist.all_reduce(
            torch.arange(8, device=dev), op=dist.ReduceOp.MIN),
        "all_to_all_single_int32": lambda: dist.all_to_all_single(
            torch.empty(4 * w, dtype=torch.int32, device=dev),
            torch.arange(4 * w, dtype=torch.int32, device=dev)),
        "all_gather_into_tensor_int32": lambda: dist.all_gather_into_tensor(
            torch.empty(3 * w, dtype=torch.int32, device=dev),
            torch.ones(3, dtype=torch.int32, device=dev)),
    }
    out = {}
    for name, fn in trials.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except RuntimeError as e:  # what gloo refuses is the probe's answer
            out[name] = f"refused: {e}"[:200]
    return out


def mesh_run(items, params, mesh, dev) -> dict:
    """One timed mesh run: the launch counts, the mesh's collective stats
    and peak device memory set to 0 just before and read just after."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    mesh.reset_stats()
    t0 = time.perf_counter()
    labels = pipeline.cluster_sessions(items, params, mesh=mesh, device=dev)
    wall = time.perf_counter() - t0
    info = dict(pipeline.last_run_info)
    stats = json.loads(json.dumps(mesh.stats))
    return {"labels": labels, "wall_s": wall,
            "launches": kernels.launch_counts(), "collectives": stats,
            "iterations": stats["pmin"]["calls"] // 2,
            "stages": info["stages"], "encoding": info["encoding"],
            "wire_mb": info.get("wire_mb"),
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}


def mesh_rank(spec: dict) -> int:
    """One rank of a phase 3g world (``chip_smoke.py --mesh-rank JSON``):
    start the world on the card, probe gloo if asked, warm up, then one
    timed run over the saved items; its labels and report go to files."""
    t0 = time.perf_counter()
    dev = multihost.init_world(spec["world"], spec["rank"], spec["init"],
                               spec["device"])
    mesh = make_mesh()
    report = {"rank": spec["rank"], "backend": mesh.backend,
              "device": torch.cuda.get_device_name(dev),
              "start_s": time.perf_counter() - t0}
    if mesh.device.type != torch.device(spec["device"]).type:
        raise AssertionError(f"rank on {mesh.device}")
    if spec["probe"]:
        report["gloo_cuda"] = gloo_cuda_probe(mesh)
    items = np.load(spec["items"], mmap_mode="r")
    params = pipeline.ClusterParams(**spec["params"])
    t1 = time.perf_counter()
    pipeline.cluster_sessions(items[:MESH_WARM_ROWS], params, mesh=mesh,
                              device=dev)
    report["warmup_s"] = time.perf_counter() - t1
    report["extension_load_s"] = _build.build_seconds
    run = mesh_run(items, params, mesh, dev)
    np.save(os.path.join(spec["out"], f"labels.r{spec['rank']}.npy"),
            run.pop("labels"))
    report.update(run)
    with open(os.path.join(spec["out"], f"report.r{spec['rank']}.json"),
              "w") as f:
        json.dump(report, f)
    multihost.shutdown()
    return 0


def build_state() -> dict:
    """mtime of every built library: a rank that rebuilt one changes it."""
    out = {}
    for d in (_build.BUILD_DIR, native.BUILD_DIR):
        for name in os.listdir(d):
            if name.endswith(".so") or name == "lock":
                out[os.path.join(d, name)] = os.stat(
                    os.path.join(d, name)).st_mtime_ns
    return out


def wait_all(procs: list, logs: list, what: str) -> float:
    """Wait for every child (killing all on the first failure or past the
    time limit); returns the wall from now."""
    t0 = time.perf_counter()
    try:
        for p, path in zip(procs, logs):
            rc = p.wait(timeout=MESH_TIMEOUT_S)
            if rc != 0:
                with open(path) as f:
                    tail = f.read()[-3000:]
                raise AssertionError(f"{what}: a child exited {rc}:\n{tail}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return time.perf_counter() - t0


def spawn(cmd: list, path: str, env=None) -> subprocess.Popen:
    with open(path, "w") as log_f:
        return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log_f,
                                stderr=subprocess.STDOUT)


def mesh_world(label: str, world: int, params: dict, items_path: str,
               dev, probe: bool = False) -> tuple:
    """A world of ``world`` ranks on the card, spawned from this script:
    (each rank's report, each rank's labels, the world's wall)."""
    d = fresh_dir(os.path.join(MESH_DIR, label))
    os.makedirs(d)
    procs, logs = [], []
    t0 = time.perf_counter()
    for r in range(world):
        spec = {"rank": r, "world": world, "init": f"file://{d}/rendezvous",
                "items": items_path, "params": params, "out": d,
                "probe": probe, "device": dev.type}
        logs.append(os.path.join(d, f"rank{r}.log"))
        procs.append(spawn([sys.executable, os.path.abspath(__file__),
                            "--mesh-rank", json.dumps(spec)], logs[-1]))
    wait_all(procs, logs, label)
    wall = time.perf_counter() - t0
    reports = []
    for r in range(world):
        with open(os.path.join(d, f"report.r{r}.json")) as f:
            reports.append(json.load(f))
    labels = [np.load(os.path.join(d, f"labels.r{r}.npy"))
              for r in range(world)]
    return reports, labels, wall


def cell_line(world: int, backend: str, wall: float, runs: list) -> dict:
    """A cell of the ``mesh`` line: world, backend, wall, and per rank the
    stages, collectives, iterations, launches and peak memory."""
    keep = ("wall_s", "stages", "collectives", "iterations", "launches",
            "peak_gib", "encoding", "wire_mb", "warmup_s", "start_s",
            "extension_load_s")
    return {"world": world, "backend": backend, "wall_s": wall,
            "ranks": [{k: r[k] for k in keep if k in r} for r in runs]}


def expect_mesh_labels(labels: list, want, label: str) -> None:
    for r, got in enumerate(labels):
        if not np.array_equal(got, want):
            raise AssertionError(f"{label}: rank {r}'s labels differ from "
                                 "the single-device run's")
    log(f"  {label}: every rank's labels == the single-device run's, "
        "element for element")


def mesh_m1(items, want, dev) -> dict:
    """(m1): a world of 1 on NCCL in this process, the host feed (the
    24-bit pack, kernel 3) and the pre-sharded feed (raw ids on the card,
    kernel 1), each == (b)'s labels."""
    rendezvous = os.path.join(MESH_DIR, "m1.rendezvous")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    init = f"file://{rendezvous}"
    t0 = time.perf_counter()
    multihost.init_world(1, 0, init, dev)
    try:
        mesh = make_mesh()
        if mesh.backend != ("nccl" if dev.type == "cuda" else "gloo"):
            raise AssertionError(f"a world of 1 on {dev} runs on "
                                 f"{mesh.backend}")
        params = pipeline.ClusterParams(prefilter="off")
        pipeline.cluster_sessions(items[:MESH_WARM_ROWS], params, mesh=mesh,
                                  device=dev)
        host = mesh_run(items, params, mesh, dev)
        expect_launches(host["launches"], {"minhash_and_keys_packed": 1})
        expect_mesh_labels([host.pop("labels")], want, "(m1) host feed")
        rows, _ = multihost.put_process_local_padded(items, N_SESSIONS, mesh)
        pre = mesh_run(rows, params, mesh, dev)
        del rows
        expect_launches(pre["launches"], {"minhash_and_keys": 1})
        expect_mesh_labels([pre.pop("labels")[:N_SESSIONS]], want,
                           "(m1) pre-sharded feed")
    finally:
        torch.distributed.destroy_process_group()
    wall = time.perf_counter() - t0
    log(f"  (m1) {mesh.backend} world of 1: host feed {host['wall_s']:.3f} s "
        f"({host['iterations']} iterations), pre-sharded "
        f"{pre['wall_s']:.3f} s")
    return {"host": cell_line(1, mesh.backend, host["wall_s"], [host]),
            "presharded": cell_line(1, mesh.backend, pre["wall_s"], [pre]),
            "world_s": wall}


def start_world(label: str, args: list, ranks: int = MESH_RANKS,
                **env) -> dict:
    """``python -m tse1m_tpu_torch ARGS`` started as each rank of a world
    of ``ranks`` under the TSE1M_* variables (a ``file://`` rendezvous in
    a fresh build/mesh_smoke/LABEL); :func:`wait_world` ends it."""
    d = fresh_dir(os.path.join(MESH_DIR, label))
    os.makedirs(d)
    procs, logs = [], []
    t0 = time.perf_counter()
    for r in range(ranks):
        logs.append(os.path.join(d, f"rank{r}.log"))
        procs.append(spawn(
            [sys.executable, "-m", "tse1m_tpu_torch", *args], logs[-1],
            dict(os.environ, TSE1M_COORDINATOR=f"file://{d}/rendezvous",
                 TSE1M_NUM_PROCESSES=str(ranks),
                 TSE1M_PROCESS_ID=str(r), **env)))
    return {"dir": d, "procs": procs, "logs": logs, "t0": t0,
            "what": f"{args[0]} under TSE1M_*"}


def check_world(world: dict | None) -> None:
    """Raise at once if a rank of a running world has already failed."""
    if world is None:
        return
    for p, path in zip(world["procs"], world["logs"]):
        if p.poll() not in (None, 0):
            stop_world(world)
            with open(path) as f:
                raise AssertionError(f"{world['what']}: a rank exited "
                                     f"{p.returncode}:\n{f.read()[-3000:]}")


def stop_world(world: dict) -> None:
    for p in world["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()


def wait_world(world: dict) -> tuple:
    """(the world's directory, the wall from the spawn to the last rank's
    exit, whether every rank had exited before this wait began: the wall
    is then an upper bound)."""
    ended = all(p.poll() is not None for p in world["procs"])
    wait_all(world["procs"], world["logs"], world["what"])
    return world["dir"], time.perf_counter() - world["t0"], ended


def world_commands(label: str, args: list, ranks: int = MESH_RANKS,
                   **env) -> tuple:
    """:func:`start_world` then :func:`wait_world`: (directory, wall)."""
    return wait_world(start_world(label, args, ranks, **env))[:2]


def mesh_cli(truth, want) -> dict:
    """(m4) through the command line: four ``cluster --n 1000000`` ranks
    under the TSE1M_* variables; the merged run_manifest.json holds four
    fragments and the single-device run's clusters and ARI."""
    out = os.path.join(MESH_DIR, "cli", "out")
    _, wall = world_commands(
        "cli", ["cluster", "--n", str(N_SESSIONS), "--ari-sample", "0"],
        TSE1M_RESULT_DIR=out)
    with open(os.path.join(out, "run_manifest.json")) as f:
        merged = json.load(f)
    n_clusters = int(np.unique(want).size)
    ari = round(float(adjusted_rand_index(want, truth)), 5)
    steps = merged["steps"]
    if not (merged["ok"] and merged["pod"]["merged_from"]
            == list(range(MESH_RANKS)) and not merged["pod"]["missing"]
            and [s["process"] for s in steps] == list(range(MESH_RANKS))):
        raise AssertionError(f"merged manifest: {merged['pod']}, ok "
                             f"{merged['ok']}")
    for s in steps:
        res = s["result"]
        if (res["n_clusters"], res["ari_vs_planted"], res["encoding"],
                res["processes"]) != (n_clusters, ari, "mesh-presharded",
                                      MESH_RANKS):
            raise AssertionError(f"rank {s['process']}: {res}, want "
                                 f"{n_clusters} clusters, ARI {ari}")
    log(f"  (m4) {MESH_RANKS} cluster commands: {wall:.3f} s, merged "
        f"run_manifest.json from {MESH_RANKS} fragments, {n_clusters} "
        f"clusters and ARI {ari} == the single-device run's")
    stage_keys = ("cluster_wall_s", "stage_encode_s", "stage_h2d_s",
                  "stage_compute_s", "stage_d2h_s")
    return {"world": MESH_RANKS, "backend": "gloo", "wall_s": wall,
            "n_clusters": n_clusters, "ari_vs_planted": ari,
            "fragments": len(merged["pod"]["merged_from"]),
            "ranks": [{k: s["result"].get(k) for k in stage_keys}
                      for s in steps]}


def mesh_phase(items, truth, want, dev) -> dict:
    """Phase 3g, first part: (m1), (m4) in a spawned world and through the
    command line, (m3c).  Returns the ``mesh`` line's cells so far and the
    kernels' launches."""
    t_phase = time.perf_counter()
    os.makedirs(MESH_DIR, exist_ok=True)
    cells = {"m1": mesh_m1(items, want, dev)}
    items_path = os.path.join(MESH_DIR, "items.npy")
    np.save(items_path, items)
    torch.cuda.empty_cache()
    before = build_state()

    reports, labels, wall = mesh_world(
        "m4", MESH_RANKS, {"prefilter": "off"}, items_path, dev,
        probe=True)
    probe = reports[0]["gloo_cuda"]
    log(f"  gloo on CUDA tensors: {probe}")
    refused = {k: v for r in reports for k, v in r["gloo_cuda"].items()
               if v != "ok"}
    if refused:
        raise AssertionError(f"gloo refuses collectives the Mesh calls on "
                             f"the card: {refused}")
    for r in reports:
        if r["backend"] != "gloo":
            raise AssertionError(f"rank {r['rank']} on {r['backend']}")
        expect_launches(r["launches"], {"minhash_and_keys_packed": 1})
    expect_mesh_labels(labels, want, f"(m4) {MESH_RANKS} gloo ranks")
    cells["m4"] = cell_line(MESH_RANKS, "gloo", wall, reports)
    log(f"  (m4) world {wall:.3f} s; rank walls "
        + ", ".join(f"{r['wall_s']:.3f}" for r in reports) + " s")
    cells["m4_cli"] = mesh_cli(truth, want)

    cmin_want = pipeline.cluster_sessions(items, params_for(-1, "cminhash"),
                                          device=dev)
    reports, labels, wall = mesh_world(
        "m3c", MESH_CMIN_RANKS, {"prefilter": "off", "scheme": "cminhash"},
        items_path, dev)
    for r in reports:
        expect_launches(r["launches"], {"cminhash_binmin": 1})
        if r["encoding"] != "mesh-pack24":
            raise AssertionError(f"(m3c) feed {r['encoding']}")
    expect_mesh_labels(labels, cmin_want,
                       f"(m3c) {MESH_CMIN_RANKS} gloo ranks, cminhash")
    cells["m3c"] = cell_line(MESH_CMIN_RANKS, "gloo", wall, reports)
    os.remove(items_path)
    launches: dict = {}
    for cell in (cells["m1"]["host"], cells["m1"]["presharded"],
                 cells["m4"], cells["m3c"]):
        for rank in cell["ranks"]:
            add_counts(launches, rank["launches"])
    return {"cells": cells, "gloo_cuda": probe,
            "build_before": before, "launches": launches,
            "phase_s": time.perf_counter() - t_phase}


def start_mesh_all(rq: dict) -> dict:
    """Phase 3g, (h-m2), started: ALL_RANKS ranks run ``all`` over phase
    4's study under the TSE1M_* variables and TSE1M_BACKEND=auto."""
    return start_world(
        "all", ["all", "--db", rq["path"], "--result-dir",
                os.path.join(MESH_DIR, "all", "out"), "--limit-date",
                RQ_CUTOFF, "--corpus-csv", rq["corpus"]],
        ALL_RANKS, TSE1M_BACKEND="auto")


def mesh_all(rq: dict, mesh: dict, world: dict, beside: str) -> dict:
    """Phase 3g, (h-m2), waited for: rank 0 of ``world`` wrote phase 4's
    single-rank file set, its CSVs byte for byte, and each driver's
    manifest notes that ``auto`` gave the device engine.  ``beside`` names
    the phase this process ran meanwhile: the wall is the world's with it,
    not comparable with a world alone.  Prints the ``mesh`` line."""
    t_phase = time.perf_counter()
    out = os.path.join(MESH_DIR, "all", "out")
    _, wall, ended = wait_world(world)
    after = build_state()
    if after != mesh["build_before"]:
        raise AssertionError(f"a rank rebuilt a library or left a lock: "
                             f"{mesh['build_before']} -> {after}")
    want_files, got_files = {}, {}
    for root, files in ((rq["all_out"], want_files), (out, got_files)):
        for base, _, names in os.walk(root):
            for n in names:
                if not n.endswith(".json"):
                    path = os.path.join(base, n)
                    files[os.path.relpath(path, root)] = path
    if sorted(want_files) != sorted(got_files):
        raise AssertionError(f"(h-m2) files {sorted(got_files)} != phase "
                             f"4's {sorted(want_files)}")
    csvs = [rel for rel in want_files if rel.endswith(".csv")]
    for rel in csvs:
        with open(want_files[rel], "rb") as f, \
                open(got_files[rel], "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"(h-m2) {rel} differs from phase 4's")
    run = check_drivers_ran(out, torch.device("cuda", 0), "h-m2 rank 0")
    # backend=auto in a world of several ranks: the device engine, noted.
    for name, rel in DRIVER_MANIFESTS.items():
        with open(os.path.join(out, rel)) as f:
            note = json.load(f).get("auto_resolution")
        if note != {"backend": "auto", "engine": "device",
                    "world_size": ALL_RANKS}:
            raise AssertionError(f"(h-m2) {name} under auto: {note}")
    log(f"  (h-m2) all as {ALL_RANKS} ranks: {wall:.3f} s with {beside} "
        f"beside it{', at most: the ranks ended first' if ended else ''} "
        f"(phase 4's single rank {rq['all_s']:.3f} s), every step ok, "
        f"phase 4's {len(want_files)} files, its {len(csvs)} CSVs byte for "
        "byte, auto on the device engine")
    cells = dict(mesh["cells"])
    cells["h_m2"] = {"world": ALL_RANKS, "backend": "gloo", "all_s": wall,
                     "beside": beside, "all_s_upper_bound": ended,
                     "phase4_all_s": rq["all_s"],
                     "files": len(want_files), "csvs_equal": len(csvs),
                     "steps_s": {s["name"]: s["wall_s"]
                                 for s in run["steps"]}}
    line = {"gloo_cuda": mesh["gloo_cuda"], "cells": cells,
            "libraries_unchanged": sorted(after),
            "phase_s": mesh["phase_s"] + time.perf_counter() - t_phase,
            "card": card_name_and_limit()}
    print(json.dumps({"mesh": line}), flush=True)
    return line


# Phase 3h: the pod on one card.
POD_DIR = os.path.join(ROOT, "build", "pod_smoke")  # gitignored
POD_PROCESSES = 2
POD_FAULT_ROWS = 100_000      # (p-kill), (p-lead), (p-zombie): cut from 1M
POD_ZOMBIE_STALL_S = 240.0    # the zombie's wedge, unless woken first
POD_TIMEOUT_S = 180
# Fast beats, a loss declared in seconds: JAX's tests/pod_harness.py:29-34.
POD_ENV = {"TSE1M_HEARTBEAT_INTERVAL_S": "0.2",
           "TSE1M_HEARTBEAT_TIMEOUT_S": "5",
           "TSE1M_WATCHDOG": "0"}


def pod_rank(spec: dict) -> int:
    """One process of a phase 3h (p2) pod (``chip_smoke.py --pod-rank
    JSON``), its identity from TSE1M_NUM_PROCESSES/TSE1M_PROCESS_ID: load
    the built libraries, then ``run_pod_cluster`` (the ``cluster``
    command's pod route) over the saved rows as the ``pod-cluster`` step of
    a manifest fragment, the launch counts and peak device memory set to 0
    just before and read just after; the step closes as the command's does
    (``close_cluster_step``: process 0, or the failover survivor, merges
    the fragments).  Its labels and report go to files."""
    import faulthandler

    from tse1m_tpu_torch.__main__ import close_cluster_step, run_pod_cluster
    from tse1m_tpu_torch.utils.runner import StepRunner

    # A hung child's threads go to its transcript when the parent gives up.
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    t0 = time.perf_counter()
    dev = torch.device(spec["device"])
    _build.load_extension()
    nproc, pid = multihost.pod_process_env()
    report = {"process": pid, "extension_load_s": _build.build_seconds,
              "start_s": time.perf_counter() - t0}
    items = np.ascontiguousarray(np.load(spec["items"], mmap_mode="r")[
        :spec["rows"]])
    params = pipeline.ClusterParams(n_hashes=N_HASHES, n_bands=N_BANDS,
                                    sig_store=spec["store"])
    runner = StepRunner(fragment_manifest_path(spec["out"], pid))
    box: dict = {}

    def step() -> None:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t1 = time.perf_counter()
        labels, pod = run_pod_cluster(items, spec["rows"], params,
                                      device=dev)
        torch.cuda.synchronize()
        box.update(labels=labels, pod=pod,
                   wall_s=time.perf_counter() - t1,
                   launches=kernels.launch_counts(),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   info=dict(pipeline.last_run_info))

    rec = runner.run("pod-cluster", step)
    result: dict = {}
    if box:
        info = box["info"]
        report.update(
            wall_s=box["wall_s"], launches=box["launches"],
            peak_gib=box["peak_gib"], stages=info["stages"],
            chunk_bits=info.get("chunk_bits", []))
        report.update({k: v for k, v in info.items()
                       if k.startswith(("cache_", "pod_"))})
        report.update(box["pod"])
        result = {k: v for k, v in report.items() if k != "stages"}
        np.save(os.path.join(spec["out"], f"labels.p{pid}.npy"),
                box["labels"])
    report.update(status=rec.status, error=rec.error)
    close_cluster_step(runner, rec, result, spec["out"], nproc, pid,
                       pod_route=True)
    with open(os.path.join(spec["out"], f"report.p{pid}.json"), "w") as f:
        json.dump(report, f)
    return 0 if rec.status == "ok" else 1


def pod_cli(spec: dict) -> int:
    """One process of a phase 3h fault cell (``chip_smoke.py --pod-cli
    JSON``): the ``cluster`` command itself (``tse1m_tpu_torch.__main__.
    main``) over its own ``spec["rows"]`` synthesized sessions with
    ``--sig-store``, under TSE1M_NUM_PROCESSES/TSE1M_PROCESS_ID and a
    TSE1M_COORDINATOR a world would meet at, so a wrong route would start
    one.  ``_cluster_labels`` is wrapped to record the route it was given
    and whether a world is up, and to keep its labels, launch counts
    (set to 0 just before), peak device memory and stages; the command's
    printed report, its exit code, its step's error and whether a world
    is up after it go to a file."""
    import faulthandler

    import tse1m_tpu_torch.__main__ as cli

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    t0 = time.perf_counter()
    t0_epoch = time.time()
    _build.load_extension()
    nproc, pid = multihost.pod_process_env()
    report = {"process": pid, "extension_load_s": _build.build_seconds,
              "t0_epoch": t0_epoch}
    real = cli._cluster_labels

    def keep(args, items, params, dev, distributed, pod_route=False,
             pod_report=None):
        report.update(start_s=time.perf_counter() - t0, route={
            "pod": pod_route, "distributed": distributed,
            "world": torch.distributed.is_initialized()})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t1 = time.perf_counter()
        labels = real(args, items, params, dev, distributed, pod_route,
                      pod_report)
        torch.cuda.synchronize()
        report.update(wall_s=time.perf_counter() - t1,
                      launches=kernels.launch_counts(),
                      peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                      stages=dict(pipeline.last_run_info["stages"]),
                      chunk_bits=pipeline.last_run_info.get("chunk_bits", []))
        np.save(os.path.join(spec["out"], f"labels.p{pid}.npy"), labels)
        report["labels_at_s"] = time.perf_counter() - t0
        return labels

    cli._cluster_labels = keep
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(["cluster", "--n", str(spec["rows"]), "--seed", "0",
                       "--sig-store", spec["store"], "--ari-sample", "0",
                       "--device", spec["device"]])
    sys.stdout.write(printed.getvalue())
    report.update(rc=rc, world_after=torch.distributed.is_initialized(),
                  command_done_s=time.perf_counter() - t0)
    if rc == 0:
        report.update(json.loads(printed.getvalue().strip().splitlines()[-1]))
    with open(fragment_manifest_path(spec["out"], pid)) as f:
        report["error"] = json.load(f)["steps"][-1]["error"]
    with open(os.path.join(spec["out"], f"report.p{pid}.json"), "w") as f:
        json.dump(report, f)
    return rc


def pod_spawn(label: str, rows: int, items_path: str | None, dev,
              plans: dict | None = None, store: str | None = None) -> dict:
    """A pod of POD_PROCESSES children, their fragments and transcripts in
    a fresh build/pod_smoke/LABEL, into ``store`` (default: a fresh root
    there); ``plans``: process -> fault plan.  With ``items_path`` the
    children are ``--pod-rank`` over its first ``rows`` saved rows, without
    it ``--pod-cli``: the ``cluster`` command over ``rows`` of its own
    sessions, a free coordinator port in the environment."""
    d = fresh_dir(os.path.join(POD_DIR, label))
    os.makedirs(d)
    spec = {"items": items_path, "rows": rows, "device": dev.type,
            "store": store or os.path.join(d, "root"), "out": d}
    mode = "--pod-rank" if items_path else "--pod-cli"
    base = dict(os.environ, TSE1M_NUM_PROCESSES=str(POD_PROCESSES), **POD_ENV)
    for k in ("TSE1M_COORDINATOR", "TSE1M_FAULT_PLAN"):
        base.pop(k, None)
    if not items_path:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            base.update(TSE1M_COORDINATOR=f"localhost:"
                        f"{sock.getsockname()[1]}", TSE1M_RESULT_DIR=d)
    procs, logs = [], []
    for pid in range(POD_PROCESSES):
        env = dict(base, TSE1M_PROCESS_ID=str(pid))
        if plans and pid in plans:
            env["TSE1M_FAULT_PLAN"] = FaultPlan.from_dict(
                plans[pid]).save(os.path.join(d, f"plan.p{pid}.json"))
        logs.append(os.path.join(d, f"p{pid}.log"))
        procs.append(spawn([sys.executable, os.path.abspath(__file__),
                            mode, json.dumps(spec)], logs[-1], env))
    return {"label": label, "dir": d, "store": spec["store"],
            "procs": procs, "logs": logs, "t0": time.perf_counter(),
            "t0_epoch": time.time(), "exit_s": [None] * POD_PROCESSES}


def pod_wait(cells: list, ticks=()) -> None:
    """Poll every cell's children until all have exited (each exit time
    kept), calling each of ``ticks`` every poll; past POD_TIMEOUT_S the
    rest are killed and the phase fails."""
    deadline = time.perf_counter() + POD_TIMEOUT_S
    try:
        while True:
            for tick in ticks:
                tick()
            busy = False
            for c in cells:
                for i, p in enumerate(c["procs"]):
                    if p.poll() is None:
                        busy = True
                    elif c["exit_s"][i] is None:
                        c["exit_s"][i] = time.perf_counter() - c["t0"]
            if not busy:
                return
            if time.perf_counter() > deadline:
                hung = [(c, i, p) for c in cells
                        for i, p in enumerate(c["procs"]) if p.poll() is None]
                for _, _, p in hung:
                    p.send_signal(signal.SIGUSR1)  # dump its stacks
                time.sleep(2.0)
                tails = []
                for c, i, _ in hung:
                    with open(c["logs"][i]) as f:
                        tails.append(f"--- {c['label']} p{i}\n"
                                     f"{f.read()[-4000:]}")
                raise AssertionError(
                    f"pod: children still running after {POD_TIMEOUT_S} s:"
                    "\n" + "\n".join(tails))
            time.sleep(0.1)
    finally:
        for c in cells:
            for p in c["procs"]:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def pod_results(cell: dict) -> list:
    """Each child's (exit code, report or None, labels or None)."""
    out = []
    for pid, p in enumerate(cell["procs"]):
        path = os.path.join(cell["dir"], f"report.p{pid}.json")
        rep = None
        if os.path.exists(path):
            with open(path) as f:
                rep = json.load(f)
        lab = os.path.join(cell["dir"], f"labels.p{pid}.npy")
        out.append((p.returncode, rep,
                    np.load(lab) if os.path.exists(lab) else None))
    return out


def pod_fail(cell: dict, what: str) -> None:
    tails = []
    for path in cell["logs"]:
        with open(path) as f:
            tails.append(f"--- {os.path.basename(path)}\n{f.read()[-3000:]}")
    raise AssertionError(f"({cell['label']}) {what}\n" + "\n".join(tails))


def pod_manifest(cell: dict) -> dict:
    with open(os.path.join(cell["dir"], "run_manifest.json")) as f:
        return json.load(f)


def exchanged_bytes(store: str) -> int:
    """Bytes of the last run's exchange files under the pod directory."""
    pod = os.path.join(store, "pod")
    return sum(os.path.getsize(os.path.join(pod, x, name))
               for x in os.listdir(pod) if x.startswith("xch_")
               for name in os.listdir(os.path.join(pod, x))
               if name.endswith(".npz"))


def pod_stages(rep: dict) -> dict:
    """A process's walls by the pod path's steps: the novel tail's MinHash
    is its encode, h2d, compute and d2h stages."""
    st = rep["stages"]
    return {"wall_s": rep["wall_s"],
            "probe_s": st.get("stage_probe_s", 0.0),
            "load_s": st.get("stage_load_s", 0.0),
            "minhash_s": sum(st.get(f"stage_{k}_s", 0.0)
                             for k in ("encode", "h2d", "compute", "d2h")),
            "exchange_s": st.get("stage_exchange_s", 0.0),
            "append_s": st.get("stage_append_s", 0.0),
            "tail_s": st.get("stage_tail_s", 0.0),
            "start_s": rep["start_s"], "peak_gib": rep["peak_gib"],
            "launches": rep["launches"], "novel_chunks": len(
                rep["chunk_bits"])}


def expect_novel_launches(counts: dict, chunks: int) -> None:
    """One MinHash launch (either kernel) a novel chunk, the rANS kernel
    where the entropy gate codes one, nothing else."""
    expect_launches(counts, {"minhash_and_keys": (0, chunks),
                             "minhash_and_keys_packed": (0, chunks),
                             "rans_decode": (0, None)})
    hashed = (counts.get("minhash_and_keys", 0)
              + counts.get("minhash_and_keys_packed", 0))
    if hashed != chunks:
        raise AssertionError(f"{hashed} MinHash launches for {chunks} "
                             "novel chunks")


def pod_clean(label: str, rows: int, items_path: str, want, dev,
              store: str | None = None) -> dict:
    """(p2)'s cold or warm run: both processes ok, each one's labels
    ``want`` element for element, MinHash launches only for its novel
    tail's chunks (the rANS kernel where the entropy gate codes one), the
    merged manifest of both fragments at the membership epoch."""
    cell = pod_spawn(label, rows, items_path, dev, store=store)
    pod_wait([cell])
    wall = max(cell["exit_s"])
    res = pod_results(cell)
    for pid, (rc, rep, lab) in enumerate(res):
        if rc != 0 or lab is None:
            pod_fail(cell, f"process {pid} exited {rc}")
        if not np.array_equal(lab, want):
            raise AssertionError(f"({label}) process {pid}'s labels differ "
                                 "from the storeless unquantized run's "
                                 f"({int((lab != want).sum())} rows)")
        expect_novel_launches(rep["launches"], len(rep["chunk_bits"]))
        if rep.get("pod_survivor") is not None:
            pod_fail(cell, f"process {pid} failed over")
    m = pod_manifest(cell)
    if not (m["ok"] and m["pod"]["merged_from"] == [0, 1]
            and not m["pod"]["missing"]
            and m["pod"]["epoch"] == res[0][1]["pod_epoch"]
            and {s["process"] for s in m["steps"]} == {0, 1}):
        raise AssertionError(f"({label}) merged manifest {m['pod']}, ok "
                             f"{m['ok']}")
    reps = [r[1] for r in res]
    line = {"rows": rows, "wall_s": wall,
            "hit_rate": reps[0]["cache_hit_rate"],
            "novel_rows": reps[0]["cache_novel_rows"],
            "appended_rows": [r["pod_appended_rows"] for r in reps],
            "exchanged_bytes": exchanged_bytes(cell["store"]),
            "epoch": reps[0]["pod_epoch"],
            "processes": [pod_stages(r) for r in reps]}
    log(f"  ({label}) {rows} rows as 2 processes: {wall:.3f} s, hit rate "
        f"{line['hit_rate']}, {line['novel_rows']} novel rows, "
        f"{line['exchanged_bytes']} B exchanged; both processes' labels == "
        "the storeless unquantized run's; merged manifest of 2 fragments "
        f"at epoch {line['epoch']}")
    for r in line["processes"]:
        log(f"    {json.dumps(r)}")
    return line


def root_fingerprint(store: str) -> dict:
    """Every file of a pod root outside pod/ (the ranges and their
    leases): path -> (bytes, content hash)."""
    import hashlib

    out = {}
    for base, dirs, names in os.walk(store):
        dirs[:] = [x for x in dirs if x != "pod"]
        for n in names:
            path = os.path.join(base, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, store)] = (
                    os.path.getsize(path),
                    hashlib.sha256(f.read()).hexdigest())
    return out


def pod_faults(want, dev) -> dict:
    """(p-kill), (p-lead) and (p-zombie): the ``cluster`` command at
    POD_FAULT_ROWS of its own sessions, the three pods at once."""
    kill = {"rules": [{"site": "pipeline.h2d", "kind": "kill"}]}
    zdir = fresh_dir(os.path.join(POD_DIR, "zombie_wake"))
    os.makedirs(zdir)
    wake = os.path.join(zdir, "wake")
    zombie_plan = {"rules": [{"site": "pipeline.h2d", "kind": "zombie",
                              "stall_s": POD_ZOMBIE_STALL_S,
                              "wake_path": wake}]}
    cells = {
        "p-kill": pod_spawn("p-kill", POD_FAULT_ROWS, None, dev, {1: kill}),
        "p-lead": pod_spawn("p-lead", POD_FAULT_ROWS, None, dev, {0: kill}),
        "p-zombie": pod_spawn("p-zombie", POD_FAULT_ROWS, None, dev,
                              {1: zombie_plan})}
    zombie = cells["p-zombie"]
    membership = os.path.join(zombie["store"], "pod", "membership.json")
    seen: dict = {}

    def wake_zombie() -> None:
        # Wake the zombie once the survivor has advanced the epoch and
        # exited, the root's bytes taken first.
        if "root" in seen or not os.path.exists(membership):
            return
        try:
            with open(membership) as f:
                epoch = int(json.load(f)["epoch"])
        except (OSError, ValueError, KeyError):
            return
        if epoch >= 1 and zombie["procs"][0].poll() is not None:
            seen["root"] = root_fingerprint(zombie["store"])
            seen["woken_s"] = time.perf_counter() - zombie["t0"]
            open(wake, "w").close()

    pod_wait(list(cells.values()), ticks=(wake_zombie,))
    out = {}
    for label, dead in (("p-kill", 1), ("p-lead", 0), ("p-zombie", 1)):
        cell = cells[label]
        res = pod_results(cell)
        live = 1 - dead
        rc, rep, lab = res[live]
        if rc != 0 or lab is None:
            pod_fail(cell, f"the survivor (process {live}) exited {rc}")
        for _, r, _ in res:
            # The pod route, no torch.distributed world, though a
            # coordinator was given.
            if r and (r["route"] != {"pod": True, "distributed": False,
                                     "world": False} or r["world_after"]):
                pod_fail(cell, f"process {r['process']} took the route "
                         f"{r['route']}, a world after it {r['world_after']}")
        if not np.array_equal(lab, want):
            raise AssertionError(f"({label}) the survivor's labels differ "
                                 "from the command's storeless run's")
        if not (rep["pod_survivor"] == live and rep["pod_lost"] == [dead]
                and rep["pod_epoch"] == 1 and dead in
                rep["pod_reassigned_ranges"]
                and rep["pod_promoted_leader"] == (dead == 0)):
            pod_fail(cell, f"survivor report {rep}")
        m = pod_manifest(cell)
        counts = m["degradation_counts"]
        kinds = ["host_lost", "pod_failover", "shard_range_reassigned",
                 "epoch_advance"] + (["leader_promoted"] if dead == 0
                                     else [])
        if any(counts.get(k, 0) < 1 for k in kinds) or \
                m["pod"]["epoch"] != 1:
            raise AssertionError(f"({label}) merged manifest: {counts}, "
                                 f"{m['pod']}")
        dead_rc, dead_rep = res[dead][0], res[dead][1]
        if label == "p-zombie":
            if not (dead_rc == 1 and dead_rep and "LeaseSupersededError"
                    in (dead_rep["error"] or "") and res[dead][2] is None):
                pod_fail(cell, f"the zombie exited {dead_rc}: {dead_rep}")
            with open(fragment_manifest_path(cell["dir"], dead)) as f:
                frag = json.load(f)
            if frag["degradation_counts"].get("lease_superseded", 0) < 1:
                raise AssertionError(f"zombie fragment {frag}")
            if "root" not in seen or \
                    root_fingerprint(cell["store"]) != seen["root"]:
                raise AssertionError("the zombie changed the pod root")
            extra = {"woken_s": seen["woken_s"], "zombie_rows_appended": 0}
        else:
            if dead_rc != -9:
                pod_fail(cell, f"process {dead} exited {dead_rc}, not "
                         "SIGKILL")
            extra = {}
        out[label] = {"rows": POD_FAULT_ROWS, "wall_s": max(cell["exit_s"]),
                      "survivor": live, "survivor_exit_s":
                      cell["exit_s"][live], "epoch": rep["pod_epoch"],
                      "degradation_counts": counts,
                      "survivor_stages": pod_stages(rep),
                      # The survivor's timeline from its spawn: imports
                      # done, labels back, the command returned.
                      "survivor_timeline_s": {
                          "imported": rep["t0_epoch"] - cell["t0_epoch"],
                          "labels": rep["t0_epoch"] - cell["t0_epoch"]
                          + rep["labels_at_s"],
                          "command": rep["t0_epoch"] - cell["t0_epoch"]
                          + rep["command_done_s"]}, **extra}
        log(f"  ({label}) process {dead} "
            + ("wedged then woken" if label == "p-zombie" else "SIGKILLed")
            + f" at pipeline.h2d: process {live} failed over at epoch "
            f"{rep['pod_epoch']} in {cell['exit_s'][live]:.3f} s"
            + (", promoted to leader" if dead == 0 else "")
            + ", labels == the command's storeless run's, no world; merged "
            "manifest "
            f"{json.dumps(counts)}"
            + ("; the zombie fenced with LeaseSupersededError, the root's "
               "bytes unchanged by it" if label == "p-zombie" else ""))
    return out


def pod_phase(warm: dict, dev) -> dict:
    """Phase 3h: the pod on one card.  Prints the ``pod`` line; returns
    the children's launches of the (p2) runs."""
    t_phase = time.perf_counter()
    os.makedirs(POD_DIR, exist_ok=True)
    items = warm["items"]
    items_path = os.path.join(POD_DIR, "items.npy")
    np.save(items_path, items)
    wants = {}
    for rows in (WARM_BASE, WARM_ROWS):
        wants[rows] = pipeline.cluster_sessions(items[:rows],
                                                params_for(-1), device=dev)
    # The fault cells' reference: the ``cluster`` command's sessions under
    # its params, without the store.
    want_cli = pipeline.cluster_sessions(
        synth_session_sets(POD_FAULT_ROWS, seed=0)[0],
        pipeline.ClusterParams(seed=0), device=dev)
    torch.cuda.empty_cache()
    cold = pod_clean("p2-cold", WARM_BASE, items_path, wants[WARM_BASE],
                     dev)
    if cold["hit_rate"] != 0.0:
        raise AssertionError(f"(p2-cold) hit rate {cold['hit_rate']}")
    warm_run = pod_clean("p2-warm", WARM_ROWS, items_path, wants[WARM_ROWS],
                         dev, store=os.path.join(POD_DIR, "p2-cold", "root"))
    if warm_run["hit_rate"] != warm["hit_rate"]:
        raise AssertionError(f"(p2-warm) hit rate {warm_run['hit_rate']}, "
                             f"phase 3b's run 2 {warm['hit_rate']}")
    log(f"  (p2-warm) hit rate {warm_run['hit_rate']} == phase 3b's "
        "single-process run 2's")
    faults = pod_faults(want_cli, dev)
    os.remove(items_path)
    launches: dict = {}
    for run in (cold, warm_run):
        for proc in run["processes"]:
            add_counts(launches, proc["launches"])
    line = {"processes": POD_PROCESSES,
            "heartbeat": {"interval_s": float(
                POD_ENV["TSE1M_HEARTBEAT_INTERVAL_S"]), "timeout_s": float(
                POD_ENV["TSE1M_HEARTBEAT_TIMEOUT_S"])},
            "cells": {"p2_cold": cold, "p2_warm": warm_run, **{
                k.replace("-", "_"): v for k, v in faults.items()}},
            "launches": launches,
            "phase_s": time.perf_counter() - t_phase,
            "card": card_name_and_limit()}
    print(json.dumps({"pod": line}), flush=True)
    return line


# Phase 4b: cell (h) arrives as the collectors' CSVs and as a pg_dump.
LOAD_DIR = os.path.join(ROOT, "build", "load_smoke")  # gitignored
LOAD_TABLES = ("project_info", "buildlog_data", "total_coverage", "issues")
DELTA_MAX_DIFFS = 16          # encode_delta's default, under S = 64's clamp
DELTA_PROBES = 3


def copy_text(v) -> str:
    """One cell in COPY's text format, as pg_dump writes it: ``\\N`` for
    NULL; backslash, tab, newline and carriage return escaped."""
    if v is None:
        return "\\N"
    s = repr(v) if isinstance(v, float) else str(v)
    return (s.replace("\\", "\\\\").replace("\t", "\\t")
            .replace("\n", "\\n").replace("\r", "\\r"))


def project_yaml(study) -> list:
    """Each project's YAML keys, the dump's ``yaml_json`` cells: a tab, a
    newline and a backslash in each, so every COPY escape is restored."""
    return [f"language: {lang}\n\tmain_repo: {repo}\\"
            for lang, repo in zip(study.project_info["language"],
                                  study.project_info["main_repo"])]


def write_pg_dump(study, path: str) -> dict:
    """Cell (h) as pg_dump writes its tables: comment, SET, CREATE TABLE
    and ALTER noise, one COPY block a study table (no ``projects``: restore
    derives it), the reference analyzer's 'Success' where the study says
    'Finish' (restore canonicalises it), NULL for an empty regressed-build
    array, the projects' YAML keys with escapes, and a block of a table
    outside the study.  Returns the rows written a table."""
    rows = {}
    with open(path, "w", encoding="utf-8") as f:
        f.write("--\n-- PostgreSQL database dump\n--\n\n"
                "SET statement_timeout = 0;\n"
                "SET client_encoding = 'UTF8';\n"
                "SET standard_conforming_strings = on;\n"
                "CREATE TABLE public.buildlog_data (\n    name text NOT NULL,"
                "\n    modules text[],\n    revisions text[]\n);\n"
                "ALTER TABLE public.buildlog_data OWNER TO replication_user;\n"
                "\n")
        for table in LOAD_TABLES:
            cols = dict(getattr(study, table))
            if table == "project_info":
                cols["yaml_json"] = project_yaml(study)
            elif table == "buildlog_data":
                cols["result"] = ["Success" if r == "Finish" else r
                                  for r in cols["result"]]
            elif table == "issues":
                cols["regressed_build"] = [v or None for v in
                                           cols["regressed_build"]]
            f.write(f"COPY public.{table} ({', '.join(cols)}) FROM stdin;\n")
            for row in zip(*cols.values()):
                f.write("\t".join(map(copy_text, row)) + "\n")
            f.write("\\.\n\n")
            rows[table] = len(next(iter(cols.values())))
        f.write("COPY public.pg_stat_statements_info (dealloc, stats_reset) "
                "FROM stdin;\n0\t2025-01-08 00:00:00+00\n\\.\n\n"
                "--\n-- PostgreSQL database dump complete\n--\n")
    return rows


def start_host_command(args: list, name: str):
    """``python -m tse1m_tpu_torch <args>`` started in a child process,
    its output to files (no pipe to fill while this process works);
    ``finish_host_command`` waits for it."""
    base = os.path.join(LOAD_DIR, name)
    with open(base + ".out", "w") as out, open(base + ".log", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tse1m_tpu_torch", *args], cwd=ROOT,
            stdout=out, stderr=err, text=True)
    return proc, args, base, time.perf_counter()


def finish_host_command(started) -> tuple:
    """The child's (wall s, stdout); its output in ``<LOAD_DIR>/<name>.out``
    and ``.log``.  Raises on a non-zero exit."""
    proc, args, base, t0 = started
    try:
        proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    wall = time.perf_counter() - t0
    with open(base + ".out") as f:
        out = f.read()
    if proc.returncode:
        with open(base + ".log") as f:
            err = f.read()
        raise AssertionError(f"{' '.join(args[:2])} exited "
                             f"{proc.returncode}: {err[-2000:]}")
    return wall, out


def host_command(args: list, name: str) -> tuple:
    """``python -m tse1m_tpu_torch <args>`` in a child process, its
    output to ``<LOAD_DIR>/<name>.log``; (wall s, stdout).  Raises on a
    non-zero exit."""
    return finish_host_command(start_host_command(args, name))


def same_arrays(got, want, label: str) -> None:
    """A loaded copy's arrays against phase 4's numpy extraction: the
    projects and offsets, every numeric column element for element and
    every text column by value (a lazy-bytes or coded column whose layout
    differs is materialised and compared cell by cell)."""
    if got.projects != want.projects:
        raise AssertionError(f"{label}: projects differ")
    for table in ("fuzz", "covb", "issues", "cov"):
        a, b = getattr(got, table), getattr(want, table)
        if not np.array_equal(a.offsets, b.offsets) \
                or a.columns.keys() != b.columns.keys():
            raise AssertionError(f"{label}: {table} offsets or columns")
        for name, x in a.columns.items():
            y = b.columns[name]
            if isinstance(y, BytesColumn):
                same = isinstance(x, BytesColumn) and all(
                    np.array_equal(getattr(x, k), getattr(y, k))
                    for k in ("arena", "starts", "lens"))
            elif isinstance(y, CodedColumn):
                same = isinstance(x, CodedColumn) and np.array_equal(
                    x.codes, y.codes) and list(x.vocab) == list(y.vocab)
            elif y.dtype == object:
                same = list(x) == list(y)
            else:
                same = x.dtype == y.dtype and np.array_equal(
                    x, y, equal_nan=y.dtype.kind == "f")
            if not same and isinstance(y, (BytesColumn, CodedColumn)):
                same = list(x.materialize()) == list(y.materialize())
            if not same:
                raise AssertionError(f"{label}: {table}.{name} differs")


def study_load_phase(rq: dict, kept_rows: np.ndarray, c_encode_s: float,
                     dev) -> dict:
    """Phase 4b: phase 4's study written as the collectors' CSVs and
    ingested by a child ``ingest``, written as a pg_dump and restored by a
    child ``restore``; the loaded copies extracted by the native decoder
    to phase 4's numpy arrays, the restored copy's timed alone, the
    ingested copy's beside the ``stats`` children of the three files, line
    for line; the native delta grouper at (c)'s kept rows
    equal to numpy's; one ``study_load`` JSON line.  The suite over the
    restored copy is not run again: its arrays equal phase 4's element for
    element, and phase 4 holds the suite on those arrays."""
    t_phase = time.perf_counter()
    fresh_dir(LOAD_DIR)
    os.makedirs(LOAD_DIR)
    study = rq.pop("study")
    csv_dir = os.path.join(LOAD_DIR, "csv")
    f1, f2 = (os.path.join(LOAD_DIR, f) for f in ("ingested.sqlite",
                                                  "restored.sqlite"))
    dump = os.path.join(LOAD_DIR, "backup_clean.sql")
    walls = {}
    t0 = time.perf_counter()
    study.to_csv_dir(csv_dir)
    walls["to_csv_dir_s"] = time.perf_counter() - t0
    # The ingest child runs while this process writes the dump and the
    # restore child loads it (one after another until phase 3e joined the
    # script: overlapped to keep it inside its time limit).
    ingest = start_host_command(["ingest", "--csv-dir", csv_dir, "--db", f1],
                                "ingest")
    t0 = time.perf_counter()
    dumped = write_pg_dump(study, dump)
    walls["dump_write_s"] = time.perf_counter() - t0
    walls["dump_mb"] = os.path.getsize(dump) / 2**20
    walls["restore_s"], out = host_command(["restore", dump, "--db", f2],
                                           "restore")
    restored = json.loads(out.splitlines()[-1])["restored"]
    walls["ingest_s"], out = finish_host_command(ingest)
    ingested = json.loads(out.splitlines()[-1])["ingested"]
    want_rows = {t: len(next(iter(getattr(study, t).values())))
                 for t in LOAD_TABLES}
    if ingested != want_rows or {t: restored[t] for t in LOAD_TABLES} \
            != dumped or dumped != want_rows \
            or restored["skipped_statements"] < 1:
        raise AssertionError(f"rows: study {want_rows}, ingested "
                             f"{ingested}, dumped {dumped}, restored "
                             f"{restored}")
    with connect(f2) as db:
        yaml = dict(db.query("SELECT project, yaml_json FROM project_info"))
        results = dict(db.query("SELECT result, COUNT(*) FROM buildlog_data "
                                "GROUP BY result"))
    if [yaml[p] for p in study.project_info["project"]] != project_yaml(
            study) or "Success" in results:
        raise AssertionError(f"restore: the escaped YAML cells or the "
                             f"result canonicalisation ({results})")
    log(f"  (h) as CSVs in {walls['to_csv_dir_s']:.3f} s, ingested in "
        f"{walls['ingest_s']:.3f} s; as a {walls['dump_mb']:.1f} MiB "
        f"pg_dump in {walls['dump_write_s']:.3f} s, restored in "
        f"{walls['restore_s']:.3f} s; rows {want_rows}, escapes and "
        "'Success' restored")
    def extract(path):
        with connect(path) as db:
            return StudyArrays.from_db(db, rq["cfg"])

    # The restored copy's extraction is timed alone.  The three files are
    # only read: their stats children then run at once, beside this
    # process's untimed extraction of the ingested copy.
    native_s, restored_arrays = median_wall(lambda: extract(f2))
    stats_started = {name: start_host_command(["stats", "--db", path],
                                              f"stats_{name}")
                     for name, path in (("phase4", rq["path"]),
                                        ("ingested", f1), ("restored", f2))}
    for name, arrays in (("ingested", extract(f1)),
                         ("restored", restored_arrays)):
        if not arrays.native_decode:
            raise AssertionError(f"{name}: extraction left the native "
                                 "decoder")
        same_arrays(arrays, rq["arrays"], name)
    log(f"  both copies extracted by the native decoder == phase 4's numpy "
        f"arrays; the restored copy's alone {native_s:.3f} s against "
        f"numpy's {rq['extract_s']:.3f} s (calls timed: {RQ_REPS}); the "
        "ingested copy's beside the stats children")
    stats = {name: finish_host_command(started)
             for name, started in stats_started.items()}
    for name, (_, out) in stats.items():
        if "regression-tracked" not in out:
            raise AssertionError(f"stats {name}: {out}")
    if not stats["ingested"][1] == stats["restored"][1] \
            == stats["phase4"][1]:
        raise AssertionError("stats lines differ: " + json.dumps(
            {k: v[1] for k, v in stats.items()}))
    walls["stats_s"] = {k: v[0] for k, v in stats.items()}
    log("  stats of phase 4's file, the ingested and the restored copy "
        "(three children at once): the same "
        + str(len(stats["phase4"][1].splitlines())) + " lines")
    t0 = time.perf_counter()
    rep_native = native.group_delta(kept_rows, DELTA_MAX_DIFFS, DELTA_PROBES)
    group_native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep_numpy = encode._group_rows(kept_rows, DELTA_MAX_DIFFS, DELTA_PROBES)
    group_numpy_s = time.perf_counter() - t0
    if rep_native is None or not np.array_equal(rep_native, rep_numpy):
        raise AssertionError("native rep_of differs from numpy's")
    log(f"  delta grouping of (c)'s {kept_rows.shape[0]} kept rows: native "
        f"rep_of == numpy's ({int((rep_numpy >= 0).sum())} delta rows), "
        f"{group_native_s:.3f} s against {group_numpy_s:.3f} s; (c)'s "
        f"encode stage {c_encode_s} s")
    report = {
        "rows": want_rows, "projects_derived": restored["projects"],
        "skipped_statements": restored["skipped_statements"],
        "dump_mb": walls.pop("dump_mb"), **walls,
        "extract_native_s": native_s, "extract_numpy_s": rq["extract_s"],
        "native_decode": True, "group_rows": int(kept_rows.shape[0]),
        "group_native_s": group_native_s, "group_numpy_s": group_numpy_s,
        "c_stage_encode_s": c_encode_s, "reps": RQ_REPS,
        "phase_s": time.perf_counter() - t_phase,
        "card": card_name_and_limit(),
    }
    print(json.dumps({"study_load": report}), flush=True)
    return report


# Phase 3i: the schedule explorer on the card.
EXPLORE_SEEDED = 16           # seeded PCT schedules a scenario
EXPLORE_BOUND = 3             # bounded exhaustive enumeration depth
# The committed interleavings (tests/test_torch_trace.py), replayed here.
EXPLORE_REPLAYS = {
    "serve": "v1:fix:q,r,w,q,w,r,q,w,r,q,w,q,r,w,r,q",
    "store": "v1:fix:rp,rr,w,rp,w,rr,rp,w,rr,rp,w,rr,rp,w,rp",
}
MINHASH_KERNELS = ("minhash_and_keys", "minhash_and_keys_packed")


def novel_slices(items: np.ndarray, batches: list, shards: int) -> int:
    """How many (batch, shard) slices carry a row not seen before: one
    padded MinHash launch each when a daemon signs on the card."""
    owner = digest_range_ids(row_digests(items), shards)
    keys = [bytes(d) for d in row_digests(items)]
    seen, n = set(), 0
    for lo, hi in batches:
        n += len({int(owner[i]) for i in range(lo, hi)
                  if keys[i] not in seen})
        seen |= set(keys[lo:hi])
    return n


def explorer_phase(dev) -> dict:
    """Phase 3i: ``explore("serve")`` and ``explore("router")`` on the card
    with ``signer="device"`` (the daemons' novel rows MinHashed from the
    threads the scheduler serializes), then the committed strings
    replayed; each run's launch counts set to 0 just before it and read
    just after.  Every schedule holds the scenario's invariants (labels
    equal to the host clustering) with no lockset race; each 4-row batch
    slice with novel rows launches one MinHash kernel, in every schedule.
    One ``trace`` JSON line."""
    t_phase = time.perf_counter()
    serve_items = synth_session_sets(texplore._N_ROWS, set_size=16, seed=5,
                                     dup_fraction=0.0)[0]
    b = texplore._BATCH
    per_schedule = {
        "serve": novel_slices(serve_items, [(lo, lo + b) for lo in range(
            0, texplore._N_ROWS, b)], 1),
        # The writer's batches; "fix0" absorbs once, whichever writer
        # runs it first (the other replays the journal's ack).
        "router": novel_slices(texplore.router_corpus(),
                               [(0, 4), (4, 8), (8, 12)], 2),
        "store": 0}
    runs = {}
    for scenario in ("serve", "router"):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        stats = texplore.explore(scenario, n_seeded=EXPLORE_SEEDED,
                                 exhaustive_bound=EXPLORE_BOUND, device=dev,
                                 signer="device")
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        runs[scenario] = dict(stats, wall_s=wall, launches=counts)
    for scenario, s in EXPLORE_REPLAYS.items():
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = texplore.replay(s, scenario, device=dev, signer="device")
        runs[f"replay_{scenario}"] = {
            "trace_schedules_explored": 1, "trace_races_found": out.races,
            "decisions": len(out.decisions),
            "wall_s": time.perf_counter() - t0,
            "launches": kernels.launch_counts()}
    for name, r in runs.items():
        scenario = name.replace("replay_", "")
        minhash = sum(r["launches"][k] for k in MINHASH_KERNELS)
        want = per_schedule[scenario] * r["trace_schedules_explored"]
        others = {k: n for k, n in r["launches"].items()
                  if k not in MINHASH_KERNELS and n}
        if r["trace_races_found"] or minhash != want or others:
            raise AssertionError(f"3i {name}: races "
                                 f"{r['trace_races_found']}, MinHash "
                                 f"launches {minhash} (want {want}), other "
                                 f"launches {others}")
        log(f"  {name}: {r['trace_schedules_explored']} schedules"
            + (f", {r['trace_distinct_traces']} distinct traces"
               if "trace_distinct_traces" in r else "")
            + f", 0 races, MinHash launches {r['launches']} "
            f"({per_schedule[scenario]} a schedule) in {r['wall_s']:.3f} s")
    launches: dict = {}
    for r in runs.values():
        add_counts(launches, r["launches"])
    line = {"scenarios": runs, "launches": launches,
            "schedules": sum(r["trace_schedules_explored"]
                             for r in runs.values()),
            "races": 0, "phase_s": time.perf_counter() - t_phase,
            "card": card_name_and_limit()}
    print(json.dumps({"trace": line}), flush=True)
    return line


# Phase 4c: the auto router on the card.
AUTO_ROUNDS = 3


def auto_router_phase(rq: dict, dev) -> dict:
    """Phase 4c: ``get_backend(Config(backend="auto"), "cuda")`` over phase
    4's study and its extraction: AUTO_ROUNDS rounds of the six RQ calls
    and ``rq_suite``, each routed result held against phase 4's
    TorchBackend("cuda") results (exact; Spearman and mean within
    RQ_TOL), the engine and wall of each call and the learned
    calibration; then the ``all`` command over the golden study under
    TSE1M_BACKEND=auto: the eight goldens byte for byte, every driver's
    manifest naming the router with its calibration.  One
    ``auto_router`` JSON line."""
    t_phase = time.perf_counter()
    be = get_backend(StudyConfig(backend="auto"), dev)
    if not isinstance(be, AutoBackend) or be.device != dev:
        raise AssertionError(f"backend=auto on the card gave {be!r}")
    rtt = be.calibration()["dispatch_rtt_s"]
    log(f"  probed dispatch round trip {rtt * 1e3:.4f} ms")
    arrays, limit_ns = rq["arrays"], rq["limit_ns"]
    calls = rq_calls(be, arrays, limit_ns, rq["g1"], rq["g2"])
    rounds = []
    worst = 0.0
    for r in range(AUTO_ROUNDS):
        row = {}
        for name, fn in calls.items():
            t0 = time.perf_counter()
            res = fn()
            wall = time.perf_counter() - t0
            if name == "suite":
                for q in RQS:
                    worst = max(worst, rq_compare(
                        res[q], rq["suite"][q], q,
                        f"auto round {r} suite vs the card's"))
            else:
                worst = max(worst, rq_compare(
                    res, rq["card_results"][name], name,
                    f"auto round {r} vs the card's"))
            row[name] = {"engine": be.last_engine, "wall_s": wall}
        rounds.append(row)
        log(f"  round {r}: " + ", ".join(
            f"{n} {c['engine']} {c['wall_s']:.4f} s" for n, c in
            row.items()))
    cal = be.calibration()
    log(f"  every routed result == TorchBackend('cuda')'s (Spearman and "
        f"mean within {RQ_TOL}, at most {worst:.3f} of it); calibration "
        f"{json.dumps(cal)}")
    golden = auto_golden_all(dev)
    line = {"dispatch_rtt_s": rtt, "rounds": rounds, "calibration": cal,
            "tolerance_share": worst, "golden_all": golden,
            "phase_s": time.perf_counter() - t_phase,
            "card": card_name_and_limit()}
    print(json.dumps({"auto_router": line}), flush=True)
    return line


def auto_golden_all(dev) -> dict:
    """Phase 4c's last step: the ``all`` command (``tse1m_tpu_torch.
    __main__.main``, in this process) over phase 4's golden study under
    TSE1M_BACKEND=auto: every step ok, the eight artifacts equal
    tests/goldens/synth8/ byte for byte, and each driver's manifest names
    the router on the card with its ``router_calibration``."""
    from tse1m_tpu_torch.__main__ import main as cli_main

    out = fresh_dir(os.path.join(RQ_DIR, "golden_auto_out"))
    t0 = time.perf_counter()
    with environment(TSE1M_BACKEND="auto", TSE1M_ROUTER_CAL=""), \
            open(os.path.join(RQ_DIR, "golden_auto_all.log"), "w") as f, \
            contextlib.redirect_stdout(f):
        rc = cli_main(["all", "--db", os.path.join(RQ_DIR, "golden.sqlite"),
                       "--result-dir", out, "--test-mode", "--corpus-csv",
                       os.path.join(RQ_DIR, "golden_corpus.csv")])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"all under TSE1M_BACKEND=auto exited {rc}")
    with open(os.path.join(out, "run_manifest.json")) as f:
        check_all_steps(json.load(f), "golden under auto")
    engines = {}
    for name, rel in DRIVER_MANIFESTS.items():
        with open(os.path.join(out, rel)) as f:
            m = json.load(f)
        cal = m.get("router_calibration")
        if (m["backend"], m["device"]) != (
                "auto", torch.cuda.get_device_name(dev)) or not cal:
            raise AssertionError(f"{name} under auto: {m['backend']} "
                                 f"{m['device']}, calibration {cal}")
        engines[name] = cal["cost_per_row"]
    for rel in GOLDEN_FILES:
        with open(os.path.join(out, rel), "rb") as f, \
                open(os.path.join(GOLDEN_DIR, rel), "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"{rel} under auto differs from the "
                                     "golden")
    log(f"  all over the golden study under TSE1M_BACKEND=auto in "
        f"{wall:.3f} s: every step ok, the {len(GOLDEN_FILES)} goldens byte "
        "for byte, each manifest with its router_calibration")
    return {"wall_s": wall, "cost_per_row": engines}


# Phase 4d: the collectors on the card's machine (no pandas, PyYAML,
# requests or selenium there).  The fixture is made from seed 0 here.
COLLECT_DIR = os.path.join(ROOT, "build", "collect_smoke")  # gitignored
COLLECT_PROJECTS = 30         # oss-fuzz projects in the local checkout
COLLECT_CORPUS = 8            # of them add a seed corpus
GCS_PAGES = 4                 # bucket listing pages
GCS_PAGE_OBJECTS = 1000       # objects a page, build logs among others
COLLECT_LOGS = 3000           # build logs of the three kinds, 2-20 KB
COVERAGE_DAYS = 60            # daily reports a project, some days missing
COLLECT_ISSUES = 1000         # issue pages, scraped in two windows
ISSUE_WINDOWS = 2
COLLECT_BASE = "2024-03-01"   # the study's first day
COLLECT_YAMLS = (             # every form of the reader's subset
    "homepage: https://{p}.org\nlanguage: {lang}\nprimary_contact: "
    "a@{p}.org\nauto_ccs:\n  - b@{p}.org\n  - 'c@{p}.org'\nsanitizers:\n"
    "- address\n- memory:\n    experimental: true\n- undefined\n"
    "builds_per_day: {k}\nmain_repo: \"https://github.com/x/{p}\"  # repo\n",
    "# {p}\nlanguage: {lang}\nfuzzing_engines: [libfuzzer, afl, honggfuzz]"
    "\nvendor_ccs: {{x: 1, y: [true, no]}}\nfile_github_issue: yes\n"
    "disabled: false\n",
    "language: {lang}\nhelp_url: >\n  folded text\n  goes on\n"
    "coverage_extra_args: |\n  -ignore=a\n  -ignore=b\nlabels:\n  "
    "fuzzer: [sec, 'x: y']\narchitectures:\n  - x86_64\n  - i386\n"
    "run_tests: Off\n",
    "language: {lang}\nview_restrictions: none\nselective_unpack: "
    "2021-03-04\nbuilds_per_day: 0x10\nhomepage: 'it''s {p}'\n",
    "language: {lang}\nauto_ccs: []\nsanitizers: [address]\nblackbox: ~\n"
    "main_repo: \"tab\\there\"\n")
CRASH_TYPES = ("Heap-buffer-overflow", "UAF", "Null-deref")
COLLECT_LANGS = ("c", "c++", "rust", "python", "jvm", "swift", "go")
HTML_C = ("<html><body><table><tr><th>Filename</th><th>Function Coverage"
          "</th><th>Line Coverage</th></tr><tr><td>a.c</td><td>1.00% "
          "(1/100)</td><td>2.00% (2/100)</td></tr><tr><td>Totals</td><td>"
          "50.00% (5/10)</td><td>{pct:.2f}% ({cov}/{tot})</td></tr></table>"
          "</body></html>")
HTML_PY = ("<html><body><table><tr><th>Module</th><th>statements</th><th>"
           "missing</th><th>coverage</th></tr><tr><td>Total</td><td>{tot}"
           "</td><td>{miss}</td><td>x%</td></tr></table></body></html>")
HTML_JVM = ("<html><body><table><tr><th>Element</th><th>Missed</th><th>"
            "Cov.</th><th>Lines</th><th>Missed</th></tr><tr><td>Total</td>"
            "<td>12</td><td>70%</td><td>{tot:,}</td><td>{miss}</td></tr>"
            "</table></body></html>")


def collect_day(k: int) -> str:
    d = np.datetime64(COLLECT_BASE) + np.timedelta64(k, "D")
    return str(d).replace("-", "")


def git(repo: str, *args, when: str | None = None) -> str:
    env = dict(os.environ, GIT_AUTHOR_NAME="smoke", GIT_AUTHOR_EMAIL="s@x",
               GIT_COMMITTER_NAME="smoke", GIT_COMMITTER_EMAIL="s@x")
    if when:
        env.update(GIT_AUTHOR_DATE=when, GIT_COMMITTER_DATE=when)
    return subprocess.run(["git", *args], cwd=repo, env=env, check=True,
                          capture_output=True, text=True).stdout.strip()


def git_history(repo: str, commits: list) -> dict:
    """``commits`` as the history of a fresh repository at ``repo``, in
    one ``git fast-import`` (the files are already in the working tree);
    each commit message's sha."""
    from datetime import datetime as _dt

    os.makedirs(repo, exist_ok=True)
    git(repo, "init", "-q")
    out = []
    for n, (when, msg, files) in enumerate(commits, 1):
        t = _dt.fromisoformat(when)
        off = int(t.utcoffset().total_seconds() // 60)
        stamp = (f"{int(t.timestamp())} {'-' if off < 0 else '+'}"
                 f"{abs(off) // 60:02d}{abs(off) % 60:02d}")
        out += [f"commit refs/heads/main", f"mark :{n}",
                f"author smoke <s@x> {stamp}",
                f"committer smoke <s@x> {stamp}",
                f"data {len(msg.encode())}", msg]
        if n > 1:
            out.append(f"from :{n - 1}")
        for rel, text in files.items():
            data = text.encode()
            out += [f"M 100644 inline {rel}", f"data {len(data)}",
                    data.decode()]
    marks = os.path.join(os.path.dirname(repo), "marks")
    subprocess.run(["git", "fast-import", "--quiet",
                    f"--export-marks={marks}"], cwd=repo, check=True,
                   input=("\n".join(out) + "\n").encode(),
                   capture_output=True)
    git(repo, "symbolic-ref", "HEAD", "refs/heads/main")
    with open(marks) as f:
        by_mark = dict(line.split() for line in f)
    return {commits[int(m[1:]) - 1][1]: sha for m, sha in by_mark.items()}


def write_file(path: str, data) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb" if isinstance(data, bytes) else "w") as f:
        f.write(data)


def collect_fixture(fx: str, has_git: bool) -> dict:
    """The phase's inputs from seed 0: an oss-fuzz checkout, the GCS
    listing, the build logs, the coverage reports and GitHub's answers,
    laid out as DirFetcher maps URLs (``fx/<host>/<path>``)."""
    rng = np.random.default_rng(0)
    names = [f"proj{i:02d}" for i in range(COLLECT_PROJECTS)]
    langs = {p: COLLECT_LANGS[i % len(COLLECT_LANGS)]
             for i, p in enumerate(names)}
    repo = os.path.join(fx, "oss-fuzz")
    first = {}
    commits = []   # (time, message, {path: content}), oldest first
    for i, p in enumerate(names):
        text = COLLECT_YAMLS[i % len(COLLECT_YAMLS)].format(
            p=p, lang=langs[p], k=int(rng.integers(1, 9)))
        if i % 7 == 6:
            text = "language: {}\n\tbad: tab\n".format(langs[p])  # skipped
        files = {f"projects/{p}/project.yaml": text,
                 f"projects/{p}/build.sh": "#!/bin/bash\ncompile\n"}
        offset = ("+02:00", "+00:00", "-05:00")[i % 3]
        first[p] = f"2024-03-0{1 + i % 3}T0{i % 10}:1{i % 6}:00{offset}"
        commits.append((first[p], f"add {p}", files))
    for i, p in enumerate(names[:COLLECT_CORPUS]):
        commits.append((f"2024-03-{10 + i}T12:00:00+00:00", f"corpus {p}",
                        {f"projects/{p}/build.sh": "#!/bin/bash\ncompile\n"
                         f"cp {p}_seed_corpus.zip $OUT/\n"}))
    for _, _, files in commits:
        for rel, text in files.items():
            write_file(os.path.join(repo, *rel.split("/")), text)
    shas = git_history(repo, commits) if has_git else {}
    shas = {msg.split()[1]: sha for msg, sha in shas.items()
            if msg.startswith("corpus ")}
    api = os.path.join(fx, "api.github.com", "repos", "google", "oss-fuzz")
    for i, (p, sha) in enumerate(sorted(shas.items())):
        if i % 4 == 3:
            continue  # no pull request found: a 404
        write_file(os.path.join(api, "commits", sha,
                                "pulls#per_page=1&state=closed"),
                   json.dumps([{"number": 100 + i}]))
        write_file(os.path.join(api, "pulls", str(100 + i)),
                   json.dumps({"merged_at": f"2024-03-{12 + i}T08:30:00Z"}))
    # The GCS listing: build logs among other objects, page by page.
    listing = os.path.join(fx, "storage.googleapis.com", "storage", "v1",
                           "b", "oss-fuzz-gcb-logs", "o")
    per_page = COLLECT_LOGS // GCS_PAGES
    logs = []
    for page in range(GCS_PAGES):
        items = []
        for j in range(GCS_PAGE_OBJECTS):
            u = rng.integers(0, 16, 32)
            hexs = "".join("0123456789abcdef"[x] for x in u)
            if j < per_page:
                name = (f"log-{hexs[:8]}-{hexs[8:12]}-{hexs[12:16]}-"
                        f"{hexs[16:20]}-{hexs[20:]}.txt")
                k = page * per_page + j
                created = (np.datetime64(f"{COLLECT_BASE}T00:00:00")
                           + np.timedelta64(int(k * 60 * 24 * 55
                                                // COLLECT_LOGS), "m"))
                link = (None if k % 11 == 5 else
                        "https://oss-fuzz-build-logs.storage.googleapis.com/"
                        + name)
                items.append({"name": name, "selfLink": f"self/{name}",
                              "mediaLink": link, "size": str(2048 + k),
                              "timeCreated": f"{created}Z", "md5": "x"})
                logs.append((name, k, link))
            else:
                items.append({"name": (f"other/{hexs}.json", "log-short.txt",
                                       f"log-{hexs}.txt")[j % 3],
                              "size": "1"})
        body = {"items": items}
        if page + 1 < GCS_PAGES:
            body["nextPageToken"] = f"tok{page + 1}"
        write_file(listing if page == 0 else f"{listing}#pageToken=tok{page}",
                   json.dumps(body))
    # The logs: fuzzing, coverage and error kinds, 2-20 KB; some absent.
    host = os.path.join(fx, "oss-fuzz-build-logs.storage.googleapis.com")
    for name, k, link in logs:
        if k % 13 == 7:
            continue  # a 404: the record keeps its metadata, empty fields
        p = names[k % COLLECT_PROJECTS]
        kind = k % 3
        lines = [f"starting build \"{k}\"",
                 (f"Step #1: Already have image: gcr.io/oss-fuzz/{p}"
                  if kind != 2 else
                  f"Step #1: No URLs matched: gs://oss-fuzz-coverage/{p}/"
                  "textcov_reports"),
                 'Starting Step #2 - "srcmap"', "Step #2: {",
                 f'Step #2:   "/src/{p}": {{', 'Step #2:     "type": "git",',
                 f'Step #2:     "url": "https://github.com/x/{p}.git",',
                 f'Step #2:     "rev": "{k:012x}"', "Step #2:   }",
                 "Step #2: }",
                 ('Starting Step #3 - "compile-libfuzzer-address-x86_64"',
                  'Starting Step #3 - "compile-libfuzzer-coverage-x86_64"',
                  'Starting Step #3 - "compile-libfuzzer-address-x86_64"'
                  )[kind]]
        size = int(rng.integers(2048, 20480))
        have = sum(len(x) + 1 for x in lines)
        for filler, pad in enumerate(rng.integers(10, 80, size // 40)):
            if have >= size:
                break
            lines.append(f"Step #3: compiling unit {filler} of {p} "
                         + "x" * int(pad))
            have += len(lines[-1]) + 1
        lines += (["PUSH", "DONE"], ["Step #4: /report/linux/index.html",
                                     "PUSH", "DONE"], ["ERROR",
                                                       "ERROR: step failed"]
                  )[kind]
        fname = name if link else f"log-{name}.txt"
        write_file(os.path.join(host, fname), "\n".join(lines) + "\n")
    # Coverage reports: each project's days from its first commit, the
    # three report families, about one day in six missing.
    cov_root = os.path.join(fx, "storage.googleapis.com", "oss-fuzz-coverage")
    for i, p in enumerate(names):
        lang = langs[p]
        for k in range(COVERAGE_DAYS):
            if rng.random() < 0.16:
                continue
            tot = int(rng.integers(1000, 90000))
            cov = int(rng.integers(0, tot))
            if lang in ("c", "c++", "rust", "swift"):
                page, html = "file_view_index.html", HTML_C.format(
                    pct=100.0 * cov / tot, cov=cov, tot=tot)
            elif lang == "python":
                page, html = "index.html", HTML_PY.format(tot=tot,
                                                         miss=tot - cov)
            else:  # jvm; go's reports carry no parse rule
                page, html = "index.html", HTML_JVM.format(tot=tot,
                                                          miss=tot - cov)
            write_file(os.path.join(cov_root, p, "reports", collect_day(k),
                                    "linux", page), html)
    return {"names": names, "langs": langs, "first": first, "repo": repo,
            "corpus_shas": shas, "log_names": [n for n, _, _ in logs]}


class SmokeIssueClient:
    """The phase's page client: issue pages made from the issue number
    (seeded), with the metadata, events, description and revision tables
    the tracker shows.  Part of this script, not of the package."""

    def __init__(self, names: list):
        self.names = names

    def fetch_issue(self, issue_no: int):
        from tse1m_tpu_torch.collect.issues import (IssueEvent, RawIssuePage,
                                                    issue_url)

        r = np.random.default_rng(issue_no)
        p = self.names[issue_no % len(self.names)]
        if issue_no % 97 == 13:
            return RawIssuePage(final_id=str(issue_no), url=issue_url(
                issue_no), load_error=True)
        day = int(r.integers(5, 55))
        rt = f"{collect_day(day)[:4]}-{collect_day(day)[4:6]}-" \
             f"{collect_day(day)[6:]}T{int(r.integers(0, 24)):02d}:17:00Z"
        rev = f"https://oss-fuzz.com/revisions?job=j&range={issue_no}:" \
              f"{issue_no + 9}"
        events = [IssueEvent(text="filed", time_iso=rt)]
        if issue_no % 3:
            events.append(IssueEvent(
                text=f"Fixed: https://oss-fuzz.com/revisions?range="
                     f"{'a' * 12}:{'b' * 12}", time_iso=rt.replace(
                         "17:00", "59:00")))
        desc = (f"Project: {p}\nFuzzing Engine: libFuzzer\nCrash Type: "
                f"{CRASH_TYPES[issue_no % 3]}"
                f"\nCrash State:\n  f{issue_no}\n  g\n\nRegressed: {rev} "
                "tail\nRecommended Security Severity: "
                f"{('Low', 'Medium', 'High')[issue_no % 3]}\n\nIssue filed "
                "automatically.\n")
        return RawIssuePage(
            final_id=str(issue_no + (1 if issue_no % 50 == 7 else 0)),
            url=issue_url(issue_no), title=f"{p}: crash {issue_no}",
            reported_time_iso=rt,
            metadata={"Status": ("Fixed (Verified)", "New", None)[
                issue_no % 3], "Type": "Vulnerability",
                "Severity": (None, "S2", "S3")[issue_no % 3],
                "Reported": rt[:10], "CC": ["a@x.org", "b@x.org"]},
            events=events, description=desc,
            hotlists=["OSS-Fuzz"] if issue_no % 5 == 0 else [])

    def fetch_revisions(self, url: str):
        from tse1m_tpu_torch.collect.issues import (
            RevisionTable, revision_buildtime_from_url)

        n = int(url.split("range=")[1].split(":")[0])
        if n % 10 == 3:
            return None
        return RevisionTable(components=["main", "dep"],
                             revisions=[["c" * 20, "d" * 20], ["v1.2"]],
                             buildtime=revision_buildtime_from_url(url))

    def close(self) -> None:
        pass


class FixtureHandler(http.server.BaseHTTPRequestHandler):
    """The fixture tree over loopback HTTP: ``/<host>/<path>?<query>`` is
    ``fx/<host>/<path>#<sorted query>``, as DirFetcher maps a URL; the
    scripted statuses (429 with Retry-After: 1, 503) come first."""

    root = ""
    script: dict = {}
    served: dict = {}
    lock = threading.Lock()

    def do_GET(self):  # noqa: N802 - http.server's name
        path, _, query = self.path.partition("?")
        rel = path.lstrip("/")
        if query:
            pairs = sorted(urllib.parse.parse_qsl(query))
            rel = rel.rstrip("/") + "#" + urllib.parse.quote(
                urllib.parse.urlencode(pairs), safe="=&")
        file = os.path.join(self.root, *rel.split("/"))
        with self.lock:
            statuses = self.script.get(path, [])
            status = statuses.pop(0) if statuses else (
                200 if os.path.isfile(file) else 404)
            self.served[status] = self.served.get(status, 0) + 1
        body = b""
        if status == 200:
            with open(file, "rb") as f:
                body = f.read()
        self.send_response(status)
        if status == 429:
            self.send_header("Retry-After", "1")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


class FixtureServer(http.server.ThreadingHTTPServer):
    """A backlog for the analyzer's eight threads at once."""

    request_queue_size = 128
    daemon_threads = True


def fixture_server(spec: dict) -> int:
    """A phase 4d child (``--fixture-server``): the fixture over loopback
    HTTP in its own process, so the fetching threads keep this process's
    interpreter, until SIGTERM; then the statuses it served, as JSON, to
    ``spec["stats"]``."""
    FixtureHandler.root = spec["root"]
    FixtureHandler.script = {k: list(v) for k, v in spec["script"].items()}
    server = FixtureServer(("127.0.0.1", 0), FixtureHandler)
    signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
        target=server.shutdown).start())
    with open(spec["port"] + ".tmp", "w") as f:
        f.write(str(server.server_address[1]))
    os.replace(spec["port"] + ".tmp", spec["port"])
    server.serve_forever()
    server.server_close()
    with open(spec["stats"], "w") as f:
        json.dump(FixtureHandler.served, f)
    return 0


class LoopbackSession:
    """HttpFetcher's session for the phase: every ``https://host/path``
    goes to the loopback server as ``/host/path``, through the package's
    urllib session."""

    def __init__(self, port: int):
        from tse1m_tpu_torch.collect.transport import UrllibSession

        self.port = port
        self.inner = UrllibSession()

    def get(self, url, params=None, timeout=None):
        rest = url.split("://", 1)[1]
        return self.inner.get(f"http://127.0.0.1:{self.port}/{rest}",
                              params=params, timeout=timeout)


def retries_total() -> int:
    from tse1m_tpu_torch.observability import metrics as obs_metrics

    return sum(m.value for m in obs_metrics.get_registry().collect()
               if m.name == "retries_total")


def fixture_fetcher(kind: str, fx: str, port: int | None = None):
    from tse1m_tpu_torch.collect.transport import (DirFetcher, FetchPolicy,
                                                   HttpFetcher)

    if kind == "dir":
        return DirFetcher(fx)
    return HttpFetcher(FetchPolicy(retries=3, backoff_factor=0.05,
                                   timeout=30.0),
                       session=LoopbackSession(port))


def collect_drivers(fetcher, data: str, info_csv: str | None,
                    finish) -> dict:
    """The GCS, buildlogs and (with ``info_csv``) coverage drivers over
    one fetcher into ``data``; each step's (wall s, rows)."""
    from tse1m_tpu_torch.collect import table
    from tse1m_tpu_torch.collect.buildlogs import BuildLogAnalyzer
    from tse1m_tpu_torch.collect.coverage import CoverageCollector
    from tse1m_tpu_torch.collect.gcs_metadata import GcsMetadataCollector
    from tse1m_tpu_torch.collect.normalize import buildlog_table_rows

    steps = {}
    t0 = time.perf_counter()
    gcs = GcsMetadataCollector(fetcher, os.path.join(
        data, "buildlog_metadata_batches"), pages_per_batch=2)
    n = gcs.collect(os.path.join(data, "buildlog_metadata.csv"))
    steps["gcs"] = {"wall_s": time.perf_counter() - t0, "rows": n,
                    "pages": gcs.pages_fetched}
    t0 = time.perf_counter()
    batch_dir = os.path.join(data, "buildlog_analyzed_batches")
    an = BuildLogAnalyzer(fetcher, batch_dir, batch_size=500, workers=8)
    n = an.analyze(table.read_csv(os.path.join(data,
                                               "buildlog_metadata.csv")))
    batches = sorted(glob.glob(os.path.join(batch_dir, "*.csv")))
    rows = buildlog_table_rows(table.concat([table.read_csv(b)
                                             for b in batches]))
    table.write_csv(rows, os.path.join(data, "buildlog_data.csv"))
    steps["buildlogs"] = {"wall_s": time.perf_counter() - t0, "rows": n,
                          "batches": len(batches), "table_rows": len(rows)}
    if info_csv:
        t0 = time.perf_counter()
        cov = CoverageCollector(fetcher, os.path.join(data, "coverage"),
                                finish_date=finish)
        n = cov.collect_all(table.read_csv(info_csv),
                            os.path.join(data, "total_coverage.csv"))
        steps["coverage"] = {"wall_s": time.perf_counter() - t0, "rows": n}
    return steps


def csv_files(d: str) -> dict:
    """Every CSV under ``d`` by relative path, its bytes."""
    out = {}
    for p in glob.glob(os.path.join(d, "**", "*.csv"), recursive=True):
        with open(p, "rb") as f:
            out[os.path.relpath(p, d)] = f.read()
    return out


def study_dump(path: str) -> dict:
    import sqlite3

    with sqlite3.connect(path) as conn:
        return {t: sorted(conn.execute(f"SELECT * FROM {t}").fetchall(),
                          key=repr)
                for t in ("projects", "project_info", "buildlog_data",
                          "total_coverage", "issues")}


@contextlib.contextmanager
def loopback_unproxied():
    """127.0.0.1 added to ``no_proxy``: urllib reads it at each request,
    so the loopback server is reached past any proxy the environment
    names."""
    saved = {k: os.environ.get(k) for k in ("no_proxy", "NO_PROXY")}
    os.environ["no_proxy"] = os.environ["NO_PROXY"] = ",".join(
        [v for v in saved.values() if v] + ["127.0.0.1"])
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def collect_phase(dev, world: dict | None = None) -> dict:
    """Phase 4d: the collectors over a seed-0 fixture with no network.
    The issue pages are scraped in two windows; the ``collect projects``
    and ``collect issues`` (merge and normalize) commands run as children;
    the GCS, coverage, buildlogs (8 workers) and corpus drivers over
    DirFetcher; GCS, buildlogs and coverage again through HttpFetcher
    against a loopback server child with scripted 429/503s (CSVs
    byte-equal, the retries as scripted); the study ingested by a child
    and ``rq1`` on the card == ``--device cpu``; GCS, buildlogs and ingest
    under a seeded fault plan == the fault-free run; the round toolbelt's
    ``diff``, ``gate`` and ``keys`` as children beside it all.  Between
    its steps it stops if a rank of ``world`` (run beside it) failed.
    Every child it started is killed if it fails.  One ``collect``
    line."""
    procs: list = []
    try:
        with loopback_unproxied():
            return collect_steps(dev, world, procs)
    finally:
        for proc, *_ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def collect_steps(dev, world, procs: list) -> dict:
    """:func:`collect_phase`'s steps; each child started goes to
    ``procs``."""
    from tse1m_tpu_torch.__main__ import main as cli_main
    from tse1m_tpu_torch.collect import table
    from tse1m_tpu_torch.collect.corpus import (GitHubMergeTimeResolver,
                                                run_corpus_collector)
    from tse1m_tpu_torch.collect.coverage import CoverageCollector
    from tse1m_tpu_torch.collect.issues import scrape_issues
    from tse1m_tpu_torch.collect.normalize import coverage_table_rows
    from tse1m_tpu_torch.db.ingest import ingest_csv_dir
    from tse1m_tpu_torch.resilience import FaultPlan

    t_phase = time.perf_counter()
    fresh_dir(COLLECT_DIR)
    os.makedirs(COLLECT_DIR)
    fx = os.path.join(COLLECT_DIR, "fx")
    has_git = shutil.which("git") is not None
    bench = [start_collect_child(
        ["-m", "tse1m_tpu_torch.bench", *args], f"bench_{args[0]}", procs)
        for args in (["diff", "BENCH_r08.json", "BENCH_r09.json"],
                     ["gate", "BENCH_r09.json", "--baseline",
                      "BENCH_baseline_smoke.json"], ["keys"])]
    t0 = time.perf_counter()
    fix = collect_fixture(fx, has_git)
    steps = {"fixture": {"wall_s": time.perf_counter() - t0}}
    check_world(world)
    data = os.path.join(COLLECT_DIR, "dir")
    finish = (np.datetime64(COLLECT_BASE) + np.timedelta64(
        COVERAGE_DAYS + 2, "D")).astype(object)
    script = {
        "/storage.googleapis.com/storage/v1/b/oss-fuzz-gcb-logs/o":
            [429, 503],
        "/oss-fuzz-build-logs.storage.googleapis.com/"
        + fix["log_names"][17]: [429, 503, 503],
        "/storage.googleapis.com/oss-fuzz-coverage/proj00/reports/"
        f"{collect_day(3)}/linux/file_view_index.html": [503]}
    scripted = sum(len(v) for v in script.values())
    spec = {"root": fx, "script": script,
            "port": os.path.join(COLLECT_DIR, "server.port"),
            "stats": os.path.join(COLLECT_DIR, "server.json")}
    server = start_collect_child([os.path.join(ROOT, "chip_smoke.py"),
                                  "--fixture-server", json.dumps(spec)],
                                 "fixture_server", procs)

    # Issues: two windows in this process, then the command's merge.
    t0 = time.perf_counter()
    ids = list(range(1, COLLECT_ISSUES + 1))
    scrape_issues(lambda: SmokeIssueClient(fix["names"]), ids,
                  os.path.join(data, "issue_scraping_results"),
                  num_workers=ISSUE_WINDOWS, save_interval=50,
                  parallel=False)
    steps["issues_scrape"] = {"wall_s": time.perf_counter() - t0,
                              "rows": len(ids)}
    children = {"issues": start_collect_child(
        ["-m", "tse1m_tpu_torch", "collect", "issues", "--data-dir", data],
        "collect_issues", procs)}
    if has_git:
        children["projects"] = start_collect_child(
            ["-m", "tse1m_tpu_torch", "collect", "projects", "--no-clone",
             "--repo", fix["repo"], "--data-dir", data], "collect_projects",
            procs)
    steps.update(collect_drivers(fixture_fetcher("dir", fx), data, None,
                                 finish))
    if has_git:
        t0 = time.perf_counter()
        corpus = run_corpus_collector(
            fix["repo"], os.path.join(data, "project_corpus_analysis.csv"),
            GitHubMergeTimeResolver(fetcher=fixture_fetcher("dir", fx),
                                    token="smoke"))
        merged = sum(1 for v in corpus.col("corpus_merged_time")
                     if v is not None)
        steps["corpus"] = {"wall_s": time.perf_counter() - t0,
                           "rows": len(corpus), "with_corpus": sum(
                               bool(v) for v in corpus.col("is_Corpus")),
                           "merged_resolved": merged}
        if (len(corpus), steps["corpus"]["with_corpus"], merged) != (
                COLLECT_PROJECTS, COLLECT_CORPUS, 6):
            raise AssertionError(f"corpus: {steps['corpus']}")
    for name, started in children.items():
        steps[name] = {"wall_s": finish_collect_child(started)[0]}
    info_csv = os.path.join(data, "project_info.csv")
    if not has_git:
        # No git on this host: the project step is the CPU tests'; the
        # coverage walk starts from the fixture's own first commits.
        table.write_csv(table.from_records(
            [{"project": p, "first_commit_datetime": fix["first"][p],
              "language": fix["langs"][p]} for p in fix["names"]]), info_csv)
    info = table.read_csv(info_csv)
    steps["projects"] = {**steps.get("projects", {}), "rows": len(info)}
    skipped = sum(1 for i in range(COLLECT_PROJECTS) if i % 7 == 6)
    if len(info) != COLLECT_PROJECTS or (has_git and sum(
            v is None for v in info.col("homepage")) < skipped):
        raise AssertionError(f"project_info: {len(info)} rows")
    t0 = time.perf_counter()
    n_cov = CoverageCollector(fixture_fetcher("dir", fx), os.path.join(
        data, "coverage"), finish_date=finish).collect_all(
            info, os.path.join(data, "total_coverage.csv"))
    steps["coverage"] = {"wall_s": time.perf_counter() - t0, "rows": n_cov}
    merged_issues = table.read_csv(os.path.join(data, "issues.csv"))
    steps["issues"]["rows"] = len(merged_issues)
    if not (steps["gcs"]["rows"] == COLLECT_LOGS
            and steps["buildlogs"]["rows"] == COLLECT_LOGS
            and n_cov > COLLECT_PROJECTS * COVERAGE_DAYS // 2
            and len(merged_issues) > COLLECT_ISSUES // 2):
        raise AssertionError(f"collect rows: {steps}")

    check_world(world)

    # The study's CSVs, ingested by a child while HttpFetcher runs.
    ingest_dir = os.path.join(COLLECT_DIR, "ingest")
    os.makedirs(ingest_dir)
    for name in ("project_info.csv", "buildlog_data.csv", "issues.csv"):
        shutil.copy(os.path.join(data, name), ingest_dir)
    table.write_csv(coverage_table_rows(table.read_csv(os.path.join(
        data, "total_coverage.csv"))), os.path.join(ingest_dir,
                                                    "total_coverage.csv"))
    study = os.path.join(COLLECT_DIR, "study.sqlite")
    ingest = start_collect_child(
        ["-m", "tse1m_tpu_torch", "ingest", "--csv-dir", ingest_dir,
         "--db", study], "ingest", procs)

    # The same drivers through HttpFetcher against the loopback server.
    t0 = time.perf_counter()
    try:
        port = wait_port(server[0], spec["port"], "the fixture server")
        http_data = os.path.join(COLLECT_DIR, "http")
        before = retries_total()
        http_steps = collect_drivers(fixture_fetcher("http", fx, port),
                                     http_data, info_csv, finish)
        http_retries = retries_total() - before
        want = {k: v for k, v in csv_files(data).items()
                if k.startswith(("buildlog_", "total_coverage", "coverage"))}
        got = csv_files(http_data)
        if got != want:
            raise AssertionError("HTTP CSVs differ from DirFetcher's: "
                                 f"{sorted(set(got) ^ set(want))}")
        if http_retries != scripted:
            raise AssertionError(f"HTTP retries {http_retries}, scripted "
                                 f"{scripted}")
        steps["http"] = {"wall_s": time.perf_counter() - t0,
                         "steps": http_steps, "csvs_equal": len(got),
                         "retries": http_retries, "scripted": scripted}

        check_world(world)
        wall, out = finish_collect_child(ingest)
        ingested = json.loads(out.splitlines()[-1])["ingested"]
        steps["ingest"] = {"wall_s": wall, "rows": ingested}
        t0 = time.perf_counter()
        rq1 = {}
        for label, device in (("card", str(dev)), ("cpu", "cpu")):
            out_dir = os.path.join(COLLECT_DIR, f"rq1_{label}")
            with open(out_dir + ".log", "w") as f, \
                    contextlib.redirect_stdout(f):
                rc = cli_main(["rq1", "--db", study, "--result-dir", out_dir,
                               "--limit-date", "2024-06-01",
                               "--min-coverage-days", "30", "--test-mode",
                               "--device", device])
            if rc:
                raise AssertionError(f"rq1 --device {device} exited {rc}")
            rq1[label] = csv_files(out_dir)
        rows = {k: len(v.splitlines()) - 1 for k, v in rq1["card"].items()}
        if rq1["card"] != rq1["cpu"] or not rows or not all(rows.values()):
            raise AssertionError(f"rq1 on the card ({rows}) differs from "
                                 "--device cpu, or wrote nothing")
        steps["rq1"] = {"wall_s": time.perf_counter() - t0, "csvs": rows,
                        "card_equals_cpu": True}

        check_world(world)

        # Under a seeded fault plan: the same CSVs, the same study.
        plan_path = os.path.join(COLLECT_DIR, "plan.json")
        with open(plan_path, "w") as f:
            json.dump({"seed": 0, "rules": [
                {"site": "http.fetch", "times": 3, "kind": "raise"},
                {"site": "http.fetch", "times": 3, "after_calls": 700,
                 "kind": "connection_drop"},
                {"site": "http.fetch", "times": 5, "after_calls": 1500,
                 "kind": "delay", "delay_s": 0.01},
                {"site": "checkpoint.csv.flush", "times": 2,
                 "kind": "torn_write"},
                {"site": "db.execute", "times": 2, "after_calls": 1,
                 "kind": "connection_drop"}]}, f)
        plan = FaultPlan.from_json(plan_path)
        t0 = time.perf_counter()
        fault_data = os.path.join(COLLECT_DIR, "faults")
        fault_db = os.path.join(COLLECT_DIR, "study_faults.sqlite")
        with plan.active():
            collect_drivers(fixture_fetcher("http", fx, port), fault_data,
                            None, finish)
            with connect(fault_db) as db:
                fault_rows = ingest_csv_dir(db, ingest_dir)
    finally:
        server[0].terminate()
    finish_collect_child(server)
    with open(spec["stats"]) as f:
        served = {int(k): v for k, v in json.load(f).items()}
    if (served.get(429), served.get(503)) != (2, 4):
        raise AssertionError(f"the server served {served}")
    steps["http"]["statuses"] = served
    fired = {}
    for site, kind in plan.fired:
        fired[f"{site}:{kind}"] = fired.get(f"{site}:{kind}", 0) + 1
    want = {k: v for k, v in csv_files(data).items()
            if k.startswith("buildlog_")}
    if csv_files(fault_data) != want or fault_rows != ingested \
            or study_dump(fault_db) != study_dump(study):
        raise AssertionError("the fault plan's run differs from the "
                             "fault-free run")
    if set(fired) != {"http.fetch:raise", "http.fetch:connection_drop",
                      "http.fetch:delay", "checkpoint.csv.flush:torn_write",
                      "db.execute:connection_drop"}:
        raise AssertionError(f"faults fired: {fired}")
    steps["faults"] = {"wall_s": time.perf_counter() - t0, "fired": fired,
                       "csvs_equal": len(want), "study_equal": True}

    check_world(world)

    # The round toolbelt, started at the top of the phase.  gate's verdict
    # on these committed rounds is a regression (exit 1, as the JAX
    # package's): r09 is a 1M round, the baseline a 2k smoke.
    tools = {}
    for (name, code), started in zip((("diff", 0), ("gate", 1),
                                      ("keys", 0)), bench):
        wall, out = finish_collect_child(started, code)
        tools[name] = {"wall_s": wall, "lines": len(out.splitlines()),
                       "exit": code}
    if not (tools["diff"]["lines"] > 5 and tools["keys"]["lines"] > 50):
        raise AssertionError(f"bench toolbelt: {tools}")
    steps["bench"] = tools
    line = {"steps": steps, "git": has_git,
            "phase_s": time.perf_counter() - t_phase,
            "card": card_name_and_limit()}
    git_note = ("present" if has_git else
                "absent: projects and corpus left to the CPU tests")
    log(f"  {COLLECT_PROJECTS} projects (git {git_note}"
        f"), {COLLECT_LOGS} logs over {GCS_PAGES} pages, {n_cov} coverage "
        f"rows, {len(merged_issues)} issues; HTTP == DirFetcher, "
        f"{http_retries} retries as scripted; rq1 on the card == --device "
        f"cpu; the fault plan's run == the fault-free run ({fired}); bench "
        "diff, gate, keys")
    print(json.dumps({"collect": line}), flush=True)
    return line


def start_collect_child(args: list, name: str, procs: list):
    """``python <args>`` in a child, its output under COLLECT_DIR; the
    child is added to ``procs``."""
    base = os.path.join(COLLECT_DIR, name)
    with open(base + ".out", "w") as out, open(base + ".log", "w") as err:
        proc = subprocess.Popen([sys.executable, *args], cwd=ROOT,
                                stdout=out, stderr=err, text=True)
    procs.append((proc, args, base, time.perf_counter()))
    return procs[-1]


def finish_collect_child(started, want_code: int = 0) -> tuple:
    """The child's (wall s, stdout); raises unless it exited
    ``want_code``."""
    proc, args, base, t0 = started
    try:
        code = proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    wall = time.perf_counter() - t0
    with open(base + ".out") as f:
        out = f.read()
    if code != want_code:
        with open(base + ".log") as f:
            raise AssertionError(f"{' '.join(args)} exited {code}: "
                                 f"{f.read()[-2000:]}")
    return wall, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls-per-window", type=int, default=KERNEL_INNER,
                    help="back-to-back kernel calls in each CUDA-event "
                    "timing window of phase 5 (default %(default)s)")
    ap.add_argument("--mesh-rank", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--pod-rank", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--pod-cli", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--fixture-server", default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.fixture_server is not None:  # phase 4d's loopback server
        return fixture_server(json.loads(args.fixture_server))
    if args.mesh_rank is not None:  # one rank of a phase 3g world
        return mesh_rank(json.loads(args.mesh_rank))
    if args.pod_rank is not None:  # one process of a phase 3h pod
        return pod_rank(json.loads(args.pod_rank))
    if args.pod_cli is not None:  # one process of a phase 3h fault cell
        return pod_cli(json.loads(args.pod_cli))
    if args.calls_per_window < 1:
        ap.error("--calls-per-window must be at least 1")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    # program/envFile.ini ships ``backend = auto``: every phase but 4c
    # measures the device engine, so this process and its children pin it
    # (phase 4c sets ``auto`` where it drives the router).
    os.environ["TSE1M_BACKEND"] = "jax_tpu"
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    phase("phase 1: build")

    # The native host layer (g++): the sqlite decoder and the delta
    # grouper run on the main path; Postgres's decoder is not driven.  It
    # builds on a thread while ninja builds the kernels.
    def build_native() -> float:
        t0 = time.perf_counter()
        for which in ("decode", "encode"):
            if not native.loaded(which):
                raise AssertionError(f"native {which} library did not build "
                                     f"or load into {native.BUILD_DIR}")
        return time.perf_counter() - t0

    with ThreadPoolExecutor(1) as pool:
        native_built = pool.submit(build_native)
        _build.load_extension()
        log(f"  built {', '.join(_build.SOURCES)} in "
            f"{_build.build_seconds:.1f} s")
        log(f"  native decode.cc, encode.cc built and loaded in "
            f"{native_built.result():.1f} s, beside the kernels")

    hp = make_params("kminhash", N_HASHES, 0).to(dev)
    items, truth = synth_session_sets(N_SESSIONS, SET_SIZE, seed=0)
    phase("phase 2: kernel checks (tolerance: exact)")
    errs = minhash_checks(dev, hp.arrays)
    errs["cminhash_binmin"] = cminhash_checks(dev)
    plan = default_run_lanes(items)
    errs["rans_decode"] = rans_checks(plan, dev)
    errs["topk_chunk"] = topk_checks(dev)

    errs["minhash_and_keys"] = max(errs["minhash_and_keys"],
                                   novel_shape_checks(dev, hp.arrays))
    errs["topk_chunk"] = max(errs["topk_chunk"], scan_chunk_checks(dev))

    phase(f"phase 3: main path, {N_SESSIONS} sessions x {SET_SIZE} ids")
    small_input_check(items, truth, dev)
    plain10 = run_plain(items, truth, 0, "minhash_and_keys", hp, dev)
    plain24 = run_plain(items, truth, -1, "minhash_and_keys_packed", hp, dev)
    del plain24["sig"]
    run_forced(dev)
    default = run_default(items, truth, plan, plain10["labels"], hp, dev)
    cmin = run_cminhash(items, truth, plan, dev)
    run_weighted(dev)
    topk = run_topk(plain10.pop("sig"), dev)
    launches = {"minhash_and_keys": plain10["counts"]["minhash_and_keys"],
                "cminhash_binmin": cmin["counts"]["cminhash_binmin"],
                "minhash_and_keys_packed":
                    plain24["counts"]["minhash_and_keys_packed"],
                "rans_decode": default["counts"]["rans_decode"],
                "topk_chunk": topk["counts"]["topk_chunk"]}

    phase(f"phase 3b: warm path, {WARM_BASE} then {WARM_ROWS} sessions x "
          f"{SET_SIZE} ids through a signature store")
    warm = warm_phase(dev)

    phase(f"phase 3c: serving, a daemon over phase 3b's {WARM_BASE}-row "
          f"store, the {WARM_ROWS - WARM_BASE}-row tail ingested over TCP")
    serve = serve_phase(warm, dev)
    serve_launches = {}
    for counts in serve["launches"].values():
        for name, n in counts.items():
            serve_launches[name] = serve_launches.get(name, 0) + n


    phase(f"phase 3d: resilience at {N_SESSIONS} sessions x {SET_SIZE} ids: a "
          "killed run resumed, a real out-of-memory, the calibrated step, "
          "stalls and device retries")
    resil = resilience_phase(items, {"a": plain10["labels"],
                                     "b": plain24["labels"],
                                     "c": default["labels"]}, default, dev)

    phase(f"phase 3e: the sharded serving plane, {SHARDS} digest-range "
          f"daemons over phase 3b's {WARM_ROWS} rows behind a router, a "
          "shard writer SIGKILLed and replaced, a read replica, backfill")
    sharded = sharded_phase(warm, dev)

    phase("phase 3f: device tooling: (c) under cluster --profile in a child, "
          "(w2) under a device trace, (b), (w3) and (w5) warm under "
          "sanitized(0), the sanitizer's self-check")
    tooling_phase(items, default, plain24, warm, dev)
    del warm["oracle"]

    phase(f"phase 3g: the mesh on one card: (m1) a world of 1 on NCCL, (m4) "
          f"{MESH_RANKS} gloo ranks in process and as cluster commands, "
          f"(m3c) {MESH_CMIN_RANKS} cminhash ranks; (h-m2) after phase 4b")
    mesh = mesh_phase(items, truth, plain24["labels"], dev)

    phase(f"phase 3h: the pod on one card: (p2) {POD_PROCESSES} processes "
          f"cold over {WARM_BASE} rows, warm over {WARM_ROWS}; (p-kill), "
          f"(p-lead), (p-zombie) at {POD_FAULT_ROWS} rows")
    pod = pod_phase(warm, dev)
    del warm["items"]

    phase(f"phase 3i: the schedule explorer on the card: serve and router, "
          f"{EXPLORE_SEEDED} seeded schedules and the depth-{EXPLORE_BOUND} "
          "enumeration each, signer='device'; the committed strings replayed")
    trace = explorer_phase(dev)

    phase(f"phase 4: the RQ path, the golden study's eight artifacts and a "
          f"{RQ_SPEC['n_projects']}-project study, its suite (tolerance: "
          f"exact, Spearman and mean {RQ_TOL}) and all six drivers")
    rq = rq_phase(dev)
    phase(f"phase 4c: the auto router over phase 4's study, {AUTO_ROUNDS} "
          "rounds of the six RQs and the suite, then all over the golden "
          "study under TSE1M_BACKEND=auto")
    auto_router_phase(rq, dev)
    phase("phase 4b: the study arrives: phase 4's study as the collectors' "
          "CSVs (ingest) and as a pg_dump (restore), stats, the native "
          "decoder and the native delta grouper")
    study_load_phase(rq, items[plan["keep"]],
                     default["info"]["stages"]["stage_encode_s"], dev)

    phase(f"phase 3g (h-m2): all as {ALL_RANKS} ranks over phase 4's study; "
          "phase 4d beside its world")
    world = start_mesh_all(rq)
    try:
        phase(f"phase 4d: the collectors, no network: {COLLECT_PROJECTS} "
              f"projects, {COLLECT_LOGS} build logs over {GCS_PAGES} pages, "
              f"{COVERAGE_DAYS} days of coverage, {COLLECT_ISSUES} issues; "
              "DirFetcher, then HttpFetcher over loopback, then a fault "
              "plan; rq1 on the card; the round toolbelt")
        collect_phase(dev, world)
    except BaseException:
        stop_world(world)
        raise
    mesh_all(rq, mesh, world, "phase 4d")
    del rq
    log("  each all's graftlint and graftspec steps (s): " + ", ".join(
        f"{k} {v['graftlint']:.3f} + {v['graftspec']:.3f}"
        for k, v in CORRECTNESS_WALLS.items()))
    print(json.dumps({"correctness_steps_s": CORRECTNESS_WALLS,
                      "card": card_name_and_limit()}), flush=True)

    phase(f"phase 5: timing (CUDA events around {args.calls_per_window} "
          "calls, median)")
    times = timing(items, plan, dev, hp.arrays, topk, warm["scan_args"],
                   args.calls_per_window)
    times["rans_decode"] = times["rans_decode:rep"]

    kernels_line = [{
        "name": name, "route": "cuda", "source": k["source"],
        "replaces": k["replaces"], "launches": launches[name],
        "max_abs_err": errs[name], **times[name],
        "warm_launches": warm["launches"].get(name, 0),
        "serve_launches": serve_launches[name],
        "sharded_launches": sharded["launches"].get(name, 0),
        "resilience_launches": resil["launches"].get(name, 0),
        "mesh_launches": mesh["launches"].get(name, 0),
        "pod_launches": pod["launches"].get(name, 0),
        "trace_launches": trace["launches"].get(name, 0),
        "warm_shapes": {case.split(":")[1]: t for case, t in times.items()
                        if case.split(":")[0] == name
                        and case.endswith((":novel", ":scan"))},
    } for name, k in KERNELS.items()]
    card = card_name_and_limit()
    loaded = sorted(m for m in FORBIDDEN_MODULES if m in sys.modules)
    if loaded:
        raise AssertionError(f"the port imported {loaded}")
    log(f"total {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels_line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
