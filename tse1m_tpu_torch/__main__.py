"""Command line of the port: session clustering and the paper's RQs.

    python -m tse1m_tpu_torch cluster --n 1000000 --seed 0 \
        [--wire-quant-bits N] [--prefilter {off,auto,on}] \
        [--entropy {off,auto,force}] \
        [--scheme {kminhash,cminhash,weighted}] [--sig-store DIR] \
        [--checkpoint-dir DIR] [--ari-sample 10000] [--profile] \
        [--device cuda]
    python -m tse1m_tpu_torch scrub [DIR] [--repair] [--compact] \
        [--strict] [--verify-sigs [--verify-n 2000] [--verify-seed 0] \
        [--verify-set-size 64] [--verify-sample 256]]
    python -m tse1m_tpu_torch synth --db PATH [--projects 24] [--days 450] \
        [--seed 0] [--csv-dir DIR]
    python -m tse1m_tpu_torch ingest --csv-dir DIR [--db PATH]
    python -m tse1m_tpu_torch restore DUMP [--db PATH]
    python -m tse1m_tpu_torch stats [--db PATH]
    python -m tse1m_tpu_torch collect {projects,gcs-metadata,coverage,\
        buildlogs,issues,corpus} [--repo DIR] [--data-dir DIR] \
        [--no-clone] [--max-pages N] [--limit N] [--ids-file F] \
        [--workers 8]
    python -m tse1m_tpu_torch {rq1,rq2a,rq2b,rq3,rq4a,rq4b,all} --db PATH \
        --result-dir DIR [--limit-date 2025-01-08] \
        [--min-coverage-days 365] [--test-mode] [--corpus-csv PATH] \
        [--device cuda]
    python -m tse1m_tpu_torch serve --sig-store DIR [--host 127.0.0.1] \
        [--port 0] [--port-file F] [--seed 0] [--state-every 8] \
        [--device cuda]
    python -m tse1m_tpu_torch serve --root R --range N [--port-file F] \
        [--state-every 1] [--device cuda]
    python -m tse1m_tpu_torch serve --status {--port P | --port-file F}
    python -m tse1m_tpu_torch serve-router --root R [--shards 2] \
        [--host 127.0.0.1] [--shard-host 127.0.0.1] [--port 0] \
        [--port-file F]
    python -m tse1m_tpu_torch serve-replica --src DIR --dir DIR \
        [--interval 2.0] [--seed 0] [--port 0] [--port-file F] \
        [--device cuda]
    python -m tse1m_tpu_torch backfill --npy Q.npy \
        {--sig-store DIR | --port P | --port-file F} [--k 1] \
        [--batch 256] [--timeout S] [--seed 0] [--out F] [--device cuda]
    python -m tse1m_tpu_torch serve-client {ping,status,query,topk,ingest,\
        metrics,trace,slowlog,profile,quiesce,shutdown} \
        {--port P | --port-file F} [--npy V.npy] [--k 10] \
        [--mode {candidates,scan}] [--limit N] [--dump]
    python -m tse1m_tpu_torch lint [PATHS...] [--json] [--write-baseline] \
        [--no-baseline] [--rules R,...] [--changed REF] \
        [--why RULE:PATH:LINE] [--graph]
    python -m tse1m_tpu_torch spec {check,trace,mutants} [NAMES...] \
        [--mode {bfs,dfs}] [--max-states N] [--json]

``cluster`` synthesizes planted near-duplicate sessions, clusters them
with default ``ClusterParams`` (wire v3: at >= 64 MiB of ids the host
prefilter, the base-delta lane and the rANS lanes switch on), and prints
one JSON line:
ARI against the planted truth, the wire chosen, the wall and the stage
walls, and the ARI of the first ``--ari-sample`` rows' labels against the
host oracle's (``host_cluster``; the sample is clustered without the
store unless it is every row).  ``--scheme weighted`` also synthesizes
per-edge hit counts and expands each session into replica ids on the host
before clustering, as the JAX package's command line does.  With
``--sig-store DIR`` (default: the config's ``sig_store``, from
TSE1M_SIG_STORE or the INI) the run goes through the persistent signature
store, and the report adds ``sig_store`` and the ``cache_*`` keys: a
second run over the same sessions merges (``cache_mode: "merge"``).  With
``--checkpoint-dir DIR`` each chunk's signatures persist there as it
finishes (``cluster_sessions_resumable``): the same command after a kill
resumes at the first unfinished chunk, and a finished run empties the
directory.  The run is the ``cluster`` step of
``<result_dir>/run_manifest.json``, with the degradation events it
survived; the report adds ``chunk_halvings`` and ``degradation_events``.
With ``--profile`` the step runs under the host stack sampler, the
lock-wait recorder, the build histograms and a ``torch.profiler`` device
trace: ``profile_NNN.json`` lands next to ``run_manifest.json`` and the
Chrome trace under ``<result_dir>/device_trace/``; the report is the
unprofiled run's.  ``TSE1M_PROFILING=0`` wins over the flag.
The environment steers the long run's supervision: ``TSE1M_FAULT_PLAN``
(a fault plan's JSON), ``TSE1M_ROUTER_CAL`` (the machine calibration the
ladder writes), ``TSE1M_WATCHDOG*`` (the stage watchdog's budgets).

``scrub`` walks a signature store (default: the config's ``sig_store``):
opening it quarantines every shard that fails its CRC frame; the report
(the ``store_scrub_*`` keys, the ``scrub`` step of ``run_manifest.json``)
counts them.  ``--repair`` frames legacy shards, ``--compact`` folds the
shards into one, ``--verify-sigs`` recomputes a sample of stored
signatures on the host from the synthetic corpus, and ``--strict`` exits
1 when anything was corrupt.  A pod-sharded root scrubs every digest
range.

``synth`` writes a synthetic study into the sqlite file and its
corpus-analysis CSV (which RQ4a and RQ4b read) at the config's
``corpus_csv``; with ``--csv-dir`` it also writes the study as the
collectors' CSVs there (the JAX package's bytes).  ``ingest`` loads a
directory of collector CSVs (``<table>.csv``) into the study database,
upserting, so a corrected CSV updates its rows; ``restore`` loads a SQL
dump (pg_dump's COPY blocks or INSERT statements, the reference's
``backup_clean.sql``); both print their row counts as one JSON line.
``stats`` prints the study's inventory as the JAX package does: table
sizes, the projects' build frequency, the eligible projects and the
regression-tracked issues by severity.  These four are host work only
and touch no device; the database is the config's engine (sqlite at
``--db``, or the INI's Postgres server).

``rq1`` ... ``rq4b`` run one research question over a sqlite study on the
card, printing the reference transcript's lines and writing its CSVs
under ``--result-dir``; ``all`` runs the six in the JAX package's order,
each to completion whatever the others do.  Every step is recorded in
``<result-dir>/run_manifest.json``, and the exit code is 1 when any step
failed.  The defaults of ``--db``, ``--result-dir``, ``--limit-date``,
``--test-mode`` and ``--corpus-csv`` (and synth's corpus CSV) come from
``load_config``: the INI at TSE1M_ENVFILE (else program/envFile.ini),
then TSE1M_SQLITE_PATH, TSE1M_CORPUS_CSV, TSE1M_RESULT_DIR and
TSE1M_TEST_MODE.

``serve`` runs the serving daemon (``serve.ServeDaemon`` behind a
``ServeServer``) over a signature store (``--sig-store``, default the
config's ``sig_store``) until a ``shutdown`` request, SIGTERM or SIGINT;
``--port-file`` receives the bound port.  Clients stream coverage
vectors in (``serve-client ingest --npy``, durably acknowledged) and ask
which cluster a vector is in (``query``) or which k stored sessions are
nearest (``topk``, ``--mode scan`` scores every stored row on the card).
``serve --status`` is a client: it prints a running daemon's status and
records it as the ``serve_status`` step in
``<result_dir>/run_manifest.json``.  ``serve-client`` sends one request
and prints the JSON answer; it exits 1 on an error answer.

Shard mode, ``serve --root R --range N``: the daemon serves
``R/range_NNNN`` as the single writer of digest range N, claims the
range's lease at the next epoch (``R/lease_NNNN.json``; the writer it
replaces is fenced), beats ``R/hb_NNN.json``, commits its LSH state every
generation unless ``--state-every`` says otherwise, and writes its port
to ``R/serve_NNNN.port`` unless ``--port-file`` is given.
``serve-router --root R --shards N`` fronts N such daemons through their
port files, with the single daemon's verbs; a forward to a shard that
does not answer retries for three heartbeat timeouts, the window a dead
writer's replacement has to start in (``serve/router.py:failover_policy``).
``serve-replica --src DIR --dir DIR`` pulls the writer's committed files
into ``--dir`` every ``--interval`` seconds and serves reads of them;
ingest refuses.  ``backfill --npy Q.npy`` prints, for every query vector,
the k nearest stored sessions by exact signature agreement (the scan):
in process over ``--sig-store DIR`` (read only), or through the ``topk``
verb of a running daemon or router (``--port``/``--port-file``); one
JSON summary line, the results inline or in ``--out``.

Under ``TSE1M_COORDINATOR`` (rank 0's ``host:port``, or a ``tcp://`` or
``file://`` URL), ``TSE1M_NUM_PROCESSES`` and ``TSE1M_PROCESS_ID``, one
process a rank, ``cluster`` and the RQ commands run as a world
(``parallel/multihost.py``; rank r on card ``r % device_count``, NCCL
when every rank has a card of its own, gloo when ranks share one or run
on the CPU): ``cluster`` feeds each rank its own block of rows to the
band-sharded run and process 0 merges the ranks' manifest fragments
(``run_manifest.pNNN.json``) into ``run_manifest.json``; the RQ
commands shard the backend's reductions over the world and rank 0 alone
writes the artifacts and prints the transcript.

``cluster --sig-store DIR`` under ``TSE1M_NUM_PROCESSES`` and
``TSE1M_PROCESS_ID`` (``TSE1M_COORDINATOR`` is not needed), or over a
pod-sharded root, is the pod path (``run_pod_cluster``) and starts no
world: each process probes its own rows against the digest-range sharded
store, MinHashes its novel tail on its card, swaps the tails through files
under ``DIR/pod/`` and runs the LSH tail on its card; heartbeats, epoch
leases and the membership ledger turn a dead peer into a failover
(``pod_failover``; ``leader_promoted`` when process 0 died), and a woken
zombie writer fences itself.  Process 0, or the survivor, merges the
fragments into ``run_manifest.json``, the membership epoch in each.

``lint`` runs graftlint over the port's own code (``tse1m_tpu_torch/``;
``lint/``: the JAX package's 13 per-file rules and eight project passes,
suppressions with reasons, the baseline ``lint/baseline.json``); exit 0
clean, 1 on a new finding, 2 on a usage error.  ``spec`` model-checks the
protocol specs (``spec/``: ``lease``, ``ingest_ack``, ``replica``):
``check`` exits 1 on a violation and 2 on an unknown name, ``trace``
prints a violation's counterexample and its ``v1:fix:...`` replay string
(mutants too), ``mutants`` runs the committed mutants, each of which must
be caught and replay.  ``all`` records both, as the steps ``graftlint``
and ``graftspec``, before the six RQs.

``cluster``, ``serve``, ``serve-replica``, ``backfill`` and the RQ
commands run on the card unless ``--device cpu`` is given, and fail
without one; ``serve-router`` holds no device; ``synth`` and ``scrub``
are host work, as are ``ingest``, ``restore``, ``stats``, ``lint``,
``spec`` and ``collect``.

``collect`` runs one of the JAX package's six collection steps
(``collect/``): ``projects`` (an oss-fuzz checkout's project.yaml files
and first commits; cloned unless ``--no-clone``), ``gcs-metadata`` (the
build-log bucket listing), ``coverage`` (daily reports per project),
``buildlogs`` (``--workers`` threads fetch and parse the logs),
``issues`` (scrape the ids of ``--ids-file`` with selenium, then merge
and normalize) and ``corpus`` (seed-corpus history; GitHub merge times
with GITHUB_TOKEN).  Its CSVs equal the JAX package's byte for byte.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from .cluster import (ClusterParams, adjusted_rand_index, cluster_sessions,
                      host_cluster)
from .cluster.pipeline import cluster_sessions_resumable, last_run_info
from .cluster.schemes import expand_weighted
from .config import load_config
from .data import synth_session_hitcounts, synth_session_sets
from .device import resolve_device
from .observability import peek_degradation_events
from .utils.atomic import atomic_write


def _cmd_cluster(args) -> int:
    """``cluster``: one ``cluster`` step into the result directory's
    ``run_manifest.json`` (its degradation events attached), the report
    printed as one JSON line.  The device is resolved first: without a
    card it raises before any manifest is written.

    Under ``TSE1M_COORDINATOR``/``TSE1M_NUM_PROCESSES``/``TSE1M_PROCESS_ID``
    (``parallel/multihost.py``) every process is one rank of a world: it
    synthesizes every row (the planted truth's permutation is global) but
    feeds only its own contiguous block to its device, every rank gets the
    labels of the band-sharded run, and each writes a manifest fragment
    that process 0 merges into one ``run_manifest.json``.  A signature
    store under ``TSE1M_NUM_PROCESSES``, or a pod-sharded root, is the pod
    path (``run_pod_cluster``), which starts no world: process 0 or the
    failover survivor merges the fragments."""
    from .cluster.store import is_sharded_root
    from .observability import profiling
    from .observability.merge import fragment_manifest_path
    from .parallel import multihost
    from .utils.runner import StepRunner

    dev = resolve_device(args.device)
    result_dir = load_config().result_dir
    # The route decides the runtime: a store under a multi-process
    # environment, or a sharded root, is the pod path, which takes its
    # identity from the environment and never starts a world (a dead
    # peer, the leader too, is a heartbeat timeout, not a hung
    # collective).  Only the storeless mesh starts one.
    env_nproc, env_pid = multihost.pod_process_env()
    pod_route = bool(args.sig_store) and (
        env_nproc > 1 or is_sharded_root(args.sig_store))
    if pod_route:
        distributed = False
        nproc, pid = env_nproc, env_pid
    else:
        distributed = multihost.initialize_from_env(device=dev)
        pid, nproc = ((torch.distributed.get_rank(),
                       torch.distributed.get_world_size()) if distributed
                      else (0, 1))
    if nproc > 1:
        manifest_path = fragment_manifest_path(result_dir, pid)
        if os.path.exists(manifest_path):  # a previous run's fragment
            os.remove(manifest_path)
    else:
        manifest_path = os.path.join(result_dir, "run_manifest.json")
    runner = StepRunner(manifest_path)
    report: dict = {}
    # --profile: the step under the host sampler and a device trace,
    # profile_NNN.json next to run_manifest.json.  The kill switch
    # (TSE1M_PROFILING=0) wins over the flag.
    prof_on = args.profile and profiling.profiling_enabled()
    if prof_on:
        profiling.install_compile_listener()
        profiling.enable_lock_wait(True)
        profiling.start_sampler()
    try:
        with profiling.device_trace(
                os.path.join(result_dir, "device_trace")
                if prof_on else None):
            rec = runner.run("cluster", _run_cluster_step, args, dev,
                             report, distributed, pod_route)
    finally:
        if prof_on:
            prof_path = profiling.dump_profile(
                extra={"step": "cluster", "n": int(args.n)}, d=result_dir)
            profiling.stop_sampler()
            profiling.enable_lock_wait(False)
            logging.getLogger("tse1m_tpu_torch.cluster").info(
                "cluster: profile -> %s", prof_path)
    close_cluster_step(runner, rec, report, result_dir, nproc, pid,
                       pod_route)
    if distributed:
        multihost.shutdown()
    if rec.status != "ok":
        print(f"cluster failed: {rec.error}\n{rec.traceback}",
              file=sys.stderr)
        return 1
    print(json.dumps(report))
    return 0


def close_cluster_step(runner, rec, report: dict, result_dir: str,
                       nproc: int, pid: int, pod_route: bool) -> None:
    """The end of a ``cluster`` step: the pod's membership epoch as
    manifest meta, the report into the step's record, and across
    processes the fragments merged into ``run_manifest.json`` by process
    0, or by the pod's failover survivor."""
    from .observability.merge import merge_run_manifests
    from .parallel import multihost

    if report.get("pod_epoch") is not None:
        runner.set_meta(epoch=report["pod_epoch"])
    if rec.status == "ok":
        runner.record_result(rec, report)
    merges = nproc > 1 and (pid == 0 or report.get("pod_survivor") == pid)
    if not pod_route:
        # The step runner writes a fragment when its step starts and
        # again when it ends: the barrier holds the merge until every
        # rank's last write is done.
        multihost.all_processes_ready("cluster-manifest")
    elif merges:
        # No world, so no barrier: the leader, or the failover survivor,
        # gives slower peers one heartbeat timeout to land their fragments.
        _await_fragments(result_dir, nproc)
    if merges:
        merged = merge_run_manifests(result_dir, nproc)
        logging.getLogger("tse1m_tpu_torch.cluster").info(
            "manifest merged from %s (missing: %s)",
            merged["pod"]["merged_from"], merged["pod"]["missing"])


def _await_fragments(result_dir: str, nproc: int) -> None:
    """Wait up to one heartbeat timeout for every process's manifest
    fragment: a dead peer's is recorded missing, never waited on."""
    from .observability.merge import fragment_manifest_path
    from .resilience.coordinator import heartbeat_timeout_s
    from .resilience.watchdog import deadline_clock

    deadline = deadline_clock() + heartbeat_timeout_s()
    while deadline_clock() < deadline:
        if all(os.path.exists(fragment_manifest_path(result_dir, p))
               for p in range(nproc)):
            return
        time.sleep(0.2)


def run_pod_cluster(items, n: int, params, device="cuda"):
    """Store-enabled clustering across pod processes: ``cluster``'s pod
    route.  Returns ``(labels, pod_report)``.

    The identity comes from the environment (``pod_process_env``); no
    ``torch.distributed`` world starts.  The leader bootstraps this run's
    membership epoch (re-admitting a recovered process through the
    elastic re-deal) and peers adopt it; each process beats heartbeats,
    watches its peers and feeds its own rows through
    ``cluster_sessions_pod`` under epoch leases.

    A peer whose heartbeat stops is declared lost.  The lowest-id survivor
    fails over (``pod_failover``): it advances the epoch, the lost
    processes' ranges re-deal to it, and it re-executes the whole
    partition alone; every other survivor re-raises.  When process 0 is
    among the lost the survivor promotes itself (``leader_promoted``) and
    merges the fragments.  A zombie, this process woken after its ranges
    were re-dealt, meets its superseded lease at its first append: the
    store demotes to read-only and ``LeaseSupersededError`` propagates with
    zero rows written."""
    from .cluster.pipeline import cluster_sessions_pod
    from .cluster.store import ShardedSignatureStore
    from .observability import record_degradation
    from .parallel import multihost
    from .resilience.coordinator import (HostLostError, LeaseSupersededError,
                                         MembershipLedger, PodSupervisor,
                                         exchange_dir, negotiate_run_nonce)

    log = logging.getLogger("tse1m_tpu_torch.cluster")
    nproc, pid = multihost.pod_process_env()
    items = np.ascontiguousarray(items, dtype=np.uint32)
    pod: dict = {"pod_process_id": pid}
    pod_dir = os.path.join(params.sig_store, "pod")
    ledger = MembershipLedger(
        pod_dir, ShardedSignatureStore.root_n_ranges(params.sig_store,
                                                     default=nproc))
    if nproc == 1:
        # A one-member pod: bootstrapping the ledger is what inherits the
        # dead peers' ranges, or re-admits this process, at an epoch.
        nonce = negotiate_run_nonce(None)
        membership = ledger.bootstrap([pid], nonce)
        labels = cluster_sessions_pod(items, n, params, device=device,
                                      membership=membership,
                                      n_processes=1, process_id=pid)
        pod.update(pod_epoch=membership["epoch"])
        return labels, pod
    sup = PodSupervisor(pod_dir, nproc, pid).start()
    nonce = None  # unset when the leader dies before publishing
    try:
        try:
            nonce = negotiate_run_nonce(sup, pod_dir=pod_dir)
            if pid == 0:
                membership = ledger.bootstrap(list(range(nproc)), nonce)
            else:
                membership = ledger.wait_for(nonce, monitor=sup.monitor)
            sup.monitor.advance_epoch(membership["epoch"])
            xch = exchange_dir(pod_dir, nonce, sweep_stale=pid == 0)
            lo, hi = multihost.pod_row_range(n, nproc, pid)
            labels = cluster_sessions_pod(items[lo:hi], n, params,
                                          device=device, supervisor=sup,
                                          exchange_dir=xch,
                                          membership=membership,
                                          n_processes=nproc,
                                          process_id=pid)
            pod.update(pod_epoch=membership["epoch"])
            return labels, pod
        except LeaseSupersededError as e:
            # The zombie: nothing was written; the fragment records it.
            log.error("pod: this process is fenced (%s); exiting without "
                      "appending", e)
            raise
        except HostLostError as e:
            survivors = sup.survivors()
            if not survivors or pid != min(survivors):
                raise  # one process fails over; the rest exit loudly
            record_degradation("pod_failover", site="cli.cluster",
                               detail={"lost": e.lost, "survivor": pid})
            promoted = 0 in e.lost and pid != 0
            if promoted:
                record_degradation("leader_promoted", site="cli.cluster",
                                   detail={"from_process": 0,
                                           "to_process": pid})
                log.warning("pod: leader (process 0) lost; process %d "
                            "promoting itself — it owns the next epoch "
                            "and merges the manifest fragments", pid)
            membership = ledger.advance([pid], nonce or os.urandom(8).hex(),
                                        reason="host_lost")
            sup.monitor.advance_epoch(membership["epoch"])
            log.warning(
                "pod: host(s) %s lost at %s; process %d failing over at "
                "epoch %d — re-executing solo with their digest ranges "
                "re-dealt (superseded leases fence any zombie)",
                e.lost, e.site, pid, membership["epoch"])
            labels = cluster_sessions_pod(items, n, params, device=device,
                                          solo=True, membership=membership,
                                          process_id=pid)
            pod.update(pod_survivor=pid, pod_lost=e.lost,
                       pod_epoch=membership["epoch"],
                       pod_promoted_leader=promoted)
            return labels, pod
    finally:
        sup.stop()


def _cluster_labels(args, items, params, dev, distributed: bool,
                    pod_route: bool = False, pod_report: dict | None = None):
    """The run's labels: band-sharded over the world's mesh, each process
    feeding its own block, or single-device (resumable from
    ``--checkpoint-dir``), or the pod path's (its report into
    ``pod_report``)."""
    if pod_route:
        if args.checkpoint_dir:
            logging.getLogger("tse1m_tpu_torch.cluster").warning(
                "--checkpoint-dir is ignored on the pod path: the sharded "
                "signature store IS the durable state (novel signatures "
                "append per chunk); this run has no chunk checkpoints")
        labels, pod = run_pod_cluster(items, args.n, params, device=dev)
        pod_report.update(pod)
        return labels
    if not distributed:
        return cluster_sessions_resumable(
            items, params, checkpoint_dir=args.checkpoint_dir, device=dev)
    from .parallel import multihost

    if args.checkpoint_dir:
        logging.getLogger("tse1m_tpu_torch.cluster").warning(
            "--checkpoint-dir is ignored under multi-host: per-chunk "
            "checkpointing is single-process only (give each process its "
            "own directory and the resumable API if you need it); this "
            "run is NOT checkpointed")
    mesh = multihost.global_mesh()
    lo, hi = multihost.local_row_range(
        multihost.padded_row_count(args.n, mesh))
    rows, _ = multihost.put_process_local_padded(
        np.ascontiguousarray(items[lo:min(hi, args.n)], dtype=np.uint32),
        args.n, mesh)
    labels = cluster_sessions(rows, params, mesh=mesh, device=dev)[:args.n]
    multihost.all_processes_ready("cluster-report")
    return labels


def _run_cluster_step(args, dev, report: dict, distributed: bool,
                      pod_route: bool = False) -> None:
    items, truth = synth_session_sets(args.n, seed=args.seed)
    if args.scheme == "weighted":
        items = expand_weighted(
            items, synth_session_hitcounts(items, truth, seed=args.seed))
    params = ClusterParams(seed=args.seed, prefilter=args.prefilter,
                           entropy=args.entropy,
                           wire_quant_bits=args.wire_quant_bits,
                           scheme=args.scheme, sig_store=args.sig_store)
    t0 = time.perf_counter()
    pod_report: dict = {}
    labels = _cluster_labels(args, items, params, dev, distributed,
                             pod_route, pod_report)
    wall = time.perf_counter() - t0
    info = dict(last_run_info)
    report.update({
        "n_sessions": args.n,
        "scheme": args.scheme,
        "set_width": int(items.shape[1]),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "n_clusters": int(np.unique(labels).size),
        "ari_vs_planted": round(float(adjusted_rand_index(labels, truth)), 5),
        "cluster_wall_s": round(wall, 4),
        "encoding": info.get("encoding"),
        "prefilter_rows_dropped": info.get("prefilter_rows_dropped"),
        "wire_quant_bits": info.get("wire_quant_bits"),
        "chunk_bits": info.get("chunk_bits"),
        "wire_mb": info.get("wire_mb"),
        "wire_v3_saved_mb": info.get("wire_v3_saved_mb"),
        # How often the run survived by degrading; the events themselves
        # go to the step's record in run_manifest.json.
        "chunk_halvings": int(info.get("chunk_halvings", 0)),
        "degradation_events": len(peek_degradation_events()),
        **info.get("stages", {}),
    })
    if "propagate_steps" in info:   # a mesh run's label propagation
        report["propagate_steps"] = info["propagate_steps"]
    if distributed:
        report["processes"] = torch.distributed.get_world_size()
    if args.checkpoint_dir and not (distributed or pod_route):
        report["checkpoint_dir"] = args.checkpoint_dir
    if args.sig_store:
        report["sig_store"] = args.sig_store
        report.update({k: v for k, v in info.items()
                       if k.startswith(("cache_", "pod_"))})
        report.update(pod_report)
    k = min(args.ari_sample, args.n)
    if k > 0:
        host_k = host_cluster(items[:k], n_hashes=params.n_hashes,
                              n_bands=params.n_bands, seed=params.seed,
                              scheme=params.scheme)
        # The sample runs without the store: its state for a k-row prefix
        # would replace the full run's.
        dev_k = (labels if k == args.n else cluster_sessions(
            items[:k], dataclasses.replace(params, sig_store=None),
            device=dev))
        report["ari_vs_host_sample"] = round(
            float(adjusted_rand_index(dev_k, host_k)), 5)
        report["ari_sample_n"] = k


def _cmd_scrub(args) -> int:
    """``scrub``: walk a signature store's frames (opening it quarantines
    what fails them) and report the ``store_scrub_*`` keys as the
    ``scrub`` step of ``run_manifest.json``; ``--verify-sigs`` recomputes
    a sample of stored signatures from the synthetic corpus on the host.
    Exit 1 when the step failed, or under ``--strict`` when corruption was
    found; 2 without a store directory."""
    from .cluster.store import (ShardedSignatureStore, SignatureStore,
                                is_sharded_root)
    from .utils.runner import StepRunner

    cfg = load_config()
    directory = args.store or cfg.sig_store
    if not directory:
        print("no store directory: pass one, or set TSE1M_SIG_STORE / the "
              "INI's sig_store", file=sys.stderr)
        return 2
    runner = StepRunner(os.path.join(cfg.result_dir, "run_manifest.json"))
    report: dict = {}

    def scrub_step() -> None:
        if is_sharded_root(directory):
            # Every digest range, opened under the root's own policy.
            with open(os.path.join(directory, "pod_topology.json"),
                      encoding="utf-8") as f:
                policy = json.load(f)["policy"]
            store = ShardedSignatureStore(directory, policy)
        else:
            store = SignatureStore.open_existing(directory)
        report.update(store.scrub(repair=args.repair, compact=args.compact))
        if args.verify_sigs:
            items, truth = synth_session_sets(
                args.verify_n, set_size=args.verify_set_size,
                seed=args.verify_seed)
            if store.policy.get("scheme") == "weighted":
                # A weighted store holds signatures of replica-expanded
                # rows: verify against the same expansion.
                items = expand_weighted(items, synth_session_hitcounts(
                    items, truth, seed=args.verify_seed))
            report.update(store.verify_signatures(
                items, sample=args.verify_sample, seed=args.verify_seed))
        report["store_scrub_dir"] = directory

    rec = runner.run("scrub", scrub_step)
    if rec.status != "ok":
        print(f"scrub failed: {rec.error}", file=sys.stderr)
        return 1
    runner.record_result(rec, report)
    print(json.dumps(report))
    corrupt = (report.get("store_scrub_corrupt", 0)
               + report.get("store_scrub_verify_mismatch", 0))
    if args.strict and corrupt:
        print(f"scrub found {corrupt} corrupt or mismatching shard(s) or "
              "row(s) (quarantined; their rows recompute on the next run)",
              file=sys.stderr)
        return 1
    return 0


def _cmd_synth(args) -> int:
    from .data.synth import SynthSpec, generate_study

    corpus_csv = load_config().corpus_csv
    study = generate_study(SynthSpec(n_projects=args.projects,
                                     days=args.days, seed=args.seed))
    study.to_db(args.db)
    if args.csv_dir:
        study.to_csv_dir(args.csv_dir)
    # RQ4 reads the corpus-analysis CSV from the config's corpus_csv
    # (rq4a_bug.py:34): a synthetic study always writes it there.
    study.write_corpus_csv(corpus_csv)
    print(f"wrote {len(study.buildlog_data['name']):,} builds, "
          f"{len(study.issues['number']):,} issues and "
          f"{len(study.total_coverage['date']):,} coverage rows to "
          f"{args.db}; corpus analysis CSV at {corpus_csv}"
          + (f"; CSVs in {args.csv_dir}" if args.csv_dir else ""))
    return 0


def _open_db(args):
    """The study database of a host command: the config's engine, with
    sqlite at ``--db``."""
    from .db.connection import DB

    return DB(config=dataclasses.replace(load_config(),
                                         sqlite_path=args.db)).connect()


def _cmd_ingest(args) -> int:
    from .db.ingest import ingest_csv_dir

    with _open_db(args) as db:
        counts = ingest_csv_dir(db, args.csv_dir)
    print(json.dumps({"ingested": counts}))
    return 0


def _cmd_restore(args) -> int:
    from .db.restore import restore_sql_dump

    with _open_db(args) as db:
        counts = restore_sql_dump(db, args.dump)
    print(json.dumps({"restored": counts}))
    return 0


def _cmd_stats(args) -> int:
    """The study's inventory, line for line the JAX package's: table
    sizes, the reference's project-frequency query (queries1.py:6-11) and
    the regression-tracked issues by severity over the eligible projects
    (queries1.py:104-118)."""
    from .db import queries
    from .db.ident import quote_ident

    cfg = load_config()
    with _open_db(args) as db:
        db.require_study_tables()
        for table in ("project_info", "buildlog_data", "total_coverage",
                      "issues"):
            n = db.query(f"SELECT COUNT(*) FROM {quote_ident(table)}")[0][0]
            print(f"{table:16s} {n:>12,} rows")
        freq = db.query(*queries.count_projects())
        print(f"projects         {len(freq):>12,} distinct "
              f"(top: {freq[0][0]} x{freq[0][1]})" if freq else
              "projects                    0 distinct")
        sql, params = queries.eligible_projects(cfg.min_coverage_days,
                                                cfg.limit_date)
        eligible = [r[0] for r in db.query(sql, params)]
        print(f"eligible         {len(eligible):>12,} projects "
              f"(>= {cfg.min_coverage_days} coverage days)")
        for severity in ("High", "Medium", "Low"):
            sql, params = queries.severity_issues(
                severity, eligible, db.dialect, cfg.limit_date)
            n = db.count(sql, params)
            print(f"severity {severity:7s} {n:>12,} regression-tracked issues")
    return 0


def _cmd_rq(args) -> int:
    """The RQ commands.  Under the ``TSE1M_*`` variables every process is
    one rank of a world: each runs the drivers over the same study, the
    backend's reductions sharded over the world's mesh, and rank 0 alone
    writes the CSVs, figures, manifests and transcript; the other ranks'
    copies go to a temporary directory that is removed."""
    import contextlib
    import tempfile

    from .analysis import RQ_DRIVERS, run_rqs
    from .parallel import multihost

    cfg = dataclasses.replace(
        load_config(), sqlite_path=args.db, result_dir=args.result_dir,
        limit_date=args.limit_date, min_coverage_days=args.min_coverage_days,
        test_mode=args.test_mode, corpus_csv=args.corpus_csv)
    names = tuple(RQ_DRIVERS) if args.cmd == "all" else (args.cmd,)
    # The device first: without a card this raises before any step runs
    # or any manifest is written.
    dev = resolve_device(args.device)
    distributed = multihost.initialize_from_env(device=dev)
    with contextlib.ExitStack() as stack:
        if distributed and torch.distributed.get_rank() != 0:
            cfg = dataclasses.replace(cfg, result_dir=stack.enter_context(
                tempfile.TemporaryDirectory(prefix="tse1m_rank_")))
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(os.devnull, "w"))))  # graftlint: disable=nonatomic-write -- os.devnull takes a non-zero rank's stdout (the port's ranks run all in a world; JAX's command runs in none): no file exists to tear
        runner = run_rqs(cfg, names, device=dev)
        if distributed:
            multihost.shutdown()
    for rec in runner.failed:
        print(f"step {rec.name} failed: {rec.error}\n{rec.traceback}",
              file=sys.stderr)
    return runner.exit_code()


def _cmd_spec(args) -> int:
    """graftspec commands (``spec {check,trace,mutants}``), with the JAX
    package's output and exit codes (``tse1m_tpu/cli.py:245-309``)."""
    from .spec import SpecError, build_spec, check, mutant_selftest

    log = logging.getLogger("tse1m_tpu_torch.spec")
    if args.action == "mutants":
        try:
            records = mutant_selftest(mode=args.mode)
        except SpecError as e:
            log.error("%s", e)
            return 1
        for name, rec in records.items():
            print(f"{name:24s} spec={rec['spec']:12s} caught "
                  f"{rec['kind']}:{rec['prop']} in {rec['states']} "
                  f"states, replayed: {rec['schedule']}")
        return 0

    names = list(args.names) or (["lease", "ingest_ack", "replica"]
                                 if args.action == "check" else [])
    if not names:
        raise SystemExit("spec trace needs a spec or mutant name")
    kwargs = {} if args.max_states is None \
        else {"max_states": args.max_states}
    results = []
    for name in names:
        try:
            spec = build_spec(name)
        except SpecError as e:
            log.error("%s", e)
            return 2
        results.append((name, check(spec, mode=args.mode, **kwargs)))
    bad = [(n, r) for n, r in results if not r.ok]
    if args.action == "trace":
        for name, r in results:
            if r.violation is None:
                print(f"{name}: no violation in {r.states} states "
                      f"(scope {r.scope})")
            else:
                print(f"{name}:")
                print(r.violation.describe())
                print(f"replay: {r.violation.schedule_str}")
        return 1 if bad else 0
    if args.json:
        print(json.dumps([dict(r.summary(), requested=n)
                          for n, r in results]))
    else:
        for name, r in results:
            status = ("ok" if r.ok else
                      f"VIOLATION {r.violation.kind}:{r.violation.prop}")
            print(f"{name:12s} {status}  states={r.states} "
                  f"transitions={r.transitions} depth={r.depth} "
                  f"wall={r.wall_s * 1000:.1f}ms")
        for name, r in bad:
            print(r.violation.describe())
            print(f"replay: {r.violation.schedule_str}")
    return 1 if bad else 0


def _cmd_collect(args) -> int:
    """One offline collection step (C3-C8), the JAX package's
    ``collect`` command.  Network steps use an HttpFetcher with the
    reference's politeness and retry policy; every output lands in
    ``--data-dir`` in the layouts ``ingest`` reads.  No device work."""
    from datetime import date, timedelta

    from .collect import table
    from .collect.transport import FetchPolicy, HttpFetcher

    data_dir = args.data_dir
    os.makedirs(data_dir, exist_ok=True)
    if args.step == "projects":
        from .collect.projects import OSS_FUZZ_URL, run_project_info_collector

        run_project_info_collector(
            args.repo, os.path.join(data_dir, "project_info.csv"),
            clone_url=None if args.no_clone else OSS_FUZZ_URL)
    elif args.step == "gcs-metadata":
        from .collect.gcs_metadata import GcsMetadataCollector

        fetcher = HttpFetcher(FetchPolicy(retries=5, backoff_factor=1.0,
                                          politeness_delay=5.0,
                                          timeout=30.0))
        coll = GcsMetadataCollector(
            fetcher, os.path.join(data_dir, "buildlog_metadata_batches"),
            max_pages=args.max_pages)
        coll.collect(os.path.join(data_dir, "buildlog_metadata.csv"))
    elif args.step == "coverage":
        from .collect.coverage import CoverageCollector

        info = table.read_csv(os.path.join(data_dir, "project_info.csv"))
        fetcher = HttpFetcher(FetchPolicy(politeness_delay=0.5))
        coll = CoverageCollector(
            fetcher, os.path.join(data_dir, "coverage_by_project"),
            finish_date=date.today() - timedelta(days=2))
        coll.collect_all(info, os.path.join(data_dir, "total_coverage.csv"))
    elif args.step == "buildlogs":
        import glob

        from .collect.buildlogs import BuildLogAnalyzer
        from .collect.normalize import buildlog_table_rows

        meta = table.read_csv(os.path.join(data_dir, "buildlog_metadata.csv"))
        batch_dir = os.path.join(data_dir, "buildlog_analyzed_batches")
        # With workers > 1 the fetcher's lock serializes request starts, so
        # the politeness delay bounds the total request rate (~10 req/s).
        an = BuildLogAnalyzer(HttpFetcher(FetchPolicy(politeness_delay=0.1)),
                              batch_dir, limit=args.limit,
                              workers=args.workers)
        an.analyze(meta)
        frames = [table.read_csv(f) for f in
                  sorted(glob.glob(os.path.join(batch_dir, "*.csv")))]
        if frames:
            table.write_csv(buildlog_table_rows(table.concat(frames)),
                            os.path.join(data_dir, "buildlog_data.csv"))
    elif args.step == "issues":
        from .collect.issues import merge_window_csvs, plan_run, scrape_issues
        from .collect.normalize import issue_table_rows

        results_dir = os.path.join(data_dir, "issue_scraping_results")
        targets = set()
        if args.ids_file and os.path.exists(args.ids_file):
            with open(args.ids_file, encoding="utf-8") as f:
                targets = {int(ln) for ln in f if ln.strip().isdigit()}
        plan = plan_run(targets, results_dir)
        if plan:
            from .collect.issues_selenium import SeleniumIssueClient

            scrape_issues(SeleniumIssueClient, plan, results_dir,
                          num_workers=args.workers)
        merged_csv = os.path.join(data_dir, "issues_merged.csv")
        if merge_window_csvs(results_dir, merged_csv):
            table.write_csv(
                issue_table_rows(table.read_csv(merged_csv,
                                                json_cells=True)),
                os.path.join(data_dir, "issues.csv"))
    elif args.step == "corpus":
        from .collect.corpus import (GitHubMergeTimeResolver,
                                     run_corpus_collector)

        resolver = GitHubMergeTimeResolver(
            fetcher=HttpFetcher(FetchPolicy()),
            token=os.environ.get("GITHUB_TOKEN"))
        run_corpus_collector(
            args.repo,
            os.path.join(data_dir, "project_corpus_analysis.csv"), resolver)
    return 0


def _cmd_lint(args) -> int:
    """graftlint over the port (``lint``): ``lint.main`` with these
    flags."""
    from .lint import main as lint_main

    argv = list(args.paths)
    for flag in ("json", "write_baseline", "no_baseline", "graph"):
        if getattr(args, flag):
            argv.append("--" + flag.replace("_", "-"))
    for opt in ("rules", "changed", "why"):
        if getattr(args, opt):
            argv += ["--" + opt, getattr(args, opt)]
    return lint_main(argv)


def _serve_client(args):
    """The target daemon (``--port``, else the port file) -> ServeClient."""
    from .serve import ServeClient

    port = args.port
    if not port and args.port_file and os.path.exists(args.port_file):
        with open(args.port_file, encoding="utf-8") as f:
            port = int(f.read().strip())
    if not port:
        raise SystemExit("no daemon address: pass --port or --port-file")
    return ServeClient(host=args.host, port=port)


def _serve_status(args) -> int:
    """``serve --status``: one status request, printed and recorded as
    the ``serve_status`` step of the result directory's manifest."""
    from .utils.runner import StepRunner

    cfg = load_config()
    runner = StepRunner(os.path.join(cfg.result_dir, "run_manifest.json"))
    got: dict = {}

    def status_step() -> None:
        with _serve_client(args) as client:
            got.update(client.status())

    rec = runner.run("serve_status", status_step)
    if rec.status != "ok":
        print(f"serve --status failed: {rec.error}", file=sys.stderr)
        return 1
    runner.record_result(rec, got)
    print(json.dumps(got))
    for verb, snap in sorted((got.get("latency_by_verb") or {}).items()):
        logging.getLogger("tse1m_tpu_torch.serve").info(
            "serve %s: n=%d p50=%.2fms p99=%.2fms", verb,
            int(snap.get("count", 0)), float(snap.get("p50_ms", 0.0)),
            float(snap.get("p99_ms", 0.0)))
    return 0


def _cmd_serve(args) -> int:
    """The serving daemon over one signature store, until a ``shutdown``
    request or a signal; ``--status`` pings a running daemon instead."""
    if args.status:
        return _serve_status(args)
    from .observability.flight import dump_flight
    from .serve import ServeDaemon, ServeServer, SloPolicy

    store = args.sig_store or load_config().sig_store
    guard = heartbeat = None
    state_every = args.state_every
    if args.range is not None:
        # Shard mode: the single writer of one digest range of a sharded
        # serve root, fenced by the range's epoch lease.
        if not args.root:
            print("--range needs --root <sharded serve root>",
                  file=sys.stderr)
            return 2
        from .resilience.coordinator import HeartbeatWriter, RangeLeaseGuard

        resolve_device(args.device)  # no lease claimed without the card
        store = os.path.join(args.root, f"range_{args.range:04d}")
        guard = RangeLeaseGuard.claim(args.root, args.range,
                                      owner=os.getpid())
        # The router's PeerMonitor watches heartbeats keyed by range id.
        heartbeat = HeartbeatWriter(args.root,
                                    process_id=args.range).start()
        if state_every is None:
            # Every generation: a replacement writer keeps the local row
            # ids of every acked batch (serve/router.py's docstring).
            state_every = 1
        if not args.port_file:
            args.port_file = os.path.join(args.root,
                                          f"serve_{args.range:04d}.port")
    if state_every is None:
        state_every = 8
    if not store:
        print("no signature store: pass --sig-store, or set "
              "TSE1M_SIG_STORE / the INI's sig_store", file=sys.stderr)
        return 2
    daemon = ServeDaemon(store, params=ClusterParams(seed=args.seed),
                         slo=SloPolicy.from_env(),
                         state_commit_every=state_every,
                         device=args.device, lease_guard=guard).start()
    try:
        _serve_forever(
            ServeServer(daemon, host=args.host, port=args.port), "serve",
            args.port_file,
            on_signal=lambda signum: dump_flight(
                "sigterm", site="serve.shutdown",
                extra={"signal": int(signum)}))
    finally:
        if heartbeat is not None:
            heartbeat.stop()
        daemon.stop()
    return 0 if daemon._ingest_error is None else 1


def _serve_forever(server, name: str, port_file: str | None,
                   on_signal=None) -> None:
    """``server`` until a ``shutdown`` request, SIGTERM or SIGINT;
    ``on_signal(signum)`` runs first on a signal."""
    import signal
    import threading

    def _graceful(signum, frame):  # noqa: ARG001
        logging.getLogger("tse1m_tpu_torch.serve").warning(
            "%s: signal %d; shutting down", name, signum)
        if on_signal is not None:
            on_signal(signum)
        # shutdown() waits for serve_forever, which runs in this thread.
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    try:
        server.serve_until_shutdown(port_file=port_file)
    finally:
        server.server_close()


def _cmd_serve_router(args) -> int:
    """The fan-out router over ``--shards`` digest-range shard daemons,
    each found through ``<root>/serve_NNNN.port`` (read again on every
    reconnect); no device, no store opened."""
    from .resilience.coordinator import PeerMonitor
    from .serve import RouterServer, ShardRouter, TcpTransport

    transports = {
        sid: TcpTransport(
            host=args.shard_host,
            port_file=os.path.join(args.root, f"serve_{sid:04d}.port"))
        for sid in range(args.shards)}
    monitor = PeerMonitor(args.root, n_processes=args.shards,
                          process_id=-1, peers=list(range(args.shards)))
    router = ShardRouter(transports, monitor=monitor)
    try:
        _serve_forever(RouterServer(router, host=args.host, port=args.port),
                       "serve-router", args.port_file)
    finally:
        router.close()
    return 0


def _cmd_serve_replica(args) -> int:
    """A read replica over a streamed copy of ``--src`` in ``--dir``:
    the first pull before serving, then one every ``--interval``."""
    from .serve import (ReplicationPuller, ServeReplica, ServeServer,
                        stream_shards)

    dev = resolve_device(args.device)
    stream_shards(args.src, args.dir)
    replica = ServeReplica(args.dir, params=ClusterParams(seed=args.seed),
                           device=dev)
    puller = ReplicationPuller(args.src, replica,
                               interval_s=args.interval).start()
    try:
        _serve_forever(ServeServer(replica, host=args.host, port=args.port),
                       "serve-replica", args.port_file)
    finally:
        puller.stop()
    return 0


def _cmd_backfill(args) -> int:
    """Exact top-k of every query vector over every committed store row
    (the scan): in process over ``--sig-store`` or through a running
    daemon's or router's ``topk`` verb; one JSON summary line."""
    vectors = np.load(args.npy)
    n = int(vectors.shape[0])
    out = {"scores": [], "ids": [], "labels": []}
    if args.sig_store:
        from .serve import ServeReplica

        target = ServeReplica(args.sig_store,
                              params=ClusterParams(seed=args.seed),
                              device=args.device)
        store_rows = int(target.store.n_rows)

        def ask(batch):
            return target.topk(batch, k=args.k, mode="scan")
    else:
        client = _serve_client(args)
        st = client.status()
        # A router's status carries each shard's rows, not its own.
        store_rows = int(st.get("store_rows", sum(
            int(s.get("store_rows", 0))
            for s in (st.get("shard_status") or {}).values())))

        def ask(batch):
            return client.topk(batch, k=args.k, mode="scan",
                               timeout_s=args.timeout)
    t0 = time.monotonic()
    rows_scored = 0
    for lo in range(0, n, args.batch):
        resp = ask(np.ascontiguousarray(vectors[lo:lo + args.batch],
                                        np.uint32))
        out["scores"].extend(np.asarray(resp["scores"]).tolist())
        out["labels"].extend(np.asarray(resp["labels"]).tolist())
        out["ids"].extend(resp["ids"])
        rows_scored += store_rows * int(min(args.batch, n - lo))
    wall = time.monotonic() - t0
    if not args.sig_store:
        client.close()
    if args.out:
        with atomic_write(args.out) as f:
            json.dump(out, f)
    summary = {"ok": True, "queries": n, "k": int(args.k),
               "store_rows": store_rows,
               "pairs_scored": rows_scored,
               "wall_s": round(wall, 3),
               "pairs_scored_s": round(rows_scored / wall, 1)
               if wall > 0 else 0.0}
    if args.out:
        summary["out"] = args.out
    else:
        summary["results"] = out
    print(json.dumps(summary))
    return 0


def _cmd_serve_client(args) -> int:
    """One request to a running daemon; prints its JSON answer.
    ``query``/``topk``/``ingest`` read a [K, S] uint32 .npy (``--npy``)."""
    with _serve_client(args) as client:
        if args.op in ("query", "topk", "ingest"):
            if not args.npy:
                raise SystemExit(f"{args.op} needs --npy <vectors.npy>")
            vectors = np.load(args.npy)
            if args.op == "query":
                resp = client.query(vectors)
            elif args.op == "topk":
                resp = client.topk(vectors, k=args.k, mode=args.mode)
            else:
                resp = client.ingest(vectors)
            resp = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                    for k, v in resp.items()}
        elif args.op == "slowlog":
            resp = client.slowlog(args.limit)
        elif args.op == "profile":
            resp = client.profile(dump=args.dump)
        else:
            resp = getattr(client, args.op)()
    print(json.dumps(resp))
    return 0 if resp.get("ok", False) else 1


def build_parser() -> argparse.ArgumentParser:
    """The command line, its defaults from ``load_config()`` as it stands
    now (the INI, then the environment)."""
    ap = argparse.ArgumentParser(prog="python -m tse1m_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    env = load_config()
    p = sub.add_parser("cluster", help="MinHash+LSH session dedup on the GPU")
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--wire-quant-bits", type=int, default=0,
                   help="0 = auto (10 bits at >= 64 MB of ids), -1 = never, "
                        "1..32 = forced")
    p.add_argument("--prefilter", default="auto",
                   choices=("off", "auto", "on"),
                   help="wire v3 host LSH prefilter: rows bucketed "
                        "singleton in every host band skip the wire; labels "
                        "stay equal to the unfiltered run's")
    p.add_argument("--entropy", default="auto",
                   choices=("off", "auto", "force"),
                   help="wire v3 rANS lane coding: 'auto' codes the lanes "
                        "that beat their bit-packed form; 'force' codes all")
    p.add_argument("--scheme", default="kminhash",
                   choices=("kminhash", "cminhash", "weighted"),
                   help="signature family: 'kminhash' = K multiply-add "
                        "hashes (default); 'cminhash' = one permutation + "
                        "densification; 'weighted' = weighted minwise over "
                        "synthesized per-edge hit counts (replica "
                        "expansion on the host)")
    p.add_argument("--sig-store", default=env.sig_store,
                   help="persistent signature store directory "
                        "(cluster/store.py): a re-run probes it and hashes "
                        "only the rows it misses (default: the config's "
                        "sig_store, %(default)s)")
    p.add_argument("--ari-sample", type=int, default=10_000,
                   help="rows of the ARI check against the host oracle "
                        "(default %(default)s; 0 = off)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="persist each chunk's signature shard here; a "
                        "killed run re-invoked with the same directory "
                        "resumes at its first unfinished chunk")
    p.add_argument("--profile", action="store_true",
                   help="host sampling profiler (span/plane/lock-wait "
                        "attribution) + torch.profiler device trace + "
                        "build-time histograms around the run; writes "
                        "profile_NNN.json (and device_trace/) into the "
                        "result dir next to run_manifest.json. "
                        "TSE1M_PROFILING=0 kills the whole plane")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain versions")
    q = sub.add_parser("scrub", help="walk a signature store: verify its "
                       "CRC frames, quarantine corruption, report the "
                       "store_scrub_* keys; host only")
    q.add_argument("store", nargs="?", default=None,
                   help="store directory (default: the config's "
                        "sig_store, %s)" % env.sig_store)
    q.add_argument("--repair", action="store_true",
                   help="frame legacy (pre-CRC) shards and sweep orphans")
    q.add_argument("--compact", action="store_true",
                   help="fold the append shards into one")
    q.add_argument("--strict", action="store_true",
                   help="exit 1 when any corruption was found")
    q.add_argument("--verify-sigs", action="store_true",
                   help="recompute a sample of stored signatures from raw "
                        "rows on the host (store_scrub_verify_* keys)")
    q.add_argument("--verify-n", type=int, default=2000,
                   help="rows of the synthetic corpus to verify against")
    q.add_argument("--verify-seed", type=int, default=0)
    q.add_argument("--verify-set-size", type=int, default=64)
    q.add_argument("--verify-sample", type=int, default=256,
                   help="most sampled rows recomputed on the host")
    y = sub.add_parser("synth", help="write a synthetic study (sqlite) and "
                       "its corpus-analysis CSV; host only")
    y.add_argument("--db", default=env.sqlite_path,
                   help="sqlite study file (default %(default)s)")
    y.add_argument("--projects", type=int, default=24)
    y.add_argument("--days", type=int, default=450)
    y.add_argument("--seed", type=int, default=0)
    y.add_argument("--csv-dir", default=None,
                   help="also write the study as the collectors' CSVs "
                        "(<table>.csv) in this directory")
    g = sub.add_parser("ingest", help="load collector CSVs (<table>.csv) "
                       "into the study database; host only")
    g.add_argument("--db", default=env.sqlite_path,
                   help="sqlite study file (default %(default)s)")
    g.add_argument("--csv-dir", required=True)
    g = sub.add_parser("restore", help="restore a SQL dump (the "
                       "reference's backup_clean.sql: pg_dump COPY blocks "
                       "or INSERT statements) into the study database; "
                       "host only")
    g.add_argument("dump", help="path to the .sql dump")
    g.add_argument("--db", default=env.sqlite_path,
                   help="sqlite study file (default %(default)s)")
    g = sub.add_parser("stats", help="study inventory and the severity "
                       "breakdown; host only")
    g.add_argument("--db", default=env.sqlite_path,
                   help="sqlite study file (default %(default)s)")
    text = ("one offline collection step (C3-C8) into --data-dir; host "
            "work only: it computes nothing on a device and takes no "
            "--device")
    g = sub.add_parser("collect", help=text, description=text)
    g.add_argument("step", choices=("projects", "gcs-metadata", "coverage",
                                    "buildlogs", "issues", "corpus"))
    g.add_argument("--repo", default="data/collect_data/repos/oss-fuzz")
    g.add_argument("--data-dir", default="data/processed_data/csv")
    g.add_argument("--no-clone", action="store_true")
    g.add_argument("--max-pages", type=int, default=None)
    g.add_argument("--limit", type=int, default=None)
    g.add_argument("--ids-file", default=None)
    g.add_argument("--workers", type=int, default=8)
    g = sub.add_parser("lint", help="graftlint over the port's own code "
                       "(rule catalog: the JAX package's LINTING.md); host "
                       "only")
    g.add_argument("paths", nargs="*",
                   help="files to lint (default: tse1m_tpu_torch/)")
    g.add_argument("--json", action="store_true")
    g.add_argument("--write-baseline", action="store_true")
    g.add_argument("--no-baseline", action="store_true")
    g.add_argument("--rules", default=None)
    g.add_argument("--changed", metavar="REF", default=None,
                   help="incremental: lint files differing from REF plus "
                        "their reverse-dependency closure")
    g.add_argument("--why", metavar="RULE:PATH:LINE", default=None,
                   help="print the witness call chain for one finding")
    g.add_argument("--graph", action="store_true",
                   help="print the import/call-graph summary")
    g = sub.add_parser("spec", help="graftspec: model-check the "
                       "executable protocol specs; host only")
    g.add_argument("action", choices=("check", "trace", "mutants"))
    g.add_argument("names", nargs="*",
                   help="spec (or mutant) names; check defaults to all "
                        "three committed specs")
    g.add_argument("--mode", choices=("bfs", "dfs"), default="bfs",
                   help="exploration order (BFS counterexamples are "
                        "shortest)")
    g.add_argument("--max-states", type=int, default=None,
                   help="state-count safety valve (default 200000)")
    g.add_argument("--json", action="store_true")
    helps = {
        "rq1": "RQ1 detection rate",
        "rq2a": "RQ2 change points (CSVs under <dir>/rq3, as the "
                "reference)",
        "rq2b": "RQ2 coverage trends",
        "rq3": "RQ3 coverage change at detection",
        "rq4a": "RQ4a corpus effect on detection",
        "rq4b": "RQ4b corpus effect on coverage",
        "all": "the correctness steps graftlint (the port's lint and the "
               "sanitizer's self-check) and graftspec (the protocol "
               "specs), then the six RQs in order (rq1 rq2a rq2b rq3 rq4a "
               "rq4b), each to completion",
    }
    for name, text in helps.items():
        r = sub.add_parser(name, help=text + " over a sqlite study on the "
                           "GPU")
        r.add_argument("--db", default=env.sqlite_path,
                       help="sqlite study file (default %(default)s)")
        r.add_argument("--result-dir", default=env.result_dir,
                       help="artifact root (default %(default)s)")
        r.add_argument("--limit-date", default=env.limit_date,
                       help="study cutoff (default %(default)s)")
        r.add_argument("--min-coverage-days", type=int,
                       default=env.min_coverage_days,
                       help="eligibility: non-zero coverage days before "
                            "the cutoff (default %(default)s)")
        r.add_argument("--test-mode", action="store_true",
                       default=env.test_mode,
                       help="first 10 eligible projects, 1 project an "
                            "iteration (the reference's TEST_MODE)")
        if name in ("rq4a", "rq4b", "all"):
            r.add_argument("--corpus-csv", default=env.corpus_csv,
                           help="corpus-analysis CSV the corpus groups "
                                "come from (default %(default)s)")
        else:
            r.set_defaults(corpus_csv=env.corpus_csv)
        r.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
    v = sub.add_parser("serve", help="the near-duplicate serving daemon "
                       "over a signature store; --status pings a running "
                       "daemon instead")
    v.add_argument("--sig-store", default=None,
                   help="signature store directory the daemon serves "
                        "(default: the config's sig_store, %s)"
                        % env.sig_store)
    v.add_argument("--host", default="127.0.0.1")
    v.add_argument("--port", type=int, default=0,
                   help="TCP port (0 = pick a free one; see --port-file)")
    v.add_argument("--port-file", default=None,
                   help="write the bound port here (atomic), for clients "
                        "and --status")
    v.add_argument("--seed", type=int, default=0)
    v.add_argument("--state-every", type=int, default=None,
                   help="commit the LSH state every N ingest generations "
                        "(acks are durable regardless; this bounds the "
                        "recovery work after a crash); default 8, or 1 in "
                        "shard mode (--range)")
    v.add_argument("--root", default=None,
                   help="sharded serve root (shard mode; with --range)")
    v.add_argument("--range", type=int, default=None,
                   help="digest range this daemon owns as single writer "
                        "(shard mode: serves <root>/range_NNNN, claims the "
                        "range's epoch lease, writes a heartbeat and "
                        "defaults --port-file to <root>/serve_NNNN.port)")
    v.add_argument("--status", action="store_true",
                   help="client mode: print a running daemon's status "
                        "and record it as the serve_status step of "
                        "run_manifest.json")
    v.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain versions")
    c = sub.add_parser("serve-client", help="one request to a running "
                       "serve daemon")
    c.add_argument("op", choices=("ping", "status", "query", "topk",
                                  "ingest", "metrics", "trace", "slowlog",
                                  "profile", "quiesce", "shutdown"))
    c.add_argument("--host", default="127.0.0.1")
    c.add_argument("--port", type=int, default=0)
    c.add_argument("--port-file", default=None)
    c.add_argument("--npy", default=None,
                   help="[K, S] uint32 .npy of coverage vectors "
                        "(query/topk/ingest)")
    c.add_argument("--k", type=int, default=10,
                   help="topk: neighbours per query vector")
    c.add_argument("--mode", default="candidates",
                   choices=("candidates", "scan"),
                   help="topk: band-candidate probe on the host, or the "
                        "exact scan of every stored row on the card")
    c.add_argument("--limit", type=int, default=None,
                   help="slowlog: at most N most recent captures")
    c.add_argument("--dump", action="store_true",
                   help="profile: also write profile_NNN.json daemon-side")
    b = sub.add_parser("backfill", help="bulk re-label: the exact top-k "
                       "scan of a signature store for every query vector")
    b.add_argument("--npy", required=True,
                   help="[K, S] uint32 .npy of coverage vectors to re-label")
    b.add_argument("--sig-store", default=None,
                   help="scan this store directory in process (read "
                        "only); otherwise --port/--port-file drives a "
                        "running daemon's or router's topk verb")
    b.add_argument("--host", default="127.0.0.1")
    b.add_argument("--port", type=int, default=0)
    b.add_argument("--port-file", default=None)
    b.add_argument("--k", type=int, default=1,
                   help="nearest stored sessions a query (default 1: the "
                        "re-label assignment)")
    b.add_argument("--batch", type=int, default=256,
                   help="query vectors a scan pass")
    b.add_argument("--timeout", type=float, default=None,
                   help="TCP mode: budget of a batch (default: the "
                        "ingest-class budget)")
    b.add_argument("--seed", type=int, default=0)
    b.add_argument("--out", default=None,
                   help="write the full (scores, ids, labels) JSON here "
                        "(atomic); default prints them inline")
    b.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: where --sig-store's scan "
                        "runs")
    r = sub.add_parser("serve-router", help="stateless fan-out router over "
                       "digest-range shard daemons; serve-client works "
                       "unchanged against it")
    r.add_argument("--root", required=True,
                   help="sharded serve root holding the shards' "
                        "serve_NNNN.port files and heartbeats")
    r.add_argument("--shards", type=int, default=2,
                   help="number of digest-range shard daemons")
    r.add_argument("--host", default="127.0.0.1")
    r.add_argument("--shard-host", default="127.0.0.1",
                   help="host the shard daemons listen on")
    r.add_argument("--port", type=int, default=0)
    r.add_argument("--port-file", default=None)
    p = sub.add_parser("serve-replica", help="read replica over a streamed "
                       "store copy (stale-bounded reads; writes refuse)")
    p.add_argument("--src", required=True,
                   help="writer store directory to stream shards from")
    p.add_argument("--dir", required=True,
                   help="replica store directory (created or refreshed)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="seconds between pulls (the staleness bound)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--port-file", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: where topk's scan runs")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "cluster":
        return _cmd_cluster(args)
    if args.cmd == "synth":
        return _cmd_synth(args)
    if args.cmd == "stats":
        return _cmd_stats(args)
    if args.cmd == "serve-client":
        return _cmd_serve_client(args)
    if args.cmd == "backfill":
        return _cmd_backfill(args)
    if args.cmd == "scrub":
        return _cmd_scrub(args)
    logging.basicConfig(level=logging.INFO, datefmt="%H:%M:%S",
                        format="%(asctime)s %(levelname)-7s %(name)s: "
                               "%(message)s")
    if args.cmd == "serve":
        return _cmd_serve(args)
    if args.cmd == "serve-router":
        return _cmd_serve_router(args)
    if args.cmd == "serve-replica":
        return _cmd_serve_replica(args)
    if args.cmd == "ingest":
        return _cmd_ingest(args)
    if args.cmd == "restore":
        return _cmd_restore(args)
    if args.cmd == "lint":
        return _cmd_lint(args)
    if args.cmd == "collect":
        return _cmd_collect(args)
    if args.cmd == "spec":
        return _cmd_spec(args)
    return _cmd_rq(args)


if __name__ == "__main__":
    sys.exit(main())
