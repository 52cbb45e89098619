#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (pilosa_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. card   — nvidia-smi name and power limit, torch's device name
2. build  — nvcc builds every kernel from pilosa_tpu_torch/ops/csrc, on
   a thread beside the host's build of phase 4's index and reference,
   after which phase 3 runs
3. kernels — each of the twelve CUDA kernels at the query path's shapes
   (954 shards x 32768 words, 8 TopN rows, BSI depth 7, with and
   without a filter, and bsi_sum_counts with one shard's planes at
   shard stride 0 against 954 filters and against the per-shard
   GroupBy's own 60 and 8 (one launch a shard a 256-combo chunk);
   masked_popcount over every shard at once as the per-shard TopN/TopK
   hands it over (954 shards x 8 row tiles of 32768 words, with and
   without filters, and with 2 views), and at one shard's (8, 32768)
   and (256, 32768) rows (the latter over 4 input copies in turn, so it
   streams from HBM, not L2); the GroupBy histogram at the able shape of 7
   code bits, signed, unsigned, with Min/Max and at the main path's
   density (every column valid and present), at 9 code bits (240
   combos), as the value
   histogram of age, and past shared memory at 4096 codes x depth 16 on
   64 shards; the one-hot histogram at the able shape, signed and
   unsigned, at 9 code bits and as the value histogram, each also held
   equal to groupby_fused and timed beside it on the same inputs; the
   per-combo kernel at the 8 combos of GroupBy(Rows(t), Rows(a)),
   unsigned and signed; the BSI comparator bsi_range for all seven
   comparisons at 954 x 9 planes and on the 64-shard depth-40 ts shape)
   on seeded random words, and assemble_pages on a (954, 32768) stack
   of 30 dense 4 MiB pages, the (954, 9, 32768) planes stack, the
   (16, 954, 32768) stack of 477 packed pages of phase 8c's sp layout,
   the (8, 954, 32768) stack of 239 run pages of its rn layout, one
   packed page at 2^8, 2^12 and 2^16 coordinates and one run page, with
   torch.cat of the dense pages beside it), each held to its plain
   PyTorch version exactly (integer outputs, tolerance 0), then timed
   with CUDA events (the profiler's device time for masked_popcount
   and the short stride-0 bsi_sum_counts launches) beside its bound,
   whose byte and operation terms (bit operations, and for groupby_sum
   and bsi_sum_counts their popcounts at the card's __popc rate, for
   bsi_sum_counts at shard stride 0 its tensor-core AND+popcount at the
   int8 rate, with the __popc form's term beside it) are printed side by
   side; the one-hot histogram's bound is
   groupby_fused's, and its own int8 tensor work (2*K*min(G, 256) a
   column, and the first port's dense 2*K*G) is printed beside it; the
   per-shard TopN's former loop of 954 masked_popcount calls, timed
   whole and as the sum of its kernels, beside the one
   masked_popcount_shards call that replaced it and its address table's
   host time; an empty kernel's device time (the launch
   floor, printed beside the profiled rows); a disjoint field of 2, 4
   and 8 rows through both GroupBy arms, held equal and timed; and the
   ragged program's page-table reads: concat_gather out of a bucket of
   30 dense pages (954 lanes, the reversed half of 477, and 3 lanes,
   beside torch.cat(pages)[lane_idx]) and segment_count over 1908 lanes
   of 60 pages in 2 segments and in ragged segments of 954, 477, 1 and 2
   lanes
4. main path — the headline index (954 shards x 2^20 columns, random-
   word fields a, b, t, a 7-plane BSI field age and the disjoint
   categorical fields edu, gen, dom, reg, about 4.6 GB of words on the
   card, plus a depth-40 field ts on the first 64 shards) built through
   the port's model API and queried through Executor.execute, every
   answer held exactly to an independent numpy reference:
   4.  the stacked engine (the default executor): the headline queries,
       GroupBy (one pass and per combo), Min, Max and Distinct, whose
       kernel launches must equal STACKED_LAUNCHES (paging is on: one
       assemble_pages a leaf fetch);
   4a. the per-shard engine (use_stacked = False) at full width: the
       headline queries, TopK, MinRow/MaxRow, set-field Distinct and
       the able GroupBy Sum, each timed beside the stacked engine; BSI
       Min, Max and Distinct of age (host walks) on 16 shards;
       each TopN/TopK must launch masked_popcount once a run (one
       launch over its 954 shards) and popcount_rows never;
   4b. the fallbacks on the default executor: Min, Max and Distinct of
       ts (depth 40), GroupBy Max of ts and GroupBy Min over the
       overlapping t rows (host loops on 16 shards, S_FALLBACK_GB) and
       Count(Distinct) on the 64 shards of ts; the executor's path
       counter must show each route;
       then Range counts of ts on both engines, which must launch
       bsi_range;
   4c. the one-hot arm (onepass_arm = "onehot"): the disjoint GroupBy
       Sums and Min, Max and Distinct of age, timed beside the fused arm;
       groupby_onehot must launch;
   4d. the read surface (SURFACE_QUERIES: Percentile, Sort, Limit,
       Extract, UnionRows, ConstRow, IncludesColumn, FieldValue, Rows,
       Options) on the stacked engine at full width, and Percentile of
       ts on its 64 shards, which must take the per-shard Min/Max walk;
       each Percentile of age must launch bsi_range and groupby_fused,
       each Limit popcount_rows; then the per-shard engine on the 16
       leading shards (S_DECODE), where Percentile must launch bsi_range
       and Limit popcount_rows.
5. writes and keys:
   5a. a seeded batch of 1003 PQL writes on the headline index through
       Executor.execute (400 Set/Clear of a, 200 of b, 200 Set of t, 150
       Set and 50 Clear of age, ClearRow(t=7), a Store into a new field
       s, a Delete of 100 columns over 10 shards), mirrored into the
       numpy arrays; then phase 4's stacked query set and the per-shard
       TopN/Count set on the executors of phases 4 and 4a, every answer
       exact, each first call printed beside phase 4's; the stacks and
       tiles the batch made stale must be patched (only stacks under new
       keys, and per-shard (W,) tiles a write dirtied whole, may be
       built);
   5b. a keyed index of 2^18 column keys (about 256 shards) with a keyed
       set field of 64 row keys, an unkeyed set field and a depth-20 INT,
       loaded through the translators and the import API; Count, Row
       (column keys), TopN with and without a filter (row keys), GroupBy
       (row_key), Rows(like=), Extract of ConstRow keys, FieldValue, and
       a Set creating a key of each kind, on both engines, each exact
       against numpy and the key lists;
   5c. SQL on the card (SQL_KERNELS): COUNT(*) of two SETCONTAINS, SUM
       of age with and without one, COUNT(*) of age >= 64 and of age
       BETWEEN 10 AND 100, the able GROUP BY edu, gen, dom and GROUP BY
       t, a (set columns grouped member-wise under the flatten hint),
       MIN/MAX/AVG of age under a, DISTINCT age, PERCENTILE(age, 50),
       ORDER BY age DESC LIMIT 100 and a LIMIT 10 of _id, age, and on
       kidx a keyed COUNT(*) and a GROUP BY of the keyed set field,
       through SQLEngine on phase 4's executor (stacked) and a new
       per-shard executor (the S_DECODE leading shards for the decoding
       statements), each exact against numpy from the mirror after 5a
       and launching its kernels, with its first call, warm p50, parse
       and plan (SQL_PLAN_COST) times; EXPLAIN of the able GROUP BY
       shows the pushed GroupBy; API.sql's JSON equals the engine's
       rows; an INSERT of 64 seeded age values (one column in each of
       64 shards) leaves SUM, the ranges and MIN/MAX/AVG exact on both
       engines with the stale stacks and tiles patched and none
       rebuilt, and a second INSERT puts the old values back.
6. restart and ingest (the holders persist under a fresh directory of
   tempfile.gettempdir(), removed at the end; its free bytes printed
   first, and the run stops there if fewer than DISK_NEEDED):
   6a. the headline holder (every phase-4 field and 5b's keyed index)
       synced to its RBF files, timed, with the bytes and shard files on
       disk; the holder and every executor dropped; a reopen with
       load_schema, timed; every fragment's row words of a, b, s, t, the
       categories and the age planes held to the numpy mirror after 5a;
       then phase 4's stacked set and 4a's per-shard TopN/Count set on
       new APIs through API.query, exact against the answers after 5a,
       each first call (stacks built from rows that came off disk) and
       warm p50 printed beside phase 4's; the keyed index's Count, Row
       keys and TopN equal to 5b's, and a Set of a new column key gets
       the partition's next id;
   6b. a fresh holder through the API: a Pipeline of 2^19 datagen
       records on 4 workers (records/s), import_columns of 2^23 seeded
       columns over 8 shards in calls of 2^22 (columns/s; every fill
       through storage/csrc/scatter.cc, calls counted: 13d), the
       INGEST_QUERIES exact on both indexes against numpy from the same
       generators; 2^20 columns imported again over every shard, the
       first query after it exact with the stack cache's patches and
       rebuilds by reason printed; sync, reopen, the same answers again.
7. a rolling time window: a fresh holder's index events (80 shards x
   2^20 columns) with a TIME field ev (YMDH, 4 rows; 2^13 seeded columns
   a row an hour over the 168 hours from 2022-06-01, about 5.5M bits,
   imported with timestamps into 5 views each), ew (the same for one day
   under timeq.configure(write_finest=True): the standard and hour views
   only), a random-word set field a and the BSI age (depth 7); every
   answer held exactly to numpy recomputed from the seeded (row, column,
   hour) triples, first call and warm p50 printed with the card's name
   and power limit:
   7a. Count(Row(ev=1, from='2022-06-02T06:00', to='2022-06-05T18:00'))
       on the stacked engine, a cover of 38 single-view leaves (the
       leaves built, TIMEQ_QCOVER_TOTAL and the cover's bytes printed),
       then under qcover off (one multi-view leaf), times beside; the
       eager union's bytes beside a fused pass's; Count(Intersect(...,
       Row(a=1))), Sum(..., field=age) and TopN(ev, n=4, from, to) on
       the stacked engine, and all four on the per-shard engine over 64
       shards;
   7b. the window shifted by an hour builds exactly one leaf; under
       qcover off its one leaf is built again, times beside;
   7c. a Set in the window's newest hour: the next Count makes one patch
       and no build;
   7d. a one-day cover of ew reads 24 hour leaves; Holder.rollup_views
       at 2022-06-02T00:00 (timed) folds the (index, field, child,
       parent) tuples numpy expects, and the same query then reads one
       day leaf;
   7f. (run before 7e) API.query(..., profile=True) of 7a's Count, cold
       and warm, its spans printed (executor.Execute > executor.executeCount
       > stacked.plan_build with one stacked.stack a built leaf, and
       stacked.dispatch); the long-query log holds a cold call with its
       spans; the newest flight record's route is solo;
       pilosa_stack_cache_total agrees with StackCache.counters(); with
       device-patch armed, a Set and the next Count: the faulted patch
       is answered by one rebuild under the reason "fault", exactly;
   7e. ev's ttl set to 4 days, Holder.remove_expired_views at
       2022-06-08T00:00 (timed) removes the views numpy expects; 7a's
       window then counts what the 20 surviving views hold, with no
       build, on both engines;
   7g. 2^22 seeded rows of an int and a float column in the pathless
       index's dataframe, each aggregate on the card against numpy under
       the JAX package's 32-bit rule (ints exact, float sums and means
       within a relative 1e-6).
8. the memory plane (memory.configure; restored at its end), on the
   headline holder reopened in 6a:
   8a. phase 4's stacked set warm, the ledger's resident bytes R read,
       the budget clamped to R // 2, then MEM_ROUNDS rounds of the set,
       exact, each round's page_rebuilds, full_rebuilds, misses and
       rebuilt bytes printed (under R, with misses); a broad TopN(t,
       n=8) leaves a hot Count(Row(a=1))'s pages resident (no rebuild on
       its next call); after an eviction of half the ledger one
       Prefetcher.step() warms a key and counts no error;
   8b. each query of the set, warm p50 paged and under
       configure(paged=False), assemble_pages' launches and device time
       in one call (profiler) beside;
   8c. fields sp (64 rows, 256 seeded bits a shard) and rn (8 rows, a
       run over an eighth of every shard plus 64 bits) added: Count,
       TopN and a Union count of sp, Intersects with Row(a=1) and a
       filtered TopN, each expanding the encoded pages on the card
       through assemble_pages, every answer exact against numpy; the
       flight records' page_mix and the ledger's bytes for sp and rn
       beside their dense size;
   8d. the OOM ladder: inject_oom(1) absorbed by the retry, inject_oom(2)
       raised after the retry (pilosa_device_oom_total raised 1; a query
       on the card never degrades to the host, so host_fallback reads 0
       in every phase), then a real torch.cuda.OutOfMemoryError:
       a ballast tensor leaves BALLAST_SLACK free and a cold query's
       upload runs out, the relief sweep sheds, the retry answers.
   Then sp and rn are deleted: no later phase reads them, and phase
   10's node would otherwise sync their rows before its first write.
9. the serving plane (Executor.enable_serving(window_s=0.001,
   max_batch=64), as the server turns it on) on the headline holder,
   with bench/ragged.py's events index (fields c, u and m, 3 shards)
   beside it; every answer's digest held to a solo Executor.execute
   on the same holder, a mismatch or a failure failing the run:
   9a. SERVING_QUERIES at 1, 8 and 32 clients, STORM_S each after a
       warm pass: qps, p50, p99, dispatches a query by kind, the
       routes, result-cache hits and the flight phases;
   9b. the cross-index mix (bench/ragged.py mixed_queries(954, 3)) at
       16 clients with cache_bytes=0 and admission=False, ragged on and
       off: dispatches a query, segment_count and concat_gather
       launches; the ragged arm must dispatch kind "ragged", launch
       both, capture no serving.* failure and degrade no rider;
   9c. POINT_QUERIES under 4 clients of HEAVY_QUERY, admission classes
       then FIFO (point p50, p99); then heavy_slots=1, queue_max=2 and a
       third heavy query sheds typed 503 with retry_after_s > 0;
   9e. (before 9d) phase 5c's statements of the stacked engine through
       API.sql's serving arm, cold and cached, equal to the solo arm;
   9d. 8 seeded bit-flipping Set/Clear of a and an import_bits of 1024
       columns: each evicts the cached Count(Row(a=1)) (over every
       shard), moves the mutation epoch and makes the canonical ragged
       program build again, and a standing Count(Row(a=1)) stays equal
       to a cold execution; then every column 9d changed is written
       back, and Count(Row(a=1)) counts what it did before 9d;
   9f. the audit at sample rate 1.0 over 12 point reads: matches and no
       mismatch; one audit-corrupt injection counted as one mismatch
       with an audit-mismatch incident.
10. a node (the port's HTTP Server, from a TOML file the script writes:
   grpc-port = -1, serving and the streaming write plane at their
   defaults, acknowledged writes synced to disk) on the same holder:
   10a. phase 4's query set and 5c's statements through client.Client
        and POST /sql, each equal to a solo Executor.execute or SQLEngine
        on the node's executor and to the numpy answers of 4-5c (6a's
        Set of a new key mirrored), each query's HTTP p50 beside its
        in-process API p50; the kernels they launch must launch (the
        serving routes printed); the solo pass runs on the node's own
        executor with its serving layer set aside;
   10b. 8 clients POST 6 batches each of 32 Set and 16 Clear of a and 16
        age values, over the 32 leading shards of the full-width index,
        to /index/bench/ingest (sync on); after each ack the
        client's own read counts its writes; then Count(Row(a=1)) and
        Sum(field=age) equal the mirror, the stale stacks patched, none
        rebuilt; windows, submits a window, mutations/s, ack p50/p99 and
        the windows' apply/maintain/sync phases printed;
   10c. 2^14 JSON and 2^14 Avro records of 16 shards through an
        in-process Broker, StreamSource/AvroStreamSource, Pipeline and a
        StreamImporter on
        the node's writer into index kf, crash-pre-commit armed once:
        the restarted consumer re-delivers, every count and sum equals
        numpy, records/s printed;
   10d. an exclusive transaction: a PQL Set, an import and a SQL INSERT
        answer 409, then land once it is finished; /debug/slo reports
        its windows; under slo.configure(latency_ms=a tenth of the
        smallest 10a p50, windows="3s") one slo.tick() reports a
        slo-burn incident at /debug/incidents;
   10e. `python -m pilosa_tpu_torch.cli.main server` (on the card,
        grpc-port -1, an auth secret) in a subprocess: the CLI import of
        2^17 CSV records over 16 shards through HTTPImporter, a keygen
        token for Client and for `cli.main sql` with piped statements,
        a request without the token answering 401, an /ingest write;
        then SIGKILL and a restart on the same directory, where every
        acknowledged write reads back; the seconds to the first answer
        after the restart printed.
11. a cluster on the card (pilosa_tpu_torch.cluster): phase 10's writes
   to the headline index are put back first (the holder then equals the
   numpy mirror after 5a); the words of its S_SUB leading shards are
   read back from the holder and phase 4's numpy reference functions
   (numpy_answers, with the joint histogram built from the categorical
   rows as they stand) run over them (sub_reference), and every answer
   of 11a-11d and 12 is held exactly to that:
   11a. three ClusterNodes (replica_n 2, one InMemDisCo with 5 s
        leases, HTTP on loopback, grpc-port -1, hedging off) in this
        process, the fragments of the headline index's S_SUB leading
        shards copied through Fragment.set_row_words to the two nodes
        ClusterSnapshot.shard_nodes names, about 2 x 1.9 GiB of words;
        phase 4's query set through node0's ClusterExecutor.execute,
        first call and warm p50 beside phase 4's in-process p50 and
        10a's HTTP p50; each node's resident stack bytes and the
        ledger's total; each node's own leg launches its kernels; the
        last fan-out's flight record names every node's attempt;
   11b. 256 seeded Set/Clear of a through the coordinator (both owners
        of each shard hold them, read with shards=), written back;
        import_bits and import_values of 2^16 records of new fields imp
        and iv over the first 64 shards through the replicated import,
        every count and sum exact on the cluster and on each owner;
   11c. node2 dies (pause) and its server closes; the query set exact
        through the survivors (first call after the failover beside the
        warm p50, and node0's new stack keys); 64 bits of imp=9 written
        to 16 shards node2 owns; node1 paused too: Count sheds with
        LoadShedError (503) and partial_ok answers the live shards'
        exact count with missing_shards; node1 reopens, node2 reopens
        with warm=True and its sync_from_peers repairs what it missed
        (its imp fragments equal their replicas'); the set exact again;
   11d. an rpc-delay of HEDGE_DELAY_S on node1's legs: HEDGE_QUERIES
        exact with hedging off and with a HEDGE_MS hedge set through
        coordinator.configure(), the hedges fired and won counted, both
        p50s printed;
   11e. a second cluster (its own disco, two nodes on disk, replica_n 1)
        over the headline's first RESHARD_SHARDS (16) shards of a, t
        and age; node2 opens member=False and joins, then node1 drains,
        each under 4
        reader threads and a writer: no read fails or mismatches, a
        reader's Count(Row(wr=9)) never falls below the writes
        acknowledged when it starts, every acknowledged write reads
        back through node0 and on its shard's owner before the writes
        the writer did not reach land, the shards and bytes moved and
        the seconds printed; a StreamWriter
        window on a donor to a moved shard is forwarded to its new
        owner and read back there;
   11f. `cli.main backup` of node2 (on disk) and `cli.main restore`
        into a fresh Server on the card, which answers node2's queries
        equally.
12. the DAX tier (pilosa_tpu_torch.dax, storage/blob.py) on the card
   over the headline's S_SUB leading shards at 2^20 columns with every
   phase-4 field, each answer held exactly to 11's sub_reference:
   12a. a "dir" BlobStore under the run's root (its free bytes checked
        first), each shard's rows encoded by snapshot_fragment_rows and
        put by BlobStore.put_snapshot (encode and put seconds, bytes);
        DAXService(n_workers=2, blob=that store) on the card, the cli dax
        shape with [blob] backend = "dir" (shared-storage workers that
        hydrate lazily from the tier), the shards registered from
        blob.shards(), the queryer's HTTP front started; phase 4's
        stacked query set through Queryer.query (the first call hydrates
        each worker's share: restore and decode seconds, then the warm
        p50s), three of it through POST /queryer/bench; each worker's
        hydrations and resident bytes (/dax/residency) and its own leg's
        launches;
   12b. 5c's statements the DAX SQL front serves (DAX_SQL: not
        PERCENTILE, whose wire result neither package's queryer decodes,
        nor kidx's) through Queryer.sql and POST /sql, exact;
   12c. seeded import_bits, import_values and a SQL INSERT over
        DAX_WRITE_SHARDS shards through the queryer, each read back; half
        of the shards snapshot_shard'ed into the tier, the rest's tails
        sealed (seal_tail); worker1 killed and the poller's pass
        (Controller.poll_once) reassigns its shards; the survivor hydrates
        them from the tier and the shared write-log tail: the seconds to
        the first answer after the death, the query set exact, every
        acknowledged write read back;
   12d. a standby admitted owning nothing (Controller.admit_standby) and
        DAX_MOVES shards moved to it by Controller.migrate_shard under
        DAX_READERS readers and a writer of mw=1: no read fails or
        mismatches, every acknowledged write reads back through the
        queryer and on its shard's new owner; shards, bytes, seconds;
   12e. a second service over the same tier with one stateless worker
        (add_blob_worker) whose worker-budget-bytes is a quarter of its
        share of DAX_PAGED_SHARDS shards: Count, Sum and the able GroupBy
        exact (numpy over those shards), with evictions > 0 and its
        resident bytes within the budget;
   12f. `python -m pilosa_tpu_torch.cli.main dax` on the card in a
        subprocess, [blob] backend = "dir" from its --config: CREATE
        TABLE, an INSERT and a GROUP BY over its /sql, then SIGINT.
13. the mesh (pilosa_tpu_torch.parallel), run after 4d on phase 4's
   headline index before 5a writes to it, with MESH_SLOTS (4) slots:
   one a card where the machine has 4, else all on card 0 (the slots
   share it, and the phase prints which):
   13 C.6. phase 4's query set and Row(a=1) with shards=[] on the
        stacked engine paged and unpaged, the per-shard engine and the
        (2, 2) mesh: the JAX executor's empty answers (empty_answer)
        and no kernel launch;
   13a. Executor.set_mesh(make_mesh(1)) over phase 4's query set, 1 + 5
        runs, must launch exactly STACKED_LAUNCHES; then a (2, 2) mesh
        (make_mesh(4, rows=2)): every answer exact against numpy (and so
        phase 4), and each query's launches in 1 + MESH_REPS runs equal
        the single device's for one run times the 4 legs (a slot's leg
        launches what one device launches; whole stacks, so no
        assemble_pages), warm p50s printed beside phase 4's;
   13b. the serving mesh (placement.configure(mesh_devices=4)) on the
        headline index: SERVING_QUERIES from MESH_STORM_CLIENTS clients
        for MESH_STORM_S, every answer's digest equal to a solo
        execution, ragged_mesh dispatches > 0 and no serving.* capture
        (a mesh program that failed would answer solo), each slot's
        resident bytes within the ledger's device_budget() and the
        working set on two slots at least; the same storm first on one
        device (placement off); both with the result cache off; queries,
        qps, p50 and p99 of both printed;
   13c. dist_count, dist_count_intersect, dist_bsi_sum_counts and
        dist_topk_counts (a tie in the rows) over (954, 32768) placed on
        the 4 slots, exact against the kernels' plain versions;
   13d. runs in 6b: its import_columns goes through the three fills of
        storage/csrc/scatter.cc, each call counted and every fill
        required, columns/s printed.
   Each phase's launches are counted from 0; every kernel must have
   launched over 4-13.

Cut to make room for phases 11 and 12 (every check kept): 11a-11d's
cluster from 954 shards to the S_SUB (320) leading ones (its copy, its
cold first calls and the rejoin's digests all scale with shards), 11e's
resharded index from 32 to 16 shards (RESHARD_SHARDS: its join and
drain take a chase a moved shard), and phase 12's tier on the same 320
(the snapshot codec's host work scales with them); phase 8a from 3
rounds to 1 (MEM_ROUNDS; two rounds rebuilt the same bytes);
5b's keyed index from 2^20 to 2^18 column keys (KEYS_N; restart reopens
it too); phase 6b's Pipeline from 2^21 to 2^19 records and its
import_columns from 2^25 columns over 32 shards to 2^23 over 8; phase
7's events index from 954 to 80 shards (EV_SHARDS) and from 2^14 to
2^13 columns a row an hour (EV_COLS), and 7g's dataframe from 2^24 to
2^22 rows; 4a's per-shard Min and Max of age from 954 shards to the
S_DECODE leading ones of its Distinct; 4b's GroupBy Max of ts and
GroupBy Min of age from 64 shards to 16 (S_FALLBACK_GB); phase 3 takes
no separate warm-up call of a plain version (its check's call warms
it).

It then prints the kernels' JSON line, the card's name and power limit,
and last {"ok": true, "device": {...}}.  Without a CUDA card it exits
non-zero before printing any result.
"""

from __future__ import annotations

import itertools
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter

S, W, R, DEPTH = 954, 32768, 8, 7
S_WIDE = 64                 # shards of the over-shared-memory histogram
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
OPS_PER_S = 67e12           # H100 non-tensor 32-bit peak, used for bit ops
INT8_TENSOR_OPS_PER_S = 1979e12   # H100 SXM dense int8 tensor-core peak
# __popc results a clock an SM, compute capability 9.0 (CUDA C++
# Programming Guide, throughput of native arithmetic instructions); the
# rate is this times the SMs times the card's maximum SM clock
POPC_PER_CLOCK_PER_SM = 16
SRC = {
    "popcount_rows": "pilosa_tpu_torch/ops/csrc/bitmap_kernels.cu",
    "pair_popcount": "pilosa_tpu_torch/ops/csrc/bitmap_kernels.cu",
    "masked_popcount": "pilosa_tpu_torch/ops/csrc/bitmap_kernels.cu",
    "rows_filter_counts": "pilosa_tpu_torch/ops/csrc/bitmap_kernels.cu",
    "bsi_sum_counts": "pilosa_tpu_torch/ops/csrc/bitmap_kernels.cu",
    "groupby_fused": "pilosa_tpu_torch/ops/csrc/groupby_kernels.cu",
    "groupby_onehot": "pilosa_tpu_torch/ops/csrc/groupby_kernels.cu",
    "groupby_sum": "pilosa_tpu_torch/ops/csrc/groupby_kernels.cu",
    "bsi_range": "pilosa_tpu_torch/ops/csrc/bitmap_kernels.cu",
    "assemble_pages": "pilosa_tpu_torch/ops/csrc/page_kernels.cu",
    "concat_gather": "pilosa_tpu_torch/ops/csrc/ragged_kernels.cu",
    "segment_count": "pilosa_tpu_torch/ops/csrc/ragged_kernels.cu",
}
REPLACES = {
    "popcount_rows": "pilosa_tpu/ops/kernels.py:128",
    "pair_popcount": "pilosa_tpu/ops/kernels.py:160",
    "masked_popcount": "pilosa_tpu/ops/kernels.py:201",
    "rows_filter_counts": "pilosa_tpu/ops/kernels.py:310",
    "bsi_sum_counts": "pilosa_tpu/ops/kernels.py:251",
    "groupby_fused": "pilosa_tpu/ops/kernels.py:867",
    "groupby_onehot": "pilosa_tpu/ops/kernels.py:656",
    "groupby_sum": "pilosa_tpu/ops/kernels.py:411",
    # no Pallas kernel: the jnp comparator (cmp_unsigned, range_*,
    # bsi.py:199-305) that XLA fuses under the stacked plan's jit
    "bsi_range": "pilosa_tpu/ops/bsi.py:199",
    # no Pallas kernel: the jitted page concatenation and the sparse
    # pages' expands (bitmap.py:352 expand_coords, :374 expand_runs)
    "assemble_pages": "pilosa_tpu/ops/bitmap.py:263",
    # no Pallas kernel: the jnp page-table gather and segment popcount of
    # the ragged program (stacked.py:1562-1578 inlines both)
    "concat_gather": "pilosa_tpu/ops/bitmap.py:290",
    "segment_count": "pilosa_tpu/ops/bitmap.py:306",
}
# lanes of one 4 MiB page of W words (memory.page_bytes())
PAGE_LANES = (4 << 20) // (W * 4)
# the stacked engine's launches over phase 4's six runs of its query set
# (paging on: every leaf of more than one 4 MiB page is assembled by one
# assemble_pages launch a fetch, 32 a run of the set)
STACKED_LAUNCHES = {"popcount_rows": 36, "pair_popcount": 6,
                    "masked_popcount": 0, "rows_filter_counts": 6,
                    "bsi_sum_counts": 12, "groupby_fused": 48,
                    "groupby_onehot": 0, "groupby_sum": 6, "bsi_range": 18,
                    "assemble_pages": 192, "concat_gather": 0,
                    "segment_count": 0}
# categorical fields of the able GroupBy (bench/common.py:129): rows
CATEGORIES = {"edu": 6, "gen": 2, "dom": 5, "reg": 4}
ABLE_SUM = "GroupBy(Rows(edu), Rows(gen), Rows(dom), aggregate=Sum(field=age))"
# the one-hot arm's queries: the disjoint GroupBy Sums and the value
# histogram's Min, Max and Distinct
ONEHOT_QUERIES = [
    ABLE_SUM,
    "GroupBy(Rows(gen), Rows(dom), aggregate=Sum(field=age))",
    "GroupBy(Rows(edu), Rows(gen), Rows(dom), Rows(reg), "
    "aggregate=Sum(field=age))",
    "GroupBy(Rows(edu), Rows(gen), filter=Row(a=1), aggregate=Sum(field=age))",
    "Min(field=age)", "Max(Row(a=1), field=age)", "Distinct(field=age)"]
S_DECODE = 16      # shards of the per-shard BSI Distinct (a host decode)
S_DEEP = 64        # shards holding the depth-40 field ts
S_FALLBACK_GB = 16  # shards of 4b's GroupBy Min/Max (host loops, ~7 s at 64)
TS_BASE = 1 << 39
TS_DEPTH = 40
# bsi_range's phase-3 cases, (op, p, q): the main path's predicates
# (Count(Row(age >= 64)), < 64, 10 < age < 100) and the other comparisons
# at 64 on age (depth 7); on ts (depth 40) at noon and a day's span
AGE_RANGES = [("gte", 64, None), ("lt", 64, None), ("between", 11, 99),
              ("eq", 64, None), ("neq", 64, None), ("lte", 64, None),
              ("gt", 64, None)]
TS_RANGES = [(op, TS_BASE + 43200, None)
             for op in ("gte", "lt", "eq", "neq", "lte", "gt")] + [
    ("between", TS_BASE + 1000, TS_BASE + 80000)]
# the Range counts of ts in phase 4b, on both engines
TS_QUERIES = [f"Count(Row(ts >= {TS_BASE + 43200}))",
              f"Count(Row({TS_BASE + 1000} < ts < {TS_BASE + 80000}))"]
# phase 4d's columns: ConstRow's in shards 0, 5 and 953; a column of
# shard 3 (IncludesColumn, Rows(column=)) and one of shard 700
CONST_COLS = [3, 77, 5 * W * 32 + 11, 5 * W * 32 + 12, 953 * W * 32 + 1023]
COL_LOW = 3 * W * 32 + 4242
COL_HIGH = 700 * W * 32 + 31337
LIMIT_OFFSET = 400_000_000
OPTION_SHARDS = [0, 5, 953]
SURFACE_QUERIES = [
    "Percentile(field=age, nth=50)", "Percentile(field=age, nth=99)",
    "Percentile(field=age, nth=0)",
    "Percentile(field=age, nth=50, filter=Row(a=1))",
    "Sort(Row(a=1), field=age, limit=100, offset=1000)",
    "Sort(Row(a=1), field=age, sort-desc=true, limit=100, offset=1000)",
    "Options(Sort(Row(a=1), field=age), shards=[0])",
    f"Limit(Row(a=1), limit=1000, offset={LIMIT_OFFSET})",
    f"Count(Limit(Row(a=1), limit=1000, offset={LIMIT_OFFSET}))",
    "Extract(Limit(Row(a=1), limit=1000), Rows(t), Rows(edu), Rows(age))",
    "Count(UnionRows(Rows(t)))",
    "Count(Intersect(Row(a=1), UnionRows(Rows(edu))))",
    f"Count(Intersect(Row(a=1), ConstRow(columns={CONST_COLS})))",
    f"IncludesColumn(Row(a=1), column={COL_LOW})",
    f"IncludesColumn(Row(a=1), column={COL_HIGH})",
    f"FieldValue(field=age, column={COL_HIGH})",
    "Rows(t)", f"Rows(t, column={COL_LOW})",
    f"Options(Count(Row(a=1)), shards={OPTION_SHARDS})",
]
TS_PERCENTILE = "Percentile(field=ts, nth=50)"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds of fn() over reps, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel: str, reps: int = 20, launches: int = 1,
              tries: int = 3) -> float:
    """Mean device milliseconds of one launch of `kernel` in fn(), from
    torch.profiler's CUDA activity: the kernel alone, without the
    wrapper's host work or the output's zero fill.  A trace now and
    then comes back without the kernel's records; it is then taken
    again, up to `tries` traces, and if none holds the kernel the time
    is fn()'s over CUDA events divided by the `launches` it makes (the
    wrapper's host work included), on a line that says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, tries + 1):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if kernel in e.key]
        count = sum(e.count for e in events)
        if count:
            return sum(e.device_time_total for e in events) / count / 1e3
        print(f"profiler: trace {attempt} of {tries} holds no {kernel}")
    ms = cuda_ms(fn, reps=reps) / launches
    print(f"profiler: {kernel} timed with CUDA events instead: {ms:.4f} ms "
          "a launch, the wrapper's host work included")
    return ms


def popc_per_s() -> float:
    """The card's __popc rate: POPC_PER_CLOCK_PER_SM x SMs x the maximum
    SM clock nvidia-smi reports."""
    import torch
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return POPC_PER_CLOCK_PER_SM * sms * mhz * 1e6


def bound(nbytes: int, ops: int, ops_per_s: float = OPS_PER_S, popcs: int = 0,
          popcs_per_s: float = 1.0,
          tensor_ops: int = 0) -> tuple[float, str, float, float]:
    """(bound ms, "bytes" or "operations", byte term ms, operation term
    ms): the operation term is the largest of the bit operations at
    ops_per_s, the popcounts at popcs_per_s and the tensor-core ops at
    the int8 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / ops_per_s, popcs / popcs_per_s,
                tensor_ops / INT8_TENSOR_OPS_PER_S) * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", t_bytes, t_ops
    return t_ops, "operations", t_bytes, t_ops


def random_words(gen, shape, device):
    """Seeded random int32 words with 0x80000000 and 0xFFFFFFFF lanes."""
    import torch
    x = torch.randint(-2**31, 2**31, shape, generator=gen, device=device,
                      dtype=torch.int32)
    x[..., 3::97] = -2**31   # 0x80000000: the sign bit alone
    x[..., 5::101] = -1      # 0xFFFFFFFF
    return x


def max_abs_err(label: str, got, want) -> int:
    """Largest |kernel - plain| over the outputs (integers); raises when
    the outputs differ in number, shape or dtype."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} outputs vs {len(want)}")
    err = 0
    for g, w in zip(got, want):
        if g is None or w is None:
            if g is not w:
                raise AssertionError(f"{label}: None mismatch")
            continue
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{label}: kernel {g.shape} {g.dtype} vs "
                                 f"plain {w.shape} {w.dtype}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
    return err


def _increments(out) -> int:
    """Histogram increments of a groupby_fused result: the sum of its
    table, what this run's data made the kernel add."""
    import torch
    return sum(int(x.sum(dtype=torch.int64)) for x in out[:4]
               if x is not None)


def phase_kernels(device) -> dict:
    """Each kernel against its plain version at main-path shapes, then
    timed (the one-hot histogram also beside groupby_fused).  Returns
    per-kernel records (launches filled in later)."""
    import torch
    from pilosa_tpu_torch.ops import kernels as K

    gen = torch.Generator(device=device)
    gen.manual_seed(20261016)
    a = random_words(gen, (S, W), device)
    b = random_words(gen, (S, W), device)
    rows = random_words(gen, (R, S, W), device)
    planes = random_words(gen, (S, 2 + DEPTH, W), device)
    codes = random_words(gen, (S, 9, W), device)
    able = codes[:, :7]
    # the main path's density: every column valid, every value present
    every = torch.full((S, W), -1, dtype=torch.int32, device=device)
    present = planes.clone()
    present[:, 0] = -1
    wide_codes = random_words(gen, (S_WIDE, 12, W), device)
    wide_planes = random_words(gen, (S_WIDE, 2 + 16, W), device)
    ts_planes = random_words(gen, (S_DEEP, 2 + TS_DEPTH, W), device)
    # GroupBy(Rows(t), Rows(a)) as the main path lays it out: the 8 t
    # rows and the one a row, combo r = (t row r, a row 0)
    sel = torch.tensor([[r, 0] for r in range(R)], dtype=torch.int32,
                       device=device)
    stacks = [rows, a.unsqueeze(0)]
    stack = S * W * 4
    words = S * W

    def hist_bytes(cb, signed):
        return K.groupby_onepass_hbm_bytes(S, W, cb, DEPTH, signed=signed)

    def hist_ops(cb, signed):
        # one op per word read plus one per histogram increment
        return lambda out: hist_bytes(cb, signed) // 4 + _increments(out)

    def vhist_ops(out):
        # the value histogram's: a word read a plane, one a value counted
        return (2 + DEPTH) * words + sum(int(x.sum(dtype=torch.int64))
                                         for x in out)

    gb_cases = [
        ("groupby_fused", f"able ({S}, 7, {W}) + ({S}, {2 + DEPTH}, {W}) "
         "unsigned, G=128",
         lambda: K.groupby_fused(able, a, planes, 128, signed=False),
         lambda: K.groupby_codes_plain(able, a, planes, 128, signed=False),
         hist_bytes(7, False) + (2 + DEPTH) * 128 * 4,
         hist_ops(7, False), 20, 1),
        ("groupby_fused", "able unsigned, every column valid and present "
         "(the main path's density), G=128",
         lambda: K.groupby_fused(able, every, present, 128, signed=False),
         lambda: K.groupby_codes_plain(able, every, present, 128,
                                       signed=False),
         hist_bytes(7, False) + (2 + DEPTH) * 128 * 4,
         hist_ops(7, False), 20, 1),
        ("groupby_fused", "able signed, G=128",
         lambda: K.groupby_fused(able, a, planes, 128),
         lambda: K.groupby_codes_plain(able, a, planes, 128),
         hist_bytes(7, True) + (2 + 2 * DEPTH) * 128 * 4,
         hist_ops(7, True), 20, 1),
        ("groupby_fused", "able signed + minmax, G=128",
         lambda: K.groupby_fused(able, a, planes, 128, minmax=True),
         lambda: K.groupby_codes_plain(able, a, planes, 128, minmax=True),
         hist_bytes(7, True) + (2 + 2 * DEPTH + 4) * 128 * 4,
         # one atomicMax and one atomicMin per exists column besides
         lambda out: (hist_ops(7, True)(out)
                      + 2 * int(out[1].sum(dtype=torch.int64))), 20, 1),
        ("groupby_fused", f"240 combos ({S}, 9, {W}) + ({S}, {2 + DEPTH}, "
         f"{W}) unsigned, G=512",
         lambda: K.groupby_fused(codes, a, planes, 512, signed=False),
         lambda: K.groupby_codes_plain(codes, a, planes, 512, signed=False),
         hist_bytes(9, False) + (2 + DEPTH) * 512 * 4,
         hist_ops(9, False), 20, 1),
        ("groupby_fused", f"bsi_value_hist of age ({S}, {2 + DEPTH}, {W}), "
         "G=256",
         lambda: K.bsi_value_hist(planes), lambda: K.bsi_value_hist_plain(planes),
         K.groupby_onepass_hbm_bytes(S, W, DEPTH + 1) + 256 * 4,
         vhist_ops, 20, 1),
        ("groupby_fused", f"past shared memory: ({S_WIDE}, 12, {W}) + "
         f"({S_WIDE}, 18, {W}) signed, G=4096, K=34 (557 KB table)",
         lambda: K.groupby_fused(wide_codes, a[:S_WIDE], wide_planes, 4096),
         lambda: K.groupby_codes_plain(wide_codes, a[:S_WIDE], wide_planes,
                                       4096),
         K.groupby_onepass_hbm_bytes(S_WIDE, W, 12, 16) + 34 * 4096 * 4,
         lambda out: (12 + 1 + 18) * S_WIDE * W + _increments(out), 5, 1),
        # bit operations a combo and word: the rows' AND, the exists AND
        # and a magnitude AND a plane (and the sign split when signed);
        # popcounts: count, nn and one a plane (a side)
        ("groupby_sum", f"C={R} of ({R}, {S}, {W}) x (1, {S}, {W}) + "
         f"({S}, {2 + DEPTH}, {W}) unsigned",
         lambda: K.groupby_sum(stacks, sel, planes, signed=False),
         lambda: K.groupby_sum_plain(stacks, sel, planes, signed=False),
         K.groupby_percombo_hbm_bytes(S, W, R + 1, DEPTH, signed=False)
         + R * (2 + 2 * DEPTH) * 4,
         (R * (2 + DEPTH) * words, R * (2 + DEPTH) * words), 20, 1),
        ("groupby_sum", f"C={R} signed",
         lambda: K.groupby_sum(stacks, sel, planes, signed=True),
         lambda: K.groupby_sum_plain(stacks, sel, planes, signed=True),
         K.groupby_percombo_hbm_bytes(S, W, R + 1, DEPTH, signed=True)
         + R * (2 + 2 * DEPTH) * 4,
         (R * (4 + 2 * DEPTH) * words, R * (2 + 2 * DEPTH) * words), 20, 1),
    ]

    # the one-hot histogram computes groupby_fused's function, so its
    # bound is groupby_fused's on the same inputs: the bytes it reads, one
    # op per word read and one per histogram increment.  The one-hot
    # form's own int8 tensor work (2*K*min(G, 256) a column: a 32-column
    # word touches at most 32 of the 8-code slices) and the first port's
    # dense 2*K*G are printed beside it, not taken as its bound
    form_ops = {}

    def onehot_case(label, k, g, kern, plain, nbytes, ops, beside):
        form_ops[label] = (2 * k * min(g, 256) * words * 32,
                           2 * k * g * words * 32)
        return ("groupby_onehot", label, kern, plain, nbytes, ops, 20, 1,
                beside)

    onehot_cases = [
        onehot_case(f"able ({S}, 7, {W}) + ({S}, {2 + DEPTH}, {W}) "
                    "unsigned, G=128, K=9", 2 + DEPTH, 128,
                    lambda: K.groupby_onehot(able, a, planes, 128, signed=False),
                    lambda: K.groupby_codes_plain(able, a, planes, 128,
                                                  signed=False),
                    hist_bytes(7, False) + (2 + DEPTH) * 128 * 4,
                    hist_ops(7, False),
                    lambda: K.groupby_fused(able, a, planes, 128, signed=False)),
        onehot_case("able signed, G=128, K=16", 2 + 2 * DEPTH, 128,
                    lambda: K.groupby_onehot(able, a, planes, 128),
                    lambda: K.groupby_codes_plain(able, a, planes, 128),
                    hist_bytes(7, True) + (2 + 2 * DEPTH) * 128 * 4,
                    hist_ops(7, True),
                    lambda: K.groupby_fused(able, a, planes, 128)),
        onehot_case(f"240 combos ({S}, 9, {W}) + ({S}, {2 + DEPTH}, {W}) "
                    "unsigned, G=512, K=9", 2 + DEPTH, 512,
                    lambda: K.groupby_onehot(codes, a, planes, 512, signed=False),
                    lambda: K.groupby_codes_plain(codes, a, planes, 512,
                                                  signed=False),
                    hist_bytes(9, False) + (2 + DEPTH) * 512 * 4,
                    hist_ops(9, False),
                    lambda: K.groupby_fused(codes, a, planes, 512, signed=False)),
        onehot_case(f"bsi_value_hist of age ({S}, {2 + DEPTH}, {W}), G=256, "
                    "K=1", 1, 256,
                    lambda: K.bsi_value_hist(planes, gb=K.groupby_onehot),
                    lambda: K.bsi_value_hist_plain(planes),
                    K.groupby_onepass_hbm_bytes(S, W, DEPTH + 1) + 256 * 4,
                    vhist_ops, lambda: K.bsi_value_hist(planes)),
    ]
    # the per-shard TopN loop's shapes: a chunk of one shard's rows
    # (contiguous) against that shard's filter words
    mask = a[0].contiguous()
    flat_rows = rows.view(R * S, W)
    # ... and as the per-shard TopN/TopK now hands them over: per shard
    # the R row tiles of a view, as the tile cache gives them (rows[r, s],
    # and planes[s, :R] as a second view), and the shard's filter words,
    # read where they lie
    view1 = [[K.RowTiles(list(rows[:, s]), W, device)] for s in range(S)]
    view2 = [[K.RowTiles(list(rows[:, s]), W, device),
              K.RowTiles(list(planes[s, :R]), W, device)] for s in range(S)]

    def rotating(fn, n=4):
        # fn(i) over n distinct input copies in turn: back-to-back calls
        # on inputs of 33.7 MB would otherwise read them from the 50 MB
        # L2, not from HBM as the byte bound assumes
        turn = itertools.cycle(range(n))
        return lambda: fn(next(turn))
    filters = list(a)
    one_shard = planes[:1].expand(S, -1, -1)

    def bsi_pop(c):
        # bit operations and popcounts of bsi_sum_counts over c filtered
        # shards: count, and a pos and a neg popcount a plane, a word
        return ((5 + 6 * DEPTH) * c * W, (1 + 2 * DEPTH) * c * W)

    # kernels too short for back-to-back CUDA events, which would time
    # the wrapper's host work: their time comes from the profiler
    profiled = set()
    popc_forms = {}

    def stride0_ops(c, label):
        # the stride-0 instance counts on the tensor cores (mma .b1
        # .and.popc): an AND and an add a bit product, of each filter's
        # positive and negative masks with the d planes and the count's
        # all-ones column, at the int8 tensor rate (no .b1 rate is
        # published for the H100); ~4 bit operations a word a filter build
        # the masks.  The __popc form's popcounts are printed beside it
        popc_forms[label] = bsi_pop(c)[1]
        return (4 * c * W, 0, 2 * c * W * 32 * 2 * (DEPTH + 1))

    def stride0(c):
        # the per-shard GroupBy's shape (executor/advanced.py
        # _groupby_loop): one shard's planes at shard stride 0 against one
        # filter (a combo's mask) each, up to _ROW_CHUNK = 256 combos a
        # launch
        planes_c = planes[:1].expand(c, -1, -1)
        label = f"(1, {2 + DEPTH}, {W}) at shard stride 0 & ({c}, {W})"
        profiled.add(label)
        return ("bsi_sum_counts", label,
                lambda: K.bsi_sum_counts(planes_c, a[:c]),
                lambda: K.bsi_sum_counts_plain(planes_c, a[:c]),
                (2 + DEPTH) * W * 4 + c * W * 4 + c * (1 + 2 * DEPTH) * 4,
                stride0_ops(c, label))
    one_label = f"(1, {2 + DEPTH}, {W}) at shard stride 0 & ({S}, {W})"
    cases = [
        # name, shape label, kernel call, plain call, bytes, word-ops
        ("popcount_rows", f"({S}, {W})", lambda: K.popcount_rows(a),
         lambda: K.popcount_rows_plain(a), stack + S * 4, 2 * S * W),
        ("popcount_rows", f"({R * S}, {W})",
         lambda: K.popcount_rows(rows.view(R * S, W)),
         lambda: K.popcount_rows_plain(rows.view(R * S, W)),
         R * stack + R * S * 4, 2 * R * S * W),
        ("pair_popcount", f"({S}, {W}) x2", lambda: K.pair_popcount(a, b),
         lambda: K.pair_popcount_plain(a, b), 2 * stack + S * 4,
         3 * S * W),
        ("rows_filter_counts", f"({R}, {S}, {W}) & ({S}, {W})",
         lambda: K.rows_filter_counts(rows, a),
         lambda: K.rows_filter_counts_plain(rows, a),
         (R + 1) * stack + R * S * 4, 3 * R * S * W),
        ("bsi_sum_counts", f"({S}, {2 + DEPTH}, {W}) & ({S}, {W})",
         lambda: K.bsi_sum_counts(planes, a),
         lambda: K.bsi_sum_counts_plain(planes, a),
         (3 + DEPTH) * stack + S * (1 + 2 * DEPTH) * 4, bsi_pop(S)),
        ("bsi_sum_counts", f"({S}, {2 + DEPTH}, {W}) no filter",
         lambda: K.bsi_sum_counts(planes, None),
         lambda: K.bsi_sum_counts_plain(planes, None),
         (2 + DEPTH) * stack + S * (1 + 2 * DEPTH) * 4,
         ((4 + 6 * DEPTH) * S * W, (1 + 2 * DEPTH) * S * W)),
        # one shard's planes at shard stride 0 against S filters, and at
        # the per-shard engine's own counts: the able GroupBy's 60 combos
        # and GroupBy(Rows(t), Rows(a))'s 8
        ("bsi_sum_counts", one_label, lambda: K.bsi_sum_counts(one_shard, a),
         lambda: K.bsi_sum_counts_plain(one_shard, a),
         (2 + DEPTH) * W * 4 + stack + S * (1 + 2 * DEPTH) * 4,
         stride0_ops(S, one_label)),
        stride0(60),
        stride0(8),
        # bytes: every tile and filter read once, the address table, the
        # int64 counts; bit operations a row and word: the views' OR,
        # the AND and the popcount's add, and a popcount each
        ("masked_popcount", f"{S} shards x {R} row tiles ({W},) & {S} "
         "filters, V=1 (the per-shard TopN/TopK)",
         lambda: K.masked_popcount_shards(view1, filters, R, W, device),
         lambda: K.masked_popcount_shards_plain(view1, filters, R, W, device),
         (S * R + S) * W * 4 + (S * R + S) * 8 + R * 8,
         (3 * S * R * W, S * R * W)),
        ("masked_popcount", f"{S} shards x {R} row tiles, no filter, V=1 "
         "(the per-shard unfiltered TopN/TopK)",
         lambda: K.masked_popcount_shards(view1, None, R, W, device),
         lambda: K.masked_popcount_shards_plain(view1, None, R, W, device),
         S * R * W * 4 + (S * R + S) * 8 + R * 8, (2 * S * R * W, S * R * W)),
        ("masked_popcount", f"{S} shards x {R} row tiles & {S} filters, V=2",
         lambda: K.masked_popcount_shards(view2, filters, R, W, device),
         lambda: K.masked_popcount_shards_plain(view2, filters, R, W, device),
         (2 * S * R + S) * W * 4 + (2 * S * R + S) * 8 + R * 8,
         (4 * S * R * W, S * R * W)),
        ("masked_popcount", f"(8, {W}) & ({W},)",
         lambda: K.masked_popcount(flat_rows[:8], mask),
         lambda: K.masked_popcount_plain(flat_rows[:8], mask),
         9 * W * 4 + 8 * 4, 3 * 8 * W),
        ("masked_popcount", f"(256, {W}) & ({W},), 4 input copies in turn",
         rotating(lambda i: K.masked_popcount(flat_rows[256 * i:256 * (i + 1)],
                                              a[i])),
         rotating(lambda i: K.masked_popcount_plain(
             flat_rows[256 * i:256 * (i + 1)], a[i])),
         257 * W * 4 + 256 * 4, 3 * 256 * W),
    ]

    def range_case(pl, op, p, q):
        # bytes: every plane read once, the row written once; operations:
        # ~6 a plane a word a predicate, and the final combination
        s_, p_, _ = pl.shape
        npred = 2 if op == "between" else 1
        return ("bsi_range", f"{op} ({s_}, {p_}, {W}) p={p}"
                + ("" if q is None else f" q={q}"),
                lambda: K.bsi_range(pl, op, p, q),
                lambda: K.bsi_range_plain(pl, op, p, q),
                s_ * p_ * W * 4 + s_ * W * 4,
                (6 * (p_ - 2) * npred + 6) * s_ * W)
    cases += [range_case(planes, *c) for c in AGE_RANGES]
    cases += [range_case(ts_planes, *c) for c in TS_RANGES]
    cases = ([c + (50, 3, None) for c in cases] + [c + (None,) for c in gb_cases]
             + onehot_cases)
    records = {}
    case_ms = {}
    floor_ms = empty_launch_ms()
    print(f"kernels: an empty kernel (torch.cuda._sleep(0)) takes {floor_ms:.4f} "
          "ms of device time (profiler): the floor of any launch")
    popc_rate = popc_per_s()
    print(f"kernels: popcount rate {popc_rate:.4e}/s ({POPC_PER_CLOCK_PER_SM} "
          "a clock an SM x SMs x the maximum SM clock)")
    for (name, label, kern, plain, nbytes, ops, reps, plain_reps,
         beside) in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(f"{name} {label}", got, want)
        if err != 0:
            raise AssertionError(f"{name} {label}: kernel differs from "
                                 f"its plain version, max |err| {err}")
        n_ops = ops(got) if callable(ops) else ops
        n_ops, popcs, tensor_ops = (n_ops + (0,) * 3)[:3] if isinstance(
            n_ops, tuple) else (n_ops, 0, 0)
        ms = cuda_ms(kern, reps=reps)
        if name == "masked_popcount" or label in profiled:
            host_ms, ms = ms, device_ms(kern, f"{name}_kernel")
            print(f"kernel {name} {label}: {host_ms:.4f} ms a call back to "
                  f"back through the wrapper (its host work), {ms:.4f} ms "
                  f"of kernel (profiler), empty-kernel floor {floor_ms:.4f} ms")
        # the check's call above is the plain version's warm-up
        plain_ms = cuda_ms(plain, reps=plain_reps, warmup=0)
        bound_ms, bound_by, t_bytes, t_ops = bound(nbytes, n_ops, OPS_PER_S,
                                                   popcs, popc_rate, tensor_ops)
        print(f"kernel {name} {label}: exact vs plain; {ms:.4f} ms "
              f"(plain {plain_ms:.4f} ms), bound {bound_ms:.4f} ms by "
              f"{bound_by} ({bound_ms / ms:.1%} of bound; byte term "
              f"{t_bytes:.4f} ms for {nbytes} bytes, operation term "
              f"{t_ops:.4f} ms for {n_ops} ops, {popcs} popcounts and "
              f"{tensor_ops} tensor ops), library none (no single PyTorch "
              "call computes this from packed words)")
        if label in popc_forms:
            t_popc = popc_forms[label] / popc_rate * 1e3
            print(f"kernel {name} {label}: the __popc form's popcount term "
                  f"(not this kernel's bound): {t_popc:.4f} ms for "
                  f"{popc_forms[label]} popcounts ({t_popc / ms:.1%})")
        if name == "groupby_onehot":
            t8, dense = form_ops[label]
            print(f"kernel {name} {label}: the one-hot form's int8 tensor "
                  f"work (not its bound): {t8 / INT8_TENSOR_OPS_PER_S * 1e3:.4f}"
                  f" ms for {t8} ops at 2*K*min(G, 256) a column; the first "
                  f"port's dense 2*K*G: {dense / INT8_TENSOR_OPS_PER_S * 1e3:.4f}"
                  f" ms for {dense} ops")
        if beside is not None:
            # the fused histogram on the same inputs: equal, timed in turn
            if max_abs_err(f"{name} {label} vs groupby_fused", got,
                           beside()) != 0:
                raise AssertionError(f"{name} {label}: differs from "
                                     "groupby_fused")
            fused_ms = cuda_ms(beside, reps=reps)
            again_ms = cuda_ms(kern, reps=reps)
            print(f"kernel {name} {label}: equal to groupby_fused; "
                  f"one-hot {ms:.4f} / {again_ms:.4f} ms, fused "
                  f"{fused_ms:.4f} ms on the same inputs")
        case_ms[label] = ms
        records.setdefault(name, {
            "name": name, "route": "cuda", "source": SRC[name],
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None})
    grouped = next(c[1] for c in cases if c[0] == "masked_popcount")
    stacked_rows = f"({R}, {S}, {W}) & ({S}, {W})"
    print(f"kernel masked_popcount {grouped}: {case_ms[grouped]:.4f} ms of "
          f"kernel beside rows_filter_counts {stacked_rows} "
          f"{case_ms[stacked_rows]:.4f} ms, the same bytes from one "
          "contiguous stack")
    topn_loop(flat_rows, a, view1, filters, device)
    compare_arms(device, codes, planes)
    records["assemble_pages"] = assemble_cases(device)
    records.update(ragged_kernel_cases(device))
    return records


def _sparse_block(rng, n_bits: int, run_words: int = 0):
    """A (PAGE_LANES, W) host page of n_bits seeded random bits, over a
    run of run_words all-ones words from a seeded start."""
    import numpy as np
    blk = np.zeros((PAGE_LANES, W), np.uint32)
    flat = blk.reshape(-1)
    if run_words:
        lo = int(rng.integers(0, flat.size - run_words))
        flat[lo:lo + run_words] = 0xFFFFFFFF
    pos = rng.choice(flat.size * 32, size=n_bits, replace=False)
    np.bitwise_or.at(flat, pos // 32,
                     np.uint32(1) << (pos % 32).astype(np.uint32))
    return blk


def _sp_stack_blocks(rng, rows: int):
    """Host page blocks of a (rows, S, W) stack laid out as phase 8c's sp
    field: SP_BITS seeded bits a lane (duplicates merged), as
    add_sparse_fields imports them."""
    import numpy as np
    lanes = rows * S
    for lo in range(0, lanes, PAGE_LANES):
        blk = np.zeros((PAGE_LANES, W), np.uint32)
        n = min(PAGE_LANES, lanes - lo)
        cols = rng.integers(0, W * 32, size=(n, SP_BITS))
        flat = blk.reshape(-1)
        pos = (cols + (np.arange(n)[:, None] * W * 32)).reshape(-1)
        np.bitwise_or.at(flat, pos // 32,
                         np.uint32(1) << (pos % 32).astype(np.uint32))
        yield blk


def _rn_stack_blocks(rng, rows: int):
    """Host page blocks of a (rows, S, W) stack laid out as phase 8c's rn
    field: lane (r, s) a run of all-ones words over the (r % 8)-th eighth
    of the shard plus RN_RESID seeded bits outside it."""
    import numpy as np
    lanes, eighth = rows * S, W // 8
    for lo in range(0, lanes, PAGE_LANES):
        blk = np.zeros((PAGE_LANES, W), np.uint32)
        for k, lane in enumerate(range(lo, min(lo + PAGE_LANES, lanes))):
            r0 = (lane // S % 8) * eighth
            blk[k, r0:r0 + eighth] = 0xFFFFFFFF
            cols = rng.integers(0, W * 32, size=RN_RESID)
            c = cols[(cols // 32 < r0) | (cols // 32 >= r0 + eighth)]
            np.bitwise_or.at(blk[k], c // 32,
                             np.uint32(1) << (c % 32).astype(np.uint32))
        yield blk


def assemble_cases(device) -> dict:
    """Phase 3's assemble_pages: a (954, 32768) stack of 30 dense 4 MiB
    pages and the (954, 9, 32768) planes stack of 269, each page its own
    allocation as the stack cache uploads it; the (16, 954, 32768) stack
    of 477 packed pages that one chunk of phase 8c's TopN(sp, n=8)
    expands (SP_BITS seeded bits a lane, 8192 coordinates a page); the
    (8, 954, 32768) stack of 239 run pages of phase 8c's rn layout; one
    packed page at 2^8, 2^12 and 2^16 coordinates and one run page.  Each
    is held exactly to the plain version (torch.cat of each page's plain
    expansion, trimmed) and timed beside its bound: the bytes read (the
    lanes' dense words, or the payload) plus the bytes written, at the
    card's rate.  The library call beside a dense stack is one torch.cat
    of its pages (its padding lanes too: 0.6% more bytes at 954 lanes)."""
    import numpy as np
    import torch
    from pilosa_tpu_torch.memory import encode
    from pilosa_tpu_torch.ops import kernels as K

    gen = torch.Generator(device=device)
    gen.manual_seed(20261017)
    rng = np.random.default_rng(20261017)

    def dense(lead):
        lanes = int(np.prod(lead))
        n = -(-lanes // PAGE_LANES)
        pages = [random_words(gen, (PAGE_LANES, W), device) for _ in range(n)]
        pages[-1][lanes - (n - 1) * PAGE_LANES:] = 0
        return (f"dense {tuple(lead) + (W,)}, {n} pages", pages,
                tuple(lead) + (W,), 2 * lanes * W * 4 + n * 80)

    def encoded(label, lead, blocks):
        lanes = int(np.prod(lead))
        pages = []
        for blk in blocks:
            enc = encode.encode_block(blk)
            assert enc is not None and enc.kind in label, (label, enc)
            pages.append(enc.to_device(device))
        payload = sum(p.nbytes for p in pages)
        mix = dict(Counter(p.kind for p in pages))
        coords = sum(p.n_valid for p in pages)
        runs = sum(p.n_runs for p in pages)
        return (f"{label} {tuple(lead) + (W,)}, {len(pages)} pages {mix}, "
                f"{coords} coordinates, {runs} runs, {payload} payload bytes",
                pages, tuple(lead) + (W,),
                payload + lanes * W * 4 + len(pages) * 80)

    cases = [dense((S,)), dense((S, 2 + DEPTH))]
    t0 = time.perf_counter()
    cases.append(encoded("packed", (16, S), _sp_stack_blocks(rng, 16)))
    cases.append(encoded("run", (RN_ROWS, S), _rn_stack_blocks(rng, RN_ROWS)))
    print(f"host: the packed and run stacks' pages encoded in "
          f"{time.perf_counter() - t0:.1f} s")
    cases += [encoded("packed", (PAGE_LANES,), [_sparse_block(rng, 1 << k)])
              for k in (8, 12, 16)]
    cases.append(encoded("run", (PAGE_LANES,), [_sparse_block(
        rng, 1 << 10, run_words=PAGE_LANES * W // 8)]))
    print(f"card: {card_line()}")
    rec = None
    for label, pages, shape, nbytes in cases:
        # the stack cache keeps a hit's page table: time the launch over
        # a kept table, as a warm hit makes it
        table = K.page_table(pages, shape, PAGE_LANES)

        def kern():
            return K.assemble_pages(pages, shape, PAGE_LANES, table=table)

        def plain():
            return K.assemble_pages_plain(pages, shape, PAGE_LANES)
        err = max_abs_err(f"assemble_pages {label}", kern(), plain())
        if err != 0:
            raise AssertionError(f"assemble_pages {label}: kernel differs from "
                                 f"its plain version, max |err| {err}")
        call_ms = cuda_ms(kern, reps=20)
        built_ms = cuda_ms(lambda: K.assemble_pages(pages, shape, PAGE_LANES),
                           reps=20)
        ms = device_ms(kern, "assemble_")
        print(f"kernel assemble_pages {label}: {call_ms:.4f} ms a call back to "
              f"back through the wrapper over the kept table, {built_ms:.4f} "
              f"ms building the table each call (host), {ms:.4f} ms of kernel "
              "(profiler)")
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        bound_ms, bound_by, t_bytes, _ = bound(nbytes, 0)
        lib = ""
        lib_ms = None
        if all(isinstance(p, torch.Tensor) for p in pages):
            # CUDA events: torch.cat of many pages is several launches
            lib_ms = cuda_ms(lambda: torch.cat(pages), reps=20)
            again = device_ms(kern, "assemble_")
            lib = (f", library torch.cat of the pages {lib_ms:.4f} ms a "
                   f"call (kernel again {again:.4f} ms)")
        print(f"kernel assemble_pages {label}: exact vs plain; {ms:.4f} ms "
              f"(plain {plain_ms:.4f} ms), bound {bound_ms:.4f} ms by "
              f"{bound_by} ({bound_ms / ms:.1%} of bound; {nbytes} bytes read "
              f"and written){lib} ({card_line()})")
        if rec is None:
            rec = {"name": "assemble_pages", "route": "cuda",
                   "source": SRC["assemble_pages"],
                   "replaces": REPLACES["assemble_pages"], "launches": 0,
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": lib_ms}
        del pages
    return rec


def empty_launch_ms() -> float:
    """Device time of an empty kernel (torch.cuda._sleep of 0 cycles, one
    thread), from the profiler: the least any launch takes."""
    import torch
    return device_ms(lambda: torch.cuda._sleep(0), "spin_kernel", reps=50)


def topn_loop(flat_rows, filt, tiles, filters, device) -> None:
    """The per-shard TopN's scan at full width, before and after: the
    former loop of one masked_popcount a shard (its 8 rows against the
    shard's filter words), timed whole with CUDA events (the wrapper's
    host work included) and as the sum of its kernels' device times
    from the profiler; and the one masked_popcount_shards call over the
    same shards' row tiles that replaced it, timed the same ways, with
    its address table's host time on a line of its own."""
    from pilosa_tpu_torch.ops import kernels as K

    def loop():
        for s in range(S):
            K.masked_popcount(flat_rows[R * s:R * (s + 1)], filt[s])

    whole = cuda_ms(loop, reps=3, warmup=1)
    kernels = S * device_ms(loop, "masked_popcount_kernel", reps=3,
                            launches=S)
    print(f"kernel masked_popcount per-shard TopN loop, {S} calls of "
          f"({R}, {W}) & ({W},) (before): {whole:.4f} ms a loop through the "
          f"wrapper (CUDA events), {kernels:.4f} ms of kernel summed over "
          f"its {S} launches (profiler)")

    def one():
        K.masked_popcount_shards(tiles, filters, R, W, device)

    whole = cuda_ms(one, reps=5, warmup=1)
    kernel = device_ms(one, "masked_popcount_kernel", reps=5)
    print(f"kernel masked_popcount per-shard TopN scan, one "
          f"masked_popcount_shards call over {S} shards x {R} row tiles "
          f"(after): {whole:.4f} ms a call through the wrapper (CUDA "
          f"events), {kernel:.4f} ms of kernel in its 1 launch (profiler)")
    t0 = time.perf_counter()
    for _ in range(5):
        K.shard_table(tiles, filters, R, W, device)
    host = (time.perf_counter() - t0) / 5 * 1e3
    print(f"host: masked_popcount_shards' address table of {S * R} row "
          f"tiles (the tile cache's RowTiles) and {S} filters, views and "
          "filters checked, "
          f"built: {host:.4f} ms a call (host clock)")


def compare_arms(device, codes, planes) -> None:
    """GroupBy Sum over one disjoint field of 2, 4 and 8 rows through
    both arms: the engine takes the one-pass histogram wherever its
    bounds hold, and this holds it to the per-combo kernel and times
    both at full width, which shows where per combo would be faster."""
    import torch
    from pilosa_tpu_torch.ops import kernels as K
    ones = torch.full((S, W), -1, dtype=torch.int32, device=device)
    for bits in (1, 2, 3):
        cp = codes[:, :bits]
        n = 1 << bits
        rows = []
        for v in range(n):
            acc = ones.clone()
            for b in range(bits):
                acc &= cp[:, b] if (v >> b) & 1 else ~cp[:, b]
            rows.append(acc)
        rows = torch.stack(rows)
        sel = torch.arange(n, dtype=torch.int32, device=device).view(n, 1)

        def one():
            return K.groupby_fused(cp, ones, planes, n, signed=False)

        def per():
            return K.groupby_sum([rows], sel, planes, signed=False)

        for x, y in zip(one(), per()):
            if not torch.equal(x, y):
                raise AssertionError(f"arms: {n} rows: one-pass and "
                                     "per-combo disagree")
        print(f"arms: GroupBy Sum of a disjoint {n}-row field ({S}, {W}), "
              f"equal on both arms; one-pass {cuda_ms(one, reps=10):.4f} "
              f"ms, per-combo {cuda_ms(per, reps=10):.4f} ms")
        del rows


def disjoint_category_rows(rng, n_rows: int):
    """Rows of a categorical field (bench/common.py:81-97): every column
    holds at most one row.  ceil(log2 R) random bit-planes are each
    column's digit; digits >= R mean the attribute is absent.  Returns
    the digit planes (bits, S, W) and the rows, each (S, W)."""
    import numpy as np
    bits = max(n_rows - 1, 0).bit_length()
    planes = rng.integers(0, 1 << 32, size=(max(bits, 1), S, W),
                          dtype=np.uint32)
    rows = []
    for r in range(n_rows):
        acc = np.full((S, W), 0xFFFFFFFF, dtype=np.uint32)
        for b in range(bits):
            acc &= planes[b] if (r >> b) & 1 else ~planes[b]
        rows.append(acc)
    return planes[:bits], rows


def build_index(path: str):
    """The headline index (bench/common.py build_index shape) through
    the port's model API, in a holder persisted under path; returns the
    holder and the generated words."""
    import numpy as np
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.models.schema import (
        CACHE_TYPE_NONE, FieldOptions, FieldType)
    from pilosa_tpu_torch.models.view import VIEW_STANDARD

    rng = np.random.default_rng(7)
    h = Holder(path=path, width=W * 32)
    idx = h.create_index("bench", track_existence=False)
    data = {}
    for fname, nrows in (("a", 1), ("b", 1), ("t", R)):
        f = idx.create_field(fname, FieldOptions(cache_type=CACHE_TYPE_NONE))
        view = f.view(VIEW_STANDARD, create=True)
        words = rng.integers(0, 1 << 32, size=(nrows, S, W), dtype=np.uint32)
        row_ids = [1] if nrows == 1 else list(range(nrows))
        for shard in range(S):
            frag = view.fragment(shard, create=True)
            for ri, r in enumerate(row_ids):
                frag.import_row_words(r, words[ri, shard])
        data[fname] = words[0] if nrows == 1 else words
    for fname, nrows in CATEGORIES.items():
        f = idx.create_field(fname, FieldOptions(cache_type=CACHE_TYPE_NONE))
        view = f.view(VIEW_STANDARD, create=True)
        digit_planes, rows = disjoint_category_rows(rng, nrows)
        for shard in range(S):
            frag = view.fragment(shard, create=True)
            for r in range(nrows):
                frag.import_row_words(r, rows[r][shard])
        data[fname] = digit_planes
    age = idx.create_field("age", FieldOptions(type=FieldType.INT,
                                               min=0, max=127))
    aview = age.view(age.bsi_view, create=True)
    planes = rng.integers(0, 1 << 32, size=(DEPTH, S, W), dtype=np.uint32)
    full = np.full(W, 0xFFFFFFFF, dtype=np.uint32)
    for shard in range(S):
        frag = aview.fragment(shard, create=True)
        frag.import_row_words(0, full)              # exists
        for p in range(DEPTH):
            frag.import_row_words(2 + p, planes[p, shard])
    data["age"] = planes
    data["age_exists"] = np.full((S, W), 0xFFFFFFFF, dtype=np.uint32)
    return h, data


def numpy_answers(data, hist=None):
    """Independent reference answers from the generated words: the
    headline and GroupBy queries' answers, and age's per-value column
    counts over every column and under a.  hist, the joint histogram
    (joint_histogram's layout), is computed here when not given."""
    import numpy as np

    def pc(x):
        return int(np.bitwise_count(x).sum(dtype=np.int64))

    a, b, t, planes = data["a"], data["b"], data["t"], data["age"]
    exists = data["age_exists"]

    def top(counts):
        pairs = sorted(((-c, r) for r, c in enumerate(counts) if c > 0))
        return [(r, -c) for c, r in pairs][:8]

    # one joint histogram over (edu, gen, dom, reg digits, a bit, age)
    # answers every GroupBy/Min/Max/Distinct
    if hist is None:
        hist = joint_histogram(data)
    vals = np.arange(1 << DEPTH, dtype=np.int64)
    by_age = hist.sum(axis=(0, 1, 2, 3, 4))[:NO_VALUE]
    between = int(by_age[11:100].sum())
    ge64 = pc(planes[6])
    assert ge64 == int(by_age[64:].sum())

    def groups(h, sizes):
        """GroupCounts in product order over the leading axes of h
        (digit axes, then the value axis, its last bin no value), zero
        counts dropped."""
        out = []
        for combo in itertools.product(*(range(n) for n in sizes)):
            cell = h[combo]
            n = int(cell.sum())
            if n:
                out.append((combo, n, int((cell[:NO_VALUE] * vals).sum()),
                            int(cell[:NO_VALUE].sum())))
        return out

    def max_groups(h, sizes):
        out = []
        for combo in itertools.product(*(range(n) for n in sizes)):
            cell = h[combo]
            n = int(cell.sum())
            nz = np.nonzero(cell[:NO_VALUE])[0]
            if n:
                out.append((combo, n, int(nz[-1]) if nz.size else None,
                            int(cell[:NO_VALUE].sum())))
        return out

    tsum = []
    for r in range(R):
        ta = t[r] & a
        n = pc(ta)
        if n:
            tsum.append(((r, 1), n, sum(pc(ta & planes[p]) << p
                                        for p in range(DEPTH)),
                         pc(ta & exists)))
    age_any = by_age
    age_a = hist[:, :, :, :, 1].sum(axis=(0, 1, 2, 3))[:NO_VALUE]
    lo_v = int(np.nonzero(age_any)[0][0])
    hi_a = int(np.nonzero(age_a)[0][-1])
    ne, ng, nd, nr = (CATEGORIES[f] for f in ("edu", "gen", "dom", "reg"))
    groupby = {
        "GroupBy(Rows(edu), Rows(gen), Rows(dom), aggregate=Sum(field=age))":
            groups(hist[:ne, :ng, :nd].sum(axis=(3, 4)), (ne, ng, nd)),
        "GroupBy(Rows(gen), Rows(dom), aggregate=Sum(field=age))":
            groups(hist[:, :ng, :nd].sum(axis=(0, 3, 4)), (ng, nd)),
        "GroupBy(Rows(edu), Rows(gen), Rows(dom), Rows(reg), "
        "aggregate=Sum(field=age))":
            groups(hist[:ne, :ng, :nd, :nr].sum(axis=4), (ne, ng, nd, nr)),
        "GroupBy(Rows(edu), Rows(gen), filter=Row(a=1), "
        "aggregate=Sum(field=age))":
            groups(hist[:ne, :ng, :, :, 1].sum(axis=(2, 3)), (ne, ng)),
        "GroupBy(Rows(edu), Rows(gen), aggregate=Max(field=age))":
            max_groups(hist[:ne, :ng].sum(axis=(2, 3, 4)), (ne, ng)),
        "GroupBy(Rows(t), Rows(a), aggregate=Sum(field=age))": tsum,
        "Min(field=age)": (lo_v, int(age_any[lo_v])),
        "Max(Row(a=1), field=age)": (hi_a, int(age_a[hi_a])),
        "Distinct(field=age)": [int(v) for v in np.nonzero(age_any)[0]],
    }
    n_values = pc(exists)
    return {
        "Count(Intersect(Row(a=1), Row(b=1)))": pc(a & b),
        "Count(Row(a=1))": pc(a),
        "Count(Union(Row(a=1), Row(b=1)))": pc(a | b),
        "TopN(t, n=8)": top([pc(t[r]) for r in range(R)]),
        "TopN(t, Row(a=1), n=8)": top([pc(t[r] & a) for r in range(R)]),
        "Sum(field=age)": (sum(pc(planes[p]) << p for p in range(DEPTH)),
                           n_values),
        "Sum(Row(a=1), field=age)": (
            sum(pc(planes[p] & a) << p for p in range(DEPTH)), pc(a & exists)),
        "Count(Row(age >= 64))": ge64,
        "Count(Row(age < 64))": n_values - ge64,
        "Count(Row(10 < age < 100))": between,
    }, groupby, (age_any, age_a)


# the joint histogram's axes: each categorical field's digits (edu and
# dom 3 bits, gen 1, reg 2) and a slot past them for a column whose row
# was deleted, the a bit, and the age value with a last bin for a
# column holding no value
HIST_SHAPE = (8, 3, 8, 5, 2, (1 << DEPTH) + 1)
ABSENT = {"edu": 7, "gen": 2, "dom": 7, "reg": 4}
NO_VALUE = 1 << DEPTH


def joint_histogram(data):
    """Counts of columns per (edu digit, gen digit, dom digit, reg
    digit, a bit, age value), decoded from the generated words in
    batches of 32 shards (on 4 threads: numpy releases the interpreter
    lock in these loops, and nvcc's processes build beside them), where
    every column holds its digits and a value: HIST_SHAPE, int64."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    def bits(words):
        return np.unpackbits(np.ascontiguousarray(words).view(np.uint8),
                             axis=-1, bitorder="little")

    # digit planes most significant field first: edu, gen, dom, reg
    cat_planes = [p for f in ("edu", "gen", "dom", "reg")
                  for p in data[f][::-1]]
    n_bins = (1 << len(cat_planes)) * 2 * (1 << DEPTH)

    def batch(lo):
        sl = slice(lo, lo + 32)
        low = bits(data["a"][sl]) << np.uint8(DEPTH)    # a above age
        for p in range(DEPTH):
            low |= bits(data["age"][p, sl]) << np.uint8(p)
        high = np.zeros(low.shape, dtype=np.uint16)
        for plane in cat_planes:
            high = (high << np.uint16(1)) | bits(plane[sl])
        code = (high.astype(np.uint32) << np.uint32(DEPTH + 1)) | low
        return np.bincount(code.reshape(-1), minlength=n_bins)

    with ThreadPoolExecutor(max_workers=4) as ex:
        total = sum(ex.map(batch, range(0, S, 32)))
    out = np.zeros(HIST_SHAPE, dtype=np.int64)
    out[:, :2, :, :4, :, :NO_VALUE] = total.reshape(8, 2, 8, 4, 2,
                                                    1 << DEPTH)
    return out


def column_codes(data, cols, deleted):
    """The joint histogram's flat bin of each absolute column, read off
    the words as they stand (a deleted column's digits absent, a column
    without an age value in the last bin)."""
    import numpy as np
    cols = np.asarray(cols, dtype=np.int64)
    shard, c = cols // (W * 32), cols % (W * 32)
    wi, bi = c >> 5, (c & 31).astype(np.uint32)

    def bit(words):
        return ((words[shard, wi] >> bi) & 1).astype(np.int64)

    gone = np.isin(cols, np.fromiter(deleted, dtype=np.int64,
                                     count=len(deleted)))
    code = np.zeros(cols.size, dtype=np.int64)
    for f, size in zip(("edu", "gen", "dom", "reg"), HIST_SHAPE[:4]):
        d = sum(bit(pl) << b for b, pl in enumerate(data[f]))
        code = code * size + np.where(gone, ABSENT[f], d)
    code = code * 2 + bit(data["a"])
    age = sum(bit(data["age"][p]) << p for p in range(DEPTH))
    return code * HIST_SHAPE[-1] + np.where(bit(data["age_exists"]) == 1,
                                            age, NO_VALUE)


def normalise(res):
    if isinstance(res, list) and res and hasattr(res[0], "group"):
        return [(tuple(g["row_id"] for g in gc.group), gc.count, gc.agg,
                 gc.agg_count) for gc in res]
    if isinstance(res, list) and all(isinstance(x, int) for x in res):
        return list(res)                                 # Rows: row ids
    if isinstance(res, list):
        return [(p.id, p.count) for p in res]
    if type(res).__name__ == "SortedRow":
        return (res.columns, res.values)
    if type(res).__name__ == "ExtractedTable":
        return (res.fields, [(e["column"], e["rows"]) for e in res.columns])
    if hasattr(res, "values") and not callable(res.values):
        return list(res.values)
    if hasattr(res, "columns"):
        return res.columns().tolist()
    if hasattr(res, "value"):
        return (res.value, res.count)
    if hasattr(res, "id"):
        return (res.id, res.count)
    return res


def unpack(words):
    """(..., W) uint32 words → (..., W*32) uint8 0/1 per column."""
    import numpy as np
    return np.unpackbits(np.ascontiguousarray(words).view(np.uint8),
                         axis=-1, bitorder="little")


def digits(planes):
    """Per-column digit of a categorical field from its digit planes."""
    import numpy as np
    out = np.zeros(planes.shape[1:-1] + (planes.shape[-1] * 32,), np.uint8)
    for b in range(planes.shape[0]):
        out |= unpack(planes[b]) << np.uint8(b)
    return out


def loop_answers(data, headline, groupby) -> tuple[dict, dict]:
    """Phase 4a's reference: the queries answered at full width, and
    those on a leading subset of shards (query -> (shards, answer))."""
    import numpy as np
    a, t = data["a"], data["t"]

    def pc(x):
        return int(np.bitwise_count(x).sum(dtype=np.int64))

    full = dict(headline)
    full["TopK(t, Row(a=1), k=8)"] = headline["TopN(t, Row(a=1), n=8)"]
    full["MinRow(field=t)"] = (0, 1)
    # per shard the highest row under the filter, shard 0 first; a later
    # shard's equal row id does not replace it, and counts never sum
    full["MaxRow(Row(a=1), field=t)"] = (R - 1, pc(t[R - 1, 0] & a[0]))
    full["Distinct(Row(a=1), field=t)"] = [r for r in range(R)
                                           if pc(t[r] & a)]
    for q in (ABLE_SUM, "GroupBy(Rows(t), Rows(a), aggregate=Sum(field=age))"):
        full[q] = groupby[q]
    # the BSI Min, Max and Distinct walk every shard's planes on the host
    # (~2 s a call at full width): the S_DECODE leading shards
    sub = list(range(S_DECODE))
    h_any, h_a = age_hists(data, sub)
    lo_v = int(np.nonzero(h_any)[0][0])
    hi_a = int(np.nonzero(h_a)[0][-1])
    subset = {"Min(field=age)": (sub, (lo_v, int(h_any[lo_v]))),
              "Max(Row(a=1), field=age)": (sub, (hi_a, int(h_a[hi_a]))),
              "Distinct(field=age)": (
                  sub, [int(v) for v in np.nonzero(h_any)[0]])}
    return full, subset


def add_deep_field(h, rng):
    """An INT field ts of depth 40 on every column of the first S_DEEP
    shards: 2^39 plus a uniform second of one day.  Written as planes
    through the model API; returns the seconds (S_DEEP, W*32)."""
    import numpy as np
    from pilosa_tpu_torch.models.schema import FieldOptions, FieldType
    idx = h.index("bench")
    ts = idx.create_field("ts", FieldOptions(type=FieldType.INT, min=0,
                                             max=(1 << 40) - 1))
    view = ts.view(ts.bsi_view, create=True)
    secs = rng.integers(0, 86400, size=(S_DEEP, W * 32), dtype=np.int32)
    full = np.full(W, 0xFFFFFFFF, dtype=np.uint32)
    for shard in range(S_DEEP):
        frag = view.fragment(shard, create=True)
        frag.import_row_words(0, full)                   # exists
        frag.import_row_words(2 + 39, full)              # the 2^39 bit
        for p in range(17):                              # 86399 < 2^17
            bits = ((secs[shard] >> p) & 1).astype(np.uint8)
            frag.import_row_words(2 + p, np.packbits(
                bits, bitorder="little").view(np.uint32))
    return secs


def deep_answers(data, secs) -> dict:
    """Phase 4b's reference over the deep field's S_DEEP shards."""
    import numpy as np
    sl = slice(0, S_DEEP)
    abits = unpack(data["a"][sl]).astype(bool)
    tbits = unpack(data["t"][:, sl]).astype(bool)
    age = np.zeros((S_DEEP, W * 32), np.uint8)
    for p in range(DEPTH):
        age |= unpack(data["age"][p, sl]) << np.uint8(p)
    edu, gen = digits(data["edu"][:, sl]), digits(data["gen"][:, sl])
    lo = int(secs.min())
    hi_a = int(secs[abits].max())
    gb = slice(0, S_FALLBACK_GB)
    max_groups = []
    for r in range(CATEGORIES["edu"]):
        for g in range(CATEGORIES["gen"]):
            m = (edu[gb] == r) & (gen[gb] == g)
            n = int(m.sum())
            if n:
                max_groups.append(((r, g), n,
                                   TS_BASE + int(secs[gb][m].max()), n))
    min_groups = []
    for r in range(R):
        m = tbits[r, gb] & abits[gb]
        n = int(m.sum())
        if n:
            min_groups.append(((r, 1), n, int(age[gb][m].min()), n))
    distinct_groups = []
    for g in range(CATEGORIES["gen"]):
        m = gen == g
        n = int(m.sum())
        k = sum(bool((m & (edu == r)).any()) for r in range(CATEGORIES["edu"]))
        if n:
            distinct_groups.append(((g,), n, k, k))
    return {
        "Min(field=ts)": (None, (TS_BASE + lo, int((secs == lo).sum()))),
        "Max(Row(a=1), field=ts)": (S_DEEP, (TS_BASE + hi_a,
                                             int((secs[abits] == hi_a).sum()))),
        "Distinct(field=ts)": (None, [TS_BASE + int(v)
                                      for v in np.unique(secs)]),
        "GroupBy(Rows(edu), Rows(gen), aggregate=Max(field=ts))":
            (S_FALLBACK_GB, max_groups),
        "GroupBy(Rows(t), Rows(a), aggregate=Min(field=age))":
            (S_FALLBACK_GB, min_groups),
        "GroupBy(Rows(gen), aggregate=Count(Distinct(field=edu)))":
            (S_DEEP, distinct_groups),
    }


def ts_range_answers(secs) -> dict:
    """The Range counts of ts over its S_DEEP shards, from the seconds."""
    return {TS_QUERIES[0]: int((secs >= 43200).sum()),
            TS_QUERIES[1]: int(((secs > 1000) & (secs < 80000)).sum())}


def bit(words, col: int) -> bool:
    """Whether an (S, W) word array holds an absolute column."""
    shard, c = divmod(col, W * 32)
    return bool((int(words[shard, c >> 5]) >> (c & 31)) & 1)


def age_values(data, shard: int):
    """Per-column age values of one shard, (W*32,) int64."""
    import numpy as np
    out = np.zeros(W * 32, np.int64)
    for p in range(DEPTH):
        out |= unpack(data["age"][p, shard]).astype(np.int64) << p
    return out


def percentile_ref(counts, nth: float, base: int = 0):
    """The reference's Percentile search (executor.go:1310) over a
    per-value histogram of non-negative values base + i: Min and Max
    for nth 0 and 100, else the midpoint search on the histogram's
    prefix sums.  Returns (value, count) as the port reports it."""
    import numpy as np
    total = int(counts.sum())
    if total == 0:
        return None
    nz = np.nonzero(counts)[0]
    lo, hi = int(nz[0]), int(nz[-1])
    less, greater = int(total * nth / 100.0), int(total * (100.0 - nth) / 100.0)
    if greater != 0 and less == 0:
        return (base + lo, int(counts[lo]))
    if greater == 0:
        return (base + hi, int(counts[hi]))
    cum = np.concatenate([[0], np.cumsum(counts)])
    while lo < hi:
        mid = (lo + hi) // 2          # Go's midpoint of non-negatives
        if cum[mid] > less:
            hi = mid - 1
        elif total - cum[mid + 1] > greater:
            lo = mid + 1
        else:
            return (base + mid, 1)
    return (base + lo, 1)


def sort_ref(data, n: int, desc: bool, offset: int, limit):
    """Sort(Row(a=1), field=age) over the n leading shards: age values
    in sort order, each value's columns in shard order, stopping once
    offset+limit columns are found.  Returns (columns, values)."""
    import numpy as np
    need = None if limit is None else offset + limit
    decoded: dict = {}
    cols, vals = [], []
    for v in (range((1 << DEPTH) - 1, -1, -1) if desc else range(1 << DEPTH)):
        for s in range(n):
            if s not in decoded:
                decoded[s] = (age_values(data, s),
                              unpack(data["a"][s]).astype(bool))
            age, a = decoded[s]
            hit = np.nonzero(a & (age == v))[0]
            cols.extend((hit + s * W * 32).tolist())
            vals.extend([v] * hit.size)
            if need is not None and len(cols) >= need:
                return cols[offset:need], vals[offset:need]
    return cols[offset:need], vals[offset:need]


def limit_ref(data, n: int, limit: int, offset: int) -> list:
    """Limit(Row(a=1)) over the n leading shards: a's columns from the
    offset-th, at most limit, found by per-shard counts."""
    import numpy as np
    ends = np.cumsum(np.bitwise_count(data["a"][:n]).sum(
        axis=1, dtype=np.int64))
    out: list = []
    for s in range(n):
        if ends[s] <= offset:
            continue
        prev = int(ends[s - 1]) if s else 0
        hit = np.nonzero(unpack(data["a"][s]))[0] + s * W * 32
        out.extend(hit[max(0, offset - prev):].tolist())
        if len(out) >= limit:
            break
    return out[:limit]


def surface_answers(data, secs, n: int, age_hists=None):
    """Phase 4d's reference over the n leading shards (ts over
    min(n, S_DEEP)): SURFACE_QUERIES -> answer, and the ts Percentile's
    answer.  age_hists, age's per-value counts (all, under a), serve
    n = S; fewer shards are decoded here."""
    import numpy as np
    a, t, edu = data["a"], data["t"], data["edu"]

    def pc(x):
        return int(np.bitwise_count(x).sum(dtype=np.int64))

    if age_hists is None:
        vals = np.concatenate([age_values(data, s) for s in range(n)])
        abits = unpack(a[:n]).reshape(-1).astype(bool)
        age_hists = (np.bincount(vals, minlength=1 << DEPTH),
                     np.bincount(vals[abits], minlength=1 << DEPTH))
    by_age, age_a = age_hists
    within = [c for c in CONST_COLS if c // (W * 32) < n]
    first = limit_ref(data, n, 1000, 0)
    first_shards = {c // (W * 32) for c in first}
    edu_digits = {s: digits(edu[:, s]) for s in first_shards}
    ages = {s: age_values(data, s) for s in first_shards}

    def extract_row(col):
        s, c = divmod(col, W * 32)
        d = int(edu_digits[s][c])
        return (col, [[r for r in range(R) if bit(t[r], col)],
                      [d] if d < CATEGORIES["edu"] else [], int(ages[s][c])])

    shallow = limit_ref(data, n, 1000, LIMIT_OFFSET)
    high_shard, high_c = divmod(COL_HIGH, W * 32)
    low_shard = COL_LOW // (W * 32)
    want = {
        "Percentile(field=age, nth=50)": percentile_ref(by_age, 50),
        "Percentile(field=age, nth=99)": percentile_ref(by_age, 99),
        "Percentile(field=age, nth=0)": percentile_ref(by_age, 0),
        "Percentile(field=age, nth=50, filter=Row(a=1))":
            percentile_ref(age_a, 50),
        "Sort(Row(a=1), field=age, limit=100, offset=1000)":
            sort_ref(data, n, False, 1000, 100),
        "Sort(Row(a=1), field=age, sort-desc=true, limit=100, offset=1000)":
            sort_ref(data, n, True, 1000, 100),
        "Options(Sort(Row(a=1), field=age), shards=[0])":
            sort_ref(data, 1, False, 0, None),
        f"Limit(Row(a=1), limit=1000, offset={LIMIT_OFFSET})": shallow,
        f"Count(Limit(Row(a=1), limit=1000, offset={LIMIT_OFFSET}))":
            len(shallow),
        "Extract(Limit(Row(a=1), limit=1000), Rows(t), Rows(edu), "
        "Rows(age))": (["t", "edu", "age"], [extract_row(c) for c in first]),
        "Count(UnionRows(Rows(t)))": pc(np.bitwise_or.reduce(t[:, :n])),
        "Count(Intersect(Row(a=1), UnionRows(Rows(edu))))":
            pc(a[:n] & ~(edu[2, :n] & edu[1, :n])),
        f"Count(Intersect(Row(a=1), ConstRow(columns={CONST_COLS})))":
            sum(bit(a, c) for c in within),
        f"IncludesColumn(Row(a=1), column={COL_LOW})":
            low_shard < n and bit(a, COL_LOW),
        f"IncludesColumn(Row(a=1), column={COL_HIGH})":
            high_shard < n and bit(a, COL_HIGH),
        f"FieldValue(field=age, column={COL_HIGH})":
            (int(age_values(data, high_shard)[high_c]), 1),
        "Rows(t)": list(range(R)),
        f"Rows(t, column={COL_LOW})": [r for r in range(R) if low_shard < n
                                       and bit(t[r], COL_LOW)],
        f"Options(Count(Row(a=1)), shards={OPTION_SHARDS})":
            pc(a[OPTION_SHARDS]),
    }
    assert list(want) == SURFACE_QUERIES
    ts_counts = np.bincount(secs[:min(n, S_DEEP)].reshape(-1),
                            minlength=86400)
    return want, percentile_ref(ts_counts, 50, TS_BASE)


def run_queries(ex, label: str, want: dict, reps: int,
                shards=None, index: str = "bench", norm=None,
                firsts=None) -> dict:
    """Each query cold and then reps times warm through Executor.execute,
    held exactly to its answer (after norm, by default normalise);
    returns query -> warm p50 (ms), and fills firsts, when given, with
    query -> the first call's ms."""
    import torch
    norm = norm or normalise
    p50 = {}
    for q, expect in want.items():
        t0 = time.perf_counter()
        got = norm(ex.execute(index, q, shards=shards)[0])
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        if firsts is not None:
            firsts[q] = cold * 1e3
        if got != expect:
            raise AssertionError(f"{label} {q}: port {str(got)[:200]} != "
                                 f"numpy {str(expect)[:200]}")
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            again = norm(ex.execute(index, q, shards=shards)[0])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if again != expect:
                raise AssertionError(f"{label} {q}: repeat gave "
                                     f"{str(again)[:200]}")
        p50[q] = statistics.median(times) * 1e3
        print(f"{label}: {q} = {str(got)[:60]} exact; first "
              f"{cold * 1e3:.2f} ms, warm p50 {p50[q]:.3f} ms over {reps}")
    return p50


def launches_of(run) -> tuple[dict, object]:
    """The kernel launches of run(), counts set to 0 just before it."""
    from pilosa_tpu_torch.ops import kernels as K
    K.reset_launches()
    out = run()
    return dict(K.LAUNCHES), out


def phase_main_path(device, root: str, kernels_phase,
                    reps: int = 5) -> tuple[dict, dict]:
    """Phases 4 to 13, the holders persisted under root, with
    kernels_phase() (phase 3, once the kernels are built) run between
    the host's preparation of phase 4 and its first query; returns phase
    3's records and each kernel's launches summed over phases 4-13."""
    import gc
    import os

    import numpy as np
    import torch
    from pilosa_tpu_torch.executor.executor import Executor
    from pilosa_tpu_torch.obs import metrics

    free = shutil.disk_usage(root).free
    print(f"main: {root} on a disk with {free} bytes free ({card_line()})")
    if free < DISK_NEEDED:
        raise RuntimeError(f"phase 6 persists about {DISK_NEEDED} bytes; "
                           f"{root} has {free} free")
    t0 = time.perf_counter()
    h, data = build_index(os.path.join(root, "headline"))
    print(f"main: index built on the host in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    hist = joint_histogram(data)
    headline, groupby, age_hists = numpy_answers(data, hist)
    want = {**headline, **groupby}
    loop_full, loop_subset = loop_answers(data, headline, groupby)
    secs = add_deep_field(h, np.random.default_rng(11))
    deep = deep_answers(data, secs)
    ts_ranges = ts_range_answers(secs)
    surface = {n: surface_answers(data, secs, n, age_hists if n == S else None)
               for n in (S, S_DECODE)}
    print(f"main: numpy reference and the deep field ts in "
          f"{time.perf_counter() - t0:.1f} s")
    del secs
    records = kernels_phase()
    totals: dict = {}

    def note(label, launches):
        print(f"{label}: kernel launches {launches}")
        for k, n in launches.items():
            totals[k] = totals.get(k, 0) + n
        fell = metrics.OOM_TOTAL.value(outcome="host_fallback")
        if fell:
            raise AssertionError(f"{label}: pilosa_device_oom_total"
                                 f"{{outcome=host_fallback}} reads {fell:g}")

    # 4: the stacked engine (the default executor)
    t0 = time.perf_counter()
    ex = Executor(h)
    firsts: dict = {}
    launches, stacked_p50 = launches_of(
        lambda: run_queries(ex, "main", want, reps, firsts=firsts))
    note("main", launches)
    if launches != STACKED_LAUNCHES:
        raise AssertionError(f"the stacked engine's launches {launches} "
                             f"differ from {STACKED_LAUNCHES}")
    print(f"main: {time.perf_counter() - t0:.1f} s; device memory allocated "
          f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB")

    # 4a: the per-shard engine at full width
    t0 = time.perf_counter()
    lp = Executor(h)
    lp.use_stacked = False
    topn = {q: e for q, e in loop_full.items() if q.startswith("Top")}
    rest = {q: e for q, e in loop_full.items() if q not in topn}
    # each TopN/TopK scans (t has no rank caches): one masked_popcount
    # launch over its S shards a run, none of popcount_rows
    launches = dict.fromkeys(STACKED_LAUNCHES, 0)
    loop_p50, loop_firsts = {}, {}
    for q, e in topn.items():
        got, p50 = launches_of(lambda: run_queries(lp, "per-shard", {q: e}, 3,
                                                   firsts=loop_firsts))
        runs = 1 + 3
        print(f"per-shard: {q}: masked_popcount launched {got['masked_popcount']}"
              f" times over {runs} runs of {S} shards, popcount_rows "
              f"{got['popcount_rows']}")
        if got["masked_popcount"] != runs or got["popcount_rows"]:
            raise AssertionError(f"per-shard {q}: launches {got}, expected "
                                 f"one masked_popcount a run")
        loop_p50.update(p50)
        for k, n in got.items():
            launches[k] += n
    more, rest_p50 = launches_of(lambda: run_queries(lp, "per-shard", rest, 3,
                                                     firsts=loop_firsts))
    loop_p50.update(rest_p50)
    for q, (sub, expect) in loop_subset.items():
        got, _ = launches_of(lambda: run_queries(
            lp, f"per-shard ({len(sub)} shards)", {q: expect}, 1, shards=sub))
        for k, n in got.items():
            more[k] += n
    note("per-shard", {k: launches[k] + more[k] for k in launches})
    for q, ms in loop_p50.items():
        print(f"per-shard vs stacked: {q}: warm p50 {ms:.3f} ms per shard "
              f"engine, {stacked_p50.get(q, float('nan')):.3f} ms stacked")
    if any(route not in ("asked", "only_route") for _q, route in lp.paths):
        raise AssertionError(f"per-shard routes {dict(lp.paths)}")
    print(f"per-shard: {time.perf_counter() - t0:.1f} s; routes "
          f"{dict(lp.paths)}")

    # 4b: the fallbacks on the default executor
    t0 = time.perf_counter()
    ex.paths.clear()

    def fallbacks():
        for q, (n_shards, expect) in deep.items():
            sub = None if n_shards is None else list(range(n_shards))
            run_queries(ex, "fallback" + (f" ({n_shards} shards)" if sub
                                          else ""), {q: expect}, 1, shards=sub)
    launches, _ = launches_of(fallbacks)
    note("fallback", launches)
    routes = {("Min", "value_hist_depth"), ("Max", "value_hist_depth"),
              ("Distinct", "value_hist_depth"), ("GroupBy", "groupby_minmax"),
              ("GroupBy", "count_distinct")}
    if set(ex.paths) != routes:
        raise AssertionError(f"fallback routes {dict(ex.paths)}, expected "
                             f"{sorted(routes)}")
    print(f"fallback: {time.perf_counter() - t0:.1f} s; routes "
          f"{dict(ex.paths)}")
    # Range counts of ts (depth 40) on both engines
    t0 = time.perf_counter()
    deep_shards = list(range(S_DEEP))
    dp = Executor(h)
    dp.use_stacked = False
    for label, e in (("ts range", ex), ("ts range per-shard", dp)):
        launches, _ = launches_of(lambda: run_queries(
            e, f"{label} ({S_DEEP} shards)", ts_ranges, 3, shards=deep_shards))
        note(label, launches)
        if launches["bsi_range"] == 0:
            raise AssertionError(f"{label}: bsi_range never launched")
    print(f"ts range: {time.perf_counter() - t0:.1f} s")
    del dp

    # 4c: the one-hot arm
    t0 = time.perf_counter()
    oh = Executor(h)
    oh.stacked.onepass_arm = "onehot"
    onehot_want = {q: want[q] for q in ONEHOT_QUERIES}
    launches, onehot_p50 = launches_of(
        lambda: run_queries(oh, "onehot", onehot_want, reps))
    note("onehot", launches)
    if launches["groupby_onehot"] == 0:
        raise AssertionError("the one-hot arm never launched groupby_onehot")
    for q, ms in onehot_p50.items():
        print(f"onehot vs fused: {q}: warm p50 {ms:.3f} ms one-hot arm, "
              f"{stacked_p50[q]:.3f} ms fused arm")
    print(f"onehot: {time.perf_counter() - t0:.1f} s")
    del oh
    phase_read_surface(h, surface, note)
    phase_mesh(h, ex, want, stacked_p50, note)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    before = {"stacked": (firsts, stacked_p50),
              "per-shard": (loop_firsts, loop_p50)}
    post = phase_writes(ex, lp, data, hist, before, note)
    print(f"writes: {time.perf_counter() - t0:.1f} s")
    del lp, hist
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    keyed = phase_keys(h, note)
    print(f"keys: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sql_want = phase_sql(h, ex, data, post, keyed, note)
    print(f"sql: {time.perf_counter() - t0:.1f} s")
    # 6a: sync, drop the holder and every executor, reopen from disk
    t0 = time.perf_counter()
    sync_and_close(h, "restart")
    del h, ex
    gc.collect()
    torch.cuda.empty_cache()
    print(f"restart: holder and executors dropped; device memory allocated "
          f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB")
    h = phase_restart(os.path.join(root, "headline"), data, post, keyed,
                      sql_want, before, note)
    print(f"restart: {time.perf_counter() - t0:.1f} s")
    # phase 8's reference: the a row and COLD_QUERY from the mirror
    mem_ref = {"a": data["a"],
               "cold": int(np.bitwise_count(data["t"][3]).sum(dtype=np.int64))}
    del data
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_ingest(os.path.join(root, "ingest"), note)
    print(f"ingest: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_time_window(device, note)
    print(f"time: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    try:
        phase_memory(h, post["want"], mem_ref, device, note)
        print(f"memory: {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        phase_serving(h, device, note)
        gc.collect()
        torch.cuda.empty_cache()
        http_p50, undo = phase_node(h, post["want"], sql_want, root, note)
        gc.collect()
        torch.cuda.empty_cache()
        ref = phase_cluster(h, stacked_p50, http_p50, undo, root, note)
        gc.collect()
        torch.cuda.empty_cache()
        phase_dax(h, ref, root, note)
    finally:
        h.close()
    missing = [k for k, n in totals.items() if n == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    print(f"main path: kernel launches over phases 4-13 {totals}")
    return records, totals


# phase 13: the mesh (run after 4d, before 5a writes)
MESH_SLOTS = 4
MESH_ROWS = 2
MESH_REPS = 3
MESH_STORM_CLIENTS = 8
MESH_STORM_S = 15.0             # several hundred queries at 8 clients
DIST_ROWS = 8


def mesh_devices_for(n: int) -> list:
    """n slots: one card each where the machine has n cards, else every
    slot on card 0 (the slots share it)."""
    import torch
    k = torch.cuda.device_count()
    if k >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * n


def empty_answer(q: str):
    """The JAX executor's answer to q over shards=[]: no columns, no
    pairs, no groups, no values; a zero count and sum; no Min/Max value."""
    if q.startswith("Count"):
        return 0
    if q.startswith("Sum"):
        return (0, 0)
    if q.startswith(("Min", "Max")):
        return (None, 0)
    return []


def phase_empty_shards(h, mx, queries, note) -> None:
    """13 C.6: queries over shards=[] on the stacked engine paged and
    unpaged, the per-shard engine and the mesh executor mx, each held to
    empty_answer with no kernel launched."""
    from pilosa_tpu_torch import memory
    from pilosa_tpu_torch.executor.executor import Executor

    prev = memory.paged_enabled()
    labels = []
    try:
        for paged in (True, False):
            memory.configure(paged=paged)
            tag = "paged" if paged else "unpaged"
            ps = Executor(h)
            ps.use_stacked = False
            engines = [(f"stacked {tag}", Executor(h)),
                       (f"per-shard {tag}", ps)]
            if not paged:                   # the mesh arm never pages
                engines.append(("mesh", mx))
            for label, e in engines:
                launches, got = launches_of(lambda: {
                    q: normalise(e.execute("bench", q, shards=[])[0])
                    for q in queries})
                note(f"13 C.6 {label}", launches)
                bad = {q: a for q, a in got.items() if a != empty_answer(q)}
                if bad or any(launches.values()):
                    raise AssertionError(f"13 C.6 {label}: shards=[] gave "
                                         f"{bad}, launches {launches}")
                labels.append(label)
    finally:
        memory.configure(paged=prev)
    print(f"13 C.6: {len(queries)} queries over shards=[] on {labels}: "
          f"the JAX executor's empty answers, no kernel launched")


def phase_mesh(h, ex, want: dict, stacked_p50: dict, note) -> None:
    """Phase 13 (see the module docstring) on phase 4's headline index,
    before 5a writes to it."""
    import gc

    import numpy as np
    import torch
    from pilosa_tpu_torch import memory
    from pilosa_tpu_torch.executor.executor import Executor
    from pilosa_tpu_torch.memory import placement
    from pilosa_tpu_torch.obs import metrics
    from pilosa_tpu_torch.obs.monitor import global_monitor
    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.parallel import (dist_bsi_sum_counts, dist_count,
                                           dist_count_intersect,
                                           dist_topk_counts, host_bsi_sum,
                                           host_count, make_mesh,
                                           place_flat, place_shards)
    from pilosa_tpu_torch.parallel.mesh import slices

    card = card_line()
    devs = mesh_devices_for(MESH_SLOTS)
    shared = len(set(devs)) == 1
    print(f"13: {MESH_SLOTS} slots on {sorted(set(str(d) for d in devs))}"
          + (" (the slots share the one card)" if shared else
             " (one card a slot)") + f" ({card})")
    t_all = time.perf_counter()

    # 13a: the engine's mesh arm, one slot and then (rows 2) x 2
    t0 = time.perf_counter()
    one = Executor(h)
    one.set_mesh(make_mesh(1, devices=devs[:1]))
    launches, _ = launches_of(lambda: run_queries(one, "13a 1 slot", want,
                                                  5))
    note("13a 1 slot", launches)
    if launches != STACKED_LAUNCHES:
        raise AssertionError(f"13a: a one-slot mesh launched {launches}, "
                             f"the single device {STACKED_LAUNCHES}")
    print(f"13a: a one-slot mesh launched exactly STACKED_LAUNCHES in "
          f"{time.perf_counter() - t0:.1f} s")
    del one
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh = make_mesh(MESH_SLOTS, rows=MESH_ROWS, devices=devs)
    mx = Executor(h)
    mx.set_mesh(mesh)
    legs = sum(1 for lo, hi in slices(S, MESH_SLOTS) if hi > lo)
    mesh_p50 = {}
    total = dict.fromkeys(K.LAUNCHES, 0)
    for q, expect in want.items():
        single, _ = launches_of(lambda: ex.execute("bench", q))
        got, p50 = launches_of(lambda: run_queries(
            mx, f"13a {MESH_ROWS}x{MESH_SLOTS // MESH_ROWS}", {q: expect},
            MESH_REPS))
        mesh_p50.update(p50)
        runs = 1 + MESH_REPS
        for k, n in got.items():
            total[k] += n
        # every slot's leg launches what one device launches for the
        # query; whole stacks, so no page assembly
        expected = {k: (0 if k == "assemble_pages" else v * legs * runs)
                    for k, v in single.items()}
        if got != expected:
            raise AssertionError(f"13a {q}: launches {got}, expected "
                                 f"{expected} ({legs} legs x {runs} runs)")
    note("13a mesh", total)
    for q, ms in mesh_p50.items():
        print(f"13a vs 4: {q}: warm p50 {ms:.3f} ms on the "
              f"{MESH_ROWS}x{MESH_SLOTS // MESH_ROWS} mesh, "
              f"{stacked_p50.get(q, float('nan')):.3f} ms single device "
              f"({card})")
    print(f"13a: every answer equal to numpy and to phase 4; {legs} legs a "
          f"query, each launching the single device's kernels; "
          f"{time.perf_counter() - t0:.1f} s; device memory allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    phase_empty_shards(h, mx, ["Row(a=1)"] + list(want), note)
    del mx
    gc.collect()
    torch.cuda.empty_cache()

    # 13b: the serving storm on one device, then on the serving mesh,
    # both with the result cache off
    t0 = time.perf_counter()
    items = [("bench", q, None) for q in SERVING_QUERIES]
    solo_want = {_key(it): digest(ex.execute(*it)) for it in items}

    def serve_storm(label, held=None):
        """The storm on a fresh serving layer; held(), when given, reads
        what the layer holds before it is closed."""
        srv = Executor(h)
        layer = srv.enable_serving(window_s=0.001, max_batch=64,
                                   cache_bytes=0, admission=False)
        try:
            for it in items:                          # the warm pass
                if digest(srv.execute_serving(*it)) != solo_want[_key(it)]:
                    raise AssertionError(f"13b {label} warm {it}: differs "
                                         "from solo")
            c0 = len(global_monitor.recent())
            got, res = launches_of(lambda: storm(
                srv, items, solo_want, MESH_STORM_CLIENTS, MESH_STORM_S))
            failed = [e.get("message") for e in global_monitor.recent()[c0:]
                      if str(e.get("where", "")).startswith("serving.")]
            if failed:
                raise AssertionError(f"13b {label}: a program failed: "
                                     f"{failed[:3]}")
            note(f"13b {label}", got)
            if res["bad"] or res["errors"]:
                raise AssertionError(f"13b {label}: {len(res['bad'])} "
                                     f"mismatches {res['bad'][:3]}, errors "
                                     f"{res['errors'][:3]}")
            if held is not None:
                held()
        finally:
            layer.close()
        print(f"13b {label}: {MESH_STORM_CLIENTS} clients x {MESH_STORM_S} "
              f"s, result cache off: {res['n']} queries, {res['qps']:.1f} "
              f"qps, p50 {res['p50']:.3f} ms, p99 {res['p99']:.3f} ms; "
              f"concat_gather {got['concat_gather']}, segment_count "
              f"{got['segment_count']} launches; every answer equal to "
              f"solo ({card})")
        del srv, layer
        gc.collect()
        torch.cuda.empty_cache()

    serve_storm("one device")
    placement.configure(mesh_devices=MESH_SLOTS, devices=devs)
    m0 = metrics.SERVING_DISPATCH.value(kind="ragged_mesh")

    def held():
        disp = metrics.SERVING_DISPATCH.value(kind="ragged_mesh") - m0
        led = memory.ledger()
        per = led.device_bytes(MESH_SLOTS)
        share = led.device_budget()
        if disp <= 0:
            raise AssertionError("13b: no ragged_mesh dispatch")
        if any(b > share for b in per) or sum(1 for b in per if b) < 2:
            raise AssertionError(f"13b: resident bytes a slot {per}, "
                                 f"share {share}")
        print(f"13b: ragged_mesh dispatches {disp:g}; resident bytes a slot "
              f"{per} within {share}")
    try:
        serve_storm("serving mesh", held)
    finally:
        placement.reset()
        memory.ledger().set_devices(1)
    print(f"13b: {time.perf_counter() - t0:.1f} s")

    # 13c: dist.py at (S, W)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(1913)
    dev = devs[0]
    a = random_words(gen, (S, W), dev)
    b = random_words(gen, (S, W), dev)
    planes = random_words(gen, (S, 2 + DEPTH, W), dev)
    rows = random_words(gen, (DIST_ROWS, S, W), dev)
    rows[5] = rows[1]                                 # a tie
    flat = make_mesh(MESH_SLOTS, devices=devs)

    def dist_run():
        pa, pb = place_shards(flat, a), place_shards(flat, b)
        c = dist_count(pa)
        ci = dist_count_intersect(pa, pb)
        sums = dist_bsi_sum_counts(place_shards(flat, planes),
                                   place_shards(flat, b))
        top = dist_topk_counts(place_flat(flat, rows, shard_axis=1),
                               place_shards(flat, b), 3)
        return c, ci, sums, top
    got, (c, ci, sums, top) = launches_of(dist_run)
    note("13c", got)
    checks = {
        "dist_count": (c, K.popcount_rows_plain(a)),
        "dist_count_intersect": (ci, K.pair_popcount_plain(a, b)),
    }
    for label, (x, y) in checks.items():
        if not torch.equal(x.to(torch.int64), y.to(torch.int64)):
            raise AssertionError(f"13c {label} differs from its plain "
                                 "version")
    pc, pp, pn = K.bsi_sum_counts_plain(planes, b)
    if host_bsi_sum(*sums) != host_bsi_sum(pc, pp, pn) \
            or host_count(c) != int(K.popcount_rows_plain(a)
                                    .sum(dtype=torch.int64)):
        raise AssertionError("13c: dist sums differ from the plain versions")
    counts = K.rows_filter_counts_plain(rows, b).sum(dim=1, dtype=torch.int64)
    order = np.argsort(-counts.cpu().numpy(), kind="stable")[:3]
    if top[1].tolist() != order.tolist() \
            or top[0].tolist() != counts.cpu().numpy()[order].tolist():
        raise AssertionError(f"13c: top-k {top} vs {order}")
    print(f"13c: dist_count, dist_count_intersect, dist_bsi_sum_counts and "
          f"dist_topk_counts over ({S}, {W}) on {MESH_SLOTS} slots exact "
          f"against the plain versions (top-3 {order.tolist()}); "
          f"{time.perf_counter() - t0:.1f} s")
    del a, b, planes, rows
    torch.cuda.empty_cache()

    print(f"13: {time.perf_counter() - t_all:.1f} s ({card})")


def phase_read_surface(h, surface, note) -> None:
    """4d: SURFACE_QUERIES through Executor.execute, each cold and then 3
    times warm, on the stacked engine at full width and on the per-shard
    engine over the S_DECODE leading shards, and Percentile of ts (depth
    40) on the stacked engine's 64 shards and the per-shard engine's 16;
    every answer exact, the launches of each query checked."""
    from pilosa_tpu_torch.executor.executor import Executor
    for label, use_stacked, n in (("surface", True, S),
                                  ("surface per-shard", False, S_DECODE)):
        t0 = time.perf_counter()
        ex = Executor(h)
        ex.use_stacked = use_stacked
        shards = None if use_stacked else list(range(n))
        want, ts_want = surface[n]
        launches = {}
        for q, expect in want.items():
            got, _ = launches_of(lambda: run_queries(
                ex, label if shards is None else f"{label} ({n} shards)",
                {q: expect}, 3, shards=shards))
            searches = q.startswith("Percentile") and "nth=0)" not in q
            needs = (["bsi_range"] if searches else []) + (
                ["groupby_fused"] if q.startswith("Percentile") and use_stacked
                else []) + (["popcount_rows"] if "Limit(" in q else [])
            print(f"{label}: {q}: launches over 4 runs "
                  f"{ {k: c for k, c in got.items() if c} }")
            if any(got[k] == 0 for k in needs):
                raise AssertionError(f"{label} {q}: launches {got}, expected "
                                     f"each of {needs}")
            for k, c in got.items():
                launches[k] = launches.get(k, 0) + c
        ts_shards = list(range(S_DEEP if use_stacked else n))
        ex.paths.clear()
        got, _ = launches_of(lambda: run_queries(
            ex, f"{label} ts ({len(ts_shards)} shards)",
            {TS_PERCENTILE: ts_want}, 3, shards=ts_shards))
        routes = ({("Min", "value_hist_depth"), ("Max", "value_hist_depth")}
                  if use_stacked else {("Min", "asked"), ("Max", "asked")})
        if not routes <= set(ex.paths) or got["bsi_range"] == 0:
            raise AssertionError(f"{label} {TS_PERCENTILE}: routes "
                                 f"{dict(ex.paths)}, launches {got}")
        for k, c in got.items():
            launches[k] = launches.get(k, 0) + c
        note(label, launches)
        print(f"{label}: {time.perf_counter() - t0:.1f} s; ts routes "
              f"{dict(ex.paths)}")


# phase 5a: the seeded batch of PQL writes on the headline index
WRITE_SEED = 2026
DELETE_SHARDS, DELETE_PER_SHARD = 10, 10
# the per-shard engine's queries rerun after the batch
LOOP_AFTER_WRITES = ["TopN(t, n=8)", "TopN(t, Row(a=1), n=8)",
                     "TopK(t, Row(a=1), k=8)",
                     "Count(Intersect(Row(a=1), Row(b=1)))",
                     "Count(Row(a=1))"]
STORE_COUNT = "Count(Row(s=1))"


def write_batch(rng) -> list:
    """Phase 5a's writes in a seeded order, each (pql, verb, field,
    column or columns, row or value): 400 Set/Clear of a, 200 of b, 200
    Set of t rows 0-7, 150 Set of age values (within its depth), 50
    Clear of age, ClearRow(t=7), a Store of Intersect(a, b) into a new
    field s, and a Delete of 100 columns over 10 shards."""
    ncols = S * W * 32
    ops = []
    for field, n in (("a", 400), ("b", 200)):
        for col in rng.integers(0, ncols, n).tolist():
            verb = "Set" if rng.random() < 0.5 else "Clear"
            ops.append((f"{verb}({col}, {field}=1)", verb, field, col, 1))
    for col, r in zip(rng.integers(0, ncols, 200).tolist(),
                      rng.integers(0, R, 200).tolist()):
        ops.append((f"Set({col}, t={r})", "Set", "t", col, r))
    for col, v in zip(rng.integers(0, ncols, 150).tolist(),
                      rng.integers(0, 1 << DEPTH, 150).tolist()):
        ops.append((f"Set({col}, age={v})", "Set", "age", col, v))
    for col in rng.integers(0, ncols, 50).tolist():
        ops.append((f"Clear({col}, age=0)", "Clear", "age", col, None))
    ops.append(("ClearRow(t=7)", "ClearRow", "t", None, 7))
    ops.append(("Store(Intersect(Row(a=1), Row(b=1)), s=1)", "Store", "s",
                None, 1))
    gone = sorted(int(sh) * W * 32 + int(c)
                  for sh in rng.choice(S, DELETE_SHARDS, replace=False)
                  for c in rng.choice(W * 32, DELETE_PER_SHARD, replace=False))
    ops.append((f"Delete(ConstRow(columns={gone}))", "Delete", None, gone,
                None))
    return [ops[i] for i in rng.permutation(len(ops))]


def put(words, col: int, on: bool) -> None:
    """Set or clear an absolute column's bit in (S, W) words."""
    shard, c = divmod(col, W * 32)
    b = 1 << (c & 31)
    if on:
        words[shard, c >> 5] |= b
    else:
        words[shard, c >> 5] &= ~b & 0xFFFFFFFF


def mirror(data, op, deleted: set) -> None:
    """Apply one write of the batch to the numpy arrays."""
    import numpy as np
    _pql, verb, field, col, val = op
    if field in ("a", "b"):
        put(data[field], col, verb == "Set")
    elif verb == "Set" and field == "t":
        put(data["t"][val], col, True)
    elif field == "age":
        for p in range(DEPTH):
            put(data["age"][p], col, verb == "Set" and (val >> p) & 1)
        put(data["age_exists"], col, verb == "Set")
    elif verb == "ClearRow":
        data["t"][val][:] = 0
    elif verb == "Store":
        data["s"] = data["a"] & data["b"]
    elif verb == "Delete":
        mask = np.zeros((S, W), np.uint32)
        for c in col:
            put(mask, c, True)
        for name in ("a", "b", "t", "s", "age", "age_exists"):
            if name in data:
                data[name] &= ~mask
        deleted.update(col)


def phase_writes(ex, lp, data, hist, before: dict, note) -> dict:
    """5a: the write batch through Executor.execute on the headline index,
    mirrored into the numpy arrays (the joint histogram updated at the
    columns the batch touched); then phase 4's stacked query set (plus a
    Count of the stored row) on phase 4's executor and the per-shard
    TopN/Count set on phase 4a's, each exact against numpy recomputed
    from the mirrored arrays, each query's first call and warm p50
    printed beside its engine's in phase 4 (before: engine -> (firsts,
    p50s)).  Every stack and tile the batch made stale must be patched: the caches may build only stacks under new keys
    (the new field s, a row set that changed), plus, for the per-shard
    tiles, a (W,) tile all of whose words a write dirtied (its one
    re-upload).  Returns the answers after the batch (want, the stacked
    set; loop_want, the per-shard set) and the deleted columns."""
    import numpy as np
    ops = write_batch(np.random.default_rng(WRITE_SEED))
    cols = sorted({c for op in ops if op[2] in ("a", "age")
                   for c in [op[3]]} | {c for op in ops if op[1] == "Delete"
                                        for c in op[3]})
    old = column_codes(data, cols, set())
    deleted: set = set()
    times: dict = {}
    for op in ops:
        t0 = time.perf_counter()
        ex.execute("bench", op[0])
        times.setdefault(op[1], []).append(time.perf_counter() - t0)
        mirror(data, op, deleted)
    for verb, ts in times.items():
        print(f"writes: {len(ts)} x {verb}: p50 {statistics.median(ts) * 1e3:.4f}"
              f" ms, total {sum(ts) * 1e3:.1f} ms through execute (host)")
    t0 = time.perf_counter()
    flat = hist.reshape(-1).copy()
    np.subtract.at(flat, old, 1)
    np.add.at(flat, column_codes(data, cols, deleted), 1)
    headline, groupby, ages = numpy_answers(data, flat.reshape(HIST_SHAPE))
    want = {**headline, **groupby,
            STORE_COUNT: int(np.bitwise_count(data["s"]).sum(dtype=np.int64))}
    print(f"writes: {len(ops)} writes, {len(cols)} columns in the joint "
          f"histogram; numpy reference again in {time.perf_counter() - t0:.1f} s")

    def rebuilt(now, was):
        return {k: n - was["rebuilds"].get(k, 0)
                for k, n in now["rebuilds"].items()
                if n != was["rebuilds"].get(k, 0)}

    loop_want = {q: want[q.replace("TopK", "TopN").replace("k=8", "n=8")]
                 for q in LOOP_AFTER_WRITES}
    for engine, e, queries, cache in (
            ("stacked", ex, want, ex.stacked.cache),
            ("per-shard", lp, loop_want, lp.tiles.cache)):
        label = f"writes {engine}"
        firsts4, p50_4 = before[engine]
        keys_before = set(cache.keys())
        was = cache.counters()
        firsts: dict = {}
        launches, p50 = launches_of(lambda: run_queries(
            e, label, queries, 3, firsts=firsts))
        note(label, launches)
        now = cache.counters()
        for q in queries:
            print(f"{label}: {q}: first call after the writes "
                  f"{firsts[q]:.3f} ms (phase 4's first {firsts4.get(q, float('nan')):.3f}"
                  f" ms), warm p50 {p50[q]:.3f} ms (phase 4's "
                  f"{p50_4.get(q, float('nan')):.3f} ms)")
        new = [k for k in cache.keys() if k not in keys_before]
        builds = rebuilt(now, was)
        print(f"{label}: cache {now}; this run: patches "
              f"{now['patches'] - was['patches']}, patched bytes "
              f"{now['patched_bytes'] - was['patched_bytes']}, rebuilds "
              f"{builds}, rebuilt bytes "
              f"{now['rebuilt_bytes'] - was['rebuilt_bytes']}; new keys "
              f"{[str(k)[:70] for k in new]}")
        allowed = {"cold"} | ({"dirty_frac"} if e is lp else set())
        if now["patches"] == was["patches"] or set(builds) - allowed or \
                builds.get("cold", 0) > len(new):
            raise AssertionError(f"{label}: the batch's stale stacks were not "
                                 f"all patched: rebuilds {builds}")
        if e is ex and any("s" not in k and "t" not in k for k in new):
            raise AssertionError(f"{label}: unexpected new stacks {new}")
    return {"want": want, "loop_want": loop_want, "deleted": deleted,
            "ages": ages}


# phase 5b: a keyed index through the translators and the import API
KEYS_N = 1 << 18
KEY_ROWS = 64


def keyed_norm(res):
    """A keyed answer in comparable form: a row result's columns and
    keys, groups with their row keys, pairs with their keys."""
    if hasattr(res, "segments"):
        return (res.columns().tolist(), res.keys)
    if isinstance(res, list) and res and hasattr(res[0], "group"):
        return [(tuple((g["row_id"], g.get("row_key")) for g in gc.group),
                 gc.count, gc.agg, gc.agg_count) for gc in res]
    if isinstance(res, list) and res and hasattr(res[0], "key"):
        return [(p.id, p.key, p.count) for p in res]
    if type(res).__name__ == "ExtractedTable":
        return (res.fields, [(e["column"], e["rows"], e.get("column_key"))
                             for e in res.columns])
    if hasattr(res, "value"):
        return (res.value, res.count)
    return res


def phase_keys(h, note) -> dict:
    """5b: the keyed index kidx: 2^18 column keys through the
    PartitionedTranslator (256 partitions), a keyed set field kf of 64
    row keys (each column in one row), an unkeyed set field ks of 8
    rows, and an INT kv of depth 20; its queries on both engines, each
    exact against numpy and the key lists, then a Set that creates a
    column key and a row key, and its Count.  Returns the answers that
    phase 6a holds the reopened index to, and the id the next column key
    NEW_KEY must get."""
    import numpy as np
    from pilosa_tpu_torch.executor.executor import Executor
    from pilosa_tpu_torch.models.schema import (
        CACHE_TYPE_NONE, FieldOptions, FieldType)
    from pilosa_tpu_torch.storage import translate

    rng = np.random.default_rng(17)
    idx = h.create_index("kidx", keys=True)
    keys = np.array([f"c{i:07d}" for i in range(KEYS_N)])
    t0 = time.perf_counter()
    ids = idx.column_translator.create_keys(*keys.tolist())
    made = time.perf_counter() - t0
    cols = np.fromiter((ids[k] for k in keys.tolist()), np.int64, KEYS_N)
    print(f"keys: create_keys of {KEYS_N} column keys: {made * 1e3:.1f} ms "
          f"(host), over {np.unique(cols // (W * 32)).size} shards")
    t0 = time.perf_counter()
    kf = idx.create_field("kf", FieldOptions(keys=True))
    rkeys = [f"k{i:02d}" for i in range(KEY_ROWS)]
    rmap = kf.row_translator.create_keys(*rkeys)
    rid = np.array([rmap[k] for k in rkeys], np.int64)
    rk = rng.integers(0, KEY_ROWS, KEYS_N)
    kf.import_bits(rid[rk], cols)
    ks = idx.create_field("ks", FieldOptions(cache_type=CACHE_TYPE_NONE))
    kr = rng.integers(0, 8, KEYS_N)
    ks.import_bits(kr, cols)
    kv = idx.create_field("kv", FieldOptions(type=FieldType.INT,
                                             min=-(1 << 20) + 1,
                                             max=(1 << 20) - 1))
    vals = rng.integers(-(1 << 20) + 1, 1 << 20, KEYS_N)
    has = rng.random(KEYS_N) < 0.9
    kv.import_values(cols[has], vals[has])
    print(f"keys: kf, ks and kv ({kv.bit_depth} planes) imported in "
          f"{time.perf_counter() - t0:.1f} s (host)")

    def top(counts, n=10):
        order = sorted(range(KEY_ROWS), key=lambda r: (-counts[r], rid[r]))
        return [(int(rid[r]), rkeys[r], int(counts[r])) for r in order[:n]
                if counts[r]]

    sel = rk == 17
    order17 = np.argsort(cols[sel])
    code = rk * 8 + kr
    n_c = np.bincount(code, minlength=KEY_ROWS * 8)
    nn_c = np.bincount(code[has], minlength=KEY_ROWS * 8)
    sum_c = np.zeros(KEY_ROWS * 8, np.int64)
    np.add.at(sum_c, code[has], vals[has])
    groups = [(((int(rid[i]), rkeys[i]), (j, None)), int(n_c[i * 8 + j]),
               int(sum_c[i * 8 + j]), int(nn_c[i * 8 + j]))
              for i in np.argsort(rid) for j in range(8) if n_c[i * 8 + j]]
    two = sorted(["c0000001", "c0000002"], key=lambda k: ids[k])
    want = {
        'Count(Row(kf="k17"))': int(sel.sum()),
        'Row(kf="k17")': (cols[sel][order17].tolist(),
                          keys[sel][order17].tolist()),
        "TopN(kf, n=10)": top(np.bincount(rk, minlength=KEY_ROWS)),
        "TopN(kf, Row(ks=3), n=10)": top(np.bincount(rk[kr == 3],
                                                     minlength=KEY_ROWS)),
        "GroupBy(Rows(kf), Rows(ks), aggregate=Sum(field=kv))": groups,
        'Rows(kf, like="k1%")': [k for k in rkeys if k.startswith("k1")],
        'Extract(ConstRow(columns=["c0000001", "c0000002"]), Rows(kf), '
        'Rows(kv))': (["kf", "kv"], [
            (ids[k], [[rkeys[rk[int(k[1:])]]],
                      int(vals[int(k[1:])]) if has[int(k[1:])] else None], k)
            for k in two]),
        'FieldValue(field=kv, column="c0000009")':
            (int(vals[9]), 1) if has[9] else (None, 0),
    }
    for label, use_stacked in (("keys stacked", True),
                               ("keys per-shard", False)):
        kex = Executor(h)
        kex.use_stacked = use_stacked
        launches, _ = launches_of(lambda: run_queries(
            kex, label, want, 3, index="kidx", norm=keyed_norm))
        note(label, launches)
        # stacked, kf's rows fill packed pages (about 64 bits a shard),
        # which expand on the card through assemble_pages
        needs = (["popcount_rows", "groupby_fused", "rows_filter_counts",
                  "assemble_pages"] if use_stacked else
                 ["popcount_rows", "bsi_sum_counts", "masked_popcount"])
        if any(launches[k] == 0 for k in needs):
            raise AssertionError(f"{label}: launches {launches}, expected "
                                 f"each of {needs}")
        if use_stacked:
            q = 'Count(Row(kf="k17"))'
            arm, _ = launches_of(lambda: run_queries(
                kex, label, {q: want[q]}, 1, index="kidx", norm=keyed_norm))
            if not arm["popcount_rows"]:
                raise AssertionError(f"{label}: {q} launched {arm}, expected "
                                     "popcount_rows")
            t0 = time.perf_counter()
            kex.execute("kidx", 'Set("c9999999", kf="k65")')
            print(f'{label}: Set("c9999999", kf="k65") creating a column '
                  f"key and a row key: {(time.perf_counter() - t0) * 1e3:.3f}"
                  " ms (host)")
        got, _ = launches_of(lambda: run_queries(
            kex, label, {'Count(Row(kf="k65"))': 1}, 3, index="kidx"))
        note(label, got)
    # NEW_KEY's partition allocates the next id past its highest, and a
    # partition's ids are those whose shard hashes to it
    taken = np.append(cols, list(idx.column_translator.find_keys(
        "c9999999").values()))
    part = translate.key_to_key_partition("kidx", NEW_KEY)
    shards = np.unique(taken // (W * 32))
    mine = shards[[translate.shard_to_shard_partition("kidx", int(sh)) == part
                   for sh in shards.tolist()]]
    in_part = taken[np.isin(taken // (W * 32), mine)]
    next_id = translate.next_partitioned_id(
        "kidx", int(in_part.max()) if in_part.size else 0, part, W * 32)
    return {"want": {q: want[q] for q in RESTART_KEYED}, "next_id": next_id,
            "taken": set(taken.tolist()),
            "kf_counts": {**{k: int(n) for k, n in zip(
                rkeys, np.bincount(rk, minlength=KEY_ROWS))}, "k65": 1}}


# phase 5c: SQL on the card, on the index phases 4-5b left
SQL_SEED = 2028
SQL_INSERT_SHARDS = 64      # one INSERTed column in each of 64 shards
SQL_REPS = {"stacked": 5, "per-shard": 3}
SQL_COUNT_AB = ("SELECT COUNT(*) FROM bench WHERE SETCONTAINS(a, 1) AND "
                "SETCONTAINS(b, 1)")
SQL_SUM_A = "SELECT SUM(age) FROM bench WHERE SETCONTAINS(a, 1)"
SQL_SUM = "SELECT SUM(age) FROM bench"
SQL_GE64 = "SELECT COUNT(*) FROM bench WHERE age >= 64"
SQL_BETWEEN = "SELECT COUNT(*) FROM bench WHERE age BETWEEN 10 AND 100"
# the able gauntlet and GroupBy(t, a): set columns group member-wise
# only under the flatten hint (without it a set column groups by its
# whole set, sql3's semantics, on the host)
SQL_ABLE = ("SELECT edu, gen, dom, SUM(age) FROM bench WITH (flatten(edu), "
            "flatten(gen), flatten(dom)) GROUP BY edu, gen, dom")
SQL_TA = ("SELECT t, a, SUM(age) FROM bench WITH (flatten(t), flatten(a)) "
          "GROUP BY t, a")
SQL_MINMAX = ("SELECT MIN(age), MAX(age), AVG(age) FROM bench WHERE "
              "SETCONTAINS(a, 1)")
SQL_DISTINCT = "SELECT DISTINCT age FROM bench"
SQL_PERCENTILE = "SELECT PERCENTILE(age, 50) FROM bench"
SQL_ORDER = ("SELECT _id, age FROM bench WHERE SETCONTAINS(a, 1) AND "
             "age > 120 ORDER BY age DESC LIMIT 100")
SQL_LIMIT = "SELECT _id, age FROM bench WHERE SETCONTAINS(a, 1) LIMIT 10"
SQL_KCOUNT = "SELECT COUNT(*) FROM kidx WHERE SETCONTAINS(kf, 'k17')"
SQL_KGROUP = "SELECT kf, COUNT(*) FROM kidx WITH (flatten(kf)) GROUP BY kf"
# statement -> (kernels that must launch on the stacked engine, on the
# per-shard engine, the per-shard engine's cut: None for every shard,
# else the S_DECODE leading shards of phases 4a and 4d)
SQL_KERNELS = {
    SQL_COUNT_AB: (["pair_popcount"], ["popcount_rows"], None),
    SQL_SUM_A: (["bsi_sum_counts"], ["bsi_sum_counts"], None),
    SQL_SUM: (["bsi_sum_counts"], ["bsi_sum_counts"], None),
    SQL_GE64: (["bsi_range", "popcount_rows"], ["bsi_range"], None),
    SQL_BETWEEN: (["bsi_range", "popcount_rows"], ["bsi_range"], None),
    SQL_ABLE: (["groupby_fused"], ["popcount_rows", "bsi_sum_counts"], None),
    SQL_TA: (["groupby_sum"], ["popcount_rows", "bsi_sum_counts"], None),
    SQL_MINMAX: (["groupby_fused", "bsi_sum_counts"],
                 ["popcount_rows", "bsi_sum_counts"], S_DECODE),
    # the per-shard BSI Distinct is a host decode (phase 4a)
    SQL_DISTINCT: (["groupby_fused"], [], S_DECODE),
    SQL_PERCENTILE: (["groupby_fused", "bsi_range"],
                     ["popcount_rows", "bsi_range"], S_DECODE),
    SQL_ORDER: (["bsi_range"], ["bsi_range"], S_DECODE),
    SQL_LIMIT: (["popcount_rows"], ["popcount_rows"], S_DECODE),
    SQL_KCOUNT: (["popcount_rows"], ["popcount_rows"], None),
    SQL_KGROUP: (["groupby_fused"], ["popcount_rows"], None),
}
# the statements the INSERTs must leave exact, on both engines
SQL_AFTER_INSERT = [SQL_SUM, SQL_SUM_A, SQL_GE64, SQL_BETWEEN, SQL_MINMAX]


def age_hists(data, shards):
    """age's per-value column counts over the listed shards, from the
    mirror: over every column holding a value, and under a."""
    import numpy as np
    h_any = np.zeros(1 << DEPTH, np.int64)
    h_a = np.zeros(1 << DEPTH, np.int64)
    for s in shards:
        v = age_values(data, s)
        ex = unpack(data["age_exists"][s]).astype(bool)
        a = unpack(data["a"][s]).astype(bool)
        h_any += np.bincount(v[ex], minlength=1 << DEPTH)
        h_a += np.bincount(v[ex & a], minlength=1 << DEPTH)
    return h_any, h_a


def bsi_sql_answers(h_any, h_a) -> dict:
    """The SUM, range, MIN/MAX/AVG, DISTINCT and PERCENTILE statements'
    rows from age's value histograms (every column, under a)."""
    from decimal import ROUND_HALF_EVEN, Decimal

    import numpy as np
    vals = np.arange(1 << DEPTH, dtype=np.int64)
    nz_a = np.nonzero(h_a)[0]
    sum_a, n_a = int((h_a * vals).sum()), int(h_a.sum())
    avg = (Decimal(sum_a) / n_a).quantize(Decimal("0.0001"),
                                          rounding=ROUND_HALF_EVEN)
    pct = percentile_ref(h_any, 50)
    return {
        SQL_SUM: [(int((h_any * vals).sum()),)],
        SQL_SUM_A: [(sum_a,)],
        SQL_GE64: [(int(h_any[64:].sum()),)],
        SQL_BETWEEN: [(int(h_any[10:101].sum()),)],
        SQL_MINMAX: [(int(nz_a[0]), int(nz_a[-1]), avg)],
        SQL_DISTINCT: [(int(v),) for v in np.nonzero(h_any)[0]],
        SQL_PERCENTILE: [(pct[0] if pct else None,)],
    }


def sql_answers(data, post, keyed) -> tuple[dict, dict]:
    """Phase 5c's rows from numpy: every shard (the stacked engine) and
    the per-shard engine's cut (the S_DECODE leading shards where
    SQL_KERNELS says so)."""
    want = post["want"]
    h_any, h_a = post["ages"]
    full = bsi_sql_answers(h_any, h_a)
    if full[SQL_SUM] != [(want["Sum(field=age)"][0],)] or \
            full[SQL_SUM_A] != [(want["Sum(Row(a=1), field=age)"][0],)] or \
            full[SQL_GE64] != [(want["Count(Row(age >= 64))"],)]:
        raise AssertionError("sql: the value histograms disagree with 5a's")
    order = {}
    for n in (S, S_DECODE):
        cols, vals = sort_ref(data, n, True, 0, 100)
        if min(vals) <= 120:
            raise AssertionError("sql: fewer than 100 columns of a over 120")
        order[n] = list(zip(cols, vals))
    first = limit_ref(data, S, 10, 0)
    ages = [sum(bit(data["age"][p], c) << p for p in range(DEPTH))
            if bit(data["age_exists"], c) else None for c in first]
    ta = want["GroupBy(Rows(t), Rows(a), aggregate=Sum(field=age))"]
    full.update({
        SQL_COUNT_AB: [(want["Count(Intersect(Row(a=1), Row(b=1)))"],)],
        SQL_ABLE: [([e], [g], [d], s) for (e, g, d), _n, s, nv in
                   want[ABLE_SUM] if nv],
        SQL_TA: [([r], [a], s) for (r, a), _n, s, nv in ta if nv],
        SQL_ORDER: order[S],
        SQL_LIMIT: list(zip(first, ages)),
        SQL_KCOUNT: [(keyed["want"]['Count(Row(kf="k17"))'],)],
        SQL_KGROUP: kgroup_rows(keyed),
    })
    cut = dict(full)
    cut.update({q: r for q, r in bsi_sql_answers(
        *age_hists(data, range(S_DECODE))).items()
        if SQL_KERNELS[q][2] is not None})
    cut[SQL_ORDER] = order[S_DECODE]
    return full, cut


def kgroup_rows(keyed) -> list:
    """SQL_KGROUP's rows from the keyed mirror."""
    return [([k], n) for k, n in keyed["kf_counts"].items() if n]


def sql_cells_ok(rows) -> bool:
    """Every cell a plain Python value (never a tensor or a numpy
    scalar); a set cell a list of them."""
    from decimal import Decimal
    plain = (int, float, Decimal, str, bool, type(None))
    return all(isinstance(c, plain) or (isinstance(c, list) and all(
        isinstance(x, plain) for x in c)) for r in rows for c in r)


def run_sql(eng, label: str, want: dict, reps: int) -> dict:
    """Each statement cold and then reps times warm through
    SQLEngine.query, held exactly to its rows; prints the first call,
    the warm p50, the parse time (parse_sql alone, host) and the plan
    time (SQL_PLAN_COST's mean over the runs, host).  Returns statement
    -> (first ms, warm p50 ms, parse µs, plan ms)."""
    import torch
    from pilosa_tpu_torch.obs import metrics
    from pilosa_tpu_torch.sql.parser import parse_sql
    out = {}
    for q, expect in want.items():
        pt = []
        for _ in range(5):
            t0 = time.perf_counter()
            parse_sql(q)
            pt.append(time.perf_counter() - t0)
        c0, s0 = metrics.SQL_PLAN_COST.count(), metrics.SQL_PLAN_COST.sum()
        t0 = time.perf_counter()
        got = eng.query_one(q).rows
        torch.cuda.synchronize()
        cold = (time.perf_counter() - t0) * 1e3
        if got != expect or not sql_cells_ok(got):
            raise AssertionError(f"{label} {q}: port {str(got)[:200]} != "
                                 f"numpy {str(expect)[:200]}")
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            again = eng.query_one(q).rows
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if again != expect:
                raise AssertionError(f"{label} {q}: repeat gave "
                                     f"{str(again)[:200]}")
        n = metrics.SQL_PLAN_COST.count() - c0
        plan = (metrics.SQL_PLAN_COST.sum() - s0) / n if n else float("nan")
        p50 = statistics.median(times) * 1e3 if times else float("nan")
        out[q] = (cold, p50, statistics.median(pt) * 1e6, plan)
        print(f"{label}: {q} = {str(got)[:60]} exact; first {cold:.2f} ms, "
              f"warm p50 {p50:.3f} ms over {reps}; parse "
              f"{out[q][2]:.1f} us, plan {plan:.3f} ms (host)")
    return out


def phase_sql(h, ex, data, post, keyed, note) -> dict:
    """5c: SQL on the card.  The statements of SQL_KERNELS through
    SQLEngine on phase 4's executor (the stacked engine, every shard)
    and on a new per-shard executor (use_stacked = False; the S_DECODE
    leading shards where SQL_KERNELS cuts), each exact against numpy
    from the mirror after 5a, each launching its kernels; EXPLAIN of the
    able GROUP BY shows the pushed GroupBy; API.sql's JSON equals the
    engine's rows.  Then an INSERT of 64 seeded age values, one column
    in each of 64 shards (the 16 leading ones among them): SUM, the
    ranges and MIN/MAX/AVG exact against the mirror updated by put, the
    resident stacks and tiles patched and none rebuilt; a second INSERT
    puts the old values back, and the same statements equal 5a's
    answers again (phase 6a checks the rows)."""
    import json as _json

    import numpy as np
    from pilosa_tpu_torch.api import API, _json_value
    from pilosa_tpu_torch.executor.executor import Executor
    from pilosa_tpu_torch.sql import SQLEngine

    class CutEngine(SQLEngine):
        """SQLEngine whose pushed calls run on the leading shards only
        (the per-shard engine's cut)."""

        def __init__(self, holder, executor, shards):
            super().__init__(holder, executor=executor)
            self.shards = shards

        def run_call(self, idx, call):
            return self.executor._execute_call(idx, call, self.shards)

    t0 = time.perf_counter()
    full, cut = sql_answers(data, post, keyed)
    print(f"sql: numpy reference in {time.perf_counter() - t0:.1f} s "
          f"({card_line()})")
    lp = Executor(h)
    lp.use_stacked = False
    engines = {"stacked": (SQLEngine(h, executor=ex), SQLEngine(h, executor=ex)),
               "per-shard": (SQLEngine(h, executor=lp),
                             CutEngine(h, lp, list(range(S_DECODE))))}
    for name, (whole, part) in engines.items():
        for q, (k_st, k_ps, n_cut) in SQL_KERNELS.items():
            on_cut = name == "per-shard" and n_cut is not None
            label = f"sql {name}" + (f" ({n_cut} shards)" if on_cut else "")
            got, _ = launches_of(lambda: run_sql(
                part if on_cut else whole, label,
                {q: (cut if on_cut else full)[q]}, SQL_REPS[name]))
            note(label, got)
            needs = k_st if name == "stacked" else k_ps
            if any(got[k] == 0 for k in needs):
                raise AssertionError(f"{label} {q}: launches {got}, "
                                     f"expected each of {needs}")
    eng = engines["stacked"][0]
    plan = [r[0] for r in eng.query_one("EXPLAIN " + SQL_ABLE).rows]
    print(f"sql: EXPLAIN {SQL_ABLE}: {plan}")
    if not any("PQL GroupBy pushdown" in ln for ln in plan):
        raise AssertionError(f"sql: EXPLAIN shows no pushed GroupBy: {plan}")
    api = API(h)
    for q in (SQL_COUNT_AB, SQL_SUM_A):
        res = eng.query_one(q)
        body = {"schema": {"fields": [{"name": n, "type": t}
                                      for n, t in res.schema]},
                "data": [[_json_value(v) for v in r] for r in res.rows]}
        if _json.dumps(api.sql(q)) != _json.dumps(body):
            raise AssertionError(f"sql: API.sql {q} differs from the engine")
    print(f"sql: API.sql of {SQL_COUNT_AB!r} and {SQL_SUM_A!r} equal the "
          "engine's rows as JSON")
    del api
    # the INSERTs: one seeded column a shard, each holding a value
    rng = np.random.default_rng(SQL_SEED)
    shards = list(range(S_DECODE)) + sorted(rng.choice(
        np.arange(S_DECODE, S), SQL_INSERT_SHARDS - S_DECODE,
        replace=False).tolist())
    cols, old = [], []
    for sh in shards:
        while True:
            c = sh * W * 32 + int(rng.integers(0, W * 32))
            if bit(data["age_exists"], c):
                break
        cols.append(c)
        old.append(sum(bit(data["age"][p], c) << p for p in range(DEPTH)))
    new = [(v + 1 + int(rng.integers(0, (1 << DEPTH) - 1))) % (1 << DEPTH)
           for v in old]
    h_any, h_a = (x.copy() for x in post["ages"])

    def insert(values, label):
        stmt = "INSERT INTO bench (_id, age) VALUES " + ", ".join(
            f"({c}, {v})" for c, v in zip(cols, values))
        t0 = time.perf_counter()
        eng.query(stmt)
        took = (time.perf_counter() - t0) * 1e3
        for c, v in zip(cols, values):
            was = sum(bit(data["age"][p], c) << p for p in range(DEPTH))
            for p in range(DEPTH):
                put(data["age"][p], c, (v >> p) & 1)
            h_any[was] -= 1
            h_any[v] += 1
            if bit(data["a"], c):
                h_a[was] -= 1
                h_a[v] += 1
        print(f"sql: {label}: INSERT of {len(cols)} age values over "
              f"{len(cols)} shards: {took:.3f} ms (host)")

    def after(label):
        want = bsi_sql_answers(h_any, h_a)
        part = bsi_sql_answers(*age_hists(data, range(S_DECODE)))
        for name, (whole, cut_eng), cache in (
                ("stacked", engines["stacked"], ex.stacked.cache),
                ("per-shard", engines["per-shard"], lp.tiles.cache)):
            was = cache.counters()
            for q in SQL_AFTER_INSERT:
                on_cut = name == "per-shard" and SQL_KERNELS[q][2] is not None
                got, _ = launches_of(lambda: run_sql(
                    cut_eng if on_cut else whole, f"sql {name} {label}",
                    {q: (part if on_cut else want)[q]}, 1))
                note(f"sql {name} {label}", got)
            now = cache.counters()
            print(f"sql {name} {label}: patches "
                  f"{now['patches'] - was['patches']}, patched bytes "
                  f"{now['patched_bytes'] - was['patched_bytes']}, rebuilds "
                  f"{now['full_rebuilds'] - was['full_rebuilds']}")
            if now["patches"] == was["patches"] or \
                    now["full_rebuilds"] != was["full_rebuilds"]:
                raise AssertionError(f"sql {name} {label}: the INSERT's "
                                     f"stale stacks were not all patched: "
                                     f"{was} -> {now}")
        return want

    insert(new, "insert")
    after("after the insert")
    insert(old, "restore")
    if after("after the restore") != bsi_sql_answers(*post["ages"]):
        raise AssertionError("sql: the restore did not give 5a's answers")
    print(f"sql: done ({card_line()})")
    return full


# phase 6: restart onto disk (6a) and ingest through the API (6b)
DISK_NEEDED = 12 << 30      # the headline index's ~4.7 GB of WAL, twice
NEW_KEY = "c9999998"        # the column key 6a creates after the reopen
RESTART_KEYED = ['Count(Row(kf="k17"))', 'Row(kf="k17")', "TopN(kf, n=10)"]
INGEST_SEED = 2027
INGEST_RECORDS = 1 << 19    # the Pipeline's datagen records (1 shard)
INGEST_COLS = 1 << 23       # import_columns' columns (8 shards)
INGEST_CHUNK = 1 << 22      # columns a call
REIMPORT = 1 << 20          # columns imported again into resident stacks
INGEST_QUERIES = ["Count(Row(segment=3))", "TopN(segment, n=16)",
                  "Sum(field=amount)", "Count(Row(amount > 500))",
                  "GroupBy(Rows(segment), aggregate=Sum(field=amount))",
                  "Min(field=amount)", "Max(field=amount)",
                  "Count(Row(active=true))"]


class ViaAPI:
    """run_queries' executor that answers through API.query: each
    result in its JSON form."""

    def __init__(self, api):
        self.api = api

    def execute(self, index, query, shards=None):
        return self.api.query(index, query, shards)["results"]


def api_norm(r):
    """An API.query JSON result in normalise's form (a keyed row as
    (columns, keys), keyed pairs as (id, key, count))."""
    if isinstance(r, dict):
        if "keys" in r:
            return (r["columns"], r["keys"])
        if "fields" in r:
            return (r["fields"], [(e["column"], e["rows"])
                                  for e in r["columns"]])
        if "values" in r and "columns" in r:
            return (r["columns"], r["values"])
        if "values" in r:
            return list(r["values"])
        if "value" in r:
            return (r["value"], r["count"])
        return r["columns"]
    if isinstance(r, list) and r and isinstance(r[0], dict):
        if "group" in r[0]:
            return [(tuple(g["row_id"] for g in gc["group"]), gc["count"],
                     gc.get("agg"), gc.get("agg_count")) for gc in r]
        if "key" in r[0]:
            return [(p["id"], p["key"], p["count"]) for p in r]
        return [(p["id"], p["count"]) for p in r]
    return r


def sync_and_close(h, label: str) -> None:
    """Holder.sync timed, the bytes and shard files on disk printed, then
    close."""
    t0 = time.perf_counter()
    h.sync()
    took = time.perf_counter() - t0
    nbytes = sum(idx.storage.disk_bytes() for idx in h.indexes.values())
    files = sum(len(idx.storage.shards_on_disk())
                for idx in h.indexes.values())
    print(f"{label}: sync of {len(h.indexes)} indexes in {took * 1e3:.1f} ms "
          f"(host; WAL fsync per shard commit): {nbytes} bytes in {files} "
          f"shard files ({card_line()})")
    h.close()


def reopen(path: str, label: str):
    from pilosa_tpu_torch.models.holder import Holder
    t0 = time.perf_counter()
    h = Holder(path=path, width=W * 32)
    h.load_schema()
    frags = sum(len(v.fragments) for idx in h.indexes.values()
                for f in idx.fields.values() for v in f.views.values())
    print(f"{label}: reopened with load_schema in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms (host): "
          f"{len(h.indexes)} indexes, {frags} fragments ({card_line()})")
    return h


def check_rows(h, data, deleted) -> None:
    """Every fragment's row words of a, b, s, t, the categories and the
    age planes, off disk, equal the numpy mirror after phase 5a."""
    import numpy as np
    from pilosa_tpu_torch.models.view import VIEW_STANDARD
    t0 = time.perf_counter()
    idx = h.index("bench")
    gone = np.zeros((S, W), np.uint32)
    for c in deleted:
        put(gone, c, True)
    zeros = np.zeros(W, np.uint32)

    def rows():
        for name in ("a", "b", "s"):
            yield name, VIEW_STANDARD, 1, data[name]
        for r in range(R):
            yield "t", VIEW_STANDARD, r, data["t"][r]
        for name, n in CATEGORIES.items():
            planes = data[name]
            for r in range(n):
                acc = ~gone
                for b in range(planes.shape[0]):
                    acc = acc & (planes[b] if (r >> b) & 1 else ~planes[b])
                yield name, VIEW_STANDARD, r, acc
        yield "age", "bsig_age", 0, data["age_exists"]
        yield "age", "bsig_age", 1, None
        for p in range(DEPTH):
            yield "age", "bsig_age", 2 + p, data["age"][p]

    n = 0
    for fname, vname, row, words in rows():
        view = idx.field(fname).views[vname]
        for shard in range(S):
            frag = view.fragment(shard)
            got = frag.row_words(row) if frag is not None else zeros
            want = zeros if words is None else words[shard]
            if not np.array_equal(got, want):
                raise AssertionError(f"restart: {fname}/{vname} shard {shard}"
                                     f" row {row} differs from the mirror")
        n += 1
    print(f"restart: {n} rows x {S} shards off disk equal the numpy mirror "
          f"({(time.perf_counter() - t0):.1f} s, host)")


def phase_restart(path, data, post, keyed, sql_want, before, note):
    """6a: reopen the synced headline holder, check its rows against the
    mirror, then phase 4's stacked set and phase 4a's per-shard
    TopN/Count set on new APIs through API.query, exact against the
    answers after phase 5a, each first call (stacks built from rows that
    came off disk) and warm p50 printed beside phase 4's; the keyed
    index's answers equal those before the restart, and a new column key
    gets the next id; that Set is mirrored into keyed and sql_want.
    Returns the reopened holder, open, for phase 8."""
    from pilosa_tpu_torch.api import API
    h = reopen(path, "restart")
    check_rows(h, data, post["deleted"])
    for engine, want, use_stacked in (("stacked", post["want"], True),
                                      ("per-shard", post["loop_want"], False)):
        label = f"restart {engine}"
        api = API(h)
        api.executor.use_stacked = use_stacked
        firsts: dict = {}
        launches, p50 = launches_of(lambda: run_queries(
            ViaAPI(api), label, want, 3, norm=api_norm, firsts=firsts))
        note(label, launches)
        firsts4, p50_4 = before[engine]
        for q in want:
            print(f"{label}: {q}: first call from disk {firsts[q]:.3f} ms "
                  f"(phase 4's first {firsts4.get(q, float('nan')):.3f} ms), "
                  f"warm p50 {p50[q]:.3f} ms (phase 4's "
                  f"{p50_4.get(q, float('nan')):.3f} ms) ({card_line()})")
        print(f"{label}: cache {api.executor.stacked.cache.counters() if use_stacked else api.executor.tiles.cache.counters()}")
        del api
    api = API(h)
    launches, _ = launches_of(lambda: run_queries(
        ViaAPI(api), "restart keys", keyed["want"], 3, index="kidx",
        norm=api_norm))
    note("restart keys", launches)
    api.query("kidx", f'Set("{NEW_KEY}", kf="k03")')
    got = api.translate_keys("kidx", None, [NEW_KEY])[0]
    if got != keyed["next_id"] or got in keyed["taken"]:
        raise AssertionError(f"restart: the new key {NEW_KEY} got id {got}, "
                             f"expected {keyed['next_id']}")
    cnt = api.query("kidx", f'Count(Intersect(Row(kf="k03"), '
                            f'ConstRow(columns=["{NEW_KEY}"])))')["results"]
    if cnt != [1]:
        raise AssertionError(f"restart: Set of {NEW_KEY} reads back {cnt}")
    print(f"restart keys: Set of the new column key {NEW_KEY} after the "
          f"reopen got id {got}, the partition's next (not 0)")
    keyed["kf_counts"]["k03"] += 1
    sql_want[SQL_KGROUP] = kgroup_rows(keyed)
    return h


def ingest_answers(seg, amount, active) -> dict:
    """INGEST_QUERIES' answers from per-column numpy state: seg a bit
    mask of segment rows, amount and active the values (every column
    holds one of each)."""
    import numpy as np
    counts, sums = [], []
    for r in range(16):
        sel = (seg >> np.uint16(r)) & 1 == 1
        counts.append(int(sel.sum()))
        sums.append(int(amount[sel].sum(dtype=np.int64)))
    lo, hi = int(amount.min()), int(amount.max())
    top = sorted(((-c, r) for r, c in enumerate(counts) if c))
    return {
        "Count(Row(segment=3))": counts[3],
        "TopN(segment, n=16)": [(r, -c) for c, r in top],
        "Sum(field=amount)": (int(amount.sum(dtype=np.int64)), amount.size),
        "Count(Row(amount > 500))": int((amount > 500).sum()),
        "GroupBy(Rows(segment), aggregate=Sum(field=amount))": [
            ((r,), counts[r], sums[r], counts[r]) for r in range(16)
            if counts[r]],
        "Min(field=amount)": (lo, int((amount == lo).sum())),
        "Max(field=amount)": (hi, int((amount == hi).sum())),
        "Count(Row(active=true))": int(active.sum(dtype=np.int64)),
    }


def phase_ingest(path, note) -> None:
    """6b: a fresh path-backed holder through the API: the Pipeline of
    INGEST_RECORDS datagen records on 4 workers (index dg), and
    import_columns of INGEST_COLS seeded columns over 8 shards in
    chunks of INGEST_CHUNK (index cols); INGEST_QUERIES on both, exact
    against numpy from the same generators; REIMPORT columns imported
    again into the resident stacks and the first query after it exact,
    the cache's patches and rebuilds by reason printed; then sync,
    reopen and the same answers again."""
    import numpy as np
    import torch
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.ingest import APIImporter, DatagenSource, Pipeline
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.storage import native_ingest as ni

    api = API(Holder(path=path, width=W * 32))
    t0 = time.perf_counter()
    n = Pipeline(DatagenSource(INGEST_RECORDS, seed=INGEST_SEED),
                 APIImporter(api), "dg", concurrency=4).run()
    took = time.perf_counter() - t0
    print(f"ingest: Pipeline of {n} datagen records, 4 workers, batches of "
          f"65536 synced after each: {took:.1f} s, {n / took:.0f} records/s "
          f"(host) ({card_line()})")
    seg = np.zeros(INGEST_RECORDS, np.uint16)
    amount = np.zeros(INGEST_RECORDS, np.int64)
    active = np.zeros(INGEST_RECORDS, np.int64)
    for i, rec in enumerate(DatagenSource(INGEST_RECORDS, seed=INGEST_SEED)):
        v = rec.values
        seg[i], amount[i], active[i] = 1 << v["segment"], v["amount"], \
            v["active"]
    wants = {"dg": ingest_answers(seg, amount, active)}

    api.apply_schema({"indexes": [{"name": "cols", "fields": [
        {"name": "segment", "options": {"type": "set"}},
        {"name": "amount", "options": {"type": "int", "min": 0, "max": 999}},
        {"name": "active", "options": {"type": "bool"}}]}]})
    rng = np.random.default_rng(INGEST_SEED)
    seg = np.zeros(INGEST_COLS, np.uint16)
    amount = np.zeros(INGEST_COLS, np.int64)
    active = np.zeros(INGEST_COLS, np.int64)
    took = 0.0
    # 13d: the fills of storage/csrc/scatter.cc, each call counted
    fills = {"or_bits": 0, "bsi_fill": 0, "mutex_fill": 0}
    real = {k: getattr(ni, k) for k in fills}

    def counted(name):
        def wrap(*a, **kw):
            fills[name] += 1
            return real[name](*a, **kw)
        return wrap
    for k in fills:
        setattr(ni, k, counted(k))
    try:
        for lo in range(0, INGEST_COLS, INGEST_CHUNK):
            hi = lo + INGEST_CHUNK
            sg = rng.integers(0, 16, INGEST_CHUNK)
            am = rng.integers(0, 1000, INGEST_CHUNK)
            ac = rng.integers(0, 2, INGEST_CHUNK)
            cols = np.arange(lo, hi, dtype=np.int64)
            t0 = time.perf_counter()
            api.import_columns("cols", cols,
                               bits={"segment": sg, "active": ac},
                               values={"amount": am})
            took += time.perf_counter() - t0
            seg[lo:hi], amount[lo:hi], active[lo:hi] = 1 << sg, am, ac
    finally:
        for k, f in real.items():
            setattr(ni, k, f)
    if not all(fills.values()):
        raise AssertionError(f"13d: a C++ fill never ran: {fills}")
    print(f"ingest: import_columns of {INGEST_COLS} columns x 3 fields in "
          f"{INGEST_COLS // INGEST_CHUNK} calls: {took:.1f} s, "
          f"{INGEST_COLS / took:.0f} columns/s (host) ({card_line()})")
    print(f"13d: those calls went through the C++ scatters {fills}; the "
          f"numpy import they replaced ran at 2.1-3.1 M columns/s on an "
          f"H100 host")
    wants["cols"] = ingest_answers(seg, amount, active)

    def query_all(api, label, reps=3):
        for index, want in wants.items():
            launches, _ = launches_of(lambda: run_queries(
                ViaAPI(api), f"{label} {index}", want, reps, index=index,
                norm=api_norm))
            note(f"{label} {index}", launches)

    query_all(api, "ingest")
    # again into the resident stacks: a seeded spread over all 8 shards
    cache = api.executor.stacked.cache
    was = cache.counters()
    cols = np.sort(rng.choice(INGEST_COLS, REIMPORT, replace=False))
    sg = rng.integers(0, 16, REIMPORT)
    am = rng.integers(0, 1000, REIMPORT)
    ac = rng.integers(0, 2, REIMPORT)
    t0 = time.perf_counter()
    api.import_columns("cols", cols, bits={"segment": sg, "active": ac},
                       values={"amount": am})
    print(f"ingest: {REIMPORT} columns imported again over "
          f"{INGEST_COLS // (W * 32)} shards in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms (host)")
    seg[cols] |= (1 << sg).astype(np.uint16)
    amount[cols], active[cols] = am, ac
    wants["cols"] = ingest_answers(seg, amount, active)
    del seg, amount, active
    firsts: dict = {}
    launches, _ = launches_of(lambda: run_queries(
        ViaAPI(api), "ingest after import", wants["cols"], 3, index="cols",
        norm=api_norm, firsts=firsts))
    note("ingest after import", launches)
    now = cache.counters()
    rebuilds = {k: v - was["rebuilds"].get(k, 0)
                for k, v in now["rebuilds"].items()
                if v != was["rebuilds"].get(k, 0)}
    print(f"ingest after import: first query {INGEST_QUERIES[0]} "
          f"{firsts[INGEST_QUERIES[0]]:.3f} ms; patches "
          f"{now['patches'] - was['patches']} ({now['patched_bytes'] - was['patched_bytes']}"
          f" bytes), adopts {now['adopts'] - was['adopts']}, rebuilds by "
          f"reason {rebuilds} ({now['rebuilt_bytes'] - was['rebuilt_bytes']}"
          f" bytes)")
    if now["patches"] == was["patches"] and not rebuilds:
        raise AssertionError("ingest: the import left every stack as it was")
    h = api.holder
    sync_and_close(h, "ingest")
    del api, h, cache
    torch.cuda.empty_cache()
    h = reopen(path, "ingest")
    query_all(API(h), "ingest reopened")
    h.close()


# ---------------------------------------------------------------------------
# phase 7: a rolling time window over a TIME field at full width
# ---------------------------------------------------------------------------

EV_HOURS = 168              # 2022-06-01 to 2022-06-07, hour by hour
EV_ROWS = 4
EV_COLS = 1 << 13           # seeded columns a (hour, row)
S_TOPN_LOOP = 64            # shards of the per-shard engine's 7a queries
# hours after 2022-06-01T00:00: 7a's window, 2022-06-02T06:00 to
# 2022-06-05T18:00, covers 18 hour + 2 day + 18 hour views
WINDOW_A = (30, 114)
WINDOW_B = (31, 115)        # 7b: rolled by one hour
COVER_LEAVES = 38
EV_SHARDS = 80             # shards of the events index
DF_ROWS = 1 << 22           # 7g: dataframe rows


def ev_time(hours: float):
    import datetime as dt
    return dt.datetime(2022, 6, 1) + dt.timedelta(hours=hours)


def ev_stamp(hours: float) -> str:
    return ev_time(hours).strftime("%Y-%m-%dT%H:%M")


def ev_row(field: str, lo: int, hi: int) -> str:
    return f"Row({field}=1, from='{ev_stamp(lo)}', to='{ev_stamp(hi)}')"


def window_queries(lo: int, hi: int) -> dict:
    """7a's query set over the window [lo, hi): name -> PQL."""
    row = ev_row("ev", lo, hi)
    return {"count": f"Count({row})",
            "intersect": f"Count(Intersect({row}, Row(a=1)))",
            "sum": f"Sum({row}, field=age)",
            "topn": f"TopN(ev, n={EV_ROWS}, from='{ev_stamp(lo)}', "
                    f"to='{ev_stamp(hi)}')"}


def window_answers(ev, a, planes, lo: int, hi: int,
                   n_shards: int = EV_SHARDS) -> dict:
    """numpy answers of window_queries from the (row, column, hour)
    triples, over the first n_shards shards."""
    import numpy as np
    rows, cols, hrs = ev
    inside = (hrs >= lo) & (hrs < hi) & (cols < n_shards * W * 32)
    one = np.unique(cols[inside & (rows == 1)])

    def bit(words, c):
        return (words.reshape(-1)[c >> 5] >> (c & 31).astype(np.uint32)) & 1

    values = sum(bit(planes[p], one).astype(np.int64) << p
                 for p in range(planes.shape[0]))
    counts = [(r, int(np.unique(cols[inside & (rows == r)]).size))
              for r in range(EV_ROWS)]
    top = sorted([c for c in counts if c[1]], key=lambda x: (-x[1], x[0]))
    return {"count": int(one.size), "intersect": int(bit(a, one).sum()),
            "sum": (int(values.sum()), int(one.size)), "topn": top}


def build_events():
    """The events index through the port's model API: ev (TIME, YMDH, 4
    rows) with EV_COLS seeded columns a row an hour over EV_HOURS hours,
    imported with timestamps; ew, the same for one day under
    write-finest; a set field a and the BSI age (depth 7) of random
    words.  Returns the holder, the (rows, cols, hours) triples of ev
    and of ew, a's words and age's planes."""
    import numpy as np
    from pilosa_tpu_torch.models import timeq
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.models.schema import (
        CACHE_TYPE_NONE, FieldOptions, FieldType, TimeQuantum)
    from pilosa_tpu_torch.models.view import VIEW_STANDARD

    rng = np.random.default_rng(23)
    h = Holder(width=W * 32)
    idx = h.create_index("events", track_existence=False)
    times = [ev_time(i) for i in range(EV_HOURS)]

    def load(name: str, hours: int):
        f = idx.create_field(name, FieldOptions(
            type=FieldType.TIME, time_quantum=TimeQuantum("YMDH"),
            cache_type=CACHE_TYPE_NONE))
        hrs = np.repeat(np.arange(hours), EV_ROWS * EV_COLS)
        rows = np.tile(np.repeat(np.arange(EV_ROWS), EV_COLS), hours)
        cols = rng.integers(0, EV_SHARDS * W * 32, size=hrs.size)
        f.import_bits(rows, cols, [times[i] for i in hrs.tolist()])
        return rows, cols, hrs

    ev = load("ev", EV_HOURS)
    timeq.configure(write_finest=True)
    try:
        ew = load("ew", 24)
    finally:
        timeq.configure(write_finest=False)
    views = sorted(idx.field("ew").views)
    if len(views) != 25 or views[0] != VIEW_STANDARD:
        raise AssertionError(f"ew under write-finest holds {views}")
    a_words = rng.integers(0, 1 << 32, size=(EV_SHARDS, W), dtype=np.uint32)
    view = idx.create_field("a", FieldOptions(
        cache_type=CACHE_TYPE_NONE)).view(VIEW_STANDARD, create=True)
    for shard in range(EV_SHARDS):
        view.fragment(shard, create=True).import_row_words(1, a_words[shard])
    age = idx.create_field("age", FieldOptions(type=FieldType.INT,
                                               min=0, max=127))
    aview = age.view(age.bsi_view, create=True)
    planes = rng.integers(0, 1 << 32, size=(DEPTH, EV_SHARDS, W),
                          dtype=np.uint32)
    full = np.full(W, 0xFFFFFFFF, dtype=np.uint32)
    for shard in range(EV_SHARDS):
        frag = aview.fragment(shard, create=True)
        frag.import_row_words(0, full)
        for p in range(DEPTH):
            frag.import_row_words(2 + p, planes[p, shard])
    return h, ev, ew, a_words, planes


def cache_delta(ex, before: dict) -> dict:
    after = ex.stacked.cache.counters()
    out = {k: after[k] - before[k] for k in after if k != "rebuilds"}
    out["rebuilds"] = {k: v - before["rebuilds"].get(k, 0)
                       for k, v in after["rebuilds"].items()
                       if v != before["rebuilds"].get(k, 0)}
    return out


def timed_call(ex, q: str, want, label: str):
    """One call of q through Executor.execute, exact; its ms."""
    import torch
    t0 = time.perf_counter()
    got = normalise(ex.execute("events", q)[0])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if got != want:
        raise AssertionError(f"{label} {q}: port {got} != numpy {want}")
    return ms


def span_summary(spans: list, depth: int = 0) -> list:
    """Profile span dicts as indented 'name duration' lines, the
    stacked.stack spans of a parent folded into one line."""
    out = []
    stacks = [sp for sp in spans if sp["name"] == "stacked.stack"]
    for sp in spans:
        if sp["name"] == "stacked.stack":
            continue
        out.append(f"{'  ' * depth}{sp['name']} {sp['duration_us'] / 1e3:.3f} ms")
        out += span_summary(sp.get("children", []), depth + 1)
    if stacks:
        outcomes = Counter(sp["tags"]["outcome"] for sp in stacks)
        out.append(f"{'  ' * depth}stacked.stack x{len(stacks)} "
                   f"{dict(outcomes)} "
                   f"{sum(sp['duration_us'] for sp in stacks) / 1e3:.3f} ms")
    return out


def span_names(spans: list) -> Counter:
    c = Counter()
    for sp in spans:
        c[sp["name"]] += 1
        c.update(span_names(sp.get("children", [])))
    return c


def stack_metric() -> dict:
    from pilosa_tpu_torch.obs import metrics
    return {o: metrics.STACK_CACHE.value(outcome=o)
            for o in ("hit", "miss", "patch", "rebuild")}


def check_stack_metric(before: dict, counters: dict, label: str) -> None:
    """pilosa_stack_cache_total's outcomes since `before` against one
    StackCache's counters (made after `before`, the only cache touched)."""
    got = {k: v - before[k] for k, v in stack_metric().items()}
    want = {"hit": counters["hits"],
            "miss": counters["adopts"] + counters["patches"]
            + counters["full_rebuilds"],
            "patch": counters["patches"] + counters["adopts"],
            "rebuild": counters["full_rebuilds"]}
    if got != want:
        raise AssertionError(f"{label}: stack metric {got} != counters {want}")
    print(f"{label}: pilosa_stack_cache_total {got} equals "
          f"StackCache.counters()")


def phase_time_window(device, note) -> None:
    """Phase 7 (see the module docstring); run order 7a, 7b, 7c, 7d, 7f,
    7e, 7g, so that 7f profiles 7a's query over all its 38 views before
    the TTL sweep of 7e removes some of them."""
    import gc

    import numpy as np
    import torch
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.executor.executor import Executor
    from pilosa_tpu_torch.models import timeq
    from pilosa_tpu_torch.obs import faults, flight, metrics

    torch.cuda.reset_peak_memory_stats(device)
    print(f"time: device memory allocated "
          f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB before")
    t0 = time.perf_counter()
    h, ev, ew, a_words, planes = build_events()
    f_ev = h.index("events").field("ev")
    print(f"time: events built on the host in {time.perf_counter() - t0:.1f} s:"
          f" ev {ev[0].size} bits in {len(f_ev.views)} views, ew "
          f"{ew[0].size} bits under write-finest in "
          f"{len(h.index('events').field('ew').views)} views")
    card = card_line()
    ex = Executor(h)
    lp = Executor(h)
    lp.use_stacked = False
    run_launches: dict = {}

    def run(fn):
        got, out = launches_of(fn)
        for k, n in got.items():
            run_launches[k] = run_launches.get(k, 0) + n
        return out

    # 7a: the cover
    qa = window_queries(*WINDOW_A)
    wa = window_answers(ev, a_words, planes, *WINDOW_A)
    c0, q0 = ex.stacked.cache.counters(), metrics.TIMEQ_QCOVER_TOTAL.value()
    firsts: dict = {}
    p50 = run(lambda: run_queries(ex, "7a qcover", {qa["count"]: wa["count"]},
                                  5, index="events", firsts=firsts))
    d = cache_delta(ex, c0)
    qc = metrics.TIMEQ_QCOVER_TOTAL.value() - q0
    if d["full_rebuilds"] != COVER_LEAVES or d["rebuilds"] != {
            "cold": COVER_LEAVES} or qc != 6:
        raise AssertionError(f"7a: cover built {d}, qcover ops {qc}")
    cover_bytes = COVER_LEAVES * EV_SHARDS * W * 4
    print(f"7a: device memory allocated "
          f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB")
    print(f"7a: {COVER_LEAVES} single-view leaves built "
          f"(StackCache {d}), TIMEQ_QCOVER_TOTAL +{qc:g} over 6 calls, "
          f"cover {cover_bytes} bytes on the card; first "
          f"{firsts[qa['count']]:.2f} ms, warm p50 {p50[qa['count']]:.3f} ms"
          f" ({card})")
    timeq.configure(qcover=False)
    try:
        c0, off_firsts = ex.stacked.cache.counters(), {}
        off = run(lambda: run_queries(ex, "7a one leaf",
                                      {qa["count"]: wa["count"]}, 5,
                                      index="events", firsts=off_firsts))
        d = cache_delta(ex, c0)
        if d["full_rebuilds"] != 1:
            raise AssertionError(f"7a qcover off: built {d}")
    finally:
        timeq.configure(qcover=True)
    print(f"7a: qcover {firsts[qa['count']]:.2f} ms first, "
          f"{p50[qa['count']]:.3f} ms warm p50; one multi-view leaf "
          f"(qcover off) {off_firsts[qa['count']]:.2f} ms first, "
          f"{off[qa['count']]:.3f} ms warm p50 ({card})")
    # the eager union of 38 leaves: 37 ORs, each reading two stacks and
    # writing one; a fused union-and-count reads each leaf once
    eager = 3 * (COVER_LEAVES - 1) * EV_SHARDS * W * 4
    print(f"7a: eager union moves {eager} bytes; a fused pass would read "
          f"{cover_bytes} bytes, {cover_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms "
          f"at {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    rest = {qa[k]: (list(wa[k]) if k == "topn" else wa[k])
            for k in ("intersect", "sum", "topn")}
    run(lambda: run_queries(ex, "7a stacked", rest, 3, index="events"))
    sub = list(range(S_TOPN_LOOP))
    wsub = window_answers(ev, a_words, planes, *WINDOW_A,
                          n_shards=S_TOPN_LOOP)
    run(lambda: run_queries(lp, f"7a per-shard ({S_TOPN_LOOP} shards)",
                            {qa[k]: wsub[k] for k in qa}, 1, shards=sub,
                            index="events"))

    # 7b: the window rolls by one hour
    qb = window_queries(*WINDOW_B)["count"]
    wb = window_answers(ev, a_words, planes, *WINDOW_B)["count"]
    c0, bfirst = ex.stacked.cache.counters(), {}
    bp50 = run(lambda: run_queries(ex, "7b qcover", {qb: wb}, 5,
                                   index="events", firsts=bfirst))
    d = cache_delta(ex, c0)
    if d["full_rebuilds"] != 1:
        raise AssertionError(f"7b: the rolled window built {d}")
    timeq.configure(qcover=False)
    try:
        c0, bofirst = ex.stacked.cache.counters(), {}
        bop50 = run(lambda: run_queries(ex, "7b one leaf", {qb: wb}, 5,
                                        index="events", firsts=bofirst))
        doff = cache_delta(ex, c0)
    finally:
        timeq.configure(qcover=True)
    print(f"7b: the rolled window built {d['full_rebuilds']} leaf "
          f"({d['rebuilt_bytes']} bytes) under qcover, first {bfirst[qb]:.2f} ms"
          f", warm p50 {bp50[qb]:.3f} ms; qcover off restacked its one "
          f"leaf ({doff['rebuilt_bytes']} bytes), first {bofirst[qb]:.2f} ms, "
          f"warm p50 {bop50[qb]:.3f} ms ({card})")

    # 7c: a write at the live edge
    rows, cols, hrs = ev
    have = set(cols[(rows == 1) & (hrs >= WINDOW_B[0])
                    & (hrs < WINDOW_B[1])].tolist())
    col = next(c for c in range(EV_SHARDS * W * 32 // 3, EV_SHARDS * W * 32)
               if c not in have)
    ex.execute("events", f"Set({col}, ev=1, {ev_stamp(WINDOW_B[1] - 0.5)})")
    ev = (np.append(rows, 1), np.append(cols, col),
          np.append(hrs, WINDOW_B[1] - 1))
    c0 = ex.stacked.cache.counters()
    ms = run(lambda: timed_call(ex, qb, wb + 1, "7c"))
    d = cache_delta(ex, c0)
    if d["patches"] != 1 or d["full_rebuilds"] or d["adopts"]:
        raise AssertionError(f"7c: the live-edge write gave {d}")
    print(f"7c: Set at {ev_stamp(WINDOW_B[1] - 0.5)} then Count {wb + 1} "
          f"exact in {ms:.2f} ms: {d['patches']} patch "
          f"({d['patched_bytes']} bytes), no build ({card})")

    # 7d: write-finest and rollup
    qd = f"Count({ev_row('ew', 0, 24)})"
    ew_rows, ew_cols, _ = ew
    wd = int(np.unique(ew_cols[ew_rows == 1]).size)
    c0 = ex.stacked.cache.counters()
    ms = run(lambda: timed_call(ex, qd, wd, "7d"))
    d = cache_delta(ex, c0)
    if d["full_rebuilds"] != 24:
        raise AssertionError(f"7d: the unrolled day built {d}")
    print(f"7d: {qd} = {wd} exact from 24 hour leaves in {ms:.2f} ms")
    t0 = time.perf_counter()
    folded = h.rollup_views(now=ev_time(24))
    roll_s = time.perf_counter() - t0
    day, month = "standard_20220601", "standard_202206"
    want_folds = [("events", f, f"standard_20220601{i:02d}", day)
                  for f in ("ev", "ew") for i in range(24)]
    want_folds = [t for f in ("ev", "ew") for t in
                  [x for x in want_folds if x[1] == f]
                  + [("events", f, day, month)]]
    if folded != want_folds:
        raise AssertionError(f"7d: rollup folded {folded[:4]}...")
    c0, q0 = ex.stacked.cache.counters(), metrics.TIMEQ_QCOVER_TOTAL.value()
    ms2 = run(lambda: timed_call(ex, qd, wd, "7d rolled"))
    d = cache_delta(ex, c0)
    if d["full_rebuilds"] != 1 or metrics.TIMEQ_QCOVER_TOTAL.value() != q0:
        raise AssertionError(f"7d: after rollup built {d}")
    print(f"7d: rollup_views folded {len(folded)} views in "
          f"{roll_s * 1e3:.1f} ms (host); then {qd} = {wd} from one day "
          f"leaf in {ms2:.2f} ms ({card})")

    # 7f: obs on the card (before 7e, so 7a's cover is whole)
    api = API(h)
    prof = {}
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        resp = api.query("events", qa["count"], profile=True)
        prof[label] = (time.perf_counter() - t0, resp)
        if resp["results"] != [wa["count"]]:
            raise AssertionError(f"7f {label}: {resp['results']}")
        print(f"7f: profile, {label} ({prof[label][0] * 1e3:.2f} ms):")
        for line in span_summary(resp["profile"]):
            print(f"7f:   {line}")
    names = span_names(prof["cold"][1]["profile"])
    if (names["stacked.stack"] != COVER_LEAVES
            or span_names(prof["warm"][1]["profile"])["stacked.stack"]
            or any(names[n] != 1 for n in (
                "executor.Execute", "executor.executeCount",
                "stacked.plan_build", "stacked.dispatch"))):
        raise AssertionError(f"7f: span names {dict(names)}")
    rec = flight.recorder.recent(1)[0]
    if rec["route"] != "solo" or rec["index"] != "events":
        raise AssertionError(f"7f: flight record {rec}")
    print(f"7f: newest flight record route {rec['route']}, stack "
          f"{rec['stack']}, phases {rec['phases']}")
    del api
    before = stack_metric()
    api = API(h)
    api.long_query_time = prof["cold"][0] / 2
    api.query("events", qa["count"])
    logged = api.long_queries()
    if not logged or logged[0]["query"] != qa["count"] or \
            span_names(logged[0]["spans"])["stacked.stack"] != COVER_LEAVES:
        raise AssertionError(f"7f: long-query log {str(logged)[:200]}")
    print(f"7f: long-query log holds the cold call "
          f"({logged[0]['runtime_ns'] / 1e6:.2f} ms > "
          f"{api.long_query_time * 1e3:.2f} ms) with its spans")
    check_stack_metric(before, api.executor.stacked.cache.counters(), "7f")
    faults.inject("device-patch", times=1)
    try:
        have = set(ev[1][(ev[0] == 1) & (ev[2] >= WINDOW_A[0])
                         & (ev[2] < WINDOW_A[1])].tolist())
        col2 = next(c for c in range(2 * EV_SHARDS * W * 32 // 3,
                                     EV_SHARDS * W * 32)
                    if c not in have)
        api.query("events", f"Set({col2}, ev=1, "
                            f"{ev_stamp(WINDOW_A[1] - 0.5)})")
        ev = (np.append(ev[0], 1), np.append(ev[1], col2),
              np.append(ev[2], WINDOW_A[1] - 1))
        c0 = api.executor.stacked.cache.counters()
        resp = api.query("events", qa["count"])
        d = cache_delta(api.executor, c0)
    finally:
        faults.clear()
    if resp["results"] != [wa["count"] + 1] or d["rebuilds"] != {"fault": 1} \
            or d["patches"]:
        raise AssertionError(f"7f: device-patch gave {resp} {d}")
    check_stack_metric(before, api.executor.stacked.cache.counters(), "7f")
    print(f"7f: device-patch armed: a Set then Count {wa['count'] + 1} exact,"
          f" the faulted patch answered by {d['full_rebuilds']} rebuild "
          f"(reason fault) ({card})")
    print(f"7f: device memory allocated "
          f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB "
          f"(phase 7's peak so far "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB)")
    del api
    gc.collect()

    # 7e: TTL
    f_ev.options.ttl = 4 * 86400
    t0 = time.perf_counter()
    removed = h.remove_expired_views(now=ev_time(EV_HOURS))
    ttl_s = time.perf_counter() - t0
    want_removed = {f"standard_{ev_time(i).strftime('%Y%m%d%H')}"
                    for i in range(71)} | {"standard_20220601",
                                           "standard_20220602"}
    if set(removed) != want_removed or len(removed) != len(want_removed):
        raise AssertionError(f"7e: removed {sorted(removed)[:5]}...")
    cover = f_ev.views_for_range(ev_stamp(WINDOW_A[0]), ev_stamp(WINDOW_A[1]))
    if set(cover) & want_removed or len(cover) != 20:
        raise AssertionError(f"7e: the cover after TTL is {cover}")
    we = window_answers(ev, a_words, planes, 48, WINDOW_A[1])["count"]
    c0 = ex.stacked.cache.counters()
    ms = run(lambda: timed_call(ex, qa["count"], we, "7e"))
    d = cache_delta(ex, c0)
    if d["full_rebuilds"] or d["hits"] + d["patches"] + d["adopts"] != 20:
        raise AssertionError(f"7e: after TTL {d}")
    lsub = window_answers(ev, a_words, planes, 48, WINDOW_A[1],
                          n_shards=S_TOPN_LOOP)["count"]
    got = run(lambda: lp.execute("events", qa["count"], shards=sub)[0])
    if got != lsub:
        raise AssertionError(f"7e per-shard: {got} != {lsub}")
    print(f"7e: remove_expired_views removed {len(removed)} views in "
          f"{ttl_s * 1e3:.1f} ms (host); 7a's window then counts {we} exact "
          f"from the 20 surviving views in {ms:.2f} ms, none built, "
          f"StackCache {d}; per-shard on {S_TOPN_LOOP} shards {got} exact "
          f"({card})")
    del ex, lp
    gc.collect()
    torch.cuda.empty_cache()

    # 7g: the dataframe
    rng = np.random.default_rng(29)
    ints = rng.integers(0, (1 << 31) + (1 << 28), size=DF_ROWS)
    floats = rng.random(DF_ROWS)
    df = h.index("events").dataframe
    t0 = time.perf_counter()
    step = 1 << 20
    for lo in range(0, DF_ROWS, step):
        df.add_rows([{"_id": i, "i": a, "f": b} for i, a, b in zip(
            range(lo, lo + step), ints[lo:lo + step].tolist(),
            floats[lo:lo + step].tolist())])
    print(f"7g: {DF_ROWS} rows added in {time.perf_counter() - t0:.1f} s "
          "(host)")
    i32, f32 = ints.astype(np.int32), floats.astype(np.float32)
    exact = {("sum", "i"): (int(i32.astype(np.int64).sum()) + (1 << 31))
             % (1 << 32) - (1 << 31),
             ("min", "i"): int(i32.min()), ("max", "i"): int(i32.max()),
             ("count", "i"): DF_ROWS, ("min", "f"): float(f32.min()),
             ("max", "f"): float(f32.max()), ("count", "f"): float(DF_ROWS)}
    close = {("sum", "f"): float(f32.astype(np.float64).sum()),
             ("mean", "f"): float(f32.astype(np.float64).mean()),
             ("mean", "i"): float(i32.astype(np.float64).mean())}
    for (op, c), want in {**exact, **close}.items():
        t0 = time.perf_counter()
        got = df.aggregate(op, c)
        ms = (time.perf_counter() - t0) * 1e3
        ok = (got == want if (op, c) in exact
              else abs(got - want) <= 1e-6 * abs(want))
        if not ok or type(got) is not type(want):
            raise AssertionError(f"7g: aggregate {op} {c} = {got!r}, "
                                 f"numpy {want!r}")
        print(f"7g: aggregate({op}, {c}) = {got!r} "
              f"{'exact' if (op, c) in exact else 'within 1e-6'} in "
              f"{ms:.1f} ms (the column's host conversion included; "
              f"{card})")
    note("time window", run_launches)
    del h, df
    gc.collect()
    torch.cuda.empty_cache()
    print(f"time: device memory allocated "
          f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB after")


# phase 8: the memory plane on the headline index
MEM_SEED = 2029
SP_ROWS, SP_BITS = 64, 256      # 8c: sp, 256 seeded bits a row a shard
RN_ROWS, RN_RESID = 8, 64       # 8c: rn, a run over an eighth + 64 bits
MEM_ROUNDS = 1
BALLAST_SLACK = 64 << 20        # 8d: device bytes left free beside the ballast
BROAD_TOPN = "TopN(t, n=8)"
HOT_COUNT = "Count(Row(a=1))"
OOM_QUERY = "Count(Intersect(Row(a=1), Row(b=1)))"
COLD_QUERY = "Count(Row(t=3))"  # a key no earlier phase-8 query holds


def add_sparse_fields(h, rng):
    """8c's fields on the headline index: sp (SP_ROWS rows of SP_BITS
    seeded bits a shard, about 2^-12 of the columns) and rn (RN_ROWS
    rows, row r a run of all-ones words over the r-th eighth of every
    shard plus RN_RESID seeded bits outside it).  Returns sp's bit
    offsets a (row, shard), deduplicated, and rn's (RN_ROWS, S, W)
    words."""
    import numpy as np
    from pilosa_tpu_torch.models.schema import CACHE_TYPE_NONE, FieldOptions
    from pilosa_tpu_torch.models.view import VIEW_STANDARD
    idx = h.index("bench")
    bits = W * 32
    sp_cols = rng.integers(0, bits, size=(SP_ROWS, S, SP_BITS))
    sp = idx.create_field("sp", FieldOptions(cache_type=CACHE_TYPE_NONE))
    shard_base = (np.arange(S, dtype=np.int64) * bits)[None, :, None]
    rows = np.repeat(np.arange(SP_ROWS), S * SP_BITS)
    sp.import_bits(rows, (sp_cols + shard_base).reshape(-1))
    rn = idx.create_field("rn", FieldOptions(cache_type=CACHE_TYPE_NONE))
    view = rn.view(VIEW_STANDARD, create=True)
    eighth = W // 8
    rn_words = np.zeros((RN_ROWS, S, W), np.uint32)
    for r in range(RN_ROWS):
        lo = (r % 8) * eighth
        rn_words[r, :, lo:lo + eighth] = 0xFFFFFFFF
        cols = rng.integers(0, bits, size=(S, RN_RESID))
        outside = (cols // 32 < lo) | (cols // 32 >= lo + eighth)
        for s in range(S):
            c = cols[s][outside[s]]
            np.bitwise_or.at(rn_words[r, s], c // 32,
                             np.uint32(1) << (c % 32).astype(np.uint32))
    for s in range(S):
        frag = view.fragment(s, create=True)
        for r in range(RN_ROWS):
            frag.import_row_words(r, rn_words[r, s])
    return [[np.unique(sp_cols[r, s]) for s in range(S)]
            for r in range(SP_ROWS)], rn_words


def sparse_answers(sp, rn_words, a_words) -> dict:
    """8c's numpy reference, from the offsets and words the fields were
    made from and the headline a row after phase 5a."""
    import numpy as np

    def in_a(s, cols):
        return ((a_words[s][cols // 32] >> (cols % 32).astype(np.uint32))
                & 1).astype(bool)

    def top(counts):
        pairs = sorted((-c, r) for r, c in enumerate(counts) if c > 0)
        return [(r, -c) for c, r in pairs][:8]

    counts = [sum(c.size for c in sp[r]) for r in range(SP_ROWS)]
    under_a = [sum(int(in_a(s, sp[r][s]).sum()) for s in range(S))
               for r in range(SP_ROWS)]
    union = sum(np.union1d(sp[1][s], sp[2][s]).size for s in range(S))
    rn_a = [int(np.bitwise_count(rn_words[r] & a_words).sum(dtype=np.int64))
            for r in range(RN_ROWS)]
    return {
        "packed": {"Count(Row(sp=5))": counts[5], "TopN(sp, n=8)": top(counts),
                   "Count(Union(Row(sp=1), Row(sp=2)))": union},
        "expand": {"Count(Intersect(Row(sp=5), Row(a=1)))": under_a[5],
                   "TopN(sp, Row(a=1), n=8)": top(under_a),
                   "Count(Intersect(Row(rn=3), Row(a=1)))": rn_a[3],
                   "Count(Intersect(Row(rn=7), Row(a=1)))": rn_a[7]},
    }


def run_round(ex, want: dict, label: str) -> None:
    """Each query once through Executor.execute, exact."""
    import torch
    for q, expect in want.items():
        got = normalise(ex.execute("bench", q)[0])
        torch.cuda.synchronize()
        if got != expect:
            raise AssertionError(f"{label} {q}: port {str(got)[:200]} != "
                                 f"numpy {str(expect)[:200]}")


def assemble_device_ms(ex, q: str) -> tuple[float, int]:
    """Device ms and launches of assemble_pages in one warm call of q
    (torch.profiler's CUDA activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ex.execute("bench", q)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if "assemble_pages_kernel" in e.key]
    return (sum(e.device_time_total for e in events) / 1e3,
            sum(e.count for e in events))


def phase_memory(h, want: dict, ref: dict, device, note) -> None:
    """Phase 8 (see the module docstring) on the reopened headline holder:
    want is phase 4's stacked set's answers after phase 5a, ref the a
    row's words and COLD_QUERY's answer from the mirror."""
    import gc

    import numpy as np
    import torch
    from pilosa_tpu_torch import memory
    from pilosa_tpu_torch.executor.executor import Executor
    from pilosa_tpu_torch.memory import pressure
    from pilosa_tpu_torch.memory.policy import Prefetcher
    from pilosa_tpu_torch.obs import flight, metrics
    from pilosa_tpu_torch.ops import kernels as K

    led = memory.ledger()
    card = card_line()
    gc.collect()
    torch.cuda.empty_cache()
    try:
        # 8a: a clamped budget
        t0 = time.perf_counter()
        ex = Executor(h)
        cache = ex.stacked.cache
        launches, _ = launches_of(lambda: run_round(ex, want, "8a warm"))
        note("8a warm", launches)
        resident = led.total_bytes
        print(f"8a: phase 4's stacked set warm: the ledger holds {resident} "
              f"bytes (stack cache {cache.nbytes}, {len(cache.keys())} "
              f"entries) of a {led.budget()}-byte budget ({card})")
        memory.configure(budget_bytes=resident // 2)
        launches = dict.fromkeys(K.LAUNCHES, 0)
        for i in range(1, MEM_ROUNDS + 1):
            c0 = cache.counters()
            got, _ = launches_of(lambda: run_round(ex, want, f"8a round {i}"))
            for k, n in got.items():
                launches[k] += n
            c1 = cache.counters()
            again = c1["rebuilt_bytes"] - c0["rebuilt_bytes"]
            print(f"8a round {i} under a {resident // 2}-byte budget: exact; "
                  f"page_rebuilds {c1['page_rebuilds'] - c0['page_rebuilds']},"
                  f" full_rebuilds {c1['full_rebuilds'] - c0['full_rebuilds']},"
                  f" misses {c1['misses'] - c0['misses']}, rebuilt_bytes "
                  f"{again} ({again / resident:.1%} of R); ledger "
                  f"{led.total_bytes} bytes")
            if again >= resident or c1["misses"] == c0["misses"]:
                raise AssertionError(f"8a round {i}: {again} bytes uploaded "
                                     f"again of R = {resident}, misses "
                                     f"{c1['misses'] - c0['misses']}")
            if led.total_bytes > led.budget():
                raise AssertionError("8a: the ledger crossed its budget")
        note("8a rounds", launches)
        want_hot = want[HOT_COUNT]
        run_round(ex, {HOT_COUNT: want_hot}, "8a hot")
        run_round(ex, {BROAD_TOPN: want[BROAD_TOPN]}, "8a broad")
        c0 = cache.counters()
        run_round(ex, {HOT_COUNT: want_hot}, "8a hot again")
        c1 = cache.counters()
        print(f"8a: {HOT_COUNT} after {BROAD_TOPN} (a (8, {S}, {W}) stack): "
              f"hits {c1['hits'] - c0['hits']}, page_rebuilds "
              f"{c1['page_rebuilds'] - c0['page_rebuilds']}, full_rebuilds "
              f"{c1['full_rebuilds'] - c0['full_rebuilds']}")
        if (c1["page_rebuilds"], c1["full_rebuilds"]) != (
                c0["page_rebuilds"], c0["full_rebuilds"]):
            raise AssertionError("8a: the broad TopN evicted the hot pages")
        led.reclaim_frac(0.5, trigger="shrink")
        e0 = metrics.PREFETCH_TOTAL.value(outcome="error")
        w0 = metrics.PREFETCH_TOTAL.value(outcome="warmed")
        warmed = Prefetcher(cache).step()
        errors = metrics.PREFETCH_TOTAL.value(outcome="error") - e0
        print(f"8a: after an eviction of half the ledger, one Prefetcher.step()"
              f" warmed {warmed} keys (pilosa_prefetch_total warmed "
              f"+{metrics.PREFETCH_TOTAL.value(outcome='warmed') - w0:g}, "
              f"error +{errors:g})")
        if warmed < 1 or errors:
            raise AssertionError(f"8a: the prefetcher warmed {warmed} keys "
                                 f"with {errors} errors")
        memory.configure(budget_bytes=0)
        print(f"8a: {time.perf_counter() - t0:.1f} s")

        # 8b: the cost of paging
        t0 = time.perf_counter()
        run_round(ex, want, "8b paged warm")
        K.reset_launches()
        paged = run_queries(ex, "8b paged", want, 5)
        per_query = K.LAUNCHES["assemble_pages"] / (6 * len(want))
        asm = {q: assemble_device_ms(ex, q) for q in want}
        # a fresh entry keeps its kind: drop them so the set is built
        # whole, and again after, so that 8c starts paged
        cache.clear()
        memory.configure(paged=False)
        try:
            whole = run_queries(ex, "8b whole", want, 5)
        finally:
            memory.configure(paged=True)
            cache.clear()
        for q in want:
            ms, n = asm[q]
            print(f"8b: {q}: warm p50 {paged[q]:.3f} ms paged, "
                  f"{whole[q]:.3f} ms whole (configure(paged=False)); "
                  f"assemble_pages {n} launches, {ms:.4f} ms of device time a "
                  f"call ({card})")
        print(f"8b: {per_query:.2f} assemble_pages launches a query on "
              f"average; {time.perf_counter() - t0:.1f} s")

        # 8c: sparse pages
        t0 = time.perf_counter()
        sp, rn_words = add_sparse_fields(h, np.random.default_rng(MEM_SEED))
        sparse = sparse_answers(sp, rn_words, ref["a"])
        del sp
        print(f"8c: fields sp ({SP_ROWS} rows x {SP_BITS} bits a shard) and "
              f"rn ({RN_ROWS} run rows) added in "
              f"{time.perf_counter() - t0:.1f} s (host)")
        for q, expect in sparse["packed"].items():
            run_round(ex, {q: expect}, "8c build")
            got, _ = launches_of(lambda: run_round(ex, {q: expect}, "8c"))
            note(f"8c {q}", got)
            print(f"8c: {q} = {str(expect)[:60]} exact; launches on a warm "
                  f"call { {k: n for k, n in got.items() if n} } (packed "
                  "pages expanded on the card)")
            if not got["assemble_pages"] or not any(
                    n for k, n in got.items() if k != "assemble_pages"):
                raise AssertionError(f"8c {q}: launched {got}, expected "
                                     "assemble_pages and a count kernel")
        flight.recorder.clear()
        launches, _ = launches_of(lambda: run_round(ex, sparse["expand"],
                                                    "8c expand"))
        note("8c", launches)
        if launches["assemble_pages"] == 0:
            raise AssertionError("8c: assemble_pages never launched")
        mix: dict = {}
        for rec in flight.recorder.recent(64):
            for k, n in rec.get("page_mix", {}).items():
                mix[k] = mix.get(k, 0) + n
        print(f"8c: {list(sparse['expand'])} exact, through assemble_pages "
              f"({launches['assemble_pages']} launches); their flight "
              f"records' page_mix {mix}")
        if not mix.get("packed") or not mix.get("run"):
            raise AssertionError(f"8c: page_mix {mix} lacks packed or run")
        for fname in ("sp", "rn"):
            ents = [(k, e) for k, e in cache._entries.items()
                    if k[0] == "rows" and k[2] == fname]
            held = sum(e[2] for _k, e in ents)
            dense = sum(e[1].lanes * W * 4 for _k, e in ents)
            kinds = Counter(encode_kind for _k, e in ents
                            for encode_kind in _page_kinds(e[1]))
            print(f"8c: the ledger holds {held} bytes for {fname} "
                  f"({len(ents)} stacks, pages {dict(kinds)}) against "
                  f"{dense} bytes dense ({held / max(dense, 1):.2%})")
            if not ents or held >= dense:
                raise AssertionError(f"8c: {fname} holds {held} of {dense}")
        print(f"8c: {time.perf_counter() - t0:.1f} s")

        # 8d: the OOM ladder
        t0 = time.perf_counter()
        o0 = {k: metrics.OOM_TOTAL.value(outcome=k)
              for k in ("caught", "retry_ok", "host_fallback", "raised")}
        # each injection on a warm query (its stacks resident, so the
        # dispatch is the first guarded call): the relief sweep of the
        # first can evict pages the second would upload.  On the card the
        # ladder has no host fallback: inject_oom(2) must ride up
        for n in (1, 2):
            run_round(ex, {OOM_QUERY: want[OOM_QUERY]}, "8d warm")
            pressure.inject_oom(n)
            try:
                run_round(ex, {OOM_QUERY: want[OOM_QUERY]},
                          f"8d inject_oom({n})")
            except pressure.InjectedOOM:
                if n == 1:
                    raise
            else:
                if n == 2:
                    raise AssertionError("8d inject_oom(2): the query "
                                         "answered; expected the OOM raised")
        run_round(ex, {OOM_QUERY: want[OOM_QUERY]}, "8d after the raise")
        got = {k: metrics.OOM_TOTAL.value(outcome=k) - v for k, v in o0.items()}
        print(f"8d: inject_oom(1) absorbed by the retry, exact; inject_oom(2) "
              f"raised after the retry, the next call exact; "
              f"pilosa_device_oom_total {got}")
        if got != {"caught": 2, "retry_ok": 1, "host_fallback": 0,
                   "raised": 1}:
            raise AssertionError(f"8d: OOM outcomes {got}")
        run_round(ex, want, "8d refill")
        gc.collect()
        torch.cuda.empty_cache()
        # ballast: chunks until the allocator refuses even 2 MiB (its
        # cached free blocks too), halving a refused size; then the
        # smallest chunks go back, BALLAST_SLACK of them, to its cache
        ballast, size = [], 1 << 30
        while size >= (2 << 20):
            try:
                ballast.append(torch.empty(size, dtype=torch.uint8,
                                           device=device))
            except torch.cuda.OutOfMemoryError:
                size //= 2
        freed = 0
        while ballast and freed < BALLAST_SLACK:
            freed += ballast.pop().numel()
        size = sum(b.numel() for b in ballast)
        left = (torch.cuda.mem_get_info(device)[0]
                + torch.cuda.memory_reserved(device)
                - torch.cuda.memory_allocated(device))
        c0 = metrics.OOM_TOTAL.value(outcome="caught")
        r0 = metrics.OOM_TOTAL.value(outcome="retry_ok")
        held = led.total_bytes
        try:
            run_round(ex, {COLD_QUERY: ref["cold"]}, "8d real OOM")
        finally:
            del ballast
            torch.cuda.empty_cache()
        caught = metrics.OOM_TOTAL.value(outcome="caught") - c0
        retried = metrics.OOM_TOTAL.value(outcome="retry_ok") - r0
        print(f"8d: a {size}-byte ballast left {left} bytes free (the card's "
              f"and the allocator's cache); {COLD_QUERY}"
              f" cold: exact, torch.cuda.OutOfMemoryError caught {caught:g}, "
              f"retry_ok {retried:g}; relief shed the ledger from {held} to "
              f"{led.total_bytes} bytes ({card})")
        if caught < 1 or retried != caught:
            raise AssertionError(f"8d: the real OOM: caught {caught}, "
                                 f"retry_ok {retried}")
        note("8d", dict.fromkeys(K.LAUNCHES, 0))
        print(f"8d: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        for fname in ("sp", "rn"):
            h.index("bench").delete_field(fname)
        print(f"8: fields sp and rn deleted in "
              f"{time.perf_counter() - t0:.1f} s")
    finally:
        memory.configure(budget_bytes=0, paged=True)
        pressure.inject_oom(0)
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3's page-table kernels: concat_gather and segment_count
# ---------------------------------------------------------------------------

def ragged_kernel_cases(device) -> dict:
    """concat_gather out of a bucket of 30 dense 4 MiB pages (a (954,
    32768) row stack as the stack cache pages it): the identity gather
    of 954 lanes, the reversed half (477 lanes) and 3 lanes; and
    segment_count over 1908 lanes of a 60-page bucket in 2 segments (two
    row stacks' point Counts) and over 9b's family shape, ragged segments
    of 954, 477, 1 and 2 lanes.  Each held exactly to its plain version,
    timed with CUDA events beside its plain version, its bound (bytes
    read and written at the card's rate; segment_count's popcounts at
    the __popc rate beside) and, for concat_gather, the library pair
    torch.cat(pages)[lane_idx]."""
    import torch
    from pilosa_tpu_torch.ops import kernels as K

    gen = torch.Generator(device=device)
    gen.manual_seed(20261018)
    pages = [random_words(gen, (PAGE_LANES, W), device) for _ in range(60)]
    half = pages[:30]
    card = card_line()
    popc_rate = popc_per_s()
    out = {}

    def idx(a):
        return torch.tensor(a, dtype=torch.int32, device=device)

    gathers = [
        ("identity, 954 lanes of 30 pages", half, idx(list(range(S)))),
        ("reversed half, 477 lanes of 30 pages", half,
         idx(list(range(S - 1, -1, -2)))),
        ("3 lanes of 30 pages", half, idx([0, 500, S - 1])),
    ]
    for label, bucket, li in gathers:
        table = K.gather_table(bucket)
        n = li.numel()

        def kern():
            return K.concat_gather(bucket, li, table=table)

        def plain():
            return K.concat_gather_plain(bucket, li)
        err = max_abs_err(f"concat_gather {label}", kern(), plain())
        if err:
            raise AssertionError(f"concat_gather {label}: differs from its "
                                 f"plain version, max |err| {err}")
        ms = cuda_ms(kern, reps=50)
        kernel_ms = device_ms(kern, "concat_gather_kernel")
        plain_ms = cuda_ms(plain, reps=20)
        lib_ms = cuda_ms(lambda: torch.cat(bucket)[li.long()], reps=20)
        nbytes = 2 * n * W * 4 + n * 4 + len(bucket) * 8
        bound_ms, bound_by, _tb, _to = bound(nbytes, 0)
        print(f"kernel concat_gather {label}: exact vs plain; {ms:.4f} ms "
              f"a call back to back (CUDA events), {kernel_ms:.4f} ms of "
              f"kernel (profiler) (plain {plain_ms:.4f} ms), bound {bound_ms:.4f} ms by "
              f"{bound_by} ({bound_ms / ms:.1%} of bound; {nbytes} bytes "
              f"read and written), library torch.cat(pages)[lane_idx] "
              f"{lib_ms:.4f} ms ({card})")
        out.setdefault("concat_gather", {
            "name": "concat_gather", "route": "cuda",
            "source": SRC["concat_gather"],
            "replaces": REPLACES["concat_gather"], "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms})
    segs = [
        ("1908 lanes of 60 pages in 2 segments", idx(list(range(2 * S))),
         idx([0] * S + [1] * S), 2),
        ("ragged segments of 954, 477, 1 and 2 lanes",
         idx(list(range(S)) + list(range(S, S + 477)) + [2 * S - 1]
             + [3, 4]),
         idx([0] * S + [1] * 477 + [2] + [3, 3]), 4),
    ]
    for label, li, seg, nseg in segs:
        table = K.gather_table(pages)
        n = li.numel()

        def kern():
            return K.segment_count(pages, li, seg, nseg, table=table)

        def plain():
            return K.segment_count_plain(pages, li, seg, nseg)
        err = max_abs_err(f"segment_count {label}", kern(), plain())
        if err:
            raise AssertionError(f"segment_count {label}: differs from its "
                                 f"plain version, max |err| {err}")
        ms = cuda_ms(kern, reps=50)
        kernel_ms = device_ms(kern, "segment_count_kernel")
        plain_ms = cuda_ms(plain, reps=5)
        nbytes = n * W * 4 + 2 * n * 4 + nseg * 8 + len(pages) * 8
        bound_ms, bound_by, t_bytes, t_ops = bound(
            nbytes, n * W, OPS_PER_S, n * W, popc_rate)
        print(f"kernel segment_count {label}: exact vs plain; {ms:.4f} ms "
              f"a call back to back (CUDA events, the output's zero fill "
              f"included), {kernel_ms:.4f} ms of kernel (profiler) (plain "
              f"{plain_ms:.4f} ms), bound {bound_ms:.4f} ms by "
              f"{bound_by} ({bound_ms / ms:.1%} of bound; byte term "
              f"{t_bytes:.4f} ms for {nbytes} bytes, operation term "
              f"{t_ops:.4f} ms for {n * W} popcounts), library none (torch "
              f"has no popcount) ({card})")
        out.setdefault("segment_count", {
            "name": "segment_count", "route": "cuda",
            "source": SRC["segment_count"],
            "replaces": REPLACES["segment_count"], "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None})
    del pages, half
    return out


# ---------------------------------------------------------------------------
# phase 9: the serving plane on the headline holder
# ---------------------------------------------------------------------------

# bench/common.py:209-222, the serving storm's query mix
SERVING_QUERIES = [
    "Count(Intersect(Row(a=1), Row(b=1)))", "Count(Row(a=1))",
    "Count(Row(b=1))", "Count(Union(Row(a=1), Row(b=1)))", "TopN(t, n=10)",
    "TopN(t, Row(a=1), n=10)", "Row(a=1)", "Count(Row(age > 63))",
    "Sum(Row(a=1), field=age)", "Count(Xor(Row(a=1), Row(b=1)))",
    "Count(Difference(Row(a=1), Row(b=1)))", "Count(Row(age < 32))"]
# bench/ragged.py:100-107
HEAVY_QUERY = ("GroupBy(Rows(edu), Rows(gen), Rows(dom), Rows(reg), "
               "aggregate=Sum(field=age))")
POINT_QUERIES = [("bench", "Count(Row(a=1))", None),
                 ("bench", "Count(Intersect(Row(a=1), Row(b=1)))", None),
                 ("events", "Count(Row(c=1))", None),
                 ("events", "Sum(field=m)", None)]
EVENTS_SHARDS = 3
STORM_CLIENTS = (1, 8, 32)
STORM_S = 1.2
MIXED_CLIENTS = 16
MIXED_S = 1.5
ADMISSION_S = 1.5
# phase 5c's statements on the stacked engine's full width
SERVING_SQL = [SQL_COUNT_AB, SQL_SUM_A, SQL_SUM, SQL_GE64, SQL_BETWEEN,
               SQL_ABLE, SQL_TA, SQL_MINMAX, SQL_DISTINCT, SQL_PERCENTILE,
               SQL_LIMIT]
WRITE_SEED = 2029


def mixed_queries(bench_shards: int, events_shards: int) -> list:
    """bench/ragged.py:72-98: point reads over both indexes, explicit
    shard subsets among them, and batchable TopNs."""
    items = [
        ("bench", "Count(Row(a=1))", None),
        ("bench", "Count(Intersect(Row(a=1), Row(b=1)))", None),
        ("bench", "Count(Union(Row(a=1), Row(b=1)))", None),
        ("bench", "Row(a=1)", None),
        ("bench", "Sum(Row(a=1), field=age)", None),
        ("bench", "Count(Row(age > 63))", None),
        ("events", "Count(Row(c=1))", None),
        ("events", "Count(Union(Row(c=0), Row(c=1)))", None),
        ("events", "Count(Row(m > 255))", None),
        ("events", "Sum(field=m)", None),
        ("events", "Row(c=2)", None),
        ("bench", "TopN(t, n=10)", None),
        ("events", "TopN(u, n=5)", None),
    ]
    items.append(("bench", "Count(Row(a=1))",
                  list(range(max(1, bench_shards // 2)))))
    items.append(("bench", "Count(Row(b=1))", [bench_shards - 1]))
    items.append(("events", "Count(Row(c=1))",
                  list(range(max(1, events_shards - 1)))))
    return items


def build_events_index(h, n_shards: int = EVENTS_SHARDS, seed: int = 11):
    """bench/ragged.py:31-70 through the port's model API: fields c (4
    rows) and u (8 rows) of seeded random words, and m, an INT 0..511 of
    9 planes, every column present."""
    import numpy as np
    from pilosa_tpu_torch.models.schema import (
        CACHE_TYPE_NONE, FieldOptions, FieldType)
    from pilosa_tpu_torch.models.view import VIEW_STANDARD

    rng = np.random.default_rng(seed)
    idx = h.create_index("events", track_existence=False)
    for fname, rows in (("c", 4), ("u", 8)):
        f = idx.create_field(fname, FieldOptions(cache_type=CACHE_TYPE_NONE))
        view = f.view(VIEW_STANDARD, create=True)
        for shard in range(n_shards):
            frag = view.fragment(shard, create=True)
            for r in range(rows):
                frag.import_row_words(r, rng.integers(0, 1 << 32, size=W,
                                                      dtype=np.uint32))
    m = idx.create_field("m", FieldOptions(type=FieldType.INT, min=0,
                                           max=511))
    mview = m.view(m.bsi_view, create=True)
    for shard in range(n_shards):
        frag = mview.fragment(shard, create=True)
        frag.import_row_words(0, np.full(W, 0xFFFFFFFF, dtype=np.uint32))
        for plane in range(9):
            frag.import_row_words(2 + plane, rng.integers(
                0, 1 << 32, size=W, dtype=np.uint32))
    return idx


def digest(results) -> str:
    """bench/ragged.py's _digest: a row result hashes its shards' raw
    words (a dense row's column list costs far more than the query),
    anything else its repr."""
    import hashlib

    import numpy as np
    from pilosa_tpu_torch.executor.results import RowResult
    hs = hashlib.blake2b(digest_size=16)
    for r in results:
        if isinstance(r, RowResult):
            for s in sorted(r.segments):
                hs.update(str(s).encode())
                hs.update(np.ascontiguousarray(r.segments[s]).tobytes())
        else:
            hs.update(repr(r).encode())
    return hs.hexdigest()


def pct(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] * 1e3 if xs else 0.0


def storm(ex, items, want: dict, n_clients: int, seconds: float) -> dict:
    """n_clients threads, each looping over items (offset by its id)
    through Executor.execute_serving for `seconds`, every answer's digest
    held to want; returns the latencies, counts and mismatches."""
    lat: list = []
    bad: list = []
    errors: list = []
    lock = threading.Lock()
    stop = time.perf_counter() + seconds

    def client(cid):
        k = cid
        mine, wrong = [], []
        try:
            while time.perf_counter() < stop:
                it = items[k % len(items)]
                k += 1
                t0 = time.perf_counter()
                got = ex.execute_serving(*it)
                mine.append(time.perf_counter() - t0)
                if digest(got) != want[_key(it)]:
                    wrong.append(it)
        except Exception as e:
            errors.append(f"{type(e).__name__}: {e}")
        with lock:
            lat.extend(mine)
            bad.extend(wrong)

    t0 = time.perf_counter()
    ts = [threading.Thread(target=client, args=(c,), daemon=True)
          for c in range(n_clients)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(seconds + 120)
    if any(t.is_alive() for t in ts):
        raise AssertionError("a storm client did not finish")
    wall = time.perf_counter() - t0
    return {"n": len(lat), "qps": len(lat) / wall, "p50": pct(lat, 0.5),
            "p99": pct(lat, 0.99), "bad": bad, "errors": errors}


def _key(it) -> tuple:
    index, q, shards = it
    return (index, q, tuple(shards) if shards else None)


def phase_serving(h, device, note) -> None:
    """Phase 9 (see the module docstring) on the headline holder that
    phase 8 served, with bench/ragged.py's events index beside it."""
    import gc

    import torch
    from pilosa_tpu_torch.api import API, _json_value
    from pilosa_tpu_torch.executor.executor import Executor
    from pilosa_tpu_torch.executor.sched import ServingShedError
    from pilosa_tpu_torch.models import fragment
    from pilosa_tpu_torch.obs import audit, flight, incidents, metrics
    from pilosa_tpu_torch.obs.monitor import global_monitor
    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.sql.engine import SQLEngine

    card = card_line()
    t_all = time.perf_counter()
    # no shadow samples until 9f: each sampled serve costs a per-shard
    # re-execution, and 9a-9e measure serving
    audit.configure(sample_rate=0.0)
    build_events_index(h)
    solo = Executor(h)
    mixed = mixed_queries(S, EVENTS_SHARDS)
    storm_items = [("bench", q, None) for q in SERVING_QUERIES]
    heavy = [("bench", HEAVY_QUERY, None)]
    t0 = time.perf_counter()
    want = {}
    for it in storm_items + mixed + POINT_QUERIES + heavy:
        want.setdefault(_key(it), digest(solo.execute(*it)))
    print(f"9: events index built ({EVENTS_SHARDS} shards); {len(want)} "
          f"solo answers in {time.perf_counter() - t0:.1f} s ({card})")
    totals = dict.fromkeys(K.LAUNCHES, 0)

    def dispatches() -> dict:
        return {k: metrics.SERVING_DISPATCH.value(kind=k)
                for k in ("ragged", "group")}

    def routes() -> dict:
        return {k: metrics.SERVING_BATCHED.value(route=k)
                for k in ("fused", "cached", "direct", "standing")}

    def check(label, res):
        if res["bad"] or res["errors"]:
            raise AssertionError(f"{label}: {len(res['bad'])} mismatches "
                                 f"{res['bad'][:3]}, errors "
                                 f"{res['errors'][:3]}")

    def add(launches):
        for k, n in launches.items():
            totals[k] += n

    # 9a: the client storm, the server's layer
    api = API(h)
    ex = api.executor
    layer = ex.enable_serving(window_s=0.001, max_batch=64)
    try:
        for n in STORM_CLIENTS:
            for it in storm_items:                  # the warm pass
                ex.execute_serving(*it)
            d0, r0, h0 = dispatches(), routes(), layer.cache.hits
            flight.recorder.clear()
            got, res = launches_of(lambda: storm(ex, storm_items, want, n,
                                                 STORM_S))
            add(got)
            check(f"9a {n} clients", res)
            d1, r1 = dispatches(), routes()
            per = {k: (d1[k] - d0[k]) / max(res["n"], 1) for k in d1}
            phases: dict = {}       # ms a flight phase over the storm
            for rec in flight.recorder.recent(4096):
                for k, v in rec.get("phases", {}).items():
                    phases[k] = round(phases.get(k, 0.0) + v, 3)
            print(f"9a: {n} clients x {STORM_S} s: {res['n']} queries, "
                  f"{res['qps']:.1f} qps, p50 {res['p50']:.3f} ms, p99 "
                  f"{res['p99']:.3f} ms; dispatches a query {per}; routes "
                  f"{ {k: r1[k] - r0[k] for k in r1} }; result-cache hits "
                  f"{layer.cache.hits - h0}; every answer exact ({card})")
            print(f"9a: {n} clients: flight phases {json.dumps(phases)}")
    finally:
        layer.close()

    # 9b: ragged against per-group on the cross-index mix
    arms = {}
    for ragged in (True, False):
        layer = ex.enable_serving(window_s=0.001, max_batch=64,
                                  cache_bytes=0, admission=False,
                                  ragged=ragged)
        try:
            d0, r0 = dispatches(), routes()
            m0 = len(global_monitor.recent())
            for it in mixed:                        # the warm pass
                ex.execute_serving(*it)
            got, res = launches_of(lambda: storm(ex, mixed, want,
                                                 MIXED_CLIENTS, MIXED_S))
            add(got)
            check(f"9b ragged={ragged}", res)
            d1, r1 = dispatches(), routes()
            plans = [e for e in global_monitor.recent()[m0:]
                     if e.get("where", "").startswith("serving.")]
            arm = {"n": res["n"], "qps": res["qps"], "p50": res["p50"],
                   "p99": res["p99"],
                   "dispatches": {k: d1[k] - d0[k] for k in d1},
                   "routes": {k: r1[k] - r0[k] for k in r1},
                   "segment_count": got["segment_count"],
                   "concat_gather": got["concat_gather"],
                   "builds": getattr(getattr(layer, "_ragged_canon", None),
                                     "builds", 0),
                   "captures": [e.get("where") for e in plans]}
            arms[ragged] = arm
            kind = "ragged" if ragged else "group"
            print(f"9b: ragged={ragged}, {MIXED_CLIENTS} clients x "
                  f"{MIXED_S} s: {res['n']} queries, {res['qps']:.1f} qps, "
                  f"p50 {res['p50']:.3f} ms, p99 {res['p99']:.3f} ms; "
                  f"{arm['dispatches'][kind] / max(res['n'], 1):.4f} "
                  f"dispatches a query ({arm['dispatches']}); routes "
                  f"{arm['routes']}; segment_count {got['segment_count']}, "
                  f"concat_gather {got['concat_gather']} launches; canonical "
                  f"builds {arm['builds']}; monitor captures "
                  f"{arm['captures']}; every answer exact ({card})")
        finally:
            layer.close()
    rg = arms[True]
    if (rg["dispatches"]["ragged"] <= 0 or rg["segment_count"] <= 0
            or rg["concat_gather"] <= 0 or rg["captures"]
            or rg["routes"]["direct"] != 0 or rg["dispatches"]["group"]):
        raise AssertionError(f"9b: the ragged route did not serve: {rg}")
    print(f"9b: route held: SERVING_DISPATCH{{kind=ragged}} +"
          f"{rg['dispatches']['ragged']:g}, segment_count "
          f"{rg['segment_count']} and concat_gather {rg['concat_gather']} "
          "launches, no serving.ragged_plan capture, no solo degrade")

    # 9c: admission classes against FIFO, then typed sheds
    for admission in (True, False):
        layer = ex.enable_serving(window_s=0.001, max_batch=64,
                                  cache_bytes=0, admission=admission)
        try:
            res = {}
            heavy_done = threading.Event()

            def heavy_storm():
                res["heavy"] = storm(ex, heavy, want, 4, ADMISSION_S)
                heavy_done.set()
            ht = threading.Thread(target=heavy_storm, daemon=True)
            for it in POINT_QUERIES + heavy:        # the warm pass
                ex.execute_serving(*it)
            a0 = {(c, o): metrics.ADMISSION_TOTAL.value(
                **{"class": c, "outcome": o})
                for c in ("point", "heavy") for o in ("admitted", "shed")}
            ht.start()
            got, pres = launches_of(lambda: storm(ex, POINT_QUERIES, want, 4,
                                                  ADMISSION_S))
            ht.join(ADMISSION_S + 300)
            if ht.is_alive():
                raise AssertionError("9c: the heavy storm did not finish")
            add(got)
            check(f"9c admission={admission} points", pres)
            check(f"9c admission={admission} heavy", res["heavy"])
            classes = {f"{c}:{o}": metrics.ADMISSION_TOTAL.value(
                **{"class": c, "outcome": o}) - n0
                for (c, o), n0 in a0.items()}
            print(f"9c: admission={'classes' if admission else 'FIFO'}: "
                  f"point p50 {pres['p50']:.3f} ms, p99 {pres['p99']:.3f} ms "
                  f"({pres['n']} point reads) under {res['heavy']['n']} heavy "
                  f"GroupBys (p50 {res['heavy']['p50']:.3f} ms); admission "
                  f"by class {classes}; exact ({card})")
        finally:
            layer.close()
    layer = ex.enable_serving(window_s=0.001, max_batch=64, cache_bytes=0,
                              heavy_slots=1, queue_max=2)
    try:
        blocker = layer.sched.heavy_slot(None)
        blocker.__enter__()
        queued = [threading.Thread(target=lambda: ex.execute_serving(
            *heavy[0]), daemon=True) for _ in range(2)]
        try:
            for t in queued:
                t.start()
            deadline = time.perf_counter() + 30
            while layer.sched.queued() < 2:
                if time.perf_counter() > deadline:
                    raise AssertionError("9c: the heavy queue did not fill")
                time.sleep(0.001)
            try:
                ex.execute_serving(*heavy[0])
                raise AssertionError("9c: a third heavy query was admitted")
            except ServingShedError as e:
                if e.status != 503 or not e.retry_after_s > 0:
                    raise AssertionError(f"9c: shed {e.status} "
                                         f"retry_after {e.retry_after_s}")
                print(f"9c: heavy_slots=1, queue_max=2: the third heavy "
                      f"query shed typed {e.status}, retry_after_s "
                      f"{e.retry_after_s:.3f}")
        finally:
            blocker.__exit__(None, None, None)
            for t in queued:
                t.join(120)
        if any(t.is_alive() for t in queued):
            raise AssertionError("9c: a queued heavy query did not finish")
    finally:
        layer.close()

    # 9e: SQL through API.sql's serving arm, each equal to the solo arm
    layer = ex.enable_serving(window_s=0.001, max_batch=64)
    try:
        solo_sql = SQLEngine(h, executor=Executor(h))
        t0 = time.perf_counter()
        for s in SERVING_SQL:
            ref = solo_sql.query_one(s)
            ref_json = {"schema": {"fields": [{"name": n, "type": t}
                                              for n, t in ref.schema]},
                        "data": [[_json_value(v) for v in r]
                                 for r in ref.rows]}
            for arm in ("serving", "cached"):
                got, out = launches_of(lambda: api.sql(s))
                add(got)
                if out != ref_json:
                    raise AssertionError(f"9e {arm} {s}: {str(out)[:200]} != "
                                         f"solo {str(ref_json)[:200]}")
        print(f"9e: {len(SERVING_SQL)} statements through API.sql's serving "
              f"arm, each equal to the solo arm's rows, cold and cached, in "
              f"{time.perf_counter() - t0:.1f} s; statement-cache hits "
              f"{layer.cache.hits}")
    finally:
        layer.close()

    # 9d: writes against the result cache, the canonical program and a
    # standing query
    layer = ex.enable_serving(window_s=0.001, max_batch=64)
    try:
        import numpy as np
        rng = np.random.default_rng(WRITE_SEED)
        q = "Count(Row(a=1))"
        every = list(range(S))
        key = ("bench", f"[{q}]", tuple(every))
        layer.standing.register("bench", q)
        batch = [("bench", "Count(Row(a=1))", None),
                 ("events", "Count(Row(c=1))", None),
                 ("bench", "Count(Row(b=1))", None)]
        canon_b = None

        def run_batch():
            from pilosa_tpu_torch.pql import parse
            reqs = []
            for index, qq, shards in batch:
                idx = h.index(index)
                r = layer._classify(index, idx, parse(qq), shards, None,
                                    (index, qq, None))
                reqs.append(r)
            layer._run_batch(reqs)
            for (index, qq, shards), r in zip(batch, reqs):
                want_r = solo.execute(index, qq, shards)
                if r.result != want_r:
                    raise AssertionError(f"9d {qq}: fused {r.result} != "
                                         f"solo {want_r}")
        run_batch()
        run_batch()
        canon = layer._ragged_canon
        a_view = h.index("bench").field("a").views["standard"]

        def a_bit(col):
            words = a_view.fragment(col // (W * 32)).row_words(1)
            local = col % (W * 32)
            return (int(words[local >> 5]) >> (local & 31)) & 1
        count0 = solo.execute("bench", q)
        orig = {}  # each written column's bit before 9d
        writes = []
        for col in rng.integers(0, S * W * 32, size=8).tolist():
            # the write flips the bit, so the fragment's version moves
            on = orig.setdefault(col, a_bit(col))
            writes.append(f"{'Clear' if on else 'Set'}({col}, a=1)")
        t0 = time.perf_counter()
        for i, w in enumerate(writes + ["import"]):
            ex.execute_serving("bench", q, every)
            if key not in layer.cache:
                raise AssertionError("9d: the Count was not cached")
            canon_b = canon.builds
            e0 = fragment.mutation_epoch()
            if w == "import":
                cols = rng.integers(0, S * W * 32, size=1024)
                for c in cols.tolist():
                    orig.setdefault(c, a_bit(c))
                api.import_bits("bench", "a", rows=[1] * len(cols),
                                cols=cols.tolist())
            else:
                ex.execute_serving("bench", w)
            if fragment.mutation_epoch() == e0:
                raise AssertionError(f"9d {w}: the epoch did not move")
            if key in layer.cache:
                raise AssertionError(f"9d {w}: the cached Count survived")
            run_batch()
            if canon.builds != canon_b + 1:
                raise AssertionError(f"9d {w}: the canonical program was "
                                     f"not built again ({canon.builds})")
            cold = solo.execute("bench", q)
            if ex.execute_serving("bench", q) != cold:
                raise AssertionError(f"9d {w}: the standing Count differs "
                                     f"from a cold execution {cold}")
        (sq,) = layer.standing._by_id.values()
        print(f"9d: {len(writes)} seeded Set/Clear and an import_bits of "
              f"1024 columns into a: each evicted the cached {q}, moved the "
              f"mutation epoch and made the canonical program build again; "
              f"the standing {q} equal to a cold execution after each "
              f"(maintained {sq.stats}) in {time.perf_counter() - t0:.1f} s")
        # a back as phases 4-5c left it, so that phase 10 holds every
        # answer to their numpy mirror
        back = {on: [c for c, was in orig.items()
                     if was == on and a_bit(c) != on] for on in (0, 1)}
        for on, verb in ((1, "Set"), (0, "Clear")):
            if back[on]:
                ex.execute_serving("bench", " ".join(
                    f"{verb}({c}, a=1)" for c in back[on]))
        cold = solo.execute("bench", q)
        if cold != count0 or ex.execute_serving("bench", q) != count0:
            raise AssertionError(f"9d: after writing back {q} is {cold}, "
                                 f"before 9d {count0}")
        print(f"9d: {len(back[1])} Set and {len(back[0])} Clear wrote a "
              f"back: {q} is its count before 9d again, cold and standing")
    finally:
        layer.close()

    # 9f: the audit plane at sample rate 1.0, then one corruption
    for it in POINT_QUERIES:
        want[_key(it)] = digest(solo.execute(*it))
    audit.configure(sample_rate=1.0)
    layer = ex.enable_serving(window_s=0.001, max_batch=64)
    try:
        plane = layer.audit
        t0 = time.perf_counter()
        for _ in range(3):
            for it in POINT_QUERIES:
                if digest(ex.execute_serving(*it)) != want[_key(it)]:
                    raise AssertionError(f"9f {it}: differs from solo")
        if not plane.wait_idle(300):
            raise AssertionError("9f: the audit queue did not drain")
        c = dict(plane.counts)
        matched = c.get(("shadow", "match"), 0)
        if c.get(("shadow", "mismatch"), 0) or not matched:
            raise AssertionError(f"9f: audit counts {c}")
        from pilosa_tpu_torch.obs import faults

        def mismatch_incidents():
            return len([m for m in incidents.get().list(1000)
                        if m["trigger"] == "audit-mismatch"])
        inc0 = mismatch_incidents()
        faults.inject("audit-corrupt", match="serve:", times=1)
        try:
            ex.execute_serving("events", "Count(Row(c=2))")
        finally:
            faults.clear("audit-corrupt")
        if not plane.wait_idle(300) or not incidents.get().wait_idle(60):
            raise AssertionError("9f: the audit did not drain")
        c2 = dict(plane.counts)
        got_inc = mismatch_incidents() - inc0
        if c2.get(("shadow", "mismatch"), 0) != 1 or got_inc != 1:
            raise AssertionError(f"9f: the injected corruption was not "
                                 f"caught: {c2}, incidents {got_inc}")
        print(f"9f: {matched} shadow matches, 0 mismatches, "
              f"{c.get(('shadow', 'shed'), 0)} shed, "
              f"{c.get(('shadow', 'stale_skip'), 0)} stale skips over 12 "
              f"point reads; one audit-corrupt injection counted as 1 "
              f"mismatch with an audit-mismatch incident, in "
              f"{time.perf_counter() - t0:.1f} s")
    finally:
        audit.configure(sample_rate=0.01)
        layer.close()
        ex.serving = None
    from pilosa_tpu_torch.obs import watchdog
    watchdog.stop()
    incidents.get().stop()
    note("9", totals)
    del solo, api, ex
    gc.collect()
    torch.cuda.empty_cache()
    print(f"9: {time.perf_counter() - t_all:.1f} s")


# phase 10: a node over HTTP on the headline holder
NODE_SEED = 2031
NODE_REPS = 3            # warm HTTP and in-process calls a query
INGEST_CLIENTS = 8
INGEST_BATCHES = 6       # /ingest POSTs a client
INGEST_WRITES = 64       # columns a POST: 32 Set, 16 Clear of a, 16 age
INGEST_SHARDS = 32       # the leading shards 10b's columns fall in
KAFKA_RECORDS = 1 << 14  # records a topic, JSON and Avro
KAFKA_SHARDS = 16        # shards the stream's record ids fall in
CLI_RECORDS = 1 << 17    # CSV records of 10e, over CLI_SHARDS shards
CLI_SHARDS = 16
CLI_SECRET = "chip-smoke-node-secret"
SLO_WINDOW_S = 3.0


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ms_stats(xs) -> str:
    """p50 and p99 of times in ms."""
    if not xs:
        return "none"
    xs = sorted(xs)
    p99 = xs[min(len(xs) - 1, int(0.99 * len(xs)))]
    return f"p50 {statistics.median(xs):.3f} ms, p99 {p99:.3f} ms"


def phase_node(h, want: dict, sql_want: dict, root: str,
               note) -> tuple[dict, dict]:
    """Phase 10 (see the module docstring): the port's Server on the
    headline holder that phases 8-9 served, then a CLI node in a
    subprocess.  Returns 10a's HTTP p50s by query and the pre-write
    state of every headline column 10b and 10d wrote ({"a": {col:
    set}, "age": {col: value or None}}), which phase 11 puts back."""
    import os

    from pilosa_tpu_torch import config
    from pilosa_tpu_torch.server.http import Server

    t_all = time.perf_counter()
    path = os.path.join(root, "node.toml")
    with open(path, "w") as f:
        f.write('bind = "127.0.0.1"\nport = 0\ngrpc-port = -1\n\n'
                '[serving]\nbatching = true\n\n[ingest]\nstream = true\n'
                'sync = true\n')
    cfg = config.load(path, env={})
    # the rows phases 8-9 wrote (9d's a and its write-back, the events
    # index) are synced first: the node's first acknowledged write would
    # otherwise wait on persisting them
    t0 = time.perf_counter()
    h.sync()
    print(f"10: the holder's rows dirtied since 6a synced in "
          f"{time.perf_counter() - t0:.1f} s before the node takes writes")
    srv = Server(holder=h, bind=cfg.bind, port=cfg.port, config=cfg)
    srv.start()
    try:
        host = f"127.0.0.1:{srv.port}"
        print(f"10: Server on {host} from {path} (grpc-port {cfg.grpc_port}, "
              f"serving and the stream writer at their defaults, device "
              f"{srv.api.executor.device}, durable acks "
              f"{srv.api.durable_writes}) ({card_line()})")
        p50s = node_queries(srv, host, want, sql_want, note)
        undo = node_ingest(srv, host, note)
        node_kafka(srv, note)
        later = node_txn_slo(srv, host, p50s, cfg, note)
    finally:
        srv.close()
    node_cli(root, note)
    print(f"10: {time.perf_counter() - t_all:.1f} s")
    for k in undo:  # the earliest pre-write state of a column wins
        for col, was in later[k].items():
            undo[k].setdefault(col, was)
    return p50s, undo


def node_queries(srv, host, want, sql_want, note) -> dict:
    """10a: phase 4's query set and 5c's statements over HTTP."""
    import torch
    from pilosa_tpu_torch import client
    from pilosa_tpu_torch.obs import metrics
    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.sql import SQLEngine

    # solo: Executor.execute and SQLEngine's host path on the node's
    # executor, its serving layer set aside (no result cache, batcher or
    # serving arm between); the stacks built here serve the HTTP calls
    t0 = time.perf_counter()
    solo = srv.api.executor
    seng = SQLEngine(srv.holder, executor=solo)
    layer, solo.serving = solo.serving, None
    expect = {}
    try:
        solo_answers(solo, seng, want, sql_want, expect)
    finally:
        solo.serving = layer
    torch.cuda.synchronize()
    del seng
    print(f"10a: {len(expect)} solo answers in {time.perf_counter() - t0:.1f}"
          f" s, each equal to numpy")
    cl = client.Client(host)
    bench = client.Schema().index("bench")
    api = srv.api
    p50s = {}

    def routes() -> dict:
        return {k: metrics.SERVING_BATCHED.value(route=k)
                for k in ("fused", "cached", "direct", "standing")}
    K.reset_launches()
    r0 = routes()
    t0 = time.perf_counter()
    for (kind, q), exp in expect.items():
        http_ms, local_ms = [], []
        for _ in range(1 + NODE_REPS):
            t1 = time.perf_counter()
            got = (cl.query(client.PQL(bench, q)) if kind == "pql"
                   else cl.sql(q)["data"])
            http_ms.append((time.perf_counter() - t1) * 1e3)
            if got != exp:
                raise AssertionError(f"10a HTTP {q}: {str(got)[:200]} != "
                                     f"solo {str(exp)[:200]}")
            t1 = time.perf_counter()
            got = json.loads(json.dumps(
                api.query("bench", q)["results"] if kind == "pql"
                else api.sql(q)["data"]))
            local_ms.append((time.perf_counter() - t1) * 1e3)
            if got != exp:
                raise AssertionError(f"10a in-process {q}: {str(got)[:200]}"
                                     f" != solo {str(exp)[:200]}")
        p50s[q] = statistics.median(http_ms[1:])
        print(f"10a: {q[:70]}: first {http_ms[0]:.2f} ms over HTTP; warm "
              f"p50 {p50s[q]:.3f} ms over HTTP, "
              f"{statistics.median(local_ms[1:]):.3f} ms in-process "
              f"(API.query/API.sql, result cache on)")
    http = dict(K.LAUNCHES)
    r1 = routes()
    note("10a", http)
    print(f"10a: serving routes over HTTP "
          f"{ {k: r1[k] - r0[k] for k in r1} }")
    need = ["groupby_fused", "groupby_sum", "bsi_sum_counts", "bsi_range",
            "assemble_pages"]
    counting = ("popcount_rows", "pair_popcount", "rows_filter_counts",
                "segment_count")
    if any(http[k] == 0 for k in need) or \
            not any(http[k] for k in counting):
        raise AssertionError(f"10a: launches {http}, expected each of "
                             f"{need} and a counting kernel")
    print(f"10a: {len(expect)} answers over HTTP equal to solo, in "
          f"{time.perf_counter() - t0:.1f} s ({card_line()})")
    return p50s


def solo_answers(ex, seng, want: dict, sql_want: dict, expect: dict):
    """10a's solo pass: each query of want through ex.execute and each
    statement of sql_want through seng, held to numpy, their JSON put
    in expect under ("pql" | "sql", text)."""
    from pilosa_tpu_torch.api import _json_value, serialize_result
    for q, w in want.items():
        res = ex.execute("bench", q)
        if normalise(res[0]) != w:
            raise AssertionError(f"10a {q}: solo {str(res)[:200]} != "
                                 f"numpy {str(w)[:200]}")
        expect[("pql", q)] = json.loads(json.dumps(
            [serialize_result(r) for r in res]))
    for q, w in sql_want.items():
        rows = seng.query_one(q).rows
        if rows != w:
            raise AssertionError(f"10a {q}: solo {str(rows)[:200]} != "
                                 f"numpy {str(w)[:200]}")
        expect[("sql", q)] = json.loads(json.dumps(
            [[_json_value(v) for v in r] for r in rows]))


def node_ingest(srv, host, note) -> dict:
    """10b: 8 clients streaming writes through /index/bench/ingest;
    returns the written columns' state before the storm."""
    import numpy as np
    from pilosa_tpu_torch.cluster.client import InternalClient
    from pilosa_tpu_torch.executor.executor import Executor
    from pilosa_tpu_torch.obs import flight
    from pilosa_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(NODE_SEED)
    n = INGEST_CLIENTS * INGEST_BATCHES * INGEST_WRITES
    cols = np.unique(rng.integers(0, INGEST_SHARDS * W * 32, size=2 * n))
    cols = rng.permutation(cols)[:n].reshape(
        INGEST_CLIENTS, INGEST_BATCHES, INGEST_WRITES)
    vals = rng.integers(0, 1 << DEPTH, size=cols.shape)
    flat = sorted(int(c) for c in cols.reshape(-1))
    solo = Executor(srv.holder)
    const = f"ConstRow(columns={flat})"
    pre_a = set(solo.execute("bench", f"Intersect(Row(a=1), {const})")[0]
                .columns().tolist())
    ext = solo.execute("bench", f"Extract({const}, Rows(age))")[0]
    pre_age = {e["column"]: e["rows"][0] for e in ext.columns}
    a0 = solo.execute("bench", "Count(Row(a=1))")[0]
    s0 = solo.execute("bench", "Sum(field=age)")[0]
    cache = srv.api.executor.stacked.cache
    was = cache.counters()
    keys_before = set(cache.keys())
    lat: list = []
    errors: list = []
    w0, m0 = srv.stream.windows_landed, srv.stream.mutations_landed
    lat_lock = threading.Lock()

    def client_run(i):
        ic = InternalClient(timeout=120.0)
        try:
            for b in range(INGEST_BATCHES):
                c = cols[i, b].tolist()
                sets, clears, vcols = c[:32], c[32:48], c[48:]
                v = vals[i, b, 48:].tolist()
                body = {"writes": [
                    {"field": "a", "rows": [1] * 32, "columns": sets},
                    {"field": "a", "rows": [1] * 16, "columns": clears,
                     "clear": True},
                    {"field": "age", "columns": vcols, "values": v}]}
                t1 = time.perf_counter()
                got = ic._request(host, "POST", "/index/bench/ingest", body)
                with lat_lock:
                    lat.append((time.perf_counter() - t1) * 1e3)
                if got["landed"] != INGEST_WRITES:
                    raise AssertionError(f"client {i}: landed {got}")
                # read your own acknowledged write
                r = ic._request(host, "POST", "/index/bench/query", {
                    "query": f"Count(Intersect(Row(a=1), ConstRow(columns="
                             f"{sorted(sets + clears)}))) Sum(ConstRow("
                             f"columns={sorted(vcols)}), field=age)"})
                if r["results"] != [32, {"value": sum(v), "count": 16}]:
                    raise AssertionError(f"client {i} batch {b}: read "
                                         f"{r['results']} after its ack")
        except BaseException as e:
            errors.append(e)

    K.reset_launches()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client_run, args=(i,))
               for i in range(INGEST_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    took = time.perf_counter() - t0
    if errors:
        raise errors[0]
    windows = srv.stream.windows_landed - w0
    muts = srv.stream.mutations_landed - m0
    recs = [r for r in flight.recorder.recent(len(flight.recorder))
            if r.get("route") == "ingest" and r.get("start", 0) >= time.time()
            - took - 1]
    phases = {k: statistics.median([r["phases"].get(k, 0.0) for r in recs])
              for k in ("apply", "maintain", "sync")} if recs else {}
    posts = INGEST_CLIENTS * INGEST_BATCHES
    print(f"10b: {INGEST_CLIENTS} clients x {INGEST_BATCHES} POSTs of "
          f"{INGEST_WRITES} writes over {INGEST_SHARDS} shards (sync on): "
          f"{windows} windows landed, "
          f"{3 * posts / max(windows, 1):.2f} submits a window, {muts} "
          f"mutations in {took:.2f} s ({muts / took:.0f} mutations/s); ack "
          f"{ms_stats(lat)}; window phases p50 (ms) {phases} over "
          f"{len(recs)} flight records; every read after an ack counted "
          f"its own writes ({card_line()})")
    # the mirror: a's row 1 and age's values at the written columns
    sets = {int(c) for c in cols[:, :, :32].reshape(-1)}
    clears = {int(c) for c in cols[:, :, 32:48].reshape(-1)}
    a_want = a0 + len(sets - pre_a) - len(clears & pre_a)
    vc = cols[:, :, 48:].reshape(-1).tolist()
    vv = vals[:, :, 48:].reshape(-1).tolist()
    old = [pre_age[c] for c in vc]
    s_want = (s0.value - sum(x for x in old if x is not None) + sum(vv),
              s0.count + sum(x is None for x in old))
    got_a = srv.api.query("bench", "Count(Row(a=1))")["results"][0]
    now = cache.counters()
    got_s = srv.api.query("bench", "Sum(field=age)")["results"][0]
    if got_a != a_want or (got_s["value"], got_s["count"]) != s_want:
        raise AssertionError(f"10b: after the storm Count(Row(a=1)) {got_a},"
                             f" Sum(field=age) {got_s}; mirror {a_want}, "
                             f"{s_want}")
    for q, w in (("Count(Row(a=1))", a_want), ("Sum(field=age)", s_want)):
        r = normalise(solo.execute("bench", q)[0])
        if r != w:
            raise AssertionError(f"10b: solo {q} {r} != mirror {w}")
    builds = {k: n - was["rebuilds"].get(k, 0)
              for k, n in now["rebuilds"].items()
              if n != was["rebuilds"].get(k, 0)}
    new = [k for k in cache.keys() if k not in keys_before]
    print(f"10b: Count(Row(a=1)) {got_a} and Sum(field=age) {got_s} equal "
          f"the mirror; the storm's reads and the first read after it: "
          f"patches "
          f"{now['patches'] - was['patches']}, patched bytes "
          f"{now['patched_bytes'] - was['patched_bytes']}, rebuilds {builds}"
          f", new keys {len(new)}")
    if now["patches"] == was["patches"] or set(builds) - {"cold"} or \
            builds.get("cold", 0) > len(new):
        raise AssertionError(f"10b: the stale stacks were not all patched: "
                             f"rebuilds {builds}")
    note("10b", dict(K.LAUNCHES))
    del solo
    return {"a": {c: c in pre_a for c in sets | clears},
            "age": {c: pre_age[c] for c in vc}}


def node_kafka(srv, note) -> None:
    """10c: JSON and Avro records from an in-process Broker through
    StreamSource, Pipeline and a StreamImporter on the node's writer,
    with crash-pre-commit armed once."""
    import numpy as np
    from pilosa_tpu_torch.ingest import Pipeline, avro, kafka, stream
    from pilosa_tpu_torch.obs import faults
    from pilosa_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(NODE_SEED + 1)
    ids = rng.permutation(np.unique(rng.integers(
        0, KAFKA_SHARDS * W * 32, size=3 * KAFKA_RECORDS)))[
        :2 * KAFKA_RECORDS]
    jids, aids = ids[:KAFKA_RECORDS].tolist(), ids[KAFKA_RECORDS:].tolist()
    jrow = rng.integers(0, 8, size=KAFKA_RECORDS).tolist()
    jval = rng.integers(0, 1 << 20, size=KAFKA_RECORDS).tolist()
    arows = [sorted(set(rng.integers(0, 8, size=int(k)).tolist()))
             for k in rng.integers(1, 3, size=KAFKA_RECORDS)]
    aval = rng.integers(-(1 << 40), 1 << 40, size=KAFKA_RECORDS).tolist()
    broker = kafka.Broker(n_partitions=4)
    for i, c in enumerate(jids):
        broker.produce("json", {"_id": c, "jf": jrow[i], "jv": jval[i]},
                       key=c)
    schema = {"type": "record", "name": "ev", "fields": [
        {"name": "_id", "type": "long"},
        {"name": "af", "type": {"type": "array", "items": "long"}},
        {"name": "av", "type": "long"}]}
    reg = avro.SchemaRegistry()
    sid = reg.register("avro-value", schema)
    for i, c in enumerate(aids):
        broker.produce("avro", avro.frame(sid, avro.encode(
            schema, {"_id": c, "af": arows[i], "av": aval[i]})), key=c)
    imp = stream.StreamImporter(srv.api, srv.stream)
    jschema = {"jf": {"type": "set"},
               "jv": {"type": "int", "min": 0, "max": 1 << 20}}
    K.reset_launches()

    def run(src, label):
        t0 = time.perf_counter()
        p = Pipeline(src, imp, "kf", batch_size=4096)
        p.apply_schema()
        n = p.run()
        took = time.perf_counter() - t0
        print(f"10c: {label}: {n} records in {took:.2f} s "
              f"({n / took:.0f} records/s) ({card_line()})")
        return n
    faults.inject("crash-pre-commit", times=1)
    t0 = time.perf_counter()
    try:
        run(kafka.StreamSource(broker, "json", group="g", schema=jschema),
            "json, crash-pre-commit armed")
    except faults.InjectedFault:
        print(f"10c: json: the crash-pre-commit fault fired after "
              f"{time.perf_counter() - t0:.2f} s; committed offsets "
              f"{broker.committed('g', 'json')}")
    else:
        raise AssertionError("10c: crash-pre-commit never fired")
    finally:
        faults.clear("crash-pre-commit")
    src = kafka.StreamSource(broker, "json", group="g", schema=jschema)
    run(src, "json, the restarted consumer")
    if src.replayed == 0:
        raise AssertionError("10c: the restarted consumer replayed nothing")
    run(avro.AvroStreamSource(broker, "avro", reg, group="g"), "avro")
    for topic in ("json", "avro"):
        done = broker.committed("g", topic)
        if any(done.get(p, 0) != broker.head(topic, p)
               for p in broker.partitions(topic)):
            raise AssertionError(f"10c: {topic} offsets {done} short of "
                                 f"the heads")
    jcounts = np.bincount(jrow, minlength=8).tolist()
    acounts = [sum(r in rs for rs in arows) for r in range(8)]
    q = " ".join([f"Count(Row(jf={r}))" for r in range(8)]
                 + [f"Count(Row(af={r}))" for r in range(8)]
                 + ["Sum(field=jv)", "Sum(field=av)", "Count(All())"])
    got = srv.api.query("kf", q)["results"]
    exp = jcounts + acounts + [{"value": sum(jval), "count": KAFKA_RECORDS},
                               {"value": sum(aval), "count": KAFKA_RECORDS},
                               2 * KAFKA_RECORDS]
    if got != exp:
        raise AssertionError(f"10c: {got} != numpy {exp}")
    print(f"10c: {src.replayed} records re-delivered after the crash; "
          f"every count and sum of index kf equals numpy, no acknowledged "
          f"record lost")
    note("10c", dict(K.LAUNCHES))


def node_txn_slo(srv, host, p50s, cfg, note) -> dict:
    """10d: writes under an exclusive transaction, then the SLO plane;
    returns the written columns' state before the writes."""
    import numpy as np
    from pilosa_tpu_torch.cluster.client import InternalClient, RemoteError
    from pilosa_tpu_torch.obs import incidents, slo
    from pilosa_tpu_torch.ops import kernels as K

    ic = InternalClient()
    rng = np.random.default_rng(NODE_SEED + 2)
    c1, c2, c3 = (int(x) for x in rng.integers(0, S * W * 32, size=3))
    pre = srv.api.query("bench", f"Intersect(Row(a=1), ConstRow(columns="
                        f"{sorted({c1, c2})})) Extract(ConstRow(columns="
                        f"[{c3}]), Rows(age))")["results"]
    undo = {"a": {c: c in pre[0]["columns"] for c in (c1, c2)},
            "age": {c3: pre[1]["columns"][0]["rows"][0]
                    if pre[1]["columns"] else None}}
    writes = [
        ("PQL Set", "POST", "/index/bench/query",
         {"query": f"Set({c1}, a=1)"}),
        ("import", "POST", "/index/bench/field/a/import",
         {"rows": [1], "columns": [c2]}),
        ("SQL INSERT", "POST", "/sql",
         {"sql": f"INSERT INTO bench (_id, age) VALUES ({c3}, 7)"})]
    K.reset_launches()
    tx = ic._request(host, "POST", "/transaction",
                     {"exclusive": True, "timeout": 120})
    if not tx["active"]:
        raise AssertionError(f"10d: transaction {tx} not active")
    for label, m, p, body in writes:
        try:
            ic._request(host, m, p, body)
        except RemoteError as e:
            if e.status != 409:
                raise
        else:
            raise AssertionError(f"10d: {label} landed under the exclusive "
                                 f"transaction")
    ic._request(host, "POST", f"/transaction/{tx['id']}/finish")
    took = []
    for label, m, p, body in writes:
        t0 = time.perf_counter()
        ic._request(host, m, p, body)
        took.append(f"{label} {(time.perf_counter() - t0) * 1e3:.1f} ms")
    got = ic._request(host, "POST", "/index/bench/query", {
        "query": f"Count(Intersect(Row(a=1), ConstRow(columns="
                 f"{sorted([c1, c2])}))) Sum(ConstRow(columns=[{c3}]), "
                 f"field=age)"})["results"]
    if got != [2, {"value": 7, "count": 1}]:
        raise AssertionError(f"10d: after the transaction {got}")
    print(f"10d: PQL Set, import and SQL INSERT answered 409 under the "
          f"exclusive transaction and landed after it finished (each "
          f"acknowledged after the index's sync: {', '.join(took)})")
    body = ic._request(host, "GET", "/debug/slo")
    if body["windows"] != ["5m", "1h", "6h"]:
        raise AssertionError(f"10d: /debug/slo windows {body['windows']}")
    thr = min(p50s.values()) / 10
    t = slo.configure(latency_ms=thr, windows=f"{SLO_WINDOW_S:g}s")
    t.sample()
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < SLO_WINDOW_S * 0.93:
        ic._request(host, "POST", "/index/bench/query",
                    {"query": f"Count(Row(t={n % R}))",
                     "shards": [n % S]})
        n += 1

    def burns():
        return [m for m in incidents.get().list(1000)
                if m["trigger"] == "slo-burn"]
    before = len(burns())
    slo.tick()
    incidents.get().wait_idle(30)
    listed = ic._request(host, "GET", "/debug/incidents")["incidents"]
    fired = [m for m in listed if m["trigger"] == "slo-burn"]
    ev = t.evaluate()["slos"]["latency"]["windows"]
    if len(burns()) != before + 1 or not fired:
        raise AssertionError(f"10d: no slo-burn incident: {ev}")
    print(f"10d: /debug/slo windows {body['windows']}; under latency-ms "
          f"{thr:.4f} (a tenth of the smallest 10a HTTP p50) and a "
          f"{SLO_WINDOW_S:g} s window, {n} queries and one slo.tick() "
          f"reported slo-burn {fired[0]['detail']} at /debug/incidents "
          f"(burn {ev})")
    cfg.apply_slo_settings()
    note("10d", dict(K.LAUNCHES))
    return undo


def node_cli(root, note) -> None:
    """10e: `python -m pilosa_tpu_torch.cli.main server` in a subprocess
    on the card, with an auth secret: the CLI import, queries through
    Client and `cli.main sql`, a 401, SIGKILL and a restart."""
    import contextlib
    import io
    import os

    import numpy as np
    from pilosa_tpu_torch import client
    from pilosa_tpu_torch.cli import main as climain
    from pilosa_tpu_torch.cluster.client import InternalClient, RemoteError

    def cli(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = climain.main(argv)
        if rc != 0:
            raise AssertionError(f"10e: cli {argv[0]} exited {rc}")
        return out.getvalue()

    data = os.path.join(root, "cli_node")
    port = free_port()
    host = f"127.0.0.1:{port}"
    repo = os.path.dirname(os.path.abspath(__file__))
    argv = [sys.executable, "-m", "pilosa_tpu_torch.cli.main", "server",
            "--data-dir", data, "--grpc-port", "-1", "--bind", "127.0.0.1",
            "--port", str(port), "--auth-secret", CLI_SECRET]
    env = dict(os.environ, PYTHONPATH=repo)

    def start():
        t0 = time.perf_counter()
        p = subprocess.Popen(argv, cwd=repo, env=env, text=True,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE)
        lines: list = []
        up = threading.Event()

        def drain():
            for ln in p.stderr:
                lines.append(ln)
                if "listening" in ln:
                    up.set()
        threading.Thread(target=drain, daemon=True).start()
        if not up.wait(180):
            p.kill()
            raise AssertionError(f"10e: the node never listened: "
                                 f"{''.join(lines)[-1500:]}")
        return p, time.perf_counter() - t0

    token = cli(["keygen", "--secret", CLI_SECRET]).strip()
    rng = np.random.default_rng(NODE_SEED + 3)
    ids = np.unique(rng.integers(0, CLI_SHARDS * W * 32, size=CLI_RECORDS))
    rows = rng.integers(0, 6, size=ids.size)
    ages = rng.integers(0, 100, size=ids.size)
    csv = os.path.join(root, "cli.csv")
    with open(csv, "w") as f:
        f.write("_id,a:id,age:int\n")
        f.writelines(f"{c},{r},{v}\n" for c, r, v in zip(
            ids.tolist(), rows.tolist(), ages.tolist()))
    p, up_s = start()
    try:
        print(f"10e: cli server on {host} listening after {up_s:.1f} s")
        try:
            InternalClient()._request(host, "POST", "/index/x/query",
                                      {"query": "Count(All())"})
        except RemoteError as e:
            if e.status != 401:
                raise
        else:
            raise AssertionError("10e: a request without a token answered")
        t0 = time.perf_counter()
        out = cli(["import", "--host", host, "--token", token, "-i", "clix",
                   "--batch-size", "65536", csv])
        took = time.perf_counter() - t0
        print(f"10e: {out.strip()} through HTTPImporter in {took:.2f} s "
              f"({ids.size / took:.0f} records/s)")
        ic = InternalClient(headers={"Authorization": f"Bearer {token}"})
        got = ic._request(host, "POST", "/index/clix/ingest", {"writes": [
            {"field": "a", "rows": [9, 9], "columns": [5, int(ids[-1])]}]})
        if got["landed"] != 2:
            raise AssertionError(f"10e: ingest {got}")
        cl = client.Client(host, token=token)
        idx = client.Schema().index("clix")
        q = client.PQL(idx, " ".join(
            [f"Count(Row(a={r}))" for r in range(6)]
            + ["Count(Row(a=9))", "Sum(field=age)", "Count(All())"]))
        exp = np.bincount(rows, minlength=6).tolist() + [
            2, {"value": int(ages.sum()), "count": int(ids.size)},
            int(ids.size) + (0 if 5 in set(ids.tolist()) else 1)]
        before = cl.query(q)
        if before != exp:
            raise AssertionError(f"10e: {before} != numpy {exp}")
        sql = subprocess.run(
            [sys.executable, "-m", "pilosa_tpu_torch.cli.main", "sql",
             "--host", host, "--token", token], cwd=repo, env=env,
            input="SELECT COUNT(*) FROM clix;\nSELECT SUM(age) FROM clix;\n",
            capture_output=True, text=True, timeout=120)
        if sql.returncode != 0 or str(exp[-1]) not in sql.stdout or \
                str(int(ages.sum())) not in sql.stdout:
            raise AssertionError(f"10e: cli sql: {sql.stdout[-500:]} "
                                 f"{sql.stderr[-500:]}")
        print(f"10e: Client and `cli.main sql` answers equal numpy "
              f"({exp[-1]} records)")
        p.kill()
        p.wait(60)
        t0 = time.perf_counter()
        p, up_s = start()
        after = cl.query(q)
        first = time.perf_counter() - t0
        if after != before:
            raise AssertionError(f"10e: after SIGKILL and a restart {after} "
                                 f"!= {before}")
        print(f"10e: SIGKILL, restart on {data}: listening after {up_s:.1f} "
              f"s, first answer {first:.1f} s after the restart began; "
              f"every acknowledged write read back ({card_line()})")
    finally:
        p.kill()
        p.wait(60)


CLUSTER_SEED = 2032
S_SUB = 320               # the headline's leading shards of 11a-11d and 12
CLUSTER_NODES = 3
CLUSTER_REPLICAS = 2
CLUSTER_REPS = 2          # warm fan-out calls a query
CLUSTER_WRITES = 256      # 11b's seeded Set/Clear of a
CLUSTER_IMPORT = 1 << 16  # 11b's records of the new set and INT fields
CLUSTER_IMPORT_SHARDS = 64
FAILOVER_BITS = 64        # 11c's bits written while node2 is down
FAILOVER_SHARDS = 16      # over this many of the shards node2 owns
HEDGE_DELAY_S = 0.25      # 11d's rpc-delay on node1's legs
HEDGE_MS = 20.0
HEDGE_QUERIES = ["Count(Row(a=1))", "Sum(field=age)", "TopN(t, n=8)"]
HEDGE_REPS = 3
RESHARD_SHARDS = 16       # 11e's index: the headline's first 16 shards
RESHARD_READERS = 4
RESHARD_WRITES = 400      # 11e's writer: Set of wr=9 at seeded columns


def holder_words(h, n: int) -> tuple[dict, dict]:
    """The headline index's words over its n leading shards, read back
    from the holder: build_index's layout of a, b, t, the age planes and
    age_exists, plus s (5a's Store), and each categorical field's rows
    (rows, n, W)."""
    import numpy as np
    from pilosa_tpu_torch.models.view import VIEW_STANDARD
    idx = h.index("bench")

    def rows(fname, row_ids, view=VIEW_STANDARD):
        out = np.zeros((len(row_ids), n, W), dtype=np.uint32)
        v = idx.field(fname).view(view)
        for s in range(n):
            frag = v.fragments.get(s) if v is not None else None
            if frag is None:
                continue
            for i, r in enumerate(row_ids):
                out[i, s] = frag.row_words(r)
        return out

    planes = rows("age", range(2 + DEPTH), idx.field("age").bsi_view)
    if planes[1].any():
        raise AssertionError("age holds a negative value")
    data = {"a": rows("a", [1])[0], "b": rows("b", [1])[0],
            "t": rows("t", range(R)), "age": planes[2:],
            "age_exists": planes[0], "s": rows("s", [1])[0]}
    cats = {f: rows(f, range(n_rows)) for f, n_rows in CATEGORIES.items()}
    return data, cats


def rows_histogram(data, cats, n: int):
    """joint_histogram's counts over the n leading shards, from the
    categorical fields' rows as they stand (a column in no row of a
    field, deleted or never given one, in the field's ABSENT slot).
    Each field's digit bits are built from its (disjoint) rows' words,
    then every column's digits, a bit, exists bit and age value are
    packed into one 20-bit code, counted in batches of 32 shards and
    laid out as HIST_SHAPE, int64."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    def bits(words):
        return np.unpackbits(np.ascontiguousarray(words).view(np.uint8),
                             axis=-1, bitorder="little")

    # digit bits a field: room for its rows and its ABSENT slot
    widths = {f: max(CATEGORIES[f] - 1, ABSENT[f]).bit_length()
              for f in CATEGORIES}
    n_high = sum(widths.values()) + 1          # the digits, then exists
    n_bins = 1 << (n_high + 1 + DEPTH)

    def batch(lo):
        sl = slice(lo, min(lo + 32, n))
        high = None
        for f in ("edu", "gen", "dom", "reg"):
            rows_f = cats[f][:, sl]
            absent = ~np.bitwise_or.reduce(rows_f, axis=0)
            for b in reversed(range(widths[f])):
                plane = absent.copy() if (ABSENT[f] >> b) & 1 \
                    else np.zeros_like(absent)
                for r in range(CATEGORIES[f]):
                    if (r >> b) & 1:
                        plane |= rows_f[r]
                d = bits(plane).astype(np.uint16)
                high = d if high is None else (high << np.uint16(1)) | d
        high = (high << np.uint16(1)) | bits(data["age_exists"][sl])
        low = bits(data["a"][sl]) << np.uint8(DEPTH)
        for p in range(DEPTH):
            low |= bits(data["age"][p, sl]) << np.uint8(p)
        code = (high.astype(np.uint32) << np.uint32(1 + DEPTH)) | low
        return np.bincount(code.reshape(-1), minlength=n_bins)

    # numpy releases the interpreter lock in these loops: batches on
    # threads
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        total = sum(ex.map(batch, range(0, n, 32)))
    shape = [1 << widths[f] for f in ("edu", "gen", "dom", "reg")]
    t = total.reshape(*shape, 2, 2, 1 << DEPTH)   # ..., exists, a, age
    out = np.zeros(HIST_SHAPE, dtype=np.int64)
    ne, ng, nd, nr = HIST_SHAPE[:4]
    t = t[:ne, :ng, :nd, :nr]
    out[..., :NO_VALUE] = t[:, :, :, :, 1]
    out[..., NO_VALUE] = t[:, :, :, :, 0].sum(axis=-1)
    return out


def sub_reference(h, n: int) -> dict:
    """Phase 4's query set's numpy answers (numpy_answers, and 5a's
    Count of s) over the headline's n leading shards, from their words
    read back from the holder; with the words, for the SQL and paged
    references below."""
    import numpy as np
    data, cats = holder_words(h, n)
    headline, groupby, ages = numpy_answers(data, rows_histogram(data, cats,
                                                                 n))
    want = {**headline, **groupby,
            STORE_COUNT: int(np.bitwise_count(data["s"]).sum(
                dtype=np.int64))}
    return {"n": n, "data": data, "cats": cats, "want": want,
            "ages": ages}


def slice_reference(ref: dict, n: int) -> dict:
    """numpy_answers over the n leading shards of ref's words."""
    data = {k: (v[:, :n] if v.ndim == 3 else v[:n])
            for k, v in ref["data"].items()}
    cats = {f: v[:, :n] for f, v in ref["cats"].items()}
    headline, groupby, _ages = numpy_answers(data,
                                             rows_histogram(data, cats, n))
    return {**headline, **groupby}



def cluster_config(**overrides):
    """A node's config: no gRPC (the card machine has none), hedging as
    given (off unless asked), everything else at its default."""
    from pilosa_tpu_torch import config
    return config.load(None, env={}, overrides={
        "grpc_port": -1, "cluster_hedge_ms": -1.0, **overrides})


def wire_norm(q: str, wire, width: int):
    """A cluster answer's JSON as phase 4's normalised form, through
    executor.results.deserialize_result."""
    from pilosa_tpu_torch.executor.results import deserialize_result
    from pilosa_tpu_torch.pql import parse
    return normalise(deserialize_result(parse(q).calls[0], wire, width))


def placement(n_nodes: int, replica_n: int):
    """The ClusterSnapshot of nodes node0.. node{n-1}, all live: the
    placement a cluster of them opened in order takes."""
    from pilosa_tpu_torch.cluster import ClusterSnapshot, Node, NodeState
    return ClusterSnapshot([Node(id=f"node{i}", state=NodeState.STARTED)
                            for i in range(n_nodes)], replica_n)


def copy_shards(h, holders, index: str, shards, snap, fields=None,
                dst_index: str | None = None) -> int:
    """Each shard's fragments of h's index into holders[i] of every node
    node{i} that snap.shard_nodes assigns it (primary and replica),
    under dst_index (the same name by default), with the index and its
    fields made there first: row by row through
    Fragment.import_row_words into empty rows; returns the rows
    copied."""
    from pilosa_tpu_torch.models.schema import FieldOptions
    src = h.index(index)
    dst_index = dst_index or index
    n = 0
    for i, hd in enumerate(holders):
        didx = hd.index(dst_index) or hd.create_index(
            dst_index, keys=src.keys, track_existence=False)
        mine = [s for s in shards if f"node{i}" in
                [o.id for o in snap.shard_nodes(dst_index, s)]]
        for fname in sorted(src.fields):
            if fields is not None and fname not in fields:
                continue
            f = src.field(fname)
            df = didx.field(fname) or didx.create_field(
                fname, FieldOptions.from_dict(f.to_dict()["options"]))
            for vname, view in f.views.items():
                dview = df.view(vname, create=True)
                for shard in mine:
                    frag = view.fragments.get(shard)
                    if frag is None:
                        continue
                    dst = dview.fragment(shard, create=True)
                    for r in frag.row_ids:
                        dst.import_row_words(r, frag.row_words(r))
                        n += 1
    return n


def write_back(h, undo: dict) -> int:
    """Put back every column phase 10 wrote in the headline index (a's
    row 1 and age), as 9d puts back its own, so that the holder again
    equals the numpy mirror after 5a."""
    idx = h.index("bench")
    fa, fage = idx.field("a"), idx.field("age")
    for col, was in undo["a"].items():
        (fa.set_bit if was else fa.clear_bit)(1, col)
    for col, old in undo["age"].items():
        if old is None:
            fage.clear_value(col)
        else:
            fage.set_value(col, old)
    return len(undo["a"]) + len(undo["age"])


def phase_cluster(h, stacked_p50: dict, http_p50: dict, undo: dict,
                  root: str, note) -> dict:
    """Phase 11 (see the module docstring): a three-node cluster of port
    ClusterNodes on the card over the headline index's S_SUB leading
    shards, then a second cluster for resharding and the backup/restore
    of one of its nodes.  Returns the numpy reference of those shards
    (sub_reference), which phase 12 holds its answers to."""
    import gc

    import torch

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    n = write_back(h, undo)
    print(f"11: the {n} columns phase 10 wrote put back in "
          f"{time.perf_counter() - t0:.2f} s (host)")
    t0 = time.perf_counter()
    ref = sub_reference(h, S_SUB)
    print(f"11: numpy reference of the {S_SUB} leading shards from their "
          f"words read back from the holder in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    gc.collect()
    torch.cuda.empty_cache()
    cluster_main(h, ref["want"], stacked_p50, http_p50, note)
    gc.collect()
    torch.cuda.empty_cache()
    cluster_reshard(h, root, note)
    print(f"11: {time.perf_counter() - t_all:.1f} s ({card_line()})")
    return ref


def cluster_main(h, want, stacked_p50, http_p50, note) -> None:
    """11a-11d on one three-node cluster of the headline index."""
    from pilosa_tpu_torch import memory
    from pilosa_tpu_torch.cluster import (
        ClusterNode, InMemDisCo, LoadShedError, coordinator)
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.obs import faults, flight, metrics
    from pilosa_tpu_torch.ops import kernels as K

    cfg = cluster_config()
    width = W * 32
    # heartbeat leases of 5 s: a heartbeat thread starved of the
    # interpreter lock by three nodes in one process must not read as
    # a dead node
    disco = InMemDisCo(lease_ttl=5.0)
    holders = [Holder(width=width) for _ in range(CLUSTER_NODES)]
    made = []

    def open_node(i, **kw):
        nd = ClusterNode(f"node{i}", disco, holder=holders[i],
                         replica_n=CLUSTER_REPLICAS, heartbeat_interval=1.0,
                         config=cfg).open(**kw)
        made.append(nd)
        return nd

    try:
        # the holders are filled before their nodes open, by the
        # placement the opened cluster takes (checked below)
        t0 = time.perf_counter()
        snap = placement(CLUSTER_NODES, CLUSTER_REPLICAS)
        rows = copy_shards(h, holders, "bench", range(S_SUB), snap)
        t_copy = time.perf_counter() - t0
        nodes = [open_node(i) for i in range(CLUSTER_NODES)]
        if any(nd.api.executor.device.type != "cuda" for nd in nodes):
            raise AssertionError("11a: a node is not on the card")
        nodes[0].apply_schema({"indexes": [h.index("bench").to_dict()]})
        disco.add_shards("bench", "", set(range(S_SUB)))
        live = nodes[0].snapshot()
        if any([o.id for o in live.shard_nodes("bench", s_)]
               != [o.id for o in snap.shard_nodes("bench", s_)]
               for s_ in range(S_SUB)):
            raise AssertionError("11a: the cluster's placement differs")
        host = [sum(fr.memory_bytes() for f in hd.index("bench").fields.values()
                    for v in f.views.values() for fr in v.fragments.values())
                for hd in holders]
        groups = snap.shards_by_node("bench", range(S_SUB))
        print(f"11a: {CLUSTER_NODES} ClusterNodes (replica_n "
              f"{CLUSTER_REPLICAS}, one InMemDisCo, lease 5 s, HTTP on "
              f"loopback, grpc-port -1) on {nodes[0].api.executor.device}; "
              f"{rows} rows of {S_SUB} shards copied to their owners in "
              f"{t_copy:.1f} s, the nodes opened in "
              f"{time.perf_counter() - t0 - t_copy:.1f} s (host); host bytes a node "
              f"{host} ({sum(host) / 2**30:.2f} GiB); fan-out groups "
              f"{ {k: len(v) for k, v in sorted(groups.items())} }")
        firsts, p50s, launches = cluster_queries(
            nodes[0], want, "11a", width, K)
        note("11a", launches)
        for q, ms in p50s.items():
            print(f"11a: {q[:70]}: first {firsts[q]:.2f} ms, warm p50 "
                  f"{ms:.3f} ms through ClusterExecutor.execute over "
                  f"{S_SUB} shards; phase 4 in-process p50 "
                  f"{stacked_p50.get(q, float('nan')):.3f} ms, 10a HTTP p50 "
                  f"{http_p50.get(q, float('nan')):.3f} ms (both over {S})")
        led = memory.ledger()
        res = [nd.api.executor.stacked.cache.nbytes for nd in nodes]
        print(f"11a: resident stack bytes a node {res} "
              f"({sum(res) / 2**30:.2f} GiB); the one ledger's total "
              f"{led.total_bytes / 2**30:.2f} GiB ({card_line()})")
        # each node's own leg alone, past its result cache (which holds
        # the fan-out's answers): every node launches on the card
        per = {}
        for nd in nodes:
            K.reset_launches()
            for q in ("Count(Intersect(Row(a=1), Row(b=1)))",
                      "Sum(field=age)"):
                nd.api.executor.execute("bench", q,
                                        shards=groups[nd.node_id])
            per[nd.node_id] = dict(K.LAUNCHES)
            note(f"11a {nd.node_id}", per[nd.node_id])
            if not sum(per[nd.node_id].values()):
                raise AssertionError(f"11a: {nd.node_id} launched nothing")
        rec = next(r for r in flight.recorder.recent(4096)
                   if r.get("route") == "cluster")
        att = [(a["node"], round(a["ms"], 3), a["outcome"])
               for a in rec.get("attempts", ())]
        print(f"11a: the last fan-out's flight record: {rec.get('query')!s:.60}"
              f" {round(rec.get('duration_ms', 0.0), 3)} ms, attempts "
              f"(node, ms, outcome) {att}")
        if {a[0] for a in att} != {nd.node_id for nd in nodes}:
            raise AssertionError(f"11a: attempts {att} miss a node")
        cluster_writes(nodes, h, width, K, note)
        nodes = cluster_failover(nodes, open_node, made, want, width,
                                 p50s, K, LoadShedError, note)
        # 11d: hedged reads under an rpc-delay on node1's legs, once
        # every node is live again (a lease that ran out during the
        # rejoin's load is renewed by the next beat)
        t0 = time.perf_counter()
        end = time.monotonic() + 30
        while any(n.state != "STARTED" for n in disco.nodes()):
            if time.monotonic() > end:
                raise AssertionError(f"11d: nodes {[(n.id, n.state) for n in disco.nodes()]}")
            time.sleep(0.1)
        base = {q: want[q] for q in HEDGE_QUERIES}
        faults.inject("rpc-delay", match=nodes[1].uri, times=0,
                      delay_s=HEDGE_DELAY_S)
        try:
            _f, slow, _l = cluster_queries(nodes[0], base, "11d hedge off",
                                           width, K, reps=HEDGE_REPS)
            fired0 = metrics.CLUSTER_EVENTS.value(event="hedge_fired")
            won0 = metrics.CLUSTER_EVENTS.value(event="hedge_won")
            coordinator.configure(hedge_ms=HEDGE_MS)
            _f, fast, launches = cluster_queries(
                nodes[0], base, "11d hedge on", width, K, reps=HEDGE_REPS)
            note("11d", launches)
        finally:
            coordinator.configure(hedge_ms=-1.0)
            faults.clear("rpc-delay")
        fired = metrics.CLUSTER_EVENTS.value(event="hedge_fired") - fired0
        won = metrics.CLUSTER_EVENTS.value(event="hedge_won") - won0
        if not fired or not won or \
                min(slow.values()) < HEDGE_DELAY_S * 1e3:
            rec = next(r for r in flight.recorder.recent(4096)
                       if r.get("route") == "cluster")
            raise AssertionError(
                f"11d: hedges fired {fired}, won {won}; p50s without a "
                f"hedge {slow}, with {fast}; knobs {coordinator.settings()};"
                f" nodes {[(n.id, n.state, n.uri) for n in disco.nodes()]}; "
                f"roster {disco.roster()}; last attempts "
                f"{rec.get('attempts')}")
        for q in HEDGE_QUERIES:
            print(f"11d: {q}: warm p50 {slow[q]:.3f} ms with node1's legs "
                  f"delayed {HEDGE_DELAY_S * 1e3:.0f} ms and no hedge, "
                  f"{fast[q]:.3f} ms with a {HEDGE_MS:g} ms hedge "
                  f"(configure(hedge_ms=))")
        print(f"11d: hedges fired {fired:g}, won {won:g}; every answer exact "
              f"in {time.perf_counter() - t0:.1f} s ({card_line()})")
    finally:
        for nd in made:
            try:
                nd.close()
            except Exception:
                pass


def cluster_queries(coord, want, label, width, K, reps=CLUSTER_REPS):
    """Each query of want through coord's ClusterExecutor, cold and then
    reps times warm, its JSON held exactly to numpy; returns (first ms,
    warm p50 ms, the launches of the whole run)."""
    import torch
    K.reset_launches()
    firsts, p50s = {}, {}
    for q, w in want.items():
        times = []
        for _ in range(1 + reps):
            t0 = time.perf_counter()
            got = coord.executor.execute("bench", q)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if "partial" in got or wire_norm(
                    q, got["results"][0], width) != w:
                raise AssertionError(f"{label} {q}: {str(got)[:200]} != "
                                     f"numpy {str(w)[:200]}")
        firsts[q], p50s[q] = times[0], statistics.median(times[1:])
    return firsts, p50s, dict(K.LAUNCHES)


def cluster_writes(nodes, h, width, K, note) -> None:
    """11b: routed PQL writes and replicated imports through node0."""
    import numpy as np
    rng = np.random.default_rng(CLUSTER_SEED)
    t0 = time.perf_counter()
    K.reset_launches()
    cols = sorted({int(c) for c in rng.integers(0, S_SUB * width,
                                                size=CLUSTER_WRITES)})
    const = f"ConstRow(columns={cols})"
    ex = nodes[0].executor
    pre = set(ex.execute("bench", f"Intersect(Row(a=1), {const})")
              ["results"][0]["columns"])
    a0 = ex.execute("bench", "Count(Row(a=1))")["results"][0]
    took = []
    want_on = set()
    for i, c in enumerate(cols):
        call = "Set" if i % 2 else "Clear"
        t1 = time.perf_counter()
        ex.execute("bench", f"{call}({c}, a=1)")
        took.append((time.perf_counter() - t1) * 1e3)
        if call == "Set":
            want_on.add(c)
    a_want = a0 + len(want_on - pre) - len((set(cols) - want_on) & pre)
    got = ex.execute("bench", f"Count(Row(a=1)) Intersect(Row(a=1), {const})")
    if got["results"] != [a_want, {"columns": sorted(want_on)}]:
        raise AssertionError(f"11b: after the writes {str(got)[:200]}; "
                             f"want {a_want}")
    snap = nodes[0].snapshot()
    by_id = {nd.node_id: nd for nd in nodes}
    by_shard: dict = {}
    for c in cols:
        by_shard.setdefault(c // width, []).append(c)
    for s, cs in by_shard.items():
        q = f"Intersect(Row(a=1), ConstRow(columns={cs}))"
        for owner in snap.shard_nodes("bench", s):
            r = by_id[owner.id].api.query("bench", q, shards=[s])
            if r["results"][0]["columns"] != sorted(set(cs) & want_on):
                raise AssertionError(f"11b: {owner.id} shard {s} holds "
                                     f"{r['results']}")
    print(f"11b: {len(cols)} seeded Set/Clear of a through "
          f"ClusterExecutor.execute, each to both owners of its shard: "
          f"write {ms_stats(took)} (holders in memory: no sync in the ack); "
          f"Count(Row(a=1)) {a_want} equals the mirror, and both owners of "
          f"each of {len(by_shard)} shards hold the written bits")
    # put them back, so that the query set's numpy answers hold again
    for c in cols:
        ex.execute("bench", f"{'Set' if c in pre else 'Clear'}({c}, a=1)")
    if ex.execute("bench", "Count(Row(a=1))")["results"] != [a0]:
        raise AssertionError("11b: the write-back left a changed")
    # replicated imports of new fields over HTTP
    nodes[0].apply_schema({"indexes": [{"name": "bench", "fields": [
        {"name": "imp", "options": {"type": "set"}},
        {"name": "iv", "options": {"type": "int", "min": 0, "max": 1000}}]}]})
    span = CLUSTER_IMPORT_SHARDS * width
    icols = np.sort(rng.choice(span, CLUSTER_IMPORT, replace=False))
    irows = rng.integers(0, 4, icols.size)
    ivals = rng.integers(0, 1001, icols.size)
    t1 = time.perf_counter()
    nodes[0].import_bits("bench", "imp", irows.tolist(), icols.tolist())
    tb = time.perf_counter() - t1
    t1 = time.perf_counter()
    nodes[0].import_values("bench", "iv", icols.tolist(), ivals.tolist())
    tv = time.perf_counter() - t1
    for r in range(4):
        got = ex.execute("bench", f"Count(Row(imp={r}))")["results"][0]
        if got != int((irows == r).sum()):
            raise AssertionError(f"11b: Count(Row(imp={r})) {got}")
    got = ex.execute("bench", "Sum(field=iv)")["results"][0]
    if got != {"value": int(ivals.sum()), "count": int(icols.size)}:
        raise AssertionError(f"11b: Sum(field=iv) {got}")
    shard_of = icols // width
    for s in range(CLUSTER_IMPORT_SHARDS):
        w1 = int(((shard_of == s) & (irows == 1)).sum())
        wv = int(ivals[shard_of == s].sum())
        for owner in snap.shard_nodes("bench", s):
            r = by_id[owner.id].api.query(
                "bench", "Count(Row(imp=1)) Sum(field=iv)", shards=[s])
            if r["results"][0] != w1 or r["results"][1]["value"] != wv:
                raise AssertionError(f"11b: {owner.id} shard {s} holds "
                                     f"{r['results']}")
    note("11b", dict(K.LAUNCHES))
    print(f"11b: import_bits of {icols.size} records ({tb:.2f} s) and "
          f"import_values ({tv:.2f} s) over {CLUSTER_IMPORT_SHARDS} shards "
          f"through the replicated import (node0 local, the others over "
          f"HTTP): every count and sum exact, both owners of each shard "
          f"hold their records; 11b in {time.perf_counter() - t0:.1f} s")


def cluster_failover(nodes, open_node, made, want, width, p50s, K,
                     LoadShedError, note):
    """11c: node2 dies (pause: its socket closes, its beats stop), writes
    it misses, the query set through the survivors, a second node paused
    for the partial and shed answers, and node2's warm rejoin."""
    import numpy as np
    from pilosa_tpu_torch.cluster import NodeState
    t0 = time.perf_counter()
    steps = {}

    def step(name, t):
        steps[name] = round(time.perf_counter() - t, 2)
        return time.perf_counter()
    disco = nodes[0].disco
    nodes[2].pause()
    # the dead node's server is closed (its serving threads and device
    # stacks go); the node object stays off disco, as a crashed node
    nodes[2].server.close()
    dead = nodes[2]
    ts = step("node2 paused and its server closed", t0)
    cache = nodes[0].api.executor.stacked.cache
    keys0 = len(cache.keys())
    firsts, after, launches = cluster_queries(nodes[0], want, "11c failover",
                                              width, K)
    note("11c failover", launches)
    ts = step("the query set after the failover", ts)
    state = {n.id: n.state for n in disco.nodes()}
    if state["node2"] != NodeState.DOWN:
        raise AssertionError(f"11c: node2 is {state['node2']}")
    new_keys = len(cache.keys()) - keys0
    for q in want:
        print(f"11c: {q[:70]}: first call after node2 died "
              f"{firsts[q]:.2f} ms, warm p50 {after[q]:.3f} ms (before "
              f"{p50s[q]:.3f} ms)")
    print(f"11c: node0's stack cache took {new_keys} keys for its new "
          f"fan-out group; the old ones stay until the ledger reclaims "
          f"them")
    snap = nodes[0].snapshot()
    owned = [s for s in range(S_SUB)
             if "node2" in [o.id for o in snap.shard_nodes("bench", s)]]
    rng = np.random.default_rng(CLUSTER_SEED + 1)
    wshards = sorted(rng.choice(owned, FAILOVER_SHARDS,
                                replace=False).tolist())
    wcols = sorted({int(s) * width + int(c) for s in wshards
                    for c in rng.integers(0, width,
                                          FAILOVER_BITS // FAILOVER_SHARDS)})
    t1 = time.perf_counter()
    nodes[0].import_bits("bench", "imp", [9] * len(wcols), wcols)
    tw = time.perf_counter() - t1
    got = nodes[0].executor.execute("bench", "Count(Row(imp=9))")
    if got["results"] != [len(wcols)]:
        raise AssertionError(f"11c: Count(Row(imp=9)) {got}")
    print(f"11c: {len(wcols)} bits of imp=9 over {len(wshards)} shards node2 "
          f"owns written while it is down in {tw:.2f} s; read back exact")
    ts = step("the writes node2 missed", ts)
    # a second node paused: shards whose owners are both down
    nodes[1].pause()
    nodes[1].server.close()
    ts = step("node1 paused and its server closed", ts)
    full = want["Count(Row(a=1))"]
    try:
        nodes[0].executor.execute("bench", "Count(Row(a=1))")
    except LoadShedError as e:
        shed = e
    else:
        raise AssertionError("11c: no LoadShedError with two nodes down")
    if shed.status != 503 or not shed.missing_shards:
        raise AssertionError(f"11c: shed {shed.status} {shed.missing_shards}")
    r = nodes[0].executor.execute("bench", "Count(Row(a=1))", partial_ok=True)
    missing = r["partial"]["missing_shards"]
    live = [s for s in range(S_SUB) if s not in set(missing)]
    exact = nodes[0].api.query("bench", "Count(Row(a=1))", shards=live)
    if missing != shed.missing_shards or r["results"] != exact["results"]:
        raise AssertionError(f"11c: partial {r} against {exact}")
    if not 0 < r["results"][0] < full:
        raise AssertionError(f"11c: partial count {r['results']}")
    print(f"11c: with node1 paused too, Count(Row(a=1)) sheds with "
          f"LoadShedError (status {shed.status}, {len(shed.missing_shards)} "
          f"shards missing); partial_ok answers {r['results'][0]} over the "
          f"{len(live)} live shards, equal to node0's own count of them")
    ts = step("the shed and partial answers", ts)
    # node1 missed no write: it reopens cold; node2 rejoins warm
    nodes[1] = open_node(1)
    ts = step("node1 reopened", ts)
    t1 = time.perf_counter()
    nodes[2] = open_node(2, warm=True)
    took = time.perf_counter() - t1
    ws = nodes[2].warm_stats
    if not ws["sync"]["blocks"]:
        raise AssertionError(f"11c: the rejoin repaired nothing: {ws}")
    by_id = {nd.node_id: nd for nd in nodes}
    snap = nodes[0].snapshot()
    for s in wshards:
        other = next(o.id for o in snap.shard_nodes("bench", s)
                     if o.id != "node2")
        mine = nodes[2].api.fragment_checksums("bench", "imp", "standard", s)
        theirs = by_id[other].api.fragment_checksums("bench", "imp",
                                                     "standard", s)
        if mine != theirs or not mine:
            raise AssertionError(f"11c: shard {s}: node2 {mine} != "
                                 f"{other} {theirs}")
        r = nodes[2].api.query("bench", "Count(Row(imp=9))", shards=[s])
        if r["results"][0] != sum(1 for c in wcols if c // width == s):
            raise AssertionError(f"11c: node2 shard {s} {r['results']}")
    secs = {k: round(v, 2) for k, v in nodes[2].warm_seconds.items()}
    print(f"11c: node2 reopened with warm=True in {took:.1f} s (seconds "
          f"{secs}): sync {ws['sync']}, after registering "
          f"{ws.get('sync_post_register')}, prefilled {ws['prefilled']}; "
          f"its imp fragments on the {len(wshards)} written shards equal "
          f"their replicas'")
    ts = step("node2's warm rejoin and its checks", t1)
    _f, _p, launches = cluster_queries(nodes[0], want, "11c rejoined",
                                       width, K, reps=1)
    note("11c rejoined", launches)
    step("the query set after the rejoin", ts)
    print(f"11c: the query set exact again through the three nodes; 11c "
          f"in {time.perf_counter() - t0:.1f} s, by step {steps} "
          f"({card_line()})")
    del dead
    return nodes


def cluster_reshard(h, root, note) -> None:
    """11e: a second cluster (its own disco) of two nodes on disk over
    the headline's first RESHARD_SHARDS shards of a, t and age; a third
    node joins and then node1 drains, under readers and a writer; a
    stream window to a moved shard; 11f: the port CLI's backup of one
    node and its restore into a fresh Server."""
    import os

    import numpy as np
    from pilosa_tpu_torch.cli.main import main as cli_main
    from pilosa_tpu_torch.cluster import ClusterNode, InMemDisCo
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.ops import kernels as K
    from pilosa_tpu_torch.server.http import Server

    t0 = time.perf_counter()
    width = W * 32
    # on disk for 11f's backup; a write is acknowledged before the sync
    # ([ingest] sync off), so the storm's writer does not sync each import
    cfg = cluster_config(ingest_sync=False)
    disco = InMemDisCo(lease_ttl=5.0)
    paths = [os.path.join(root, f"reshard{i}") for i in range(3)]
    holders = [Holder(path=p, width=width) for p in paths]
    made = []

    def open_node(i, **kw):
        nd = ClusterNode(f"node{i}", disco, holder=holders[i], replica_n=1,
                         heartbeat_interval=1.0, config=cfg).open(**kw)
        made.append(nd)
        return nd

    # numpy answers of the 32 shards, from the headline's words
    src = h.index("bench")
    shards = range(RESHARD_SHARDS)
    a = np.stack([src.field("a").views["standard"].fragments[s].row_words(1)
                  for s in shards])
    planes = np.stack([[src.field("age").view(src.field("age").bsi_view)
                        .fragments[s].row_words(2 + p) for p in range(DEPTH)]
                       for s in shards])
    exists = np.stack([src.field("age").view(src.field("age").bsi_view)
                       .fragments[s].row_words(0) for s in shards])
    pc = np.bitwise_count(planes).sum(axis=(0, 2), dtype=np.int64)
    t_rows = [int(np.bitwise_count(np.stack([
        src.field("t").views["standard"].fragments[s].row_words(r)
        for s in shards])).sum(dtype=np.int64)) for r in range(R)]
    top = sorted(((r, c) for r, c in enumerate(t_rows) if c),
                 key=lambda x: (-x[1], x[0]))
    expect = {
        "Count(Row(a=1))": int(np.bitwise_count(a).sum(dtype=np.int64)),
        "Sum(field=age)": {"value": int(sum(int(pc[p]) << p
                                            for p in range(DEPTH))),
                           "count": int(np.bitwise_count(exists).sum(
                               dtype=np.int64))},
        "TopN(t, n=8)": [{"id": r, "count": c} for r, c in top],
    }
    try:
        rows = copy_shards(h, holders[:2], "bench", shards,
                           placement(2, 1), fields=("a", "t", "age"),
                           dst_index="reshard")
        nodes = [open_node(i) for i in range(2)]
        nodes[0].apply_schema({"indexes": [{
            "name": "reshard", "options": {"keys": False,
                                           "trackExistence": False},
            "fields": [f.to_dict() for f in src.public_fields()
                       if f.name in ("a", "t", "age")]
            + [{"name": "wr", "options": {"type": "set"}}]}]})
        disco.add_shards("reshard", "", set(shards))
        for hd in holders[:2]:
            hd.sync()
        for q, w in expect.items():
            got = nodes[0].executor.execute("reshard", q)["results"][0]
            if got != w:
                raise AssertionError(f"11e: {q} {str(got)[:200]} != {w}")
        print(f"11e: a second cluster (two nodes on disk, replica_n 1) over "
              f"{RESHARD_SHARDS} shards of a, t and age ({rows} rows) built "
              f"in {time.perf_counter() - t0:.1f} s; its answers equal numpy")
        rng = np.random.default_rng(CLUSTER_SEED + 2)
        wcols = [int(c) for c in rng.integers(0, RESHARD_SHARDS * width,
                                              2 * RESHARD_WRITES)]
        K.reset_launches()
        joiner = open_node(2, member=False)
        nodes.append(joiner)
        moves, known = {}, set()
        for k, (label, run) in enumerate((
                ("join", lambda: nodes[0].rebalance_join("node2")),
                ("drain", lambda: nodes[0].rebalance_drain("node1")))):
            out, stats, known = reshard_storm(
                nodes, expect, wcols[k::2], run, known, width)
            moves[label] = out
            print(f"11e: {label} of {'node2' if label == 'join' else 'node1'}"
                  f": {out['shards_moved']} shards moved, "
                  f"{out['bytes_copied']} bytes copied, "
                  f"{out['bytes_delta_replayed']} bytes of deltas replayed in "
                  f"{out['chase_rounds']} chase rounds, {stats['seconds']:.2f} "
                  f"s; {stats['reads']} reads by {RESHARD_READERS} threads, "
                  f"{stats['failed']} failed, {stats['mismatched']} "
                  f"mismatched; {stats['writes']} writes acknowledged "
                  f"during it ({stats['late']:g} also sent to an owner "
                  f"that the placement read after the ack added), each "
                  f"read back through node0 and on its owner before the "
                  f"rest landed")
            if stats["failed"] or stats["mismatched"] or \
                    out["state"] != "done" or not out["shards_moved"]:
                raise AssertionError(f"11e {label}: {out} {stats}")
            if label == "join":
                reshard_stream(nodes, disco, width)
        got = nodes[0].executor.execute("reshard", "Count(Row(wr=9))")
        if got["results"] != [len(known)] or known != set(wcols):
            raise AssertionError(f"11e: Count(Row(wr=9)) {got}")
        if disco.roster() != ["node0", "node2"]:
            raise AssertionError(f"11e: roster {disco.roster()}")
        note("11e", dict(K.LAUNCHES))
        # 11f: backup of node2 (a node on disk) and restore
        t1 = time.perf_counter()
        bdir = os.path.join(root, "backup11f")
        host = f"127.0.0.1:{nodes[2].server.port}"
        if cli_main(["backup", "--host", host, "--output-dir", bdir,
                     "--quiet"]) != 0:
            raise AssertionError("11f: backup failed")
        h2 = Holder(path=os.path.join(root, "restore11f"), width=width)
        srv = Server(holder=h2, port=0, config=cfg)
        srv.start()
        try:
            if cli_main(["restore", "--host", f"127.0.0.1:{srv.port}",
                         "--source-dir", bdir, "--quiet"]) != 0:
                raise AssertionError("11f: restore failed")
            queries = list(expect) + ["Count(Row(wr=9))",
                                      "GroupBy(Rows(t), aggregate=Sum(field=age))"]
            for q in queries:
                a1 = nodes[2].api.query("reshard", q)["results"]
                a2 = srv.api.query("reshard", q)["results"]
                if a1 != a2:
                    raise AssertionError(f"11f: {q}: restored {str(a2)[:200]}"
                                         f" != source {str(a1)[:200]}")
            print(f"11f: `cli.main backup` of node2 ({len(os.listdir(bdir))} "
                  f"entries) and `restore` into a fresh Server on "
                  f"{srv.api.executor.device}: {len(queries)} queries answer "
                  f"as node2 does, in {time.perf_counter() - t1:.1f} s")
        finally:
            srv.close()
            h2.close()
    finally:
        for nd in made:
            try:
                nd.close()
            except Exception:
                pass
        for hd in holders:
            hd.close()


def reshard_storm(nodes, expect, wcols, run, known, width):
    """run() (a join or a drain) while RESHARD_READERS threads read
    expect's queries and Count(Row(wr=9)) through nodes[0] and one
    thread writes wr=9 at wcols; known holds the wr=9 columns set
    before.  A read of Count(Row(wr=9)) lies between the acknowledged
    writes when it starts and those when it ends plus the one in
    flight, and never falls.  After the stop, every acknowledged write
    reads back through nodes[0] and, shard by shard, on its owner;
    only then do the writes the writer did not reach land.  Returns
    (run's plan, counts, the wr=9 columns now set)."""
    from pilosa_tpu_torch.obs import metrics
    coord = nodes[0]
    stop = threading.Event()
    lock = threading.Lock()
    stats = {"reads": 0, "failed": 0, "mismatched": 0, "writes": 0}
    late0 = metrics.CLUSTER_EVENTS.value(event="late_owner")
    acked = []
    errors = []

    def n_acked():
        with lock:
            return len(known.union(acked))

    def reader(i):
        qs = list(expect) + ["Count(Row(wr=9))"]
        k, last = i, 0
        while not stop.is_set():
            q = qs[k % len(qs)]
            k += 1
            try:
                lo = n_acked()
                got = coord.executor.execute("reshard", q)["results"][0]
                if q in expect:
                    bad = got != expect[q]
                else:
                    bad = not max(lo, last) <= got <= n_acked() + 1
                    lo, last = max(lo, last), max(last, got)
                with lock:
                    stats["reads"] += 1
                    stats["mismatched"] += bad
                if bad:
                    errors.append(f"{q}: {str(got)[:120]} (at least {lo})")
            except Exception as e:
                with lock:
                    stats["failed"] += 1
                errors.append(f"{q}: {type(e).__name__}: {e}")
            time.sleep(0.002)

    def writer():
        for c in wcols:
            if stop.is_set():
                return
            try:
                coord.import_bits("reshard", "wr", [9], [c])
            except Exception as e:
                errors.append(f"write: {type(e).__name__}: {e}")
                with lock:
                    stats["failed"] += 1
                return
            with lock:
                acked.append(c)
                stats["writes"] += 1
            time.sleep(0.005)

    threads = [threading.Thread(target=reader, args=(i,))
               for i in range(RESHARD_READERS)] + [threading.Thread(
                   target=writer)]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    try:
        out = run()
    finally:
        stats["seconds"] = time.perf_counter() - t0
        stop.set()
        for t in threads:
            t.join(120)
        stats["late"] = metrics.CLUSTER_EVENTS.value(
            event="late_owner") - late0
    if any(t.is_alive() for t in threads):
        raise AssertionError("11e: a reader or the writer did not stop")
    if errors:
        print(f"11e: first errors {errors[:3]}")
    have = known.union(acked)
    got = coord.executor.execute("reshard", "Count(Row(wr=9))")["results"]
    if got != [len(have)]:
        raise AssertionError(f"11e: Count(Row(wr=9)) {got} != {len(have)} "
                             f"acknowledged ({len(acked)} in this move)")
    snap = coord.snapshot()
    by_id = {nd.node_id: nd for nd in nodes}
    for s in range(RESHARD_SHARDS):
        owner = snap.shard_nodes("reshard", s)[0].id
        want = sum(1 for c in have if c // width == s)
        got = by_id[owner].api.query("reshard", "Count(Row(wr=9))",
                                     shards=[s])["results"]
        if got != [want]:
            raise AssertionError(f"11e: shard {s} on its owner {owner}: "
                                 f"Count(Row(wr=9)) {got} != {want}")
    rest = wcols[len(acked):]
    if rest:
        coord.import_bits("reshard", "wr", [9] * len(rest), rest)
    return out, stats, have.union(rest)


def reshard_stream(nodes, disco, width) -> None:
    """A StreamWriter window on a donor, to a shard that moved to node2,
    forwards to the new owner and is read back there."""
    from pilosa_tpu_torch.ingest.stream import StreamWriter
    donor = next((nd for nd in nodes[:2]
                  if nd.api.fences.moved_map("reshard")), None)
    if donor is None:
        raise AssertionError("11e: no donor holds a MOVED fence")
    moved = donor.api.fences.moved_map("reshard")
    s = min(moved)
    col = s * width + 12345 % width
    w = StreamWriter(donor.api, window_s=0.001, sync=False)
    try:
        w.submit("reshard", "wr", rows=[5], cols=[col], timeout=30)
    finally:
        w.close()
    owner = next(nd for nd in nodes if nd.node_id == moved[s][0])
    got = owner.api.query("reshard", "Count(Row(wr=5))", shards=[s])
    frag = donor.api.holder.index("reshard").field("wr").views.get(
        "standard")
    left = frag.fragments.get(s) if frag is not None else None
    stayed = left is not None and left.contains(5, col % width)
    if got["results"] != [1] or stayed:
        raise AssertionError(
            f"11e: the window to moved shard {s} read {got} on "
            f"{owner.node_id} (moved map {moved}; on the donor: {stayed}; "
            f"the owner's shards "
            f"{sorted(owner.api.holder.index('reshard').available_shards)})")
    print(f"11e: a StreamWriter window on {donor.node_id} to shard {s} "
          f"(moved to {owner.node_id}) was forwarded there and reads back")


DAX_SEED = 2033
DAX_WORKERS = 2
DAX_REPS = 2              # warm calls a query through the queryer
# 12a's queries through POST /queryer/{table} as well
DAX_FRONT_QUERIES = ["Count(Intersect(Row(a=1), Row(b=1)))",
                     "Sum(field=age)", ABLE_SUM]
# 5c's statements the DAX SQL front serves: PERCENTILE's wire result is
# decoded by neither package's queryer, and kidx is not in the tier
DAX_SQL = [SQL_COUNT_AB, SQL_SUM_A, SQL_SUM, SQL_GE64, SQL_BETWEEN, SQL_ABLE,
           SQL_TA, SQL_MINMAX, SQL_DISTINCT, SQL_ORDER, SQL_LIMIT]
DAX_WRITE_SHARDS = 16     # 12c's writes fall in this many shards
DAX_WRITE_BITS = 1 << 12  # 12c's import_bits and import_values records
DAX_MOVES = 16            # 12d's shards moved to the admitted standby
DAX_READERS = 2
DAX_MOVE_WRITES = 400     # 12d's writer: Set of mw=1 at seeded columns
DAX_READ_QUERIES = ["Count(Row(a=1))", "Sum(field=age)", "TopN(t, n=8)"]
DAX_PAGED_SHARDS = 64     # 12e's stateless worker's share
DAX_PAGED_QUERIES = ["Count(Row(a=1))", "Sum(field=age)", ABLE_SUM]


def shard_rows(idx, shard: int) -> dict:
    """One shard's rows as ComputeNode.snapshot_shard gathers them:
    {(field, view, row): words}, fields and views in the index's order,
    rows ascending."""
    rows = {}
    for f in idx.fields.values():
        for v in f.views.values():
            frag = v.fragment(shard)
            if frag is None:
                continue
            for r in frag.row_ids:
                rows[(f.name, v.name, r)] = frag.row_words(r)
    return rows


def dax_seed_tier(h, tier: str):
    """12a's tier: each of the S_SUB leading shards of the headline index
    encoded by the port's snapshot_fragment_rows and put by
    BlobStore.put_snapshot (at version 0) into a "dir" tier under tier,
    the puts on a thread beside the encoding.  Returns the store and each
    shard's bytes of words."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from pilosa_tpu_torch.dax.snapshotter import snapshot_fragment_rows
    from pilosa_tpu_torch.storage.blob import BlobStore, LocalDirBackend
    idx = h.index("bench")
    t0 = time.perf_counter()
    first = snapshot_fragment_rows(shard_rows(idx, 0))
    t_enc = time.perf_counter() - t0
    free = shutil.disk_usage(os.path.dirname(tier)).free
    need = int(len(first) * S_SUB * 1.1)
    print(f"12a: the tier under {tier} on a disk with {free} bytes free "
          f"(~{need} needed)")
    if free < need:
        raise RuntimeError(f"12a: the blob tier needs ~{need} bytes; "
                           f"{free} free")
    blob = BlobStore(LocalDirBackend(os.path.join(tier, "blob")))

    def put(s, data):
        t1 = time.perf_counter()
        blob.put_snapshot("bench", s, 0, data)
        return time.perf_counter() - t1

    words, nbytes, t_put = [], 0, 0.0
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = []
        for s in range(S_SUB):
            t1 = time.perf_counter()
            rows = shard_rows(idx, s)
            data = first if s == 0 else snapshot_fragment_rows(rows)
            if s:
                t_enc += time.perf_counter() - t1
            words.append(sum(int(w.nbytes) for w in rows.values()))
            nbytes += len(data)
            pending.append(pool.submit(put, s, data))
            if len(pending) > 3:
                t_put += pending.pop(0).result()
        t_put += sum(f.result() for f in pending)
    wall = time.perf_counter() - t0
    print(f"12a: {S_SUB} shards ({sum(words)} bytes of words) encoded by "
          f"snapshot_fragment_rows in {t_enc:.2f} s and put by "
          f"BlobStore.put_snapshot in {t_put:.2f} s (sha256 and a "
          f"tmp+fsync+rename, on a thread beside the encoding), {wall:.2f} s "
          f"in all (host); {nbytes} bytes of snapshots, "
          f"{nbytes / max(sum(words), 1):.3f} a byte of words")
    return blob, words


def hydrate_timers(svc) -> dict:
    """Seconds the service's workers spend restoring shards from the blob
    tier (read and sha256) and decoding them into fragments
    (load_fragment_rows and set_row_words), summed over their threads."""
    acc = {"restore": 0.0, "decode": 0.0, "shards": 0}
    lock = threading.Lock()
    restore = svc.blob.restore

    def timed_restore(table, shard):
        t0 = time.perf_counter()
        out = restore(table, shard)
        with lock:
            acc["restore"] += time.perf_counter() - t0
        return out
    svc.blob.restore = timed_restore
    for w in svc.workers:
        def timed_load(idx, shard, data, load=w.hyd._load_snapshot):
            t0 = time.perf_counter()
            out = load(idx, shard, data)
            with lock:
                acc["decode"] += time.perf_counter() - t0
                acc["shards"] += 1
            return out
        w.hyd._load_snapshot = timed_load
    return acc


def http_json(port: int, method: str, path: str, body=None,
              timeout: float = 300.0):
    """One request to a local server: (status, parsed JSON)."""
    import http.client
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request(method, path, body=None if body is None
                  else json.dumps(body))
        r = c.getresponse()
        return r.status, json.loads(r.read())
    finally:
        c.close()


def dax_queries(queryer, want: dict, label: str, reps: int = DAX_REPS):
    """Each query of want through Queryer.query, cold and then reps times
    warm, its wire answer held exactly to numpy; returns (first ms, warm
    p50 ms)."""
    import torch
    firsts, p50s = {}, {}
    for q, w in want.items():
        times = []
        for _ in range(1 + reps):
            t0 = time.perf_counter()
            got = queryer.query("bench", q)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if wire_norm(q, got["results"][0], W * 32) != w:
                raise AssertionError(f"{label} {q}: {str(got)[:200]} != "
                                     f"numpy {str(w)[:200]}")
        firsts[q] = times[0]
        p50s[q] = statistics.median(times[1:]) if reps else float("nan")
    return firsts, p50s


def dax_sql_answers(ref: dict) -> dict:
    """DAX_SQL's rows from numpy over ref's shards (sql_answers' rules)."""
    want, data, n = ref["want"], ref["data"], ref["n"]
    full = bsi_sql_answers(*ref["ages"])
    cols, vals = sort_ref(data, n, True, 0, 100)
    if min(vals) <= 120:
        raise AssertionError("12b: fewer than 100 columns of a over 120")
    first = limit_ref(data, n, 10, 0)
    ages = [sum(bit(data["age"][p], c) << p for p in range(DEPTH))
            if bit(data["age_exists"], c) else None for c in first]
    ta = want["GroupBy(Rows(t), Rows(a), aggregate=Sum(field=age))"]
    full.update({
        SQL_COUNT_AB: [(want["Count(Intersect(Row(a=1), Row(b=1)))"],)],
        SQL_ABLE: [([e], [g], [d], s) for (e, g, d), _n, s, nv in
                   want[ABLE_SUM] if nv],
        SQL_TA: [([r], [a], s) for (r, a), _n, s, nv in ta if nv],
        SQL_ORDER: list(zip(cols, vals)),
        SQL_LIMIT: list(zip(first, ages)),
    })
    return {q: full[q] for q in DAX_SQL}


def phase_dax(h, ref: dict, root: str, note, device=None) -> None:
    """Phase 12 (see the module docstring): the DAX tier over the
    headline's S_SUB leading shards, from a blob tier this phase seeds,
    every answer held to ref (sub_reference)."""
    import os

    import torch
    from pilosa_tpu_torch import config
    from pilosa_tpu_torch.dax.server import DAXService
    from pilosa_tpu_torch.ops import kernels as K

    t_all = time.perf_counter()
    tier = os.path.join(root, "dax")
    blob, words = dax_seed_tier(h, tier)
    cfg = config.load(None, env={}, overrides={"grpc_port": -1})
    on = torch.device(device).type if device is not None else "cuda"
    made = []
    try:
        t0 = time.perf_counter()
        svc = DAXService(os.path.join(tier, "svc"), n_workers=DAX_WORKERS,
                         blob=blob, device=device, config=cfg)
        made.append(svc)
        if svc.device.type != on or any(
                w.api.executor.device.type != on for w in svc.workers):
            raise AssertionError(f"12a: a worker is not on {on}")
        svc.queryer.apply_schema({"indexes": [h.index("bench").to_dict()]})
        shards = [s for t, s in blob.shards() if t == "bench"]
        if shards != list(range(S_SUB)):
            raise AssertionError(f"12a: the tier holds {len(shards)} shards")
        svc.controller.add_shards("bench", shards)
        front = svc.serve_queryer()
        timers = hydrate_timers(svc)
        print(f"12a: DAXService (controller, queryer, {DAX_WORKERS} "
              f"shared-storage workers hydrating lazily from the tier) on "
              f"{svc.device}, {S_SUB} shards registered, the queryer's HTTP "
              f"front on :{front.port}, in {time.perf_counter() - t0:.1f} s")
        dax_serve(svc, front, ref, timers, words, note, K)
        dax_sql(svc, front, ref, note, K)
        dax_failover(svc, ref, note, K)
        dax_migrate(svc, ref, note, K)
        paged = DAXService(os.path.join(tier, "paged"), n_workers=0,
                           blob=blob, device=device, config=cfg)
        made.append(paged)
        dax_paged(paged, svc.controller.schema, ref, words, note, K)
    finally:
        for s in made:
            s.close()
    dax_cli(tier, device)
    shutil.rmtree(tier, ignore_errors=True)
    print(f"12: {time.perf_counter() - t_all:.1f} s ({card_line()})")


def dax_serve(svc, front, ref, timers, words, note, K) -> None:
    """12a: phase 4's query set through Queryer.query (the first call
    hydrates every worker's share), three of it through POST
    /queryer/bench; each worker's residency and own launches."""
    from pilosa_tpu_torch.cluster.client import InternalClient
    want = ref["want"]
    K.reset_launches()
    t0 = time.perf_counter()
    firsts, p50s = dax_queries(svc.queryer, want, "12a")
    took = time.perf_counter() - t0
    note("12a", dict(K.LAUNCHES))
    q0 = next(iter(want))
    print(f"12a: the first call ({q0}) hydrated {timers['shards']} shards: "
          f"{firsts[q0] / 1e3:.2f} s, of which restore (read, sha256) "
          f"{timers['restore']:.2f} s and decode (load_fragment_rows, "
          f"set_row_words) {timers['decode']:.2f} s summed over the "
          f"workers' threads; the rest is the stacks' builds and uploads, "
          f"the kernels and HTTP")
    for q, ms in p50s.items():
        print(f"12a: {q[:70]}: first {firsts[q]:.2f} ms, warm p50 "
              f"{ms:.3f} ms through Queryer.query")
    client = InternalClient(timeout=60.0)
    for w in svc.workers:
        res = client._request(w.uri, "GET", "/dax/residency")
        held = sorted(w.held.get("bench", ()))
        K.reset_launches()
        for q in ("Count(Intersect(Row(a=1), Row(b=1)))", "Sum(field=age)"):
            w.api.executor.execute("bench", q, shards=held)
        got = dict(K.LAUNCHES)
        note(f"12a {w.address}", got)
        if not sum(got.values()):
            raise AssertionError(f"12a: {w.address} launched nothing")
        mine = sum(words[s] for s in held)
        if res["hydrations"] < len(held) or res["resident_bytes"] < mine:
            raise AssertionError(f"12a: {w.address} residency {res}")
        print(f"12a: {w.address}: {len(held)} shards, {res['hydrations']} "
              f"hydrations, resident {res['resident_bytes']} bytes "
              f"(/dax/residency); its own leg launched {got}")
    K.reset_launches()
    for q in DAX_FRONT_QUERIES:
        times = []
        for _ in range(1 + DAX_REPS):
            t1 = time.perf_counter()
            st, body = http_json(front.port, "POST", "/queryer/bench",
                                 {"query": q})
            times.append((time.perf_counter() - t1) * 1e3)
            if st != 200 or wire_norm(q, body["results"][0], W * 32) != \
                    want[q]:
                raise AssertionError(f"12a front {q}: {st} {str(body)[:200]}")
        print(f"12a: POST /queryer/bench {q[:60]}: first {times[0]:.2f} ms, "
              f"warm p50 {statistics.median(times[1:]):.3f} ms, exact")
    note("12a front", dict(K.LAUNCHES))
    print(f"12a: the query set exact in {took:.1f} s ({card_line()})")


def dax_sql(svc, front, ref, note, K) -> None:
    """12b: DAX_SQL through Queryer.sql and POST /sql, exact."""
    import torch
    from pilosa_tpu_torch.api import _json_value
    K.reset_launches()
    for q, rows in dax_sql_answers(ref).items():
        times = []
        for _ in range(1 + DAX_REPS):
            t0 = time.perf_counter()
            got = [tuple(r) for r in svc.queryer.sql(q)["data"]]
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if got != rows:
                raise AssertionError(f"12b {q}: {str(got)[:200]} != numpy "
                                     f"{str(rows)[:200]}")
        t0 = time.perf_counter()
        st, body = http_json(front.port, "POST", "/sql", {"sql": q})
        t_http = (time.perf_counter() - t0) * 1e3
        if st != 200 or [tuple(r) for r in body["data"]] != \
                [tuple(_json_value(c) for c in r) for r in rows]:
            raise AssertionError(f"12b POST /sql {q}: {st} "
                                 f"{str(body)[:200]}")
        print(f"12b: {q[:70]}: first {times[0]:.2f} ms, warm p50 "
              f"{statistics.median(times[1:]):.3f} ms through Queryer.sql, "
              f"{t_http:.2f} ms through POST /sql; exact")
    note("12b", dict(K.LAUNCHES))


def dax_write_fields(svc) -> None:
    """Add 12c's and 12d's fields (dw, dv, mw) to the tier's schema."""
    import copy
    schema = copy.deepcopy(svc.controller.schema)
    ix = next(i for i in schema["indexes"] if i["name"] == "bench")
    ix["fields"] += [{"name": "dw", "options": {"type": "set"}},
                     {"name": "dv", "options": {"type": "int", "min": 0,
                                                "max": 1000}},
                     {"name": "mw", "options": {"type": "set"}}]
    svc.queryer.apply_schema(schema)


def dax_failover(svc, ref, note, K) -> None:
    """12c: seeded import_bits, import_values and a SQL INSERT over
    DAX_WRITE_SHARDS shards, read back; half the shards snapshotted into
    the tier, the rest's tails sealed; worker1 killed, the poller's pass
    reassigns its shards, and the survivor hydrates them: the query set
    exact, every acknowledged write read back."""
    import numpy as np
    t0 = time.perf_counter()
    width = W * 32
    K.reset_launches()
    rng = np.random.default_rng(DAX_SEED)
    wshards = sorted(int(s) for s in rng.choice(S_SUB, DAX_WRITE_SHARDS,
                                                replace=False))
    owners = {s: svc.controller.worker_for("bench", s)[0] for s in wshards}
    dax_write_fields(svc)
    last = {(s + 1) * width - 1 for s in wshards}
    cols = sorted({int(s) * width + int(c) for s in wshards
                   for c in rng.integers(0, width,
                                         DAX_WRITE_BITS // DAX_WRITE_SHARDS)}
                  - last)
    rows = rng.integers(0, 4, len(cols))
    vals = rng.integers(0, 1001, len(cols))
    ins = sorted(last)
    ins_vals = rng.integers(0, 1001, len(ins))
    q = svc.queryer
    t1 = time.perf_counter()
    q.import_bits("bench", "dw", rows.tolist(), cols)
    tb = time.perf_counter() - t1
    t1 = time.perf_counter()
    q.import_values("bench", "dv", cols, vals.tolist())
    tv = time.perf_counter() - t1
    t1 = time.perf_counter()
    out = q.sql("INSERT INTO bench (_id, dw, dv) VALUES " + ", ".join(
        f"({c}, 5, {int(v)})" for c, v in zip(ins, ins_vals)))
    ti = time.perf_counter() - t1
    if out["data"] != [[len(ins)]]:
        raise AssertionError(f"12c: INSERT answered {out}")
    expect = {f"Count(Row(dw={r}))": int((rows == r).sum()) for r in range(4)}
    expect["Count(Row(dw=5))"] = len(ins)
    expect["Sum(field=dv)"] = {"value": int(vals.sum() + ins_vals.sum()),
                               "count": len(cols) + len(ins)}
    expect["Row(dw=5)"] = ins

    def read_back(label):
        for pql, w in expect.items():
            got = q.query("bench", pql)["results"][0]
            if pql.startswith("Row("):
                got = got["columns"]
            if got != w:
                raise AssertionError(f"12c {label}: {pql} {str(got)[:200]} "
                                     f"!= {str(w)[:200]}")
    read_back("after the writes")
    print(f"12c: import_bits of {len(cols)} records ({tb:.2f} s), "
          f"import_values ({tv:.2f} s) and an INSERT of {len(ins)} rows "
          f"({ti:.2f} s) over {len(wshards)} shards (owners "
          f"{dict(sorted(Counter(owners.values()).items()))}) through the "
          f"queryer, each read back")
    by_addr = {w.address: w for w in svc.workers}
    t1 = time.perf_counter()
    for s in wshards[::2]:
        by_addr[owners[s]].snapshot_shard("bench", s)
    t_snap = time.perf_counter() - t1
    t1 = time.perf_counter()
    sealed = sum(by_addr[owners[s]].hyd.seal_tail("bench", s)
                 for s in wshards[1::2])
    t_seal = time.perf_counter() - t1
    for s in wshards:
        if svc.blob.covered_version("bench", s) != svc.wl.version("bench", s):
            raise AssertionError(f"12c: shard {s}: the tier covers "
                                 f"{svc.blob.covered_version('bench', s)} of "
                                 f"{svc.wl.version('bench', s)}")
    print(f"12c: snapshot_shard of {len(wshards[::2])} shards into the tier "
          f"in {t_snap:.2f} s; seal_tail of {len(wshards[1::2])} shards "
          f"({sealed} write-log entries) in {t_seal:.2f} s")
    t1 = time.perf_counter()
    svc.kill_worker("worker1")
    dead = svc.controller.poll_once()
    if dead != ["worker1"] or sorted(svc.controller.workers) != ["worker0"]:
        raise AssertionError(f"12c: poll_once found {dead}; workers "
                             f"{sorted(svc.controller.workers)}")
    q0 = next(iter(ref["want"]))
    got = q.query("bench", q0)
    t_first = time.perf_counter() - t1
    if wire_norm(q0, got["results"][0], width) != ref["want"][q0]:
        raise AssertionError(f"12c: {q0} after the death: {str(got)[:200]}")
    firsts, p50s = dax_queries(q, ref["want"], "12c", reps=1)
    read_back("after worker1 died")
    note("12c", dict(K.LAUNCHES))
    w0 = svc.workers[0]
    print(f"12c: worker1 killed; the poller's pass reassigned its shards; "
          f"the first answer {t_first:.2f} s after the kill (worker0 "
          f"hydrated {len(w0.hyd._resident)} shards in all, "
          f"{w0.hyd.hydrations} hydrations); the query set exact again "
          f"(first calls {min(firsts.values()):.1f}-"
          f"{max(firsts.values()):.1f} ms, warm {min(p50s.values()):.2f}-"
          f"{max(p50s.values()):.2f} ms); every acknowledged write read "
          f"back; 12c in {time.perf_counter() - t0:.1f} s ({card_line()})")


def dax_migrate(svc, ref, note, K) -> None:
    """12d: a standby admitted owning nothing, DAX_MOVES shards moved to it
    one at a time by Controller.migrate_shard under DAX_READERS readers
    and a writer of mw=1: no read fails or mismatches, every acknowledged
    write reads back, on its shard's new owner too."""
    import numpy as np
    from pilosa_tpu_torch.cluster.client import InternalClient
    t0 = time.perf_counter()
    width = W * 32
    K.reset_launches()
    rng = np.random.default_rng(DAX_SEED + 1)
    moves = sorted(int(s) for s in rng.choice(S_SUB, DAX_MOVES,
                                              replace=False))
    wcols = [int(rng.choice(moves)) * width + int(c)
             for c in rng.integers(0, width, DAX_MOVE_WRITES)]
    standby = svc.add_standby("standby0")
    svc.controller.admit_standby("standby0")
    want = {q: ref["want"][q] for q in DAX_READ_QUERIES}
    stop = threading.Event()
    lock = threading.Lock()
    stats = {"reads": 0, "failed": 0, "mismatched": 0}
    acked, errors = [], []

    def reader(i):
        k = i
        while not stop.is_set():
            q = DAX_READ_QUERIES[k % len(DAX_READ_QUERIES)]
            k += 1
            try:
                got = svc.queryer.query("bench", q)["results"][0]
                bad = wire_norm(q, got, width) != want[q]
            except Exception as e:
                bad = None
                errors.append(f"{q}: {type(e).__name__}: {e}")
            with lock:
                stats["reads"] += 1
                if bad is None:
                    stats["failed"] += 1
                elif bad:
                    stats["mismatched"] += 1
                    errors.append(f"{q}: {str(got)[:120]}")

    def writer():
        for c in wcols:
            if stop.is_set():
                return
            try:
                svc.queryer.import_bits("bench", "mw", [1], [c])
            except Exception as e:
                errors.append(f"write: {type(e).__name__}: {e}")
                with lock:
                    stats["failed"] += 1
                return
            with lock:
                acked.append(c)

    threads = [threading.Thread(target=reader, args=(i,))
               for i in range(DAX_READERS)] + [threading.Thread(target=writer)]
    for t in threads:
        t.start()
    outcomes = {}
    t1 = time.perf_counter()
    try:
        for s in moves:
            outcomes[s] = svc.controller.migrate_shard("bench", s,
                                                       "standby0")
    finally:
        took = time.perf_counter() - t1
        stop.set()
        for t in threads:
            t.join(120)
    if any(t.is_alive() for t in threads):
        raise AssertionError("12d: a reader or the writer did not stop")
    if errors:
        print(f"12d: first errors {errors[:3]}")
    if stats["failed"] or stats["mismatched"] or \
            set(outcomes.values()) != {"done"}:
        raise AssertionError(f"12d: {stats}, outcomes {outcomes}")
    held = sorted(standby.held.get("bench", ()))
    if held != moves:
        raise AssertionError(f"12d: standby0 holds {held}")
    got = svc.queryer.query("bench", "Count(Row(mw=1))")["results"]
    if got != [len(set(acked))]:
        raise AssertionError(f"12d: Count(Row(mw=1)) {got} != "
                             f"{len(set(acked))} acknowledged")
    client = InternalClient(timeout=60.0)
    for s in moves:
        mine = sorted({c for c in acked if c // width == s})
        r = client._request(standby.uri, "POST", "/index/bench/query",
                            {"query": "Row(mw=1)", "shards": [s]})
        if r["results"][0]["columns"] != mine:
            raise AssertionError(f"12d: shard {s} on standby0: "
                                 f"{str(r)[:200]} != {len(mine)} columns")
    res = client._request(standby.uri, "GET", "/dax/residency")
    note("12d", dict(K.LAUNCHES))
    print(f"12d: {len(moves)} shards moved to the admitted standby0 by "
          f"migrate_shard in {took:.2f} s ({took / len(moves):.2f} s a "
          f"shard), {res['resident_bytes']} bytes hydrated there; "
          f"{stats['reads']} reads by {DAX_READERS} threads, none failed or "
          f"mismatched; {len(acked)} writes acknowledged during the moves, "
          f"each read back through the queryer and on its new owner; 12d "
          f"in {time.perf_counter() - t0:.1f} s")


def dax_paged(paged, schema, ref, words, note, K) -> None:
    """12e: a stateless worker (add_blob_worker) of a second service over
    the same tier, its worker-budget-bytes a quarter of its share of
    DAX_PAGED_SHARDS shards: Count, Sum and the able GroupBy exact, with
    evictions and its resident bytes within the budget."""
    import torch
    t0 = time.perf_counter()
    share = sum(words[:DAX_PAGED_SHARDS])
    budget = share // 4
    paged.queryer.apply_schema(schema)
    w = paged.add_blob_worker("paged0", budget_bytes=budget)
    paged.controller.add_shards("bench", range(DAX_PAGED_SHARDS))
    want = slice_reference(ref, DAX_PAGED_SHARDS)
    K.reset_launches()
    for q in DAX_PAGED_QUERIES:
        t1 = time.perf_counter()
        got = paged.queryer.query("bench", q)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        if wire_norm(q, got["results"][0], W * 32) != want[q]:
            raise AssertionError(f"12e {q}: {str(got)[:200]} != numpy "
                                 f"{str(want[q])[:200]}")
        p = w.hyd.payload()
        print(f"12e: {q[:70]}: {ms:.1f} ms, exact; {p['hydrations']} "
              f"hydrations and {p['evictions']} evictions so far, resident "
              f"{p['resident_bytes']} of {budget} bytes")
    note("12e", dict(K.LAUNCHES))
    p = w.hyd.payload()
    if not p["evictions"] or p["resident_bytes"] > budget:
        raise AssertionError(f"12e: {p}")
    print(f"12e: a stateless worker with worker-budget-bytes {budget} (a "
          f"quarter of its {DAX_PAGED_SHARDS} shards' {share} bytes) paged "
          f"them in windows: {p['hydrations']} hydrations, {p['evictions']} "
          f"evictions, resident {p['resident_bytes']} bytes; 12e in "
          f"{time.perf_counter() - t0:.1f} s")


def dax_cli(tier: str, device=None) -> None:
    """12f: `python -m pilosa_tpu_torch.cli.main dax` (on the card unless
    device names another, [blob] backend = "dir") in a subprocess:
    CREATE TABLE, INSERT and SELECT over its /sql, then SIGINT."""
    import os
    import signal
    t0 = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    cfg = os.path.join(tier, "cli.toml")
    with open(cfg, "w") as f:
        f.write('[blob]\nbackend = "dir"\n')
    port = free_port()
    p = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli.main", "dax", "--config",
         cfg, "--data-dir", os.path.join(tier, "cli"), "--port", str(port)]
        + (["--device", str(device)] if device is not None else []),
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo), text=True,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    lines: list = []
    up = threading.Event()

    def drain():
        for ln in p.stderr:
            lines.append(ln)
            if "listening" in ln:
                up.set()
    threading.Thread(target=drain, daemon=True).start()
    try:
        if not up.wait(180):
            raise AssertionError(f"12f: cli dax never listened: "
                                 f"{''.join(lines)[-1500:]}")
        up_s = time.perf_counter() - t0
        width = W * 32
        out = []
        for stmt in ("CREATE TABLE ev (_id id, n int min 0 max 100, g id)",
                     f"INSERT INTO ev (_id, n, g) VALUES (1, 5, 1), "
                     f"({width + 2}, 7, 1), ({2 * width + 3}, 9, 2)",
                     "SELECT g, COUNT(*), SUM(n) FROM ev GROUP BY g"):
            st, body = http_json(port, "POST", "/sql", {"sql": stmt})
            if st != 200:
                raise AssertionError(f"12f: {stmt}: {st} {body}")
            out.append(body["data"])
        if sorted(out[2]) != [[1, 2, 12], [2, 1, 9]] or out[1] != [[3]]:
            raise AssertionError(f"12f: {out}")
        print(f"12f: `cli.main dax` ([blob] backend = \"dir\", on "
              f"{device or 'the card'}) "
              f"listening after {up_s:.1f} s; CREATE TABLE, an INSERT over 3 "
              f"shards and a GROUP BY over its /sql exact; "
              f"{''.join(ln for ln in lines if 'dax' in ln).strip()[:200]}")
    finally:
        p.send_signal(signal.SIGINT)
        try:
            p.wait(60)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(60)
    print(f"12f: stopped by SIGINT (exit {p.returncode}); "
          f"{time.perf_counter() - t0:.1f} s")


def _page_kinds(ps):
    from pilosa_tpu_torch.memory import encode
    return [encode.page_kind(p) for p in ps.pages if p is not None]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from pilosa_tpu_torch.ops import _build

    device = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    import numpy
    print(f"card: torch {torch.__version__} cuda {torch.version.cuda} "
          f"numpy {numpy.__version__} "
          f"device {name} count {torch.cuda.device_count()}")

    # nvcc builds the kernels (one process a source) beside the host's
    # build of the headline index; phase 3 waits for it
    t0 = time.perf_counter()
    built: dict = {}

    def build():
        try:
            built["dir"] = _build.build_all()
        except BaseException as e:  # re-raised on the main thread
            built["error"] = e
    builder = threading.Thread(target=build, name="nvcc")
    builder.start()

    def kernels_phase():
        builder.join()
        if "error" in built:
            raise built["error"]
        print(f"build: {built['dir']} in {time.perf_counter() - t0:.1f} s "
              "(beside the host's index build)")
        records = phase_kernels(device)
        torch.cuda.empty_cache()
        return records

    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        records, launches = phase_main_path(device, root, kernels_phase)
    finally:
        builder.join()
        shutil.rmtree(root, ignore_errors=True)
    for k, rec in records.items():
        rec["launches"] = launches[k]
    print(json.dumps({"kernels": list(records.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
